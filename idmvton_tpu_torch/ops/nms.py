"""Fixed-shape NMS and box IoU (counterpart of ``idmvton_tpu/ops/nms.py``).

Greedy suppression over the IoU matrix, with fixed output shapes and
``-1`` padding, as the JAX functions. JAX runs the sequential greedy loop
as a ``lax.fori_loop`` on the device; here the IoU matrix and its threshold
are computed on the boxes' device and the greedy scan, one pass in score
order over the rows of that boolean matrix, runs on the host (torchvision's
CUDA NMS splits the work the same way: the scan is sequential and touches
each row once). Score order ties break as JAX's: ``jnp.argsort`` is stable
and ``jax.lax.top_k`` takes the lower index first, so both use a stable
descending sort here.
"""

from __future__ import annotations

import numpy as np
import torch


def box_iou(a, b):
    """a: (N, 4), b: (M, 4) [x1, y1, x2, y2] -> (N, M) IoU."""
    area_a = ((a[:, 2] - a[:, 0]).clamp_min(0)
              * (a[:, 3] - a[:, 1]).clamp_min(0))
    area_b = ((b[:, 2] - b[:, 0]).clamp_min(0)
              * (b[:, 3] - b[:, 1]).clamp_min(0))
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def _descending(scores):
    """Indices of ``scores`` in descending order, ties lower index first
    (``jnp.argsort(-scores)``, ``jax.lax.top_k``)."""
    return torch.argsort(-scores, stable=True)


def nms_mask(boxes, scores, *, iou_threshold: float = 0.7,
             score_threshold: float = float("-inf")):
    """Greedy NMS. boxes (N, 4), scores (N,) -> keep mask (N,) bool on the
    boxes' device: a box is kept when its score is above
    ``score_threshold`` and no kept box of higher rank overlaps it by more
    than ``iou_threshold``; padded or invalid boxes never suppress."""
    n = boxes.shape[0]
    order = _descending(scores)
    valid = (scores > score_threshold)[order].cpu().numpy()
    b = boxes[order]
    over = (box_iou(b, b) > iou_threshold).cpu().numpy()
    keep_sorted = np.zeros(n, bool)
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if valid[i] and not suppressed[i]:
            keep_sorted[i] = True
            suppressed |= over[i]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep


def nms_topk(boxes, scores, *, iou_threshold: float = 0.7, topk: int = 100,
             score_threshold: float = float("-inf")):
    """NMS + fixed-size top-k selection. Returns (boxes (K, 4), scores (K,),
    indices (K,) int64 with -1 padding), the static K of detectron2's
    POST_NMS_TOPK."""
    keep = nms_mask(boxes, scores, iou_threshold=iou_threshold,
                    score_threshold=score_threshold)
    masked = torch.where(keep, scores, torch.full_like(scores, -float("inf")))
    n = boxes.shape[0]
    if n < topk:   # pad so the output shape is always (topk, ...)
        masked = torch.cat([masked, masked.new_full((topk - n,),
                                                    -float("inf"))])
        boxes = torch.cat([boxes, boxes.new_zeros(topk - n, 4)])
    idx = _descending(masked)[:topk]
    top = masked[idx]
    valid = torch.isfinite(top)
    out_boxes = torch.where(valid[:, None], boxes[idx],
                            boxes.new_zeros(()))
    out_idx = torch.where(valid, idx, idx.new_full((), -1))
    out_scores = torch.where(valid, top, top.new_zeros(()))
    return out_boxes, out_scores, out_idx
