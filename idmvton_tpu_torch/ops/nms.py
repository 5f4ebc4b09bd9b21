"""Fixed-shape NMS and box IoU (counterpart of ``idmvton_tpu/ops/nms.py``).

Greedy suppression with fixed output shapes and ``-1`` padding, as the
JAX functions. JAX runs the sequential greedy loop over the full IoU matrix
as a ``lax.fori_loop`` on the device; here the walk goes down the score
order in chunks (``_greedy``): IoUs and thresholds on the boxes' device,
each chunk against the boxes kept so far, then the sequential scan within
the chunk on the host (torchvision's CUDA NMS splits the work the same
way). ``nms_topk`` stops at its K-th kept box: the detection trainer runs
NMS over every anchor of every level (217,413 boxes at 800x1088), whose
IoU matrix alone would be 189 GB. Score order ties break as JAX's:
``jnp.argsort`` is stable and ``jax.lax.top_k`` takes the lower index
first, so both use a stable descending sort here.
"""

from __future__ import annotations

from typing import Optional

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


# boxes a chunk of the greedy walk: its chunk x chunk IoU matrix (16 MB of
# fp32 at 2048) stays on the boxes' device, the thresholded bools (4 MB)
# go to the host at once
CHUNK = 2048


def _greedy(boxes, scores, *, iou_threshold: float, score_threshold: float,
            limit: int):
    """Greedy NMS in score order, stopped once ``limit`` boxes are kept.

    Box i is decided by the kept boxes of higher rank alone, so the walk
    goes down the stable descending order (``_descending``) a chunk at a
    time: each chunk is tested against the boxes kept so far on the boxes'
    device, then resolved greedily within itself on the host, and the walk
    stops at ``limit`` kept or at the end. No N x N matrix is formed.
    Returns (order, the kept boxes' positions in ``order`` as a host int64
    tensor, in rank order, and the number of ranks decided)."""
    n, chunk = boxes.shape[0], CHUNK
    order = _descending(scores)
    valid = scores > score_threshold
    kept_boxes = boxes.new_zeros(0, 4)
    kept = []
    if limit <= 0:
        return order, torch.tensor(kept, dtype=torch.long), 0
    for c0 in range(0, n, chunk):
        idx = order[c0:c0 + chunk]
        cb = boxes[idx]
        cand = valid[idx]
        if kept_boxes.shape[0]:
            cand = cand & ~(box_iou(cb, kept_boxes) > iou_threshold).any(1)
        cand = cand.cpu().numpy()
        if not cand.any():
            continue
        over = (box_iou(cb, cb) > iou_threshold).cpu().numpy()
        suppressed = ~cand
        new = []
        for i in np.flatnonzero(cand):
            if suppressed[i]:
                continue
            new.append(i)
            if len(kept) + len(new) == limit:
                kept.extend(c0 + j for j in new)
                return (order, torch.tensor(kept, dtype=torch.long),
                        int(c0 + i + 1))
            suppressed |= over[i]
        kept.extend(c0 + j for j in new)
        kept_boxes = torch.cat([kept_boxes, cb[torch.from_numpy(
            np.asarray(new)).to(cb.device)]])
    return order, torch.tensor(kept, dtype=torch.long), n


def nms_mask(boxes, scores, *, iou_threshold: float = 0.7,
             score_threshold: float = float("-inf")):
    """Greedy NMS. boxes (N, 4), scores (N,) -> keep mask (N,) bool on the
    boxes' device: a box is kept when its score is above
    ``score_threshold`` and no kept box of higher rank overlaps it by more
    than ``iou_threshold``; padded or invalid boxes never suppress."""
    n = boxes.shape[0]
    order, kept, _ = _greedy(boxes, scores, iou_threshold=iou_threshold,
                             score_threshold=score_threshold, limit=n)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order[kept.to(order.device)]] = True
    return keep


def nms_topk(boxes, scores, *, iou_threshold: float = 0.7, topk: int = 100,
             score_threshold: float = float("-inf"),
             record: Optional[dict] = None):
    """NMS + fixed-size top-k selection. Returns (boxes (K, 4), scores (K,),
    indices (K,) int64 with -1 padding), the static K of detectron2's
    POST_NMS_TOPK: the first K kept boxes in score order, which is what a
    top-k of the scores masked by the whole keep mask returns (JAX), so the
    walk stops at the K-th kept box. A kept box of non-finite score is a
    padded row, as there. ``record``, when given, receives ``visited``:
    the ranks the walk decided before it stopped."""
    order, kept, visited = _greedy(
        boxes, scores, iou_threshold=iou_threshold,
        score_threshold=score_threshold, limit=topk)
    if record is not None:
        record["visited"] = visited
    sel = order[kept.to(order.device)]
    k = sel.shape[0]
    out_boxes = boxes.new_zeros(topk, 4)
    out_scores = scores.new_zeros(topk)
    out_idx = torch.full((topk,), -1, dtype=torch.long, device=boxes.device)
    fin = torch.isfinite(scores[sel])
    out_boxes[:k] = torch.where(fin[:, None], boxes[sel], 0.0)
    out_scores[:k] = torch.where(fin, scores[sel], 0.0)
    out_idx[:k] = torch.where(fin, sel, -1)
    return out_boxes, out_scores, out_idx
