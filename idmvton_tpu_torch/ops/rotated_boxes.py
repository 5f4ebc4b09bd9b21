"""Rotated box IoU and rotated NMS in plain PyTorch.

Counterpart of ``idmvton_tpu/ops/rotated_boxes.py`` (the reference's
detectron2 csrc/nms_rotated and box_iou_rotated for RRPN-style heads, N2b;
not on the R-50-FPN DensePose path): the convex intersection of two
rotated rectangles by Sutherland-Hodgman clipping over fixed 16-vertex
buffers with a vertex count, branch-free. JAX clips one pair at a time in
a ``fori_loop`` under ``vmap``; here every clipping step runs over all
pairs at once, in the same order, with the same index clamping.

Boxes: (cx, cy, w, h, angle_degrees), angle CCW (detectron2's
convention).
"""

from __future__ import annotations

import numpy as np
import torch

_MAX_VERTS = 16  # intersection of two 4-gons has <= 8 vertices; padded


def box_corners(boxes):
    """(..., 5) -> (..., 4, 2) CCW corner coordinates."""
    cx, cy, w, h, a = boxes.unbind(-1)
    t = torch.deg2rad(a)
    cos, sin = torch.cos(t)[..., None], torch.sin(t)[..., None]
    dx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    dy = torch.stack([h / 2, h / 2, -h / 2, -h / 2], -1)
    x = cx[..., None] + dx * cos - dy * sin
    y = cy[..., None] + dx * sin + dy * cos
    return torch.stack([x, y], dim=-1)


def _clip_polygons(verts, count, a, b):
    """One Sutherland-Hodgman step for P polygons at once: keep the part of
    each (verts (P, V, 2), its first ``count`` (P,) ordered) on the left of
    its edge a -> b (P, 2), the CCW interior. Writes past the buffer clamp
    to its last slot, as JAX's ``dynamic_update_slice``."""
    p, n = verts.shape[:2]
    rows = torch.arange(p, device=verts.device)
    edge = b - a
    # signed area cross(edge, v - a): > 0 means left of a -> b
    d = (edge[:, 0:1] * (verts[..., 1] - a[:, 1:2])
         - edge[:, 1:2] * (verts[..., 0] - a[:, 0:1]))
    out = verts.new_zeros(p, n, 2)
    out_count = torch.zeros_like(count)
    for i in range(n):
        j = torch.where(count > i + 1, i + 1, 0)
        vi, vj = verts[:, i], verts[rows, j]
        di, dj = d[:, i], d[rows, j]
        active = count > i
        emit = active & (di >= 0)
        at = out_count.clamp(max=n - 1)
        out[rows, at] = torch.where(emit[:, None], vi, out[rows, at])
        out_count = out_count + emit
        crosses = active & ((di >= 0) != (dj >= 0))
        denom = di - dj
        tiny = torch.where(denom < 0, -1e-12, 1e-12).to(denom.dtype)
        t = di / torch.where(denom.abs() < 1e-12, tiny, denom)
        inter = vi + t[:, None] * (vj - vi)
        at = out_count.clamp(max=n - 1)
        out[rows, at] = torch.where(crosses[:, None], inter, out[rows, at])
        out_count = out_count + crosses
    return out, out_count


def _polygon_area(verts, count):
    """Shoelace over the first ``count`` (ordered) vertices, per polygon."""
    n = verts.shape[1]
    idx = torch.arange(n, device=verts.device)
    nxt = torch.where(idx[None] + 1 < count[:, None], idx[None] + 1, 0)
    vj = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    cross = verts[..., 0] * vj[..., 1] - vj[..., 0] * verts[..., 1]
    cross = torch.where(idx[None] < count[:, None], cross, 0.0)
    return cross.sum(1).abs() / 2.0


def _pair_intersection_area(box_a, box_b):
    """Intersection areas of P box pairs (P, 5) x (P, 5) -> (P,)."""
    ca = box_corners(box_a)           # (P, 4, 2) CCW
    cb = box_corners(box_b)
    verts = ca.new_zeros(ca.shape[0], _MAX_VERTS, 2)
    verts[:, :4] = ca
    count = torch.full((ca.shape[0],), 4, dtype=torch.long,
                       device=ca.device)
    for i in range(4):
        verts, count = _clip_polygons(verts, count, cb[:, i],
                                      cb[:, (i + 1) % 4])
    return _polygon_area(verts, count)


def box_iou_rotated(a, b):
    """a: (N, 5), b: (M, 5) -> (N, M) IoU of rotated boxes."""
    n, m = a.shape[0], b.shape[0]
    inter = _pair_intersection_area(
        a[:, None].expand(n, m, 5).reshape(-1, 5),
        b[None].expand(n, m, 5).reshape(-1, 5)).reshape(n, m)
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms_rotated_mask(boxes, scores, *, iou_threshold: float = 0.5):
    """Greedy rotated NMS -> keep mask (N,) (csrc/nms_rotated semantics):
    a box is kept when no kept box of higher rank (stable descending
    score order, as ``jnp.argsort``) overlaps it by more than
    ``iou_threshold``."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    over = (box_iou_rotated(b, b) > iou_threshold).cpu().numpy()
    keep_sorted = np.zeros(n, bool)
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if not suppressed[i]:
            keep_sorted[i] = True
            suppressed |= over[i]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep
