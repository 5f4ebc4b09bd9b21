"""ROIAlign as a batched bilinear gather (counterpart of
``idmvton_tpu/ops/roi_align.py``): detectron2 semantics, ``aligned=True``
(half-pixel offset), a fixed sampling ratio, average pooling, a fixed
number of ROIs with ``-1`` batch indices giving zeros.

Every (roi, bin, sample point) reads its 4 neighbours with one row gather
from the feature map each (no per-ROI copy of the map), weighted and
summed in the JAX function's order.
"""

from __future__ import annotations

import torch


def roi_align(features, boxes, box_indices, *, output_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = True):
    """features: (B, H, W, C); boxes: (R, 4) [x1, y1, x2, y2] in input-image
    coords; box_indices: (R,) int batch index per ROI (-1 for padded /
    invalid ROIs -> zero output). Returns (R, output_size, output_size,
    C)."""
    b, h, w, c = features.shape
    r = boxes.shape[0]
    n = output_size
    s = sampling_ratio
    dev = features.device

    offset = 0.5 if aligned else 0.0
    bx = boxes.float() * spatial_scale - offset
    x1, y1, x2, y2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
    roi_w = (x2 - x1).clamp_min(1e-6 if aligned else 1.0)
    roi_h = (y2 - y1).clamp_min(1e-6 if aligned else 1.0)
    bin_w = roi_w / n
    bin_h = roi_h / n

    # sample-point grid: (R, n, s) per axis
    iy = torch.arange(n, dtype=torch.float32, device=dev)
    is_ = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    frac = iy[None, :, None] + is_[None, None, :]
    ys = (y1[:, None, None] + frac * bin_h[:, None, None]).reshape(r, n * s)
    xs = (x1[:, None, None] + frac * bin_w[:, None, None]).reshape(r, n * s)

    # points outside (-1, size) contribute zero; in-range coords are
    # clamped to [0, size - 1] before the bilinear split
    valid_y = (ys >= -1.0) & (ys <= h)
    valid_x = (xs >= -1.0) & (xs <= w)
    cy = ys.clamp(0.0, h - 1)
    cx = xs.clamp(0.0, w - 1)
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    zero = cy.new_zeros(())
    wy1 = torch.where(valid_y, cy - y0, zero)
    wy0 = torch.where(valid_y, 1.0 - (cy - y0), zero)
    wx1 = torch.where(valid_x, cx - x0, zero)
    wx0 = torch.where(valid_x, 1.0 - (cx - x0), zero)

    bi = box_indices.long().clamp(0, b - 1)[:, None, None]
    flat = features.reshape(b * h * w, c)

    def take(yi, xi):
        # (R, Py, Px, C): one row gather; its backward is index_add_, which
        # accumulates duplicates with atomics (the advanced index's
        # backward sorts them and serializes each run of equal rows: ROIs
        # on a border all read the same pixels)
        rows = (bi * h + yi[:, :, None]) * w + xi[:, None, :]
        return flat.index_select(0, rows.reshape(-1)).reshape(
            *rows.shape, c)

    def wt(wy, wx):
        return wy[:, :, None, None] * wx[:, None, :, None]

    out = (take(y0i, x0i) * wt(wy0, wx0) + take(y0i, x1i) * wt(wy0, wx1)
           + take(y1i, x0i) * wt(wy1, wx0) + take(y1i, x1i) * wt(wy1, wx1))
    pooled = out.reshape(r, n, s, n, s, c).mean(dim=(2, 4))
    valid = (box_indices >= 0)[:, None, None, None]
    return torch.where(valid, pooled, pooled.new_zeros(())).to(
        features.dtype)
