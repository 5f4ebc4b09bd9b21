"""DensePose IUV extraction, the reference's painters, and the end-to-end
``DensePose`` wrapper producing the pose conditioning image.

Counterpart of ``idmvton_tpu/preprocess/densepose/visualize.py`` (the
reference's apply_net ShowAction with the ``dp_segm`` visualizer): the
R-CNN and ``extract_iuv`` run on the model's device; the resize in, the
colormaps and the painting are the reference's OpenCV host code, copied
with their quirks (OpenCV is imported inside the functions that use it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from idmvton_tpu_torch.preprocess.densepose.rcnn import (
    DensePoseConfig, DensePoseRCNN, init_densepose_rcnn,
)

PIXEL_MEAN_BGR = np.asarray([103.530, 116.280, 123.675], np.float32)


def extract_iuv(coarse, fine, u, v):
    """Per-detection IUV from head outputs (densepose chart result
    semantics): label = argmax(fine) gated by coarse fg; u/v gathered at the
    label channel. Inputs (K, S, S, C) -> labels (K, S, S) uint8,
    uv (K, S, S, 2) float in [0, 1]."""
    fg = torch.argmax(coarse, dim=-1) > 0
    labels = torch.where(fg, torch.argmax(fine, dim=-1), 0)
    lab_idx = labels[..., None]
    uu = torch.gather(u, -1, lab_idx)[..., 0]
    vv = torch.gather(v, -1, lab_idx)[..., 0]
    uv = torch.stack([uu, vv], dim=-1).clamp(0.0, 1.0)
    return labels.to(torch.uint8), uv


class MatrixVisualizer:
    """Exact port of the reference's MatrixVisualizer
    (gradio_demo/densepose/vis/base.py:11-66), quirks preserved:

    - inplace=False does NOT copy — it ZEROES the caller's image in place
      (``image_target_bgr = image_bgr; image_target_bgr *= 0``), so the
      dp_segm output is colormapped parts on a BLACK background;
    - the matrix is resized with the dsize-positional cv2.resize call the
      reference uses (interp defaults to INTER_LINEAR — label values blend
      at part borders before colormapping, exactly like base.py:62-65 where
      the interp constant lands in cv2.resize's ``dst`` slot and is ignored).
    """

    def __init__(self, inplace=True, cmap=None, val_scale=1.0, alpha=0.7):
        import cv2
        self.inplace = inplace
        self.cmap = cv2.COLORMAP_PARULA if cmap is None else cmap
        self.val_scale = val_scale
        self.alpha = alpha

    def visualize(self, image_bgr, mask, matrix, bbox_xywh):
        import cv2
        if self.inplace:
            image_target_bgr = image_bgr
        else:
            image_target_bgr = image_bgr
            image_target_bgr *= 0
        x, y, w, h = [int(v) for v in bbox_xywh]
        if w <= 0 or h <= 0:
            return image_bgr
        if (w != mask.shape[1]) or (h != mask.shape[0]):
            mask = cv2.resize(mask, (w, h))
        if (w != matrix.shape[1]) or (h != matrix.shape[0]):
            matrix = cv2.resize(matrix, (w, h))
        mask_bg = np.tile((mask == 0)[:, :, np.newaxis], [1, 1, 3])
        matrix_scaled = matrix.astype(np.float32) * self.val_scale
        matrix_scaled_8u = matrix_scaled.clip(0, 255).astype(np.uint8)
        matrix_vis = cv2.applyColorMap(matrix_scaled_8u, self.cmap)
        matrix_vis[mask_bg] = image_target_bgr[y:y + h, x:x + w, :][mask_bg]
        image_target_bgr[y:y + h, x:x + w, :] = (
            image_target_bgr[y:y + h, x:x + w, :] * (1.0 - self.alpha)
            + matrix_vis * self.alpha)
        return image_target_bgr.astype(np.uint8)


def _xyxy_to_xywh_clipped(box, h, w):
    x1, y1, x2, y2 = [float(c) for c in box]
    x1, y1 = max(x1, 0.0), max(y1, 0.0)
    x2, y2 = min(x2, float(w)), min(y2, float(h))
    return [x1, y1, x2 - x1, y2 - y1]


def _paint_masked_colormap(image_rgb, boxes, valid, matrices, segms, *,
                           inplace, alpha, val_scale):
    """Shared loop: gray image -> per-detection MatrixVisualizer painting
    (DensePoseResultsVisualizer.visualize loop, densepose_results.py:14-33)."""
    import cv2
    out = cv2.cvtColor(cv2.cvtColor(image_rgb, cv2.COLOR_RGB2GRAY),
                       cv2.COLOR_GRAY2BGR)
    vis = MatrixVisualizer(inplace=inplace, alpha=alpha, val_scale=val_scale)
    h, w = out.shape[:2]
    for k in range(len(boxes)):
        if not valid[k]:
            continue
        bbox_xywh = _xyxy_to_xywh_clipped(boxes[k], h, w)
        out = vis.visualize(out, segms[k].astype(np.uint8),
                            matrices[k].astype(np.uint8), bbox_xywh)
    return out[:, :, ::-1]  # BGR -> RGB


def paint_segmentation(image_rgb: np.ndarray, boxes: np.ndarray,
                       labels: np.ndarray, valid: np.ndarray,
                       *, num_parts: int = 24) -> np.ndarray:
    """dp_segm: colormapped 24-part labels on a BLACK background —
    DensePoseResultsFineSegmentationVisualizer defaults
    (densepose_results.py:319-330: inplace=False, alpha=1,
    val_scale=255/N_PART_LABELS). This is the reference's "image-densepose"
    conditioning image (apply_net.py:270-285)."""
    # pre-scale to 8-bit like the iuv_array packing (labels are already the
    # matrix AND the segm mask in the fine-seg visualizer)
    return _paint_masked_colormap(
        image_rgb, boxes, valid, labels, labels,
        inplace=False, alpha=1.0, val_scale=255.0 / num_parts)


def paint_u(image_rgb, boxes, labels, uv, valid):
    """dp_u: U coordinate colormapped over the part mask, alpha-blended onto
    the gray image (DensePoseResultsUVisualizer, densepose_results.py:332:
    inplace=True, alpha=0.7, val_scale=1.0; iuv packing scales uv*255)."""
    u8 = np.clip(np.asarray(uv)[..., 0] * 255.0, 0, 255).astype(np.uint8)
    return _paint_masked_colormap(image_rgb, boxes, valid, u8, labels,
                                  inplace=True, alpha=0.7, val_scale=1.0)


def paint_v(image_rgb, boxes, labels, uv, valid):
    """dp_v: like dp_u for the V coordinate
    (DensePoseResultsVVisualizer, densepose_results.py:345)."""
    v8 = np.clip(np.asarray(uv)[..., 1] * 255.0, 0, 255).astype(np.uint8)
    return _paint_masked_colormap(image_rgb, boxes, valid, v8, labels,
                                  inplace=True, alpha=0.7, val_scale=1.0)


def paint_bbox(image_rgb, boxes, scores, valid):
    """bbox: green rectangles + score text on the gray image
    (ScoredBoundingBoxVisualizer, vis/bounding_box.py:15-37 with
    RectangleVisualizer green (18,127,15) thickness 1 and TextVisualizer
    gray 0.35-scale Hershey-simplex, vis/base.py:80-140)."""
    import cv2
    out = cv2.cvtColor(cv2.cvtColor(image_rgb, cv2.COLOR_RGB2GRAY),
                       cv2.COLOR_GRAY2BGR)
    h, w = out.shape[:2]
    for k in range(len(boxes)):
        if not valid[k]:
            continue
        x, y, bw, bh = _xyxy_to_xywh_clipped(boxes[k], h, w)
        cv2.rectangle(out, (int(x), int(y)), (int(x + bw), int(y + bh)),
                      (18, 127, 15), 1)
        cv2.putText(out, "{0:6.4f}".format(float(scores[k])),
                    (int(x), int(y)), cv2.FONT_HERSHEY_SIMPLEX, 0.35,
                    (218, 227, 218), 1, cv2.LINE_AA)
    return out[:, :, ::-1]


# marching-squares case table is in _bin_code_2_lines below
_N_PART_LABELS = 24


def paint_contour(image_rgb, boxes, labels, uv, valid, *, levels: int = 10):
    """dp_contour: U/V iso-contours per part via marching squares
    (DensePoseResultsCustomContourVisualizer, densepose_results.py:137-316 —
    the reference's own no-matplotlib implementation of the registered
    dp_contour visualizer; the mpl variant differs only in rasterization)."""
    import cv2
    out = cv2.cvtColor(cv2.cvtColor(image_rgb, cv2.COLOR_RGB2GRAY),
                       cv2.COLOR_GRAY2BGR)
    lv = np.linspace(0, 1, levels)
    # reshape to a column first: modern cv2 maps a 1-D array to (1, N, 3)
    # whereas the reference's per-level iteration (densepose_results.py:
    # 154-157) assumes one row per level
    colors = cv2.applyColorMap((lv * 255).astype(np.uint8).reshape(-1, 1),
                               cv2.COLORMAP_PARULA)
    level_colors = [[int(v) for v in c.ravel()] for c in colors]
    h, w = out.shape[:2]
    for k in range(len(boxes)):
        if not valid[k]:
            continue
        bbox_xywh = _xyxy_to_xywh_clipped(boxes[k], h, w)
        segm = np.asarray(labels[k])
        # The reference contours the uint8-PACKED IUV, not the raw float
        # heads: uv*255 truncated to uint8 then /255 (densepose_results.py:
        # 28-29 iuv packing, :162-163 unpack) — reproduce that quantization
        # round-trip so contour placement matches.
        u = np.clip(np.asarray(uv)[k, ..., 0], 0, 1)
        v = np.clip(np.asarray(uv)[k, ..., 1], 0, 1)
        u = (u * 255.0).astype(np.uint8).astype(float) / 255.0
        v = (v * 255.0).astype(np.uint8).astype(float) / 255.0
        for arr in (u, v):
            _contours(out, arr, segm, bbox_xywh, lv, level_colors)
    return out[:, :, ::-1]


def _contours(image_bgr, arr, segm, bbox_xywh, levels, level_colors):
    """densepose_results.py:167-211 (_contours): per part, marching-squares
    bin codes over thresholded U/V, lines drawn where the part mask holds."""
    nh, nw = arr.shape[0] - 1, arr.shape[1] - 1
    for part_idx in range(1, _N_PART_LABELS + 1):
        mask = segm == part_idx
        if not np.any(mask):
            continue
        arr_min, arr_max = np.amin(arr[mask]), np.amax(arr[mask])
        ii, jj = np.nonzero(mask)
        i0, i1 = np.amin(ii), np.amax(ii) + 1
        j0, j1 = np.amin(jj), np.amax(jj) + 1
        if (j1 == j0 + 1) or (i1 == i0 + 1):
            continue
        for level_idx, level in enumerate(levels):
            if (level < arr_min) or (level > arr_max):
                continue
            vp = arr[i0:i1, j0:j1] >= level
            bin_codes = (vp[:-1, :-1] + vp[1:, :-1] * 2 + vp[1:, 1:] * 4
                         + vp[:-1, 1:] * 8)
            mp = mask[i0:i1, j0:j1]
            bin_mask = (mp[:-1, :-1] + mp[1:, :-1] * 2 + mp[1:, 1:] * 4
                        + mp[:-1, 1:] * 8)
            color = level_colors[level_idx]
            nz = np.argwhere((bin_codes != 0) & (bin_codes != 15)
                             & (bin_mask != 0))
            for i, j in nz:
                _draw_level_lines(image_bgr, arr, level, color,
                                  int(bin_codes[i, j]), (i, j), bbox_xywh,
                                  nw, nh, (i0, j0))


def _draw_level_lines(image_bgr, arr, v, color_bgr, bin_code, multi_idx,
                      bbox_xywh, nw, nh, offset):
    import cv2
    lines = _bin_code_2_lines(arr, v, bin_code, multi_idx, nw, nh, offset)
    x0, y0, w, h = bbox_xywh
    x1, y1 = x0 + w, y0 + h
    for (x0r, y0r), (x1r, y1r) in lines:
        pt0 = (int(x0 + x0r * (x1 - x0)), int(y0 + y0r * (y1 - y0)))
        pt1 = (int(x0 + x1r * (x1 - x0)), int(y0 + y1r * (y1 - y0)))
        cv2.line(image_bgr, pt0, pt1, color_bgr, 1)


def _bin_code_2_lines(arr, v, bin_code, multi_idx, nw, nh, offset):
    """Marching-squares case table (densepose_results.py:239-306)."""
    i0, j0 = offset
    i, j = multi_idx
    i += i0
    j += j0
    v0, v1, v2, v3 = arr[i, j], arr[i + 1, j], arr[i + 1, j + 1], arr[i, j + 1]
    x0i = float(j) / nw
    y0j = float(i) / nh
    he = 1.0 / nh
    we = 1.0 / nw
    if bin_code in (1, 14):
        a = (v - v0) / (v1 - v0)
        b = (v - v0) / (v3 - v0)
        return [((x0i, y0j + a * he), (x0i + b * we, y0j))]
    if bin_code in (2, 13):
        a = (v - v0) / (v1 - v0)
        b = (v - v1) / (v2 - v1)
        return [((x0i, y0j + a * he), (x0i + b * we, y0j + he))]
    if bin_code in (3, 12):
        a = (v - v0) / (v3 - v0)
        b = (v - v1) / (v2 - v1)
        return [((x0i + a * we, y0j), (x0i + b * we, y0j + he))]
    if bin_code in (4, 11):
        a = (v - v1) / (v2 - v1)
        b = (v - v3) / (v2 - v3)
        return [((x0i + a * we, y0j + he), (x0i + we, y0j + b * he))]
    if bin_code in (6, 9):
        a = (v - v0) / (v1 - v0)
        b = (v - v3) / (v2 - v3)
        return [((x0i, y0j + a * he), (x0i + we, y0j + b * he))]
    if bin_code in (7, 8):
        a = (v - v0) / (v3 - v0)
        b = (v - v3) / (v2 - v3)
        return [((x0i + a * we, y0j), (x0i + we, y0j + b * he))]
    if bin_code == 5:
        a1 = (v - v0) / (v1 - v0)
        b1 = (v - v1) / (v2 - v1)
        a2 = (v - v0) / (v3 - v0)
        b2 = (v - v3) / (v2 - v3)
        return [((x0i, y0j + a1 * he), (x0i + b1 * we, y0j + he)),
                ((x0i + a2 * we, y0j), (x0i + we, y0j + b2 * he))]
    if bin_code == 10:
        a1 = (v - v0) / (v3 - v0)
        b1 = (v - v0) / (v1 - v0)
        a2 = (v - v1) / (v2 - v1)
        b2 = (v - v3) / (v2 - v3)
        return [((x0i + a1 * we, y0j), (x0i, y0j + b1 * he)),
                ((x0i + a2 * we, y0j + he), (x0i + we, y0j + b2 * he))]
    return []


VISUALIZERS = {
    "dp_segm": lambda img, out: paint_segmentation(
        img, out["boxes"], out["labels"], out["valid"]),
    "dp_u": lambda img, out: paint_u(
        img, out["boxes"], out["labels"], out["uv"], out["valid"]),
    "dp_v": lambda img, out: paint_v(
        img, out["boxes"], out["labels"], out["uv"], out["valid"]),
    "dp_contour": lambda img, out: paint_contour(
        img, out["boxes"], out["labels"], out["uv"], out["valid"]),
    "bbox": lambda img, out: paint_bbox(
        img, out["boxes"], out["scores"], out["valid"]),
}


def dump_results(file_name: str, boxes, scores, valid, labels, uv) -> dict:
    """DumpAction-equivalent structured record (apply_net.py:137-178):
    {"file_name", "scores", "pred_boxes_XYXY", "pred_densepose"} with only
    the valid detections, densepose as (labels (K,S,S) uint8,
    uv (K,S,S,2) float32) — the DensePoseResultExtractor payload."""
    keep = np.asarray(valid).astype(bool)
    return {
        "file_name": file_name,
        "scores": np.asarray(scores)[keep],
        "pred_boxes_XYXY": np.asarray(boxes)[keep],
        "pred_densepose": (np.asarray(labels)[keep].astype(np.uint8),
                           np.asarray(uv)[keep].astype(np.float32)),
    }


class DensePose:
    """image -> densepose conditioning image (RGB uint8, input size).

    Mirrors apply_net 'show' dp_segm: ResizeShortestEdge(800, max 1333)
    (OpenCV, on the host), caffe-style BGR mean subtraction, the R-CNN on
    ``model``'s device, fine-seg painting (host). ``model`` defaults to the
    seeded random R-CNN on ``device``; ``impl`` is the conv sites' impl
    (None: follow the device)."""

    def __init__(self, model: Optional[DensePoseRCNN] = None,
                 cfg: Optional[DensePoseConfig] = None, *,
                 short_edge: int = 800, max_size: int = 1333,
                 device="cuda", impl=None):
        if model is None:
            model = init_densepose_rcnn(0, cfg or DensePoseConfig(),
                                        device=device)
        self.model = model
        self.cfg = model.cfg
        self.short_edge = short_edge
        self.max_size = max_size
        self.impl = impl

    @property
    def device(self):
        return next(self.model.parameters()).device

    @staticmethod
    def from_pickle(path: str, cfg: DensePoseConfig = DensePoseConfig(), *,
                    device="cuda") -> "DensePose":
        from idmvton_tpu_torch.preprocess.densepose.convert import (
            convert_densepose, load_d2_pickle,
        )
        from idmvton_tpu_torch.weights.from_jax import load_module_params
        model = DensePoseRCNN(cfg, device=device)
        load_module_params(model, convert_densepose(load_d2_pickle(path),
                                                    cfg))
        return DensePose(model)

    def _preprocess(self, image_rgb: np.ndarray) -> Tuple[np.ndarray, float]:
        import cv2
        h, w = image_rgb.shape[:2]
        scale = self.short_edge / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        resized = cv2.resize(image_rgb, (nw, nh),
                             interpolation=cv2.INTER_LINEAR)
        bgr = resized[:, :, ::-1].astype(np.float32) - PIXEL_MEAN_BGR
        # pad to stride-32 multiples (FPN divisibility)
        ph = (32 - nh % 32) % 32
        pw = (32 - nw % 32) % 32
        bgr = np.pad(bgr, ((0, ph), (0, pw), (0, 0)))
        return bgr, scale

    def forward(self, bgr: np.ndarray, *, record: Optional[dict] = None):
        """The R-CNN on one preprocessed (H, W, 3) array (``_preprocess``'s
        output); returns its output dict on the device."""
        x = torch.from_numpy(np.ascontiguousarray(bgr[None])).to(
            self.device, next(self.model.parameters()).dtype)
        with torch.no_grad():
            return self.model(x, impl=self.impl, record=record)

    def detect(self, image_rgb: np.ndarray):
        """Detection-only forward: (boxes (K,4) xyxy in input-image coords,
        scores (K,), valid (K,) bool) with K = cfg.num_detections."""
        bgr, scale = self._preprocess(image_rgb)
        out = self.forward(bgr)
        return (out["boxes"].cpu().numpy() / scale,
                out["scores"].cpu().numpy(),
                out["valid"].cpu().numpy().astype(bool))

    def _outputs(self, image_rgb: np.ndarray) -> dict:
        bgr, scale = self._preprocess(image_rgb)
        out = self.forward(bgr)
        labels, uv = extract_iuv(out["coarse"], out["fine"], out["u"],
                                 out["v"])
        return {
            "boxes": out["boxes"].cpu().numpy() / scale,
            "scores": out["scores"].cpu().numpy(),
            "valid": out["valid"].cpu().numpy().astype(bool),
            "labels": labels.cpu().numpy(),
            "uv": uv.cpu().numpy(),
        }

    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        out = self._outputs(image_rgb)
        return paint_segmentation(image_rgb, out["boxes"], out["labels"],
                                  out["valid"])

    def show(self, image_rgb: np.ndarray, visualizations=("dp_segm",)):
        """ShowAction with a list of visualizer specs: each spec paints its
        own gray copy; returns {spec: image}."""
        out = self._outputs(image_rgb)
        return {spec: VISUALIZERS[spec](image_rgb, out)
                for spec in visualizations}

    def dump(self, image_rgb: np.ndarray, file_name: str = "") -> dict:
        """DumpAction-equivalent structured record."""
        out = self._outputs(image_rgb)
        return dump_results(file_name, out["boxes"], out["scores"],
                            out["valid"], out["labels"], out["uv"])
