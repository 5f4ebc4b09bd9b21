"""padding_mask_crop host-side helpers (counterpart of
``idmvton_tpu/preprocess/inpaint_crop.py``, a numpy / OpenCV copy).

The reference's ``padding_mask_crop`` kwarg (src/tryon_pipeline.py:1263,
:1580-1594, :1888) crops the person/mask images to the mask's bounding
region (expanded by ``pad`` pixels and to the processing aspect ratio) before
the diffusion runs, then pastes the generated crop back onto the original
image with the mask as alpha. Both halves are pure host-side numpy image ops
(they never touch the device), re-derived from the diffusers 0.25
``VaeImageProcessor.get_crop_region`` / ``apply_overlay`` semantics the
reference calls into.

Usage with the pipeline (arrays instead of the reference's PIL flow):

    region = get_crop_region(mask_hw, width, height, pad=padding_mask_crop)
    person_c = crop_resize(person_hw3, region, (height, width))
    mask_c   = crop_resize(mask_hw[..., None], region, (height, width),
                           nearest=True)
    ... run TryonPipeline on the cropped inputs ...
    final = apply_overlay(mask_hw, original_person_hw3, generated_hw3, region)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_crop_region(mask: np.ndarray, width: int, height: int,
                    pad: int = 0) -> Tuple[int, int, int, int]:
    """(x1, y1, x2, y2) crop window in MASK pixel coordinates: the mask's
    nonzero bounding box, padded by ``pad``, then expanded along one axis to
    the ``width:height`` processing aspect ratio (diffusers
    VaeImageProcessor.get_crop_region; reference call site
    src/tryon_pipeline.py:1581).

    mask: (H, W) array, nonzero = inpaint region. An all-zero mask returns
    the full frame (the reference's PIL flow would degenerate; full-frame is
    the only sane fallback)."""
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[..., 0]
    h, w = mask.shape
    nz = mask != 0
    cols, rows = nz.any(axis=0), nz.any(axis=1)
    if not cols.any():
        return 0, 0, w, h
    crop_left = int(np.argmax(cols))
    crop_right = int(np.argmax(cols[::-1]))
    crop_top = int(np.argmax(rows))
    crop_bottom = int(np.argmax(rows[::-1]))

    x1 = max(crop_left - pad, 0)
    y1 = max(crop_top - pad, 0)
    x2 = min(w - crop_right + pad, w)
    y2 = min(h - crop_bottom + pad, h)

    # expand the short axis to the processing aspect ratio
    ratio_crop = (x2 - x1) / max(y2 - y1, 1)
    ratio_proc = width / height
    if ratio_crop > ratio_proc:
        desired_h = (x2 - x1) / ratio_proc
        diff = int(desired_h - (y2 - y1))
        y1 -= diff // 2
        y2 += diff - diff // 2
        if y2 >= h:
            y1 -= y2 - h
            y2 = h
        if y1 < 0:
            y2 -= y1
            y1 = 0
        y2 = min(y2, h)
    else:
        desired_w = (y2 - y1) * ratio_proc
        diff = int(desired_w - (x2 - x1))
        x1 -= diff // 2
        x2 += diff - diff // 2
        if x2 >= w:
            x1 -= x2 - w
            x2 = w
        if x1 < 0:
            x2 -= x1
            x1 = 0
        x2 = min(x2, w)
    return int(x1), int(y1), int(x2), int(y2)


def crop_resize(image: np.ndarray, region: Tuple[int, int, int, int],
                out_hw: Tuple[int, int], *, nearest: bool = False
                ) -> np.ndarray:
    """Crop ``region`` (x1, y1, x2, y2) out of (H, W[, C]) and resize to
    ``out_hw`` — the reference's preprocess(crops_coords=..., resize_mode=
    'fill') step (tryon_pipeline.py:1588-1594; the crop region already has
    the target aspect ratio, so 'fill' reduces to a plain resize). Bilinear
    for images; nearest for masks."""
    import cv2
    x1, y1, x2, y2 = region
    patch = np.asarray(image)[y1:y2, x1:x2]
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    out = cv2.resize(patch, (out_hw[1], out_hw[0]), interpolation=interp)
    if out.ndim == 2 and np.asarray(image).ndim == 3:
        out = out[..., None]
    return out


def apply_overlay(mask: np.ndarray, original: np.ndarray,
                  generated: np.ndarray,
                  region: Optional[Tuple[int, int, int, int]] = None
                  ) -> np.ndarray:
    """Paste the generated image back onto the original with the mask as
    alpha (diffusers VaeImageProcessor.apply_overlay; reference call site
    tryon_pipeline.py:1888): out = original*(1-m) + generated*m, where the
    generated crop is resized into ``region`` and m = mask/max scaled to
    [0, 1]. Outside the region the original is returned untouched.

    mask: (H, W[, 1]) in {0..1} or {0..255}; original (H, W, 3);
    generated: the pipeline output (any resolution — resized into region).
    """
    import cv2
    mask = np.asarray(mask, np.float32)
    if mask.ndim == 3:
        mask = mask[..., 0]
    if mask.max() > 1.0:
        mask = mask / 255.0
    out_dtype = np.asarray(original).dtype
    original = np.asarray(original, np.float32)
    out = original.copy()
    h, w = original.shape[:2]
    x1, y1, x2, y2 = region if region is not None else (0, 0, w, h)
    patch = cv2.resize(np.asarray(generated, np.float32), (x2 - x1, y2 - y1),
                       interpolation=cv2.INTER_LINEAR)
    m = mask[y1:y2, x1:x2, None]
    out[y1:y2, x1:x2] = (1.0 - m) * out[y1:y2, x1:x2] + m * patch
    if np.issubdtype(out_dtype, np.integer):
        out = np.clip(np.rint(out), np.iinfo(out_dtype).min,
                      np.iinfo(out_dtype).max)
    return out.astype(out_dtype)
