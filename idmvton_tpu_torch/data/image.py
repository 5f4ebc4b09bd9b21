"""Host-side image utilities (PIL/numpy): resize, normalize, CLIP preprocess.

Replaces torchvision transforms + HF CLIPImageProcessor used by the reference
datasets (inference.py:89-95,156 and CLIPImageProcessor at inference.py:153).
Arrays are NHWC float32. PIL is imported by the functions that need it, so
the module imports without it.

Own copy of ``idmvton_tpu/data/image.py`` for the PyTorch port, which
imports nothing of the JAX package; tests hold the two bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def to_array(img) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1]."""
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return arr


def normalize_pm1(img, size: Tuple[int, int]) -> np.ndarray:
    """Resize to (width, height) and normalize to [-1, 1] (the reference's
    ToTensor + Normalize(0.5, 0.5))."""
    from PIL import Image
    w, h = size
    return to_array(img.resize((w, h), Image.BICUBIC)) * 2.0 - 1.0


def load_mask(img, size: Tuple[int, int]) -> np.ndarray:
    """Binary inpaint mask (H, W, 1) in {0,1}; 1 = region to repaint."""
    from PIL import Image
    w, h = size
    arr = np.asarray(img.resize((w, h), Image.NEAREST), np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = (arr > 127).astype(np.float32) if arr.max() > 1.5 else (arr > 0.5).astype(np.float32)
    return arr[..., None]


def clip_preprocess(img, image_size: int = 224) -> np.ndarray:
    """HF CLIPImageProcessor defaults: resize shortest edge -> center crop ->
    rescale -> normalize. Returns (image_size, image_size, 3) float32."""
    from PIL import Image
    w, h = img.size
    short = min(w, h)
    nw, nh = round(w * image_size / short), round(h * image_size / short)
    img = img.convert("RGB").resize((nw, nh), Image.BICUBIC)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def denormalize_to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 (the reference's VaeImageProcessor.postprocess)."""
    arr = np.clip((np.asarray(images, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0).round().astype(np.uint8)


def save_image(images: np.ndarray, paths):
    from PIL import Image
    if isinstance(paths, str):
        paths = [paths]
    arr = denormalize_to_uint8(images)
    for img, path in zip(arr, paths):
        Image.fromarray(img).save(path)
