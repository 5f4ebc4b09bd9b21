"""Train-time augmentations (host-side numpy).

Mirrors the reference train dataset's aug block (train_xl.py:152-216):
hflip 50% (all), color jitter 50% (person image + cloth; brightness 0.5,
contrast 0.3, saturation 0.5, hue 0.5), affine scale 50% U(0.8, 1.2)
(image/mask/pose), affine translate 50% U(-0.2, 0.2) (image/mask/pose).

Jitter math follows torchvision's functional ops on [0, 1] RGB. NOTE: the
reference applies TF.adjust_* to the already-[-1,1]-normalized person tensor,
whose internal clamp(0, 1) destroys the negative half of the range
(torchvision _blend clamps floats to [0,1]) — a reference bug we do not
replicate; both person and cloth are jittered in [0, 1] space here.

Affine uses nearest-neighbor resampling about the image center with zero
fill — torchvision's defaults for transforms.functional.affine.

Own copy of ``idmvton_tpu/data/augment.py`` for the PyTorch port, which
imports nothing of the JAX package; tests hold the two bit for bit.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# color jitter (torchvision functional semantics on [0,1] RGB)
# ---------------------------------------------------------------------------


def _rgb_to_grayscale(x: np.ndarray) -> np.ndarray:
    # torchvision rgb_to_grayscale weights
    return (0.2989 * x[..., 0] + 0.587 * x[..., 1]
            + 0.114 * x[..., 2])[..., None]


def adjust_brightness(x: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(x * factor, 0.0, 1.0)


def adjust_contrast(x: np.ndarray, factor: float) -> np.ndarray:
    mean = _rgb_to_grayscale(x).mean()
    return np.clip(factor * x + (1.0 - factor) * mean, 0.0, 1.0)


def adjust_saturation(x: np.ndarray, factor: float) -> np.ndarray:
    gray = _rgb_to_grayscale(x)
    return np.clip(factor * x + (1.0 - factor) * gray, 0.0, 1.0)


def _rgb_to_hsv(x: np.ndarray):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(-1)
    minc = x.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q]),
    ], axis=-1)
    return out


def adjust_hue(x: np.ndarray, factor: float) -> np.ndarray:
    """factor in [-0.5, 0.5]: shift hue channel cyclically."""
    h, s, v = _rgb_to_hsv(np.clip(x, 0.0, 1.0))
    h = (h + factor) % 1.0
    return _hsv_to_rgb(h, s, v)


def color_jitter(x01: np.ndarray, b: float, c: float, s: float,
                 h: float) -> np.ndarray:
    """Reference order: contrast, brightness, hue, saturation
    (train_xl.py:164-173)."""
    x01 = adjust_contrast(x01, c)
    x01 = adjust_brightness(x01, b)
    x01 = adjust_hue(x01, h)
    x01 = adjust_saturation(x01, s)
    return x01


def sample_jitter_params(rng) -> tuple:
    """ColorJitter(brightness=0.5, contrast=0.3, saturation=0.5, hue=0.5)
    parameter ranges (train_xl.py:162)."""
    return (rng.uniform(0.5, 1.5), rng.uniform(0.7, 1.3),
            rng.uniform(0.5, 1.5), rng.uniform(-0.5, 0.5))


# ---------------------------------------------------------------------------
# affine (nearest-neighbor about center, zero fill — torchvision defaults)
# ---------------------------------------------------------------------------


def affine_nearest(arr: np.ndarray, *, scale: float = 1.0,
                   translate: tuple = (0.0, 0.0)) -> np.ndarray:
    """arr (H, W, C). translate is (tx, ty) in PIXELS (reference passes
    shift_frac * width/height, train_xl.py:190-216). Inverse-map sampling:
    src = (dst - center - t) / scale + center."""
    h, w = arr.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    tx, ty = translate
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    src_y = np.round((ys - cy - ty) / scale + cy).astype(np.int64)
    src_x = np.round((xs - cx - tx) / scale + cx).astype(np.int64)
    valid = (src_y >= 0) & (src_y < h) & (src_x >= 0) & (src_x < w)
    out = np.zeros_like(arr)
    out[valid] = arr[src_y[valid], src_x[valid]]
    return out
