"""3x3 stride-1 SAME convolution (NHWC, HWIO weights).

Counterpart of ``idmvton_tpu/ops/pallas_conv.py``. Both Pallas variants --
``conv3x3`` (whole activation resident in VMEM) and ``conv3x3_hblock``
(input left in HBM, halo rows DMA'd) -- differ only in where the TPU kept
the input, so both wrappers launch the one implicit-GEMM kernel of
``csrc/conv3x3.cu``, which reads its halo tiles straight from the NHWC
input. Each wrapper keeps its own launch count.

The JAX package picks the variant by its VMEM budget. The port keeps the
same split with a size rule that reproduces that choice at every shape of
the serving path: an input of at least ``HBLOCK_MIN_BYTES`` per image takes
``conv3x3_hblock`` (the VAE's 1024x768 / 512x384 / 256x192 levels), a
smaller one ``conv3x3`` (every UNet conv, the VAE's 128x96 level). The
kernel takes bf16; the wrappers raise on anything else.

The JAX package's opt-in ``IDMVTON_CONV_PADACC=1`` variant of the
``conv3x3`` sites (``_conv3_kernel_padacc``) is a kernel of its own here,
``conv3x3_padacc`` (``csrc/conv3x3_padacc.cu``), with its own count.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from idmvton_tpu_torch.ops import _build

_LANE = 128
HBLOCK_MIN_BYTES = 32 * 1024 * 1024


def conv3x3_torch(x, w, b=None):
    """Plain version (JAX ``_conv3_xla``): x (B,H,W,Cin), w (3,3,Cin,Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _launch(x, w, b):
    bsz, h, wdt, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout):
        raise ValueError(f"conv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if cin % 32 or cout % 8:
        raise ValueError(f"conv3x3 kernel needs Cin % 32 == 0 and "
                         f"Cout % 8 == 0, got {cin}, {cout}")
    out = torch.empty(bsz, h, wdt, cout, dtype=x.dtype, device=x.device)
    dev = x.device
    bias = None if b is None else b.float()
    _build.call("idm_conv3x3",
                _build.ptr(x, "x", torch.bfloat16),
                _build.ptr(w, "w", torch.bfloat16, dev),
                _build.ptr(bias, "b", torch.float32, dev),
                _build.ptr(out, "out", torch.bfloat16),
                bsz, h, wdt, cin, cout, _build.stream_ptr(dev))
    return out


def conv3x3(x, w, b=None):
    """x (B,H,W,Cin) bf16, w (3,3,Cin,Cout) bf16, b (Cout,) or None."""
    out = _launch(x, w, b)
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


def conv3x3_hblock(x, w, b=None):
    """Large-activation site of the same kernel (see the module doc)."""
    out = _launch(x, w, b)
    conv3x3_hblock.launches += 1
    return out


conv3x3_hblock.launches = 0


def _shape_ok(x, w) -> bool:
    # the shape part of the JAX predicates (Cin, Cout >= 128, W >= 8) plus
    # the kernel's own limits: 32-channel K chunks, 8-channel output vectors
    if tuple(w.shape[:2]) != (3, 3) or x.dim() != 4:
        return False
    cin, cout, wdt = x.shape[-1], w.shape[-1], x.shape[2]
    return (cin >= _LANE and cout >= _LANE and wdt >= 8 and cin % 32 == 0
            and cout % 8 == 0)


def _image_bytes(x) -> int:
    return x[0].numel() * x.element_size()


def conv3x3_supported(x, w) -> bool:
    return _shape_ok(x, w) and _image_bytes(x) < HBLOCK_MIN_BYTES


def conv3x3_hblock_supported(x, w) -> bool:
    return _shape_ok(x, w)


def conv_padacc_enabled() -> bool:
    """JAX ``pallas_conv._padacc``: ``IDMVTON_CONV_PADACC=1``, read at call
    time, swaps the ``conv3x3`` sites to ``conv3x3_padacc``."""
    return os.environ.get("IDMVTON_CONV_PADACC", "0") == "1"


def conv3x3_padacc(x, w, b=None):
    """The padded-accumulator variant (``csrc/conv3x3_padacc.cu``) of the
    same conv: x (B,H,W,Cin) bf16, w (3,3,Cin,Cout) bf16, b (Cout,) or None.

    As the TPU variant, it makes one explicit zero-padded copy of x and runs
    GEMMs over whole padded rows, so no tap needs a halo predicate; each
    (dy, dx) product is added into an fp32 accumulator shifted by 2 - dx
    and only output columns [2, 2 + W) of each padded row are kept."""
    bsz, h, wdt, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout):
        raise ValueError(f"conv3x3_padacc: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if cin % 32 or cout % 8:
        raise ValueError(f"conv3x3_padacc kernel needs Cin % 32 == 0 and "
                         f"Cout % 8 == 0, got {cin}, {cout}")
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.empty(bsz, h, wdt, cout, dtype=x.dtype, device=x.device)
    dev = x.device
    bias = None if b is None else b.float()
    _build.call("idm_conv3x3_padacc",
                _build.ptr(xp, "x", torch.bfloat16),
                _build.ptr(w, "w", torch.bfloat16, dev),
                _build.ptr(bias, "b", torch.float32, dev),
                _build.ptr(out, "out", torch.bfloat16),
                bsz, h, wdt, cin, cout, _build.stream_ptr(dev))
    conv3x3_padacc.launches += 1
    return out


conv3x3_padacc.launches = 0
