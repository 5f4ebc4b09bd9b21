"""Int8 weight quantization arithmetic (W8A8 on the ``ln_linear`` sites).

Counterpart of the array math of ``idmvton_tpu/ops/quant.py`` and of
``pallas_norm.dequantize_int8``: symmetric per-output-channel int8 codes
with fp32 scales (absmax / 127). The modules that hold them
(``models.layers.QuantLinear``) and the walk that quantizes a UNet's
``to_qkv`` / ``ff.proj_in`` sites (``models.attention.
quantize_unet_linears_int8``) live in ``models/``.
"""

from __future__ import annotations

import torch


def quantize_kernel_int8(w: torch.Tensor):
    """(C, N) weight -> (int8 codes (C, N), fp32 scales (N,)) with the JAX
    package's arithmetic: in fp32, ``scale = max(absmax over C, 1e-8) /
    127`` and ``codes = clip(round(w / scale), -127, 127)`` (a true
    division; ``torch.round`` rounds half to even, as ``jnp.round``). The
    codes are the (C, N) view of (N, C) storage: the W8A8 kernel reads the
    weight K-major (``csrc/ln_linear_i8.cu``)."""
    w = w.detach().float()
    scale = w.abs().amax(0).clamp_min(1e-8) / 127.0
    codes = torch.round(w / scale[None]).clamp_(-127, 127)
    return codes.t().to(torch.int8, memory_format=torch.contiguous_format).t(), \
        scale


def dequantize_kernel_int8(w_i8, w_scale, dtype):
    """(C, N) int8 codes times their (N,) fp32 scales, cast to ``dtype``
    (a contiguous (C, N) tensor, whatever the codes' storage)."""
    out = torch.empty(w_i8.shape, dtype=dtype, device=w_i8.device)
    return torch.mul(w_i8.float(), w_scale.float()[None], out=out)
