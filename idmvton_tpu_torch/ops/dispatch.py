"""Impl dispatch: ``"torch"`` (plain PyTorch) or ``"cuda"`` (hand kernels).

Counterpart of ``idmvton_tpu/ops/dispatch.py``. ``impl=None`` follows the
tensor: ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU tensor. There is
no process-wide default; callers pass ``impl`` down explicitly.
"""

from __future__ import annotations

from typing import Optional

import torch

IMPLS = ("torch", "cuda")


def narrow(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """An activation as a bf16-operand kernel takes it: an fp32 tensor
    narrowed to bf16 (the TPU kernels' DEFAULT precision rounds their
    operands to bf16 too, and accumulates in fp32), any other as it is (the
    wrapper checks its type). The site widens the result back."""
    if t is not None and t.dtype == torch.float32:
        return t.bfloat16()
    return t


def resolve(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    return impl


def launch_counters() -> dict:
    """Every hand kernel's wrapper, by name: the one list of them. Each
    wrapper's ``launches`` counts its launches."""
    from idmvton_tpu_torch.ops import cuda_attention as A
    from idmvton_tpu_torch.ops import cuda_conv as C
    from idmvton_tpu_torch.ops import cuda_norm as N
    fns = (N.ln_linear, N.fused_layer_norm, N.gn_spatial_stats, C.conv3x3,
           C.conv3x3_hblock, A.flash_attention_gemm, N.ln_linear_i8,
           A.cross_attention_small_kv, C.conv3x3_padacc, A.flash_attention,
           A.flash_attention_fused_qkv, N.gn_apply)
    return {f.__name__: f for f in fns}


def switches() -> tuple:
    """The call-time switches a kernel site reads: the fixed-shift softmax
    (with ``calibrate_fixed_shift``'s force-off), the small-KV
    cross-attention kernel and the padded-row conv."""
    from idmvton_tpu_torch.ops.cuda_attention import (
        cross_kernel_enabled, fixed_shift_enabled,
    )
    from idmvton_tpu_torch.ops.cuda_conv import conv_padacc_enabled
    return fixed_shift_enabled(), cross_kernel_enabled(), conv_padacc_enabled()
