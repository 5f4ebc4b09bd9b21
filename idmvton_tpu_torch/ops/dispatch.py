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
