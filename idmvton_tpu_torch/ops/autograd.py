"""The kernels under autograd: one differentiable entry a kernel.

Counterpart of the ``jax.custom_vjp``s around the Pallas kernels
(``pallas_norm.py:89-107, 290-312, 530-560, 620-639``,
``pallas_attention.py:107-173, 663-688, 887-980``,
``pallas_conv.py:312-330, 370-388``). A kernel writes a fresh output that
autograd cannot see, so each entry point with a JAX VJP gets a
``torch.autograd.Function`` here:

- its forward runs the kernel wrapper (``kernel=``, the real wrapper by
  default; a test passes a stand-in) with grad mode off, and saves the
  inputs;
- its backward recomputes the wrapper's plain version under
  ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it: the
  VJP of the XLA reference, as JAX's ``jax.vjp(_xla_ref, ...)``. No kernel
  runs in a backward, as no Pallas kernel does in JAX's.

Three entries follow JAX's VJPs where they differ from the rule:
``gn_spatial_stats``'s backward is the closed form g1 + 2 x g2;
``flash_attention_gemm`` forces the exact online-max softmax in a
differentiated forward (JAX ``_flash_gemm_fwd``: training logits are not
bounded, so the fixed shift is off whatever ``fixed_shift_enabled()`` says); and
``ln_linear_i8`` differentiates the bf16 product on the dequantized
weight, with no gradient for the int8 weight or its scales.

Where nothing needs a gradient (serving, the frozen towers under
``torch.no_grad()``) each entry calls the wrapper directly: a serving step
runs no Function. ``flash_attention_fused_qkv`` (#10) has no VJP in JAX
and none here; the wrappers raise when autograd would record a launch
(``_build.no_autograd``), so no gradient is dropped silently.
"""

from __future__ import annotations

from typing import Optional

import torch

from idmvton_tpu_torch.ops import cuda_attention as A
from idmvton_tpu_torch.ops import cuda_conv as C
from idmvton_tpu_torch.ops import cuda_norm as N
from idmvton_tpu_torch.ops.quant import dequantize_kernel_int8


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class KernelVJP(torch.autograd.Function):
    """``kernel(*inputs, **kw)`` forward, the VJP of ``plain(*inputs,
    **kw)`` backward. ``inputs`` are tensors or None."""

    @staticmethod
    def forward(ctx, kernel, plain, kw, *inputs):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **kw)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(inputs, need)]
            outs = ctx.plain(*xs, **ctx.kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            wrt = [x for x, n in zip(xs, need) if n]
            got = iter(torch.autograd.grad(outs, wrt, grads,
                                           allow_unused=True))
        return (None, None, None) + tuple(next(got) if n else None
                                          for n in need)


def _apply(kernel, plain, inputs, **kw):
    if not needs_grad(*inputs):
        return kernel(*inputs, **kw)
    return KernelVJP.apply(kernel, plain, kw, *inputs)


# -- #1, #2, #8: the LayerNorm kernels --------------------------------------


def ln_linear(x, gamma, beta, w, b=None, *, eps: float = 1e-5,
              geglu: bool = False, kernel=None):
    """#1 (JAX ``_ln_mm_core``): VJP of ``ln_linear_torch`` for x, gamma,
    beta, w and b."""
    return _apply(kernel or N.ln_linear, N.ln_linear_torch,
                  (x, gamma, beta, w, b), eps=eps, geglu=geglu)


def fused_layer_norm(x, scale, bias, *, eps: float = 1e-5, kernel=None):
    """#2 (JAX ``fused_layer_norm``): VJP of ``layer_norm_torch``."""
    return _apply(kernel or N.fused_layer_norm, N.layer_norm_torch,
                  (x, scale, bias), eps=eps)


def _ln_linear_i8_plain(x, gamma, beta, w_i8, w_scale, b=None, *, eps,
                        geglu):
    w = dequantize_kernel_int8(w_i8.detach(), w_scale.detach(), x.dtype)
    return N.ln_linear_torch(x, gamma, beta, w, b, eps=eps, geglu=geglu)


def ln_linear_i8(x, gamma, beta, w_i8, w_scale, b=None, *, eps: float = 1e-5,
                 geglu: bool = False, kernel=None):
    """#8 (JAX ``_ln_mm_core_i8``): the gradient of ``ln_linear_torch`` on
    the dequantized weight for x, gamma, beta and b; none for the int8
    weight or its scales (a quantized stack serves, it is not trained)."""
    return _apply(kernel or N.ln_linear_i8, _ln_linear_i8_plain,
                  (x, gamma, beta, w_i8, w_scale, b), eps=eps, geglu=geglu)


# -- #3: GroupNorm statistics --------------------------------------------


class GnStatsVJP(torch.autograd.Function):
    """``kernel(x)`` -> (Σx, Σx²) per (B, C) forward; the closed-form VJP
    (g1 + 2 x g2, in fp32, cast to x's type) backward, as JAX's
    ``_gn_stats_bwd``."""

    @staticmethod
    def forward(ctx, kernel, x):
        ctx.save_for_backward(x)
        return kernel(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        gx = g1.reshape(shape) + 2.0 * x.float() * g2.reshape(shape)
        return None, gx.to(x.dtype)


def gn_spatial_stats(x, *, kernel=None):
    """#3 (JAX ``gn_spatial_stats``)."""
    kernel = kernel or N.gn_spatial_stats
    if not needs_grad(x):
        return kernel(x)
    return GnStatsVJP.apply(kernel, x)


# -- #13: the GroupNorm apply -------------------------------------------------


def gn_apply(x, mean_c, mean2_c, scale, bias, *, num_groups: int,
             eps: float = 1e-5, silu: bool = False, kernel=None):
    """#13 (no JAX VJP: JAX differentiates the tail XLA fuses): VJP of
    ``gn_apply_torch`` for x, the channel means, scale and bias."""
    return _apply(kernel or N.gn_apply, N.gn_apply_torch,
                  (x, mean_c, mean2_c, scale, bias), num_groups=num_groups,
                  eps=eps, silu=silu)


# -- #5, #6, #7: the 3x3 convolutions ----------------------------------------


def conv3x3(x, w, b=None, *, kernel=None):
    """#5 (JAX ``_conv3_core``): VJP of ``conv3x3_torch``."""
    return _apply(kernel or C.conv3x3, C.conv3x3_torch, (x, w, b))


def conv3x3_hblock(x, w, b=None, *, kernel=None):
    """#6 (JAX ``_conv3_hblock_core``)."""
    return _apply(kernel or C.conv3x3_hblock, C.conv3x3_torch, (x, w, b))


def conv3x3_padacc(x, w, b=None, *, kernel=None):
    """#7 (JAX's padacc kernel shares ``_conv3_core``'s VJP)."""
    return _apply(kernel or C.conv3x3_padacc, C.conv3x3_torch, (x, w, b))


# -- #4, #9, #11: attention --------------------------------------------------


def flash_attention_gemm(qkv, kv_ref=None, *, heads: int,
                         scale: Optional[float] = None,
                         sink_tokens: int = 0, uncond_rows: int = 0,
                         fixed_shift: bool = True, kernel=None):
    """#4 (JAX ``_flash_gemm_core``). ``fixed_shift`` holds where nothing
    is differentiated; a differentiated forward runs the online-max
    softmax, and its backward is the VJP of the exact softmax."""
    kernel = kernel or A.flash_attention_gemm
    kw = dict(heads=heads, scale=scale, sink_tokens=sink_tokens,
              uncond_rows=uncond_rows)
    if not needs_grad(qkv, kv_ref):
        return kernel(qkv, kv_ref, fixed_shift=fixed_shift, **kw)
    return KernelVJP.apply(kernel, A.flash_attention_gemm_torch,
                           dict(kw, fixed_shift=False), qkv, kv_ref)


def flash_attention(q, k, v, *, scale: Optional[float] = None, kernel=None):
    """#9 (JAX ``_flash_attention_core``): VJP of
    ``flash_attention_torch``."""
    return _apply(kernel or A.flash_attention, A.flash_attention_torch,
                  (q, k, v), scale=scale)


def flash_attention_concat_kv(q, k, v, k_ref, v_ref, *,
                              scale: Optional[float] = None, kernel=None):
    """#9 over [own | garment] keys: VJP of
    ``flash_attention_concat_kv_torch`` (JAX differentiates its
    concatenation, then ``_flash_attention_core``)."""
    return _apply(kernel or A.flash_attention_concat_kv,
                  A.flash_attention_concat_kv_torch, (q, k, v, k_ref, v_ref),
                  scale=scale)


def cross_attention_small_kv(q, kv, kv_ip=None, *, heads: int,
                             scale: Optional[float] = None,
                             ip_scale: float = 1.0, kernel=None):
    """#11 (JAX ``_cross_small_core``): VJP of
    ``cross_attention_small_kv_torch``."""
    return _apply(kernel or A.cross_attention_small_kv,
                  A.cross_attention_small_kv_torch, (q, kv, kv_ip),
                  heads=heads, scale=scale, ip_scale=ip_scale)
