"""Attention and BasicTransformerBlock modules of the SDXL UNets.

Counterpart of ``idmvton_tpu/models/attention.py``. One block covers the
three garment modes:
- ``"emit"``: GarmentNet returns the post-norm1, pre-attention hidden state;
- ``"consume"``: TryonNet self-attention over [own | garment] KV;
- ``"none"``: vanilla SDXL.

Projections are stored fused as in the JAX package (``to_qkv``; ``to_q`` +
``to_kv`` (+ ``to_kv_ip``)). On CUDA the pre-attention/pre-FF LayerNorms
fuse into their GEMMs (``ln_linear``), GarmentNet's emitted LayerNorm runs
``fused_layer_norm`` and self-attention runs ``flash_attention_gemm`` --
each where the JAX package takes the Pallas kernel, under the same shape
predicates; its softmax mode is ``IDMVTON_FLASH_FIXED_SHIFT`` (or a failed
``calibrate_fixed_shift``), read at every call as JAX reads it.
Self-attention over head layouts ``flash_attention_gemm`` does not take
(H*D not a multiple of 128, as at the tiny UNet's 64-wide level)
goes through ``sdpa`` / ``concat_kv_attention`` with the caller's impl, so
on CUDA it runs ``flash_attention`` above 256 keys. Cross-attention (77
text + 16 IP tokens) stays plain, as the JAX package leaves it to XLA,
unless ``IDMVTON_CROSS_KERNEL=1`` opts the
CUDA impl into the small-KV kernel (``cross_attention_small_kv``), as it
opts JAX's Pallas impl in; the torch impl ignores the switch, as JAX's XLA
impl does.

``quantize_unet_linears_int8`` makes every block's ``to_qkv`` /
``ff.proj_in`` an int8 ``QuantLinear``. At the fused sites on CUDA these
run the W8A8 kernel ``ln_linear_i8``; every other use of them (the plain
path, the garment K/V GEMM, an unfused site) takes the dequantized weight,
as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.models.layers import (
    Linear, Norm, QuantLinear, kernel_weight, layer_norm, linear,
    quantize_linear_int8, weights_changed_,
)
from idmvton_tpu_torch.ops.attention import (
    concat_kv_attention, decoupled_ip_attention, sdpa,
)
from idmvton_tpu_torch.ops.cuda_attention import (
    _fixed_shift, cross_attention_small_kv,
    cross_attention_small_kv_supported, flash_attention_gemm,
    flash_attention_gemm_supported,
)
from idmvton_tpu_torch.ops.cuda_norm import (
    fused_layer_norm, ln_linear, ln_linear_i8, ln_linear_supported,
    supports_fused_ln,
)
from idmvton_tpu_torch.ops.dispatch import narrow, resolve


def _split_heads(x, heads: int):
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1)


def _merge_heads(x):
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def _ln_proj(x, norm, proj, *, geglu=False, impl=None):
    """norm(x) @ proj: the fused kernel where it applies (the W8A8 one for
    an int8 projection), else plain (an int8 projection dequantized, as JAX
    ``pallas_norm.ln_linear`` does where its kernel does not apply). Returns
    the raw product for ``geglu=False``, value * gelu(gate) for
    ``geglu=True``."""
    quant = isinstance(proj, QuantLinear)
    w = proj.kernel_i8 if quant else proj.kernel
    if (norm is not None and resolve(impl, x) == "cuda"
            and ln_linear_supported(x, w, geglu=geglu)):
        # an fp32 stack hands the kernels bf16 x and weights (their
        # operands), and takes the product back in fp32
        if quant:
            return ln_linear_i8(narrow(x), norm.scale, norm.bias, w,
                                proj.kernel_scale, proj.bias,
                                geglu=geglu).to(x.dtype)
        return ln_linear(narrow(x), norm.scale, norm.bias,
                         kernel_weight(proj), proj.bias,
                         geglu=geglu).to(x.dtype)
    if norm is not None:
        x = layer_norm(norm, x)
    h = linear(proj.dequantized(x.dtype), x)
    if not geglu:
        return h
    value, gate = h.chunk(2, dim=-1)
    return value * F.gelu(gate.float()).to(x.dtype)


class SelfAttention(nn.Module):
    def __init__(self, dim, *, heads, head_dim, dtype, device):
        super().__init__()
        inner = heads * head_dim
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.to_qkv = Linear(dim, 3 * inner, bias=False, **kw)
        self.to_out = Linear(inner, dim, **kw)

    def forward(self, x, *, garment_feat=None, garment_uncond_zero=False,
                norm=None, impl=None):
        """Keys/values span [own | garment] tokens when ``garment_feat``
        (B, M, C) is given, or (B/2, M, C) with ``garment_uncond_zero``:
        the leading B/2 (CFG uncond) rows then see all-zero garment KV."""
        heads = self.heads
        b = x.shape[0]
        inner = self.to_out.kernel.shape[0]
        qkv = _ln_proj(x, norm, self.to_qkv, impl=impl)
        kv_g = None
        if garment_feat is not None:
            # garment tokens only contribute K/V: the KV columns of to_qkv
            # (of an int8 to_qkv, dequantized: a bf16 GEMM, not a W8A8 site)
            wk = self.to_qkv.dequantized(qkv.dtype).kernel[:, inner:]
            kv_g = torch.matmul(garment_feat.to(qkv.dtype), wk.to(qkv.dtype))
        if (resolve(impl, x) == "cuda"
                and flash_attention_gemm_supported(qkv, heads)):
            uncond = 0
            if kv_g is not None and garment_uncond_zero:
                if 2 * garment_feat.shape[0] != b:
                    raise ValueError(f"garment_feat {tuple(garment_feat.shape)}"
                                     f" is not the cond half of batch {b}")
                uncond = b // 2
            out = flash_attention_gemm(narrow(qkv), narrow(kv_g),
                                       heads=heads, uncond_rows=uncond,
                                       fixed_shift=_fixed_shift())
            return linear(self.to_out, out.to(qkv.dtype))
        q = _split_heads(qkv[..., :inner], heads)
        k = _split_heads(qkv[..., inner:2 * inner], heads)
        v = _split_heads(qkv[..., 2 * inner:], heads)
        if kv_g is not None:
            if garment_uncond_zero:
                kv_g = torch.cat([torch.zeros_like(kv_g), kv_g], 0)
            out = concat_kv_attention(q, k, v,
                                      _split_heads(kv_g[..., :inner], heads),
                                      _split_heads(kv_g[..., inner:], heads),
                                      impl=impl)
        else:
            out = sdpa(q, k, v, impl=impl)
        return linear(self.to_out, _merge_heads(out))


class CrossAttention(nn.Module):
    def __init__(self, dim, *, context_dim, heads, head_dim,
                 ip_adapter=False, dtype, device):
        super().__init__()
        inner = heads * head_dim
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False, **kw)
        self.to_kv = Linear(context_dim, 2 * inner, bias=False, **kw)
        self.to_out = Linear(inner, dim, **kw)
        self.to_kv_ip = (Linear(context_dim, 2 * inner, bias=False, **kw)
                         if ip_adapter else None)

    def forward(self, x, context, *, ip_num_tokens=0, ip_scale=1.0,
                norm=None, impl=None):
        """``context`` is (B, S_text [+ ip_num_tokens], C); with
        ``to_kv_ip`` the trailing IP tokens get their own K/V and an
        independently normalized softmax (IPAttnProcessor2_0)."""
        heads = self.heads
        with_ip = self.to_kv_ip is not None and ip_num_tokens > 0
        if resolve(impl, x) == "cuda" and cross_attention_small_kv_supported(
                self.to_out.kernel.shape[0], heads, context.shape[1]):
            # GEMM-layout small-KV kernel (JAX attention.py:170-187): both
            # softmaxes in one pass over q, no split-heads copies
            q = _ln_proj(x, norm, self.to_q, impl=impl)
            if with_ip:
                out = cross_attention_small_kv(
                    narrow(q),
                    narrow(linear(self.to_kv, context[:, :-ip_num_tokens])),
                    narrow(linear(self.to_kv_ip,
                                  context[:, -ip_num_tokens:])),
                    heads=heads, ip_scale=ip_scale)
            else:
                out = cross_attention_small_kv(
                    narrow(q), narrow(linear(self.to_kv, context)),
                    heads=heads)
            return linear(self.to_out, out.to(q.dtype))
        q = _split_heads(_ln_proj(x, norm, self.to_q, impl=impl), heads)

        def kv(p, ctx):
            h = linear(p, ctx).reshape(ctx.shape[0], ctx.shape[1], 2, heads,
                                       -1)
            return h[:, :, 0], h[:, :, 1]

        if with_ip:
            k, v = kv(self.to_kv, context[:, :-ip_num_tokens])
            k_ip, v_ip = kv(self.to_kv_ip, context[:, -ip_num_tokens:])
            out = decoupled_ip_attention(q, k, v, k_ip, v_ip,
                                         ip_scale=ip_scale)
        else:
            k, v = kv(self.to_kv, context)
            out = sdpa(q, k, v, impl=impl)
        return linear(self.to_out, _merge_heads(out))


class FeedForward(nn.Module):
    """GEGLU feed-forward: proj_in (dim, 2*4dim) laid out [value | gate]."""

    def __init__(self, dim, *, mult=4, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.proj_in = Linear(dim, dim * mult * 2, **kw)
        self.proj_out = Linear(dim * mult, dim, **kw)

    def forward(self, x, *, norm=None, impl=None):
        h = _ln_proj(x, norm, self.proj_in, geglu=True, impl=impl)
        return linear(self.proj_out, h)


class TransformerBlock(nn.Module):
    def __init__(self, dim, *, heads, head_dim, context_dim,
                 ip_adapter=False, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = Norm(dim, device=device)
        self.attn1 = SelfAttention(dim, heads=heads, head_dim=head_dim, **kw)
        self.norm2 = Norm(dim, device=device)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=heads,
                                    head_dim=head_dim, ip_adapter=ip_adapter,
                                    **kw)
        self.norm3 = Norm(dim, device=device)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x, context, *, garment_mode="none", garment_feat=None,
                garment_uncond_zero=False, ip_num_tokens=0, ip_scale=1.0,
                impl=None):
        """Returns (hidden_states, emitted garment feature or None)."""
        emitted = None
        if garment_mode == "emit":
            # the LN output is the emitted feature, so it cannot fuse into
            # the QKV GEMM; the standalone LN kernel runs here instead
            if resolve(impl, x) == "cuda" and supports_fused_ln(x):
                h = fused_layer_norm(narrow(x), self.norm1.scale,
                                     self.norm1.bias).to(x.dtype)
            else:
                h = layer_norm(self.norm1, x)
            emitted = h
            x = x + self.attn1(h, impl=impl)
        else:
            x = x + self.attn1(
                x, norm=self.norm1,
                garment_feat=garment_feat if garment_mode == "consume"
                else None,
                garment_uncond_zero=garment_uncond_zero, impl=impl)
        x = x + self.attn2(x, context, norm=self.norm2,
                           ip_num_tokens=ip_num_tokens, ip_scale=ip_scale,
                           impl=impl)
        x = x + self.ff(x, norm=self.norm3, impl=impl)
        return x, emitted


def quantize_unet_linears_int8(unet: nn.Module, *,
                               attn_qkv: bool = True) -> nn.Module:
    """Quantize every transformer block's ``attn1.to_qkv`` and
    ``ff.proj_in`` in place (JAX ``ops.quant.quantize_unet_linears_int8``,
    which returns a new tree; in place, the bf16 weights are freed on the
    card); returns ``unet``.

    ``attn_qkv=False`` skips ``to_qkv``: pass it for the GarmentNet (emit)
    tower, whose self-attention runs on the emitted post-norm1 states with
    no fused LayerNorm, so a quantized ``to_qkv`` would never reach the W8A8
    kernel and would only add weight rounding error."""
    blocks = [m for m in unet.modules() if isinstance(m, TransformerBlock)]
    for blk in blocks:
        if attn_qkv:
            blk.attn1.to_qkv = quantize_linear_int8(blk.attn1.to_qkv)
        blk.ff.proj_in = quantize_linear_int8(blk.ff.proj_in)
    return weights_changed_(unet)
