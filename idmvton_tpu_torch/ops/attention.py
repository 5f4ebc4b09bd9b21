"""Attention ops (counterpart of ``idmvton_tpu/ops/attention.py``).

- ``sdpa``                   -- scaled dot-product attention.
- ``concat_kv_attention``    -- q against [own KV | garment KV], the
  reference's ``attn(cat([x, g], seq))[:, :N]``.
- ``decoupled_ip_attention`` -- IP-Adapter: two softmaxes (text, image)
  summed, not one softmax over the concatenated context.

Shapes: q (B, Sq, H, D); k/v (B, Skv, H, D). The plain path is matmul +
softmax (not SDPA) so the numerics follow the JAX formula: fp32 logits and
softmax, probabilities cast to the input type for the PV product.

``sdpa`` and ``concat_kv_attention`` dispatch as the JAX ops do: the
``"cuda"`` impl takes ``cuda_attention.flash_attention`` (which itself
keeps up to 256 keys on the plain formula, as the JAX kernel wrapper does;
above that an fp32 stack hands the kernel bf16 operands), the ``"torch"``
impl the plain path. The UNets' self-attention reaches the
kernel where ``flash_attention_gemm`` does not take its head layout; the
text, vision, Resampler and VAE attention pass ``impl="torch"``, as the JAX
package passes ``impl="xla"`` there. ``decoupled_ip_attention`` (77 + 16
tokens) is plain on every device, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from idmvton_tpu_torch.ops.dispatch import narrow, resolve


def softmax_(x):
    """In-place softmax over the last axis (max-subtracted, as
    ``jax.nn.softmax``); saves a second logits-sized buffer."""
    x.sub_(x.amax(-1, keepdim=True))
    x.exp_()
    x.div_(x.sum(-1, keepdim=True))
    return x


def attend(q, k, v, scale: float, mask=None):
    """softmax(q k^T * scale [masked]) v with fp32 logits; mask (Sq, Skv)
    bool, False entries get -1e9 (the CLIP text towers' causal mask)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits.mul_(scale)
    if mask is not None:
        logits.masked_fill_(~mask, -1e9)
    p = softmax_(logits).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def sdpa(q, k, v, *, scale: Optional[float] = None,
         impl: Optional[str] = None):
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if resolve(impl, q) == "cuda":
        from idmvton_tpu_torch.ops.cuda_attention import (
            XLA_KV_CUTOFF, flash_attention,
        )
        if k.shape[1] > XLA_KV_CUTOFF:   # the kernel: bf16 operands
            return flash_attention(narrow(q), narrow(k), narrow(v),
                                   scale=scale).to(q.dtype)
        return flash_attention(q, k, v, scale=scale)
    return attend(q, k, v, scale)


def concat_kv_attention(q, k, v, k_ref, v_ref, *,
                        scale: Optional[float] = None,
                        impl: Optional[str] = None):
    """q (B,N,H,D) against concat([own KV, garment KV]) on the sequence axis;
    equals the reference's ``attn(cat([x, g]))[:, :N]``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if resolve(impl, q) == "cuda":
        from idmvton_tpu_torch.ops.cuda_attention import (
            XLA_KV_CUTOFF, flash_attention_concat_kv,
        )
        if k.shape[1] + k_ref.shape[1] > XLA_KV_CUTOFF:   # the kernel
            return flash_attention_concat_kv(
                *(narrow(t) for t in (q, k, v, k_ref, v_ref)),
                scale=scale).to(q.dtype)
        return flash_attention_concat_kv(q, k, v, k_ref, v_ref, scale=scale)
    return attend(q, torch.cat([k, k_ref], 1), torch.cat([v, v_ref], 1),
                  scale)


def decoupled_ip_attention(q, k_text, v_text, k_ip, v_ip, *,
                           ip_scale: float = 1.0,
                           scale: Optional[float] = None):
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out_text = attend(q, k_text, v_text, scale)
    out_ip = attend(q, k_ip, v_ip, scale)
    # ip_scale rounded to the activations' type on the host, as a tensor of
    # that type would hold it, then a scalar product: no per-call tensor on
    # the device, nothing copied from the host (capturable)
    ip_scale = torch.tensor(ip_scale, dtype=out_text.dtype).item()
    return out_text + ip_scale * out_ip
