"""Flash attention over the fused-QKV GEMM output, garment KV and CFG sink;
small-KV cross-attention.

Counterpart of ``idmvton_tpu/ops/pallas_attention.py::flash_attention_gemm``.
``flash_attention_gemm`` launches ``csrc/flash_attention_gemm.cu`` on CUDA
tensors; ``flash_attention_gemm_torch`` is its plain version (the JAX oracle
``_gemm_ref_xla``: the zero garment KV of the uncond rows and the sink
tokens are materialized and an exact softmax is taken).

The kernel reads Q/K/V straight from the ``to_qkv`` output (B, N, 3*H*D),
attends over the own tokens then the garment K|V (B - uncond_rows, M,
2*H*D), gives the leading ``uncond_rows`` the analytic sink of M zero
logits (init m=0, l=M, no garment reads), and writes merged heads
(B, N, H*D). ``fixed_shift`` (default, as in the JAX package) takes
p = exp(min(s, 60)) with no running max -- exact softmax for every logit
<= 60 (the clamp of the code, pallas_attention.py:244, not the 80 some of
the JAX package's documents state); ``fixed_shift=False`` is the online-max
softmax.

``cross_attention_small_kv`` (``csrc/cross_attention_small_kv.cu``, the
opt-in ``IDMVTON_CROSS_KERNEL=1`` branch of cross-attention) attends the
to_q output over the fused to_kv output of the 77 text tokens and,
separately, of the 16 IP tokens, in GEMM layouts end to end; its plain
version is ``cross_attention_small_kv_torch``.

``flash_attention`` / ``flash_attention_concat_kv`` /
``flash_attention_fused_qkv`` (``csrc/flash_attention.cu``, counterparts of
the Pallas ``_flash_kernel`` / ``_flash_kernel_fused``) take (B, S, H, D)
heads of any D = 8..128 (a multiple of 8), read through their strides; the
self-attention of head layouts ``flash_attention_gemm`` does not take runs
them. Plain versions: the ``*_torch`` functions (JAX ``_xla_ref_bhsd``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from idmvton_tpu_torch.ops import _build
from idmvton_tpu_torch.ops.attention import (
    attend, concat_kv_attention, sdpa, softmax_,
)

_LANE = 128
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# up to this many keys the JAX flash_attention takes its XLA einsum path
# (the default of pallas_attention.py:45)
XLA_KV_CUTOFF = 256


# ---------------------------------------------------------------------------
# flash attention over (B, S, H, D) heads (replaces pallas_attention.py::
# flash_attention / flash_attention_concat_kv, _flash_kernel, and
# flash_attention_fused_qkv, _flash_kernel_fused)
# ---------------------------------------------------------------------------


def flash_attention_torch(q, k, v, *, scale: Optional[float] = None):
    """Plain version (JAX ``_xla_ref_bhsd`` in (B, S, H, D)): fp32 logits,
    the softmax normalized before the cast to q's type, PV accumulated in
    fp32 -- the plain ``sdpa``."""
    return sdpa(q, k, v, scale=scale, impl="torch")


def flash_attention_concat_kv_torch(q, k, v, k_ref, v_ref, *,
                                    scale: Optional[float] = None):
    return concat_kv_attention(q, k, v, k_ref, v_ref, scale=scale,
                               impl="torch")


def flash_attention_fused_qkv_torch(qkv, s_own: int, *,
                                    scale: Optional[float] = None):
    return flash_attention_torch(qkv[:, :s_own, 0], qkv[:, :, 1],
                                 qkv[:, :, 2], scale=scale)


def _flash_strides(t, name: str, heads: int, d: int):
    """(batch, row) strides of a (B, S, H, D) view the kernel reads in
    place: heads packed (stride D) and elements contiguous; every stride a
    multiple of 8 for the 16-byte copies."""
    if t.dim() != 4 or t.shape[2] != heads or t.shape[3] != d:
        raise ValueError(f"{name} {tuple(t.shape)}: expected (B, S, {heads}, "
                         f"{d})")
    sb, sr, sh, se = t.stride()
    if se != 1 or sh != d or sb % 8 or sr % 8:
        raise ValueError(f"{name}: strides {t.stride()} are not (8k, 8k, "
                         f"{d}, 1)")
    return sb, sr


def _flash_launch(q, k, v, scale):
    b, sq, heads, d = q.shape
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"flash_attention kernel: head dim {d} (a multiple "
                         f"of 8 up to 128)")
    skv = k.shape[1]
    if tuple(k.shape) != (b, skv, heads, d) or k.shape != v.shape or skv < 1:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    strides = [*_flash_strides(q, "q", heads, d),
               *_flash_strides(k, "k", heads, d),
               *_flash_strides(v, "v", heads, d)]
    out = torch.empty(b, sq, heads, d, dtype=q.dtype, device=q.device)
    dev = q.device
    _build.call("idm_flash_attention",
                _build.ptr(q, "q", torch.bfloat16, contiguous=False),
                _build.ptr(k, "k", torch.bfloat16, dev, contiguous=False),
                _build.ptr(v, "v", torch.bfloat16, dev, contiguous=False),
                _build.ptr(out, "out", torch.bfloat16),
                b, sq, skv, heads, d, *strides, *out.stride()[:2],
                float(scale), _build.stream_ptr(dev))
    return out


def flash_attention(q, k, v, *, scale: Optional[float] = None):
    """q (B, Sq, H, D), k/v (B, Skv, H, D) bf16 -> (B, Sq, H, D) bf16.

    Up to ``XLA_KV_CUTOFF`` keys this computes the plain formula, as the
    JAX function routes such shapes to its XLA einsum (pallas_attention.py:
    183-189): that is its own choice by shape, not a fallback. Above it, the
    kernel."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if k.shape[1] <= XLA_KV_CUTOFF:
        return flash_attention_torch(q, k, v, scale=scale)
    out = _flash_launch(q, k, v, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_concat_kv(q, k, v, k_ref, v_ref, *,
                              scale: Optional[float] = None):
    """q against [own KV | garment KV] on the sequence axis: the two K/V
    tensors are concatenated (as the JAX function does), then
    ``flash_attention``."""
    return flash_attention(q, torch.cat([k, k_ref], 1),
                           torch.cat([v, v_ref], 1), scale=scale)


def flash_attention_fused_qkv(qkv, s_own: int, *,
                              scale: Optional[float] = None):
    """qkv (B, St, 3, H, D) bf16, a fused projection over St tokens ->
    (B, s_own, H, D) bf16: the first ``s_own`` tokens' queries over all St
    keys and values, read in place from the one buffer. Always the kernel
    (the JAX function has no XLA cutoff)."""
    b, st, three, heads, d = qkv.shape
    if three != 3 or not 1 <= s_own <= st:
        raise ValueError(f"qkv {tuple(qkv.shape)} with s_own {s_own}")
    scale = scale if scale is not None else d ** -0.5
    out = _flash_launch(qkv[:, :s_own, 0], qkv[:, :, 1], qkv[:, :, 2], scale)
    flash_attention_fused_qkv.launches += 1
    return out


flash_attention_fused_qkv.launches = 0


def flash_attention_gemm_torch(qkv, kv_ref=None, *, heads: int,
                               scale: Optional[float] = None,
                               sink_tokens: int = 0, uncond_rows: int = 0):
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    scale = scale if scale is not None else d ** -0.5
    q = qkv[..., :hd].reshape(b, n, heads, d)
    k = qkv[..., hd:2 * hd].reshape(b, n, heads, d)
    v = qkv[..., 2 * hd:].reshape(b, n, heads, d)
    if kv_ref is not None:
        m = kv_ref.shape[1]
        kg = kv_ref[..., :hd].reshape(-1, m, heads, d)
        vg = kv_ref[..., hd:].reshape(-1, m, heads, d)
        if uncond_rows > 0:
            pad = kg.new_zeros(uncond_rows, m, heads, d)
            kg = torch.cat([pad, kg], 0)
            vg = torch.cat([pad, vg], 0)
        k = torch.cat([k, kg], 1)
        v = torch.cat([v, vg], 1)
    if sink_tokens > 0:
        z = k.new_zeros(b, sink_tokens, heads, d)
        k = torch.cat([k, z], 1)
        v = torch.cat([v, z], 1)
    return attend(q, k, v, scale).reshape(b, n, hd)


def flash_attention_gemm(qkv, kv_ref=None, *, heads: int,
                         scale: Optional[float] = None,
                         sink_tokens: int = 0, uncond_rows: int = 0,
                         fixed_shift: bool = True):
    """qkv (B, N, 3*H*D) bf16; kv_ref (B - uncond_rows, M, 2*H*D) bf16 or
    None. Returns (B, N, H*D) bf16."""
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    if three_hd != 3 * hd or hd != heads * d or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_gemm kernel: qkv {tuple(qkv.shape)}"
                         f" with {heads} heads (head dim must be one of "
                         f"{KERNEL_HEAD_DIMS})")
    m = 0
    if kv_ref is not None:
        m = kv_ref.shape[1]
        want = (b - uncond_rows, m, 2 * hd)
        if tuple(kv_ref.shape) != want:
            raise ValueError(f"kv_ref {tuple(kv_ref.shape)}, expected {want}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty(b, n, hd, dtype=qkv.dtype, device=qkv.device)
    dev = qkv.device
    _build.call("idm_flash_attention_gemm",
                _build.ptr(qkv, "qkv", torch.bfloat16),
                _build.ptr(kv_ref, "kv_ref", torch.bfloat16, dev),
                _build.ptr(out, "out", torch.bfloat16),
                b, n, m, heads, d, int(uncond_rows), int(sink_tokens),
                float(scale), int(fixed_shift), _build.stream_ptr(dev))
    flash_attention_gemm.launches += 1
    return out


flash_attention_gemm.launches = 0


def flash_attention_gemm_supported(qkv, heads: int) -> bool:
    """JAX ``flash_attention_gemm_supported`` (H*D % 128 == 0, D divides
    128), plus the kernel's 16-wide head-dim MMA steps (D >= 16). So D = 8
    with H*D a multiple of 128, which JAX gives to the GEMM-layout kernel,
    takes ``flash_attention`` here: the same function (no config of the repo
    has such a layout)."""
    inner = qkv.shape[-1] // 3
    d = inner // heads
    return (inner % _LANE == 0 and d <= _LANE and _LANE % d == 0
            and d in KERNEL_HEAD_DIMS)


# ---------------------------------------------------------------------------
# small-KV cross-attention (replaces pallas_attention.py::
# cross_attention_small_kv, _cross_small_kernel)
# ---------------------------------------------------------------------------


def cross_attention_small_kv_torch(q, kv, kv_ip=None, *, heads: int,
                                   scale: Optional[float] = None,
                                   ip_scale: float = 1.0):
    """Plain version (JAX ``_cross_small_xla``): per branch an fp32 softmax
    of fp32 logits, probabilities cast to q's type for the PV product with
    fp32 accumulation; the text and IP branch outputs are summed in fp32
    (``out_text + ip_scale * out_ip``) and cast once. (The decoupled
    IP-attention op casts each branch before the sum, so it is not this
    function's plain version.)"""
    b, n, hd = q.shape
    d = hd // heads
    scale = scale if scale is not None else d ** -0.5
    qh = q.reshape(b, n, heads, d).float()

    def branch(kvx):
        s = kvx.shape[1]
        k = kvx[..., :hd].reshape(b, s, heads, d).float()
        v = kvx[..., hd:].reshape(b, s, heads, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, k)
        logits.mul_(scale)
        p = softmax_(logits).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())

    out = branch(kv)
    if kv_ip is not None:
        out = out + ip_scale * branch(kv_ip)
    return out.to(q.dtype).reshape(b, n, hd)


def cross_attention_small_kv(q, kv, kv_ip=None, *, heads: int,
                             scale: Optional[float] = None,
                             ip_scale: float = 1.0):
    """q (B, N, H*D) merged heads (the to_q output); kv (B, S_text, 2*H*D)
    the fused to_kv output [K | V]; kv_ip (B, S_ip, 2*H*D) or None. All
    bf16; returns (B, N, H*D) bf16."""
    b, n, hd = q.shape
    d = hd // heads
    if hd != heads * d or d not in KERNEL_HEAD_DIMS or hd % _LANE:
        raise ValueError(f"cross_attention_small_kv kernel: q "
                         f"{tuple(q.shape)} with {heads} heads (H*D % 128 "
                         f"== 0, head dim one of {KERNEL_HEAD_DIMS})")
    for name, t in (("kv", kv), ("kv_ip", kv_ip)):
        if t is not None and (t.dim() != 3 or t.shape[0] != b
                              or t.shape[2] != 2 * hd or t.shape[1] < 1):
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    dev = q.device
    _build.call("idm_cross_attention_small_kv",
                _build.ptr(q, "q", torch.bfloat16),
                _build.ptr(kv, "kv", torch.bfloat16, dev),
                _build.ptr(kv_ip, "kv_ip", torch.bfloat16, dev),
                _build.ptr(out, "out", torch.bfloat16),
                b, n, heads, d, kv.shape[1],
                0 if kv_ip is None else kv_ip.shape[1],
                float(scale), float(ip_scale), _build.stream_ptr(dev))
    cross_attention_small_kv.launches += 1
    return out


cross_attention_small_kv.launches = 0


def cross_attention_small_kv_supported(inner: int, heads: int,
                                       s_kv: int) -> bool:
    """JAX ``cross_attention_small_kv_supported``: opt-in through
    ``IDMVTON_CROSS_KERNEL=1`` (read at call time), H*D % 128 == 0, D
    divides 128, at most 1024 context tokens; plus the kernel's 16-wide
    head-dim MMA steps (D >= 16)."""
    if os.environ.get("IDMVTON_CROSS_KERNEL", "0") != "1":
        return False
    d = inner // heads
    return (inner % _LANE == 0 and d <= _LANE and _LANE % d == 0
            and d in KERNEL_HEAD_DIMS and s_kv <= 1024)
