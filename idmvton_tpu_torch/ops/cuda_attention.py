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
separately, of the 16 IP tokens, in GEMM layouts end to end (TMA boxes and
``wgmma``, its geometry from ``cross_attention_plan``); its plain version
is ``cross_attention_small_kv_torch``.

``flash_attention`` / ``flash_attention_concat_kv`` /
``flash_attention_fused_qkv`` (``csrc/flash_attention.cu``, counterparts of
the Pallas ``_flash_kernel`` / ``_flash_kernel_fused``) take (B, S, H, D)
heads of any D = 8..128 (a multiple of 8), read through their strides; the
self-attention of head layouts ``flash_attention_gemm`` does not take runs
them. Plain versions: the ``*_torch`` functions (JAX ``_xla_ref_bhsd``).

Both attention sources instantiate one templated kernel
(``csrc/flash_attention.cuh``: TMA boxes, an mbarrier ring, ``wgmma`` with
the softmax in registers). ``attention_plan`` decides its launch geometry
from the shape alone -- the instance, the grid and every tensor map -- and
the C entry points encode and launch what it gives them.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import threading
from typing import NamedTuple, Optional

import torch

from idmvton_tpu_torch.ops import _build
from idmvton_tpu_torch.ops.attention import (
    attend, concat_kv_attention, sdpa, softmax_,
)
from idmvton_tpu_torch.ops.cuda_conv import (
    INT32_MAX, SMS, TensorMap, _sm_count,
)

_LANE = 128
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# up to this many keys the JAX flash_attention takes its XLA einsum path
# (the default of pallas_attention.py:45)
XLA_KV_CUTOFF = 256
# the fixed-shift softmax's clamp on a scaled logit (pallas_attention.py:
# 244, csrc/flash_attention.cuh::CLAMP)
FIXED_SHIFT_CLAMP = 60.0


# ---------------------------------------------------------------------------
# the launch plan of csrc/flash_attention.cuh
# ---------------------------------------------------------------------------

# keys a K/V tile by padded head dim DP (KERNEL_HEAD_DIMS, the kernel's DP
# instances): the fastest of scripts/torch_attention_tiles.py's
# sweep at the path's shapes (D = 16 and 64, both softmax modes, read on an
# H100 80GB HBM3 at 700 W), with the ring depth (3) and the consumers'
# turn-taking (on) that flash_attention.cuh fixes; D = 32 and 128 reach no
# path shape and take their neighbours'
BKV = {16: 128, 32: 128, 64: 128, 128: 64}
# (DP, BKV, consumer warpgroups) the kernel is built for
# (flash_attention.cuh::dispatch): BKV's tile with the 2 or 3 warpgroups
# the plan weighs. A block holds 64 queries a consumer warpgroup; three
# leave a consumer 160 registers, too few for DP = 128
INSTANCES = frozenset([(16, 128, 2), (16, 128, 3), (32, 128, 2),
                       (32, 128, 3), (64, 128, 2), (64, 128, 3),
                       (128, 64, 2)])
# Three warpgroups ran at 490 TFLOP/s where two ran at 430 (D = 64, fixed
# shift, the same sweep), but a 192-query tile quantizes a short sequence
# into a wave more: the plan takes the warpgroups of fewer waves x tile
# time at these rates
WGS_TFLOPS = {2: 430, 3: 490}
# TMA limits: a dimension below 2**32 elements, a stride below 2**40 bytes
_TMA_DIM, _TMA_STRIDE = 2**32, 2**40


class AttentionPlan(NamedTuple):
    dp: int                 # padded head dim: the kernel's DP instance
    bkv: int                # keys a K/V tile
    wgs: int                # consumer warpgroups: 64 queries each
    q_tiles: int            # 64 * wgs-query tiles of a (batch row, head)
    grid: int               # blocks: q_tiles x heads x batch, query fastest
    own_tiles: int          # K/V tiles over the own keys
    garm_tiles: int         # and over the garment keys (rows >= uncond)
    uncond: int             # leading rows of the analytic garment sink
    heads0: tuple           # head coordinates of Q, K, V, garment K, V
    q_map: TensorMap        # dims (D, heads, rows, batch), innermost first
    k_map: TensorMap
    v_map: TensorMap
    kg_map: Optional[TensorMap]   # garment K / V (None: no garment read)
    vg_map: Optional[TensorMap]
    c_plan: ctypes.Array    # all of the above as the C entry points read it


def _heads_map(d, dp, heads, rows, batch, row_stride, batch_stride,
               box_rows) -> TensorMap:
    """Head columns of a (batch, rows, heads, d) view with head stride d,
    boxed (min(dp, 64), 1, box_rows, 1) under the swizzle of the box row
    (TMA zero-fills the columns past d)."""
    box = min(dp, 64)
    return TensorMap((d, heads, rows, batch),
                     (2 * d, 2 * row_stride, 2 * batch_stride),
                     (box, 1, box_rows, 1), 2 * box)


def _c_plan(fields, maps) -> ctypes.Array:
    """A C entry point's Plan (flash_attention.cuh's, ln_linear.cu's,
    ln_linear_i8.cu's, cross_attention_small_kv.cu's): the int64 fields,
    then each map's dims, byte strides, box, swizzle and element size (zeros
    where there is no map: only 4-D maps are optional)."""
    vals = list(fields)
    for t in maps:
        vals += [*t.dims, *t.strides, *t.box, t.swizzle, t.elem] if t \
            else [0] * 13
    return (ctypes.c_longlong * len(vals))(*vals)


@functools.lru_cache(maxsize=1024)
def attention_plan(b: int, sq: int, skv: int, heads: int, d: int, *,
                   m: int = 0, uncond_rows: int = 0, strides=None,
                   tile=None, sms: int = SMS) -> AttentionPlan:
    """Launch geometry of the attention kernel. ``strides`` None: the
    ``flash_attention_gemm`` layout, q/k/v the sections of a (b, sq, 3 *
    heads * d) to_qkv output (skv == sq) and, for m > 0, a garment K|V
    (b - uncond_rows, m, 2 * heads * d); else the (batch, row) element
    strides of q, k and v (and, for m > 0, of the garment k and v, (b, m,
    heads, d) keys after skv), (b, sq|skv, heads, d) views with head stride
    d. The tile (BKV, consumer warpgroups) is ``tile`` or ``BKV``'s for the
    padded head dim with the warpgroups of least waves on ``sms`` SMs x
    tile time (``WGS_TFLOPS``). Raises on what the kernel cannot take; a
    forced tile that the library was not built with raises at launch."""
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"attention kernel: head dim {d} (a multiple of 8 "
                         f"up to 128)")
    if min(b, sq, skv, heads) < 1 or m < 0:
        raise ValueError(f"attention kernel: b {b}, sq {sq}, skv {skv}, "
                         f"heads {heads}, m {m}")
    dp = next(p for p in KERNEL_HEAD_DIMS if p >= d)
    if tile is None:
        wgs = min((w for w in (3, 2) if (dp, BKV[dp], w) in INSTANCES),
                  key=lambda w: (-(-b * heads * -(-sq // (64 * w)) // sms)
                                 * w / WGS_TFLOPS[w]))
        tile = (BKV[dp], wgs)
    if len(tile) != 2:
        raise ValueError(f"attention kernel: tile {tile} is not (BKV, "
                         f"consumer warpgroups)")
    bkv, wgs = tile
    # the kernel's template: BKV 64 or 128, 2 or 3 consumer warpgroups, 2
    # at DP = 128 (registers)
    if bkv not in (64, 128) or wgs not in (2, 3) or (dp == 128 and wgs > 2):
        raise ValueError(f"attention kernel: no instance (D {dp}, BKV {bkv},"
                         f" {wgs} warpgroups)")
    bq = 64 * wgs
    garm_rows = 0
    if strides is None:
        if skv != sq:
            raise ValueError(f"attention kernel: the to_qkv layout has "
                             f"skv == sq, got {skv} != {sq}")
        if not 0 <= uncond_rows <= b:
            raise ValueError(f"attention kernel: uncond_rows {uncond_rows} "
                             f"of {b}")
        ld = 3 * heads * d
        q_map = _heads_map(d, dp, 3 * heads, sq, b, ld, sq * ld, bq)
        k_map = v_map = _heads_map(d, dp, 3 * heads, sq, b, ld, sq * ld, bkv)
        kg_map = vg_map = None
        if m > 0 and uncond_rows < b:
            garm_rows = b - uncond_rows
            kg_map = vg_map = _heads_map(d, dp, 2 * heads, m, garm_rows,
                                         2 * heads * d, 2 * heads * d * m,
                                         bkv)
        heads0 = (0, heads, 2 * heads, 0, heads)
    else:
        if uncond_rows:
            raise ValueError("attention kernel: uncond rows are the to_qkv "
                             "layout's")
        if (len(strides) != (10 if m else 6)
                or any(st % 8 or st < 0 for st in strides)):
            raise ValueError(f"attention kernel: strides {strides} are not "
                             f"{10 if m else 6} multiples of 8")
        qb, qr, kb, kr, vb, vr = strides[:6]
        q_map = _heads_map(d, dp, heads, sq, b, qr, qb, bq)
        k_map = _heads_map(d, dp, heads, skv, b, kr, kb, bkv)
        v_map = _heads_map(d, dp, heads, skv, b, vr, vb, bkv)
        kg_map = vg_map = None
        if m:
            garm_rows = b
            kg_map = _heads_map(d, dp, heads, m, b, strides[7], strides[6],
                                bkv)
            vg_map = _heads_map(d, dp, heads, m, b, strides[9], strides[8],
                                bkv)
        heads0 = (0, 0, 0, 0, 0)
    for tmap in (q_map, k_map, v_map, kg_map, vg_map):
        if tmap is not None and (max(tmap.dims) >= _TMA_DIM
                                 or max(tmap.strides) >= _TMA_STRIDE):
            raise ValueError(f"attention kernel: a tensor map of dims "
                             f"{tmap.dims} exceeds TMA's limits")
    q_tiles = -(-sq // bq)
    grid = q_tiles * heads * b
    if grid > INT32_MAX:
        raise ValueError(f"attention kernel: {grid} blocks overflow int32")
    fields = (dp, bkv, wgs, q_tiles, grid, -(-skv // bkv),
              -(-m // bkv) if garm_rows else 0, uncond_rows if m else 0,
              heads0)
    maps = (q_map, k_map, v_map, kg_map, vg_map)
    return AttentionPlan(*fields, *maps,
                         _c_plan(fields[:-1] + heads0, maps))


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


def _flash_launch(q, k, v, scale, tile=None, k_ref=None, v_ref=None):
    """Launches the kernel on (B, S, H, D) views, over k / v then (when
    given) k_ref / v_ref; ``tile`` forces the plan's (BKV, consumer
    warpgroups), as scripts/torch_attention_tiles.py does."""
    _build.no_autograd("flash_attention", q, k, v, k_ref, v_ref)
    b, sq, heads, d = q.shape
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"flash_attention kernel: head dim {d} (a multiple "
                         f"of 8 up to 128)")
    skv = k.shape[1]
    if tuple(k.shape) != (b, skv, heads, d) or k.shape != v.shape or skv < 1:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    views = [("q", q), ("k", k), ("v", v)]
    m = 0
    if k_ref is not None:
        m = k_ref.shape[1]
        if (tuple(k_ref.shape) != (b, m, heads, d)
                or k_ref.shape != v_ref.shape or m < 1):
            raise ValueError(f"k_ref {tuple(k_ref.shape)} / v_ref "
                             f"{tuple(v_ref.shape)} do not match q "
                             f"{tuple(q.shape)}")
        views += [("k_ref", k_ref), ("v_ref", v_ref)]
    strides = tuple(st for name, t in views
                    for st in _flash_strides(t, name, heads, d))
    dev = q.device
    ptrs = [_build.ptr(t, name, torch.bfloat16, dev, contiguous=False)
            for name, t in views] + [None] * (5 - len(views))
    plan = attention_plan(b, sq, skv, heads, d, m=m, strides=strides,
                          tile=tile, sms=_sm_count(dev.index))
    out = torch.empty(b, sq, heads, d, dtype=q.dtype, device=dev)
    _build.call("idm_flash_attention", *ptrs,
                _build.ptr(out, "out", torch.bfloat16), b, sq, skv, m, heads,
                d, float(scale), plan.c_plan, _build.stream_ptr(dev))
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
    """q against [own KV | garment KV] on the sequence axis, as the JAX
    function's concatenation then ``flash_attention``: up to
    ``XLA_KV_CUTOFF`` keys in all the plain formula, above it the kernel,
    which reads the garment K/V as a second key segment (no concatenated
    copy) and counts as a ``flash_attention`` launch."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if k.shape[1] + k_ref.shape[1] <= XLA_KV_CUTOFF:
        return flash_attention_concat_kv_torch(q, k, v, k_ref, v_ref,
                                               scale=scale)
    out = _flash_launch(q, k, v, scale, k_ref=k_ref, v_ref=v_ref)
    flash_attention.launches += 1
    return out


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
                               sink_tokens: int = 0, uncond_rows: int = 0,
                               fixed_shift: bool = False):
    """Plain version: the exact softmax (JAX ``_gemm_ref_xla``), or with
    ``fixed_shift`` the kernel's fixed-shift formula, p = exp(min(logit,
    60)) normalized by its sum, which differs from the exact softmax only
    where logits pass the clamp."""
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
    if not fixed_shift:
        return attend(q, k, v, scale).reshape(b, n, hd)
    p = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p.mul_(scale).clamp_max_(FIXED_SHIFT_CLAMP).exp_()
    p.div_(p.sum(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(qkv.dtype).reshape(b, n, hd)


def flash_attention_gemm(qkv, kv_ref=None, *, heads: int,
                         scale: Optional[float] = None,
                         sink_tokens: int = 0, uncond_rows: int = 0,
                         fixed_shift: bool = True):
    """qkv (B, N, 3*H*D) bf16; kv_ref (B - uncond_rows, M, 2*H*D) bf16 or
    None. Returns (B, N, H*D) bf16. The model's site passes
    ``fixed_shift=fixed_shift_enabled()``, read at its call."""
    out = _gemm_launch(qkv, kv_ref, heads, scale, sink_tokens, uncond_rows,
                       fixed_shift)
    flash_attention_gemm.launches += 1
    return out


flash_attention_gemm.launches = 0


# ---------------------------------------------------------------------------
# the fixed-shift switch (pallas_attention.py::_fixed_shift and its
# load-time calibration)
# ---------------------------------------------------------------------------

# Set by calibrate_fixed_shift() when a checkpoint's live logits exceed the
# clamp (60): forces the exact online-max softmax for the rest of the
# process.
_FIXED_SHIFT_FORCED_OFF = False
# serializes the calibration's A/B, which sets the environment and the flag
_CALIBRATE_LOCK = threading.Lock()


def fixed_shift_enabled() -> bool:
    """Fixed-shift softmax (the default): p = exp(min(logit, 60)) with no
    running max, exact for every logit <= 60. ``IDMVTON_FLASH_FIXED_SHIFT=0``
    or a failed calibration selects the online-max softmax. Read at every
    call of the self-attention site."""
    if _FIXED_SHIFT_FORCED_OFF:
        return False
    return os.environ.get("IDMVTON_FLASH_FIXED_SHIFT", "1") == "1"


def _gemm_attention(qkv, kv_ref, **kw):
    """``flash_attention_gemm`` in the switch's mode: the kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    fn = flash_attention_gemm if qkv.is_cuda else flash_attention_gemm_torch
    return fn(qkv, kv_ref, fixed_shift=fixed_shift_enabled(), **kw)


def calibrate_fixed_shift(qkv, kv_ref=None, *, tol: float = 5e-3,
                          **kw) -> dict:
    """Load-time guard for a new or fine-tuned checkpoint: A/B the
    fixed-shift softmax against the online-max softmax on one batch of real
    projected activations (the to_qkv output of the hottest attention site;
    kwargs go to ``flash_attention_gemm``, ``heads=`` required). If the max
    |difference| exceeds ``tol`` (logits above the clamp equalize), force
    the online-max softmax for the rest of the process; a clean calibration
    clears an earlier force-off. Returns {"max_error", "fixed_shift"}. The
    site reads the switch at every call, so the result holds from the next
    call on."""
    global _FIXED_SHIFT_FORCED_OFF
    with _CALIBRATE_LOCK:
        err = _fixed_shift_max_error_locked(qkv, kv_ref, **kw)
        _FIXED_SHIFT_FORCED_OFF = err > tol
        if _FIXED_SHIFT_FORCED_OFF:
            logging.getLogger(__name__).warning(
                "fixed-shift softmax miscalibrated for this checkpoint "
                "(max_error %.3g > tol %.3g): online-max softmax "
                "process-wide", err, tol)
        return {"max_error": err, "fixed_shift": not _FIXED_SHIFT_FORCED_OFF}


def fixed_shift_max_error(qkv, kv_ref=None, **kw) -> float:
    """Max |fixed-shift - online-max| of ``flash_attention_gemm`` on these
    activations (kwargs as ``calibrate_fixed_shift``)."""
    with _CALIBRATE_LOCK:
        return _fixed_shift_max_error_locked(qkv, kv_ref, **kw)


def _fixed_shift_max_error_locked(qkv, kv_ref=None, **kw) -> float:
    global _FIXED_SHIFT_FORCED_OFF
    old = os.environ.get("IDMVTON_FLASH_FIXED_SHIFT")
    old_forced = _FIXED_SHIFT_FORCED_OFF
    try:
        _FIXED_SHIFT_FORCED_OFF = False   # the A/B runs both softmaxes
        os.environ["IDMVTON_FLASH_FIXED_SHIFT"] = "1"
        a = _gemm_attention(qkv, kv_ref, **kw)
        os.environ["IDMVTON_FLASH_FIXED_SHIFT"] = "0"
        b = _gemm_attention(qkv, kv_ref, **kw)
    finally:
        _FIXED_SHIFT_FORCED_OFF = old_forced
        if old is None:
            os.environ.pop("IDMVTON_FLASH_FIXED_SHIFT", None)
        else:
            os.environ["IDMVTON_FLASH_FIXED_SHIFT"] = old
    return float((a.float() - b.float()).abs().max())


def _gemm_launch(qkv, kv_ref, heads, scale, sink_tokens, uncond_rows,
                 fixed_shift, tile=None):
    """Launches the kernel on a to_qkv output; ``tile`` forces the plan's
    (BKV, consumer warpgroups), as scripts/torch_attention_tiles.py
    does."""
    _build.no_autograd("flash_attention_gemm", qkv, kv_ref)
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
    dev = qkv.device
    ptrs = (_build.ptr(qkv, "qkv", torch.bfloat16),
            _build.ptr(kv_ref, "kv_ref", torch.bfloat16, dev))
    plan = attention_plan(b, n, n, heads, d, m=m, uncond_rows=uncond_rows,
                          tile=tile, sms=_sm_count(dev.index))
    out = torch.empty(b, n, hd, dtype=qkv.dtype, device=dev)
    _build.call("idm_flash_attention_gemm", *ptrs,
                _build.ptr(out, "out", torch.bfloat16),
                b, n, m, heads, d, int(sink_tokens), float(scale),
                int(fixed_shift), plan.c_plan, _build.stream_ptr(dev))
    return out


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


CROSS_BQ, CROSS_GC = 128, 128   # queries a tile; columns a head group
CROSS_KC = (80, 16)             # key rows a chunk: text, IP


class CrossPlan(NamedTuple):
    dp: int                 # head dim: the kernel's instance
    groups: int             # 128-column head groups
    q_tiles: int            # 128-query tiles of a (batch row, group)
    tiles: int              # b * groups * q_tiles, query tiles fastest
    grid: int               # persistent blocks, each a contiguous range
    text_chunks: int        # CROSS_KC[0]-row chunks of the text context
    ip_chunks: int          # CROSS_KC[1]-row chunks of the IP context
    q_map: TensorMap        # q (B, N, H*D): dims (D, H, N, B)
    kv_map: TensorMap       # kv (B, S, 2*H*D): dims (D, 2H, S, B)
    ip_map: Optional[TensorMap]   # kv_ip, or None
    c_plan: ctypes.Array    # all of the above as the C entry point reads it


@functools.lru_cache(maxsize=1024)
def cross_attention_plan(b: int, n: int, heads: int, d: int, s_text: int,
                         s_ip: int = 0, sms: int = SMS) -> CrossPlan:
    """Launch geometry of the small-KV cross-attention kernel for q (b, n,
    heads * d) over kv (b, s_text, 2 * heads * d) and, for s_ip > 0, kv_ip
    (b, s_ip, 2 * heads * d): the tiles ((batch row, head group) outer, so a
    block's range keeps a group's K/V resident), the grid and the three
    tensor maps, each box one head's d columns (two 64-column boxes at d =
    128) of CROSS_BQ query or CROSS_KC key rows. Raises on what the kernel
    cannot take."""
    if d not in KERNEL_HEAD_DIMS or (heads * d) % CROSS_GC:
        raise ValueError(f"cross_attention_small_kv kernel: {heads} heads of "
                         f"{d} (H*D % 128 == 0, head dim one of "
                         f"{KERNEL_HEAD_DIMS})")
    if min(b, n, heads, s_text) < 1 or s_ip < 0:
        raise ValueError(f"cross_attention_small_kv kernel: b {b}, n {n}, "
                         f"heads {heads}, s_text {s_text}, s_ip {s_ip}")
    hd = heads * d
    groups = hd // CROSS_GC
    q_tiles = -(-n // CROSS_BQ)
    tiles = b * groups * q_tiles
    grid = min(tiles, sms)
    q_map = _heads_map(d, d, heads, n, b, hd, n * hd, CROSS_BQ)
    kv_map = _heads_map(d, d, 2 * heads, s_text, b, 2 * hd, s_text * 2 * hd,
                        CROSS_KC[0])
    ip_map = (_heads_map(d, d, 2 * heads, s_ip, b, 2 * hd, s_ip * 2 * hd,
                         CROSS_KC[1]) if s_ip else None)
    maps = (q_map, kv_map, ip_map)
    if tiles > INT32_MAX or any(
            t is not None and (max(t.dims) >= _TMA_DIM
                               or max(t.strides) >= _TMA_STRIDE)
            for t in maps):
        raise ValueError(f"cross_attention_small_kv kernel: q ({b}, {n}, "
                         f"{hd}) overflows its int32 tiles or TMA's limits")
    fields = (d, groups, q_tiles, tiles, grid, -(-s_text // CROSS_KC[0]),
              -(-s_ip // CROSS_KC[1]))
    return CrossPlan(*fields, *maps, _c_plan(fields, maps))


def cross_attention_small_kv(q, kv, kv_ip=None, *, heads: int,
                             scale: Optional[float] = None,
                             ip_scale: float = 1.0):
    """q (B, N, H*D) merged heads (the to_q output); kv (B, S_text, 2*H*D)
    the fused to_kv output [K | V]; kv_ip (B, S_ip, 2*H*D) or None. All
    bf16; returns (B, N, H*D) bf16. The launch geometry is
    ``cross_attention_plan``'s."""
    _build.no_autograd("cross_attention_small_kv", q, kv, kv_ip)
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
    ptrs = (_build.ptr(q, "q", torch.bfloat16),
            _build.ptr(kv, "kv", torch.bfloat16, dev),
            _build.ptr(kv_ip, "kv_ip", torch.bfloat16, dev),
            _build.ptr(out, "out", torch.bfloat16))
    s_ip = 0 if kv_ip is None else kv_ip.shape[1]
    if n == 0 or b == 0:
        return out
    plan = cross_attention_plan(b, n, heads, d, kv.shape[1], s_ip,
                                sms=_sm_count(dev.index))
    _build.call("idm_cross_attention_small_kv", *ptrs, b, n, heads, d,
                kv.shape[1], s_ip, float(scale), float(ip_scale),
                plan.c_plan, _build.stream_ptr(dev))
    cross_attention_small_kv.launches += 1
    return out


cross_attention_small_kv.launches = 0


def cross_kernel_enabled() -> bool:
    """The opt-in ``IDMVTON_CROSS_KERNEL=1``, read at every call of the
    cross-attention site."""
    return os.environ.get("IDMVTON_CROSS_KERNEL", "0") == "1"


def cross_attention_small_kv_supported(inner: int, heads: int,
                                       s_kv: int) -> bool:
    """JAX ``cross_attention_small_kv_supported``: opt-in through
    ``cross_kernel_enabled()``, H*D % 128 == 0, D divides 128, at most
    1024 context tokens; plus the kernel's 16-wide head-dim MMA steps
    (D >= 16)."""
    if not cross_kernel_enabled():
        return False
    d = inner // heads
    return (inner % _LANE == 0 and d <= _LANE and _LANE % d == 0
            and d in KERNEL_HEAD_DIMS and s_kv <= 1024)
