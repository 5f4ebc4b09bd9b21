"""LayerNorm + GEMM, standalone LayerNorm, GroupNorm statistics and apply.

Counterpart of ``idmvton_tpu/ops/pallas_norm.py``. Each kernel wrapper here
launches its CUDA kernel (``csrc/ln_linear.cu``, ``csrc/ln_linear_i8.cu``,
``csrc/gn_stats.cu``) on CUDA tensors and raises on anything else (CPU
tensors, types the kernel does not take: bf16 activations, int8 weights
for the W8A8 kernel, fp32 also for the GroupNorm kernels, a bf16 or
fp32 bias for ``ln_linear`` and ``ln_linear_i8``); the
``*_torch`` function beside it is its plain version (the JAX package's XLA
formula; for ``gn_apply``, which replaces no Pallas kernel, the tail the
JAX package leaves to XLA's fusion), which the sites take on CPU tensors
and which the tests and ``chip_smoke.py`` compare against. The
``*_supported`` predicates are shape conditions only, so a site never swaps
in the plain version for a CUDA tensor of the wrong type: the wrapper
raises.

All statistics are one-pass fp32 with the clamped variance
``var = max(E[x^2] - E[x]^2, 0)`` of the JAX package (not the two-pass
statistics of ``F.layer_norm`` / ``F.group_norm``).

``ln_linear_plan`` and ``ln_linear_i8_plan`` are the one source of the
``ln_linear`` and ``ln_linear_i8`` kernels' launch geometry (tile, grid and
tensor maps, passed to the C entry point as an int64 array), cached per
shape. The W8A8 kernel reads its int8 weight K-major: a (C, N)
``kernel_i8`` must be the transposed view of (N, C) storage, which
``ops.quant.quantize_kernel_int8`` returns and ``QuantLinear`` keeps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from idmvton_tpu_torch.ops import _build
from idmvton_tpu_torch.ops.cuda_attention import (
    _TMA_DIM, _TMA_STRIDE, _c_plan,
)
from idmvton_tpu_torch.ops.cuda_conv import (
    INT32_MAX, SMS, TensorMap, _cdiv, _sm_count,
)

_LANE = 128


# ---------------------------------------------------------------------------
# standalone LayerNorm (replaces pallas_norm.py::fused_layer_norm)
# ---------------------------------------------------------------------------


def layer_norm_torch(x, scale, bias, eps: float = 1e-5):
    """Plain LayerNorm over the last axis (JAX ``_xla_ln``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = xf.square().mean(-1, keepdim=True)
    var = (mean2 - mean.square()).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """x (..., C) bf16 with C % 128 == 0 up to 2048 (the kernel holds a row
    in registers); scale/bias (C,) fp32."""
    _build.no_autograd("fused_layer_norm", x, scale, bias)
    c = x.shape[-1]
    m = x.numel() // c
    if c % _LANE or not 0 < c <= 16 * _LANE:
        raise ValueError(f"fused_layer_norm kernel needs C % 128 == 0 and "
                         f"C <= 2048, got C={c}")
    out = torch.empty_like(x)
    dev = x.device
    _build.call("idm_layer_norm",
                _build.ptr(x, "x", torch.bfloat16),
                _build.ptr(scale, "scale", torch.float32, dev),
                _build.ptr(bias, "bias", torch.float32, dev),
                _build.ptr(out, "out", torch.bfloat16),
                m, c, float(eps), _build.stream_ptr(dev))
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0


def supports_fused_ln(x) -> bool:
    return x.shape[-1] % _LANE == 0


# ---------------------------------------------------------------------------
# LayerNorm + GEMM (+ GEGLU) (replaces pallas_norm.py::ln_linear)
# ---------------------------------------------------------------------------

LN_BM, LN_BK = 128, 64      # rows a tile; K a chunk (128-byte x box rows)
# B columns a ring stage (value + gate for GEGLU) csrc/ln_linear.cu is
# built for; a tile's output columns are BN, or BN / 2 for GEGLU
LN_TILES = (128, 256)
# TFLOP/s of each (BN, geglu) tile in a CUDA graph at the path's full-width
# shapes, read on an H100 80GB HBM3 at 700 W by scripts/torch_ln_tiles.py
# (4 stages): the plan's cost model
LN_TILE_TFLOPS = {(128, False): 260, (256, False): 380, (128, True): 260,
                  (256, True): 335}


class LnLinearPlan(NamedTuple):
    bn: int                 # B columns a ring stage: the instance
    geglu: bool
    vw: int                 # output columns a tile
    m_tiles: int            # 128-row blocks
    n_tiles: int            # vw-column tiles a row block
    tiles: int              # m_tiles * n_tiles, column tiles fastest
    grid: int               # persistent blocks, each a contiguous range
    kc: int                 # 64-deep K chunks
    x_map: TensorMap        # x (M, C): box (64, 128)
    w_map: TensorMap        # w (C, G * N): box (64, 64), MN-major B
    c_plan: ctypes.Array    # all of the above as the C entry point reads it


def _ln_tile_plan(m, c, n, geglu, bn, sms) -> LnLinearPlan:
    vw = bn // 2 if geglu else bn
    m_tiles, n_tiles = _cdiv(m, LN_BM), _cdiv(n, vw)
    tiles = m_tiles * n_tiles
    grid = min(tiles, sms)
    x_map = TensorMap((c, m), (2 * c,), (LN_BK, LN_BM), 128)
    n_total = (2 if geglu else 1) * n
    w_map = TensorMap((n_total, c), (2 * n_total,), (64, LN_BK), 128)
    fields = (bn, int(geglu), m_tiles, n_tiles, tiles, grid, n, c // LN_BK)
    return LnLinearPlan(bn, geglu, vw, m_tiles, n_tiles, tiles, grid,
                        c // LN_BK, x_map, w_map,
                        _c_plan(fields, (x_map, w_map)))


def _ln_cost(plan: LnLinearPlan) -> float:
    """Time of the busiest block: its tiles (a contiguous share of all),
    each 128 x bn x C at its tile's measured rate."""
    return (_cdiv(plan.tiles, plan.grid) * plan.bn
            / LN_TILE_TFLOPS[plan.bn, plan.geglu])


# a step has a dozen ln_linear shapes and each call would otherwise pay the
# plan's Python, so each shape is planned once
@functools.lru_cache(maxsize=1024)
def ln_linear_plan(m: int, c: int, n: int, geglu: bool = False, tile=None,
                   sms: int = SMS) -> LnLinearPlan:
    """Launch geometry of the ln_linear kernel for x (m, c) and w (c, n) or,
    for ``geglu``, (c, 2n) [value | gate]: n is the output width. The BN
    (B columns a ring stage) is ``tile`` or, of ``LN_TILES``, the one of
    least ``_ln_cost`` on ``sms`` SMs (then fewer tiles). Raises on what the
    kernel cannot take: C not a multiple of 64 (its K chunks), N not a
    multiple of 8 (16-byte W rows and output stores), or a coordinate past
    TMA's or int32's range."""
    if m < 1 or c < LN_BK or c % LN_BK or n < 8 or n % 8:
        raise ValueError(f"ln_linear kernel needs M >= 1, C % 64 == 0 and N "
                         f"% 8 == 0, got M={m}, C={c}, N={n}")
    if tile is not None:
        if tile not in LN_TILES:
            raise ValueError(f"ln_linear kernel: no BN {tile} in {LN_TILES}")
        plan = _ln_tile_plan(m, c, n, geglu, tile, sms)
    else:
        plan = min((_ln_tile_plan(m, c, n, geglu, bn, sms)
                    for bn in LN_TILES),
                   key=lambda p: (_ln_cost(p), p.tiles))
    if (max(plan.tiles, m, plan.w_map.dims[0]) > INT32_MAX
            or max(plan.x_map.dims + plan.w_map.dims) >= _TMA_DIM
            or max(plan.x_map.strides + plan.w_map.strides) >= _TMA_STRIDE):
        raise ValueError(f"ln_linear kernel: x ({m}, {c}) -> {n} overflows "
                         f"its int32 tile or TMA coordinates")
    return plan


def ln_linear_torch(x, gamma, beta, w, b=None, *, eps: float = 1e-5,
                    geglu: bool = False):
    """Plain LN -> GEMM (+ bias, + GEGLU) (JAX ``_ln_mm_xla``): the product,
    bias and GEGLU run in fp32 and round once at the end."""
    h = layer_norm_torch(x, gamma, beta, eps)
    y = torch.matmul(h.float(), w.to(h.dtype).float())
    if b is not None:
        y = y + b.float()
    if geglu:
        val, gate = y.chunk(2, dim=-1)
        y = val * F.gelu(gate)
    return y.to(x.dtype)


def ln_linear(x, gamma, beta, w, b=None, *, eps: float = 1e-5,
              geglu: bool = False, tile=None):
    """layer_norm(x) @ w (+ b), optionally with a GEGLU epilogue.

    x (..., C) bf16; gamma/beta (C,) fp32; w (C, N) bf16, or (C, 2N)
    laid out [value | gate] for ``geglu``; b (N,) or (2N,) bf16 or fp32
    (the kernel widens it) or None. Returns (..., N) bf16. ``tile`` forces
    the plan's BN, as scripts/torch_ln_tiles.py does. The sites send an
    int8-quantized projection to ``ln_linear_i8`` instead
    (``models.attention._ln_proj``)."""
    _build.no_autograd("ln_linear", x, gamma, beta, w, b)
    c = x.shape[-1]
    m = x.numel() // c
    n_out = w.shape[1] // (2 if geglu else 1)
    if (w.dim() != 2 or w.shape[0] != c
            or w.shape[1] != (2 if geglu else 1) * n_out
            or (b is not None and tuple(b.shape) != (w.shape[1],))):
        raise ValueError(f"ln_linear: x {tuple(x.shape)}, w {tuple(w.shape)}"
                         f", b {None if b is None else tuple(b.shape)}")
    dev = x.device
    x_ptr = _build.ptr(x, "x", torch.bfloat16)
    bias_bf16 = b is not None and b.dtype == torch.bfloat16
    ptrs = (_build.ptr(gamma, "gamma", torch.float32, dev),
            _build.ptr(beta, "beta", torch.float32, dev),
            _build.ptr(w, "w", torch.bfloat16, dev),
            _build.ptr(b, "b", torch.bfloat16 if bias_bf16 else torch.float32,
                       dev))
    out = torch.empty(*x.shape[:-1], n_out, dtype=x.dtype, device=dev)
    if m == 0:
        return out
    plan = ln_linear_plan(m, c, n_out, bool(geglu), tile,
                          sms=_sm_count(dev.index))
    # the kernel's statistics pre-pass writes (inv, -mean * inv) a row here
    stats = torch.empty(m, 2, dtype=torch.float32, device=dev)
    _build.call("idm_ln_linear", x_ptr, *ptrs, int(bias_bf16),
                _build.ptr(stats, "stats", torch.float32),
                _build.ptr(out, "out", torch.bfloat16), m, c, n_out,
                float(eps), plan.c_plan, _build.stream_ptr(dev))
    ln_linear.launches += 1
    return out


ln_linear.launches = 0


def ln_linear_supported(x, w, *, geglu: bool = False) -> bool:
    """JAX ``ln_linear_supported``: C and N multiples of 128 (within what
    ``ln_linear_plan`` takes)."""
    c = x.shape[-1]
    two = 2 if geglu else 1
    n_out = w.shape[1] // two
    return (c % _LANE == 0 and n_out % _LANE == 0
            and w.shape[1] == two * n_out)


# ---------------------------------------------------------------------------
# W8A8 int8 LayerNorm + GEMM (+ GEGLU) (replaces pallas_norm.py::ln_linear
# on a kernel_i8 projection, _ln_mm_kernel_i8)
# ---------------------------------------------------------------------------


I8_BM, I8_BK = 128, 128      # rows a tile; K bytes a chunk (128-byte rows)
# B rows a ring stage (value + gate for GEGLU) csrc/ln_linear_i8.cu is
# built for; a tile's output columns are BN, or BN / 2 for GEGLU
I8_TILES = (128, 256)
# TOP/s of each (BN, geglu) tile in a CUDA graph at the variant path's
# full-width shapes, read on an H100 80GB HBM3 at 700 W by
# scripts/torch_ln_tiles.py --i8: the plan's cost model
I8_TILE_TOPS = {(128, False): 528, (256, False): 570, (128, True): 619,
                (256, True): 638}
I8_MAX_C = 2048              # the pre-pass holds a row in registers


class LnLinearI8Plan(NamedTuple):
    bn: int                 # W rows a ring stage: the instance
    geglu: bool
    vw: int                 # output columns a tile
    m_tiles: int            # 128-row blocks
    n_tiles: int            # vw-column tiles a row block
    tiles: int              # m_tiles * n_tiles, column tiles fastest
    grid: int               # persistent blocks, each a contiguous range
    kc: int                 # 128-deep K chunks
    a_map: TensorMap        # codes (M, C) int8: box (128, 128)
    w_map: TensorMap        # W storage (G * N, C) int8: box (128, BN / G)
    c_plan: ctypes.Array    # all of the above as the C entry point reads it


def _i8_tile_plan(m, c, n, geglu, bn, sms) -> LnLinearI8Plan:
    g = 2 if geglu else 1
    vw = bn // g
    m_tiles, n_tiles = _cdiv(m, I8_BM), _cdiv(n, vw)
    tiles = m_tiles * n_tiles
    grid = min(tiles, sms)
    a_map = TensorMap((c, m), (c,), (I8_BK, I8_BM), 128, 1)
    w_map = TensorMap((c, g * n), (c,), (I8_BK, bn // g), 128, 1)
    kc = _cdiv(c, I8_BK)
    fields = (bn, int(geglu), m_tiles, n_tiles, tiles, grid, n, kc)
    return LnLinearI8Plan(bn, geglu, vw, m_tiles, n_tiles, tiles, grid, kc,
                          a_map, w_map, _c_plan(fields, (a_map, w_map)))


def _i8_cost(plan: LnLinearI8Plan) -> float:
    """Time of the busiest block: its tiles, each 128 x bn x C at its
    tile's measured rate."""
    return (_cdiv(plan.tiles, plan.grid) * plan.bn
            / I8_TILE_TOPS[plan.bn, plan.geglu])


@functools.lru_cache(maxsize=1024)
def ln_linear_i8_plan(m: int, c: int, n: int, geglu: bool = False,
                      tile=None, sms: int = SMS) -> LnLinearI8Plan:
    """Launch geometry of the W8A8 kernel for x (m, c) and W (c, n) or, for
    ``geglu``, (c, 2n) [value | gate], stored (G n, c): n is the output
    width. The BN is ``tile`` or, of ``I8_TILES``, the one of least
    ``_i8_cost`` on ``sms`` SMs (then fewer tiles). Raises on what the
    kernel cannot take: C not a multiple of 64 or above ``I8_MAX_C`` (the
    pre-pass's row in registers), N not a multiple of 8 (16-byte output
    stores), or a coordinate past TMA's or int32's range."""
    if (m < 1 or c < 64 or c % 64 or c > I8_MAX_C or n < 8 or n % 8):
        raise ValueError(f"ln_linear_i8 kernel needs M >= 1, C % 64 == 0 "
                         f"up to {I8_MAX_C} and N % 8 == 0, got M={m}, "
                         f"C={c}, N={n}")
    if tile is not None:
        if tile not in I8_TILES:
            raise ValueError(f"ln_linear_i8 kernel: no BN {tile} in "
                             f"{I8_TILES}")
        plan = _i8_tile_plan(m, c, n, geglu, tile, sms)
    else:
        plan = min((_i8_tile_plan(m, c, n, geglu, bn, sms)
                    for bn in I8_TILES),
                   key=lambda p: (_i8_cost(p), p.tiles))
    if (max(plan.tiles, m, plan.w_map.dims[1]) > INT32_MAX
            or max(plan.a_map.dims + plan.w_map.dims) >= _TMA_DIM
            or max(plan.a_map.strides + plan.w_map.strides) >= _TMA_STRIDE):
        raise ValueError(f"ln_linear_i8 kernel: x ({m}, {c}) -> {n} "
                         f"overflows its int32 tile or TMA coordinates")
    return plan


def ln_quant_i8_torch(x, gamma, beta, eps: float = 1e-5):
    """The activation quantization of ``ln_linear_i8_torch``: fp32
    LayerNorm, per-row scale ``rs = max(row absmax, 1e-8) / 127`` and codes
    ``clip(round(xn * (1 / rs)), -127, 127)`` (fp32 values). Returns
    (codes, rs) of shapes (..., C) and (..., 1)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = xf.square().mean(-1, keepdim=True)
    var = (mean2 - mean.square()).clamp_min(0.0)
    xn = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    rs = xn.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xn * (1.0 / rs)).clamp_(-127.0, 127.0), rs


def ln_linear_i8_torch(x, gamma, beta, w_i8, w_scale, b=None, *,
                       eps: float = 1e-5, geglu: bool = False):
    """Plain version of the W8A8 kernel (the Pallas kernel's math):
    ``ln_quant_i8_torch``'s codes and row scales; an exact integer product
    with the int8 weight (float64: the sums stay below 2^53); then
    ``acc * rs * w_scale + b`` in fp32, and value * gelu(gate) for
    ``geglu``."""
    q, rs = ln_quant_i8_torch(x, gamma, beta, eps)
    acc = torch.matmul(q.double(), w_i8.double()).float()
    y = acc * rs * w_scale.float()
    if b is not None:
        y = y + b.float()
    if geglu:
        val, gate = y.chunk(2, dim=-1)
        y = val * F.gelu(gate)
    return y.to(x.dtype)


def _check_i8_layout(w_i8):
    """The kernel reads W K-major: a (C, N) int8 ``kernel_i8`` must be the
    view of (N, C) storage (the layout ``ops.quant.quantize_kernel_int8``
    returns and ``QuantLinear`` keeps); any other layout is refused rather
    than copied."""
    if w_i8.dtype == torch.int8 and not w_i8.t().is_contiguous():
        raise ValueError(f"ln_linear_i8: w_i8 {tuple(w_i8.shape)} with "
                         f"strides {w_i8.stride()} is not the (C, N) view of "
                         f"(N, C) storage (quantize_kernel_int8's layout)")


def ln_linear_i8(x, gamma, beta, w_i8, w_scale, b=None, *,
                 eps: float = 1e-5, geglu: bool = False, tile=None):
    """Kernel version of ``ln_linear_i8_torch``: x (..., C) bf16;
    gamma/beta (C,) fp32; w_i8 (C, N) or (C, 2N) int8, the transposed view
    of (N, C) storage; w_scale (N,) or (2N,) fp32; b the same shape, bf16 or
    fp32 (the kernel widens it), or None. Returns (..., N) bf16. ``tile``
    forces the plan's BN, as scripts/torch_ln_tiles.py --i8 does."""
    _build.no_autograd("ln_linear_i8", x, gamma, beta, w_i8, w_scale, b)
    c = x.shape[-1]
    m = x.numel() // c
    n_out = w_i8.shape[1] // (2 if geglu else 1)
    if (w_i8.dim() != 2 or w_i8.shape[0] != c
            or w_i8.shape[1] != (2 if geglu else 1) * n_out
            or tuple(w_scale.shape) != (w_i8.shape[1],)
            or (b is not None and tuple(b.shape) != (w_i8.shape[1],))):
        raise ValueError(f"ln_linear_i8: x {tuple(x.shape)}, w_i8 "
                         f"{tuple(w_i8.shape)}, w_scale "
                         f"{tuple(w_scale.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    dev = x.device
    x_ptr = _build.ptr(x, "x", torch.bfloat16)
    _check_i8_layout(w_i8)
    bias_bf16 = b is not None and b.dtype == torch.bfloat16
    ptrs = (_build.ptr(gamma, "gamma", torch.float32, dev),
            _build.ptr(beta, "beta", torch.float32, dev),
            _build.ptr(w_i8.t(), "w_i8", torch.int8, dev),
            _build.ptr(w_scale, "w_scale", torch.float32, dev),
            _build.ptr(b, "b", torch.bfloat16 if bias_bf16 else torch.float32,
                       dev))
    out = torch.empty(*x.shape[:-1], n_out, dtype=x.dtype, device=dev)
    if m == 0:
        return out
    plan = ln_linear_i8_plan(m, c, n_out, bool(geglu), tile,
                             sms=_sm_count(dev.index))
    # the kernel's pre-pass writes the codes and row scales here
    codes = torch.empty(m, c, dtype=torch.int8, device=dev)
    rs = torch.empty(m, dtype=torch.float32, device=dev)
    _build.call("idm_ln_linear_i8", x_ptr, *ptrs, int(bias_bf16),
                _build.ptr(codes, "codes", torch.int8),
                _build.ptr(rs, "rs", torch.float32),
                _build.ptr(out, "out", torch.bfloat16), m, c, n_out,
                float(eps), plan.c_plan, _build.stream_ptr(dev))
    ln_linear_i8.launches += 1
    return out


ln_linear_i8.launches = 0


def ln_quant_i8(x, gamma, beta, eps: float = 1e-5):
    """The W8A8 kernel's quantization pre-pass alone (a debug entry, not
    counted as a launch): x (..., C) bf16 -> (codes (M, C) int8, rs (M,)
    fp32), which the tests hold against ``ln_quant_i8_torch``."""
    c = x.shape[-1]
    m = x.numel() // c
    if c % 8 or c > I8_MAX_C:
        raise ValueError(f"ln_quant_i8 kernel needs C % 8 == 0 up to "
                         f"{I8_MAX_C}, got C={c}")
    dev = x.device
    x_ptr = _build.ptr(x, "x", torch.bfloat16)
    codes = torch.empty(m, c, dtype=torch.int8, device=dev)
    rs = torch.empty(m, dtype=torch.float32, device=dev)
    _build.call("idm_ln_quant_i8", x_ptr,
                _build.ptr(gamma, "gamma", torch.float32, dev),
                _build.ptr(beta, "beta", torch.float32, dev),
                _build.ptr(codes, "codes", torch.int8),
                _build.ptr(rs, "rs", torch.float32), m, c, float(eps),
                _build.stream_ptr(dev))
    return codes, rs


# ---------------------------------------------------------------------------
# GroupNorm spatial statistics (replaces pallas_norm.py::gn_spatial_stats)
# ---------------------------------------------------------------------------

GN_ROWS_PER_BLOCK = 256


def gn_spatial_stats_torch(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, ..., C) -> fp32 (sum, sum of squares) per (B, C) over space."""
    xf = x.float().reshape(x.shape[0], -1, x.shape[-1])
    return xf.sum(1), xf.square().sum(1)


def gn_spatial_stats(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel version of ``gn_spatial_stats_torch`` for bf16 or fp32 x.

    Pass 1 writes fp32 partial sums per block of ``GN_ROWS_PER_BLOCK``
    spatial rows; pass 2 adds the partials in a fixed order, so the result
    is deterministic (no atomics)."""
    _build.no_autograd("gn_spatial_stats", x)
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    if c % 2 or -(-s // GN_ROWS_PER_BLOCK) > 65535 or b > 65535:
        raise ValueError(f"gn_spatial_stats kernel: unsupported shape "
                         f"{tuple(x.shape)} (needs an even C)")
    r = -(-s // GN_ROWS_PER_BLOCK)
    kind = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    partial = torch.empty(b, r, 2, c, dtype=torch.float32, device=x.device)
    s1 = torch.empty(b, c, dtype=torch.float32, device=x.device)
    s2 = torch.empty(b, c, dtype=torch.float32, device=x.device)
    _build.call("idm_gn_stats",
                _build.ptr(x, "x", kind),
                _build.ptr(partial, "partial", torch.float32),
                _build.ptr(s1, "s1", torch.float32),
                _build.ptr(s2, "s2", torch.float32),
                b, s, c, GN_ROWS_PER_BLOCK, int(kind == torch.bfloat16),
                _build.stream_ptr(x.device))
    gn_spatial_stats.launches += 1
    return s1, s2


gn_spatial_stats.launches = 0


def gn_stats_supported(x) -> bool:
    """JAX ``gn_stats_supported`` (rank >= 3, C >= 8), plus the kernel's
    channel-pair loads (even C)."""
    return x.dim() >= 3 and x.shape[-1] >= 8 and x.shape[-1] % 2 == 0


# ---------------------------------------------------------------------------
# GroupNorm apply (#13; no Pallas kernel: the JAX package leaves this tail to
# XLA's fusion)
# ---------------------------------------------------------------------------

def gn_apply_torch(x, mean_c, mean2_c, scale, bias, *, num_groups: int,
                   eps: float = 1e-5, silu: bool = False):
    """GroupNorm of x (B, ..., C) from its per-channel fp32 means of x and
    x^2 (B, C): the group statistics, the fp32 affine ``scale`` / ``bias``
    (C,) and an optional SiLU, in fp32 with one rounding to x's type."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    gmean = mean_c.reshape(b, g, c // g).mean(-1)
    gmean2 = mean2_c.reshape(b, g, c // g).mean(-1)
    inv = torch.rsqrt((gmean2 - gmean.square()).clamp_min(0.0) + eps)
    inv_c = inv.repeat_interleave(c // g, dim=-1)
    mean_bc = gmean.repeat_interleave(c // g, dim=-1)
    w = inv_c * scale[None]
    shift = bias[None] - mean_bc * w
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    xf = x.float() * w.reshape(shape)
    xf.add_(shift.reshape(shape))
    if silu:
        F.silu(xf, inplace=True)
    return xf.to(x.dtype)


def gn_apply(x, mean_c, mean2_c, scale, bias, *, num_groups: int,
             eps: float = 1e-5, silu: bool = False):
    """Kernel version of ``gn_apply_torch`` for bf16 or fp32 x (B, ..., C)
    with C even and a multiple of ``num_groups``: one read of x and one
    write of the output in x's type."""
    _build.no_autograd("gn_apply", x, mean_c, mean2_c, scale, bias)
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // max(b * c, 1)
    if (c % 2 or c % num_groups or b > 65535 or s > INT32_MAX
            or tuple(mean_c.shape) != (b, c)
            or tuple(mean2_c.shape) != (b, c)
            or tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,)):
        raise ValueError(f"gn_apply kernel: unsupported shapes x "
                         f"{tuple(x.shape)}, means {tuple(mean_c.shape)} / "
                         f"{tuple(mean2_c.shape)}, affine "
                         f"{tuple(scale.shape)} / {tuple(bias.shape)} with "
                         f"{num_groups} groups (needs an even C that the "
                         f"groups divide, means (B, C), affine (C,))")
    kind = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    dev = x.device
    xp = _build.ptr(x, "x", kind)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    _build.call("idm_gn_apply", xp,
                _build.ptr(mean_c, "mean_c", torch.float32, dev),
                _build.ptr(mean2_c, "mean2_c", torch.float32, dev),
                _build.ptr(scale, "scale", torch.float32, dev),
                _build.ptr(bias, "bias", torch.float32, dev),
                _build.ptr(out, "out", kind),
                b, s, c, num_groups, float(eps), int(silu),
                int(kind == torch.bfloat16), _sm_count(dev.index),
                _build.stream_ptr(dev))
    gn_apply.launches += 1
    return out


gn_apply.launches = 0
