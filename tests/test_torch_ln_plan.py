"""The launch plan of the wgmma ``ln_linear`` kernel (``cuda_norm.
ln_linear_plan``) and the kernel's index arithmetic, on the CPU.

The kernels (``idmvton_tpu_torch/ops/csrc/ln_linear.cu``) run only on the
card, so what surrounds them is held here: the plan the wrapper passes to
the C entry point, over every ``ln_linear`` shape of the serving path and
its refusals, and a numpy model of the kernel -- the statistics pre-pass,
each block's contiguous tile range, the TMA boxes of x and of both GEGLU
halves of W (zero-filled past the tensor), the 128-byte swizzle of the x
box and the consumer threads' reads of their wgmma A fragments out of it,
the normalization of the fragments, the epilogue's bias, GEGLU and
quad-transposed 16-byte stores -- and of the standalone LayerNorm's
half-warp row mapping.

The models are held against the JAX package's ``ln_linear`` and
``fused_layer_norm`` (Pallas interpret mode, as tests/test_ops.py runs
them) and against the port's plain versions. Tolerances: in fp32 (the
model without its bf16 rounding of the normalized x, as JAX's kernel keeps
an fp32 x's scratch in fp32) both sides differ in summation order only: 2e-5
absolute and relative at O(1) values (JAX's GEGLU takes a rational erf with
1.5e-7 error). In bf16 both round the normalized x and the output to bf16
and differ in fp32 summation order, which can move an output by one bf16
ulp: max |diff| <= 1e-2 * max |want|.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import pallas_norm
from idmvton_tpu_torch.ops import cuda_norm
from idmvton_tpu_torch.ops.cuda_conv import INT32_MAX
from idmvton_tpu_torch.ops.cuda_norm import (
    LN_BK, LN_BM, LN_TILES, ln_linear_plan,
)

F32_TOL = 2e-5
BF16_TOL = 1e-2

# (M, C, N, geglu) of every ln_linear call of the path at 768x1024:
# TryonNet (B = 4) and GarmentNet (B = 2) to_qkv / to_q / ff.proj_in at the
# 640 (3072 tokens) and 1280 (768 tokens) levels -- GarmentNet's to_qkv runs
# fused_layer_norm + a GEMM -- the tiny UNet's 128-wide level (768 tokens)
# and the variant path's non-int8 sites (to_q of both UNets: among these)
PATH = [(4 * 3072, 640, 1920, False), (4 * 3072, 640, 640, False),
        (4 * 3072, 640, 2560, True), (4 * 768, 1280, 3840, False),
        (4 * 768, 1280, 1280, False), (4 * 768, 1280, 5120, True),
        (2 * 3072, 640, 640, False), (2 * 3072, 640, 2560, True),
        (2 * 768, 1280, 1280, False), (2 * 768, 1280, 5120, True),
        (4 * 768, 128, 384, False), (4 * 768, 128, 128, False),
        (4 * 768, 128, 512, True), (2 * 768, 128, 128, False),
        (2 * 768, 128, 512, True)]


def _cdiv(a, b):
    return -(-a // b)


def block_ranges(plan):
    """Each persistent block's contiguous tile range [t0, t1): the kernel's
    ``tile_range``."""
    return [(b * plan.tiles // plan.grid, (b + 1) * plan.tiles // plan.grid)
            for b in range(plan.grid)]


def check_plan(plan, m, c, n, geglu, sms=132):
    assert plan.bn in LN_TILES and plan.geglu == geglu
    assert plan.vw == (plan.bn // 2 if geglu else plan.bn)
    assert plan.m_tiles == _cdiv(m, LN_BM) and plan.kc * LN_BK == c
    assert plan.n_tiles == _cdiv(n, plan.vw)
    assert plan.tiles == plan.m_tiles * plan.n_tiles <= INT32_MAX
    assert plan.grid == min(plan.tiles, sms)
    # the blocks' ranges cover every tile once, within one tile of balance
    ranges = block_ranges(plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [t1 - t0 for t0, t1 in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # every output (row block, column) stored once: column tiles of vw
    cols = np.arange(plan.n_tiles)[:, None] * plan.vw + np.arange(plan.vw)
    assert np.bincount(cols[cols < n], minlength=n).tolist() == [1] * n
    # the maps: 2-D, 128-byte rows under the 128-byte swizzle
    g = 2 if geglu else 1
    assert plan.x_map.dims == (c, m) and plan.x_map.strides == (2 * c,)
    assert plan.x_map.box == (LN_BK, LN_BM)
    assert plan.w_map.dims == (g * n, c) and plan.w_map.strides == (2 * g * n,)
    assert plan.w_map.box == (64, LN_BK)
    for tmap in (plan.x_map, plan.w_map):
        assert tmap.swizzle == 128 and tmap.box[0] * 2 == tmap.swizzle
        assert all(1 <= d <= 256 for d in tmap.box)
        assert all(s % 16 == 0 for s in tmap.strides)
    # the int64 array the C entry point reads, field for field
    vals = list(plan.c_plan)
    assert len(vals) == 22
    assert vals[:8] == [plan.bn, int(geglu), plan.m_tiles, plan.n_tiles,
                        plan.tiles, plan.grid, n, plan.kc]
    assert vals[8:15] == [*plan.x_map.dims, *plan.x_map.strides,
                          *plan.x_map.box, 128, 2]
    assert vals[15:] == [*plan.w_map.dims, *plan.w_map.strides,
                         *plan.w_map.box, 128, 2]


@pytest.mark.parametrize("shape", PATH)
def test_plan_covers_path_shapes(shape):
    m, c, n, geglu = shape
    plan = ln_linear_plan(m, c, n, geglu)
    check_plan(plan, *shape)
    # every path shape fills the card: a wave of blocks, or all its tiles
    assert plan.grid == min(plan.tiles, 132)
    for tile in LN_TILES:
        check_plan(ln_linear_plan(m, c, n, geglu, tile=tile), *shape)


def test_plan_is_cached_and_refuses_what_the_kernel_cannot_take():
    assert ln_linear_plan(12288, 640, 1920) is ln_linear_plan(12288, 640, 1920)
    # the full-width to_qkv: 256-wide tiles (the ragged 8th holds 128)
    assert ln_linear_plan(12288, 640, 1920).bn == 256
    for m, c, n in ((0, 640, 640), (10, 96, 128), (10, 640, 100),
                    (10, 32, 128)):
        with pytest.raises(ValueError, match="C % 64"):
            ln_linear_plan(m, c, n)
    with pytest.raises(ValueError, match="BN"):
        ln_linear_plan(10, 128, 128, tile=64)
    with pytest.raises(ValueError, match="int32"):
        ln_linear_plan(2**31, 128, 128)


def test_predicate_stays_jax_and_within_the_plan():
    """ln_linear_supported is JAX's (C, N multiples of 128); every shape it
    takes the plan takes."""
    for c, n, geglu in ((128, 128, False), (640, 2560, True),
                        (1280, 3840, False), (192, 128, False),
                        (128, 200, False), (128, 256, True)):
        x = torch.zeros(3, c)
        w = torch.zeros(c, n * (2 if geglu else 1))
        want = pallas_norm.ln_linear_supported(jnp.zeros((3, c)),
                                               jnp.zeros(w.shape),
                                               geglu=geglu)
        assert cuda_norm.ln_linear_supported(x, w, geglu=geglu) == want
        if want:
            ln_linear_plan(3, c, n, geglu)


def test_wrapper_checks_before_building():
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    g = torch.ones(128)
    with pytest.raises(ValueError, match="ln_linear: x"):
        cuda_norm.ln_linear(x, g, g, torch.zeros(64, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="ln_linear: x"):
        cuda_norm.ln_linear(x, g, g, torch.zeros(128, 128, dtype=torch.bfloat16),
                            torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_norm.ln_linear(x, g, g, torch.zeros(128, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="C <= 2048"):
        cuda_norm.fused_layer_norm(torch.zeros(2, 2176, dtype=torch.bfloat16),
                                   torch.ones(2176), torch.ones(2176))


# ---------------------------------------------------------------------------
# the kernel in numpy
# ---------------------------------------------------------------------------


def bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _box(src, starts, sizes):
    """A TMA tiled box: src[start:start + size] on every axis, zeros where
    the box leaves the tensor."""
    out = np.zeros(sizes, src.dtype)
    dst_sl, src_sl = [], []
    for s0, n, d in zip(starts, sizes, src.shape):
        lo, hi = max(s0, 0), min(s0 + n, d)
        if hi <= lo:
            return out
        src_sl.append(slice(lo, hi))
        dst_sl.append(slice(lo - s0, hi - s0))
    out[tuple(dst_sl)] = src[tuple(src_sl)]
    return out


def swizzle128(box):
    """A (128 rows, 64 bf16) box as TMA's 128-byte swizzle writes it:
    shared memory (row, 16-byte unit, 8 values), row r's unit j at j ^ (r %
    8)."""
    smem = np.zeros((box.shape[0], 8, 8), box.dtype)
    for r in range(box.shape[0]):
        for j in range(8):
            smem[r, j ^ (r % 8)] = box[r, 8 * j:8 * j + 8]
    return smem


def a_fragments(smem):
    """Every consumer thread's reads of its wgmma A fragments out of the
    swizzled box (``fragments`` in ln_linear.cu): warpgroup w, warp, lane
    (g = lane / 4, q = lane % 4) reads, per 16-deep step kk, the bf16 pairs
    at byte 4q of unit (2kk) ^ g and (2kk + 1) ^ g of rows rw + g and rw +
    g + 8 (rw = 64 w + 16 warp), which are the fragment's (row, column)
    (g, 2q), (g + 8, 2q), (g, 2q + 8), (g + 8, 2q + 8). Returns the (128,
    64) matrix the fragments hold."""
    a = np.full((128, 64), np.nan, np.float32)
    for w in range(2):
        for warp in range(4):
            rw = 64 * w + 16 * warp
            for lane in range(32):
                g, q = lane // 4, lane % 4
                for kk in range(4):
                    for dr, dc, unit in ((0, 0, 2 * kk), (8, 0, 2 * kk),
                                         (0, 8, 2 * kk + 1),
                                         (8, 8, 2 * kk + 1)):
                        r = rw + g + dr
                        assert r % 8 == g % 8
                        pair = smem[r, unit ^ g, 2 * q:2 * q + 2]
                        c = 16 * kk + 2 * q + dc
                        a[r, c:c + 2] = pair
    return a


def epilogue_columns(vw):
    """The output column each lane q of a quad stores as element i of its
    16-byte vector, per 32-column group: after the quad transpose (r[s] =
    lane q ^ s's pair q; o = r[q], r[q ^ 1], r[q ^ 2], r[q ^ 3]) -- the
    accumulator pair (8u + 2q', +1) of lane q' moves to lane u, element
    q'."""
    cols = np.zeros((vw // 32, 4, 8), np.int64)
    for jj in range(vw // 32):
        # v[lane][u]: the pair of columns this lane holds in block u
        v = [[32 * jj + 8 * u + 2 * ln for u in range(4)] for ln in range(4)]
        for q in range(4):
            r = [v[q ^ s][q] for s in range(4)]        # shfl_xor(sel4(v, q^s))
            o = [r[q], r[q ^ 1], r[q ^ 2], r[q ^ 3]]
            cols[jj, q] = [c + e for c0 in o for c, e in ((c0, 0), (c0, 1))]
    return cols


def test_epilogue_stores_eight_consecutive_columns():
    for vw in (64, 128, 256):
        cols = epilogue_columns(vw)
        for jj in range(vw // 32):
            for q in range(4):
                assert cols[jj, q].tolist() == list(
                    range(32 * jj + 8 * q, 32 * jj + 8 * q + 8))


def _gelu_erf(v):
    return 0.5 * v * (1.0 + np.vectorize(math.erf)(v / math.sqrt(2.0)))


def stats_np(x, eps=1e-5):
    """The statistics pre-pass: (inv, -mean * inv) of each row, one-pass
    fp32 sums with the clamped variance, over the 16 lanes of half a warp
    (lane hl: columns 8 hl + 128 i .. + 7)."""
    m, c = x.shape
    lanes = [[cc for c0 in range(8 * hl, c, 128) for cc in range(c0, c0 + 8)]
             for hl in range(16)]
    assert sorted(sum(lanes, [])) == list(range(c))
    s1 = sum(x[:, ln].sum(-1, dtype=np.float32) for ln in lanes if ln)
    s2 = sum((x[:, ln] ** 2).sum(-1, dtype=np.float32) for ln in lanes if ln)
    mean = (s1 / c).astype(np.float32)
    inv = (1.0 / np.sqrt(np.maximum(s2 / c - mean * mean, 0.0) + eps)
           ).astype(np.float32)
    return np.stack([inv, -mean * inv], -1).astype(np.float32)


def kernel_np(x, gamma, beta, w, b, plan, *, round_xn=True, eps=1e-5):
    """ln_linear.cu in numpy: the statistics pre-pass; per block its
    contiguous tile range, its threads' rows' statistics read at each new
    row block; per 64-deep chunk the x box (through the swizzle and the
    fragment reads) normalized -- x inv - mean inv, then gamma, beta -- (and
    rounded to bf16 with ``round_xn``) times the W boxes (GEGLU: value boxes
    at n0, gate boxes at N + n0); bias, GEGLU and the bf16 rounding in the
    epilogue, rows and columns past the output dropped."""
    m, c = x.shape
    n, vw = plan.c_plan[6], plan.vw
    geglu = plan.geglu
    stats = stats_np(x, eps)
    out = np.full((m, n), np.nan, np.float32)
    for t0, t1 in block_ranges(plan):
        cur_mb = -1
        for t in range(t0, t1):
            mb, nt = divmod(t, plan.n_tiles)
            m0, n0 = mb * LN_BM, nt * vw
            if mb != cur_mb:
                cur_mb = mb
                st = _box(stats, (m0, 0), (LN_BM, 2))   # rows past M: zeros
                inv, nmi = st[:, :1], st[:, 1:]
            acc = np.zeros((LN_BM, vw), np.float32)
            accg = np.zeros((LN_BM, vw), np.float32)
            for k in range(plan.kc):
                xbox = _box(x, (m0, k * LN_BK), (LN_BM, LN_BK))
                a = a_fragments(swizzle128(xbox))
                np.testing.assert_array_equal(a, xbox)
                cs = slice(k * LN_BK, (k + 1) * LN_BK)
                xn = ((a * inv + nmi) * gamma[cs] + beta[cs]).astype(
                    np.float32)
                if round_xn:
                    xn = bf16(xn)
                boxes = [_box(w, (k * LN_BK, col), (LN_BK, 64))
                         for col in ([n0 + 64 * i for i in range(vw // 64)]
                                     + ([n + n0 + 64 * i
                                         for i in range(vw // 64)]
                                        if geglu else []))]
                acc += xn @ np.concatenate(boxes[:vw // 64], 1)
                if geglu:
                    accg += xn @ np.concatenate(boxes[vw // 64:], 1)
            colv = n0 + np.arange(vw)
            live = colv < n
            bias = np.zeros((2, vw), np.float32)
            if b is not None:
                bias[0, live] = b[colv[live]]
                if geglu:
                    bias[1, live] = b[n + colv[live]]
            y = acc + bias[0]
            if geglu:
                y = y * _gelu_erf(accg + bias[1])
            y = bf16(y) if round_xn else y
            # the stores: 8 consecutive columns a lane, rows < M, cols < N
            cols = n0 + epilogue_columns(vw).reshape(-1)
            for r in range(LN_BM):
                if m0 + r < m:
                    keep = cols < n
                    out[m0 + r, cols[keep]] = y[r, cols[keep] - n0]
    assert not np.isnan(out).any()      # every output written
    return out


def _inputs(seed, m, c, n, geglu, bias=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, c)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w = (rng.standard_normal((c, n * (2 if geglu else 1)))
         / math.sqrt(c)).astype(np.float32)
    b = ((0.2 * rng.standard_normal(w.shape[1])).astype(np.float32)
         if bias else None)
    return x, gamma, beta, w, b


# (M, C, N, geglu, BN): a ragged row block, ragged column tiles, C of 1 and
# 3 chunks, both instances and both epilogues (the JAX kernel needs C and N
# multiples of 128)
NP_CASES = [(200, 128, 256, False, 256), (130, 128, 128, True, 128),
            (70, 256, 384, False, 128), (129, 128, 256, True, 256),
            (60, 192, 136, True, 256)]


@pytest.mark.parametrize("m,c,n,geglu,bn", NP_CASES)
def test_kernel_model_matches_jax_ln_linear_fp32(m, c, n, geglu, bn):
    x, gamma, beta, w, b = _inputs(1, m, c, n, geglu)
    plan = ln_linear_plan(m, c, n, geglu, tile=bn, sms=3)
    got = kernel_np(x, gamma, beta, w, b, plan, round_xn=False)
    want = cuda_norm.ln_linear_torch(*map(torch.from_numpy, (x, gamma, beta,
                                                            w, b)),
                                     geglu=geglu).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    if c % 128 == 0 and n % 128 == 0:
        jx = pallas_norm.ln_linear(jnp.asarray(x),
                                   {"scale": jnp.asarray(gamma),
                                    "bias": jnp.asarray(beta)},
                                   {"kernel": jnp.asarray(w),
                                    "bias": jnp.asarray(b)}, geglu=geglu)
        np.testing.assert_allclose(got, np.asarray(jx), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("m,c,n,geglu,bn", NP_CASES[:4])
def test_kernel_model_matches_jax_ln_linear_bf16(m, c, n, geglu, bn):
    """bf16 x and W: the model rounds the normalized x to bf16 as JAX's
    kernel's xn scratch (x's type) does, and the output once."""
    x, gamma, beta, w, b = _inputs(2, m, c, n, geglu)
    x, w = bf16(x), bf16(w)
    plan = ln_linear_plan(m, c, n, geglu, tile=bn, sms=3)
    got = kernel_np(x, gamma, beta, w, b, plan)
    jx = pallas_norm.ln_linear(jnp.asarray(x, jnp.bfloat16),
                               {"scale": jnp.asarray(gamma),
                                "bias": jnp.asarray(beta)},
                               {"kernel": jnp.asarray(w, jnp.bfloat16),
                                "bias": jnp.asarray(b)}, geglu=geglu)
    want = np.asarray(jx.astype(jnp.float32))
    tx = torch.from_numpy(x).bfloat16()
    plain = cuda_norm.ln_linear_torch(
        tx, torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(w).bfloat16(), torch.from_numpy(b),
        geglu=geglu).float().numpy()
    for ref in (want, plain):
        assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()


def layer_norm_np(x, gamma, beta, eps=1e-5):
    """The standalone LayerNorm kernel in numpy: half a warp a row (16
    lanes), lane hl holding the 8 columns 8 hl + 128 i of chunk i, the
    row's sums reduced over the 16 lanes."""
    m, c = x.shape
    nch = c // 128
    out = np.full_like(x, np.nan)
    for row in range(m):
        cols = [[8 * hl + 128 * i + j for i in range(nch) for j in range(8)]
                for hl in range(16)]
        flat = sorted(cc for lane in cols for cc in lane)
        assert flat == list(range(c))                  # each column once
        s1 = sum(float(x[row, lane].sum()) for lane in cols)
        s2 = sum(float((x[row, lane] ** 2).sum()) for lane in cols)
        mean = s1 / c
        inv = 1.0 / math.sqrt(max(s2 / c - mean * mean, 0.0) + eps)
        for lane in cols:
            out[row, lane] = (x[row, lane] - mean) * inv * gamma[lane] \
                + beta[lane]
    return out


@pytest.mark.parametrize("c", [128, 640, 1280])
def test_layer_norm_model_matches_jax_fused_layer_norm(c):
    x, gamma, beta, _, _ = _inputs(3, 37, c, 8, False)
    got = layer_norm_np(x, gamma, beta)
    want = pallas_norm.fused_layer_norm(jnp.asarray(x), jnp.asarray(gamma),
                                        jnp.asarray(beta))
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    plain = cuda_norm.layer_norm_torch(*map(torch.from_numpy,
                                            (x, gamma, beta)))
    np.testing.assert_allclose(got, plain.numpy(), atol=F32_TOL, rtol=F32_TOL)
