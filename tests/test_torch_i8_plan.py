"""The launch plan of the wgmma W8A8 ``ln_linear_i8`` kernel (``cuda_norm.
ln_linear_i8_plan``) and the kernel's arithmetic, on the CPU.

The kernel (``idmvton_tpu_torch/ops/csrc/ln_linear_i8.cu``) runs only on
the card, so what surrounds it is held here: the plan the wrapper passes to
the C entry point, over every ``ln_linear_i8`` shape of the variant path
and its refusals, and a numpy model of the kernel -- the quantization
pre-pass (half a warp a row: its lanes' partial sums and butterfly
reduction, the means as sum * fl(1/C), rs as absmax * fl(1/127)), each
block's contiguous tile range, the K-major TMA boxes of the codes and of W's
(N, C) storage read back through the 128-byte swizzle by 32-byte wgmma k
steps, GEGLU's value and gate boxes side by side in one stage, and the
epilogue's dequantization, bias, GEGLU and clipped stores.

The model is held against the JAX package's Pallas ``ln_linear`` on an
int8-quantized projection (interpret mode, as tests/test_ops.py runs it)
and against the port's plain version. Tolerances: the codes of the model
and of the plain version on the CPU differ where an fp32 rounding of the
statistics or of rs (the CPU divides by 127 where the card multiplies by
its reciprocal) moves xn * (1 / rs) across a rounding boundary: by one
code, in at most 1e-3 of them; the outputs, which sum the same int8
products exactly, by 1e-2 of max |want| (a flipped code is one step of a
row's 1/127 scale; JAX's erf approximation is 1.5e-7).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import pallas_norm
from idmvton_tpu.ops import quant as jquant
from idmvton_tpu_torch.ops import cuda_norm
from idmvton_tpu_torch.ops.cuda_conv import INT32_MAX
from idmvton_tpu_torch.ops.cuda_norm import (
    I8_BK, I8_BM, I8_MAX_C, I8_TILES, ln_linear_i8_plan,
)
from idmvton_tpu_torch.ops.quant import quantize_kernel_int8

TOL = 1e-2
CSRC = Path(cuda_norm.__file__).parent / "csrc" / "ln_linear_i8.cu"

# (M, C, N, geglu) of every ln_linear_i8 call of the variant path at
# 768x1024: TryonNet (B = 4) to_qkv and ff.proj_in at the 640 (3072 tokens)
# and 1280 (768 tokens) levels, GarmentNet's (B = 2) ff.proj_in
PATH = [(4 * 3072, 640, 1920, False), (4 * 768, 1280, 3840, False),
        (4 * 3072, 640, 2560, True), (4 * 768, 1280, 5120, True),
        (2 * 3072, 640, 2560, True), (2 * 768, 1280, 5120, True)]


def _cdiv(a, b):
    return -(-a // b)


def block_ranges(plan):
    """Each persistent block's contiguous tile range [t0, t1): the kernel's
    ``idm::tile_range``."""
    return [(b * plan.tiles // plan.grid, (b + 1) * plan.tiles // plan.grid)
            for b in range(plan.grid)]


def check_plan(plan, m, c, n, geglu, sms=132):
    g = 2 if geglu else 1
    assert plan.bn in I8_TILES and plan.geglu == geglu
    assert plan.vw == plan.bn // g
    assert plan.m_tiles == _cdiv(m, I8_BM) and plan.kc == _cdiv(c, I8_BK)
    assert plan.n_tiles == _cdiv(n, plan.vw)
    assert plan.tiles == plan.m_tiles * plan.n_tiles <= INT32_MAX
    assert plan.grid == min(plan.tiles, sms)
    ranges = block_ranges(plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [t1 - t0 for t0, t1 in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the maps: int8 (1-byte elements, TMA's UINT8), K innermost, 128-byte
    # rows under the 128-byte swizzle
    assert plan.a_map.dims == (c, m) and plan.a_map.strides == (c,)
    assert plan.a_map.box == (I8_BK, I8_BM)
    assert plan.w_map.dims == (c, g * n) and plan.w_map.strides == (c,)
    assert plan.w_map.box == (I8_BK, plan.bn // g)
    for tmap in (plan.a_map, plan.w_map):
        assert tmap.elem == 1 and tmap.swizzle == 128
        assert tmap.box[0] * tmap.elem == tmap.swizzle
        assert all(1 <= d <= 256 for d in tmap.box)
        assert all(s % 16 == 0 for s in tmap.strides)
    # the int64 array the C entry point reads, field for field
    vals = list(plan.c_plan)
    assert len(vals) == 22
    assert vals[:8] == [plan.bn, int(geglu), plan.m_tiles, plan.n_tiles,
                        plan.tiles, plan.grid, n, plan.kc]
    assert vals[8:15] == [*plan.a_map.dims, *plan.a_map.strides,
                          *plan.a_map.box, 128, 1]
    assert vals[15:] == [*plan.w_map.dims, *plan.w_map.strides,
                         *plan.w_map.box, 128, 1]


@pytest.mark.parametrize("shape", PATH)
def test_plan_covers_path_shapes(shape):
    m, c, n, geglu = shape
    plan = ln_linear_i8_plan(m, c, n, geglu)
    check_plan(plan, *shape)
    assert plan.grid == 132          # every path shape fills the card
    for tile in I8_TILES:
        check_plan(ln_linear_i8_plan(m, c, n, geglu, tile=tile), *shape)


def test_plan_is_cached_and_refuses_what_the_kernel_cannot_take():
    assert ln_linear_i8_plan(12288, 640, 1920) is \
        ln_linear_i8_plan(12288, 640, 1920)
    for m, c, n in ((0, 640, 640), (10, 96, 128), (10, 640, 100),
                    (10, 32, 128), (10, I8_MAX_C + 64, 128)):
        with pytest.raises(ValueError, match="C % 64"):
            ln_linear_i8_plan(m, c, n)
    with pytest.raises(ValueError, match="BN"):
        ln_linear_i8_plan(10, 128, 128, tile=64)
    with pytest.raises(ValueError, match="int32"):
        ln_linear_i8_plan(2**31, 128, 128)


def test_c_source_reads_the_plan():
    """The C Plan is as long as the plan's c_plan and the kernel is built
    for the plan's tiles."""
    src = CSRC.read_text()
    n = int(re.search(r"sizeof\(Plan\) == (\d+) \* sizeof", src).group(1))
    assert len(ln_linear_i8_plan(300, 640, 640).c_plan) == n
    built = {(int(bn), g == "true") for bn, g in re.findall(
        r"launch<(\d+), (true|false)>\(amap", src)}
    assert built == {(bn, g) for bn in I8_TILES for g in (False, True)}
    assert "wmma::" not in src and "mma.sync" not in src


def test_predicate_within_the_plan():
    """Every shape the sites send the kernel (ln_linear_supported: C and N
    multiples of 128) up to C = 2048 the plan takes."""
    for c, n, geglu in ((128, 128, False), (640, 2560, True),
                        (1280, 3840, False), (2048, 256, True)):
        x = torch.zeros(3, c)
        w = torch.zeros(c, n * (2 if geglu else 1))
        assert cuda_norm.ln_linear_supported(x, w, geglu=geglu)
        ln_linear_i8_plan(3, c, n, geglu)


def test_wrapper_checks_before_building():
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    g = torch.ones(128)
    w_i8, scale = quantize_kernel_int8(torch.randn(128, 256))
    with pytest.raises(ValueError, match="ln_linear_i8: x"):
        cuda_norm.ln_linear_i8(x, g, g, w_i8[:64], scale)
    with pytest.raises(ValueError, match="ln_linear_i8: x"):
        cuda_norm.ln_linear_i8(x, g, g, w_i8, scale[:128])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_norm.ln_linear_i8(x, g, g, w_i8, scale)
    # (on a card the wrapper raises this before launching:
    # tests/test_torch_cuda.py)
    with pytest.raises(ValueError, match="storage"):
        cuda_norm._check_i8_layout(w_i8.contiguous())
    cuda_norm._check_i8_layout(w_i8)
    with pytest.raises(ValueError, match="C % 8"):
        cuda_norm.ln_quant_i8(torch.zeros(4, 100, dtype=torch.bfloat16),
                              torch.ones(100), torch.ones(100))


# ---------------------------------------------------------------------------
# the kernel in numpy
# ---------------------------------------------------------------------------

f32 = np.float32


def quant_np(x, gamma, beta, eps=1e-5):
    """The pre-pass: lane hl of a row's half warp sums its columns 8 hl +
    128 i + j in (i, j) order, the 16 partial sums meet in a butterfly (xor
    8, 4, 2, 1); then the plain version's ops on the card, each rounded to
    fp32: mean = s1 fl(1/C), the clamped variance, rsqrt(var + eps), xn =
    ((x - mean) inv) gamma + beta, rs = max(absmax, 1e-8) fl(1/127), codes
    = clip(rint(xn fl(1 / rs)), -127, 127). Returns (codes int8, rs)."""
    m, c = x.shape
    lanes = [[cc for i in range(_cdiv(c, 128)) for cc in
              range(8 * hl + 128 * i, 8 * hl + 128 * i + 8) if cc < c]
             for hl in range(16)]
    assert sorted(sum(lanes, [])) == list(range(c))
    s1 = np.zeros((16, m), f32)
    s2 = np.zeros((16, m), f32)
    for hl, cols in enumerate(lanes):
        for cc in cols:
            s1[hl] = s1[hl] + x[:, cc]
            s2[hl] = s2[hl] + x[:, cc] * x[:, cc]
    for o in (8, 4, 2, 1):
        s1 = s1 + s1[np.arange(16) ^ o]
        s2 = s2 + s2[np.arange(16) ^ o]
    assert (s1 == s1[0]).all()      # every lane holds the row's sums
    rc = f32(1) / f32(c)
    mean, mean2 = s1[0] * rc, s2[0] * rc
    var = np.maximum(mean2 - mean * mean, f32(0))
    inv = (f32(1) / np.sqrt(var + f32(eps))).astype(f32)
    xn = ((x - mean[:, None]) * inv[:, None]) * gamma + beta
    rs = np.maximum(np.abs(xn).max(-1), f32(1e-8)) * (f32(1) / f32(127))
    rcp = (f32(1) / rs).astype(f32)
    codes = np.clip(np.rint(xn * rcp[:, None]), -127, 127).astype(np.int8)
    return codes, rs.astype(f32)


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
    """A (rows, 128 bytes) int8 box as TMA's 128-byte swizzle writes it:
    shared memory (row, 16-byte unit, 16 bytes), row r's unit j at j ^ (r %
    8)."""
    smem = np.zeros((box.shape[0], 8, 16), box.dtype)
    for r in range(box.shape[0]):
        for j in range(8):
            smem[r, j ^ (r % 8)] = box[r, 16 * j:16 * j + 16]
    return smem


def k_step(smem, kk):
    """What a K-major wgmma operand reads at k step kk, its descriptor 32
    bytes on in the swizzled rows: logical units 2 kk and 2 kk + 1 of each
    row, at their swizzled places."""
    rows = np.arange(smem.shape[0]) % 8
    lo = smem[np.arange(smem.shape[0]), (2 * kk) ^ rows]
    hi = smem[np.arange(smem.shape[0]), (2 * kk + 1) ^ rows]
    return np.concatenate([lo, hi], 1)


def _gelu_erf(v):
    return 0.5 * v * (1.0 + np.vectorize(math.erf)(v / math.sqrt(2.0)))


def kernel_np(x, gamma, beta, w_nc, w_scale, b, plan, *, round_out=True):
    """ln_linear_i8.cu in numpy: the pre-pass's codes and rs; per block
    its contiguous tile range; per 128-deep chunk the codes box (128 rows)
    and the W box(es) of the (G N, C) storage -- value rows n0.., then, for
    GEGLU, gate rows n + n0.. in the same stage -- read by four 32-deep k
    steps through the swizzle, each of the two consumer warpgroups its 64
    rows; the epilogue's ((acc rs) w_scale) + b, GEGLU and the bf16
    rounding, rows and columns past the output dropped."""
    m, c = x.shape
    n, vw, g = plan.c_plan[6], plan.vw, 2 if plan.geglu else 1
    codes, rs = quant_np(x, gamma, beta)
    out = np.full((m, n), np.nan, f32)
    for t0, t1 in block_ranges(plan):
        for t in range(t0, t1):
            mb, nt = divmod(t, plan.n_tiles)
            m0, n0 = mb * I8_BM, nt * vw
            acc = np.zeros((I8_BM, plan.bn), np.int64)
            for k in range(plan.kc):
                a = swizzle128(_box(codes, (m0, k * I8_BK), (I8_BM, I8_BK)))
                rows = [n0] + ([n + n0] if plan.geglu else [])
                bstage = np.concatenate(
                    [_box(w_nc, (r, k * I8_BK), (plan.bn // g, I8_BK))
                     for r in rows], 0)
                bsm = swizzle128(bstage)
                for w in range(2):          # the consumer warpgroups
                    rw = slice(64 * w, 64 * w + 64)
                    for kk in range(4):
                        acc[rw] += (k_step(a, kk)[rw].astype(np.int64)
                                    @ k_step(bsm, kk).astype(np.int64).T)
            cols = n0 + np.arange(vw)
            live = cols < n
            accf = acc.astype(f32)
            rsv = _box(rs, (m0,), (I8_BM,))[:, None]

            def dq(a_cols, off):
                sc = np.zeros(vw, f32)
                bb = np.zeros(vw, f32)
                sc[live] = w_scale[off + cols[live]]
                if b is not None:
                    bb[live] = b[off + cols[live]]
                return (a_cols * rsv) * sc + bb

            y = dq(accf[:, :vw], 0)
            if plan.geglu:
                y = y * _gelu_erf(dq(accf[:, vw:], n))
            if round_out:
                y = np.asarray(torch.from_numpy(y.astype(f32)).bfloat16()
                               .float())
            for r in range(I8_BM):
                if m0 + r < m:
                    out[m0 + r, cols[live]] = y[r, live]
    assert not np.isnan(out).any()      # every output written
    return out, codes, rs


def _inputs(seed, m, c, n, geglu, bias=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, c)) * 1.7 + 0.3).astype(f32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(f32)
    beta = (0.1 * rng.standard_normal(c)).astype(f32)
    w = (rng.standard_normal((c, n * (2 if geglu else 1)))
         / math.sqrt(c)).astype(f32)
    proj = {"kernel": jnp.asarray(w)}
    if bias:
        proj["bias"] = jnp.asarray(
            (0.2 * rng.standard_normal(w.shape[1])).astype(f32))
    return x, gamma, beta, jquant.quantize_linear_int8(proj)


def test_swizzled_k_steps_read_the_box():
    """The 32-byte k steps of a K-major operand, read back through the
    swizzle, are the box's 32-column slices."""
    box = np.random.default_rng(0).integers(-127, 128, (128, 128)).astype(
        np.int8)
    smem = swizzle128(box)
    for kk in range(4):
        np.testing.assert_array_equal(k_step(smem, kk),
                                      box[:, 32 * kk:32 * kk + 32])


@pytest.mark.parametrize("m,c", [(70, 128), (300, 640), (33, 1280),
                                 (17, 192)])
def test_pre_pass_model_matches_the_plain_codes(m, c):
    """The pre-pass model's codes and rs against the port's plain version
    on the CPU (see the module doc for why not bit for bit here)."""
    x, gamma, beta, _ = _inputs(3, m, c, 128, False)
    codes, rs = quant_np(x, gamma, beta)
    want_q, want_rs = cuda_norm.ln_quant_i8_torch(
        *map(torch.from_numpy, (x, gamma, beta)))
    diff = np.abs(codes.astype(f32) - want_q.numpy())
    assert diff.max() <= 1 and diff.mean() <= 1e-3
    np.testing.assert_allclose(rs, want_rs.numpy()[:, 0], rtol=1e-6)


# (M, C, N, geglu, BN): a ragged row block, ragged column tiles, C of 1, 2
# and 5 chunks (C = 192: a half-filled last chunk), both instances and both
# epilogues (the JAX kernel needs C and N multiples of 128)
NP_CASES = [(200, 128, 256, False, 256), (130, 128, 128, True, 128),
            (70, 256, 384, False, 128), (129, 640, 256, True, 256),
            (60, 192, 136, True, 256), (131, 256, 200, False, 128)]


@pytest.mark.parametrize("m,c,n,geglu,bn", NP_CASES)
def test_kernel_model_matches_jax_and_plain(m, c, n, geglu, bn):
    x, gamma, beta, qproj = _inputs(1, m, c, n, geglu)
    w_i8 = np.array(qproj["kernel_i8"])
    w_scale = np.array(qproj["kernel_scale"])
    b = np.array(qproj["bias"])
    plan = cuda_norm.ln_linear_i8_plan(m, c, n, geglu, tile=bn, sms=3)
    got, _, _ = kernel_np(x, gamma, beta, np.ascontiguousarray(w_i8.T),
                          w_scale, b, plan, round_out=False)
    plain = cuda_norm.ln_linear_i8_torch(
        *map(torch.from_numpy, (x, gamma, beta, w_i8, w_scale, b)),
        geglu=geglu).numpy()
    refs = [plain]
    if c % 128 == 0 and n % 128 == 0:
        norm = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
        refs.append(np.asarray(pallas_norm.ln_linear(
            jnp.asarray(x), norm, qproj, geglu=geglu), f32))
    for ref in refs:
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("m,c,n,geglu,bn", NP_CASES[:4])
def test_kernel_model_bf16_matches_jax(m, c, n, geglu, bn):
    """bf16 x and output: the model rounds once at the end, as both the
    Pallas kernel and the plain version do."""
    x, gamma, beta, qproj = _inputs(2, m, c, n, geglu)
    x = np.asarray(torch.from_numpy(x).bfloat16().float())
    w_i8 = np.asarray(qproj["kernel_i8"])
    plan = cuda_norm.ln_linear_i8_plan(m, c, n, geglu, tile=bn, sms=5)
    got, _, _ = kernel_np(x, gamma, beta, np.ascontiguousarray(w_i8.T),
                          np.asarray(qproj["kernel_scale"]),
                          np.asarray(qproj["bias"]), plan)
    norm = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    want = np.asarray(pallas_norm.ln_linear(
        jnp.asarray(x, jnp.bfloat16), norm, qproj,
        geglu=geglu).astype(jnp.float32))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
