"""The launch plan of the wgmma small-KV cross-attention kernel
(``cuda_attention.cross_attention_plan``) and the kernel's arithmetic, on
the CPU.

The kernel (``idmvton_tpu_torch/ops/csrc/cross_attention_small_kv.cu``)
runs only on the card, so what surrounds it is held here: the plan the
wrapper passes to the C entry point, over every cross-attention shape of the
variant path and its refusals, and a numpy model of the kernel -- the
persistent blocks' contiguous ranges of (batch row, head group, 128-query)
tiles, the per-head TMA boxes of q and of the K / V chunks (zero-filled past
the tensor), the key columns past a branch's length masked to -inf, the
exact softmax normalized before PV, the two-pass scheme of contexts longer
than a chunk, and the fp32 sum o_text + ip_scale * o_ip.

The model is held against the JAX package's Pallas
``cross_attention_small_kv`` (interpret mode, as tests/test_ops.py runs it)
and the port's plain version. Tolerances: in fp32 both sides differ in
summation order only (the chunked sums and the running max rescale the
same terms): 2e-5 absolute and relative at O(1) values. In bf16 the model
rounds P to bf16 as the kernel does and the output once; JAX's kernel and
the plain version round the same places: 1e-2 of max |want|, as the card
tests.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import pallas_attention
from idmvton_tpu_torch.ops import cuda_attention as A
from idmvton_tpu_torch.ops.cuda_attention import (
    CROSS_BQ, CROSS_GC, CROSS_KC, cross_attention_plan,
)

F32_TOL = 2e-5
BF16_TOL = 1e-2
CSRC = Path(A.__file__).parent / "csrc" / "cross_attention_small_kv.cu"

# (B, N, heads, D, S_text, S_ip) of every cross_attention_small_kv call of
# the variant path at 768x1024: TryonNet (B = 4: 77 text + 16 IP tokens) and
# GarmentNet (B = 2: text only) at the 640 (3072 tokens, 10 heads) and 1280
# (768 tokens, 20 heads) levels
PATH = [(4, 3072, 10, 64, 77, 16), (4, 768, 20, 64, 77, 16),
        (2, 3072, 10, 64, 77, 0), (2, 768, 20, 64, 77, 0)]


def _cdiv(a, b):
    return -(-a // b)


def block_ranges(plan):
    return [(b * plan.tiles // plan.grid, (b + 1) * plan.tiles // plan.grid)
            for b in range(plan.grid)]


def decode(plan, t):
    """Tile t -> (batch row, head group, query tile): the kernel's order,
    query tiles fastest, so a block's range stays within few groups."""
    unit, qt = divmod(t, plan.q_tiles)
    return unit // plan.groups, unit % plan.groups, qt


def c_plan_fields(plan):
    """The plan as cross_attention_small_kv.cu's Plan reads it back: its 7
    fields, then each map's (dims, strides, box, swizzle, element size) or
    None."""
    c = list(plan.c_plan)
    maps = []
    for i in range(7, 46, 13):
        m = (tuple(c[i:i + 4]), tuple(c[i + 4:i + 7]), tuple(c[i + 7:i + 11]),
             c[i + 11], c[i + 12])
        maps.append(m if m[0][0] else None)
    return tuple(c[:7]), maps


def check_plan(plan, b, n, heads, d, s_text, s_ip, sms=132):
    hd = heads * d
    assert plan.dp == d and plan.groups == hd // CROSS_GC
    assert plan.q_tiles == _cdiv(n, CROSS_BQ)
    assert plan.tiles == b * plan.groups * plan.q_tiles
    assert plan.grid == min(plan.tiles, sms)
    assert plan.text_chunks == _cdiv(s_text, CROSS_KC[0])
    assert plan.ip_chunks == _cdiv(s_ip, CROSS_KC[1])
    # every (batch row, group, query tile) in exactly one block's range
    seen = np.zeros((b, plan.groups, plan.q_tiles), int)
    for t0, t1 in block_ranges(plan):
        assert t1 > t0
        for t in range(t0, t1):
            seen[decode(plan, t)] += 1
    assert (seen == 1).all()
    box = min(d, 64)
    maps = [(plan.q_map, (d, heads, n, b), (2 * d, 2 * hd, 2 * n * hd),
             CROSS_BQ),
            (plan.kv_map, (d, 2 * heads, s_text, b),
             (2 * d, 4 * hd, 4 * s_text * hd), CROSS_KC[0])]
    if s_ip:
        maps.append((plan.ip_map, (d, 2 * heads, s_ip, b),
                     (2 * d, 4 * hd, 4 * s_ip * hd), CROSS_KC[1]))
    else:
        assert plan.ip_map is None
    for tmap, dims, strides, rows in maps:
        assert tmap.dims == dims and tmap.strides == strides
        assert tmap.box == (box, 1, rows, 1)
        assert tmap.swizzle == 2 * box and tmap.elem == 2
        assert all(s % 16 == 0 for s in tmap.strides)
        assert all(1 <= x <= 256 for x in tmap.box)
    fields, c_maps = c_plan_fields(plan)
    assert fields == tuple(plan[:7])
    assert c_maps == [None if t is None else tuple(t)
                      for t in (plan.q_map, plan.kv_map, plan.ip_map)]


@pytest.mark.parametrize("shape", PATH)
def test_plan_covers_path_shapes(shape):
    plan = cross_attention_plan(*shape)
    check_plan(plan, *shape)
    assert plan.grid == min(plan.tiles, 132) and plan.text_chunks == 1
    assert plan.ip_chunks == (1 if shape[-1] else 0)
    # a block's range crosses at most one group boundary: its K / V load
    # twice at most
    for t0, t1 in block_ranges(plan):
        units = {t // plan.q_tiles for t in range(t0, t1)}
        assert len(units) <= 2


@pytest.mark.parametrize("shape", [(2, 200, 16, 16, 8, 0),
                                   (2, 200, 8, 32, 300, 90),
                                   (1, 1, 1, 128, 1024, 16),
                                   (3, 130, 2, 64, 81, 17)])
def test_plan_covers_other_shapes(shape):
    check_plan(cross_attention_plan(*shape, sms=7), *shape, sms=7)


def test_plan_is_cached_and_refuses_what_the_kernel_cannot_take():
    assert cross_attention_plan(4, 3072, 10, 64, 77, 16) is \
        cross_attention_plan(4, 3072, 10, 64, 77, 16)
    for heads, d in ((3, 64), (8, 8), (1, 96)):
        with pytest.raises(ValueError, match="head dim"):
            cross_attention_plan(2, 10, heads, d, 77)
    with pytest.raises(ValueError, match="s_text"):
        cross_attention_plan(2, 10, 2, 64, 0)


def test_c_source_reads_the_plan():
    src = CSRC.read_text()
    n = int(re.search(r"sizeof\(Plan\) == (\d+) \* sizeof", src).group(1))
    assert len(cross_attention_plan(2, 300, 2, 64, 77, 16).c_plan) == n
    kc = re.search(r"KC_T = (\d+), KC_I = (\d+);", src).groups()
    assert tuple(map(int, kc)) == CROSS_KC
    assert f"BQ = {CROSS_BQ}, GC = {CROSS_GC}" in src
    assert "wmma::" not in src and "mma.sync" not in src


def test_wrapper_checks_before_building():
    q = torch.zeros(2, 16, 128, dtype=torch.bfloat16)
    kv = torch.zeros(2, 77, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        A.cross_attention_small_kv(q, kv, heads=16)
    with pytest.raises(ValueError, match="does not match"):
        A.cross_attention_small_kv(q, kv[:, :, :128], heads=2)
    with pytest.raises(ValueError, match="CUDA"):
        A.cross_attention_small_kv(q, kv, heads=2)


# ---------------------------------------------------------------------------
# the kernel in numpy
# ---------------------------------------------------------------------------


def _box(src, starts, sizes):
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


def bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def kernel_np(q, kv, kv_ip, heads, scale, ip_scale, plan, *, round_p):
    """cross_attention_small_kv.cu in numpy, over views of q (B, N, H, D)
    and kv (B, S, 2H, D) as the tensor maps see them: per block its tile
    range; per tile and head the Q box (128 rows, zeros past N); per branch
    the K and V boxes of each KC-row chunk (zeros past S), S = Q K^T
    scaled, key columns at or past the chunk's length -inf, one chunk: the
    exact softmax; more: a pass for the running max and sum, a second for P
    = exp(s - m) / l; P (rounded to bf16 with ``round_p``) times V summed
    over chunks in fp32; o_text + ip_scale * o_ip; rows past N dropped."""
    b, n, hd = q.shape
    d = hd // heads
    qv = q.reshape(b, n, heads, d)
    branches = [(kv.reshape(b, kv.shape[1], 2 * heads, d), CROSS_KC[0],
                 plan.text_chunks, 1.0)]
    if kv_ip is not None:
        branches.append((kv_ip.reshape(b, kv_ip.shape[1], 2 * heads, d),
                         CROSS_KC[1], plan.ip_chunks, ip_scale))
    out = np.full((b, n, heads, d), np.nan, np.float32)
    hpb = CROSS_GC // d
    for t0, t1 in block_ranges(plan):
        for t in range(t0, t1):
            bi, grp, qt = decode(plan, t)
            for hh in range(hpb):
                h = grp * hpb + hh
                qb = _box(qv[bi, :, h], (qt * CROSS_BQ, 0), (CROSS_BQ, d))
                o = np.zeros((CROSS_BQ, d), np.float32)
                for kvv, kc, chunks, weight in branches:
                    s_len = kvv.shape[1]

                    def chunk(ch):
                        kb = _box(kvv[bi, :, h], (ch * kc, 0), (kc, d))
                        vb = _box(kvv[bi, :, heads + h], (ch * kc, 0),
                                  (kc, d))
                        s = (qb @ kb.T).astype(np.float32) * np.float32(scale)
                        s[:, np.arange(kc) >= s_len - ch * kc] = -np.inf
                        return s, vb

                    m = np.full((CROSS_BQ, 1), -np.inf, np.float32)
                    l = np.zeros((CROSS_BQ, 1), np.float32)
                    for ch in range(chunks):       # the max and sum
                        s, _ = chunk(ch)
                        mn = np.maximum(m, s.max(1, keepdims=True))
                        l = l * np.exp(m - mn) + np.exp(s - mn).sum(
                            1, keepdims=True)
                        m = mn
                    ob = np.zeros((CROSS_BQ, d), np.float32)
                    for ch in range(chunks):       # P and PV
                        s, vb = chunk(ch)
                        p = np.exp(s - m) / l
                        ob += (bf16(p) if round_p else p) @ vb
                    o = o + np.float32(weight) * ob
                rows = qt * CROSS_BQ + np.arange(CROSS_BQ)
                live = rows < n
                out[bi, rows[live], h] = o[live]
    assert not np.isnan(out).any()
    return out.reshape(b, n, hd)


def _inputs(seed, b, n, heads, d, s_text, s_ip, scale=1.5):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    hd = heads * d
    return r(b, n, hd), r(b, s_text, 2 * hd), (r(b, s_ip, 2 * hd)
                                                if s_ip else None)


# (B, N, heads, D, S_text, S_ip): each head dim, one and several chunks of
# each branch (80 text / 16 IP key rows a chunk), no IP branch, ragged query
# tiles, more tiles than blocks
NP_CASES = [(2, 200, 2, 64, 77, 16), (1, 130, 8, 16, 8, 0),
            (2, 64, 4, 32, 300, 40), (1, 150, 1, 128, 81, 17),
            (3, 40, 2, 64, 160, 0)]


@pytest.mark.parametrize("b,n,heads,d,s_text,s_ip", NP_CASES)
def test_kernel_model_matches_jax_fp32(b, n, heads, d, s_text, s_ip):
    q, kv, kv_ip = _inputs(1, b, n, heads, d, s_text, s_ip)
    scale, ip_scale = d ** -0.5, 0.7
    plan = cross_attention_plan(b, n, heads, d, s_text, s_ip, sms=5)
    got = kernel_np(q, kv, kv_ip, heads, scale, ip_scale, plan,
                    round_p=False)
    want = pallas_attention.cross_attention_small_kv(
        jnp.asarray(q), jnp.asarray(kv),
        None if kv_ip is None else jnp.asarray(kv_ip), heads=heads,
        ip_scale=ip_scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    plain = A.cross_attention_small_kv_torch(
        torch.from_numpy(q), torch.from_numpy(kv),
        None if kv_ip is None else torch.from_numpy(kv_ip), heads=heads,
        ip_scale=ip_scale)
    np.testing.assert_allclose(got, plain.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("b,n,heads,d,s_text,s_ip", NP_CASES[:3])
def test_kernel_model_bf16_matches_jax(b, n, heads, d, s_text, s_ip):
    """bf16 inputs: the model rounds P to bf16 before PV and the output
    once, as the kernel does."""
    q, kv, kv_ip = (None if t is None else bf16(t)
                    for t in _inputs(2, b, n, heads, d, s_text, s_ip))
    plan = cross_attention_plan(b, n, heads, d, s_text, s_ip, sms=4)
    got = bf16(kernel_np(q, kv, kv_ip, heads, d ** -0.5, 1.0, plan,
                         round_p=True))
    want = pallas_attention.cross_attention_small_kv(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
        None if kv_ip is None else jnp.asarray(kv_ip, jnp.bfloat16),
        heads=heads)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
