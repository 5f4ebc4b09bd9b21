"""The launch plan of the wgmma attention kernel
(``cuda_attention.attention_plan``) and the kernel's loop, on the CPU.

The kernel (``idmvton_tpu_torch/ops/csrc/flash_attention.cuh``) runs only on
the card, so what surrounds it is held here: the plan the wrappers pass to
the C entry points, over every attention shape of the serving and tiny
paths and odd test shapes (its tensor maps, grid order and tile counts,
and the int64 array the C entry points read them from: they encode its
maps as given and derive nothing), and a numpy model of the kernel's
loop. The model reads its Q, K and V
boxes through the plan's tensor maps (TMA zero-fill past each tensor's
edge, as ``_box`` does), decodes each block as the kernel does, runs the
own then the garment tiles with the uncond rows' analytic sink, takes the
exp2 form of both softmax modes (the online one with its row max on the raw
logits, as the kernel's FFMA form) and casts P to the input's type for the
PV product. It is held against the JAX package: ``flash_attention_gemm``
(Pallas interpret mode, as tests/test_torch_ops.py runs it) in both
``IDMVTON_FLASH_FIXED_SHIFT`` modes, ``_gemm_ref_xla``, and
``flash_attention`` / ``flash_attention_fused_qkv`` (interpret mode above
the 256-key cutoff).

Tolerance: fp32 inputs, the same softmax on both sides in another order
(blockwise exp2 against one exp) and P kept in fp32 as the JAX kernels keep
it for fp32 values: max |diff| <= 2e-5 at O(1) outputs (the bound of
tests/test_torch_attention.py). With bf16 inputs both sides cast P to bf16,
and an exp2 and an exp of the same logit may round to neighbouring bf16
values: max |diff| <= 2e-2 * max |JAX|, the card's bound.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import pallas_attention as jpa
from idmvton_tpu_torch.ops import cuda_attention as A
from idmvton_tpu_torch.ops.cuda_attention import (
    BKV, INSTANCES, attention_plan,
)
from idmvton_tpu_torch.ops.cuda_conv import INT32_MAX

F32_TOL = 2e-5
BF16_TOL = 2e-2
LOG2E = 1.4426950408889634
NEG = -1e30


# flash_attention_gemm's shapes at 768x1024 (b, n, heads, d, m, uncond):
# TryonNet (B=4, CFG: 2 uncond rows, garment KV) and GarmentNet (B=2, no
# garment) at the 640 and 1280 levels, the tiny UNet's 128-wide level (8
# heads of 16); with and without uncond rows
GEMM = [(4, 3072, 10, 64, 3072, 2), (4, 3072, 10, 64, 3072, 0),
        (4, 768, 20, 64, 768, 2), (4, 768, 20, 64, 768, 0),
        (2, 3072, 10, 64, 0, 0), (2, 768, 20, 64, 0, 0),
        (4, 768, 8, 16, 768, 2), (2, 768, 8, 16, 0, 0),
        # odd: N and M off every BKV, M = 1, N = 1, every row uncond
        (3, 200, 2, 64, 150, 1), (2, 130, 4, 32, 1, 0), (2, 1, 2, 64, 7, 1),
        (4, 77, 2, 128, 300, 4), (1, 257, 8, 16, 129, 0)]


def _heads_strides(b, sq, skv, heads, d, layout, m=0):
    """(batch, row) element strides of q, k, v for the (B, S, H, D) views
    the port passes: "qkv", split heads of a to_qkv output (self
    attention); "garment", those over contiguous garment K / V of m keys
    (flash_attention_concat_kv: ten strides); "concat", q of a to_qkv
    output over contiguous K / V; "fused", slices of a (B, St, 3, H, D)
    buffer; "dense", contiguous q, k, v."""
    hd = heads * d
    if layout == "qkv":
        return (sq * 3 * hd, 3 * hd) * 3
    if layout == "garment":
        return (sq * 3 * hd, 3 * hd) * 3 + (m * hd, hd) * 2
    if layout == "concat":
        return (sq * 3 * hd, 3 * hd, skv * hd, hd, skv * hd, hd)
    if layout == "fused":
        return (skv * 3 * hd, 3 * hd) * 3
    return (sq * hd, hd, skv * hd, hd, skv * hd, hd)


# flash_attention's (b, sq, skv, heads, d, layout, m): the tiny UNet's
# 64-wide level (TryonNet over own then garment keys, GarmentNet self), the
# SDXL-width shape chip_smoke times, the fused-qkv layout, and odd shapes:
# Sq = 1, ragged tiles, M = 1, D = 8, 24, 72, 128
HEADS = [(4, 3072, 3072, 4, 16, "garment", 3072),
         (2, 3072, 3072, 4, 16, "qkv", 0),
         (4, 3072, 3072, 10, 64, "garment", 3072),
         (4, 3072, 6144, 4, 16, "fused", 0),
         (4, 3072, 6144, 10, 64, "fused", 0), (2, 1, 1000, 3, 64, "dense", 0),
         (2, 300, 384, 3, 8, "dense", 0), (2, 64, 257, 3, 24, "qkv", 0),
         (2, 130, 300, 3, 72, "concat", 0), (1, 200, 300, 2, 128, "fused", 0),
         (2, 130, 130, 2, 16, "garment", 1)]


def decode(plan, blk, b):
    """The kernel's block decode: (query tile, head, batch row); the rows
    that see the garment first."""
    qt = blk % plan.q_tiles
    heads = plan.grid // (plan.q_tiles * b)
    h = blk // plan.q_tiles % heads
    return qt, h, (blk // plan.q_tiles // heads + plan.uncond) % b


def c_plan_fields(plan):
    """The plan as flash_attention.cuh's Plan reads it back: its fields,
    then each map's (dims, strides, box, swizzle, element size) or None."""
    c = list(plan.c_plan)
    maps = []
    for i in range(13, 78, 13):
        dims, strides, box, sw, elem = (
            tuple(c[i:i + 4]), tuple(c[i + 4:i + 7]), tuple(c[i + 7:i + 11]),
            c[i + 11], c[i + 12])
        maps.append((dims, strides, box, sw, elem) if dims[0] else None)
    return tuple(c[:8]), tuple(c[8:13]), maps


def check_plan(plan, b, sq, skv, heads, d, m=0, uncond=0):
    bq = 64 * plan.wgs
    assert (plan.bkv, plan.wgs) in _template_tiles(plan.dp)
    assert d <= plan.dp < 2 * d or plan.dp == 16
    assert plan.uncond == (uncond if m else 0)
    assert plan.grid == plan.q_tiles * heads * b <= INT32_MAX
    assert plan.q_tiles * bq >= sq > (plan.q_tiles - 1) * bq
    assert plan.own_tiles * plan.bkv >= skv > (plan.own_tiles - 1) * plan.bkv
    if m and uncond < b:
        assert plan.garm_tiles * plan.bkv >= m > (plan.garm_tiles - 1) \
            * plan.bkv
    else:
        assert plan.garm_tiles == 0 and plan.kg_map is None
    # every (batch row, head, query) of the output in exactly one block, and
    # the blocks of the rows that read the garment before the uncond ones
    seen = np.zeros((b, heads, plan.q_tiles), int)
    rows = [decode(plan, blk, b) for blk in range(plan.grid)]
    for qt, h, bi in rows:
        seen[bi, h, qt] += 1
    assert (seen == 1).all()
    if m and uncond:
        cond = [bi >= uncond for _, _, bi in rows]
        assert cond == sorted(cond, reverse=True)
    maps = [(plan.q_map, bq), (plan.k_map, plan.bkv), (plan.v_map, plan.bkv)]
    if plan.kg_map is not None:
        maps += [(plan.kg_map, plan.bkv), (plan.vg_map, plan.bkv)]
    for tmap, rows_ in maps:
        assert len(tmap.dims) == len(tmap.box) == len(tmap.strides) + 1 == 4
        assert tmap.dims[0] == d and all(1 <= x < 2**32 for x in tmap.dims)
        assert all(s % 16 == 0 and s < 2**40 for s in tmap.strides)
        assert all(1 <= x <= 256 for x in tmap.box)
        assert tmap.box == (min(plan.dp, 64), 1, rows_, 1)
        assert tmap.swizzle == 2 * tmap.box[0] in (32, 64, 128)
        assert tmap.strides[0] == 2 * d       # heads packed
    # the head coordinates the kernel adds h to stay inside their maps
    for (tmap, _), h0 in zip(maps, plan.heads0):
        assert h0 + heads <= tmap.dims[1]
    # what the C entry points read is this plan, field for field
    fields, heads0, c_maps = c_plan_fields(plan)
    assert fields == tuple(plan[:8]) and heads0 == plan.heads0
    assert c_maps == [None if t is None else tuple(t) for t in
                      (plan.q_map, plan.k_map, plan.v_map, plan.kg_map,
                       plan.vg_map)]


@pytest.mark.parametrize("shape", GEMM)
def test_plan_covers_gemm_shapes(shape):
    b, n, heads, d, m, uncond = shape
    plan = attention_plan(b, n, n, heads, d, m=m, uncond_rows=uncond)
    check_plan(plan, b, n, n, heads, d, m, uncond)
    ld = 3 * heads * d
    assert plan.q_map.dims == (d, 3 * heads, n, b)
    assert plan.q_map.strides == (2 * d, 2 * ld, 2 * n * ld)
    assert plan.heads0 == (0, heads, 2 * heads, 0, heads)
    if m and uncond < b:
        assert plan.kg_map.dims == (d, 2 * heads, m, b - uncond)
    assert plan.bkv == BKV[plan.dp]
    assert (plan.dp, plan.bkv, plan.wgs) in INSTANCES


@pytest.mark.parametrize("shape", HEADS)
def test_plan_covers_heads_shapes(shape):
    b, sq, skv, heads, d, layout, m = shape
    strides = _heads_strides(b, sq, skv, heads, d, layout, m)
    plan = attention_plan(b, sq, skv, heads, d, m=m, strides=strides)
    check_plan(plan, b, sq, skv, heads, d, m)
    assert plan.q_map.dims == (d, heads, sq, b)
    assert plan.k_map.dims == (d, heads, skv, b)
    if m:
        assert plan.kg_map.dims == (d, heads, m, b)
        assert plan.vg_map.strides == (2 * d, 2 * strides[9], 2 * strides[8])
    assert plan.q_map.strides == (2 * d, 2 * strides[1], 2 * strides[0])
    assert plan.bkv == BKV[plan.dp]
    assert (plan.dp, plan.bkv, plan.wgs) in INSTANCES


def _sweep_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_attention_tiles.py"
    spec = importlib.util.spec_from_file_location("torch_attention_tiles",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_instances_are_the_kernels_dispatch():
    """The plan's INSTANCES are exactly what flash_attention.cuh's dispatch
    builds for the port, and the sweep's extra tiles what it adds under
    -DIDM_ATTN_SWEEP, so no plan reaches a missing instance; the C Plan is
    as long as the plan's c_plan; the header fixes the ring depth the sweep
    chose and refuses one stage, and the sweep builds only depths it
    takes."""
    src = (Path(A.__file__).parent / "csrc" / "flash_attention.cuh").read_text()
    port, sweep = src.split("#ifdef IDM_ATTN_SWEEP")

    def built(text):
        return {tuple(int(x) for x in m.groups()) for m in re.finditer(
            r"^  IDM_ATTN_TILE\((\d+), (\d+), (\d+)\)$", text, re.M)}

    script = _sweep_script()
    assert built(port) == set(INSTANCES)
    assert built(sweep) == set(script.SWEEP_INSTANCES)
    assert {(dp, BKV[dp], w) for dp in BKV for w in (2, 3)
            if dp < 128} | {(128, BKV[128], 2)} == set(INSTANCES)
    n = int(re.search(r"sizeof\(Plan\) == (\d+) \* sizeof", src).group(1))
    assert len(attention_plan(2, 300, 300, 2, 64).c_plan) == n
    assert "#define IDM_ATTN_STAGES 3" in src and script.PORT == (3, True)
    assert "static_assert(STAGES >= 2 && STAGES <= 4" in src
    assert {s for s, _ in script.VARIANTS} == {2, 3, 4}


def test_plan_weighs_warpgroups_by_waves():
    """Three consumer warpgroups (192-query tiles) where the waves allow:
    the 640-level shapes; two where 192-query tiles leave a last wave
    nearly empty (GarmentNet's 1280 level: 160 tiles on 132 SMs, against
    240 of 128 queries); two always at D = 128."""
    assert attention_plan(4, 3072, 3072, 10, 64, m=3072,
                          uncond_rows=2).wgs == 3
    assert attention_plan(2, 3072, 3072, 10, 64).wgs == 3
    assert attention_plan(2, 768, 768, 20, 64).wgs == 2
    assert attention_plan(4, 768, 768, 20, 64, m=768, uncond_rows=2).wgs == 3
    assert attention_plan(4, 3072, 6144, 4, 16,
                          strides=(3072 * 192, 192) * 3).wgs == 3
    assert attention_plan(4, 300, 300, 2, 128).wgs == 2
    # fewer SMs, fewer tiles a wave
    assert attention_plan(2, 768, 768, 20, 64, sms=160).wgs == 3


def test_plan_rejects_what_the_kernel_cannot_take():
    st = (64 * 300, 64) * 3
    for d in (0, 4, 12, 136):
        with pytest.raises(ValueError, match="head dim"):
            attention_plan(1, 300, 300, 2, d)
    with pytest.raises(ValueError, match="multiples of 8"):
        attention_plan(1, 300, 300, 2, 32, strides=(64 * 300, 68) * 3)
    with pytest.raises(ValueError, match="10 multiples"):
        attention_plan(1, 300, 300, 2, 32, m=10, strides=st)
    with pytest.raises(ValueError, match="uncond rows"):
        attention_plan(2, 300, 300, 2, 32, uncond_rows=1, strides=st)
    with pytest.raises(ValueError, match="uncond_rows"):
        attention_plan(2, 300, 300, 2, 64, m=10, uncond_rows=3)
    with pytest.raises(ValueError, match="skv == sq"):
        attention_plan(2, 300, 200, 2, 64)
    with pytest.raises(ValueError, match="no instance"):
        attention_plan(2, 300, 300, 2, 128, tile=(64, 3))
    with pytest.raises(ValueError, match="no instance"):
        attention_plan(2, 300, 300, 2, 64, tile=(96, 2))
    with pytest.raises(ValueError, match="no instance"):
        attention_plan(2, 300, 300, 2, 64, tile=(128, 4))
    # the ring depth and turn-taking are the kernel's constants, not a
    # plan's: a tile that names them is refused
    for tile in ((128, 1, True, 2), (64, 5, False, 2)):
        with pytest.raises(ValueError, match="not \\(BKV"):
            attention_plan(2, 300, 300, 2, 64, tile=tile)
    with pytest.raises(ValueError, match="int32"):
        attention_plan(2**20, 2**14, 2**14, 64, 64)
    with pytest.raises(ValueError, match="TMA"):
        attention_plan(1, 2**32, 2**32, 1, 8, strides=(8 * 2**32, 8) * 3)
    with pytest.raises(ValueError, match="b 0"):
        attention_plan(0, 300, 300, 2, 64)


# every (BKV, consumer warpgroups) of the kernel's template: the port's
# INSTANCES and the sweep's extra BKV 64 tiles among them
TEMPLATE_TILES = [(64, 2), (64, 3), (128, 2), (128, 3)]


def _template_tiles(dp):
    return [t for t in TEMPLATE_TILES if dp < 128 or t[1] == 2]


@pytest.mark.parametrize("tile", TEMPLATE_TILES)
def test_every_tile_plans_the_path_shape(tile):
    """Each tile at each padded head dim the template takes plans
    chip_smoke's TryonNet shape (what scripts/torch_attention_tiles.py
    sweeps)."""
    for dp in A.KERNEL_HEAD_DIMS:
        if tile not in _template_tiles(dp):
            continue
        plan = attention_plan(4, 3072, 3072, 10, dp, m=3072, uncond_rows=2,
                              tile=tile)
        assert (plan.bkv, plan.wgs) == tile
        check_plan(plan, 4, 3072, 3072, 10, dp, 3072, 2)


# ---------------------------------------------------------------------------
# the kernel's loop in numpy
# ---------------------------------------------------------------------------


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _box(src, starts, sizes):
    """A TMA tiled box: src[start:start + size] on every axis, zeros where
    the box leaves the tensor (negative starts included)."""
    out = np.zeros(sizes, src.dtype)
    dst_sl, src_sl = [], []
    for s0, n, dim in zip(starts, sizes, src.shape):
        lo, hi = max(s0, 0), min(s0 + n, dim)
        if hi <= lo:
            return out
        src_sl.append(slice(lo, hi))
        dst_sl.append(slice(lo - s0, hi - s0))
    out[tuple(dst_sl)] = src[tuple(src_sl)]
    return out


def _mapped(base, tmap):
    """The tensor a map describes, (batch, rows, heads, D) over a flat fp32
    buffer: its dims and byte strides (bf16 elements) read back."""
    d, heads, rows, batch = tmap.dims
    el = base.itemsize
    strides = tuple(el * s // 2 for s in tmap.strides[::-1]) + (el,)
    return np.lib.stride_tricks.as_strided(base, (batch, rows, heads, d),
                                           strides, writeable=False)


def _tile(src, tmap, dp, b, row0, head, rows):
    """Q / K / V tile of `rows` rows: the map's boxes side by side, (rows,
    dp) with the columns past D zero-filled."""
    cols = tmap.box[0]
    return np.concatenate(
        [_box(src, (b, row0, head, x), (1, rows, 1, cols))[0, :, 0]
         for x in range(0, dp, cols)], axis=1)


def kernel_np(plan, bases, *, heads, nq, n, m, sink, scale, fixed, cast):
    """The kernel's loop over its blocks in numpy; ``bases`` the flat
    buffers under the q, k, v, garment k, garment v maps; ``cast`` P's
    rounding for the PV product. Returns (B, nq, heads, D) fp32."""
    qs, ks, vs = (_mapped(x, t) for x, t in
                  zip(bases, (plan.q_map, plan.k_map, plan.v_map)))
    if plan.kg_map is not None:
        kgs, vgs = (_mapped(x, t) for x, t in
                    zip(bases[3:], (plan.kg_map, plan.vg_map)))
    b, d = qs.shape[0], qs.shape[3]
    out = np.zeros((b, nq, heads, d), np.float32)
    c = scale * LOG2E
    for blk in range(plan.grid):
        qt, h, bi = decode(plan, blk, b)
        bq = 64 * plan.wgs
        q0 = qt * bq
        garm = plan.garm_tiles > 0 and bi >= plan.uncond
        tiles = plan.own_tiles + (plan.garm_tiles if garm else 0)
        s0 = sink + (m if m > 0 and bi < plan.uncond else 0)
        mx = np.full(bq, 0.0 if s0 > 0 else NEG, np.float32)
        l_ = np.full(bq, s0, np.float32)
        o = np.zeros((bq, plan.dp), np.float32)
        q = _tile(qs, plan.q_map, plan.dp, bi, q0, plan.heads0[0] + h, bq)
        for t in range(tiles):
            own = t < plan.own_tiles
            key0 = (t if own else t - plan.own_tiles) * plan.bkv
            src_k, src_v = (ks, vs) if own else (kgs, vgs)
            hk, hv = plan.heads0[1:3] if own else plan.heads0[3:5]
            row_b = bi if own else bi - plan.uncond
            kt = _tile(src_k, plan.k_map, plan.dp, row_b, key0, hk + h,
                       plan.bkv)
            vt = _tile(src_v, plan.v_map, plan.dp, row_b, key0, hv + h,
                       plan.bkv)
            s = q @ kt.T
            cs = c
            if not c > 0:
                s, cs = s * c, 1.0
            s[:, np.arange(key0, key0 + plan.bkv) >= (n if own else m)] \
                = -np.inf
            if fixed:
                p = np.exp2(np.minimum(s * cs, 60 * LOG2E))
                l_ += p.sum(1)
            else:
                new = np.maximum(mx, s.max(1) * cs)
                al = np.exp2(mx - new)
                mx = new
                p = np.exp2(s * cs - new[:, None])
                l_ = al * l_ + p.sum(1)
                o *= al[:, None]
            o += cast(p) @ vt
        rows = min(bq, nq - q0)
        out[bi, q0:q0 + rows, h] = (o / np.maximum(l_, 1e-30)[:, None])[
            :rows, :d]
    return out


def _keep(p):
    return p


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float() \
        .numpy()


def gemm_np(qkv, kv, heads, *, sink=0, uncond=0, fixed=True, scale=None,
            cast=_keep, tile=None):
    b, n, three_hd = qkv.shape
    d = three_hd // 3 // heads
    m = 0 if kv is None else kv.shape[1]
    plan = attention_plan(b, n, n, heads, d, m=m, uncond_rows=uncond,
                          tile=tile)
    g = kv.reshape(-1) if kv is not None and kv.size else None
    flat = qkv.reshape(-1)
    out = kernel_np(plan, (flat, flat, flat, g, g), heads=heads, nq=n, n=n,
                    m=m, sink=sink,
                    scale=d ** -0.5 if scale is None else scale,
                    fixed=fixed, cast=cast)
    return out.reshape(b, n, heads * d)


# (garment, uncond, sink, fixed) as tests/test_torch_ops.py holds the plain
# version, plus every row uncond and a ragged tile at D = 16
GEMM_CASES = [(False, 0, 0, True), (True, 2, 0, True), (True, 2, 3, False),
              (True, 0, 0, False), (False, 0, 4, True), (True, 2, 0, False)]


@pytest.mark.parametrize("garment,uncond,sink,fixed", GEMM_CASES)
def test_gemm_loop_matches_pallas(monkeypatch, garment, uncond, sink, fixed):
    monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "1" if fixed else "0")
    b, n, m, heads, d = 4, 200, 150, 2, 64
    qkv = _np(12, b, n, 3 * heads * d)
    kv = _np(13, b - uncond, m, 2 * heads * d) if garment else None
    want = jpa.flash_attention_gemm(
        jnp.asarray(qkv), None if kv is None else jnp.asarray(kv),
        heads=heads, sink_tokens=sink, uncond_rows=uncond)
    got = gemm_np(qkv, kv, heads, sink=sink, uncond=uncond, fixed=fixed)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("b,n,m,heads,d,uncond,sink", [
    (4, 130, 70, 8, 16, 2, 0), (2, 40, 30, 2, 32, 2, 0),
    (3, 9, 1, 1, 128, 1, 2), (2, 150, 257, 4, 32, 0, 0)])
def test_gemm_loop_matches_the_oracle(b, n, m, heads, d, uncond, sink, fixed):
    """Against _gemm_ref_xla (an exact softmax over explicit zero garment
    KV and sink tokens) at other head dims, ragged tiles, M = 1 and every
    row uncond; each at another forced tile of the same head dim."""
    qkv = _np(14, b, n, 3 * heads * d, scale=0.7)
    kv = _np(15, b - uncond, m, 2 * heads * d, scale=0.7)
    want = jpa._gemm_ref_xla(jnp.asarray(qkv), jnp.asarray(kv), heads,
                             d ** -0.5, sink, uncond)
    dp = attention_plan(b, n, n, heads, d).dp
    for tile in _template_tiles(dp):
        got = gemm_np(qkv, kv, heads, sink=sink, uncond=uncond, fixed=fixed,
                      tile=tile)
        np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL,
                                   rtol=0)


def test_gemm_loop_bf16_matches_pallas(monkeypatch):
    """bf16 inputs: the model casts P to bf16 for PV, as the kernel and the
    Pallas kernel do."""
    monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "1")
    b, n, m, heads, d = 4, 200, 150, 2, 64
    qkv, kv = _bf16(_np(16, b, n, 3 * heads * d)), _bf16(
        _np(17, b - 2, m, 2 * heads * d))
    want = np.asarray(jpa.flash_attention_gemm(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16),
        heads=heads, uncond_rows=2).astype(jnp.float32))
    got = _bf16(gemm_np(qkv, kv, heads, uncond=2, cast=_bf16))
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def heads_np(bufs, offs, shape, layout, *, m=0, scale=None, tile=None):
    """The kernel's loop over (B, S, H, D) views: ``bufs`` the flat fp32
    buffers q, k, v (and garment k, v) lie in at element offsets
    ``offs``."""
    b, sq, skv, heads, d = shape
    strides = _heads_strides(b, sq, skv, heads, d, layout, m)
    plan = attention_plan(b, sq, skv, heads, d, m=m, strides=strides,
                          tile=tile)
    bases = [buf[off:] for buf, off in zip(bufs, offs)]
    return kernel_np(plan, bases, heads=heads, nq=sq, n=skv, m=m,
                     sink=0, scale=d ** -0.5 if scale is None else scale,
                     fixed=False, cast=_keep)


@pytest.mark.parametrize("d", [8, 16, 24, 64, 72])
def test_heads_loop_matches_pallas(d):
    """q of a to_qkv output over contiguous [own | garment] K / V, as the
    narrow-head self-attention passes them, against JAX flash_attention
    (Pallas interpret mode: 300 keys, past the cutoff)."""
    b, sq, skv, heads = 2, 150, 300, 2
    hd = heads * d
    qkv = _np(20, b, sq, 3 * hd)
    k, v = _np(21, b, skv, heads, d), _np(22, b, skv, heads, d)
    q = qkv[..., :hd].reshape(b, sq, heads, d)
    want = jpa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = heads_np((qkv.reshape(-1), k.reshape(-1), v.reshape(-1)),
                   (0, 0, 0), (b, sq, skv, heads, d), "concat")
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("d,m", [(16, 300), (64, 150), (24, 1)])
def test_garment_segment_matches_pallas_concat_kv(d, m):
    """The split heads of a to_qkv output over own then garment keys read
    as two segments (no concatenation), against JAX
    flash_attention_concat_kv (Pallas interpret mode over the concatenated
    keys)."""
    b, n, heads = 2, 150, 2
    hd = heads * d
    qkv = _np(25, b, n, 3 * hd)
    kg, vg = _np(26, b, m, heads, d), _np(27, b, m, heads, d)
    q, k, v = (jnp.asarray(qkv[..., i * hd:(i + 1) * hd].reshape(
        b, n, heads, d)) for i in range(3))
    want = jpa.flash_attention_concat_kv(q, k, v, jnp.asarray(kg),
                                         jnp.asarray(vg))
    flat = qkv.reshape(-1)
    got = heads_np((flat, flat, flat, kg.reshape(-1), vg.reshape(-1)),
                   (0, hd, 2 * hd, 0, 0), (b, n, n, heads, d), "garment",
                   m=m)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_fused_loop_matches_pallas(d):
    """The (B, St, 3, H, D) slices, read in place at offsets 0, H*D and
    2*H*D of one buffer, against JAX flash_attention_fused_qkv."""
    b, st, s_own, heads = 2, 384, 300, 2
    qkv = _np(23, b, st, 3, heads, d)
    want = jpa.flash_attention_fused_qkv(jnp.asarray(qkv), s_own)
    flat = qkv.reshape(-1)
    hd = heads * d
    got = heads_np((flat,) * 3, (0, hd, 2 * hd), (b, s_own, st, heads, d),
                   "fused")
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL, rtol=0)


def test_heads_loop_generic_scale_matches_plain():
    """A negative scale takes the kernel's generic row max (logits scaled
    before it), here against the plain version at the split-heads
    layout."""
    b, sq, heads, d = 2, 64, 3, 24
    hd = heads * d
    qkv = _np(24, b, sq, 3 * hd)
    views = [torch.from_numpy(qkv[..., i * hd:(i + 1) * hd]).reshape(
        b, sq, heads, d) for i in range(3)]
    want = A.flash_attention_torch(*views, scale=-0.3).numpy()
    flat = qkv.reshape(-1)
    got = heads_np((flat,) * 3, (0, hd, 2 * hd), (b, sq, sq, heads, d), "qkv",
                   scale=-0.3)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
