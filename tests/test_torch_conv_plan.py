"""The launch plan of the wgmma conv kernel (``cuda_conv.conv_plan``) and
the kernel's index arithmetic, on the CPU.

The kernel (``idmvton_tpu_torch/ops/csrc/conv3x3.cuh``) runs only on the
card, so what surrounds it is held here: the plan the wrappers pass to the
C entry points, over every conv shape of the serving path and odd test
shapes, and numpy versions of the kernel's tile decode and epilogue (which
output pixel each GEMM row of a tile stores) and of its per-tap A boxes
(TMA zero-fill outside the tensor).

The padded-row formulation of ``conv3x3_padacc`` (nine row-offset GEMMs
over the flattened padded input, margin columns dropped) is held against
the JAX package's ``_conv3_kernel_padacc`` (Pallas interpret mode, as
tests/test_torch_variants.py runs it) and against ``conv3x3_torch``; the
halo formulation of ``conv3x3`` against ``conv3x3_torch``. Tolerance: fp32
on every side, sums in other orders: 1e-5 absolute and relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import pallas_conv
from idmvton_tpu_torch.ops import cuda_conv
from idmvton_tpu_torch.ops.cuda_conv import BK, INT32_MAX, TILES, conv_plan

TOL = 1e-5


def _cdiv(a, b):
    return -(-a // b)


# (B, H, W, Cin, Cout) of every 3x3 stride-1 conv the kernels take at
# 768x1024: the UNet's three levels (TryonNet B=4, GarmentNet B=2; resnet
# convs, skip-concat inputs, upsample convs) and the VAE's four (encoder
# B=6 for the three images of a request, decoder B=2)
UNET = [(h, w, cin, cout)
        for h, w, pairs in (
            (128, 96, [(320, 320), (320, 640), (640, 640), (960, 320),
                       (640, 320)]),
            (64, 48, [(640, 640), (640, 1280), (1280, 1280), (1920, 640),
                      (1280, 640), (960, 640)]),
            (32, 24, [(1280, 1280), (2560, 1280), (1920, 1280)]))
        for cin, cout in pairs]
VAE = [(1024, 768, 128, 128), (1024, 768, 256, 128), (1024, 768, 256, 256),
       (512, 384, 128, 256), (512, 384, 256, 256), (512, 384, 512, 256),
       (512, 384, 512, 512), (256, 192, 256, 512), (256, 192, 512, 512),
       (128, 96, 512, 512)]
PATH = ([(b,) + s for b in (4, 2) for s in UNET]
        + [(b,) + s for b in (6, 2) for s in VAE])
# ragged tiles, ragged K chunks, Cout off every N tile, W below 8
ODD = [(2, 10, 12, 128, 256), (3, 7, 9, 256, 128), (1, 12, 16, 160, 128),
       (2, 19, 27, 320, 640), (3, 12, 10, 256, 200), (2, 9, 13, 2560, 256),
       (1, 5, 3, 32, 8), (1, 1, 1, 8, 8)]


def tile_pixels(plan, b, h, w, padded):
    """(m_tiles, BM): the flat output pixel (bi * H + y) * W + x that GEMM
    row r of m tile m stores, or -1 where the kernel drops the row -- its
    ``tile_origin`` and epilogue."""
    m = np.arange(plan.m_tiles, dtype=np.int64)[:, None]
    r = np.arange(plan.bm, dtype=np.int64)[None, :]
    if padded:
        bi = m // plan.tiles_per_image
        p = (m % plan.tiles_per_image) * plan.bm + r
        y, x = p // (w + 2), p % (w + 2)
    else:
        tiles_x, tiles_y = _cdiv(w, plan.tile_w), _cdiv(h, plan.tile_h)
        bi = m // (tiles_x * tiles_y)
        y = (m // tiles_x) % tiles_y * plan.tile_h + r // plan.tile_w
        x = m % tiles_x * plan.tile_w + r % plan.tile_w
    ok = (y < h) & (x < w)
    assert (bi[ok.any(axis=1)] < b).all()
    return np.where(ok, (bi * h + y) * w + x, -1)


def check_plan(plan, b, h, w, cin, cout, padded):
    # every output pixel stored exactly once by the m tiles ...
    pix = tile_pixels(plan, b, h, w, padded)
    counts = np.bincount(pix[pix >= 0], minlength=b * h * w)
    assert counts.shape == (b * h * w,) and (counts == 1).all()
    # ... and every output channel by the n tiles (8-column stores, clipped)
    cols = np.arange(plan.n_tiles)[:, None] * plan.bn + np.arange(plan.bn)
    assert np.bincount(cols[cols < cout], minlength=cout).tolist() \
        == [1] * cout
    assert plan.tiles == plan.m_tiles * plan.n_tiles <= INT32_MAX
    assert (plan.bm, plan.bn) in TILES
    for tmap in (plan.x_map, plan.w_map):
        assert all(1 <= d <= 256 for d in tmap.box)
        assert tmap.box[0] * 2 <= tmap.swizzle          # inner box bytes
        assert all(s % 16 == 0 for s in tmap.strides)
        assert len(tmap.dims) == len(tmap.box) == len(tmap.strides) + 1
    x_box = int(np.prod(plan.x_map.box))
    assert x_box == plan.bm * BK                        # A: BM rows of 128 B
    assert plan.w_map.box[1] == BK and plan.bn % plan.w_map.box[0] == 0
    assert plan.w_map.dims == (cout, cin, 9)
    # the largest TMA coordinate stays in int32
    if padded:
        rows = plan.x_map.dims[1]
        assert rows == b * (h + 2) * (w + 2)
        assert plan.tiles_per_image * plan.bm >= h * (w + 2)
        assert plan.x_map.box == (BK, plan.bm)
        last = rows + plan.tiles_per_image * plan.bm + 2 * (w + 2) + 2
    else:
        assert plan.x_map.dims == (cin, w, h, b)
        assert plan.tile_h * plan.tile_w == plan.bm
        # smem row ht * tile_w + wt: the epilogue's row order
        assert plan.x_map.box == (BK, plan.tile_w, plan.tile_h, 1)
        last = max(h, w) + 256
    assert last <= INT32_MAX


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("shape", PATH)
def test_plan_covers_path_shapes(shape, padded):
    plan = conv_plan(*shape, padded=padded)
    check_plan(plan, *shape, padded)
    if not padded and shape[2] % 8 == 0 and shape[1] % 16 == 0:
        # the serving path's levels tile exactly: no row computed for nothing
        assert (tile_pixels(plan, *shape[:3], False) >= 0).all()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("shape", ODD + [(4, 32, 24, 1280, 1280)])
def test_every_tile_covers_odd_shapes(shape, tile, padded):
    check_plan(conv_plan(*shape, padded=padded, tile=tile), *shape, padded)


def test_plan_picks_by_shape_and_rejects_what_the_kernel_cannot_take():
    # Cout 320 in two 160-wide tiles, not three of 128 (384 columns)
    assert conv_plan(4, 128, 96, 320, 320).bn == 160
    # the 32x24 level: one wave of 120 tiles on 132 SMs
    plan = conv_plan(4, 32, 24, 1280, 1280)
    assert plan.tiles <= cuda_conv.SMS
    # the hblock and plain sites take the same plan (bit-equal outputs)
    assert conv_plan(2, 10, 12, 128, 256) == conv_plan(2, 10, 12, 128, 256)
    with pytest.raises(ValueError, match="% 8"):
        conv_plan(1, 8, 8, 132, 128)
    with pytest.raises(ValueError, match="% 8"):
        conv_plan(1, 8, 8, 128, 132)
    with pytest.raises(ValueError, match="int32"):
        conv_plan(4096, 1024, 1024, 128, 128, padded=True)
    with pytest.raises(ValueError, match="tile"):
        conv_plan(1, 8, 8, 128, 128, tile=(64, 64))


# the fp32 decode's conv shapes (VAEConfig.force_upcast, decoder B=2)
VAE_DEC = [(2,) + s for s in VAE if s[0] <= 1024]


@pytest.mark.parametrize("shape", VAE_DEC + ODD)
def test_fp32_plan_covers_decode_shapes(shape):
    """An fp32 x: BM = 128 tiles only (two stages of its raw 256-byte A rows
    fit), the x box unswizzled with 4-byte strides; coverage as bf16."""
    b, h, w, cin, cout = shape
    plan = conv_plan(*shape, f32=True)
    assert (plan.bm, plan.bn) in cuda_conv.F32_TILES
    pix = tile_pixels(plan, b, h, w, False)
    assert (np.bincount(pix[pix >= 0], minlength=b * h * w) == 1).all()
    assert plan.x_map.dims == (cin, w, h, b)
    assert plan.x_map.strides == (4 * cin, 4 * cin * w, 4 * cin * w * h)
    assert plan.x_map.box == (BK, plan.tile_w, plan.tile_h, 1)
    assert plan.x_map.swizzle == 0 and plan.x_map.box[0] * 4 <= 256
    assert plan.w_map == conv_plan(*shape, tile=(plan.bm, plan.bn)).w_map
    for tile in TILES:
        if tile in cuda_conv.F32_TILES:
            conv_plan(*shape, f32=True, tile=tile)
        else:
            with pytest.raises(ValueError, match="tile"):
                conv_plan(*shape, f32=True, tile=tile)


def test_fp32_predicates_route_the_decode():
    """The sites' predicates take an fp32 x as they take bf16; the hblock
    rule counts its 4-byte elements, so the fp32 decode's 128x96 level takes
    conv3x3 and its larger levels conv3x3_hblock, and an image of 25 MiB in
    bf16 takes conv3x3 but of 50 MiB in fp32 conv3x3_hblock."""
    k = torch.zeros(3, 3, 512, 512, dtype=torch.bfloat16)
    small = torch.zeros(1, 128, 96, 512)
    mid = torch.zeros(1, 128, 192, 512)
    big = torch.zeros(1, 256, 192, 512)
    assert cuda_conv.conv3x3_supported(small, k)
    assert cuda_conv.conv3x3_supported(mid.bfloat16(), k)
    for x in (mid, big):
        assert not cuda_conv.conv3x3_supported(x, k)
        assert cuda_conv.conv3x3_hblock_supported(x, k)


def test_predicates_accept_what_they_did():
    """The kernel's limits moved to 16-byte strides (Cin, Cout % 8); the
    sites' predicates keep their shape rule, so no site leaves the
    kernel."""
    x = torch.zeros(1, 8, 8, 160)
    assert cuda_conv.conv3x3_supported(x, torch.zeros(3, 3, 160, 136))
    assert not cuda_conv.conv3x3_supported(x, torch.zeros(3, 3, 160, 120))
    assert not cuda_conv.conv3x3_supported(torch.zeros(1, 8, 8, 144),
                                           torch.zeros(3, 3, 144, 128))


# ---------------------------------------------------------------------------
# the kernel's arithmetic in numpy
# ---------------------------------------------------------------------------


def _np(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _box(src, starts, sizes):
    """A TMA tiled box: src[start:start + size] on every axis, zeros where
    the box leaves the tensor (negative starts included)."""
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


def kernel_np(x, w, bias, plan, padded):
    """The kernel's loop in numpy: per tile, nine taps x 64-channel chunks
    of (BM, 64) A boxes times (64, BN) B boxes into one fp32 accumulator,
    bias added once, rows stored through the epilogue's mapping."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    wt = w.reshape(9, cin, cout)                          # (tap, Cin, Cout)
    if padded:
        xf = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))).reshape(-1, cin)
    out = np.zeros((b * h * wd, cout), np.float32)
    pix = tile_pixels(plan, b, h, wd, padded)
    kc = _cdiv(cin, BK)
    for t in range(plan.tiles):
        m, n0 = divmod(t, plan.n_tiles)
        n0 *= plan.bn
        acc = np.zeros((plan.bm, plan.bn), np.float32)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for c in range(kc):
                c0 = c * BK
                if padded:
                    bi, p0 = divmod(m, plan.tiles_per_image)
                    row = bi * (h + 2) * (wd + 2) + p0 * plan.bm \
                        + dy * (wd + 2) + dx
                    a = _box(xf, (row, c0), (plan.bm, BK))
                else:
                    tiles_x = _cdiv(wd, plan.tile_w)
                    tiles_y = _cdiv(h, plan.tile_h)
                    bi = m // (tiles_x * tiles_y)
                    y0 = (m // tiles_x) % tiles_y * plan.tile_h
                    x0 = m % tiles_x * plan.tile_w
                    a = _box(x, (bi, y0 + dy - 1, x0 + dx - 1, c0),
                             (1, plan.tile_h, plan.tile_w, BK))
                    a = a.reshape(plan.bm, BK)    # rows ht * tile_w + wt
                wb = _box(wt, (tap, c0, n0), (1, BK, plan.bn))[0]
                acc += a @ wb
        acc += _box(bias, (n0,), (plan.bn,))
        keep = pix[m] >= 0
        ncols = min(plan.bn, cout - n0)
        out[pix[m][keep], n0:n0 + ncols] = acc[keep, :ncols]
    return out.reshape(b, h, wd, cout)


NP_SHAPES = [
    ((2, 5, 13, 128, 128), None),          # one tile runs past each image
    ((1, 12, 16, 128, 160), None),         # two tiles an image
    ((1, 9, 10, 160, 136), (256, 128)),    # ragged K chunk, ragged N tile
    ((2, 7, 9, 192, 320), (128, 160)),
]


@pytest.mark.parametrize("shape,tile", NP_SHAPES)
def test_padded_rows_match_pallas_padacc(monkeypatch, shape, tile):
    b, h, wd, cin, cout = shape
    x = _np(1, b, h, wd, cin)
    w = _np(2, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bias = _np(3, cout)
    plan = conv_plan(*shape, padded=True, tile=tile)
    if plan.bm * plan.tiles_per_image > h * (wd + 2):
        assert (tile_pixels(plan, b, h, wd, True)[-1] < 0).any()
    got = kernel_np(x, w, bias, plan, padded=True)
    want = cuda_conv.conv3x3_torch(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if cin % 128 == 0 and cout >= 128:
        monkeypatch.setenv("IDMVTON_CONV_PADACC", "1")
        calls = []
        kern = pallas_conv._conv3_kernel_padacc
        monkeypatch.setattr(pallas_conv, "_conv3_kernel_padacc",
                            lambda *a, **k: calls.append(1) or kern(*a, **k))
        jx = pallas_conv.conv3x3(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias), rows_target=64)
        assert calls     # the JAX side ran the padacc kernel
        np.testing.assert_allclose(got, np.asarray(jx), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape,tile", NP_SHAPES)
def test_halo_boxes_match_conv3x3_torch(shape, tile):
    b, h, wd, cin, cout = shape
    x = _np(4, b, h, wd, cin)
    w = _np(5, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bias = _np(6, cout)
    got = kernel_np(x, w, bias, conv_plan(*shape, tile=tile), padded=False)
    want = cuda_conv.conv3x3_torch(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
