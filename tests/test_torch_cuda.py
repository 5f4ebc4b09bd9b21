"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at small shapes with every edge the serving path can hit (ragged row
and key tiles, GEGLU, uncond rows, sink tokens, both softmax paths; for the
opt-in variants: int8 codes at every C, short and chunked contexts, padded
rows at both ends of an image).

The captured denoise step (``pipeline/graph.py``): a replayed step equals
the eager one bit for bit at the tiny and at a full-width-slice UNet, a
flipped switch or new weights capture again, and a replayed request
launches what an eager one does and gives its images.

Marked ``cuda``: each test skips without a card. This file imports no JAX,
so it also runs on a host that has none:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``. The
full-width paths here keep their launches under their names
(``torch_card.record``) for ``chip_smoke.py``'s kernels line.

Tolerances: both sides take the same bf16 inputs and accumulate in fp32;
they differ in summation order and in where bf16 rounds (the plain
versions round some intermediates the kernels keep in fp32), so outputs
agree to a few bf16 ulps: max |kernel - plain| <= 2e-2 * max |plain|.
The W8A8 kernel and its plain version sum the same int8 products exactly;
they differ only where an fp32 LayerNorm rounding flips one code, far
inside the same bound.
The flash attention kernels (#4, #9, #10) cast the unnormalized
probabilities to bf16 for the PV product and their plain versions the
normalized ones: the same bf16 bound.
The GroupNorm statistics are fp32 sums in another order (deterministic,
no atomics): max error <= 1e-5 * max |sum of squares|.
The GroupNorm apply (#13) computes the plain version's fp32 operations in
its order with the same roundings (a separate multiply and add, rsqrtf,
expf, one rounding to x's type) but for the group means, which it adds in
another order: w and shift then differ by a few fp32 ulps, so each output
lies within one bf16 ulp of the plain one (none for an fp32 x) plus 16
fp32 ulps of |x w| + |mean w| + |bias| (the terms the rounded sum is made
of, where cancellation near zero would otherwise magnify the ulps).
The conv kernel on an fp32 x narrows x to bf16 and multiplies by the bf16
weights with fp32 accumulation (the TPU kernel's DEFAULT precision): against
the plain version in full fp32 (``torch.backends.cudnn.allow_tf32 = False``,
set here) it differs by x's bf16 rounding, within the bf16 bound; against
the plain version fed the bf16-rounded x it differs only in summation
order, max |diff| <= 1e-4 * max |plain| (K up to 9 * 2560 fp32 terms).
"""

import pytest
import torch

import torch_card
from idmvton_tpu_torch.ops import cuda_attention, cuda_conv, cuda_norm
from idmvton_tpu_torch.ops.quant import quantize_kernel_int8

pytestmark = pytest.mark.cuda
BF16_TOL = 2e-2
SUM_TOL = 1e-5


F32_TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, *shape, dev, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _rel_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def _ln_inputs(seed, lead, c, n, geglu, bias, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, *lead, c, dev=dev, scale=3.0) + 1.0
    gamma = _randn(g, c, dev=dev, dtype=torch.float32) * 0.2 + 1.0
    beta = _randn(g, c, dev=dev, dtype=torch.float32) * 0.1
    w = _randn(g, c, (2 if geglu else 1) * n, dev=dev, scale=c ** -0.5)
    b = (_randn(g, w.shape[1], dev=dev, dtype=torch.float32)
         if bias else None)
    if bias == "bf16":   # the sites' bf16 bias, widened by the kernel
        b = b.bfloat16()
    return x, gamma, beta, w, b


@pytest.mark.parametrize("m,c,n,geglu,bias", [
    (200, 128, 384, False, "fp32"), (64, 256, 128, True, "fp32"),
    (77, 640, 1920, False, None), (130, 1280, 256, True, None),
    # ragged output tiles (N off the 256-wide tile), a bf16 bias, C = 64
    (129, 640, 640, False, "bf16"), (300, 64, 136, True, "bf16"),
    (1, 384, 1280, True, "fp32")])
def test_ln_linear_kernel(dev, m, c, n, geglu, bias):
    x, gamma, beta, w, b = _ln_inputs(0, (2, m), c, n, geglu, bias, dev)
    before = cuda_norm.ln_linear.launches
    got = cuda_norm.ln_linear(x, gamma, beta, w, b, geglu=geglu)
    want = cuda_norm.ln_linear_torch(x, gamma, beta, w, b, geglu=geglu)
    torch.cuda.synchronize()
    assert got.shape == (2, m, n)
    assert cuda_norm.ln_linear.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


# every ln_linear shape of the path: TryonNet (B = 4) and GarmentNet (B =
# 2) at 768x1024 (to_qkv, to_q, GEGLU at the 640 and 1280 levels), the tiny
# UNet's 128-wide level, and ragged M (a 128-row block past the rows); a
# TP=2 rank's TryonNet (to_qkv, to_q and GEGLU at the 1280-wide level, GEGLU
# at the 640-wide one) and an SP=2 rank's rows (TryonNet's to_qkv, to_q and
# GEGLU, GarmentNet's to_q and GEGLU, at both levels)
LN_PATH = [((4, 3072), 640, 1920, False), ((4, 3072), 640, 640, False),
           ((4, 3072), 640, 2560, True), ((4, 768), 1280, 3840, False),
           ((4, 768), 1280, 1280, False), ((4, 768), 1280, 5120, True),
           ((2, 3072), 640, 640, False), ((2, 3072), 640, 2560, True),
           ((2, 768), 1280, 1280, False), ((2, 768), 1280, 5120, True),
           ((4, 768), 128, 384, False), ((4, 768), 128, 128, False),
           ((4, 768), 128, 512, True), ((2, 768), 128, 512, True),
           ((3, 1000), 640, 1920, False), ((1, 1500), 1280, 5120, True),
           ((4, 768), 1280, 1920, False), ((4, 768), 1280, 640, False),
           ((4, 768), 1280, 2560, True), ((4, 3072), 640, 1280, True),
           ((4, 1536), 640, 1920, False), ((4, 1536), 640, 640, False),
           ((4, 1536), 640, 2560, True), ((4, 384), 1280, 3840, False),
           ((4, 384), 1280, 1280, False), ((4, 384), 1280, 5120, True),
           ((2, 1536), 640, 640, False), ((2, 1536), 640, 2560, True),
           ((2, 384), 1280, 1280, False), ((2, 384), 1280, 5120, True)]


@pytest.mark.parametrize("bias", [None, "bf16"])
@pytest.mark.parametrize("lead,c,n,geglu", LN_PATH)
def test_ln_linear_path_shapes(dev, lead, c, n, geglu, bias):
    x, gamma, beta, w, b = _ln_inputs(12, lead, c, n, geglu, bias, dev)
    got = cuda_norm.ln_linear(x, gamma, beta, w, b, geglu=geglu)
    want = cuda_norm.ln_linear_torch(x, gamma, beta, w, b, geglu=geglu)
    torch.cuda.synchronize()
    assert got.shape == lead + (n,)
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("tile", cuda_norm.LN_TILES)
@pytest.mark.parametrize("geglu", [False, True])
def test_ln_linear_every_tile(dev, tile, geglu):
    """Each instance (BN x GEGLU), forced through the plan, at ragged rows
    and columns and a C of 11 chunks."""
    x, gamma, beta, w, b = _ln_inputs(13, (3, 111), 704, 392, geglu, "fp32",
                                      dev)
    got = cuda_norm.ln_linear(x, gamma, beta, w, b, geglu=geglu, tile=tile)
    want = cuda_norm.ln_linear_torch(x, gamma, beta, w, b, geglu=geglu)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("rows,c", [(3, 128), (1000, 640), (77, 1280),
                                    (6144, 640), (1536, 1280), (3072, 640),
                                    (768, 1280)])
def test_fused_layer_norm_kernel(dev, rows, c):
    g = torch.Generator(device=dev).manual_seed(1)
    x = _randn(g, rows, c, dev=dev, scale=2.0) - 0.5
    gamma = _randn(g, c, dev=dev, dtype=torch.float32)
    beta = _randn(g, c, dev=dev, dtype=torch.float32)
    got = cuda_norm.fused_layer_norm(x, gamma, beta)
    want = cuda_norm.layer_norm_torch(x, gamma, beta)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("shape,dtype", [
    ((2, 9, 13, 128), torch.bfloat16), ((3, 300, 320), torch.float32),
    ((1, 64, 48, 2560), torch.bfloat16), ((2, 5, 7, 10), torch.float32),
    # the path's: TryonNet's 320- and 2560-wide levels, the VAE encode's
    # largest input, an SP=2 rank's 64 of 128 rows
    ((4, 128, 96, 320), torch.bfloat16), ((4, 32, 24, 2560), torch.bfloat16),
    ((6, 1024, 768, 128), torch.bfloat16),
    ((4, 64, 96, 320), torch.bfloat16)])
def test_gn_stats_kernel(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    x = _randn(g, *shape, dev=dev, dtype=dtype) + 0.3
    s1, s2 = cuda_norm.gn_spatial_stats(x)
    r1, r2 = cuda_norm.gn_spatial_stats_torch(x)
    torch.cuda.synchronize()
    scale = float(r2.abs().max())
    assert float((s1 - r1).abs().max()) <= SUM_TOL * scale
    assert float((s2 - r2).abs().max()) <= SUM_TOL * scale


def _gn_apply_case(seed, shape, dtype, dev, groups=32):
    """x with a mean off zero, its channel means as group_sums gives them,
    and an fp32 affine near the identity."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c = shape[0], shape[-1]
    x = (_randn(g, *shape, dev=dev, dtype=torch.float32, scale=1.5)
         + 0.4).to(dtype)
    xf = x.float().reshape(b, -1, c)
    mean_c, mean2_c = xf.mean(1), xf.square().mean(1)
    del xf
    scale = _randn(g, c, dev=dev, dtype=torch.float32, scale=0.1) + 1.0
    bias = _randn(g, c, dev=dev, dtype=torch.float32, scale=0.1)
    return x, mean_c, mean2_c, scale, bias


def _assert_gn_apply_close(got, want, x, mean_c, mean2_c, scale, bias,
                           groups, eps):
    """Each output within one ulp of the plain output in x's type (bf16;
    none for fp32) plus 16 fp32 ulps of |x w| + |mean w| + |bias|, w and
    mean the plain version's (the module docstring)."""
    b, c = x.shape[0], x.shape[-1]
    gmean = mean_c.reshape(b, groups, -1).mean(-1)
    gmean2 = mean2_c.reshape(b, groups, -1).mean(-1)
    inv = torch.rsqrt((gmean2 - gmean.square()).clamp_min(0.0) + eps)
    w = inv.repeat_interleave(c // groups, dim=-1) * scale
    mw = gmean.repeat_interleave(c // groups, dim=-1) * w
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    bound = x.float().abs_().mul_(w.abs().reshape(shape))
    bound.add_((mw.abs() + bias.abs()).reshape(shape)).mul_(16 * 2.0 ** -24)
    wf = want.float()
    if x.dtype == torch.bfloat16:
        _, e = torch.frexp(wf)
        bound.add_(torch.ldexp(torch.ones_like(wf), e - 8) * (wf != 0))
    diff = (got.float() - wf).abs_()
    assert torch.isfinite(got).all()
    worst = float((diff - bound).max())
    assert worst <= 0, (worst, float(diff.max()))


# the UNets' GroupNorm widths at their three levels (TryonNet B = 4,
# GarmentNet B = 2); the VAE encode's and decode's largest bf16 inputs and
# the fp32 decode's 1024x768 level; an SP=2 rank's rows (its means are the
# whole image's); the narrow-vector edges (C not a multiple of 8 or 4), a
# partial 128-channel column, one channel a group, a (B, S, C) input
GN_APPLY_UNET = [(b, h, w, c) for b in (4, 2)
                 for h, w in ((128, 96), (64, 48), (32, 24))
                 for c in (320, 640, 960, 1280, 1920, 2560)]
GN_APPLY_OTHER = [((6, 1024, 768, 128), torch.bfloat16, 32),
                  ((2, 512, 384, 512), torch.bfloat16, 32),
                  ((2, 1024, 768, 128), torch.float32, 32),
                  ((2, 9, 13, 42), torch.bfloat16, 7),
                  ((3, 300, 42), torch.float32, 6),
                  ((2, 5, 7, 40), torch.float32, 8),
                  ((2, 77, 96), torch.bfloat16, 32),
                  ((1, 64, 48, 2560), torch.bfloat16, 2560)]


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", GN_APPLY_UNET)
def test_gn_apply_kernel_unet_shapes(dev, shape, silu):
    x, m1, m2, sc, bi = _gn_apply_case(23, shape, torch.bfloat16, dev)
    before = cuda_norm.gn_apply.launches
    got = cuda_norm.gn_apply(x, m1, m2, sc, bi, num_groups=32, silu=silu)
    want = cuda_norm.gn_apply_torch(x, m1, m2, sc, bi, num_groups=32,
                                    silu=silu)
    torch.cuda.synchronize()
    assert cuda_norm.gn_apply.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    _assert_gn_apply_close(got, want, x, m1, m2, sc, bi, 32, 1e-5)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,dtype,groups", GN_APPLY_OTHER)
def test_gn_apply_kernel_other_shapes(dev, shape, dtype, groups, silu):
    x, m1, m2, sc, bi = _gn_apply_case(24, shape, dtype, dev, groups)
    got = cuda_norm.gn_apply(x, m1, m2, sc, bi, num_groups=groups, eps=1e-6,
                             silu=silu)
    want = cuda_norm.gn_apply_torch(x, m1, m2, sc, bi, num_groups=groups,
                                    eps=1e-6, silu=silu)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    _assert_gn_apply_close(got, want, x, m1, m2, sc, bi, groups, 1e-6)


def test_gn_apply_kernel_sp_rank_rows(dev):
    """An SP=2 rank's 64 of 128 rows with the whole image's means (what
    group_sums returns after adding every rank's sums)."""
    x, m1, m2, sc, bi = _gn_apply_case(25, (4, 128, 96, 320),
                                       torch.bfloat16, dev)
    rows = x[:, :64].contiguous()
    got = cuda_norm.gn_apply(rows, m1, m2, sc, bi, num_groups=32, silu=True)
    want = cuda_norm.gn_apply_torch(rows, m1, m2, sc, bi, num_groups=32,
                                    silu=True)
    torch.cuda.synchronize()
    _assert_gn_apply_close(got, want, rows, m1, m2, sc, bi, 32, 1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout,bias", [
    (2, 10, 12, 128, 256, True), (1, 16, 8, 320, 320, True),
    (3, 7, 9, 256, 128, False), (2, 32, 24, 640, 1280, True),
    # the wgmma kernel's edges: Cout 320 (160-wide N tiles), 15 and 40
    # 64-channel chunks a tap, the 32x24 level at batch 4, H and W off the
    # 16 x 8 tile, a ragged last K chunk (Cin 160)
    (1, 16, 24, 320, 320, True), (1, 16, 24, 960, 320, True),
    (1, 8, 24, 2560, 1280, True), (4, 32, 24, 1280, 1280, True),
    (2, 19, 27, 320, 640, True), (1, 12, 16, 160, 128, False),
    # the path's: TryonNet's 320- and 640-wide levels and the 960 -> 320 skip
    # conv, an SP=2 rank's rows with their two halo rows, the VAE's
    # 1024x768 and 512x384 levels (the hblock sites)
    (4, 128, 96, 320, 320, True), (4, 64, 48, 640, 640, True),
    (4, 128, 96, 960, 320, True), (4, 66, 96, 320, 320, True),
    (4, 18, 24, 1280, 1280, True), (6, 1024, 768, 128, 128, True),
    (2, 512, 384, 512, 256, True)])
def test_conv3x3_kernel(dev, b, h, w, cin, cout, bias):
    g = torch.Generator(device=dev).manual_seed(3)
    x = _randn(g, b, h, w, cin, dev=dev)
    k = _randn(g, 3, 3, cin, cout, dev=dev, scale=(9 * cin) ** -0.5)
    bb = _randn(g, cout, dev=dev) if bias else None
    counts = (cuda_conv.conv3x3.launches, cuda_conv.conv3x3_hblock.launches)
    got = cuda_conv.conv3x3(x, k, bb)
    got_h = cuda_conv.conv3x3_hblock(x, k, bb)
    want = cuda_conv.conv3x3_torch(x, k, bb)
    torch.cuda.synchronize()
    assert (cuda_conv.conv3x3.launches, cuda_conv.conv3x3_hblock.launches) \
        == (counts[0] + 1, counts[1] + 1)
    assert torch.equal(got, got_h)
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 10, 12, 128, 256), (1, 16, 24, 320, 320), (1, 12, 16, 160, 128),
    (2, 32, 24, 512, 512), (1, 19, 27, 256, 136),
    # the fp32 decode's shapes (batch 1, cut in H and W): conv_in 4 ->
    # (not a kernel site), the 128x96 .. 1024x768 levels' channel pairs
    (1, 16, 24, 512, 512), (1, 32, 48, 512, 256), (1, 64, 96, 256, 128),
    (1, 64, 96, 128, 128)])
def test_conv3x3_kernel_fp32(dev, b, h, w, cin, cout):
    """An fp32 x through both conv wrappers (and the padded-row variant):
    fp32 out, against the fp32 plain version and, tightly, against the plain
    version fed the bf16-rounded x."""
    g = torch.Generator(device=dev).manual_seed(14)
    x = _randn(g, b, h, w, cin, dev=dev, dtype=torch.float32)
    k = _randn(g, 3, 3, cin, cout, dev=dev, scale=(9 * cin) ** -0.5)
    bb = _randn(g, cout, dev=dev)
    before = (cuda_conv.conv3x3.launches, cuda_conv.conv3x3_hblock.launches)
    got = cuda_conv.conv3x3(x, k, bb)
    got_h = cuda_conv.conv3x3_hblock(x, k, bb)
    got_p = cuda_conv.conv3x3_padacc(x, k, bb)
    want = cuda_conv.conv3x3_torch(x, k, bb)
    want_r = cuda_conv.conv3x3_torch(x.bfloat16().float(), k, bb)
    torch.cuda.synchronize()
    assert (cuda_conv.conv3x3.launches, cuda_conv.conv3x3_hblock.launches) \
        == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, cout)
    assert torch.equal(got, got_h)
    assert _rel_err(got, want) <= BF16_TOL
    assert _rel_err(got, want_r) <= F32_TOL
    assert _rel_err(got_p, want_r) <= F32_TOL


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_vae_decode_fp32_runs_the_conv_kernels(dev, size):
    """VAEConfig.force_upcast: the decode runs in fp32 through the conv and
    GroupNorm statistics kernels at every site the bf16 decode of the same
    latent runs them (the fp32 activations' size moves sites between
    conv3x3 and conv3x3_hblock), against the plain decode of the same
    module on the CPU (each conv rounds its input to bf16: the bf16 bound);
    the tiny VAE and the full one on a 768x1024 request's latents."""
    import copy
    import dataclasses
    from idmvton_tpu_torch.core.config import VAEConfig
    from idmvton_tpu_torch.models.layers import reset_parameters_
    from idmvton_tpu_torch.models.vae import VAE
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    base = VAEConfig.tiny() if size == "tiny" else VAEConfig()
    cfg = dataclasses.replace(base, force_upcast=True)
    vae = VAE(cfg, dtype=torch.bfloat16, device=dev)
    reset_parameters_(vae, torch.Generator(device=dev).manual_seed(15))
    g = torch.Generator(device=dev).manual_seed(16)
    lh, lw = (32, 24) if size == "tiny" else (128, 96)
    z = _randn(g, 2, lh, lw, cfg.latent_channels, dev=dev)
    counters = launch_counters()
    launched = {}
    for upcast in (False, True):
        vae.cfg = dataclasses.replace(cfg, force_upcast=upcast)
        before = {k: f.launches for k, f in counters.items()}
        got = vae.decode(z)
        torch.cuda.synchronize()
        launched[upcast] = {k: f.launches - before[k]
                            for k, f in counters.items()
                            if f.launches != before[k]}
    counts, bf16 = launched[True], launched[False]
    assert set(counts) <= {"conv3x3", "conv3x3_hblock", "gn_spatial_stats",
                           "gn_apply"}, counts
    assert counts["conv3x3"] > 0 and counts["gn_spatial_stats"] > 0
    assert counts["gn_apply"] == counts["gn_spatial_stats"] \
        == bf16["gn_spatial_stats"]
    convs = lambda c: c.get("conv3x3", 0) + c.get("conv3x3_hblock", 0)
    assert convs(counts) == convs(bf16), (counts, bf16)
    if size == "full":
        torch_card.record("decode_fp32", counts)
    want = copy.deepcopy(vae).cpu().decode(z.cpu())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got.cpu(), want) <= BF16_TOL


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("garment,uncond,sink,fixed", [
    (False, 0, 0, True), (True, 0, 0, True), (True, 2, 0, True),
    (True, 2, 3, False), (False, 0, 5, False), (True, 1, 0, False)])
def test_flash_attention_gemm_kernel(dev, d, garment, uncond, sink, fixed):
    g = torch.Generator(device=dev).manual_seed(4)
    b, n, m, heads = 4, 200, 150, 256 // d
    qkv = _randn(g, b, n, 3 * heads * d, dev=dev, scale=1.5)
    kv = _randn(g, b - uncond, m, 2 * heads * d, dev=dev, scale=1.5) \
        if garment else None
    got = cuda_attention.flash_attention_gemm(
        qkv, kv, heads=heads, sink_tokens=sink, uncond_rows=uncond,
        fixed_shift=fixed)
    want = cuda_attention.flash_attention_gemm_torch(
        qkv, kv, heads=heads, sink_tokens=sink, uncond_rows=uncond)
    torch.cuda.synchronize()
    assert got.shape == (b, n, heads * d)
    assert _rel_err(got, want) <= BF16_TOL


# flash_attention_gemm's four path shapes at full width (TryonNet and
# GarmentNet at the 640 and 1280 levels), every row uncond, the tiny
# UNet's 128-wide level (8 heads of 16) and a TP=2 rank's TryonNet at the
# 1280-wide level (10 heads)
@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("b,n,heads,d,garment,uncond", [
    (4, 3072, 10, 64, True, 2), (4, 768, 20, 64, True, 2),
    (2, 3072, 10, 64, False, 0), (2, 768, 20, 64, False, 0),
    (4, 768, 20, 64, True, 4), (4, 768, 8, 16, True, 2),
    (4, 768, 10, 64, True, 2)])
def test_flash_attention_gemm_path_shapes(dev, b, n, heads, d, garment,
                                          uncond, fixed):
    g = torch.Generator(device=dev).manual_seed(9)
    hd = heads * d
    qkv = _randn(g, b, n, 3 * hd, dev=dev)
    kv = _randn(g, b - uncond, n, 2 * hd, dev=dev) if garment else None
    before = cuda_attention.flash_attention_gemm.launches
    got = cuda_attention.flash_attention_gemm(qkv, kv, heads=heads,
                                              uncond_rows=uncond,
                                              fixed_shift=fixed)
    want = cuda_attention.flash_attention_gemm_torch(qkv, kv, heads=heads,
                                                     uncond_rows=uncond)
    torch.cuda.synchronize()
    assert got.shape == (b, n, hd)
    assert cuda_attention.flash_attention_gemm.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


def test_fixed_shift_switch_reaches_the_kernel(dev, monkeypatch):
    """IDMVTON_FLASH_FIXED_SHIFT and the calibration's force-off reach the
    kernel: on logits far past the clamp (60) the online mode matches the
    exact softmax and the fixed shift its own plain formula; the
    SelfAttention site passes the mode as it stands at each call."""
    from idmvton_tpu_torch.models import attention as tmod
    from idmvton_tpu_torch.models.attention import SelfAttention
    from idmvton_tpu_torch.models.layers import reset_parameters_
    g = torch.Generator(device=dev).manual_seed(17)
    n, d = 256, 128
    rows = 1.0 + torch.arange(n, device=dev) / n
    base = torch.full((1, n, d), 4.0, device=dev)
    qkv = torch.cat([base, base * rows[None, :, None],
                     _randn(g, 1, n, d, dev=dev, dtype=torch.float32)],
                    -1).bfloat16()
    exact = cuda_attention.flash_attention_gemm_torch(qkv, heads=1)
    fixed = cuda_attention.flash_attention_gemm_torch(qkv, heads=1,
                                                      fixed_shift=True)
    assert _rel_err(fixed, exact) > 0.1
    monkeypatch.setattr(cuda_attention, "_FIXED_SHIFT_FORCED_OFF", False)
    for env, want in (("0", exact), ("1", fixed)):
        monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", env)
        got = cuda_attention._gemm_attention(qkv, None, heads=1)
        assert _rel_err(got, want) <= BF16_TOL
    rep = cuda_attention.calibrate_fixed_shift(qkv, heads=1)
    assert not rep["fixed_shift"] and not cuda_attention.fixed_shift_enabled()
    got = cuda_attention._gemm_attention(qkv, None, heads=1)
    assert _rel_err(got, exact) <= BF16_TOL

    seen = []
    real = tmod.flash_attention_gemm
    monkeypatch.setattr(tmod, "flash_attention_gemm", lambda *a, **kw: (
        seen.append(kw["fixed_shift"]) or real(*a, **kw)))
    mod = SelfAttention(128, heads=2, head_dim=64, dtype=torch.bfloat16,
                        device=dev)
    reset_parameters_(mod, torch.Generator(device=dev).manual_seed(18))
    x = _randn(g, 2, 300, 128, dev=dev)
    mod(x)                                   # forced off by the calibration
    monkeypatch.setattr(cuda_attention, "_FIXED_SHIFT_FORCED_OFF", False)
    mod(x)                                   # env "1"
    monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "0")
    mod(x)
    torch.cuda.synchronize()
    assert seen == [False, True, False]


@pytest.mark.parametrize("d,tile", [
    (dp, (bkv, wgs)) for dp, bkv, wgs in sorted(cuda_attention.INSTANCES)])
def test_attention_kernel_every_tile(dev, d, tile):
    """Each instance the kernel is built for (every padded head dim with
    its BKV and 2 or 3 consumer warpgroups), forced through the plan, at
    ragged query and key tiles, both layouts and both softmax modes."""
    g = torch.Generator(device=dev).manual_seed(10)
    b, n, m, heads = 3, 200, 130, 4
    qkv = _randn(g, b, n, 3 * heads * d, dev=dev, scale=1.5)
    kv = _randn(g, b - 1, m, 2 * heads * d, dev=dev, scale=1.5)
    want = cuda_attention.flash_attention_gemm_torch(qkv, kv, heads=heads,
                                                     uncond_rows=1)
    for fixed in (True, False):
        got = cuda_attention._gemm_launch(qkv, kv, heads, None, 0, 1, fixed,
                                          tile)
        assert _rel_err(got, want) <= BF16_TOL
    q, k, v = (qkv[..., i * heads * d:(i + 1) * heads * d].reshape(
        b, n, heads, d) for i in range(3))
    got = cuda_attention._flash_launch(q, k, v, d ** -0.5, tile)
    want = cuda_attention.flash_attention_torch(q, k, v)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("scale", [None, -0.2])
@pytest.mark.parametrize("b,sq,heads,d,m", [
    (4, 3072, 4, 16, 3072), (2, 3072, 4, 16, 0), (4, 3072, 10, 64, 3072),
    (4, 3072, 5, 64, 3072)])
def test_flash_attention_tiny_path_shapes(dev, b, sq, heads, d, m, scale):
    """The tiny UNet's 64-wide level, and TryonNet's 640-wide level at SDXL
    width and on a TP=2 rank (5 heads): the split heads of a to_qkv output
    over own then garment keys (flash_attention_concat_kv) and over their
    own (self-attention), sliced from a longer buffer (a batch stride that
    is not S * row stride); a negative scale takes the kernel's generic
    row max."""
    g = torch.Generator(device=dev).manual_seed(11)
    hd = heads * d
    buf = _randn(g, b, 2 * sq, 3 * hd, dev=dev)
    qkv = buf[:, :sq]
    assert qkv.stride(0) != sq * qkv.stride(1)
    q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(b, sq, heads, d)
               for i in range(3))
    before = cuda_attention.flash_attention.launches
    if m:   # the garment K/V read as the kernel's second key segment
        kg, vg = (_randn(g, b, m, heads, d, dev=dev) for _ in range(2))
        got = cuda_attention.flash_attention_concat_kv(q, k, v, kg, vg,
                                                       scale=scale)
        want = cuda_attention.flash_attention_concat_kv_torch(
            q, k, v, kg, vg, scale=scale)
    else:
        got = cuda_attention.flash_attention(q, k, v, scale=scale)
        want = cuda_attention.flash_attention_torch(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert cuda_attention.flash_attention.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("m,c,n,geglu,bias", [
    (200, 128, 128, False, False), (77, 256, 128, True, False),
    (130, 640, 128, True, True), (65, 1280, 128, False, True),
    (3, 1280, 256, True, False),
    # M off the 128-row tile, C = 128 (one K chunk), GEGLU at both path
    # widths, an fp32 bias
    (300, 128, 384, False, "fp32"), (129, 1280, 1280, False, True),
    (257, 640, 2560, True, True), (131, 1280, 5120, True, "fp32"),
    (12, 640, 1920, False, False),
    # the variant path's rows: TryonNet's to_qkv and GEGLU at both levels
    # (B = 4), GarmentNet's GEGLU (B = 2)
    (6144, 640, 1920, False, False), (1536, 1280, 3840, False, False),
    (6144, 640, 2560, True, True), (1536, 1280, 5120, True, True),
    (3072, 640, 2560, True, True), (768, 1280, 5120, True, True)])
def test_ln_linear_i8_kernel(dev, m, c, n, geglu, bias):
    from idmvton_tpu_torch.models.attention import _ln_proj
    from idmvton_tpu_torch.models.layers import (
        Linear, Norm, quantize_linear_int8,
    )
    g = torch.Generator(device=dev).manual_seed(5)
    x = _randn(g, 2, m, c, dev=dev, scale=3.0) + 1.0
    gamma = _randn(g, c, dev=dev, dtype=torch.float32) * 0.2 + 1.0
    beta = _randn(g, c, dev=dev, dtype=torch.float32) * 0.1
    lin = Linear(c, (2 if geglu else 1) * n, bias=bool(bias),
                 dtype=torch.bfloat16, device=dev)
    lin.kernel.copy_(_randn(g, *lin.kernel.shape, dev=dev, scale=c ** -0.5))
    if bias:
        lin.bias.copy_(_randn(g, *lin.bias.shape, dev=dev))
    q = quantize_linear_int8(lin)
    assert q.kernel_i8.t().is_contiguous()    # the kernel's K-major W
    norm = Norm(c, device=dev)
    norm.scale.copy_(gamma)
    norm.bias.copy_(beta)
    # the sites pass the module's bf16 bias; an fp32 one is widened alike
    b = q.bias.float() if bias == "fp32" else q.bias
    before = cuda_norm.ln_linear_i8.launches
    got = cuda_norm.ln_linear_i8(x, gamma, beta, q.kernel_i8, q.kernel_scale,
                                 b, geglu=geglu)
    # a fused LN site dispatches the int8 projection to the same kernel
    got2 = _ln_proj(x, norm, q, geglu=geglu, impl="cuda")
    want = cuda_norm.ln_linear_i8_torch(x, gamma, beta, q.kernel_i8,
                                        q.kernel_scale, q.bias, geglu=geglu)
    torch.cuda.synchronize()
    assert got.shape == (2, m, n)
    assert cuda_norm.ln_linear_i8.launches == before + 2
    assert torch.equal(got, got2)
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("tile", cuda_norm.I8_TILES)
@pytest.mark.parametrize("geglu", [False, True])
@pytest.mark.parametrize("c,n", [(640, 320), (192, 200)])
def test_ln_linear_i8_every_tile(dev, tile, geglu, c, n):
    """Each BN instance (forced through the plan) at ragged shapes: column
    tiles past N, C % 128 == 64 (a half-filled last K chunk)."""
    g = torch.Generator(device=dev).manual_seed(15)
    m = 333
    x = _randn(g, m, c, dev=dev, scale=2.0)
    gamma = _randn(g, c, dev=dev, dtype=torch.float32) * 0.2 + 1.0
    beta = _randn(g, c, dev=dev, dtype=torch.float32) * 0.1
    w_i8, w_scale = quantize_kernel_int8(
        _randn(g, c, (2 if geglu else 1) * n, dev=dev, scale=c ** -0.5))
    b = _randn(g, w_i8.shape[1], dev=dev)
    got = cuda_norm.ln_linear_i8(x, gamma, beta, w_i8, w_scale, b,
                                 geglu=geglu, tile=tile)
    want = cuda_norm.ln_linear_i8_torch(x, gamma, beta, w_i8, w_scale, b,
                                        geglu=geglu)
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("m,c", [(3, 128), (200, 640), (129, 1280),
                                 (4 * 768, 1280), (77, 2048), (50, 192)])
def test_ln_quant_i8_codes_equal_plain(dev, m, c):
    """The kernel's quantization pre-pass against the plain version's codes
    and row scales, exactly. The two sum a row's statistics in different
    orders; x on a grid of small integers makes every order exact, so the
    rest of the arithmetic -- the means, the variance, rsqrt, the
    normalization, the absmax, rs and 1/rs, the rounding -- must agree bit
    for bit. On Gaussian x the codes are compared by count: an fp32
    statistics rounding may move a code by one, rarely."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randint(-12, 13, (m, c), generator=g, device=dev).bfloat16()
    gamma = _randn(g, c, dev=dev, dtype=torch.float32) * 0.2 + 1.0
    beta = _randn(g, c, dev=dev, dtype=torch.float32) * 0.1
    codes, rs = cuda_norm.ln_quant_i8(x, gamma, beta)
    want_q, want_rs = cuda_norm.ln_quant_i8_torch(x, gamma, beta)
    assert codes.dtype == torch.int8 and codes.shape == (m, c)
    assert torch.equal(codes.float(), want_q)
    assert torch.equal(rs, want_rs.reshape(m))
    xg = _randn(g, m, c, dev=dev, scale=2.0) + 0.5
    codes, rs = cuda_norm.ln_quant_i8(xg, gamma, beta)
    want_q, want_rs = cuda_norm.ln_quant_i8_torch(xg, gamma, beta)
    diff = (codes.float() - want_q).abs()
    assert float(diff.max()) <= 1 and float(diff.mean()) <= 1e-3
    assert _rel_err(rs, want_rs.reshape(m)) <= 1e-5


def test_ln_linear_i8_refuses_other_weight_layouts(dev):
    """The kernel reads W K-major: a (C, N) kernel_i8 must be the view of
    (N, C) storage; a row-major one is refused, not copied."""
    x = torch.zeros(4, 128, dtype=torch.bfloat16, device=dev)
    g = torch.ones(128, device=dev)
    w_i8 = torch.zeros(128, 256, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="storage"):
        cuda_norm.ln_linear_i8(x, g, g, w_i8, torch.ones(256, device=dev))
    cuda_norm.ln_linear_i8(x, g, g, w_i8.t().contiguous().t(),
                           torch.ones(256, device=dev))


def test_quant_layout_survives_module_to_cuda(dev):
    """QuantLinear's (N, C) storage survives Module.to onto the card."""
    from idmvton_tpu_torch.models.layers import Linear, quantize_linear_int8
    lin = Linear(128, 384, dtype=torch.bfloat16, device="cpu")
    lin.kernel.copy_(torch.randn(128, 384))
    q = quantize_linear_int8(lin).to(dev)
    assert q.kernel_i8.is_cuda and q.kernel_i8.shape == (128, 384)
    assert q.kernel_i8.t().is_contiguous()


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s_text,s_ip", [(77, 16), (8, 0), (300, 90),
                                         (1024, 16), (80, 17), (81, 1)])
def test_cross_attention_small_kv_kernel(dev, d, s_text, s_ip):
    """Every head dim, one-chunk and multi-chunk contexts of both branches
    (80 text / 16 IP key rows a chunk), no IP branch, 200 queries (a
    ragged 128-row tile)."""
    g = torch.Generator(device=dev).manual_seed(6)
    b, n, heads = 2, 200, 256 // d
    q = _randn(g, b, n, heads * d, dev=dev, scale=2.0)
    kv = _randn(g, b, s_text, 2 * heads * d, dev=dev, scale=2.0)
    kv_ip = _randn(g, b, s_ip, 2 * heads * d, dev=dev, scale=2.0) \
        if s_ip else None
    before = cuda_attention.cross_attention_small_kv.launches
    got = cuda_attention.cross_attention_small_kv(q, kv, kv_ip, heads=heads,
                                                  ip_scale=0.7)
    want = cuda_attention.cross_attention_small_kv_torch(
        q, kv, kv_ip, heads=heads, ip_scale=0.7)
    torch.cuda.synchronize()
    assert got.shape == (b, n, heads * d)
    assert cuda_attention.cross_attention_small_kv.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("b,n,heads,ip", [(4, 3072, 10, True),
                                          (4, 768, 20, True),
                                          (2, 3072, 10, False),
                                          (2, 768, 20, False)])
def test_cross_attention_small_kv_path_shapes(dev, b, n, heads, ip):
    """The variant path's shapes: 77 text + 16 IP tokens (TryonNet), 77
    text (GarmentNet), 64-wide heads; more blocks' tiles than SMs, so the
    persistent blocks cross head groups."""
    g = torch.Generator(device=dev).manual_seed(9)
    hd = heads * 64
    q = _randn(g, b, n, hd, dev=dev)
    kv = _randn(g, b, 77, 2 * hd, dev=dev)
    kv_ip = _randn(g, b, 16, 2 * hd, dev=dev) if ip else None
    got = cuda_attention.cross_attention_small_kv(q, kv, kv_ip, heads=heads)
    want = cuda_attention.cross_attention_small_kv_torch(q, kv, kv_ip,
                                                         heads=heads)
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("b,h,w,cin,cout,bias", [
    (1, 16, 24, 128, 256, True), (1, 9, 96, 320, 640, False),
    (2, 7, 24, 1280, 320, True), (1, 5, 96, 640, 128, True),
    (3, 12, 10, 256, 200, False),
    # the wgmma kernel's edges: Cin 960 and 2560, the 32x24 level at batch
    # 4, an image whose last 128-position tile runs past it (9 * 15 = 135),
    # a ragged last K chunk (Cin 160)
    (1, 16, 24, 960, 320, True), (2, 9, 13, 2560, 256, True),
    (4, 32, 24, 1280, 1280, True), (1, 12, 16, 160, 128, False),
    # the variant path's: TryonNet's 320- and 640-wide levels, the 960 ->
    # 320 skip conv, the VAE's 128x96 level
    (4, 128, 96, 320, 320, True), (4, 64, 48, 640, 640, True),
    (4, 128, 96, 960, 320, True), (6, 128, 96, 512, 512, True)])
def test_conv3x3_padacc_kernel(dev, b, h, w, cin, cout, bias):
    g = torch.Generator(device=dev).manual_seed(7)
    x = _randn(g, b, h, w, cin, dev=dev)
    k = _randn(g, 3, 3, cin, cout, dev=dev, scale=(9 * cin) ** -0.5)
    bb = _randn(g, cout, dev=dev) if bias else None
    before = cuda_conv.conv3x3_padacc.launches
    got = cuda_conv.conv3x3_padacc(x, k, bb)
    want = cuda_conv.conv3x3_torch(x, k, bb)
    torch.cuda.synchronize()
    assert got.shape == (b, h, w, cout)
    assert cuda_conv.conv3x3_padacc.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("d", [8, 16, 24, 64, 72, 128])
@pytest.mark.parametrize("sq,skv", [(300, 384), (64, 257), (1, 1000),
                                    (130, 6144)])
def test_flash_attention_kernel(dev, d, sq, skv):
    """Dense (B, S, H, D) heads and the split-heads views of a fused to_qkv
    output (row stride 3*H*D), ragged query and key tiles."""
    g = torch.Generator(device=dev).manual_seed(6)
    b, h = 2, 3
    q = _randn(g, b, sq, h, d, dev=dev, scale=2.0)
    qkv = _randn(g, b, skv, 3 * h * d, dev=dev)
    k = qkv[..., h * d:2 * h * d].reshape(b, skv, h, d)
    v = qkv[..., 2 * h * d:].reshape(b, skv, h, d)
    before = cuda_attention.flash_attention.launches
    got = cuda_attention.flash_attention(q, k, v)
    want = cuda_attention.flash_attention_torch(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (b, sq, h, d)
    assert cuda_attention.flash_attention.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("b,heads", [(2, 4), (4, 4), (4, 10)])
@pytest.mark.parametrize("d", [8, 16, 64, 128])
@pytest.mark.parametrize("st,s_own", [(384, 300), (6144, 3072), (70, 70)])
def test_flash_attention_fused_qkv_kernel(dev, d, st, s_own, b, heads):
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = _randn(g, b, st, 3, heads, d, dev=dev, scale=1.5)
    before = cuda_attention.flash_attention_fused_qkv.launches
    got = cuda_attention.flash_attention_fused_qkv(qkv, s_own, scale=0.3)
    want = cuda_attention.flash_attention_fused_qkv_torch(qkv, s_own,
                                                          scale=0.3)
    torch.cuda.synchronize()
    assert got.shape == (b, s_own, heads, d)
    assert cuda_attention.flash_attention_fused_qkv.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


# an SP=2 rank's SelfAttention (parallel/sp.py): its nq local queries, a
# view of its to_qkv output, over the n own keys and values gathered from
# every rank (contiguous (B, n, H, D)) and, for TryonNet (``uncond``
# given), the gathered garment K/V as the model passes it: a view of the
# (B, n, 2*H*D) garment GEMM output whose leading ``uncond`` rows are zeros
@pytest.mark.parametrize("b,nq,n,heads,uncond", [
    (4, 1536, 3072, 10, 2), (4, 384, 768, 20, 2), (2, 1536, 3072, 10, None),
    (2, 384, 768, 20, None)])
def test_flash_attention_sp_rank_shapes(dev, b, nq, n, heads, uncond):
    g = torch.Generator(device=dev).manual_seed(12)
    d = 64
    hd = heads * d
    q = _randn(g, b, nq, 3 * hd, dev=dev)[..., :hd].reshape(b, nq, heads, d)
    k, v = (_randn(g, b, n, heads, d, dev=dev) for _ in range(2))
    before = cuda_attention.flash_attention.launches
    if uncond is None:
        got = cuda_attention.flash_attention(q, k, v)
        want = cuda_attention.flash_attention_torch(q, k, v)
    else:
        kvg = torch.cat([torch.zeros(uncond, n, 2 * hd, device=dev,
                                     dtype=torch.bfloat16),
                         _randn(g, b - uncond, n, 2 * hd, dev=dev)])
        kg = kvg[..., :hd].reshape(b, n, heads, d)
        vg = kvg[..., hd:].reshape(b, n, heads, d)
        got = cuda_attention.flash_attention_concat_kv(q, k, v, kg, vg)
        want = cuda_attention.flash_attention_concat_kv_torch(q, k, v, kg, vg)
    torch.cuda.synchronize()
    assert got.shape == (b, nq, heads, d)
    assert cuda_attention.flash_attention.launches == before + 1
    assert _rel_err(got, want) <= BF16_TOL


def test_flash_attention_below_the_cutoff_is_plain(dev):
    """Up to 256 keys flash_attention computes the plain formula, as the
    JAX function routes such shapes to XLA, and launches nothing."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (_randn(g, 2, s, 2, 16, dev=dev) for s in (300, 256, 256))
    before = cuda_attention.flash_attention.launches
    got = cuda_attention.flash_attention(q, k, v)
    assert cuda_attention.flash_attention.launches == before
    assert torch.equal(got, cuda_attention.flash_attention_torch(q, k, v))


def test_kernels_refuse_other_types(dev):
    """The sites' predicates are shape conditions only, so a CUDA tensor of
    a type the kernel does not take reaches the wrapper, which raises (no
    silent plain path on the card)."""
    x = torch.zeros(2, 64, 128, device=dev)
    g = torch.ones(128, device=dev)
    w = torch.zeros(128, 128, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_norm.fused_layer_norm(x, g, g)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_norm.ln_linear(x, g, g, w)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_conv.conv3x3(x.reshape(2, 8, 8, 128),
                          torch.zeros(3, 3, 128, 128, device=dev))
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_attention.flash_attention_gemm(
            torch.zeros(2, 16, 384, device=dev), heads=2)
    with pytest.raises(ValueError, match="float32"):
        cuda_norm.gn_spatial_stats(x.half())
    m = torch.zeros(2, 128, device=dev)
    with pytest.raises(ValueError, match="float32"):
        cuda_norm.gn_apply(x.half(), m, m, g, g, num_groups=32)
    with pytest.raises(ValueError, match="float32"):
        cuda_norm.gn_apply(x, m, m, g.half(), g, num_groups=32)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_norm.gn_apply(x, m, m, g, g, num_groups=48)
    with pytest.raises(ValueError, match="int8"):
        cuda_norm.ln_linear_i8(x.bfloat16(), g, g, w.bfloat16(), g)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_attention.cross_attention_small_kv(
            torch.zeros(2, 16, 128, device=dev),
            torch.zeros(2, 77, 256, device=dev), heads=2)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_conv.conv3x3_padacc(x.reshape(2, 8, 8, 128),
                                 torch.zeros(3, 3, 128, 128, device=dev))
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_attention.flash_attention(*(torch.zeros(1, 300, 2, 16,
                                                     device=dev),) * 3)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_attention.flash_attention_fused_qkv(
            torch.zeros(1, 300, 3, 2, 16, device=dev), 100)


# ---------------------------------------------------------------------------
# the captured denoise step (pipeline/graph.py)
# ---------------------------------------------------------------------------

# SDXL's UNet widths, head dim and norm groups at one layer a block and one
# transformer a level: every kernel site of the full-width step at shapes
# of its width (the conv, attention and ln_linear kernels at 320 / 640 /
# 1280 channels), small enough for a test
FULL_WIDTH_SLICE = dict(block_out_channels=(320, 640, 1280),
                        attention_head_dim=64, transformer_depth=(0, 1, 1),
                        layers_per_block=1, norm_num_groups=32)


def _step_pipeline(dev, width):
    """A bf16 pipeline of the tiny encoders and VAE with tiny or
    full-width-slice UNets, random biases and norm affines."""
    from idmvton_tpu_torch.core.config import UNetConfig
    from idmvton_tpu_torch.models.layers import Norm, reset_parameters_
    from idmvton_tpu_torch.models.unet import UNet
    from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
    models = TryonModels.init(0, tiny=True, device=dev, dtype=torch.bfloat16)
    if width == "slice":
        gen = torch.Generator(device=dev).manual_seed(1)
        for name, mode in (("unet", "consume"), ("garm", "emit")):
            cfg = UNetConfig.tiny(mode, **FULL_WIDTH_SLICE)
            unet = UNet(cfg, dtype=torch.bfloat16, device=dev)
            reset_parameters_(unet, gen)
            setattr(models, f"{name}_cfg", cfg)
            setattr(models, name, unet)
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for module in models.components().values():
            for m in module.modules():
                for pname, p in m.named_parameters(recurse=False):
                    if pname == "bias" or (pname == "scale"
                                           and isinstance(m, Norm)):
                        r = torch.randn(p.shape, generator=gen, device=dev)
                        p.copy_(r * 0.1 + (1.0 if pname == "scale" else 0.0))
    return TryonPipeline(models)


def _step_inputs(pipe, dev, b=2, h=256, w=192):
    g = torch.Generator(device=dev).manual_seed(3)
    img = lambda: (torch.rand(b, h, w, 3, generator=g, device=dev) * 2
                   - 1).bfloat16()
    ids = lambda: torch.randint(0, pipe.models.clip_l_cfg.vocab_size,
                                (b, 77), generator=g, device=dev)
    mask = torch.zeros(b, h, w, 1, device=dev, dtype=torch.bfloat16)
    mask[:, h // 5:4 * h // 5, w // 6:5 * w // 6] = 1
    isz = pipe.models.vision_cfg.image_size
    return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids(),
                ip_pixels=(torch.rand(b, isz, isz, 3, generator=g,
                                      device=dev) * 2 - 1).bfloat16())


def _replayed_vs_eager(pipe, inputs, **kw):
    """(replayed latent, eager latent, second eager latent) of one step
    from the same latents, conditioning and noise; the first step() of a
    new graph runs eagerly and captures, so the step is run twice."""
    import numpy as np
    dev = inputs["person"].device
    sched = pipe.scheduler
    g = torch.Generator(device=dev).manual_seed(4)
    cond = pipe.staged_encoder()(g, inputs)
    b, h, w, _ = inputs["person"].shape
    lat = torch.randn(b, h // 8, w // 8, 4, generator=g,
                      device=dev).bfloat16()
    noise = torch.randn(lat.shape, generator=g, device=dev).bfloat16()
    ts, prev = sched.timesteps_and_prev(30)
    table = torch.from_numpy(sched.step_table(
        ts, prev, np.concatenate([ts[1:], [-1]]))).to(dev)
    i = 3
    eager = [pipe.denoise_step(cond, lat, int(ts[i]), int(prev[i]),
                               step_noise=noise, **kw) for _ in range(2)]
    steps = pipe.step_graph(cond, lat, **kw)
    for _ in range(2):
        steps.start(table[i:], lat, cond)
        steps.step(noise)
    return steps, steps.lat.clone(), eager


@pytest.mark.parametrize("width", ["tiny", "slice"])
def test_replayed_step_equals_eager_step(dev, width):
    pipe = _step_pipeline(dev, width)
    with torch.inference_mode():
        steps, got, (want, again) = _replayed_vs_eager(
            pipe, _step_inputs(pipe, dev), guidance_rescale=0.3)
    assert steps.graph is not None
    # every GroupNorm whose statistics take #3 takes #13 in the capture
    delta = steps.counts.delta
    assert delta["gn_apply"] == delta["gn_spatial_stats"] > 0, delta
    assert torch.equal(want, again)
    assert torch.equal(got, want)


def test_recapture_after_fixed_shift_flip_and_quantization(dev, monkeypatch):
    """A flipped fixed-shift switch and the W8A8 quantization each give a
    new graph, whose replay equals the eager step under the new switch or
    weights."""
    from idmvton_tpu_torch.models.attention import (
        quantize_unet_linears_int8,
    )
    monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "1")
    pipe = _step_pipeline(dev, "slice")
    inputs = _step_inputs(pipe, dev)
    with torch.inference_mode():
        first, got, (want, _) = _replayed_vs_eager(pipe, inputs)
        assert torch.equal(got, want)
        monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "0")
        online, got_o, (want_o, _) = _replayed_vs_eager(pipe, inputs)
        assert online is not first and torch.equal(got_o, want_o)
        assert not torch.equal(got_o, got)
        monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "1")
        quantize_unet_linears_int8(pipe.models.unet)
        quant, got_q, (want_q, _) = _replayed_vs_eager(pipe, inputs)
        assert quant is not first and torch.equal(got_q, want_q)
        assert not torch.equal(got_q, got)
        assert len(pipe.graphs.graphs) == 1


def test_replayed_request_counts_equal_eager(dev):
    """jit_generate (every step but the first replayed) and generate from
    generators of one seed: the same images and, per kernel, the same
    launch counts; a second request replays every step."""
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    pipe = _step_pipeline(dev, "tiny")
    inputs = _step_inputs(pipe, dev)
    counters = launch_counters()
    out = {}
    for mode in ("jit", "eager"):
        g = torch.Generator(device=dev).manual_seed(5)
        for f in counters.values():
            f.launches = 0
        if mode == "jit":
            fn = pipe.jit_generate(num_steps=4, inpaint_blend=True)
        else:
            fn = lambda g, **kw: pipe.generate(g, num_steps=4,
                                               inpaint_blend=True, **kw)
        images = [fn(g, **inputs) for _ in range(2)]
        out[mode] = (images, {k: f.launches for k, f in counters.items()})
    for a, b in zip(out["jit"][0], out["eager"][0]):
        assert torch.equal(a, b)
    assert out["jit"][1] == out["eager"][1]
    assert out["jit"][1]["conv3x3"] > 0
    torch_card.record("graph_tiny", out["jit"][1])


# ---------------------------------------------------------------------------
# checkpoint IO on the card (weights/)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_safetensors_reads_straight_to_the_card(dev, tmp_path, dtype):
    """The port's reader puts BF16 / F16 tensors on the card with the bits
    the CPU path reads, eagerly and through the lazy reader."""
    from idmvton_tpu_torch.weights.safetensors import (
        SafetensorsReader, load_file, save_file,
    )
    g = torch.Generator().manual_seed(6)
    want = {"w": (torch.randn(640, 1920, generator=g) * 3).to(dtype),
            "b": torch.randn(1920, generator=g).to(dtype),
            "t": torch.randn(77, 64, generator=g).to(dtype).t()}
    path = str(tmp_path / "w.safetensors")
    save_file(want, path)
    cpu, card = load_file(path), load_file(path, device=dev)
    with SafetensorsReader(path, device=dev) as r:
        lazy = {k: r[k] for k in r}
    for k, w in want.items():
        for got in (card[k], lazy[k]):
            assert got.device == dev and got.dtype == dtype
            assert torch.equal(got.cpu(), cpu[k]) and torch.equal(cpu[k], w)


@pytest.fixture
def fixed_shift_flag():
    old = cuda_attention._FIXED_SHIFT_FORCED_OFF
    cuda_attention._FIXED_SHIFT_FORCED_OFF = False
    yield
    cuda_attention._FIXED_SHIFT_FORCED_OFF = old


def test_calibration_flips_the_switch_and_the_next_capture(dev,
                                                           fixed_shift_flag):
    """``calibrate_attention_softmax`` on a stack whose TryonNet down site
    is hot (q and k columns share one large matrix, as JAX's test builds
    it) probes every flash-servable site through the kernel, forces the
    online softmax, and the next captured step holds that in its key and
    equals the eager step under it; a clean stack restores the fixed
    shift."""
    from idmvton_tpu_torch.models.layers import weights_changed_
    from idmvton_tpu_torch.weights.checkpoint import (
        calibrate_attention_softmax,
    )
    pipe = _step_pipeline(dev, "slice")
    models = pipe.models
    inputs = _step_inputs(pipe, dev)
    with torch.inference_mode():
        clean = calibrate_attention_softmax(models)
        assert clean["fixed_shift"] and cuda_attention.fixed_shift_enabled()
        assert set(clean["site_errors"]) == {"unet.down", "unet.mid",
                                             "garm.down", "garm.mid"}
        first, _, _ = _replayed_vs_eager(pipe, inputs)
        kernel = models.unet.down_blocks[1]["attentions"][0].blocks[0] \
            .attn1.to_qkv.kernel
        inner = kernel.shape[1] // 3
        g = torch.Generator(device=dev).manual_seed(7)
        w_qk = (0.5 * torch.randn(kernel.shape[0], inner, generator=g,
                                  device=dev)).to(kernel.dtype)
        kernel[:, :inner].copy_(w_qk)
        kernel[:, inner:2 * inner].copy_(w_qk)
        weights_changed_(models.unet)
        launches = cuda_attention.flash_attention_gemm.launches
        hot = calibrate_attention_softmax(models)
        # two launches a site, two more for the worst one
        assert cuda_attention.flash_attention_gemm.launches - launches == 10
        assert hot["worst_site"] == "unet.down" and not hot["fixed_shift"]
        assert not cuda_attention.fixed_shift_enabled()
        steps, got, (want, _) = _replayed_vs_eager(pipe, inputs)
        assert steps is not first and torch.equal(got, want)
        (key,) = [k for k, v in pipe.graphs.graphs.items() if v is steps]
        assert key[-1][0] is False


# ---------------------------------------------------------------------------
# fp32 weights at the kernel sites: the preprocessing nets and an fp32 stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (1, 23, 18, 512, 512), (1, 23, 18, 128, 128), (1, 32, 32, 256, 256),
    (1, 34, 25, 256, 256), (20, 28, 28, 512, 512)])
def test_conv_site_takes_fp32_weights(dev, b, h, w, cin, cout):
    """``layers.conv2d`` on an fp32 x and an fp32 ``Conv`` (the OpenPose,
    SCHP and DensePose sites) launches the conv kernel with a bf16 copy of
    the weight, made once per weights version: within the bf16 bound of the
    fp32 plain version and within F32_TOL of the plain version on the
    bf16-rounded x and weight. New weights (``weights_changed_``) give a
    new copy."""
    from idmvton_tpu_torch.models.layers import (
        Conv, conv2d, reset_parameters_, weights_changed_,
    )
    g = torch.Generator(device=dev).manual_seed(21)
    conv = Conv(cin, cout, dtype=torch.float32, device=dev)
    reset_parameters_(conv, g)
    conv.bias.copy_(_randn(g, cout, dev=dev, dtype=torch.float32) * 0.1)
    x = _randn(g, b, h, w, cin, dev=dev, dtype=torch.float32)
    before = cuda_conv.conv3x3.launches + cuda_conv.conv3x3_hblock.launches
    got = conv2d(conv, x, impl="cuda")
    again = conv2d(conv, x, impl="cuda")
    want = conv2d(conv, x, impl="torch")
    want_r = cuda_conv.conv3x3_torch(x.bfloat16().float(),
                                     conv.kernel.bfloat16().float(),
                                     conv.bias)
    torch.cuda.synchronize()
    assert (cuda_conv.conv3x3.launches + cuda_conv.conv3x3_hblock.launches
            == before + 2)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, cout)
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= BF16_TOL
    assert _rel_err(got, want_r) <= F32_TOL
    with torch.no_grad():
        conv.kernel.mul_(-1.0)
    weights_changed_(conv)
    assert _rel_err(conv2d(conv, x, impl="cuda"), -want_r
                    + 2 * conv.bias) <= F32_TOL


def test_fp32_tiny_step_reaches_the_kernels(dev):
    """The tiny stack in fp32 (the CLIs' ``--dtype float32``): one denoise
    step with ``impl="cuda"`` launches the conv, ln_linear and attention
    kernels (each site hands its kernel bf16 operands: the activations
    narrowed, the weights' bf16 copy) and stays within 2e-2 mean rel of the
    fp32 plain step on the guided noise prediction and the latent."""
    from idmvton_tpu_torch.diffusion.scheduler import (
        classifier_free_guidance,
    )
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
    models = TryonModels.init(0, tiny=True, device=dev, dtype=torch.float32)
    pipe = TryonPipeline(models)
    inputs = {k: v.float() if v.is_floating_point() else v
              for k, v in _step_inputs(pipe, dev, h=512, w=384).items()}
    counters = launch_counters()
    out = {}
    hook = models.unet.register_forward_hook(
        lambda mod, args, res: out.update(unet=res[0]))
    try:
        with torch.inference_mode():
            g = torch.Generator(device=dev).manual_seed(4)
            cond = pipe.staged_encoder()(g, inputs)
            lat = torch.randn(2, 64, 48, 4, generator=g, device=dev)
            noise = torch.randn(lat.shape, generator=g, device=dev)
            ts, prev = pipe.scheduler.timesteps_and_prev(30)
            for impl in ("cuda", "torch"):
                for f in counters.values():
                    f.launches = 0
                latent = pipe.denoise_step(cond, lat, int(ts[3]),
                                           int(prev[3]), step_noise=noise,
                                           impl=impl)
                pred = classifier_free_guidance(*out.pop("unet").chunk(2),
                                                2.0)
                out[impl] = (latent, pred,
                             {k: f.launches for k, f in counters.items()})
    finally:
        hook.remove()
    launches = out["cuda"][2]
    assert not any(out["torch"][2].values()), out["torch"][2]
    for k in ("conv3x3", "ln_linear", "flash_attention_gemm",
              "flash_attention", "gn_spatial_stats"):
        assert launches[k] > 0, launches
    for i in (0, 1):
        got, want = out["cuda"][i], out["torch"][i]
        assert got.dtype == torch.float32
        assert torch.isfinite(got).all()
        mean_rel = float((got - want).abs().mean() / want.abs().mean())
        assert mean_rel <= 2e-2, (i, mean_rel)


# the demo's preprocessing conv sites (fp32 x): OpenPose's 92x72 / 46x36 /
# 23x18 levels, SCHP's layer2 / layer3 / PSP bottleneck at 512 and 473,
# DensePose's res3-res5, FPN / RPN levels (P2 272x200 takes the hblock
# site) and the head's batch of 20 (tests/test_torch_conv_plan.py's
# PREPROCESS, which imports JAX)
PREPROCESS_CONVS = [
    (1, 92, 72, 128, 128), (1, 46, 36, 128, 256), (1, 46, 36, 256, 256),
    (1, 23, 18, 256, 512), (1, 23, 18, 512, 512), (1, 23, 18, 512, 256),
    (1, 23, 18, 256, 128), (1, 23, 18, 128, 128),
    (1, 64, 64, 128, 128), (1, 32, 32, 256, 256), (1, 32, 32, 4096, 512),
    (1, 60, 60, 128, 128), (1, 30, 30, 256, 256), (1, 30, 30, 4096, 512),
    (1, 136, 100, 128, 128), (1, 68, 50, 256, 256), (1, 34, 25, 512, 512),
    (1, 272, 200, 256, 256), (1, 136, 100, 256, 256), (1, 68, 50, 256, 256),
    (1, 34, 25, 256, 256), (1, 17, 13, 256, 256),
    (20, 28, 28, 256, 512), (20, 28, 28, 512, 512)]
# the other fp32 conv sites: the fp32 decode's 128x96, 512x384 and 1024x768
# levels; the DensePose train step (B = 2 at 800x1088: res3's conv2, P3,
# P2, a slab of 16 RoIs), FaceNet's 96x96 level (Face at 384), Hand's
# conv2_2 at 736; LPIPS's VGG16 on a 768x1024 image (conv2_2, conv3_1,
# conv3_2, conv4_2)
FP32_CONVS = [
    (2, 128, 96, 512, 512), (2, 512, 384, 512, 256), (2, 1024, 768, 128, 128),
    (2, 100, 136, 128, 128), (2, 100, 136, 256, 256), (2, 200, 272, 256, 256),
    (16, 28, 28, 512, 512), (1, 96, 96, 256, 256), (1, 368, 368, 128, 128),
    (1, 512, 384, 128, 128), (1, 256, 192, 128, 256), (1, 256, 192, 256, 256),
    (1, 128, 96, 512, 512)]


@pytest.mark.parametrize("b,h,w,cin,cout", PREPROCESS_CONVS + FP32_CONVS)
def test_conv3x3_kernel_preprocess_shapes(dev, b, h, w, cin, cout):
    """Each fp32 conv shape of the preprocessing nets and the other fp32
    sites through the wrapper its site takes (an image of 32 MiB or more
    takes the hblock site), on an fp32 x and bf16 weights: against the
    fp32 plain version (the bf16 bound) and the plain version on the
    bf16-rounded x (F32_TOL)."""
    g = torch.Generator(device=dev).manual_seed(22)
    x = _randn(g, b, h, w, cin, dev=dev, dtype=torch.float32)
    k = _randn(g, 3, 3, cin, cout, dev=dev, scale=(9 * cin) ** -0.5)
    bb = _randn(g, cout, dev=dev, dtype=torch.float32)
    fn = (cuda_conv.conv3x3 if cuda_conv.conv3x3_supported(x, k)
          else cuda_conv.conv3x3_hblock)
    assert (fn is cuda_conv.conv3x3_hblock) == (
        h * w * cin * 4 >= cuda_conv.HBLOCK_MIN_BYTES)
    before = fn.launches
    got = fn(x, k, bb)
    want = cuda_conv.conv3x3_torch(x, k, bb)
    want_r = cuda_conv.conv3x3_torch(x.bfloat16().float(), k, bb)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, h, w, cout)
    assert _rel_err(got, want) <= BF16_TOL
    assert _rel_err(got, want_r) <= F32_TOL


@pytest.mark.parametrize("n,thr,score_thr,topk", [
    (5000, 0.7, float("-inf"), 1000), (1000, 0.5, 0.05, 100),
    (60, 0.5, float("-inf"), 100)])
def test_nms_on_the_card_equals_the_cpu(dev, n, thr, score_thr, topk):
    """``nms_topk`` on CUDA boxes (the IoU matrix on the card, the scan on
    the host) equals the CPU run on the same boxes: keeps, order, boxes,
    scores (the RPN's 5 levels x 1000 and the box head's 1000 -> 100).
    Both compute each IoU with the same fp32 operations; a pair within one
    ulp of the threshold could still flip, which these boxes do not have."""
    from idmvton_tpu_torch.ops.nms import nms_topk
    g = torch.Generator().manual_seed(23)
    ctr = torch.rand(n, 2, generator=g) * 800
    size = torch.rand(n, 2, generator=g) * 200 + 8
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], 1)
    scores = torch.rand(n, generator=g)
    scores[1::7] = scores[::7][:scores[1::7].shape[0]]   # ties
    kw = dict(iou_threshold=thr, score_threshold=score_thr, topk=topk)
    want = nms_topk(boxes, scores, **kw)
    got = nms_topk(boxes.to(dev), scores.to(dev), **kw)
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)
    assert (want[2] >= 0).sum() > 1


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions, a train step, and concurrent
# demo requests (F9)
# ---------------------------------------------------------------------------


def _vjp_cases(dev):
    """name -> (autograd entry, plain version, inputs, keywords) at small
    shapes each kernel takes (bf16 operands, fp32 LayerNorm affines)."""
    from idmvton_tpu_torch.ops import autograd as AG
    g = torch.Generator(device=dev).manual_seed(21)
    rn = lambda *s, **kw: _randn(g, *s, dev=dev, **kw)
    f32 = dict(dtype=torch.float32)
    x = rn(2, 40, 128)
    gam, bet = rn(128, **f32) * 0.2 + 1.0, rn(128, **f32) * 0.1
    w, wg = rn(128, 256, scale=128 ** -0.5), rn(128, 512, scale=128 ** -0.5)
    w_i8, w_s = quantize_kernel_int8(w)
    xc, k3 = rn(2, 8, 12, 128), rn(3, 3, 128, 128, scale=(9 * 128) ** -0.5)
    return {
        "ln_linear": (AG.ln_linear, cuda_norm.ln_linear_torch,
                      (x, gam, bet, w, rn(256, scale=0.1)), {}),
        "ln_linear_geglu": (AG.ln_linear, cuda_norm.ln_linear_torch,
                            (x, gam, bet, wg, rn(512, scale=0.1)),
                            {"geglu": True}),
        "fused_layer_norm": (AG.fused_layer_norm,
                             cuda_norm.layer_norm_torch, (x, gam, bet), {}),
        "gn_spatial_stats": (AG.gn_spatial_stats,
                             cuda_norm.gn_spatial_stats_torch,
                             (rn(2, 8, 12, 64) + 0.3,), {}),
        "gn_apply": (AG.gn_apply, cuda_norm.gn_apply_torch,
                     _gn_apply_case(26, (2, 8, 12, 128), torch.bfloat16,
                                    dev),
                     {"num_groups": 32, "silu": True}),
        "conv3x3": (AG.conv3x3, cuda_conv.conv3x3_torch,
                    (xc, k3, rn(128, scale=0.1)), {}),
        "conv3x3_hblock": (AG.conv3x3_hblock, cuda_conv.conv3x3_torch,
                           (xc, k3, rn(128, scale=0.1)), {}),
        "conv3x3_padacc": (AG.conv3x3_padacc, cuda_conv.conv3x3_torch,
                           (xc, k3, rn(128, scale=0.1)), {}),
        "flash_attention_gemm": (AG.flash_attention_gemm,
                                 cuda_attention.flash_attention_gemm_torch,
                                 (rn(4, 64, 384), rn(2, 64, 256)),
                                 {"heads": 2, "uncond_rows": 2}),
        "ln_linear_i8": (AG.ln_linear_i8, cuda_norm.ln_linear_i8_torch,
                         (x, gam, bet, w_i8, w_s, rn(256, scale=0.1)), {}),
        "flash_attention": (AG.flash_attention,
                            cuda_attention.flash_attention_torch,
                            (rn(2, 300, 2, 64), rn(2, 300, 2, 64),
                             rn(2, 300, 2, 64)), {}),
        "flash_attention_concat_kv": (
            AG.flash_attention_concat_kv,
            cuda_attention.flash_attention_concat_kv_torch,
            (rn(2, 200, 2, 64), rn(2, 200, 2, 64), rn(2, 200, 2, 64),
             rn(2, 100, 2, 64), rn(2, 100, 2, 64)), {}),
        "cross_attention_small_kv": (
            AG.cross_attention_small_kv,
            cuda_attention.cross_attention_small_kv_torch,
            (rn(2, 64, 128), rn(2, 77, 256), rn(2, 16, 256)), {"heads": 2}),
    }


VJP_CASES = ["ln_linear", "ln_linear_geglu", "fused_layer_norm",
             "gn_spatial_stats", "gn_apply", "conv3x3", "conv3x3_hblock",
             "conv3x3_padacc", "flash_attention_gemm", "ln_linear_i8",
             "flash_attention", "flash_attention_concat_kv",
             "cross_attention_small_kv"]


@pytest.mark.parametrize("name", VJP_CASES)
def test_kernel_gradient_matches_plain_autograd(dev, name):
    """Each kernel through its autograd Function on the card: it launches
    the kernel once, its output within the bf16 bound of the plain
    version's, and every input's gradient within the bf16 bound of plain
    autograd's (the backward is the plain version's VJP; the two differ by
    the forward's rounding where a VJP reads it, and by cuDNN / cuBLAS
    summation order). #8 differentiates the dequantized product, as JAX's
    VJP does: the plain side is ``ln_linear_torch`` on the dequantized
    weight; no gradient reaches its int8 weight or scales."""
    from idmvton_tpu_torch.ops.quant import dequantize_kernel_int8
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    entry, plain, ins, kw = _vjp_cases(dev)[name]
    leaf = lambda t: (t.detach().clone().requires_grad_()
                      if t.is_floating_point() else t)
    ins_k = [leaf(t) for t in ins]
    counters = launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    out = entry(*ins_k, **kw)
    launched = {k: f.launches - before[k] for k, f in counters.items()
                if f.launches != before[k]}
    kernel = {"ln_linear_geglu": "ln_linear",
              "flash_attention_concat_kv": "flash_attention"}.get(name, name)
    assert launched == {kernel: 1}, launched
    ins_p = [leaf(t) for t in ins]
    if name == "ln_linear_i8":
        wd = dequantize_kernel_int8(ins[3], ins[4], torch.bfloat16)
        want = cuda_norm.ln_linear_torch(ins_p[0], ins_p[1], ins_p[2], wd,
                                         ins_p[5])
        pairs = [(ins_k[i], ins_p[i]) for i in (0, 1, 2, 5)]
        assert ins_k[4].grad is None
    else:
        want = plain(*ins_p, **kw)
        pairs = [(a, b) for a, b in zip(ins_k, ins_p) if a.requires_grad]
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    gen = torch.Generator(device=dev).manual_seed(5)
    cots = [torch.randn(o.shape, generator=gen, device=dev).to(o.dtype)
            for o in outs]
    got_g = torch.autograd.grad(outs, [a for a, _ in pairs], cots)
    want_g = torch.autograd.grad(wants, [b for _, b in pairs], cots)
    tol = SUM_TOL if name == "gn_spatial_stats" else BF16_TOL
    if name != "ln_linear_i8":
        for o, w_ in zip(outs, wants):
            assert _rel_err(o.detach(), w_.detach()) <= tol
    for gk, gp in zip(got_g, want_g):
        assert gk.dtype == gp.dtype
        assert _rel_err(gk, gp) <= BF16_TOL


def test_unwrapped_kernel_under_grad_raises_on_the_card(dev):
    """A kernel wrapper called with grad mode on and an input that requires
    grad raises instead of launching (its output would carry no grad_fn and
    the gradient through it would be dropped); #10, which has no VJP,
    raises the same way; under ``no_grad`` both launch."""
    x = _randn(torch.Generator(device=dev).manual_seed(1), 2, 40, 128,
               dev=dev).requires_grad_()
    gam = torch.ones(128, device=dev)
    w = _randn(torch.Generator(device=dev).manual_seed(2), 128, 128, dev=dev)
    qkv = x.reshape(2, 40, 2, 64)[:, :, None].expand(2, 40, 3, 2, 64)
    qkv = torch.cat([qkv] * 8, 1)
    with pytest.raises(RuntimeError, match="under autograd"):
        cuda_norm.ln_linear(x, gam, gam * 0, w)
    with pytest.raises(RuntimeError, match="under autograd"):
        cuda_attention.flash_attention_fused_qkv(qkv, 64)
    with torch.no_grad():
        assert cuda_norm.ln_linear(x, gam, gam * 0, w).shape == (2, 40, 128)
        assert cuda_attention.flash_attention_fused_qkv(
            qkv.contiguous(), 64).shape == (2, 64, 2, 64)


def test_tiny_train_steps_cuda_match_torch(dev):
    """Two adamw steps of the tiny stack (bf16, 256x192, remat) with
    ``impl="cuda"``, and the same masters' loss with ``impl="torch"`` before
    each: the losses within 3e-2 relative (bf16 kernels against the plain
    path through two UNets, the differences of the step gates), the
    gradient norms within 5e-2, every trainable leaf's gradient within
    0.1 of its scale on average (mean |diff| / mean |torch|). The second
    forward reads the first step's in-place update: a stale bf16 weight
    copy at a kernel site would leave the kernel path on the old weights
    (its loss then off by the step's whole change). The step launches the
    bf16 path's kernels and #9 (the 64-wide level's 384 keys); the torch
    impl only the VAE encode's (the frozen VAE takes no impl, as JAX's
    ``vae_encode``); with remat TryonNet's launch again in the backward's
    recompute, so the remat step launches more than the one without."""
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.train_step import (
        flat_params, init_train_state, make_optimizer, make_train_step,
        tryon_loss,
    )
    models = TryonModels.init(0, tiny=True, device=dev, dtype=torch.bfloat16)
    sched = DDPMScheduler(SchedulerConfig.train())
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, w = 1, 256, 192
    img = lambda: torch.rand(b, h, w, 3, generator=g, device=dev) * 2 - 1
    ids = lambda: torch.randint(0, 1000, (b, 7), generator=g, device=dev)
    batch = dict(person=img(), pose=img(), cloth=img(),
                 mask=(torch.rand(b, h, w, 1, generator=g, device=dev)
                       > 0.5).float(),
                 prompt_ids_l=ids(), prompt_ids_g=ids(), cloth_ids_l=ids(),
                 cloth_ids_g=ids(),
                 ip_pixels=torch.rand(b, 28, 28, 3, generator=g,
                                      device=dev) * 2 - 1,
                 noise=torch.randn(b, h // 8, w // 8, 4, generator=g,
                                   device=dev),
                 timesteps=torch.tensor([437], device=dev))
    tx = make_optimizer(learning_rate=1e-4)
    state = init_train_state(models, tx)
    counters = launch_counters()

    def grads(impl, remat=True):
        params = flat_params(state.trainable)
        for f in counters.values():
            f.launches = 0
        loss = tryon_loss(state.trainable, models, sched, batch,
                          impl=impl, remat=remat, vae_sample=False)
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        return (float(loss.detach()), dict(zip(params, gs)),
                {k: f.launches for k, f in counters.items()})

    step = make_train_step(models, sched, tx, impl="cuda", vae_sample=False)
    for i in range(2):
        loss_c, g_c, n_c = grads("cuda")
        loss_t, g_t, n_t = grads("torch")
        assert {k for k, n in n_t.items() if n} == {
            "conv3x3", "gn_spatial_stats", "gn_apply"}, n_t
        assert all(n_c[k] > n_t[k] for k in n_t if n_t[k]), (n_c, n_t)
        for k in ("conv3x3", "ln_linear", "flash_attention_gemm",
                  "flash_attention", "gn_spatial_stats", "gn_apply"):
            assert n_c[k] > 0, n_c
        assert abs(loss_c - loss_t) <= 3e-2 * abs(loss_t), (i, loss_c,
                                                             loss_t)
        norm = lambda gs: float(torch.sqrt(sum(
            v.float().square().sum() for v in gs.values() if v is not None)))
        assert abs(norm(g_c) - norm(g_t)) <= 5e-2 * norm(g_t)
        for k, gt in g_t.items():
            if gt is None or float(gt.abs().mean()) == 0:
                continue
            rel = float((g_c[k] - gt).abs().mean() / gt.abs().mean())
            assert rel <= 0.1, (i, k, rel)
        state, metrics = step(state, batch)
        assert torch.isfinite(metrics["loss"]) and state.step == i + 1
    _, _, n_plain = grads("cuda", remat=False)
    assert sum(n_c.values()) > sum(n_plain.values()), (n_c, n_plain)


def test_concurrent_demo_requests_keep_exact_launch_counts(dev):
    """F9: one thread serves try-on requests on the tiny service, each the
    first of its graph key (the captures are dropped in between), while a
    second thread loops over the service's three preprocessing nets
    (``auto_mask``: OpenPose and SCHP; ``pose_image``: DensePose). Both
    finish without error, and the launch counters hold exactly what the
    requests and the loops launch when run alone: a launch of the other
    thread inside a capture would be counted again at every replay, and an
    allocation of it would break the capture (``capture_error_mode=
    "global"``)."""
    import threading

    from idmvton_tpu_torch.cli.demo import TryonService, parse_args
    from idmvton_tpu_torch.data.image import clip_preprocess
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    from PIL import Image
    import numpy as np
    svc = TryonService(parse_args(["--tiny", "--device", "cuda", "--width",
                                   "384", "--height", "512"]))
    rng = np.random.default_rng(8)
    person = rng.integers(0, 255, (512, 384, 3), np.uint8)
    cloth = rng.integers(0, 255, (512, 384, 3), np.uint8)
    ip = clip_preprocess(Image.fromarray(cloth)).astype(np.float32)
    drawn = np.zeros((512, 384), bool)
    drawn[100:400, 80:300] = True
    counters = launch_counters()

    def counts():
        torch.cuda.synchronize(dev)
        return {k: f.launches for k, f in counters.items()}

    def request():
        svc.pipe.graphs.graphs.clear()     # the next step captures again
        svc.tryon_arrays(person, cloth, ip, "shirt", mask=drawn, steps=3)

    def preprocess():
        svc.auto_mask(person)
        svc.pose_image(person)

    request()           # warm: the build, lazy inits, cuBLAS workspaces
    preprocess()
    alone = {}
    for name, fn in (("request", request), ("preprocess", preprocess)):
        for f in counters.values():
            f.launches = 0
        fn()
        alone[name] = counts()
    assert sum(alone["request"].values()) > 0
    assert sum(alone["preprocess"].values()) > 0

    for f in counters.values():
        f.launches = 0
    done, errors, loops = threading.Event(), [], [0]

    def requests():
        try:
            for _ in range(4):
                request()
        except BaseException as e:   # reported by the assert below
            errors.append(e)
        finally:
            done.set()

    def preprocessing():
        try:
            while not done.is_set():
                preprocess()
                loops[0] += 1
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=preprocessing),
               threading.Thread(target=requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert not errors, errors
    assert loops[0] >= 1
    got = counts()
    want = {k: 4 * alone["request"][k] + loops[0] * alone["preprocess"][k]
            for k in got}
    assert got == want, (got, want, loops[0])


# ---------------------------------------------------------------------------
# DensePose detection training, Face / Hand, the evaluation harness
# ---------------------------------------------------------------------------


def _dp_batch(dev, b=2, h=256, w=352, g_=3, p=32, m=56, seed=60):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    mean = torch.tensor([103.530, 116.280, 123.675], device=dev)
    images = u(b, h, w, 3) * 255 - mean
    bw, bh = (0.2 + 0.3 * u(b, g_)) * w, (0.3 + 0.4 * u(b, g_)) * h
    x1, y1 = u(b, g_) * (w - bw), u(b, g_) * (h - bh)
    gts = {"boxes": torch.stack([x1, y1, x1 + bw, y1 + bh], -1),
           "valid": torch.ones(b, g_, dtype=torch.bool, device=dev),
           "dp_x": x1[..., None] + u(b, g_, p) * bw[..., None],
           "dp_y": y1[..., None] + u(b, g_, p) * bh[..., None],
           "dp_i": torch.randint(0, 25, (b, g_, p), generator=g,
                                 device=dev),
           "dp_u": u(b, g_, p), "dp_v": u(b, g_, p),
           "dp_pt_valid": torch.ones(b, g_, p, dtype=torch.bool, device=dev),
           "dp_mask": u(b, g_, m, m) > 0.4}
    return images, gts


def _dp_model(dev, seed=60, **cfg):
    from idmvton_tpu_torch.preprocess.densepose import rcnn
    model = rcnn.init_densepose_rcnn(seed, rcnn.DensePoseConfig(**cfg),
                                     device=dev)
    with torch.no_grad():   # the stem at mean-subtracted pixel scale
        model.backbone.stem.conv.kernel.div_(50.0)
    return model


# The DensePose R-CNN's train step: at reduced depth (a 2x128 head, B = 2
# at 256x352, 3 persons of 32 points, 56x56 masks) and at the served
# config (the 8x512 head, B = 2 at 800x1088, 3 persons of 128 points: 42
# conv3x3 and 3 conv3x3_hblock sites a forward, read from the code: res3-5's
# conv2, the FPN outputs and RPN conv above P2, the decoder, the head's 8
# convs on each image's slab; at P2 the FPN output, the RPN conv and the
# decoder conv). The served losses' bound and the gradients' (max rel, mean
# rel) bound sit at 3-4x the first readings on an H100 (losses rel 3.7e-7
# to 2.4e-3; gradients max rel 1.9e-2 to 2.8e-2, mean rel 7.2e-3 to 3.0e-2)
DP_TRAIN = {
    "reduced": dict(cfg=dict(dp_convs=2, dp_dim=128), hw=(256, 352), points=32,
                    loss_tol=5e-2, convs=None, grads=None),
    "served": dict(cfg={}, hw=(800, 1088), points=128, loss_tol=1e-2,
                   convs={"conv3x3": 42, "conv3x3_hblock": 3},
                   grads=(("backbone.res3.0.conv2.conv.kernel",
                           "fpn.output.0.kernel", "rpn.conv.kernel",
                           "dp_head.convs.7.kernel"), 1e-1, 1e-1)),
}


@pytest.mark.parametrize("config", list(DP_TRAIN))
def test_dp_train_step_cuda_matches_torch(dev, config):
    """A DensePose train step (``DP_TRAIN``): the losses ``impl="cuda"``
    against ``impl="torch"`` within the config's bound on the same uniforms
    and replayed proposals (and, served, four kernel-site leaves'
    gradients), the sampled sets identical; the step launches exactly its
    forward's conv sites (no kernel in the backward; served, the sites read
    from the code); two masked SGD steps stay finite, move the head and
    leave stem, res2 and every frozen BN bitwise unchanged."""
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    from idmvton_tpu_torch.preprocess.densepose import train as dt
    c = DP_TRAIN[config]
    model = _dp_model(dev, **c["cfg"])
    h, w = c["hw"]
    images, gts = _dp_batch(dev, h=h, w=w, p=c["points"])
    tcfg = dt.DetectionTrainConfig()
    params = dt.detection_params(model)
    tx = dt.make_detection_optimizer(tcfg, params)
    for k, p in params.items():
        p.requires_grad_(tx.trains(k))
    g = torch.Generator(device=dev).manual_seed(61)
    # three anchors a position of P2-P6
    n_anchors = 3 * sum(-(-h // s) * -(-w // s) for s in (4, 8, 16, 32, 64))
    n_prop = model.cfg.rpn_post_nms_topk + gts["boxes"].shape[1]
    uniforms = [[torch.rand(n, generator=g, device=dev)
                 for n in (n_anchors, n_prop, n_prop)] for _ in range(2)]
    leaves = c["grads"][0] if c["grads"] else ("rpn.conv.kernel",)
    counters = launch_counters()
    runs = {}
    for impl in ("cuda", "torch"):
        for f in counters.values():
            f.launches = 0
        rec = []
        total, losses = dt.detection_total_loss(
            model, params, images, gts, tcfg=tcfg, uniforms=uniforms,
            impl=impl, record=rec, proposals=None if impl == "cuda"
            else [r["prop_idx"] for r in runs["cuda"][1]])
        grads = torch.autograd.grad(total, [params[k] for k in leaves])
        runs[impl] = ({k: float(v.detach()) for k, v in losses.items()}, rec,
                      {k: f.launches for k, f in counters.items()
                       if f.launches}, grads)
    assert runs["torch"][2] == {} and runs["cuda"][2]["conv3x3"] > 0
    if c["convs"] is not None:
        assert runs["cuda"][2] == c["convs"], runs["cuda"][2]
        torch_card.record("densepose_train", runs["cuda"][2])
    for k, want in runs["torch"][0].items():
        got = runs["cuda"][0][k]
        assert abs(got - want) <= c["loss_tol"] * abs(want), (k, got, want)
    if c["grads"]:
        _, max_tol, mean_tol = c["grads"]
        for k, a, b in zip(leaves, runs["cuda"][3], runs["torch"][3]):
            mean = float((a - b).abs().mean() / b.abs().mean())
            assert _rel_err(a, b) <= max_tol and mean <= mean_tol, k
    for rc, rt in zip(runs["cuda"][1], runs["torch"][1]):
        for key in ("rpn_w", "prop_idx", "roi_w", "fg", "dp_idx",
                    "dp_valid"):
            assert torch.equal(rc[key], rt[key]), key
    step = dt.make_detection_train_step(tcfg, tx, impl="cuda")
    state = tx.init(params)
    frozen = {k: p.detach().clone() for k, p in params.items()
              if not tx.trains(k)}
    watch = "dp_head.convs.1.kernel"
    for _ in range(2):
        before = params[watch].detach().clone()
        for f in counters.values():
            f.launches = 0
        state, metrics = step(model, params, state, images, gts, g)
        assert all(torch.isfinite(v) for v in metrics.values()), metrics
        assert {k: f.launches for k, f in counters.items()
                if f.launches} == runs["cuda"][2]
        assert not torch.equal(params[watch], before)
    assert all(torch.equal(params[k], p) for k, p in frozen.items())


def test_nms_topk_over_every_anchor_on_the_card(dev):
    """The trainer's NMS at its served size (217,413 boxes, topk 1000) on
    the card equals the CPU walk, and stops early."""
    from idmvton_tpu_torch.ops.nms import nms_topk
    n = 217413
    g = torch.Generator().manual_seed(24)
    ctr = torch.rand(n, 2, generator=g) * 1088
    size = torch.rand(n, 2, generator=g) * 400 + 16
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], 1)
    scores = torch.randn(n, generator=g)
    rec_c, rec_g = {}, {}
    want = nms_topk(boxes, scores, iou_threshold=0.7, topk=1000,
                    record=rec_c)
    got = nms_topk(boxes.to(dev), scores.to(dev), iou_threshold=0.7,
                   topk=1000, record=rec_g)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert rec_g["visited"] == rec_c["visited"] < n


# Face and Hand at the served sizes: Face at 384 (12 conv3x3 sites a call:
# the trunk's conv2_2 .. conv5_3_CPM) and Hand at its four scales (184 /
# 368 / 552 / 736; 48 sites, of which five inputs reach 32 MiB and take
# conv3x3_hblock: conv2_2 at 552 and 736, conv3_2-3_4 at 736), read on an
# H100. Their bounds: (max rel, mean rel) of the heatmaps and the share of
# peaks at the same pixel, at about 4x the first readings (Face max rel
# 2.3e-4, mean rel 9.1e-5; Hand 2.5e-4 / 1.0e-4; every peak equal)
FACE_HAND_SERVED = {"face": ({"conv3x3": 12}, (1e-3, 4e-4)),
                    "hand": ({"conv3x3": 43, "conv3x3_hblock": 5},
                             (1e-3, 4e-4))}


@pytest.mark.parametrize("size", ["small", "served"])
def test_face_and_hand_cuda_match_torch(dev, size):
    """Face and Hand (random nets with random biases), small (Face at 96,
    Hand at two scales of 96) and served (``FACE_HAND_SERVED``): heatmaps
    ``cuda`` against ``torch``, small within the bf16 bound (5e-2 of the
    largest magnitude) and the cuda calls on the conv kernel; served within
    its bounds, 90% of the peaks at the same pixel and each cuda call's
    launches exact."""
    import numpy as np
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    from idmvton_tpu_torch.preprocess import openpose_extra as ox
    counters = launch_counters()
    rng = np.random.default_rng(70)
    if size == "small":
        img = rng.integers(0, 256, (120, 100, 3), np.uint8)
        nets = (("face", lambda n, i: ox.Face(n, input_size=96, impl=i),
                 ox.init_facenet, img),
                ("hand", lambda n, i: ox.Hand(n, boxsize=96,
                                              scales=(0.5, 1.0),
                                              map_size=32, impl=i),
                 ox.init_handpose, img))
    else:
        nets = (("face", lambda n, i: ox.Face(n, impl=i), ox.init_facenet,
                 rng.integers(0, 256, (200, 160, 3), np.uint8)),
                ("hand", lambda n, i: ox.Hand(n, impl=i), ox.init_handpose,
                 rng.integers(0, 256, (180, 180, 3), np.uint8)))
    for name, make, kw, img in nets:
        net = kw(71, device=dev)
        gen = torch.Generator(device=dev).manual_seed(72)
        with torch.no_grad():
            for m in net.modules():
                if getattr(m, "bias", None) is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen,
                                             device=dev) * 0.1)
        out, wrap = {}, {}
        for impl in ("cuda", "torch"):
            for f in counters.values():
                f.launches = 0
            wrap[impl] = make(net, impl)
            out[impl] = wrap[impl].heatmaps(img)
            counts = {k: f.launches for k, f in counters.items()
                      if f.launches}
            assert (counts.get("conv3x3", 0) > 0) == (impl == "cuda"), counts
            if size == "served" and impl == "cuda":
                assert counts == FACE_HAND_SERVED[name][0], (name, counts)
                torch_card.record(name, counts)
        scale = float(np.abs(out["torch"]).max())
        if size == "small":
            assert float(np.abs(out["cuda"] - out["torch"]).max()) \
                <= 5e-2 * scale
            continue
        a, b = (torch.from_numpy(out[i]) for i in ("cuda", "torch"))
        max_tol, mean_tol = FACE_HAND_SERVED[name][1]
        assert _rel_err(a, b) <= max_tol, name
        assert float((a - b).abs().mean() / b.abs().mean()) <= mean_tol, name
        if name == "face":   # a channel's peak, or none below threshold
            pc, pt = ([wrap[i].peaks(out[i][:, :, c:c + 1]).tolist()
                       for c in range(out[i].shape[-1])]
                      for i in ("cuda", "torch"))
            share = float(np.mean([x == y for x, y in zip(pc, pt)]))
        else:
            pc, pt = (wrap[i].peaks(out[i], img.shape[:2])
                      for i in ("cuda", "torch"))
            share = float((pc == pt).all(-1).mean())
        assert share >= 0.9, (name, share)


@pytest.mark.parametrize("size", ["small", "served"])
def test_inference_on_dataset_on_the_card(dev, size):
    """``inference_on_dataset`` with ``DensePose.detect`` on the card: small
    (a 1x128 head at short edge 256) over two 240x320 images, served (the
    served R-CNN at short edge 800) over three 480x640 images, each
    launching its R-CNN's conv sites exactly (short edge 800 of 480x640:
    800x1067 padded to 800x1088, the demo's 66 conv3x3 and 3 conv3x3_hblock
    sites, read on an H100); the host runtime scores them, 12 finite
    stats."""
    import numpy as np
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    from idmvton_tpu_torch.preprocess.densepose import evaluate
    from idmvton_tpu_torch.preprocess.densepose.visualize import DensePose
    rng = np.random.default_rng(80)
    if size == "small":
        dp = DensePose(_dp_model(dev, dp_convs=1, dp_dim=128), short_edge=256,
                       max_size=400)
        data = [(i, rng.integers(0, 256, (240, 320, 3), np.uint8),
                 np.asarray([[20, 30, 150, 230]], np.float32))
                for i in range(2)]
    else:
        dp = DensePose(_dp_model(dev))
        data = [(i, rng.integers(0, 256, (480, 640, 3), np.uint8),
                 np.asarray([[40, 60, 300, 460], [320, 20, 600, 470]],
                            np.float32)) for i in range(3)]
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    out = evaluate.inference_on_dataset(dp.detect, data)
    counts = {k: f.launches for k, f in counters.items() if f.launches}
    assert out["n_images"] == len(data) and out["stats"].shape == (12,)
    assert np.isfinite(out["stats"]).all()
    if size == "served":
        assert counts == {"conv3x3": 3 * 66, "conv3x3_hblock": 3 * 3}, counts
        torch_card.record("evaluate", counts)


# ---------------------------------------------------------------------------
# adamw8bit's fused update (train/quant_opt.py, csrc/adam_int8.cu) against
# the plain per-leaf update on the CPU
# ---------------------------------------------------------------------------

# leaves whose sizes are not a multiple of the 256-element blocks (2880,
# 12480, 35), one element, exactly 256, and one of 160 blocks (12-171) that
# a two-rank ZeRO-1 split (112 blocks a rank) cuts in two; 224 blocks
ADAM_SHAPES = {"conv": (3, 3, 16, 20), "linear": (160, 256), "one": (1,),
               "bias": (256,), "thin": (96, 130), "odd": (5, 7)}
ADAM_LR = 1e-3


def _adam_tree(seed, scale, dev):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(s, generator=g) * scale).to(dev)
            for k, s in ADAM_SHAPES.items()}


def _gradients(step, norm, dev):
    """Gradients of global norm ``norm``; ``linear``'s a transposed view
    (not contiguous: the wrapper reads a contiguous copy)."""
    gs = _adam_tree(100 + step, 1.0, "cpu")
    gs["linear"] = gs["linear"].t().contiguous().t()
    total = float(torch.sqrt(sum(g.square().sum() for g in gs.values())))
    return {k: (g * (norm / total)).to(dev) for k, g in gs.items()}


def _assert_moments_close(got: dict, want: dict):
    """Codes equal or one apart (a log10 rounding tie between the card's
    and the CPU's libraries; a moment one level apart then stays apart by
    about a level), 99.9% equal; scales within fp32 rounding for 99% of the
    blocks and within a level (13%) for all."""
    for m in ("mu", "nu"):
        q = got[f"{m}_q"].cpu().short()
        wq = want[f"{m}_q"].short()
        assert (q - wq).abs().max() <= 1, m
        assert (q == wq).float().mean() >= 0.999, m
        sc, wsc = got[f"{m}_scale"].cpu(), want[f"{m}_scale"]
        rel = ((sc - wsc).abs() / wsc).flatten()
        assert (rel <= 1e-6).float().mean() >= 0.99 and rel.max() <= 0.13, m


def _assert_masters_close(got: dict, want: dict, steps: int, masks=None):
    """Within fp32 rounding of the update (1e-6 of the leaf's scale) for
    99.9% of the elements, and within the effect of one code level (15% of
    the learning rate a step) for all."""
    close = total = 0
    for k, w in want.items():
        err = (got[k].cpu() - w).abs().flatten()
        if masks is not None:
            err = err[masks[k]]
        if err.numel():
            assert float(err.max()) <= 0.15 * ADAM_LR * steps, k
        close += int((err <= 1e-6 * float(w.abs().max())).sum())
        total += err.numel()
    assert close >= 0.999 * total, (close, total)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("norm", [2.7, 0.4], ids=["clip", "no_clip"])
def test_adamw8bit_kernel_matches_plain(dev, accum, norm):
    """Three adamw8bit steps (of ``accum`` micro-steps each) through
    ``Optimizer.update_`` on the card, where the kernel runs, against the
    same steps on the CPU, where the plain update runs: the clip active
    (gradient norm 2.7 over the limit 1) and not (0.4). The global norm the
    kernel's sum of squares gives equals ``global_norm``'s within fp32
    rounding; each step launches the norm and the update once and counts
    every covered block in ``adamw8bit.fused_blocks``; the gradients are
    left as they were."""
    from idmvton_tpu_torch.train import quant_opt
    from idmvton_tpu_torch.train.train_step import global_norm, make_optimizer
    from idmvton_tpu_torch.utils.profiling import counters
    params = _adam_tree(0, 0.1, dev)
    plain = {k: p.cpu() for k, p in params.items()}
    kw = dict(learning_rate=ADAM_LR, optimizer="adamw8bit",
              accum_steps=accum)
    tx, tx_plain = make_optimizer(**kw), make_optimizer(**kw)
    state, state_plain = tx.init(params), tx_plain.init(plain)
    for i in range(3 * accum):
        grads = _gradients(i, norm, dev)
        kept = {k: g.clone() for k, g in grads.items()}
        got_norm = tx.global_norm(grads, params)
        want_norm = global_norm([g.cpu() for g in grads.values()])
        assert abs(float(got_norm) - float(want_norm)) <= 1e-6 * float(
            want_norm)
        before = (quant_opt.fused_global_norm.launches,
                  quant_opt.adamw_int8_fused_.launches,
                  counters().get("adamw8bit.fused_blocks", 0))
        moved = tx.update_(grads, state, params)
        torch.cuda.synchronize()
        assert moved == tx_plain.update_({k: g.cpu() for k, g in
                                          kept.items()}, state_plain, plain)
        n = int(moved)
        assert (quant_opt.fused_global_norm.launches - before[0],
                quant_opt.adamw_int8_fused_.launches - before[1],
                counters().get("adamw8bit.fused_blocks", 0) - before[2]
                ) == (n, n, 224 * n)
        assert all(torch.equal(grads[k], kept[k]) for k in grads)
    inner = state if accum == 1 else state["inner"]
    inner_plain = state_plain if accum == 1 else state_plain["inner"]
    assert inner["count"] == inner_plain["count"] == 3
    _assert_moments_close(inner, inner_plain)
    _assert_masters_close(params, plain, 3)


def test_adamw8bit_kernel_zero1_cut_matches_plain(dev):
    """ZeRO-1's split of the 224 blocks over two ranks, each rank's range
    through the kernel (``blocks=(lo, hi)``, the state holding only those
    blocks), against the plain ``adam_int8_`` on the same range on the CPU
    (then the decay, the learning rate and the master add), three steps
    with the clip active: the range's moments alike, and the masters alike
    inside the range and untouched outside it. The ``linear`` leaf (blocks
    12-171) lies across the cut."""
    from idmvton_tpu_torch.train import quant_opt
    from idmvton_tpu_torch.train.train_step import global_norm
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    offs, nblocks = quant_opt.layout(ADAM_SHAPES.values())
    assert nblocks == 224
    for lo, hi in ((0, 112), (112, 224)):
        params = _adam_tree(0, 0.1, dev)
        start = {k: p.cpu() for k, p in params.items()}
        plain = {k: p.clone() for k, p in start.items()}
        whole = quant_opt.init_state(plain)
        state_plain = {k: v if k == "count" else v[lo:hi].clone()
                       for k, v in whole.items()}
        state = {k: v if k == "count" else v.to(dev)
                 for k, v in state_plain.items()}
        table = quant_opt.LeafTable(params)
        for i in range(3):
            grads = _gradients(i, 2.7, dev)
            norm = quant_opt.fused_global_norm(table, grads)
            quant_opt.adamw_int8_fused_(
                table, grads, params, state, **hp, weight_decay=1e-2,
                lr=ADAM_LR, clip=norm, max_norm=1.0, blocks=(lo, hi))
            g_cpu = {k: g.cpu() for k, g in grads.items()}
            n_cpu = global_norm(g_cpu.values())
            for g in g_cpu.values():
                g.div_(n_cpu).mul_(1.0)
            quant_opt.adam_int8_(g_cpu, state_plain, **hp, blocks=(lo, hi))
            for k, g in g_cpu.items():
                plain[k].add_((g + 1e-2 * plain[k]) * -ADAM_LR)
        torch.cuda.synchronize()
        masks = {}
        for (k, p), o in zip(start.items(), offs):
            e = torch.arange(p.numel()) // quant_opt.BLOCK + o
            masks[k] = (e >= lo) & (e < hi)
            assert torch.equal(params[k].cpu().flatten()[~masks[k]],
                               p.flatten()[~masks[k]]), k
        assert state["count"] == state_plain["count"] == 3
        _assert_moments_close(state, state_plain)
        _assert_masters_close(params, plain, 3, masks)


# ---------------------------------------------------------------------------
# two ranks sharing the card (parallel/onecard.py): gloo with CUDA tensors
# (NCCL refuses two ranks on one device)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["tiny", "full"])
def two_ranks(dev, request):
    """Both ranks' results of ``onecard.all_ranks`` with the tiny UNets and
    ViT, or at full width."""
    from idmvton_tpu_torch.parallel import onecard
    from idmvton_tpu_torch.parallel.dryrun import spawn
    ranks = spawn(onecard.all_ranks, 2, 7, "cuda", request.param == "tiny",
                  backend="gloo", timeout=600)
    return request.param, ranks


# One full-width denoise step (GarmentNet at batch 2, TryonNet over the CFG
# batch of 4, 128x96 latents), per rank, read from the code. Single
# process: ln_linear at TryonNet's to_qkv, to_q and ff proj_in of its 70
# blocks and GarmentNet's to_q and ff (its emit LayerNorm is
# fused_layer_norm): 210 + 140; 70 fused_layer_norm; GroupNorm 46 TryonNet
# (4 + 4 + 2 + 4 + 2 resnets' and Transformer2Ds' down, 4 + 1 mid, 6 + 3 +
# 6 + 3 + 6 up, conv_norm_out) + 39 GarmentNet (no plain up block, no
# conv_norm_out); 3x3 convs with Cin, Cout >= 128: 36 + 30 (conv_in and
# conv_out stay plain); flash_attention_gemm at every self-attention site,
# 70 + 70. TP=2 (``parallel/tp.py``): the 640-wide level keeps 5 heads a
# rank (H*D = 320, not a multiple of 128), so its 10 + 10 self-attention
# sites take flash_attention (over 3072 own [+ 3072 garment] keys) and its
# to_qkv (N = 960) and to_q (N = 320) leave ln_linear (N % 128 != 0): 320
# ln_linear (TryonNet 60 x 3 + 10, GarmentNet 60 x 2 + 10), 120
# flash_attention_gemm, 20 flash_attention; GroupNorm and convs are
# replicated. SP=2 (``parallel/sp.py``): every conv runs on its 64 + 2 (32
# + 2, 16 + 2) rows, GroupNorm on local rows (>= 64 positions everywhere),
# and self-attention gathers K / V and runs flash_attention at all 140
# sites.
PARALLEL_STEP = {
    "single": {"ln_linear": 350, "fused_layer_norm": 70,
               "gn_spatial_stats": 85, "gn_apply": 85, "conv3x3": 66,
               "flash_attention_gemm": 140},
    "tp": {"ln_linear": 320, "fused_layer_norm": 70, "gn_spatial_stats": 85,
           "gn_apply": 85, "conv3x3": 66, "flash_attention_gemm": 120,
           "flash_attention": 20},
    "sp": {"ln_linear": 350, "fused_layer_norm": 70, "gn_spatial_stats": 85,
           "gn_apply": 85, "conv3x3": 66, "flash_attention": 140},
}
# (max rel, mean rel) of the gathered TP=2 / SP=2 guided noise prediction
# against the single-process impl="cuda" step on the same inputs: the tiny
# UNets' (bf16 partial sums reduced in another order, other kernel routes
# at the split widths), and the full width's at 2x the max and 1.3x the
# mean of its first reading on an H100 (TP max rel 2.94e-2, mean rel
# 2.68e-2; SP 2.84e-2 / 2.71e-2): a dropped bias or LayerNorm shift or a
# lost garment K/V falls outside
PARALLEL_TOLS = {"tiny": (0.1, 5e-2), "full": (6e-2, 3.5e-2)}


def test_two_ranks_tp_sp_step_match_single_process(two_ranks):
    """The CFG denoise step (the tiny UNets at 16x16 latents, or at full
    width) under TP=2 and SP=2 against the single-process impl="cuda" step
    on each rank: finite and within ``PARALLEL_TOLS``; SP and TP run
    kernels (their launches are counted), at full width each rank exactly
    ``PARALLEL_STEP``'s."""
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    width, ranks = two_ranks
    max_tol, mean_tol = PARALLEL_TOLS[width]
    for r in ranks:
        d = r["denoise"]
        for mode in ("tp", "sp"):
            mx, mean = d[f"{mode}_err"]
            assert mx <= max_tol and mean <= mean_tol, (mode, mx, mean)
            assert sum(d[mode].values()) > 0, mode
        if width == "full":
            for mode, want in PARALLEL_STEP.items():
                want = dict(dict.fromkeys(launch_counters(), 0), **want)
                assert d[mode] == want, (mode, d[mode])
    if width == "full":
        torch_card.record("tp", ranks[0]["denoise"]["tp"])
        torch_card.record("sp", ranks[0]["denoise"]["sp"])


def test_two_ranks_zero1_micro_step_matches_one_rank(dev, two_ranks):
    """The micro stack's dp=2 adamw step, replicated and ZeRO-1, against
    one rank on the card: the loss within 1e-5 relative, the masters within
    1e-5 where the gradient is above 1e-3 of its leaf's largest (else
    within 3e-5: a first Adam step may flip there); ZeRO-1 holds at most
    half the moments a rank."""
    from idmvton_tpu_torch.parallel.onecard import _host, micro_step
    torch.backends.cudnn.allow_tf32 = False
    one = _host(*micro_step(dev, 7))
    for r in two_ranks[1]:
        for mode in ("replicated", "zero1"):
            _assert_micro_close(r["train"][mode], one, one["mu"])
        assert r["train"]["zero1"]["moment_bytes"] <= 0.5 * one["moment_bytes"]


def _assert_micro_close(got, one, mu):
    """A dp=2 micro step against one rank's: the loss within 1e-5
    relative, the masters within 1e-5 where the gradient (adamw's first
    moment ``mu``) is above 1e-3 of its leaf's largest, else within 3e-5
    (Adam's first step is lr * g / |g|: such an entry may flip its step's
    sign), and at most 1e-3 of all entries flipped."""
    import numpy as np
    assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    flips = total = 0
    for k, w in one["params"].items():
        err = np.abs(got["params"][k] - w)
        tiny = np.abs(mu[k]) < 1e-3 * np.abs(mu[k]).max()
        assert (err[~tiny] <= 1e-5).all() and (err[tiny] <= 3e-5).all(), k
        flips += int((err[tiny] > 1e-5).sum())
        total += err.size
    assert flips <= 1e-3 * total, (flips, total)


def test_two_ranks_zero1_adamw8bit_step_matches_one_rank(dev, two_ranks):
    """The micro stack's dp=2 adamw8bit step with ZeRO-1 (each rank's half
    of the 1,344 blocks through the kernel inside ``Optimizer.update_``,
    then the masters' block all-gather) against one rank's adamw8bit step
    on the card, the kernel over every block: as close as the adamw case
    (the first step's direction comes from the unquantized moments); one
    launch a rank, and each rank's state half the blocks."""
    from idmvton_tpu_torch.parallel.onecard import _host, micro_step
    torch.backends.cudnn.allow_tf32 = False
    mu = _host(*micro_step(dev, 7))["mu"]
    one = _host(*micro_step(dev, 7, optimizer="adamw8bit"))
    for rank, r in enumerate(two_ranks[1]):
        got = r["train"]["zero1_adamw8bit"]
        _assert_micro_close(got, one, mu)
        assert got["blocks"] == (672 * rank, 672 * (rank + 1))
        assert got["launches"] == 1
        assert got["moment_bytes"] <= 0.5 * one["moment_bytes"]


def test_two_ranks_gpipe_is_bit_exact(two_ranks):
    """ViT (tiny, or ViT-H at full width) in 2 stages x 2 microbatches
    equals its sequential forward over the same microbatches bit for
    bit."""
    assert all(r["pipeline"]["equal"] for r in two_ranks[1])
