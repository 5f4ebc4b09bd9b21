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
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

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
The conv kernel on an fp32 x narrows x to bf16 and multiplies by the bf16
weights with fp32 accumulation (the TPU kernel's DEFAULT precision): against
the plain version in full fp32 (``torch.backends.cudnn.allow_tf32 = False``,
set here) it differs by x's bf16 rounding, within the bf16 bound; against
the plain version fed the bf16-rounded x it differs only in summation
order, max |diff| <= 1e-4 * max |plain| (K up to 9 * 2560 fp32 terms).
"""

import pytest
import torch

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
# UNet's 128-wide level, and ragged M (a 128-row block past the rows)
LN_PATH = [((4, 3072), 640, 1920, False), ((4, 3072), 640, 640, False),
           ((4, 3072), 640, 2560, True), ((4, 768), 1280, 3840, False),
           ((4, 768), 1280, 1280, False), ((4, 768), 1280, 5120, True),
           ((2, 3072), 640, 640, False), ((2, 3072), 640, 2560, True),
           ((2, 768), 1280, 1280, False), ((2, 768), 1280, 5120, True),
           ((4, 768), 128, 384, False), ((4, 768), 128, 128, False),
           ((4, 768), 128, 512, True), ((2, 768), 128, 512, True),
           ((3, 1000), 640, 1920, False), ((1, 1500), 1280, 5120, True)]


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
                                    (6144, 640), (1536, 1280)])
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
    ((1, 64, 48, 2560), torch.bfloat16), ((2, 5, 7, 10), torch.float32)])
def test_gn_stats_kernel(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    x = _randn(g, *shape, dev=dev, dtype=dtype) + 0.3
    s1, s2 = cuda_norm.gn_spatial_stats(x)
    r1, r2 = cuda_norm.gn_spatial_stats_torch(x)
    torch.cuda.synchronize()
    scale = float(r2.abs().max())
    assert float((s1 - r1).abs().max()) <= SUM_TOL * scale
    assert float((s2 - r2).abs().max()) <= SUM_TOL * scale


@pytest.mark.parametrize("b,h,w,cin,cout,bias", [
    (2, 10, 12, 128, 256, True), (1, 16, 8, 320, 320, True),
    (3, 7, 9, 256, 128, False), (2, 32, 24, 640, 1280, True),
    # the wgmma kernel's edges: Cout 320 (160-wide N tiles), 15 and 40
    # 64-channel chunks a tap, the 32x24 level at batch 4, H and W off the
    # 16 x 8 tile, a ragged last K chunk (Cin 160)
    (1, 16, 24, 320, 320, True), (1, 16, 24, 960, 320, True),
    (1, 8, 24, 2560, 1280, True), (4, 32, 24, 1280, 1280, True),
    (2, 19, 27, 320, 640, True), (1, 12, 16, 160, 128, False)])
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


def test_vae_decode_fp32_runs_the_conv_kernels(dev):
    """VAEConfig.force_upcast: the decode runs in fp32 through the conv and
    GroupNorm statistics kernels, against the plain decode of the same
    module on the CPU (each conv rounds its input to bf16: the bf16
    bound)."""
    import copy
    import dataclasses
    from idmvton_tpu_torch.core.config import VAEConfig
    from idmvton_tpu_torch.models.layers import reset_parameters_
    from idmvton_tpu_torch.models.vae import VAE
    cfg = dataclasses.replace(VAEConfig.tiny(), force_upcast=True)
    vae = VAE(cfg, dtype=torch.bfloat16, device=dev)
    reset_parameters_(vae, torch.Generator(device=dev).manual_seed(15))
    g = torch.Generator(device=dev).manual_seed(16)
    z = _randn(g, 2, 32, 24, cfg.latent_channels, dev=dev)
    counts = (cuda_conv.conv3x3.launches,
              cuda_norm.gn_spatial_stats.launches)
    got = vae.decode(z)
    torch.cuda.synchronize()
    assert cuda_conv.conv3x3.launches > counts[0]
    assert cuda_norm.gn_spatial_stats.launches > counts[1]
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
# GarmentNet at the 640 and 1280 levels), every row uncond, and the tiny
# UNet's 128-wide level (8 heads of 16)
@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("b,n,heads,d,garment,uncond", [
    (4, 3072, 10, 64, True, 2), (4, 768, 20, 64, True, 2),
    (2, 3072, 10, 64, False, 0), (2, 768, 20, 64, False, 0),
    (4, 768, 20, 64, True, 4), (4, 768, 8, 16, True, 2)])
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
    assert not rep["fixed_shift"] and not cuda_attention._fixed_shift()
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
    (4, 3072, 4, 16, 3072), (2, 3072, 4, 16, 0)])
def test_flash_attention_tiny_path_shapes(dev, b, sq, heads, d, m, scale):
    """The tiny UNet's 64-wide level: the split heads of a to_qkv output
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
    (12, 640, 1920, False, False)])
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
    (4, 32, 24, 1280, 1280, True), (1, 12, 16, 160, 128, False)])
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


@pytest.mark.parametrize("d", [8, 16, 64, 128])
@pytest.mark.parametrize("st,s_own", [(384, 300), (6144, 3072), (70, 70)])
def test_flash_attention_fused_qkv_kernel(dev, d, st, s_own):
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = _randn(g, 2, st, 3, 4, d, dev=dev, scale=1.5)
    before = cuda_attention.flash_attention_fused_qkv.launches
    got = cuda_attention.flash_attention_fused_qkv(qkv, s_own, scale=0.3)
    want = cuda_attention.flash_attention_fused_qkv_torch(qkv, s_own,
                                                          scale=0.3)
    torch.cuda.synchronize()
    assert got.shape == (2, s_own, 4, d)
    assert cuda_attention.flash_attention_fused_qkv.launches == before + 1
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
    from idmvton_tpu_torch.pipeline.graph import launch_counters
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
