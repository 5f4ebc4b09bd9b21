"""The serving path's opt-in variants in the port against the JAX package's,
on the CPU: small-KV cross-attention (``IDMVTON_CROSS_KERNEL=1``), the
padded-accumulator conv (``IDMVTON_CONV_PADACC=1``) and W8A8 int8 serving
(both towers quantized, as ``bench.py``'s ``IDMVTON_GEMM_INT8=2``).

JAX runs its Pallas kernels in interpret mode, as tests/test_ops.py does;
the port runs the kernels' plain versions (what a CPU tensor takes). Inputs
and noises come from a numpy seed and go to both sides.

Tolerances: fp32 on both sides and the same formulas, other summation
orders: 1e-4 for the ops, 2e-4 through the tiny stack (2 denoise steps of
both UNets, tests/test_torch_pipeline.py's bound). The int8 quality bound is
JAX's own (tests/test_pipeline.py): SSIM of the quantized output against the
fp one > 0.75, and above the SSIM of another seed by 0.3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.models import attention as jatt
from idmvton_tpu.ops import pallas_attention, pallas_conv
from idmvton_tpu.ops import quant as jquant
from idmvton_tpu.pipeline import tryon as jtryon
from idmvton_tpu.utils.metrics import ssim
from idmvton_tpu_torch.models import attention as tattention
from idmvton_tpu_torch.models import layers as tlayers
from idmvton_tpu_torch.models.attention import (
    CrossAttention, FeedForward, quantize_unet_linears_int8,
)
from idmvton_tpu_torch.models.layers import quantize_linear_int8
from idmvton_tpu_torch.ops import cuda_attention, cuda_conv, cuda_norm
from idmvton_tpu_torch.pipeline import tryon as ttryon
from idmvton_tpu_torch.weights.from_jax import (
    load_jax_params, load_module_params,
)

ATOL = 1e-4
F32 = dict(dtype=torch.float32, device="cpu")
B, H, W, STEPS = 2, 32, 32, 2


def _np(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


class _Spy:
    """Wraps a function and counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


# ---------------------------------------------------------------------------
# small-KV cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,heads,d,ip,ip_scale", [
    (2, 192, 4, 32, False, 0.7), (2, 192, 4, 32, True, 0.7),
    (1, 200, 2, 64, True, 1.0)])
def test_cross_attention_small_kv_plain_matches_pallas(b, n, heads, d, ip,
                                                       ip_scale):
    hd = heads * d
    q, kv = _np(0, b, n, hd), _np(1, b, 77, 2 * hd)
    kv_ip = _np(2, b, 16, 2 * hd) if ip else None
    want = pallas_attention.cross_attention_small_kv(
        jnp.asarray(q), jnp.asarray(kv),
        None if kv_ip is None else jnp.asarray(kv_ip), heads=heads,
        ip_scale=ip_scale, block_q=128)
    got = cuda_attention.cross_attention_small_kv_torch(
        _t(q), _t(kv), None if kv_ip is None else _t(kv_ip), heads=heads,
        ip_scale=ip_scale)
    assert got.shape == (b, n, hd)
    _close(got, want)


def test_cross_attention_small_kv_supported_follows_the_switch(monkeypatch):
    """JAX's gate, read at call time, plus the kernel's head dims >= 16."""
    monkeypatch.delenv("IDMVTON_CROSS_KERNEL", raising=False)
    assert not cuda_attention.cross_attention_small_kv_supported(640, 10, 93)
    monkeypatch.setenv("IDMVTON_CROSS_KERNEL", "1")
    for inner, heads, s_kv in ((640, 10, 93), (1280, 20, 93), (128, 2, 1024),
                               (64, 4, 77), (96, 2, 77), (640, 10, 1025),
                               (256, 32, 77), (512, 2, 93)):
        want = (pallas_attention.cross_attention_small_kv_supported(
                    inner, heads, s_kv) and inner // heads >= 16)
        assert cuda_attention.cross_attention_small_kv_supported(
            inner, heads, s_kv) == want, (inner, heads, s_kv)
    assert cuda_attention.cross_attention_small_kv_supported(640, 10, 93)


@pytest.mark.parametrize("switch", ["1", "0"])
def test_cross_attention_module_small_kv_branch_matches_jax(monkeypatch,
                                                            switch):
    """Under the switch the CUDA impl of the port's CrossAttention takes the
    small-KV branch (JAX attention.py:170-187) and matches JAX's
    impl="pallas" (LN + to_q kernel, small-KV kernel, interpret); here the
    kernel wrappers are stood in for by their plain versions. The torch impl
    ignores the switch and matches JAX's impl="xla", as does the CUDA impl
    with the switch off."""
    monkeypatch.setenv("IDMVTON_CROSS_KERNEL", switch)
    heads, d = 2, 64
    inner = heads * d
    jp = jatt.init_attention(jax.random.PRNGKey(0), inner, context_dim=96,
                             heads=heads, head_dim=d, ip_adapter=True,
                             dtype=jnp.float32)
    jn = {"scale": jnp.asarray(_np(3, inner, scale=0.1, shift=1.0)),
          "bias": jnp.asarray(_np(4, inner, scale=0.1))}
    x, ctx = _np(5, 2, 160, inner), _np(6, 2, 77 + 16, 96)
    kw = dict(heads=heads, ip_num_tokens=16, ip_scale=0.6)
    mod = load_module_params(
        CrossAttention(inner, context_dim=96, heads=heads, head_dim=d,
                       ip_adapter=True, **F32), jax.tree.map(np.asarray, jp))
    norm = load_module_params(tlayers.Norm(inner, device="cpu"),
                              jax.tree.map(np.asarray, jn))
    spy = _Spy(cuda_attention.cross_attention_small_kv_torch)
    monkeypatch.setattr(tattention, "cross_attention_small_kv", spy)
    monkeypatch.setattr(tattention, "ln_linear", cuda_norm.ln_linear_torch)
    for impl, jimpl, calls in (("cuda", "pallas", int(switch == "1")),
                               ("torch", "xla", 0)):
        want = jatt.cross_attention(jp, jnp.asarray(x), jnp.asarray(ctx),
                                    norm=jn, impl=jimpl, **kw)
        spy.calls = 0
        got = mod(_t(x), _t(ctx), ip_num_tokens=16, ip_scale=0.6, norm=norm,
                  impl=impl)
        assert spy.calls == calls, impl
        _close(got, want, tol=2e-4)


# ---------------------------------------------------------------------------
# padded-accumulator conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,cout,bias", [((2, 8, 8, 128), 128, True),
                                             ((1, 6, 16, 256), 384, False)])
def test_conv3x3_plain_matches_pallas_padacc(monkeypatch, shape, cout, bias):
    monkeypatch.setenv("IDMVTON_CONV_PADACC", "1")
    spy = _Spy(pallas_conv._conv3_kernel_padacc)
    monkeypatch.setattr(pallas_conv, "_conv3_kernel_padacc", spy)
    x = _np(7, *shape)
    w = _np(8, 3, 3, shape[-1], cout, scale=(9 * shape[-1]) ** -0.5)
    b = _np(9, cout) if bias else None
    assert pallas_conv.conv3x3_supported(jnp.asarray(x), jnp.asarray(w))
    want = pallas_conv.conv3x3(jnp.asarray(x), jnp.asarray(w),
                               None if b is None else jnp.asarray(b),
                               rows_target=64)
    assert spy.calls > 0     # the JAX side ran the padacc kernel
    got = cuda_conv.conv3x3_torch(_t(x), _t(w), None if b is None else _t(b))
    _close(got, want)


@pytest.mark.parametrize("switch", ["1", "0"])
def test_conv2d_routes_conv3x3_sites_to_padacc(monkeypatch, switch):
    """On the CUDA impl the switch swaps the conv3x3 sites, and only them,
    to conv3x3_padacc (as JAX swaps the kernel inside conv3x3); the
    conv3x3_hblock sites and the torch impl are unchanged."""
    monkeypatch.setenv("IDMVTON_CONV_PADACC", switch)
    calls = []
    for name in ("conv3x3", "conv3x3_padacc", "conv3x3_hblock"):
        monkeypatch.setattr(tlayers, name, lambda x, w, b=None, _n=name:
                            calls.append(_n) or cuda_conv.conv3x3_torch(x, w, b))
    conv = tlayers.Conv(128, 128, 3, **F32)
    conv.reset_parameters_(torch.Generator().manual_seed(0))
    small = _t(_np(10, 1, 8, 8, 128))
    big = torch.zeros(1, 256, 256, 128)  # 32 MiB per image: the hblock rule
    want = cuda_conv.conv3x3_torch(small, conv.kernel, conv.bias)
    assert torch.equal(tlayers.conv2d(conv, small, impl="cuda"), want)
    tlayers.conv2d(conv, big, impl="cuda")
    assert torch.equal(tlayers.conv2d(conv, small), want)
    first = "conv3x3_padacc" if switch == "1" else "conv3x3"
    assert calls == [first, "conv3x3_hblock"]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_conv.conv3x3_padacc(small, conv.kernel)


# ---------------------------------------------------------------------------
# W8A8 sites in the modules
# ---------------------------------------------------------------------------


def test_quantized_sites_reach_the_w8a8_kernel(monkeypatch):
    """On the CUDA impl a quantized to_qkv / ff.proj_in under a fused
    LayerNorm goes to ln_linear_i8 with its int8 weight and scales (the W8A8
    kernel), an unquantized one to ln_linear with its bf16 weight; on the
    torch impl the dequantized product runs, equal to the unquantized module
    on the dequantized weight."""
    seen = []

    def fake(name):
        def run(x, gamma, beta, w, *rest, geglu=False):
            seen.append((name, w.dtype, geglu))
            return torch.zeros(*x.shape[:-1],
                               w.shape[1] // (2 if geglu else 1))
        return run

    monkeypatch.setattr(tattention, "ln_linear", fake("ln_linear"))
    monkeypatch.setattr(tattention, "ln_linear_i8", fake("ln_linear_i8"))
    gen = torch.Generator().manual_seed(0)
    ff = FeedForward(128, **F32)
    tlayers.reset_parameters_(ff, gen)
    norm = tlayers.Norm(128, device="cpu")
    tlayers.reset_parameters_(norm, gen)
    x = _t(_np(11, 2, 10, 128))
    ff(x, norm=norm, impl="cuda")
    plain = FeedForward(128, **F32)
    plain.proj_out = ff.proj_out
    ff.proj_in = quantize_linear_int8(ff.proj_in)
    plain.proj_in.kernel.copy_(ff.proj_in.dequantized(torch.float32).kernel)
    plain.proj_in.bias.copy_(ff.proj_in.bias)
    ff(x, norm=norm, impl="cuda")
    assert seen == [("ln_linear", torch.float32, True),
                    ("ln_linear_i8", torch.int8, True)]
    _close(ff(x, norm=norm), plain(x, norm=norm), tol=1e-6)


# ---------------------------------------------------------------------------
# the tiny stack, both towers quantized (bench.py IDMVTON_GEMM_INT8=2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_stacks():
    jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32)
    jp = jm.params()
    jq = dict(jp, unet=jquant.quantize_unet_linears_int8(jp["unet"]),
              garm=jquant.quantize_unet_linears_int8(jp["garm"],
                                                     attn_qkv=False))
    tm = ttryon.TryonModels.init(None, tiny=True, dtype=torch.float32,
                                 device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    tq = ttryon.TryonModels.init(None, tiny=True, dtype=torch.float32,
                                 device="cpu")
    quantize_unet_linears_int8(tq.unet)
    quantize_unet_linears_int8(tq.garm, attn_qkv=False)
    load_jax_params(tq, jax.tree.map(np.asarray, jq))
    return jm, jq, tm, tq


def _inputs(b, vocab, isz, seed=0):
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    ids = lambda: rng.integers(0, vocab, (b, 7))
    mask = np.zeros((b, H, W, 1), np.float32)
    mask[:, 6:26, 4:20] = 1.0
    return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids(),
                ip_pixels=rng.uniform(-1, 1, (b, isz, isz, 3))
                .astype(np.float32))


def test_int8_stepwise_generate_matches_jax(int8_stacks):
    """The port's torch impl (weight-only dequantized products) against
    JAX's XLA impl on the same quantized trees, noises and inputs."""
    jm, jq, _, tq = int8_stacks
    inputs = _inputs(B, jm.clip_l_cfg.vocab_size, jm.vision_cfg.image_size)
    rng = np.random.default_rng(1)
    lat = (B, H // 8, W // 8, 4)
    init_noise = rng.standard_normal(lat).astype(np.float32)
    step_noise = rng.standard_normal((STEPS,) + lat).astype(np.float32)
    want = jtryon.TryonPipeline(jm).stepwise_generate(
        num_steps=STEPS, vae_sample=False, impl="xla")(
        jq, jax.random.PRNGKey(2), init_noise=jnp.asarray(init_noise),
        step_noise=jnp.asarray(step_noise),
        **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = ttryon.TryonPipeline(tq).stepwise_generate(
        num_steps=STEPS, vae_sample=False, impl="torch")(
        torch.Generator().manual_seed(2), init_noise=_t(init_noise),
        step_noise=_t(step_noise),
        **{k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.shape == (B, H, W, 3) and bool(torch.isfinite(got).all())
    _close(got, want, tol=2e-4)


def test_int8_quality_bound(int8_stacks):
    """JAX's int8 quality statement (tests/test_pipeline.py), on the port:
    generation with both towers quantized stays far closer to the fp output
    than another seed does."""
    jm, _, tm, tq = int8_stacks
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(
        1, jm.clip_l_cfg.vocab_size, jm.vision_cfg.image_size, 3).items()}

    def gen(models, seed):
        fn = ttryon.TryonPipeline(models).stepwise_generate(
            num_steps=3, vae_sample=False)
        return jnp.asarray(fn(torch.Generator().manual_seed(seed),
                              **inputs).numpy())

    fp, q, other = gen(tm, 1), gen(tq, 1), gen(tm, 2)
    s_q, s_other = float(ssim(fp, q)), float(ssim(fp, other))
    assert s_q > 0.75, s_q
    assert s_q > s_other + 0.3, (s_q, s_other)
