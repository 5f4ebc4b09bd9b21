"""The PyTorch port's ops against the JAX package's, on the CPU.

For each TPU kernel the port hand-writes for Hopper, the port's plain
PyTorch version (what a CPU tensor runs, and what the CUDA kernel is held
to on the card, see tests/test_torch_cuda.py) is compared with the JAX
function run as tests/test_ops.py runs it: the Pallas kernel in interpret
mode. Inputs come from a numpy seed and are fed to both sides; everything
runs in fp32, where the point is the algorithm.

Tolerances: both sides compute the same fp32 formula and differ only in
summation order (and, for GEGLU, the TPU kernel's erf approximation, 1.5e-7
absolute), so max abs error <= 1e-4 at O(1) outputs; the GroupNorm sums
over ~100 rows are held to 1e-4 relative.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import attention as jattn
from idmvton_tpu.ops import pallas_attention, pallas_conv, pallas_norm
from idmvton_tpu_torch.models import layers as tlayers
from idmvton_tpu_torch.ops import _build, cuda_attention, cuda_conv, cuda_norm
from idmvton_tpu_torch.ops import attention as tattn
from idmvton_tpu_torch.ops.dispatch import resolve

ATOL = 1e-4


def _np(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("geglu,bias", [(False, True), (True, True),
                                        (False, False)])
def test_ln_linear_plain_matches_pallas(geglu, bias):
    c, n = 128, 256
    x = _np(0, 2, 96, c, scale=2.0, shift=0.5)
    gamma, beta = _np(1, c, scale=0.1, shift=1.0), _np(2, c, scale=0.1)
    w = _np(3, c, (2 if geglu else 1) * n, scale=c ** -0.5)
    b = _np(4, w.shape[1]) if bias else None
    proj = {"kernel": jnp.asarray(w)}
    if bias:
        proj["bias"] = jnp.asarray(b)
    assert pallas_norm.ln_linear_supported(jnp.asarray(x), proj["kernel"],
                                           geglu=geglu)
    want = pallas_norm.ln_linear(
        jnp.asarray(x), {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
        proj, geglu=geglu)
    got = cuda_norm.ln_linear_torch(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        geglu=geglu)
    assert got.shape == want.shape
    _close(got, want)


def test_fused_layer_norm_plain_matches_pallas():
    x = _np(5, 3, 50, 256, scale=3.0, shift=-1.0)
    s, b = _np(6, 256), _np(7, 256)
    want = pallas_norm.fused_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(b))
    got = cuda_norm.layer_norm_torch(torch.from_numpy(x), torch.from_numpy(s),
                                     torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 9, 13, 128), (3, 70, 320)])
def test_gn_spatial_stats_plain_matches_pallas(shape):
    x = _np(8, *shape, shift=0.3)
    w1, w2 = pallas_norm.gn_spatial_stats(jnp.asarray(x))
    g1, g2 = cuda_norm.gn_spatial_stats_torch(torch.from_numpy(x))
    _close(g1, w1, atol=1e-3)
    _close(g2, w2, atol=1e-3)


def _old_group_norm_tail(x, mean_c, mean2_c, p, g, eps, act):
    """``models/layers.py::group_norm`` after its statistics, as it stood
    before the tail moved into ``cuda_norm.gn_apply_torch``."""
    import torch.nn.functional as F
    b, c = x.shape[0], x.shape[-1]
    gmean = mean_c.reshape(b, g, c // g).mean(-1)
    gmean2 = mean2_c.reshape(b, g, c // g).mean(-1)
    inv = torch.rsqrt((gmean2 - gmean.square()).clamp_min(0.0) + eps)
    inv_c = inv.repeat_interleave(c // g, dim=-1)
    mean_bc = gmean.repeat_interleave(c // g, dim=-1)
    w = inv_c * p.scale.float()[None]
    shift = p.bias.float()[None] - mean_bc * w
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    xf = x.float() * w.reshape(shape)
    xf.add_(shift.reshape(shape))
    if act == "silu":
        F.silu(xf, inplace=True)
    return xf.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups,act,eps", [
    ((2, 8, 6, 32), 8, "silu", 1e-5), ((3, 20, 40), 4, None, 1e-6),
    ((1, 5, 3, 2, 12), 12, "silu", 1e-6)])
def test_gn_apply_plain_is_the_old_tail(shape, groups, act, eps, dtype):
    """``gn_apply_torch`` (the tail ``group_norm`` hands the means to)
    gives the old inline tail's bits, with SiLU on and off, for bf16 and
    fp32 x."""
    c = shape[-1]
    x = torch.from_numpy(_np(12, *shape, scale=2.0, shift=0.7)).to(dtype)
    norm = tlayers.Norm(c, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(_np(13, c, shift=1.0)))
        norm.bias.copy_(torch.from_numpy(_np(14, c)))
    xf = x.float().reshape(shape[0], -1, c)
    mean_c, mean2_c = xf.mean(1), xf.square().mean(1)
    want = _old_group_norm_tail(x, mean_c, mean2_c, norm, groups, eps, act)
    got = cuda_norm.gn_apply_torch(x, mean_c, mean2_c, norm.scale.float(),
                                   norm.bias.float(), num_groups=groups,
                                   eps=eps, silu=act == "silu")
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(tlayers.group_norm(norm, x, num_groups=groups,
                                          eps=eps, act=act), want)


@pytest.mark.parametrize("variant", ["conv3x3", "conv3x3_hblock"])
@pytest.mark.parametrize("cout,bias", [(128, True), (256, False)])
def test_conv3x3_plain_matches_pallas(variant, cout, bias):
    x = _np(9, 2, 10, 12, 128)
    w = _np(10, 3, 3, 128, cout, scale=(9 * 128) ** -0.5)
    b = _np(11, cout) if bias else None
    jfn = getattr(pallas_conv, variant)
    assert getattr(pallas_conv, variant + "_supported")(jnp.asarray(x),
                                                        jnp.asarray(w))
    want = jfn(jnp.asarray(x), jnp.asarray(w),
               None if b is None else jnp.asarray(b))
    got = cuda_conv.conv3x3_torch(torch.from_numpy(x), torch.from_numpy(w),
                                  None if b is None else torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("garment,uncond,sink,fixed", [
    (False, 0, 0, True), (True, 2, 0, True), (True, 2, 3, False),
    (True, 0, 0, False), (False, 0, 4, True)])
def test_flash_attention_gemm_plain_matches_pallas(monkeypatch, garment,
                                                   uncond, sink, fixed):
    monkeypatch.setenv("IDMVTON_FLASH_FIXED_SHIFT", "1" if fixed else "0")
    b, n, m, heads, d = 4, 200, 150, 2, 64
    qkv = _np(12, b, n, 3 * heads * d)
    kv = _np(13, b - uncond, m, 2 * heads * d) if garment else None
    want = pallas_attention.flash_attention_gemm(
        jnp.asarray(qkv), None if kv is None else jnp.asarray(kv),
        heads=heads, sink_tokens=sink, uncond_rows=uncond)
    got = cuda_attention.flash_attention_gemm_torch(
        torch.from_numpy(qkv), None if kv is None else torch.from_numpy(kv),
        heads=heads, sink_tokens=sink, uncond_rows=uncond)
    assert got.shape == (b, n, heads * d)
    _close(got, want)
    assert cuda_attention.flash_attention_gemm_supported(
        torch.zeros(1, 1, 3 * heads * d, dtype=torch.bfloat16), heads)


def test_flash_attention_gemm_plain_is_the_oracle():
    """The plain version is the JAX oracle _gemm_ref_xla (explicit zero
    garment KV for the uncond rows, explicit sink tokens)."""
    qkv, kv = _np(14, 4, 40, 3 * 64), _np(15, 2, 30, 2 * 64)
    want = pallas_attention._gemm_ref_xla(jnp.asarray(qkv), jnp.asarray(kv),
                                          2, 32 ** -0.5, 3, 2)
    got = cuda_attention.flash_attention_gemm_torch(
        torch.from_numpy(qkv), torch.from_numpy(kv), heads=2, sink_tokens=3,
        uncond_rows=2)
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("op", ["sdpa", "concat_kv", "decoupled_ip"])
def test_attention_ops_match_jax(op):
    q, k, v = _np(16, 2, 30, 3, 16), _np(17, 2, 77, 3, 16), _np(18, 2, 77, 3, 16)
    k2, v2 = _np(19, 2, 16, 3, 16), _np(20, 2, 16, 3, 16)
    J = [jnp.asarray(a) for a in (q, k, v, k2, v2)]
    T = [torch.from_numpy(a) for a in (q, k, v, k2, v2)]
    if op == "sdpa":
        want, got = jattn.sdpa(*J[:3], impl="xla"), tattn.sdpa(*T[:3])
    elif op == "concat_kv":
        want = jattn.concat_kv_attention(*J, impl="xla")
        got = tattn.concat_kv_attention(*T)
    else:
        want = jattn.decoupled_ip_attention(*J, ip_scale=0.7)
        got = tattn.decoupled_ip_attention(*T, ip_scale=0.7)
    _close(got, want, atol=1e-5, rtol=1e-5)


def test_dispatch_follows_the_tensor():
    assert resolve(None, torch.zeros(1)) == "torch"
    assert resolve("cuda", torch.zeros(1)) == "cuda"
    with pytest.raises(ValueError):
        resolve("pallas", torch.zeros(1))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; on a CPU tensor it raises
    before anything is built (the sites take the plain version there)."""
    x = torch.zeros(2, 16, 128, dtype=torch.bfloat16)
    w = torch.zeros(128, 128, dtype=torch.bfloat16)
    g = torch.ones(128)
    calls = [
        lambda: cuda_norm.fused_layer_norm(x, g, g),
        lambda: cuda_norm.ln_linear(x, g, g, w),
        lambda: cuda_norm.gn_spatial_stats(x),
        lambda: cuda_norm.gn_apply(x, g[None].expand(2, 128).contiguous(),
                                   g[None].expand(2, 128).contiguous(), g, g,
                                   num_groups=32),
        lambda: cuda_conv.conv3x3(x.reshape(2, 4, 4, 128),
                                  w.reshape(1, 1, 128, 128).expand(
                                      3, 3, 128, 128).contiguous()),
        lambda: cuda_attention.flash_attention_gemm(
            torch.zeros(2, 16, 384, dtype=torch.bfloat16), heads=2),
        lambda: cuda_norm.ln_linear_i8(x, g, g, w.to(torch.int8), g),
        lambda: cuda_attention.cross_attention_small_kv(
            x, torch.zeros(2, 77, 256, dtype=torch.bfloat16), heads=2),
        lambda: cuda_conv.conv3x3_padacc(x.reshape(2, 4, 4, 128),
                                         w.reshape(1, 1, 128, 128).expand(
                                             3, 3, 128, 128).contiguous()),
        lambda: cuda_attention.flash_attention(
            *(torch.zeros(1, 300, 2, 16, dtype=torch.bfloat16),) * 3),
        lambda: cuda_attention.flash_attention_fused_qkv(
            torch.zeros(1, 300, 3, 2, 16, dtype=torch.bfloat16), 100),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    # a forced "cuda" impl on a CPU tensor reaches the kernel and raises
    conv = tlayers.Conv(128, 128, 3, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tlayers.conv2d(conv, torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16),
                       impl="cuda")


def test_c_entry_points_match_the_bindings():
    """Each argtypes list in _build.SIGNATURES has the arity of its
    ``extern "C"`` definition in csrc/ (the build itself only runs on a
    host with nvcc)."""
    defs = {}
    for name in _build.SOURCES:
        src = (_build.CSRC / name).read_text()
        for fn, args in re.findall(r'extern "C" int (idm_\w+)\(([^)]*)\)',
                                   src):
            defs[fn] = len([a for a in args.split(",") if a.strip()])
    assert set(defs) == set(_build.SIGNATURES)
    for fn, argtypes in _build.SIGNATURES.items():
        assert defs[fn] == len(argtypes), fn
    assert all((_build.CSRC / h).exists() for h in _build.HEADERS)
