"""The port's int8 serving pieces against the JAX package's, on the CPU.

``ops/quant.py`` with ``QuantLinear`` and ``quantize_unet_linears_int8``
(weight quantization), the ``QuantLinear`` loading path and
the W8A8 kernel's plain version ``ln_linear_i8_torch``. JAX runs the Pallas
int8 kernel in interpret mode, as tests/test_ops.py does; inputs come from a
numpy seed and go to both sides.

Tolerances: the quantized codes and scales are compared bit for bit (the
same fp32 arithmetic, round half to even on both sides). Networks with
quantized weights run in fp32 and differ from JAX only in summation order:
2e-4, as tests/test_torch_models.py. The W8A8 plain version and the Pallas
kernel sum the same int8 products exactly; they differ where an fp32
LayerNorm rounding flips a code (one step of a row's 1/127 scale) and in
the Pallas kernel's erf approximation (1.5e-7): 1e-2 of max |want|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.core import config as jcfg
from idmvton_tpu.models import unet as junet
from idmvton_tpu.ops import pallas_norm
from idmvton_tpu.ops import quant as jquant
from idmvton_tpu_torch.core import config as tcfg
from idmvton_tpu_torch.models import attention as tattention
from idmvton_tpu_torch.models.attention import quantize_unet_linears_int8
from idmvton_tpu_torch.models.layers import (
    Linear, Norm, QuantLinear, quantize_linear_int8,
)
from idmvton_tpu_torch.models.unet import UNet
from idmvton_tpu_torch.ops import cuda_norm
from idmvton_tpu_torch.ops.quant import (
    dequantize_kernel_int8, quantize_kernel_int8,
)
from idmvton_tpu_torch.weights.from_jax import load_module_params

TOL = 2e-4
F32 = dict(dtype=torch.float32, device="cpu")


def _np(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_linear_int8_matches_jax_bit_for_bit(dtype):
    w = _np(0, 96, 200, scale=0.3)
    # a column whose scale is exactly 1: ties at .5 round half to even
    w[:, 0] = 0.0
    w[:6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    b = _np(1, 200)
    jtree = {"kernel": jnp.asarray(w).astype(getattr(jnp, dtype)),
             "bias": jnp.asarray(b).astype(getattr(jnp, dtype))}
    want = jquant.quantize_linear_int8(jtree)
    lin = load_module_params(
        Linear(96, 200, dtype=getattr(torch, dtype), device="cpu"),
        jax.tree.map(np.asarray, jtree))
    got = quantize_linear_int8(lin)
    assert isinstance(got, QuantLinear) and got.bias is lin.bias
    assert got.kernel_i8.dtype == torch.int8
    np.testing.assert_array_equal(got.kernel_i8.numpy(),
                                  np.asarray(want["kernel_i8"]))
    np.testing.assert_array_equal(got.kernel_scale.numpy(),
                                  np.asarray(want["kernel_scale"]))
    assert got.kernel_i8[:6, 0].tolist() == [127, 0, 2, 2, 0, -2]
    assert lin.dequantized(torch.float32) is lin
    # the dequantized view is JAX's dequantize_int8
    dq = pallas_norm.dequantize_int8(want, jnp.float32)
    _close(got.dequantized(torch.float32).kernel, dq["kernel"], tol=0)


@pytest.fixture(scope="module", params=[("consume", True), ("emit", False)],
                ids=["tryon", "garment"])
def quantized_unets(request):
    """A JAX tiny UNet, quantized as bench.py's mode 2 quantizes that tower,
    and the port's UNet quantized the same way in place."""
    mode, attn_qkv = request.param
    jp = junet.init_unet(jax.random.PRNGKey(0), jcfg.UNetConfig.tiny(mode),
                         dtype=jnp.float32)
    jq = jquant.quantize_unet_linears_int8(jp, attn_qkv=attn_qkv)
    tu = load_module_params(UNet(tcfg.UNetConfig.tiny(mode), **F32),
                            jax.tree.map(np.asarray, jp))
    quantize_unet_linears_int8(tu, attn_qkv=attn_qkv)
    return mode, attn_qkv, jq, tu


def test_quantize_unet_linears_int8_hits_the_jax_sites(quantized_unets):
    """The same leaves, names and shapes as the quantized JAX tree, and the
    same codes and scales in each of them."""
    mode, attn_qkv, jq, tu = quantized_unets
    want = _flat(jq)
    got = {n: p.detach().numpy() for n, p in tu.named_parameters()}
    assert set(got) == set(want)
    sites = sorted(n for n in want if n.endswith("kernel_i8"))
    assert sites and all(".ff.proj_in." in n or ".attn1.to_qkv." in n
                         for n in sites)
    assert any(".attn1.to_qkv." in n for n in sites) == attn_qkv
    for n in sites:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        sc = n.replace("kernel_i8", "kernel_scale")
        np.testing.assert_array_equal(got[sc], want[sc], err_msg=sc)


def test_quantized_tree_loads_and_runs_like_jax(quantized_unets):
    """A JAX-quantized tree fills a port UNet quantized beforehand, and the
    quantized forward (weight-only dequantized products: the port's torch
    impl, JAX's XLA impl) matches JAX."""
    mode, attn_qkv, jq, _ = quantized_unets
    cfg = tcfg.UNetConfig.tiny(mode)
    tu = quantize_unet_linears_int8(UNet(cfg, **F32), attn_qkv=attn_qkv)
    load_module_params(tu, jax.tree.map(np.asarray, jq))
    jc = jcfg.UNetConfig.tiny(mode)
    if mode == "emit":
        x, ctx = _np(2, 2, 8, 8, 4), _np(3, 2, 7, cfg.cross_attention_dim)
        _, want = junet.unet_apply(jq, jc, jnp.asarray(x), 500,
                                   jnp.asarray(ctx), impl="xla")
        _, got = tu(_t(x), 500, _t(ctx))
        assert len(got) == len(want) == cfg.num_garment_features
        for a, b in zip(got, want):
            _close(a, b)
        return
    x = _np(4, 2, 8, 8, 13)
    ctx = _np(5, 2, 7 + cfg.ip_num_tokens, cfg.cross_attention_dim)
    feats = [_np(10 + i, 2, hw * hw, ch) for i, (hw, ch) in enumerate(
        [(4, 64)] * 2 + [(2, 128)] * 12 + [(4, 64)] * 3)]
    want, _ = junet.unet_apply(
        jq, jc, jnp.asarray(x), 500, jnp.asarray(ctx),
        garment_features=tuple(jnp.asarray(f) for f in feats), impl="xla")
    got, _ = tu(_t(x), 500, _t(ctx),
                garment_features=tuple(_t(f) for f in feats))
    _close(got, want)


def test_loader_checks_the_quantized_parameters():
    """Every parameter of a quantized module must be filled: an unquantized
    tree leaves kernel_i8 / kernel_scale empty and is refused, as is a
    quantized tree for an unquantized module."""
    lin = Linear(8, 16, **F32)
    tree = {"kernel": _np(6, 8, 16), "bias": _np(7, 16)}
    q = quantize_linear_int8(load_module_params(lin, tree))
    with pytest.raises(KeyError):
        load_module_params(q, tree)
    qtree = jax.tree.map(np.asarray, jquant.quantize_linear_int8(
        {k: jnp.asarray(v) for k, v in tree.items()}))
    with pytest.raises(KeyError):
        load_module_params(Linear(8, 16, **F32), qtree)
    with pytest.raises(KeyError, match="kernel_scale"):
        load_module_params(q, {k: v for k, v in qtree.items()
                               if k != "kernel_scale"})
    load_module_params(q, qtree)
    assert q.kernel_i8.dtype == torch.int8


def _i8_case(c, n, geglu, bias, seed=0):
    x = _np(seed, 2, 96, c, scale=1.7, shift=0.3)
    gamma = _np(seed + 1, c, scale=0.1, shift=1.0)
    beta = _np(seed + 2, c, scale=0.1)
    w = _np(seed + 3, c, n * (2 if geglu else 1), scale=c ** -0.5)
    proj = {"kernel": jnp.asarray(w)}
    if bias:
        proj["bias"] = jnp.linspace(-0.5, 0.5, w.shape[1]).astype(jnp.float32)
    return x, gamma, beta, proj


@pytest.mark.parametrize("c,n", [(128, 128), (128, 256), (256, 128),
                                 (256, 256)])
@pytest.mark.parametrize("geglu,bias", [(False, True), (True, True),
                                        (True, False)])
def test_ln_linear_i8_plain_matches_pallas(c, n, geglu, bias):
    x, gamma, beta, proj = _i8_case(c, n, geglu, bias)
    qproj = jquant.quantize_linear_int8(proj)
    assert pallas_norm.ln_linear_supported(jnp.asarray(x), qproj["kernel_i8"],
                                           geglu=geglu)
    norm = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    want = np.asarray(pallas_norm.ln_linear(jnp.asarray(x), norm, qproj,
                                            geglu=geglu), np.float32)
    b = qproj.get("bias")
    got = cuda_norm.ln_linear_i8_torch(
        _t(x), _t(gamma), _t(beta),
        torch.from_numpy(np.array(qproj["kernel_i8"])),
        _t(qproj["kernel_scale"]), None if b is None else _t(b), geglu=geglu)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-2 * scale
    # a real W8A8 path: activation quantization moves it off the fp path
    fp = np.asarray(pallas_norm.ln_linear(jnp.asarray(x), norm, proj,
                                          geglu=geglu), np.float32)
    assert np.abs(got.numpy() - fp).max() > 1e-4 * scale


def test_ln_linear_dispatches_quantized_projections():
    """A fused LN site dispatches an int8 projection as JAX's ln_linear:
    one the kernel does not take (C % 128 != 0) dequantizes and runs the
    plain LN -> GEMM; one it takes reaches the W8A8 kernel, which refuses a
    CPU tensor."""
    for c, supported in ((96, False), (128, True)):
        x, gamma, beta, proj = _i8_case(c, 128, True, True, seed=20)
        q = quantize_linear_int8(load_module_params(
            Linear(c, 256, **F32), jax.tree.map(np.asarray, proj)))
        norm = load_module_params(Norm(c, device="cpu"),
                                  {"scale": gamma, "bias": beta})
        if supported:
            with pytest.raises(ValueError, match="CUDA"):
                tattention._ln_proj(_t(x), norm, q, geglu=True, impl="cuda")
            continue
        got = tattention._ln_proj(_t(x), norm, q, geglu=True, impl="cuda")
        want = pallas_norm.ln_linear(
            jnp.asarray(x), {"scale": jnp.asarray(gamma),
                             "bias": jnp.asarray(beta)},
            jquant.quantize_linear_int8(proj), geglu=True)
        _close(got, want)


# ---------------------------------------------------------------------------
# the int8 weight layout: (C, N) codes stored (N, C), K-major for the W8A8
# kernel (csrc/ln_linear_i8.cu), with the JAX layout, keys and bits
# ---------------------------------------------------------------------------


def _k_major(t):
    return t.dtype == torch.int8 and t.dim() == 2 and t.t().is_contiguous()


@pytest.mark.parametrize("shape", [(96, 200), (640, 1920), (128, 8)])
def test_quantize_kernel_int8_layout_and_bits(shape):
    """The codes are the (C, N) view of (N, C) storage and still equal
    JAX's quantize_linear_int8 bit for bit, scales too."""
    w = _np(30, *shape, scale=0.2)
    want = jquant.quantize_linear_int8({"kernel": jnp.asarray(w)})
    codes, scale = quantize_kernel_int8(torch.from_numpy(w))
    assert codes.shape == shape and _k_major(codes)
    assert codes.stride() == (1, shape[0])
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(want["kernel_i8"]))
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(want["kernel_scale"]))
    # the dequantized weight is a contiguous (C, N) tensor, as before
    dq = dequantize_kernel_int8(codes, scale, torch.float32)
    assert dq.is_contiguous()
    _close(dq, pallas_norm.dequantize_int8(want, jnp.float32)["kernel"],
           tol=0)


def test_int8_layout_survives_to_quantize_and_load(quantized_unets):
    """quantize_unet_linears_int8 leaves every site K-major; so do a JAX
    quantized tree loaded into a quantized UNet (the loader's copy_) and
    Module.to, with the same (C, N) shapes, keys and values."""
    mode, attn_qkv, jq, tu = quantized_unets
    sites = {n: m for n, m in tu.named_modules() if isinstance(m, QuantLinear)}
    assert sites and all(_k_major(m.kernel_i8) for m in sites.values())
    loaded = quantize_unet_linears_int8(UNet(tcfg.UNetConfig.tiny(mode),
                                             **F32), attn_qkv=attn_qkv)
    load_module_params(loaded, jax.tree.map(np.asarray, jq))
    want = _flat(jq)
    for name, m in loaded.named_modules():
        if isinstance(m, QuantLinear):
            assert _k_major(m.kernel_i8), name
            np.testing.assert_array_equal(m.kernel_i8.numpy(),
                                          want[f"{name}.kernel_i8"])
    for target in (torch.float64, "meta"):
        moved = loaded.to(target)
        assert all(_k_major(m.kernel_i8) for m in moved.modules()
                   if isinstance(m, QuantLinear))


def test_load_jax_params_keeps_the_int8_layout():
    """load_jax_params of a quantized JAX tiny stack into a quantized port
    stack: each QuantLinear keeps its (C, N) shape over (N, C) storage and
    takes JAX's codes."""
    from idmvton_tpu.pipeline import tryon as jtryon
    from idmvton_tpu_torch.pipeline import tryon as ttryon
    from idmvton_tpu_torch.weights.from_jax import load_jax_params
    jp = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32).params()
    jq = dict(jp, unet=jquant.quantize_unet_linears_int8(jp["unet"]),
              garm=jquant.quantize_unet_linears_int8(jp["garm"],
                                                     attn_qkv=False))
    tq = ttryon.TryonModels.init(None, tiny=True, dtype=torch.float32,
                                 device="cpu")
    quantize_unet_linears_int8(tq.unet)
    quantize_unet_linears_int8(tq.garm, attn_qkv=False)
    load_jax_params(tq, jax.tree.map(np.asarray, jq))
    for tower in ("unet", "garm"):
        want = _flat(jq[tower])
        sites = [(n, m) for n, m in getattr(tq, tower).named_modules()
                 if isinstance(m, QuantLinear)]
        assert sites
        for name, m in sites:
            assert _k_major(m.kernel_i8), (tower, name)
            np.testing.assert_array_equal(m.kernel_i8.numpy(),
                                          want[f"{name}.kernel_i8"])


def _ln_linear_i8_pre_change(x, gamma, beta, w_i8, w_scale, b, eps, geglu):
    """ln_linear_i8_torch's arithmetic as it stood before the weight layout
    moved to (N, C) storage, on a row-major copy of the codes."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = xf.square().mean(-1, keepdim=True)
    var = (mean2 - mean.square()).clamp_min(0.0)
    xn = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    rs = xn.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xn * (1.0 / rs)).clamp_(-127.0, 127.0)
    acc = torch.matmul(q.double(), w_i8.contiguous().double()).float()
    y = acc * rs * w_scale.float()
    if b is not None:
        y = y + b.float()
    if geglu:
        val, gate = y.chunk(2, dim=-1)
        y = val * torch.nn.functional.gelu(gate)
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geglu", [False, True])
def test_plain_path_unchanged_by_the_layout(dtype, geglu):
    """The plain W8A8 version and the dequantized site path give the same
    output, bit for bit, as the pre-change arithmetic on row-major codes."""
    x, gamma, beta, proj = _i8_case(256, 128, geglu, True, seed=40)
    lin = load_module_params(
        Linear(256, proj["kernel"].shape[1], dtype=dtype, device="cpu"),
        jax.tree.map(np.asarray, proj))
    q = quantize_linear_int8(lin)
    assert _k_major(q.kernel_i8)
    tx = _t(x).to(dtype)
    args = (tx, _t(gamma), _t(beta), q.kernel_i8, q.kernel_scale, q.bias)
    got = cuda_norm.ln_linear_i8_torch(*args, geglu=geglu)
    assert torch.equal(got, _ln_linear_i8_pre_change(*args, 1e-5, geglu))
    # a site the kernel does not take (impl="torch"): the dequantized weight
    norm = load_module_params(Norm(256, device="cpu"),
                              {"scale": gamma, "bias": beta})
    site = tattention._ln_proj(tx, norm, q, geglu=geglu, impl="torch")
    row_major = Linear(256, proj["kernel"].shape[1], dtype=dtype,
                       device="cpu")
    with torch.no_grad():
        row_major.kernel.copy_((q.kernel_i8.contiguous().float()
                                * q.kernel_scale[None]).to(dtype))
        row_major.bias.copy_(q.bias)
    assert torch.equal(site, tattention._ln_proj(tx, norm, row_major,
                                                 geglu=geglu, impl="torch"))
