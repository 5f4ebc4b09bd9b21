"""The PyTorch port's modules against the JAX package's, on the CPU.

Each module is built on the JAX side from its own init (tiny configs, fp32),
its parameter pytree goes through ``weights.from_jax.load_module_params``
into the port's module, and both run the same numpy inputs. JAX runs its
XLA path here (impl=None on the CPU), the port its plain path.

Tolerances: fp32 on both sides; the formulas are the same and only the
summation order differs, which over a few dozen layers stays below 2e-4
(absolute and relative) at O(1) activations.

The transformer block, UNet and VAE comparisons run twice: on the init's
parameters (zero biases, unit norms) and with random biases and norm
affines (``test_torch_affine.random_affine``, the ``random_affine`` case),
so a bias or scale/shift fault cannot cancel out.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.core import config as jcfg
from idmvton_tpu.diffusion import scheduler as jsched
from idmvton_tpu.models import attention as jatt
from idmvton_tpu.models import clip as jclip
from idmvton_tpu.models import layers as jlayers
from idmvton_tpu.models import resampler as jres
from idmvton_tpu.models import resnet as jresnet
from idmvton_tpu.models import unet as junet
from idmvton_tpu.models import vae as jvae
from idmvton_tpu_torch.core import config as tcfg
from idmvton_tpu_torch.diffusion import scheduler as tsched
from idmvton_tpu_torch.models import layers as tlayers
from idmvton_tpu_torch.models.attention import TransformerBlock
from idmvton_tpu_torch.models.clip import CLIPText, CLIPVision
from idmvton_tpu_torch.models.resampler import Resampler
from idmvton_tpu_torch.models.resnet import (
    Downsample2D, ResnetBlock, Upsample2D,
)
from idmvton_tpu_torch.models.unet import UNet
from idmvton_tpu_torch.models.vae import VAE
from idmvton_tpu_torch.weights.from_jax import load_module_params
from test_torch_affine import INITS, params_for

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
F32 = dict(dtype=torch.float32, device="cpu")


def _np(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _port(module, jparams):
    return load_module_params(module, jax.tree.map(np.asarray, jparams))


def _port_case(module, jparams, init, seed):
    """``module`` loaded with ``jparams`` as the parity case ``init`` has
    them (``params_for``); returns (module, that numpy tree, which the JAX
    side runs too)."""
    tree = params_for(init, jparams, seed)
    return load_module_params(module, tree), tree


def _key(i):
    return jax.random.PRNGKey(i)


# ---------------------------------------------------------------------------
# config copy and the no-JAX rule
# ---------------------------------------------------------------------------

PRESETS = [
    ("UNetConfig", "sdxl_tryon", ()), ("UNetConfig", "sdxl_garment", ()),
    ("UNetConfig", "tiny", ("none",)), ("UNetConfig", "tiny", ("emit",)),
    ("UNetConfig", "tiny", ("consume",)), ("UNetConfig", "micro", ("emit",)),
    ("UNetConfig", "micro", ("consume",)), ("VAEConfig", "sdxl", ()),
    ("VAEConfig", "tiny", ()), ("CLIPTextConfig", "clip_l", ()),
    ("CLIPTextConfig", "clip_bigg", ()), ("CLIPTextConfig", "tiny", ()),
    ("CLIPVisionConfig", "vit_h", ()), ("CLIPVisionConfig", "tiny", ()),
    ("ResamplerConfig", "sdxl_plus", ()), ("ResamplerConfig", "tiny", ()),
    ("SchedulerConfig", "sdxl_inference", ()), ("SchedulerConfig", "train", ()),
]


@pytest.mark.parametrize("cls,preset,args", PRESETS)
def test_config_preset_matches_jax(cls, preset, args):
    want = getattr(getattr(jcfg, cls), preset)(*args)
    got = getattr(getattr(tcfg, cls), preset)(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if cls == "UNetConfig":
        assert got.num_garment_features == want.num_garment_features


def test_config_classes_match_jax():
    names = lambda mod: sorted(n for n, v in vars(mod).items()
                               if dataclasses.is_dataclass(v))
    assert names(tcfg) == names(jcfg)
    for n in names(jcfg):
        assert dataclasses.asdict(getattr(tcfg, n)()) == \
            dataclasses.asdict(getattr(jcfg, n)())


def test_port_imports_no_jax():
    """Every module of the port, the CLIs and data modules included, imports
    without JAX, the JAX package, PIL, OpenCV or the ``safetensors``
    package (the card's host may lack the last three: only the functions
    that read or write images import the first two, and the port reads
    safetensors with its own ``weights/safetensors.py``)."""
    code = ("import importlib, pkgutil, sys\n"
            "import idmvton_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    p.__path__, 'idmvton_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'idmvton_tpu',\n"
            "                                    'PIL', 'cv2', 'safetensors'))\n"
            "assert not bad, bad\n"
            "assert 'idmvton_tpu_torch.cli.infer' in mods\n"
            "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` and what it runs on the card besides the port (the
    card tests and their shared module) import the port and torch, and
    nothing of JAX."""
    for path in ("chip_smoke.py", "tests/torch_card.py",
                 "tests/test_torch_cuda.py", "tests/test_torch_cuda_full.py"):
        mods = set()
        for node in ast.walk(ast.parse((ROOT / path).read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module.split(".")[0])
        assert "idmvton_tpu_torch" in mods and "torch" in mods, path
        assert not mods & {"jax", "jaxlib", "idmvton_tpu"}, path


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_timestep_embedding_matches_jax():
    # fp32 sin/cos of arguments up to 999 rad: the two libraries' argument
    # reductions differ by a few ulps of 999 (~6e-5 rad)
    t = np.array([0, 1, 17, 500, 999], np.float32)
    for dim in (32, 33, 256):
        _close(tlayers.timestep_embedding(_t(t), dim),
               jlayers.timestep_embedding(jnp.asarray(t), dim), tol=1e-4)


@pytest.mark.parametrize("shape,act,eps", [((2, 8, 6, 32), "silu", 1e-5),
                                           ((3, 20, 16), None, 1e-6)])
def test_group_norm_matches_jax(shape, act, eps):
    c = shape[-1]
    x = _np(0, *shape, scale=2.0, shift=0.7)
    p = {"scale": _np(1, c, shift=1.0), "bias": _np(2, c)}
    want = jlayers.group_norm(p, jnp.asarray(x), num_groups=8, eps=eps,
                              act=act, impl="xla")
    got = tlayers.group_norm(_port(tlayers.Norm(c, device="cpu"), p), _t(x),
                             num_groups=8, eps=eps, act=act)
    _close(got, want, tol=1e-5)


def test_layer_norm_matches_jax():
    x = _np(3, 2, 7, 48, scale=3.0, shift=-2.0)
    p = {"scale": _np(4, 48), "bias": _np(5, 48)}
    _close(tlayers.layer_norm(_port(tlayers.Norm(48, device="cpu"), p), _t(x)),
           jlayers.layer_norm(p, jnp.asarray(x)), tol=1e-5)


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, "SAME"), (1, 1, "SAME"), (3, 2, ((0, 1), (0, 1))),
    (2, 2, "VALID"), (3, 2, "SAME")])
def test_conv2d_matches_jax(k, stride, padding):
    x = _np(6, 2, 9, 11, 16)
    p = {"kernel": _np(7, k, k, 16, 24, scale=0.2), "bias": _np(8, 24)}
    want = jlayers.conv2d(p, jnp.asarray(x), stride=stride, padding=padding,
                          impl="xla")
    mod = _port(tlayers.Conv(16, 24, k, **F32), p)
    got = tlayers.conv2d(mod, _t(x), stride=stride, padding=padding)
    _close(got, want, tol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((4, 3), (8, 6)), ((5, 3), (9, 7)),
                                          ((16, 16), (2, 2)), ((12, 8), (3, 2))])
def test_resize_nearest_matches_jax_image_resize(in_hw, out_hw):
    """jax.image.resize "nearest" samples half-pixel centres (16 -> 2 picks
    rows 4 and 12), which torch's plain "nearest" does not."""
    x = _np(9, 2, *in_hw, 3)
    want = jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), "nearest")
    np.testing.assert_array_equal(tlayers.resize_nearest(_t(x), out_hw).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_resnet_block_matches_jax():
    jp = jresnet.init_resnet_block(_key(0), 32, 64, temb_dim=48, num_groups=8,
                                   dtype=jnp.float32)
    x, temb = _np(10, 2, 6, 5, 32), _np(11, 2, 48)
    want = jresnet.resnet_block(jp, jnp.asarray(x), jnp.asarray(temb),
                                num_groups=8)
    mod = _port(ResnetBlock(32, 64, temb_dim=48, num_groups=8, **F32), jp)
    _close(mod(_t(x), _t(temb)), want)


def test_up_and_downsample_match_jax():
    x = _np(12, 2, 7, 5, 16)
    jd = jresnet.init_downsample(_key(1), 16, dtype=jnp.float32)
    _close(_port(Downsample2D(16, **F32), jd)(_t(x)),
           jresnet.downsample2d(jd, jnp.asarray(x)))
    ju = jresnet.init_upsample(_key(2), 16, dtype=jnp.float32)
    up = _port(Upsample2D(16, **F32), ju)
    _close(up(_t(x)), jresnet.upsample2d(ju, jnp.asarray(x)))
    _close(up(_t(x), out_hw=(13, 9)),
           jresnet.upsample2d(ju, jnp.asarray(x), out_hw=(13, 9)))


@pytest.mark.parametrize("init", INITS)
@pytest.mark.parametrize("mode", ["none", "emit", "consume"])
def test_transformer_block_matches_jax(mode, init):
    dim, heads, ctx_dim, ip = 32, 2, 24, 4
    jp = jatt.init_transformer_block(_key(3), dim, heads=heads, head_dim=16,
                                     context_dim=ctx_dim,
                                     ip_adapter=mode == "consume",
                                     dtype=jnp.float32)
    b = 4 if mode == "consume" else 2
    x, ctx = _np(13, b, 12, dim), _np(14, b, 9 + ip, ctx_dim)
    kw = dict(heads=heads, garment_mode=mode,
              ip_num_tokens=ip if mode == "consume" else 0)
    feat = _np(15, b // 2, 12, dim) if mode == "consume" else None
    mod, jp = _port_case(TransformerBlock(dim, heads=heads, head_dim=16,
                                          context_dim=ctx_dim,
                                          ip_adapter=mode == "consume",
                                          **F32), jp, init, 3)
    want, want_em = jatt.transformer_block(
        jp, jnp.asarray(x), jnp.asarray(ctx),
        garment_feat=None if feat is None else jnp.asarray(feat),
        garment_uncond_zero=mode == "consume", **kw)
    got, got_em = mod(_t(x), _t(ctx), garment_mode=mode,
                      garment_feat=None if feat is None else _t(feat),
                      garment_uncond_zero=mode == "consume",
                      ip_num_tokens=kw["ip_num_tokens"])
    _close(got, want)
    if mode == "emit":
        _close(got_em, want_em)
    else:
        assert got_em is None and want_em is None


# ---------------------------------------------------------------------------
# UNets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=INITS)
def unets(request):
    g_cfg, u_cfg = jcfg.UNetConfig.tiny("emit"), jcfg.UNetConfig.tiny("consume")
    jg = junet.init_unet(_key(4), g_cfg, dtype=jnp.float32)
    ju = junet.init_unet(_key(5), u_cfg, dtype=jnp.float32)
    tg, jg = _port_case(UNet(tcfg.UNetConfig.tiny("emit"), **F32), jg,
                        request.param, 4)
    tu, ju = _port_case(UNet(tcfg.UNetConfig.tiny("consume"), **F32), ju,
                        request.param, 5)
    return g_cfg, jg, tg, u_cfg, ju, tu


def test_unet_emit_matches_jax(unets):
    g_cfg, jg, tg, *_ = unets
    x, ctx = _np(16, 2, 8, 8, 4), _np(17, 2, 7, g_cfg.cross_attention_dim)
    none, want = junet.unet_apply(jg, g_cfg, jnp.asarray(x), 500,
                                  jnp.asarray(ctx))
    got_none, got = tg(_t(x), 500, _t(ctx))
    assert none is None and got_none is None
    assert len(got) == len(want) == g_cfg.num_garment_features
    for a, b in zip(got, want):
        _close(a, b)


def test_unet_consume_matches_jax(unets):
    *_, u_cfg, ju, tu = unets
    b = 4
    x = _np(18, b, 8, 8, 13)
    ctx = _np(19, b, 7 + u_cfg.ip_num_tokens, u_cfg.cross_attention_dim)
    pooled, tids = _np(20, b, 64), np.tile(
        np.array([[32, 32, 0, 0, 32, 32]], np.float32), (b, 1))
    feats = [_np(30 + i, b // 2, hw * hw, ch) for i, (hw, ch) in enumerate(
        [(4, 64)] * 2 + [(2, 128)] * 4 + [(2, 128)] * 2 + [(2, 128)] * 6
        + [(4, 64)] * 3)]
    assert len(feats) == u_cfg.num_garment_features
    want, _ = junet.unet_apply(
        ju, u_cfg, jnp.asarray(x), jnp.asarray([999, 999, 999, 999]),
        jnp.asarray(ctx), added_cond=(jnp.asarray(pooled), jnp.asarray(tids)),
        garment_features=tuple(jnp.asarray(f) for f in feats),
        garment_uncond_zero=True)
    got, _ = tu(_t(x), torch.tensor([999, 999, 999, 999]), _t(ctx),
                added_cond=(_t(pooled), _t(tids)),
                garment_features=tuple(_t(f) for f in feats),
                garment_uncond_zero=True)
    _close(got, want)


# ---------------------------------------------------------------------------
# VAE, CLIP, resampler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=INITS)
def vae(request):
    cfg = jcfg.VAEConfig.tiny()
    jp = jvae.init_vae(_key(6), cfg, dtype=jnp.float32)
    tv, jp = _port_case(VAE(tcfg.VAEConfig.tiny(), **F32), jp, request.param, 6)
    return cfg, jp, tv


def test_vae_encode_matches_jax(vae):
    cfg, jp, tv = vae
    x = np.tanh(_np(21, 2, 16, 24, 3))
    mean, logvar = jvae.vae_encode_moments(jp, cfg, jnp.asarray(x))
    got_mean, got_logvar = tv.encode_moments(_t(x))
    _close(got_mean, mean)
    _close(got_logvar, logvar)
    _close(tv.encode(_t(x), sample=False),
           jvae.vae_encode(jp, cfg, jnp.asarray(x), sample=False))
    # the posterior sample: mean + exp(logvar / 2) * noise, scaled
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(got_mean.shape, generator=torch.Generator()
                        .manual_seed(3))
    want = (got_mean + torch.exp(0.5 * got_logvar) * noise) * cfg.scaling_factor
    _close(tv.encode(_t(x), gen), want, tol=1e-6)


def test_vae_decode_matches_jax(vae):
    cfg, jp, tv = vae
    z = _np(22, 2, 2, 3, 4)
    _close(tv.decode(_t(z)), jvae.vae_decode(jp, cfg, jnp.asarray(z)))


def test_vae_decode_force_upcast_matches_jax():
    """VAEConfig.force_upcast with bf16 parameters: both decode a bf16
    latent in fp32 with the bf16 weights (the card's conv kernels take that
    fp32 x as it is; the plain path here upcasts the weights exactly)."""
    cfg = dataclasses.replace(jcfg.VAEConfig.tiny(), force_upcast=True)
    jp = jvae.init_vae(_key(7), cfg, dtype=jnp.bfloat16)
    tree = params_for("random_affine", jp, 7)
    tv = load_module_params(
        VAE(dataclasses.replace(tcfg.VAEConfig.tiny(), force_upcast=True),
            dtype=torch.bfloat16, device="cpu"), tree)
    z = _np(23, 2, 2, 3, 4)
    want = jvae.vae_decode(jax.tree.map(jnp.asarray, tree), cfg,
                           jnp.asarray(z, jnp.bfloat16))
    got = tv.decode(_t(z).bfloat16())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)


@pytest.mark.parametrize("bigg", [False, True])
def test_clip_text_matches_jax(bigg):
    kw = dict(hidden_size=32, projection_dim=64, use_final_projection=True,
              hidden_act="gelu") if bigg else {}
    jc, tc = jcfg.CLIPTextConfig.tiny(**kw), tcfg.CLIPTextConfig.tiny(**kw)
    jp = jclip.init_clip_text(_key(7), jc, dtype=jnp.float32)
    ids = np.random.default_rng(23).integers(0, jc.vocab_size, (3, 77))
    want = jclip.clip_text_apply(jp, jc, jnp.asarray(ids))
    got = _port(CLIPText(tc, **F32), jp)(torch.from_numpy(ids))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_clip_vision_matches_jax():
    jc = jcfg.CLIPVisionConfig.tiny()
    jp = jclip.init_clip_vision(_key(8), jc, dtype=jnp.float32)
    jp["class_embedding"] = jnp.asarray(_np(24, jc.hidden_size))
    px = _np(25, 2, jc.image_size, jc.image_size, 3)
    want = jclip.clip_vision_apply(jp, jc, jnp.asarray(px))
    got = _port(CLIPVision(tcfg.CLIPVisionConfig.tiny(), **F32), jp)(_t(px))
    for k in want:
        _close(got[k], want[k])


def test_resampler_matches_jax():
    jc = jcfg.ResamplerConfig.tiny()
    jp = jres.init_resampler(_key(9), jc, dtype=jnp.float32)
    x = _np(26, 2, 5, jc.embedding_dim)
    want = jres.resampler_apply(jp, jc, jnp.asarray(x))
    got = _port(Resampler(tcfg.ResamplerConfig.tiny(), **F32), jp)(_t(x))
    _close(got, want)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

SCHED_CFGS = [
    {}, {"rescale_betas_zero_snr": True}, {"beta_schedule": "linear"},
    {"beta_schedule": "squaredcos_cap_v2", "timestep_spacing": "trailing"},
    {"timestep_spacing": "linspace", "prediction_type": "v_prediction"},
    {"prediction_type": "sample"},
]


@pytest.mark.parametrize("kw", SCHED_CFGS)
def test_scheduler_matches_jax(kw):
    js = jsched.DDPMScheduler(jcfg.SchedulerConfig(**kw))
    ts_ = tsched.DDPMScheduler(tcfg.SchedulerConfig(**kw))
    np.testing.assert_array_equal(ts_.alphas_cumprod,
                                  np.asarray(js.alphas_cumprod))
    for n in (30, 25):
        want_t, want_p = js.timesteps_and_prev(n)
        got_t, got_p = ts_.timesteps_and_prev(n)
        np.testing.assert_array_equal(got_t, np.asarray(want_t))
        np.testing.assert_array_equal(got_p, np.asarray(want_p))
    sample, out, noise = _np(27, 2, 4, 4, 4), _np(28, 2, 4, 4, 4), \
        _np(29, 2, 4, 4, 4)
    for t, prev in ((981, 948), (500, 467), (1, -1)):
        want, want_x0 = js.step(jnp.asarray(out), jnp.int32(t),
                                jnp.int32(prev), jnp.asarray(sample),
                                jnp.asarray(noise))
        got, got_x0 = ts_.step(_t(out), t, prev, _t(sample), _t(noise))
        _close(got, want, tol=1e-5)
        _close(got_x0, want_x0, tol=1e-4)


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_classifier_free_guidance_matches_jax(rescale):
    u, c = _np(30, 2, 4, 4, 4), _np(31, 2, 4, 4, 4)
    _close(tsched.classifier_free_guidance(_t(u), _t(c), 2.0, rescale),
           jsched.classifier_free_guidance(jnp.asarray(u), jnp.asarray(c),
                                           2.0, rescale), tol=1e-5)
