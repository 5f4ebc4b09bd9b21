"""The port's checkpoint IO (``weights/checkpoint.py``) against the JAX
package's, on the CPU, at the tiny configs.

- A tree JAX's ``save_diffusers`` wrote (fp32, bf16) loads through the
  port's ``from_diffusers`` to the stack ``load_jax_params`` makes of JAX's
  ``from_diffusers`` of the same tree, bit for bit; the port's
  ``save_diffusers`` writes a tree JAX's ``from_diffusers`` reads to the
  same parameters. The Resampler from ``ip_adapter/`` in both layouts.
- The configs' choice (``_idmvton_cfgs``, else SDXL's), alone: the full
  stack is never allocated here.
- ``save_pipeline`` / ``load_pipeline`` round trip, cast as JAX's
  ``load_pipeline`` casts (held against it on JAX's own orbax
  checkpoint), which the port refuses with the ``save_diffusers`` message.
- The load-time fixed-shift calibration (tests/test_checkpoint_resume.py's
  two cases) through the port's loaders: a hot TryonNet down site and a hot
  GarmentNet mid block force the online softmax, a clean checkpoint
  restores the fixed shift; the report names JAX's worst site and probes
  JAX's sites.
- ``weights.load_profile`` (the load's stages timed alone) at the tiny
  configs.

Tolerance: none; every parameter comparison is bit for bit.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.core.config import UNetConfig as JUNetConfig
from idmvton_tpu.models.unet import init_unet
from idmvton_tpu.ops import pallas_attention as PA
from idmvton_tpu.pipeline import tryon as jtryon
from idmvton_tpu.weights import checkpoint as jckpt
from idmvton_tpu_torch.ops import cuda_attention as TA
from idmvton_tpu_torch.pipeline import tryon as ttryon
from idmvton_tpu_torch.weights import checkpoint as tckpt
from idmvton_tpu_torch.weights.from_jax import load_jax_params
from idmvton_tpu_torch.weights.safetensors import load_file, save_file
from test_torch_affine import random_affine
from test_torch_weights import DTYPES, assert_modules_equal

FIELDS = ttryon.CFG_FIELDS


def jax_models(tree, like):
    """A JAX TryonModels with ``like``'s configs and the numpy ``tree``."""
    cfgs = {f: getattr(like, f) for f in FIELDS}
    return jtryon.TryonModels(**cfgs, **jax.tree.map(jnp.asarray, tree))


def port_models(tree, dtype, cfgs=None):
    """The port's stack (CPU) filled from a numpy tree."""
    m = ttryon.TryonModels.init(None, tiny=True, cfgs=cfgs, device="cpu",
                                dtype=dtype)
    return load_jax_params(m, tree)


def assert_stacks_equal(got, want):
    for name in ttryon.COMPONENTS:
        assert_modules_equal(getattr(got, name), getattr(want, name))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _np(models):
    return jax.tree.map(np.asarray, models.params())


@pytest.fixture(scope="module")
def jax_stacks():
    """dtype -> (JAX tiny stack, random biases and norm affines drawn
    in the stack's types)."""
    out = {}
    for dtype, (jdt, _) in DTYPES.items():
        jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                     dtype=jdt)
        out[dtype] = jax_models(random_affine(_np(jm), 5), jm)
    return out


@pytest.fixture(scope="module")
def jax_trees(jax_stacks, tmp_path_factory):
    """dtype -> the diffusers tree JAX's save_diffusers wrote."""
    out = {}
    for dtype, jm in jax_stacks.items():
        path = str(tmp_path_factory.mktemp(f"jax_tree_{dtype}"))
        jckpt.save_diffusers(path, jm)
        out[dtype] = path
    return out


# ---------------------------------------------------------------------------
# the diffusers tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("saved,load", [("float32", "float32"),
                                        ("bfloat16", "bfloat16"),
                                        ("float32", "bfloat16")])
def test_from_diffusers_matches_jax(jax_trees, saved, load):
    """fp32 -> bf16 rounds the fp32 norm affines through bf16, as JAX."""
    jdt, tdt = DTYPES[load]
    want = port_models(_np(jckpt.from_diffusers(jax_trees[saved], jdt,
                                                calibrate=False)), tdt)
    got = tckpt.from_diffusers(jax_trees[saved], tdt, device="cpu",
                               calibrate=False)
    assert got.calibration is None
    assert_stacks_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_save_diffusers_is_read_by_jax(jax_stacks, jax_trees, tmp_path,
                                       dtype):
    """The port's tree of a stack reads, in JAX and in the port, as JAX's
    own tree of the same stack reads in JAX (in bf16 the fp32 norm
    affines round on the way in, as they do from JAX's tree)."""
    jdt, tdt = DTYPES[dtype]
    mine = port_models(_np(jax_stacks[dtype]), tdt)
    tckpt.save_diffusers(str(tmp_path), mine)
    want = port_models(_np(jckpt.from_diffusers(jax_trees[dtype], jdt,
                                                calibrate=False)), tdt)
    back = jckpt.from_diffusers(str(tmp_path), jdt, calibrate=False)
    assert_stacks_equal(port_models(_np(back), tdt), want)
    assert_stacks_equal(tckpt.from_diffusers(
        str(tmp_path), tdt, device="cpu", calibrate=False), want)
    if dtype == "float32":
        assert_stacks_equal(want, mine)
    with open(tmp_path / "model_index.json") as f:
        index = json.load(f)
    assert index["unet"] == ["diffusers", "UNet2DConditionModel"]
    assert index["image_encoder"] == ["transformers",
                                      "CLIPVisionModelWithProjection"]


@pytest.mark.parametrize("prefix", ["image_proj.", ""])
def test_from_diffusers_reads_ip_adapter(jax_trees, tmp_path, prefix):
    """A try-on UNet without ``encoder_hid_proj.*``: the Resampler comes
    from ``ip_adapter/`` (a torch pickle here), with or without the
    ``image_proj.`` prefix, as JAX reads it."""
    root = str(tmp_path / "tree")
    shutil.copytree(jax_trees["float32"], root)
    unet_file = os.path.join(root, "unet",
                             "diffusion_pytorch_model.safetensors")
    sd = load_file(unet_file)
    rs = {prefix + k[len("encoder_hid_proj."):]: sd.pop(k)
          for k in list(sd) if k.startswith("encoder_hid_proj.")}
    assert rs
    save_file(sd, unet_file)
    os.makedirs(os.path.join(root, "ip_adapter"))
    torch.save(rs, os.path.join(root, "ip_adapter", "ip-adapter-plus.bin"))
    want = port_models(_np(jckpt.from_diffusers(root, jnp.float32,
                                                calibrate=False)),
                       torch.float32)
    got = tckpt.from_diffusers(root, torch.float32, device="cpu",
                               calibrate=False)
    assert_stacks_equal(got, want)
    ref = tckpt.from_diffusers(jax_trees["float32"], torch.float32,
                               device="cpu", calibrate=False)
    assert_modules_equal(got.resampler, ref.resampler)


def test_find_weights_order(tmp_path):
    """safetensors, then .bin, .pth, .pt (JAX's ``_find_weights``)."""
    for name in ("w.pt", "w.pth", "w.bin", "w.safetensors"):
        (tmp_path / name).write_bytes(b"")
        assert tckpt._find_weights(str(tmp_path)) == \
            jckpt._find_weights(str(tmp_path)) == str(tmp_path / name)
    assert tckpt._find_weights(str(tmp_path / "none")) is None


def test_diffusers_configs_choice(jax_trees, tmp_path):
    """A tree save_diffusers wrote brings its configs; a hub tree (no
    ``_idmvton_cfgs``, or no model_index.json) gets the SDXL stack's."""
    tiny = dict(zip(FIELDS, ttryon.TryonModels.configs(tiny=True)))
    assert tckpt.diffusers_configs(jax_trees["float32"]) == tiny
    sdxl = dict(zip(FIELDS, ttryon.TryonModels.configs(tiny=False)))
    assert tckpt.diffusers_configs(str(tmp_path)) == sdxl
    with open(tmp_path / "model_index.json", "w") as f:
        json.dump({"_class_name": "TryonPipeline"}, f)
    assert tckpt.diffusers_configs(str(tmp_path)) == sdxl
    assert sdxl["unet_cfg"].in_channels == 13
    assert sdxl["unet_cfg"].block_out_channels == (320, 640, 1280)


# ---------------------------------------------------------------------------
# the pipeline checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def orbax_dir(jax_stacks, tmp_path_factory):
    """JAX's save_pipeline (orbax) of the fp32 stack."""
    path = str(tmp_path_factory.mktemp("orbax"))
    jckpt.save_pipeline(path, jax_stacks["float32"])
    return path


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pipeline_checkpoint_round_trip(jax_stacks, orbax_dir, tmp_path,
                                        dtype):
    """The port's save_pipeline of the fp32 stack, loaded at ``dtype``:
    the parameters JAX's load_pipeline gives at ``dtype`` from its own
    checkpoint of the same stack (floating leaves cast to ``dtype``, so
    bf16 rounds the norm affines)."""
    jdt, tdt = DTYPES[dtype]
    mine = port_models(_np(jax_stacks["float32"]), torch.float32)
    tckpt.save_pipeline(str(tmp_path), mine)
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["config.json"] + [f"{n}.safetensors" for n in ttryon.COMPONENTS])
    got = tckpt.load_pipeline(str(tmp_path), tdt, device="cpu",
                              calibrate=False)
    want = port_models(_np(jckpt.load_pipeline(orbax_dir, jdt,
                                               calibrate=False)), tdt)
    assert_stacks_equal(got, want)
    if dtype == "float32":
        assert_stacks_equal(got, mine)


def test_load_pipeline_refuses_orbax(orbax_dir, tmp_path):
    with pytest.raises(ValueError, match="save_diffusers"):
        tckpt.load_pipeline(orbax_dir, device="cpu")
    with pytest.raises(FileNotFoundError, match="missing"):
        tckpt.load_pipeline(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# the load-time fixed-shift softmax calibration
# ---------------------------------------------------------------------------


def _hot(kernel, seed):
    """q and k columns share one large random matrix: logits far past the
    fixed-shift clamp, with distinct magnitudes (JAX's test's recipe)."""
    c, three_inner = kernel.shape
    inner = three_inner // 3
    w_qk = 0.5 * jax.random.normal(jax.random.PRNGKey(seed), (c, inner),
                                   jnp.float32)
    return jnp.concatenate([w_qk, w_qk, kernel[:, 2 * inner:]], axis=1)


@pytest.fixture
def switch():
    """Restores both packages' force-off flags."""
    old_j, old_t = PA._FIXED_SHIFT_FORCED_OFF, TA._FIXED_SHIFT_FORCED_OFF
    PA._FIXED_SHIFT_FORCED_OFF = TA._FIXED_SHIFT_FORCED_OFF = False
    yield
    PA._FIXED_SHIFT_FORCED_OFF, TA._FIXED_SHIFT_FORCED_OFF = old_j, old_t


def _jax_report(jm):
    try:
        return jckpt.calibrate_attention_softmax(jm)
    finally:
        PA._FIXED_SHIFT_FORCED_OFF = False


def test_calibration_hot_tryon_down_site(tmp_path, switch):
    """A TryonNet whose first flash-servable down site is hot: the port's
    from_diffusers forces the online softmax; a clean tree restores the
    fixed shift."""
    cfg = JUNetConfig.tiny("consume", block_out_channels=(32, 128, 256))
    jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32)
    jm = dataclasses.replace(jm, unet_cfg=cfg, unet=init_unet(
        jax.random.PRNGKey(3), cfg, dtype=jnp.float32))
    clean = str(tmp_path / "clean")
    jckpt.save_diffusers(clean, jm)
    site = jm.unet["down_blocks"][1]["attentions"][0]["blocks"][0]["attn1"]
    site["to_qkv"]["kernel"] = _hot(site["to_qkv"]["kernel"], 7)
    hot = str(tmp_path / "hot")
    jckpt.save_diffusers(hot, jm)
    want = _jax_report(jm)

    models = tckpt.from_diffusers(hot, torch.float32, device="cpu")
    assert not TA.fixed_shift_enabled(), \
        "a hot checkpoint must force the online-max softmax"
    rep = models.calibration
    assert rep["fixed_shift"] is False and rep["max_error"] > 5e-3
    assert rep["worst_site"] == want["worst_site"] == "unet.down"
    assert rep["site_errors"].keys() == want["site_errors"].keys()
    assert want["fixed_shift"] is False

    models = tckpt.from_diffusers(clean, torch.float32, device="cpu")
    assert TA.fixed_shift_enabled() and models.calibration["fixed_shift"]
    assert models.calibration["site_errors"].keys() == \
        want["site_errors"].keys()


def test_calibration_hot_garment_mid_block(tmp_path, switch):
    """Hot logits only in the GarmentNet's mid block (a site the single
    TryonNet probe missed), through the port's own pipeline checkpoint:
    load_pipeline forces the online softmax."""
    gcfg = JUNetConfig.tiny("emit", block_out_channels=(32, 128, 256))
    jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32)
    jm = dataclasses.replace(jm, garm_cfg=gcfg, garm=init_unet(
        jax.random.PRNGKey(5), gcfg, dtype=jnp.float32))
    site = jm.garm["mid_block"]["attentions"][0]["blocks"][0]["attn1"]
    site["to_qkv"]["kernel"] = _hot(site["to_qkv"]["kernel"], 9)
    want = _jax_report(jm)
    cfgs = tckpt._configs({f: dataclasses.asdict(getattr(jm, f))
                           for f in FIELDS})
    tckpt.save_pipeline(str(tmp_path), port_models(_np(jm), torch.float32,
                                                   cfgs))
    models = tckpt.load_pipeline(str(tmp_path), torch.float32, device="cpu")
    assert not TA.fixed_shift_enabled(), \
        "garment-tower hot logits must force the online-max softmax"
    rep = models.calibration
    assert rep["worst_site"] == want["worst_site"] == "garm.mid"
    assert rep["site_errors"].keys() == want["site_errors"].keys()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IDMVTON_CALIBRATE", "0")
        TA._FIXED_SHIFT_FORCED_OFF = False
        skipped = tckpt.load_pipeline(str(tmp_path), torch.float32,
                                      device="cpu")
        assert skipped.calibration is None and TA.fixed_shift_enabled()


def test_load_profile_tiny(capsys, switch):
    """``weights.load_profile`` at the tiny configs on the CPU: every stage
    timed over the whole tree, the calibration's report kept, the whole
    printed as the last line."""
    from idmvton_tpu_torch.weights import load_profile
    got = load_profile.main(["--tiny", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(got))
    assert got["tree_bytes"] > 0
    for stage in ("export", "read_cold", "from_diffusers_cold", "read",
                  "read_to_card", "from_diffusers", "calibrate_first",
                  "calibrate_again"):
        assert got[stage]["s"] > 0, stage
    for share in ("read_cold_resident_before", "resident_warm"):
        assert 0.0 <= got[share] <= 1.0
    assert got["calibration"]["worst_site"] in \
        got["calibration"]["site_errors"]
