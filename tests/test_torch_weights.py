"""The port's checkpoint readers and converters against the JAX package's,
on the CPU.

- ``weights/safetensors.py`` (torch and the standard library) against the
  ``safetensors`` package, both ways, in F32, F16, BF16 and I64; a
  transposed tensor is written by value; a ``.bin`` holding a nested
  ``state_dict``, in torch's zip and legacy formats, reads like its
  safetensors twin.
- ``weights/converter.py``: for each family, the JAX exporter's state dict
  of a seeded tiny tree (random biases and norm affines,
  ``test_torch_affine.random_affine``) through the port's ``convert_*``
  must fill a module bit for bit as ``load_jax_params`` of JAX's
  ``convert_*`` of the same state dict does, in fp32 and in bf16 (where
  the norms are rounded through bf16); the port's ``export_*`` must equal
  JAX's key for key and bit for bit. The conv_in 9 -> 13 surgery, the
  Resampler's three layouts, the CLIP pre-norm's two spellings, a missing
  key and ``strict``'s leftover check.
- The full-size schemas against the key manifests of
  ``tests/fixtures/manifests`` (as tests/test_key_manifests.py holds
  JAX's): every key consumed, every parameter filled at its shape, on the
  ``meta`` device (no memory allocated).

Tolerance: none. Both sides cast each leaf once (or twice, for norms: to
the target type, then fp32) with round-to-nearest-even; everything else is
layout, so every comparison is bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.pipeline import tryon as jtryon
from idmvton_tpu.weights import converter as jconv
from idmvton_tpu_torch.models.clip import CLIPText, CLIPVision
from idmvton_tpu_torch.models.resampler import Resampler
from idmvton_tpu_torch.models.unet import UNet
from idmvton_tpu_torch.models.vae import VAE
from idmvton_tpu_torch.pipeline import tryon as ttryon
from idmvton_tpu_torch.weights import converter as tconv
from idmvton_tpu_torch.weights import safetensors as tst
from idmvton_tpu_torch.weights.from_jax import load_module_params
from test_torch_affine import random_affine

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "manifests")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# component: (config field, JAX convert, JAX export, port convert, port
# export, port module class)
FAMILIES = {
    "unet": ("unet_cfg", jconv.convert_unet, jconv.export_unet,
             tconv.convert_unet, tconv.export_unet, UNet),
    "garm": ("garm_cfg", jconv.convert_unet, jconv.export_unet,
             tconv.convert_unet, tconv.export_unet, UNet),
    "vae": ("vae_cfg", jconv.convert_vae, jconv.export_vae,
            tconv.convert_vae, tconv.export_vae, VAE),
    "clip_l": ("clip_l_cfg", jconv.convert_clip_text, jconv.export_clip_text,
               tconv.convert_clip_text, tconv.export_clip_text, CLIPText),
    "clip_g": ("clip_g_cfg", jconv.convert_clip_text, jconv.export_clip_text,
               tconv.convert_clip_text, tconv.export_clip_text, CLIPText),
    "vision": ("vision_cfg", jconv.convert_clip_vision,
               jconv.export_clip_vision, tconv.convert_clip_vision,
               tconv.export_clip_vision, CLIPVision),
    "resampler": ("resampler_cfg", jconv.convert_resampler,
                  jconv.export_resampler, tconv.convert_resampler,
                  tconv.export_resampler, Resampler),
}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def to_torch(a) -> torch.Tensor:
    """numpy / JAX array -> torch tensor with the same bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.uint16).numpy().view(jnp.bfloat16)
    return t.contiguous().numpy()


def assert_modules_equal(got, want):
    """Every parameter of two modules equal bit for bit, in type too."""
    g, w = dict(got.named_parameters()), dict(want.named_parameters())
    assert g.keys() == w.keys()
    for name, p in w.items():
        assert g[name].dtype == p.dtype, name
        assert torch.equal(g[name], p), name


def assert_state_dicts_equal(got, want):
    """A port state dict (torch) and a JAX one (numpy), key for key and
    bit for bit."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = to_numpy(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _sd_torch(sd):
    return {k: to_torch(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX tiny stack (fp32) with random biases and norm affines: its
    configs and {component: numpy tree}."""
    jm = jtryon.TryonModels.init(jax.random.PRNGKey(0), tiny=True,
                                 dtype=jnp.float32)
    tree = random_affine(jax.tree.map(np.asarray, jm.params()), 11)
    return jm, tree


# the port's tiny configs (equal to JAX's: tests/test_torch_models.py)
TINY = dict(zip(ttryon.CFG_FIELDS, ttryon.TryonModels.configs(tiny=True)))


def _module(name, dtype):
    return FAMILIES[name][5](TINY[FAMILIES[name][0]], dtype=dtype,
                             device="cpu")


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

ST_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64]


def _tensors(dtype):
    g = torch.Generator().manual_seed(3)
    if dtype.is_floating_point:
        mk = lambda *s: (torch.randn(s, generator=g) * 3).to(dtype)
    else:
        mk = lambda *s: torch.randint(-2**40, 2**40, s, generator=g)
    return {"w": mk(5, 7), "b": mk(7), "s": mk(), "empty": mk(0, 4),
            "deep.name.0": mk(2, 3, 4)}


@pytest.mark.parametrize("dtype", ST_DTYPES, ids=str)
def test_safetensors_reader_reads_the_package(tmp_path, dtype):
    from safetensors.torch import save_file as pkg_save
    want = _tensors(dtype)
    path = str(tmp_path / "pkg.safetensors")
    pkg_save(want, path, metadata={"format": "pt"})
    got = tst.load_file(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    with tst.SafetensorsReader(path) as r:
        assert r.metadata == {"format": "pt"} and r.dtype("w") == dtype


@pytest.mark.parametrize("dtype", ST_DTYPES, ids=str)
def test_safetensors_writer_is_read_by_the_package(tmp_path, dtype):
    from safetensors.torch import load_file as pkg_load
    want = _tensors(dtype)
    path = str(tmp_path / "port.safetensors")
    tst.save_file(want, path)
    got = pkg_load(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_safetensors_writes_views_by_value(tmp_path):
    """A transposed kernel (the exporters' linear layout) and a column
    slice write their values, not their base buffers."""
    from safetensors.numpy import load_file as pkg_load_np
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    views = {"t": base.t(), "cols": base[:, 1:3], "perm":
             base.reshape(2, 2, 3, 2).permute(3, 2, 0, 1)}
    path = str(tmp_path / "views.safetensors")
    tst.save_file(views, path)
    got = pkg_load_np(path)
    for k, v in views.items():
        np.testing.assert_array_equal(got[k], v.contiguous().numpy())


def test_lazy_reader_reads_on_demand(tmp_path):
    """``in`` reads the header only; each lookup returns a fresh tensor
    that owns its memory; a closed reader refuses."""
    want = _tensors(torch.float32)
    path = str(tmp_path / "lazy.safetensors")
    tst.save_file(want, path)
    r = tst.SafetensorsReader(path)
    assert "w" in r and "missing" not in r and len(r) == len(want)
    a, b = r["w"], r["w"]
    a.add_(1.0)
    assert torch.equal(b, want["w"]) and not torch.equal(a, b)
    r.close()
    assert torch.equal(b, want["w"])
    with pytest.raises(ValueError, match="closed"):
        r.get_tensor("w")


def _check_bin_like_safetensors(tmp_path, zip_format):
    """A torch pickle with a top-level ``state_dict`` of nested dicts (and a
    non-tensor entry) flattens with dots, as JAX's ``load_state_dict``, and
    reads like its safetensors twin."""
    sd = _tensors(torch.float16)
    nested = {"state_dict": {"w": sd["w"], "b": sd["b"], "s": sd["s"],
                             "empty": sd["empty"],
                             "deep": {"name": {"0": sd["deep.name.0"]}},
                             "step": 3}}
    torch.save(nested, str(tmp_path / "m.bin"),
               _use_new_zipfile_serialization=zip_format)
    tst.save_file(sd, str(tmp_path / "m.safetensors"))
    got = tconv.load_state_dict(str(tmp_path / "m.bin"))
    twin = tconv.load_state_dict(str(tmp_path / "m.safetensors"))
    want_np = jconv.load_state_dict(str(tmp_path / "m.bin"))
    try:
        assert sorted(got) == sorted(twin) == sorted(want_np)
        for k in sd:
            assert torch.equal(got[k], twin[k]) and got[k].dtype == twin[k].dtype
            # JAX widens a pickle's tensors to fp32 (exactly)
            np.testing.assert_array_equal(got[k].float().numpy(), want_np[k])
    finally:
        tconv.close_state_dict(twin)


def test_bin_state_dict_reads_like_safetensors(tmp_path):
    _check_bin_like_safetensors(tmp_path, zip_format=True)


def test_legacy_bin_state_dict_reads_like_safetensors(tmp_path):
    """torch's legacy (non-zip) pickle format, which cannot be
    memory-mapped: read whole, with the same result."""
    _check_bin_like_safetensors(tmp_path, zip_format=False)


# ---------------------------------------------------------------------------
# converters against JAX's, per family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_convert_matches_jax(jax_tiny, name, dtype):
    jm, tree = jax_tiny
    field, jconvert, jexport, tconvert, _, _ = FAMILIES[name]
    jdt, tdt = DTYPES[dtype]
    cfg = getattr(jm, field)
    sd = jexport(tree[name], cfg)
    want = load_module_params(_module(name, tdt), jax.tree.map(
        np.asarray, jconvert(sd, cfg, jdt)))
    got = load_module_params(_module(name, tdt), tconvert(
        _sd_torch(sd), TINY[field], tdt, device="cpu"))
    assert_modules_equal(got, want)
    if dtype == "bfloat16":
        # the norms were rounded through bf16, then widened
        norm = next(p for n, p in got.named_parameters()
                    if n.endswith("scale"))
        assert norm.dtype == torch.float32
        assert torch.equal(norm, norm.bfloat16().float())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(FAMILIES))
def test_export_matches_jax(jax_tiny, name, dtype):
    """The port's exporter on a module loaded with JAX's tree writes JAX's
    exporter's state dict: same keys, fp32, same bits (and a bf16 module
    widens exactly)."""
    jm, tree = jax_tiny
    field, jconvert, jexport, _, texport, _ = FAMILIES[name]
    jdt, tdt = DTYPES[dtype]
    cfg = getattr(jm, field)
    jtree = jconvert(jexport(tree[name], cfg), cfg, jdt)
    module = load_module_params(_module(name, tdt),
                                jax.tree.map(np.asarray, jtree))
    got = texport(module, TINY[field])
    assert_state_dicts_equal(got, jexport(jtree, cfg))
    assert {t.dtype for t in got.values()} == {torch.float32}


def test_conv_in_surgery_matches_jax(jax_tiny):
    """Raw 9-channel SDXL-inpainting weights widen to the TryonNet's 13
    input channels, the extra ones zero, as JAX's ``convert_unet`` does; the
    surgery is off with ``allow_conv_in_expand=False``."""
    jm, tree = jax_tiny
    cfg = jm.unet_cfg
    sd = jconv.export_unet(tree["unet"], cfg)
    sd["conv_in.weight"] = np.ascontiguousarray(sd["conv_in.weight"][:, :9])
    for jdt, tdt in DTYPES.values():
        want = jconv.convert_unet(sd, cfg, jdt)["conv_in"]["kernel"]
        got = tconv.convert_unet(_sd_torch(sd), TINY["unet_cfg"], tdt,
                                 device="cpu")["conv_in"]["kernel"]
        assert got.shape == (3, 3, cfg.in_channels, cfg.block_out_channels[0])
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
        assert not got[:, :, 9:].any() and got[:, :, :9].any()
    raw = tconv.convert_unet(_sd_torch(sd), TINY["unet_cfg"], torch.float32,
                             device="cpu",
                             allow_conv_in_expand=False)
    assert raw["conv_in"]["kernel"].shape[2] == 9


@pytest.mark.parametrize("layout", ["encoder_hid_proj.", "image_proj.", ""])
def test_resampler_layouts_match_jax(jax_tiny, layout):
    """Inside the try-on UNet (``encoder_hid_proj.``), in a raw ip-adapter
    file (``image_proj.``) or bare; ``latents`` with its leading axis of 1
    (as exported) or without."""
    jm, tree = jax_tiny
    cfg = jm.resampler_cfg
    sd = jconv.export_resampler(tree["resampler"], cfg, prefix=layout)
    sd_2d = dict(sd, **{layout + "latents": sd[layout + "latents"][0]})
    want = load_module_params(_module("resampler", torch.bfloat16),
                              jax.tree.map(np.asarray, jconv.convert_resampler(
                                  sd, cfg, jnp.bfloat16, prefix=layout)))
    for s in (sd, sd_2d):
        got = load_module_params(
            _module("resampler", torch.bfloat16),
            tconv.convert_resampler(_sd_torch(s), TINY["resampler_cfg"],
                                    torch.bfloat16,
                                    prefix=layout, device="cpu",
                                    strict=True))
        assert_modules_equal(got, want)


def test_clip_vision_pre_norm_spellings(jax_tiny):
    jm, tree = jax_tiny
    cfg = jm.vision_cfg
    sd = jconv.export_clip_vision(tree["vision"], cfg)
    assert "vision_model.pre_layrnorm.weight" in sd
    alt = {k.replace("pre_layrnorm", "pre_layernorm"): v
           for k, v in sd.items()}
    want = load_module_params(_module("vision", torch.float32),
                              jax.tree.map(np.asarray, jconv.convert_clip_vision(
                                  alt, cfg, jnp.float32)))
    got = load_module_params(_module("vision", torch.float32),
                             tconv.convert_clip_vision(
                                 _sd_torch(alt), TINY["vision_cfg"],
                                 torch.float32,
                                 device="cpu", strict=True))
    assert_modules_equal(got, want)


def test_missing_key_and_strict_leftovers(jax_tiny):
    jm, tree = jax_tiny
    cfg = jm.vae_cfg
    sd = _sd_torch(jconv.export_vae(tree["vae"], cfg))
    gone = "decoder.mid_block.attentions.0.to_k.weight"
    with pytest.raises(KeyError, match=gone):
        tconv.convert_vae({k: v for k, v in sd.items() if k != gone}, cfg,
                          torch.float32, device="cpu")
    extra = dict(sd, **{"decoder.conv_extra.weight": torch.zeros(3)})
    tconv.convert_vae(extra, cfg, torch.float32, device="cpu")  # lenient
    with pytest.raises(ValueError, match="unconsumed"):
        tconv.convert_vae(extra, cfg, torch.float32, device="cpu",
                          strict=True)
    # the try-on UNet's strict check leaves the Resampler and IP KV keys
    usd = jconv.export_unet(tree["unet"], jm.unet_cfg)
    usd.update(jconv.export_resampler(tree["resampler"], jm.resampler_cfg,
                                      prefix="encoder_hid_proj."))
    tconv.convert_unet(_sd_torch(usd), jm.unet_cfg, torch.float32,
                       device="cpu", strict=True)


# ---------------------------------------------------------------------------
# the full-size schemas against the key manifests (meta device)
# ---------------------------------------------------------------------------


def _manifest(name):
    with open(os.path.join(FIXDIR, name + ".json")) as f:
        return json.load(f)


def _meta_sd(manifest):
    return {k: torch.empty(s, device="meta") for k, s in manifest.items()}


FULL = ttryon.TryonModels.configs(tiny=False)
# manifest: (port module factory, config, convert, schema, keys the
# converter leaves by design)
MANIFESTS = {
    "unet_sdxl_tryon": (UNet, FULL[0], tconv.convert_unet,
                        tconv._unet_schema(FULL[0]), ()),
    # GarmentNet reads the base SDXL UNet; the reference runs it without
    # added conditioning and stops before the last plain up block
    "unet_sdxl_base": (UNet, FULL[1], tconv.convert_unet,
                       tconv._unet_schema(FULL[1]),
                       ("add_embedding.", "up_blocks.2.", "conv_norm_out.",
                        "conv_out.")),
    "vae_sdxl": (VAE, FULL[2], tconv.convert_vae, tconv._vae_schema(FULL[2]),
                 ()),
    "clip_l_text": (CLIPText, FULL[3], tconv.convert_clip_text,
                    tconv._clip_text_schema(FULL[3]), ("position_ids",)),
    "clip_bigg_text": (CLIPText, FULL[4], tconv.convert_clip_text,
                       tconv._clip_text_schema(FULL[4]), ("position_ids",)),
    "clip_vith_vision": (CLIPVision, FULL[5], tconv.convert_clip_vision,
                         tconv._clip_vision_schema(FULL[5]),
                         ("position_ids", "logit_scale")),
    "resampler_plus_vith": (Resampler, FULL[6], tconv.convert_resampler,
                            tconv._resampler_schema(FULL[6]), ()),
}


@pytest.mark.parametrize("name", list(MANIFESTS))
def test_full_size_schema_consumes_manifest(name):
    """The schema consumes exactly the manifest's keys (less the documented
    ones the converter leaves), and converting the manifest's shapes on the
    ``meta`` device fills every parameter of the full-size module at its
    shape."""
    man = _manifest(name)
    factory, cfg, convert, schema, left = MANIFESTS[name]
    want = tconv.schema_keys(schema, man)
    assert not sorted(want - set(man))
    extra = sorted(k for k in set(man) - want
                   if not any(s in k for s in left))
    assert not extra, extra[:8]
    tree = convert(_meta_sd(man), cfg, torch.bfloat16, device="meta")
    module = factory(cfg, dtype=torch.bfloat16, device="meta")
    load_module_params(module, tree)
    if name.startswith("unet") or name == "vae_sdxl":   # JAX's schema too
        jschema = (jconv._unet_schema(cfg) if name.startswith("unet")
                   else jconv._vae_schema(cfg))
        assert want == jconv.schema_keys(jschema, man)
