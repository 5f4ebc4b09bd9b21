"""Checkpoint IO of the port.

Counterpart of ``idmvton_tpu/weights/checkpoint.py``:

- ``from_diffusers`` builds the try-on stack from a diffusers-layout tree
  (the yisol/IDM-VTON hub layout, inference.py:232-274) on the device
  asked for, streaming each tensor from its file to that device;
  ``save_diffusers`` writes one, as JAX's does (same files, configs and
  ``model_index.json``), so trees pass between the two packages;
- ``save_pipeline`` / ``load_pipeline``: the stack in the port's own
  format, ``config.json`` (the configs, as JAX writes them) beside one
  safetensors file a component keyed by the JAX tree paths, so a load is
  ``load_jax_params`` from disk. JAX's orbax checkpoints are not read:
  ``save_diffusers`` is the bridge;
- ``calibrate_attention_softmax``: the load-time fixed-shift softmax guard,
  run by both loaders on the loaded weights before any step is captured.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
from typing import Optional

import torch

from idmvton_tpu_torch.core.config import (
    CLIPTextConfig, CLIPVisionConfig, ResamplerConfig, UNetConfig, VAEConfig,
)
from idmvton_tpu_torch.pipeline.tryon import (
    CFG_FIELDS, COMPONENTS, TryonModels,
)
from idmvton_tpu_torch.weights.converter import (
    close_state_dict, convert_clip_text, convert_clip_vision,
    convert_resampler, convert_unet, convert_vae, export_clip_text,
    export_clip_vision, export_resampler, export_unet, export_vae,
    load_state_dict,
)
from idmvton_tpu_torch.weights.from_jax import load_module_params
from idmvton_tpu_torch.weights.safetensors import (
    SafetensorsReader, save_file,
)

_CFG_TYPES = (UNetConfig, UNetConfig, VAEConfig, CLIPTextConfig,
              CLIPTextConfig, CLIPVisionConfig, ResamplerConfig)

log = logging.getLogger(__name__)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card is visible")
    return device


def _configs(saved: dict) -> dict:
    """field -> config from their ``dataclasses.asdict`` dicts (JSON
    lists back to tuples)."""
    cfgs = {}
    for field, typ in zip(CFG_FIELDS, _CFG_TYPES):
        d = {k: tuple(v) if isinstance(v, list) else v
             for k, v in saved[field].items()}
        cfgs[field] = typ(**d)
    return cfgs


def _configs_dict(models: TryonModels) -> dict:
    return {f: dataclasses.asdict(getattr(models, f)) for f in CFG_FIELDS}


# ---------------------------------------------------------------------------
# the fixed-shift softmax calibration
# ---------------------------------------------------------------------------


def _calibration_sites(models: TryonModels):
    """(label, to_qkv kernel, heads) of every self-attention probe site:
    both towers (the GarmentNet serves through the same fixed-shift kernel
    as the TryonNet), at the first attention-bearing down level and at the
    mid block (the deepest, widest level)."""
    for tower, cfg_field in (("unet", "unet_cfg"), ("garm", "garm_cfg")):
        unet = getattr(models, tower)
        cfg = getattr(models, cfg_field)
        down = next((b for b in unet.down_blocks if "attentions" in b), None)
        mid = getattr(unet, "mid_block", None)
        for level, blk in (("down", down), ("mid", mid)):
            if blk is None or "attentions" not in blk:
                continue
            kernel = blk["attentions"][0].blocks[0].attn1.to_qkv.kernel
            heads = (kernel.shape[1] // 3) // cfg.attention_head_dim
            yield f"{tower}.{level}", kernel, heads


def calibrate_attention_softmax(models: TryonModels, *, tol: float = 5e-3,
                                seq: int = 256, batch: int = 2,
                                seed: int = 0) -> Optional[dict]:
    """A/B the fixed-shift softmax against the online-max one on a batch of
    activations projected through each probe site's own to_qkv weights
    (``_calibration_sites``), then ``calibrate_fixed_shift`` on the worst
    site: past ``tol`` it forces the online-max softmax process-wide, and a
    clean checkpoint clears an earlier force-off. One call on the worst
    site sets or clears the flag at once (calibrating site by site would
    let a later clean site reset a breach found earlier).

    Run it after loading, before any step is captured (a captured step's
    key holds the switch, so a flip also captures anew). The probe
    activations come from a ``torch.Generator`` seeded with ``seed`` (not
    JAX's stream). Returns the calibrate report with ``site_errors`` and
    ``worst_site``, or None when skipped: no site the kernel serves (tiny
    geometries run plain attention), or ``IDMVTON_CALIBRATE=0``."""
    if os.environ.get("IDMVTON_CALIBRATE", "1") == "0":
        return None
    from idmvton_tpu_torch.ops.cuda_attention import (
        calibrate_fixed_shift, fixed_shift_max_error,
        flash_attention_gemm_supported,
    )

    def qkv_for(kernel, offset):
        gen = torch.Generator(device=kernel.device).manual_seed(seed + offset)
        x = torch.randn((batch, seq, kernel.shape[0]), generator=gen,
                        device=kernel.device, dtype=torch.float32)
        return torch.matmul(x.to(kernel.dtype), kernel)

    errors, worst = {}, None
    with torch.no_grad():
        for i, (label, kernel, heads) in enumerate(
                _calibration_sites(models)):
            # the kernel's predicate reads only the last axis, 3 * H * D
            if not flash_attention_gemm_supported(kernel, heads):
                continue
            errors[label] = fixed_shift_max_error(qkv_for(kernel, i),
                                                  heads=heads)
            if worst is None or errors[label] > errors[worst[0]]:
                worst = (label, kernel, heads, i)
        if worst is None:
            return None
        label, kernel, heads, i = worst
        report = calibrate_fixed_shift(qkv_for(kernel, i), heads=heads,
                                       tol=tol)
    report["site_errors"] = errors
    report["worst_site"] = label
    log.info("fixed-shift softmax calibration: worst site %s max_error %.3g "
             "(sites %s), fixed_shift=%s", label, report["max_error"],
             errors, report["fixed_shift"])
    return report


# ---------------------------------------------------------------------------
# the diffusers tree
# ---------------------------------------------------------------------------

_SUBFOLDERS = {
    # subfolder: (library, class in config.json, weights file)
    "unet": ("diffusers", "UNet2DConditionModel",
             "diffusion_pytorch_model.safetensors"),
    "unet_encoder": ("diffusers", "UNet2DConditionModel",
                     "diffusion_pytorch_model.safetensors"),
    "vae": ("diffusers", "AutoencoderKL",
            "diffusion_pytorch_model.safetensors"),
    "text_encoder": ("transformers", "CLIPTextModel", "model.safetensors"),
    "text_encoder_2": ("transformers", "CLIPTextModelWithProjection",
                       "model.safetensors"),
    "image_encoder": ("transformers", "CLIPVisionModelWithProjection",
                      "model.safetensors"),
}


def _export_subfolder(name: str, models: TryonModels, dtype) -> dict:
    if name == "unet":
        # the Resampler rides inside the try-on UNet as encoder_hid_proj.*
        # (train_xl.py:343-357)
        sd = export_unet(models.unet, models.unet_cfg, dtype=dtype)
        sd.update(export_resampler(models.resampler, models.resampler_cfg,
                                   prefix="encoder_hid_proj.", dtype=dtype))
        return sd
    if name == "unet_encoder":
        return export_unet(models.garm, models.garm_cfg, dtype=dtype)
    if name == "vae":
        return export_vae(models.vae, models.vae_cfg, dtype=dtype)
    if name == "text_encoder":
        return export_clip_text(models.clip_l, models.clip_l_cfg, dtype=dtype)
    if name == "text_encoder_2":
        return export_clip_text(models.clip_g, models.clip_g_cfg, dtype=dtype)
    return export_clip_vision(models.vision, models.vision_cfg, dtype=dtype)


def save_diffusers(path: str, models: TryonModels, *,
                   dtype=torch.float32) -> None:
    """Writes ``models`` as a diffusers-layout tree (reference:
    train_xl.py:770-792 ``pipeline.save_pretrained``): ``model_index.json``
    (with the exact configs as ``_idmvton_cfgs``, so non-SDXL geometries
    round-trip; diffusers ignores the key) and a subfolder a component with
    its ``config.json`` stub and safetensors file, in the yisol/IDM-VTON
    layout that ``from_diffusers`` and the reference's inference.py read.
    Tensors are written in ``dtype`` (fp32, as JAX's exporters, by
    default), one component at a time."""
    index = {"_class_name": "TryonPipeline", "_diffusers_version": "0.25.0",
             "_idmvton_cfgs": _configs_dict(models)}
    os.makedirs(path, exist_ok=True)
    for name, (lib, cls, fname) in _SUBFOLDERS.items():
        sub = os.path.join(path, name)
        os.makedirs(sub, exist_ok=True)
        save_file(_export_subfolder(name, models, dtype),
                  os.path.join(sub, fname))
        with open(os.path.join(sub, "config.json"), "w") as f:
            json.dump({"_class_name": cls} if lib == "diffusers"
                      else {"architectures": [cls]}, f)
        index[name] = [lib, cls]
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2)


def _find_weights(subdir: str) -> Optional[str]:
    for pattern in ("*.safetensors", "*.bin", "*.pth", "*.pt"):
        hits = sorted(glob.glob(os.path.join(subdir, pattern)))
        if hits:
            return hits[0]
    return None


def _open(subdir: str, device):
    path = _find_weights(subdir)
    if path is None:
        raise FileNotFoundError(f"{subdir}: no .safetensors / .bin / .pth / "
                                f".pt weights")
    return load_state_dict(path, device)


def diffusers_configs(root: str) -> dict:
    """The configs of the tree at ``root``: ``model_index.json``'s
    ``_idmvton_cfgs`` (trees ``save_diffusers`` wrote), else the SDXL
    try-on stack's."""
    index_path = os.path.join(root, "model_index.json")
    if os.path.isfile(index_path):
        with open(index_path) as f:
            saved = json.load(f).get("_idmvton_cfgs")
        if saved:
            return _configs(saved)
    return dict(zip(CFG_FIELDS, TryonModels.configs(tiny=False)))


def from_diffusers(root: str, dtype=torch.bfloat16, *, device="cuda",
                   unet_subfolder: str = "unet",
                   calibrate: bool = True) -> TryonModels:
    """The try-on stack from a diffusers hub layout: {unet, unet_encoder,
    vae, text_encoder, text_encoder_2, image_encoder} subfolders, each with
    a .safetensors, .bin, .pth or .pt file (the first in that order). The
    Resampler is read from the try-on UNet's ``encoder_hid_proj.*``, else
    from ``ip_adapter/`` (``image_proj.*`` or bare keys). The stack is
    allocated on ``device`` and filled in place, a component at a time;
    ``calibrate`` runs ``calibrate_attention_softmax`` on the loaded
    weights (its report in ``models.calibration``)."""
    device = _device(device)
    cfgs = diffusers_configs(root)
    models = TryonModels.init(None, cfgs=cfgs, device=device, dtype=dtype)

    def fill(name, tree):
        load_module_params(getattr(models, name), tree)

    sd = _open(os.path.join(root, unet_subfolder), device)
    try:
        fill("unet", convert_unet(sd, cfgs["unet_cfg"], dtype, device=device))
        if any(k.startswith("encoder_hid_proj.") for k in sd):
            fill("resampler", convert_resampler(
                sd, cfgs["resampler_cfg"], dtype, prefix="encoder_hid_proj.",
                device=device))
        else:
            ip_sd = _open(os.path.join(root, "ip_adapter"), device)
            try:
                prefix = ("image_proj." if any(k.startswith("image_proj.")
                                               for k in ip_sd) else "")
                fill("resampler", convert_resampler(
                    ip_sd, cfgs["resampler_cfg"], dtype, prefix=prefix,
                    device=device))
            finally:
                close_state_dict(ip_sd)
    finally:
        close_state_dict(sd)
    for name, sub, convert, cfg in (
            ("garm", "unet_encoder", convert_unet, "garm_cfg"),
            ("vae", "vae", convert_vae, "vae_cfg"),
            ("clip_l", "text_encoder", convert_clip_text, "clip_l_cfg"),
            ("clip_g", "text_encoder_2", convert_clip_text, "clip_g_cfg"),
            ("vision", "image_encoder", convert_clip_vision, "vision_cfg")):
        sd = _open(os.path.join(root, sub), device)
        try:
            fill(name, convert(sd, cfgs[cfg], dtype, device=device))
        finally:
            close_state_dict(sd)
    if calibrate:
        models.calibration = calibrate_attention_softmax(models)
    return models


# ---------------------------------------------------------------------------
# the port's pipeline checkpoint
# ---------------------------------------------------------------------------


def save_pipeline(path: str, models: TryonModels) -> None:
    """``config.json`` (field -> config dict, as JAX's ``save_pipeline``)
    and ``{component}.safetensors`` with every parameter under its JAX tree
    path (``down_blocks.0.resnets.0.norm1.scale``), in its own type."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_configs_dict(models), f, indent=2)
    for name in COMPONENTS:
        save_file(dict(getattr(models, name).named_parameters()),
                  os.path.join(path, f"{name}.safetensors"))


def _unflatten(flat: dict) -> dict:
    """{"a.0.b": t} -> {"a": {0: {"b": t}}} (the loader indexes module
    lists by int)."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = [int(p) if p.isdigit() else p for p in key.split(".")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_pipeline(path: str, dtype=torch.bfloat16, *, device="cuda",
                  calibrate: bool = True) -> TryonModels:
    """The stack ``save_pipeline`` wrote, on ``device``: every floating
    tensor cast to ``dtype`` (as JAX's ``load_pipeline`` casts its leaves;
    the fp32 norm parameters are widened back), then
    ``calibrate_attention_softmax`` when ``calibrate``. A JAX orbax
    checkpoint (a ``params/`` directory) is refused."""
    device = _device(device)
    files = {n: os.path.join(path, f"{n}.safetensors") for n in COMPONENTS}
    if not all(os.path.isfile(f) for f in files.values()):
        if os.path.isdir(os.path.join(path, "params")):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package, which the"
                f" port does not read: write it as a diffusers tree with the "
                f"JAX package's weights.checkpoint.save_diffusers and load "
                f"that with from_diffusers (--pretrained DIR --diffusers)")
        missing = [f for f in files.values() if not os.path.isfile(f)]
        raise FileNotFoundError(f"{path}: not a pipeline checkpoint, "
                                f"missing {missing}")
    with open(os.path.join(path, "config.json")) as f:
        cfgs = _configs(json.load(f))
    models = TryonModels.init(None, cfgs=cfgs, device=device, dtype=dtype)
    for name, file in files.items():
        with SafetensorsReader(file, device) as r:
            flat = {k: r[k].to(dtype) if r.dtype(k).is_floating_point
                    else r[k] for k in r}
        load_module_params(getattr(models, name), _unflatten(flat))
        del flat
    if calibrate:
        models.calibration = calibrate_attention_softmax(models)
    return models
