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
  run by both loaders on the loaded weights before any step is captured;
- ``save_train_state`` / ``latest_train_state_step`` / ``load_train_state``:
  the resumable fine-tuning state, in the port's own format (safetensors
  and a JSON of the counters; JAX's is orbax's).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import shutil
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


# ---------------------------------------------------------------------------
# the train state (resumable fine-tuning)
# ---------------------------------------------------------------------------


def _flatten_state(tree, prefix, tensors: dict, scalars: dict):
    """Nested dicts of tensors and ints -> ``tensors`` / ``scalars`` keyed
    by "/"-joined paths (parameter names keep their dots)."""
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            _flatten_state(value, path + "/", tensors, scalars)
        elif isinstance(value, torch.Tensor):
            tensors[path] = value
        else:
            scalars[path] = int(value)


def _state_tree(state) -> dict:
    return {"trainable": state.trainable, "opt_state": state.opt_state}


def save_train_state(path: str, state, *, keep: int = 3) -> str:
    """Writes ``state`` (a ``train.train_step.TrainState``: the fp32
    masters, the optimizer's state, the step) as ``path/state_{step}``:
    ``state.safetensors`` (every tensor under its "/"-joined path) beside
    ``state.json`` (the step and the optimizer's integer counters), then
    keeps the ``keep`` newest states. The port's own format: JAX's is
    orbax's (``checkpoint.py:152-194``). The reference's
    ``--resume_from_checkpoint`` is dead code (train_xl.py:259,469); here
    resume is real. Returns the state's directory. A ZeRO-1 state is
    gathered first (``parallel.zero.gather_state``, on every rank)."""
    if getattr(state, "zero1", None) is not None:
        raise ValueError("a ZeRO-1 state holds this rank's slices of the "
                         "moments: save parallel.zero.gather_state(state)")
    os.makedirs(path, exist_ok=True)
    tensors, scalars = {}, {}
    _flatten_state(_state_tree(state), "", tensors, scalars)
    final = os.path.join(path, f"state_{int(state.step)}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_file(tensors, os.path.join(tmp, "state.safetensors"))
    with open(os.path.join(tmp, "state.json"), "w") as f:
        json.dump({"step": int(state.step), "scalars": scalars}, f,
                  indent=1)
    # a state appears whole or not at all
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    steps = sorted(_state_steps(path))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"state_{s}"), ignore_errors=True)
    return final


def _state_steps(path: str):
    return [int(d.split("_")[1]) for d in os.listdir(path)
            if d.startswith("state_") and d.split("_")[1].isdigit()]


def latest_train_state_step(path: str) -> Optional[int]:
    """The newest step ``save_train_state`` wrote under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = _state_steps(path)
    return max(steps) if steps else None


def load_train_state(path: str, template, step: Optional[int] = None):
    """The ``TrainState`` saved at ``step`` (the newest by default), in the
    structure, types and devices of ``template`` (a state
    ``init_train_state`` made for the same models and optimizer): every
    tensor and counter of the template must be in the file, with its
    shape. The masters require grad, as the template's."""
    from idmvton_tpu_torch.train.train_step import TrainState
    step = step if step is not None else latest_train_state_step(path)
    if step is None:
        raise FileNotFoundError(f"{path}: no train state")
    root = os.path.join(path, f"state_{step}")
    with open(os.path.join(root, "state.json")) as f:
        meta = json.load(f)
    tensors, scalars = {}, {}
    _flatten_state(_state_tree(template), "", tensors, scalars)
    missing = sorted(set(scalars) - set(meta["scalars"]))
    with SafetensorsReader(os.path.join(root, "state.safetensors")) as r:
        missing += sorted(k for k in tensors if k not in r)
        if missing:
            raise KeyError(f"{root}: not in the saved state: {missing[:8]}")
        loaded = {}
        for k, t in tensors.items():
            v = r[k]
            if tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype:
                raise ValueError(f"{root}: {k} is {v.dtype} "
                                 f"{tuple(v.shape)}, expected {t.dtype} "
                                 f"{tuple(t.shape)}")
            loaded[k] = v.to(t.device).requires_grad_(t.requires_grad)

    def rebuild(tree, prefix):
        out = {}
        for key, value in tree.items():
            p = f"{prefix}{key}"
            out[key] = (rebuild(value, p + "/") if isinstance(value, dict)
                        else loaded[p] if isinstance(value, torch.Tensor)
                        else meta["scalars"][p])
        return out

    tree = rebuild(_state_tree(template), "")
    return TrainState(step=int(meta["step"]), trainable=tree["trainable"],
                      opt_state=tree["opt_state"])
