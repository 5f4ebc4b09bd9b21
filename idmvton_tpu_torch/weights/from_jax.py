"""Fill the port's modules from the JAX package's parameter pytree.

The tree is nested dicts / lists of numpy arrays -- e.g.
``jax.tree.map(np.asarray, TryonModels.init(...).params())`` on the JAX
side -- so this module needs no JAX, or of torch tensors on any device
(``weights.converter``'s trees). The port's modules store the JAX
layouts (linear ``(in, out)``, conv HWIO, fused ``to_qkv`` / ``to_kv`` /
``to_kv_ip``) under the JAX key names, so every leaf copies as it is, cast
to the parameter's type. Every parameter of the module must be filled, and
every leaf of the tree must find its parameter. A model quantized
beforehand (``models.attention.quantize_unet_linears_int8``) takes a JAX tree
quantized the same way: its ``kernel_i8`` / ``kernel_scale`` leaves fill
the ``QuantLinear`` parameters as they are, under the same checks. The
preprocessing nets (OpenPose, the two SCHP nets, the DensePose R-CNN) take
JAX's trees the same way (``load_preprocess_params``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from idmvton_tpu_torch.models.layers import weights_changed_
from idmvton_tpu_torch.pipeline.tryon import COMPONENTS, TryonModels


def _to_tensor(arr) -> torch.Tensor:
    a = np.array(arr)    # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _child(module, key, path):
    try:
        if isinstance(module, (nn.ModuleDict, nn.ModuleList)):
            return module[key]
        return getattr(module, key)
    except (AttributeError, KeyError, IndexError):
        raise KeyError(f"{path}: not in {type(module).__name__}") from None


def _fill(module, tree, prefix, filled):
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else \
        tree.items()
    for key, sub in items:
        path = f"{prefix}{key}"
        if isinstance(sub, (dict, list, tuple)):
            _fill(_child(module, key, path), sub, path + ".", filled)
            continue
        param = _child(module, key, path)
        if not isinstance(param, torch.Tensor):
            raise KeyError(f"{path}: no parameter in {type(module).__name__}")
        src = sub if isinstance(sub, torch.Tensor) else _to_tensor(sub)
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} != "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(src.to(param.dtype))
        filled.add(id(param))


def load_module_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy one component's pytree into ``module`` (in place); a CUDA
    graph captured over its old weights is captured again."""
    filled = set()
    weights_changed_(module)
    _fill(module, tree, "", filled)
    missing = [n for n, p in module.named_parameters() if id(p) not in filled]
    if missing:
        raise KeyError(f"parameters not in the tree: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return module


def load_jax_params(models: TryonModels, tree: dict) -> TryonModels:
    """``tree``: {"unet", "garm", "vae", "clip_l", "clip_g", "vision",
    "resampler"} -> component pytree (the JAX ``TryonModels.params()``)."""
    for name in COMPONENTS:
        load_module_params(getattr(models, name), tree[name])
    return models


def load_preprocess_params(openpose, parsing, densepose, tree: dict):
    """Fills the nets of the ``OpenPose``, ``Parsing`` and ``DensePose``
    wrappers in place from ``tree``: {"openpose", "atr", "lip",
    "densepose"} -> JAX's ``init_openpose``, ``init_schp`` (ATR, LIP) and
    ``init_densepose_rcnn`` trees."""
    load_module_params(openpose.net, tree["openpose"])
    load_module_params(parsing.atr, tree["atr"])
    load_module_params(parsing.lip, tree["lip"])
    load_module_params(densepose.model, tree["densepose"])
