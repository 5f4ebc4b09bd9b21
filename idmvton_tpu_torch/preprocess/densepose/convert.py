"""detectron2 DensePose checkpoint -> the R-CNN's parameter tree.

Counterpart of ``idmvton_tpu/preprocess/densepose/convert.py``: the d2
``.pkl`` layout (``{"model": {name: ndarray}}``, the format of
model_final_162be9.pkl), FrozenBatchNorm folded into an inference scale +
bias in numpy, as JAX folds it. The tree holds CPU tensors under the JAX
key names; ``weights.from_jax.load_module_params`` fills a
``DensePoseRCNN`` from it.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from idmvton_tpu_torch.preprocess.densepose.rcnn import DensePoseConfig


def load_d2_pickle(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    model = data.get("model", data)
    return {k: np.asarray(v) for k, v in model.items()
            if isinstance(v, np.ndarray) or hasattr(v, "shape")}


def as_numpy(v) -> np.ndarray:
    """A state-dict leaf (numpy array or torch tensor) as a numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def tensor(a, dtype) -> torch.Tensor:
    """A numpy array as a CPU tensor of ``dtype``."""
    return torch.from_numpy(np.array(a)).to(dtype)


def conv_leaf(w, b, dtype) -> dict:
    """torch conv (O, I, kh, kw) [+ bias] -> {"kernel": HWIO, "bias"}."""
    p = {"kernel": tensor(np.transpose(as_numpy(w), (2, 3, 1, 0)), dtype)}
    if b is not None:
        p["bias"] = tensor(as_numpy(b), dtype)
    return p


def _conv(sd, key, dtype, bias=True):
    return conv_leaf(sd[key + ".weight"],
                     sd[key + ".bias"] if bias and key + ".bias" in sd
                     else None, dtype)


def _frozen_bn(sd, key, eps=1e-5):
    w = as_numpy(sd[key + ".weight"])
    b = as_numpy(sd[key + ".bias"])
    mean = as_numpy(sd[key + ".running_mean"])
    var = as_numpy(sd[key + ".running_var"])
    scale = w / np.sqrt(var + eps)
    return {"scale": tensor(scale, torch.float32),
            "bias": tensor(b - mean * scale, torch.float32)}


def _conv_bn(sd, key, dtype):
    return {"conv": _conv(sd, key, dtype, bias=False),
            "bn": _frozen_bn(sd, key + ".norm")}


def _linear(sd, key, dtype):
    return {"kernel": tensor(np.transpose(as_numpy(sd[key + ".weight"])),
                             dtype),
            "bias": tensor(as_numpy(sd[key + ".bias"]), dtype)}


def _fc1_nhwc(sd, key, dtype, ch=256, size=7):
    """box_head.fc1 consumes the flattened ROI feature: torch flattens CHW,
    the port HWC, so the input dimension is permuted."""
    w = as_numpy(sd[key + ".weight"])             # (1024, C*7*7) CHW order
    w = w.reshape(-1, ch, size, size).transpose(0, 2, 3, 1).reshape(
        w.shape[0], -1)
    return {"kernel": tensor(np.transpose(w), dtype),
            "bias": tensor(as_numpy(sd[key + ".bias"]), dtype)}


class _RecordingSD(dict):
    """dict that records key reads (strict manifest accounting)."""

    def __init__(self, sd):
        super().__init__(sd)
        self.touched = set()

    def __getitem__(self, k):
        self.touched.add(k)
        return super().__getitem__(k)


def convert_densepose(sd, cfg: DensePoseConfig = DensePoseConfig(),
                      dtype=torch.float32, *, strict: bool = False) -> dict:
    sd = _RecordingSD(sd)
    bb = {"stem": _conv_bn(sd, "backbone.bottom_up.stem.conv1", dtype)}
    for li, n in enumerate((3, 4, 6, 3)):
        layer = []
        for bi in range(n):
            pre = f"backbone.bottom_up.res{li + 2}.{bi}"
            blk = {f"conv{j}": _conv_bn(sd, f"{pre}.conv{j}", dtype)
                   for j in (1, 2, 3)}
            if f"{pre}.shortcut.weight" in sd:
                blk["shortcut"] = _conv_bn(sd, f"{pre}.shortcut", dtype)
            layer.append(blk)
        bb[f"res{li + 2}"] = layer

    fpn = {
        "lateral": [_conv(sd, f"backbone.fpn_lateral{i}", dtype)
                    for i in (2, 3, 4, 5)],
        "output": [_conv(sd, f"backbone.fpn_output{i}", dtype)
                   for i in (2, 3, 4, 5)],
    }
    rpn = {
        "conv": _conv(sd, "proposal_generator.rpn_head.conv", dtype),
        "objectness": _conv(
            sd, "proposal_generator.rpn_head.objectness_logits", dtype),
        "deltas": _conv(sd, "proposal_generator.rpn_head.anchor_deltas",
                        dtype),
    }
    box_head = {
        "fc1": _fc1_nhwc(sd, "roi_heads.box_head.fc1", dtype),
        "fc2": _linear(sd, "roi_heads.box_head.fc2", dtype),
        "cls": _linear(sd, "roi_heads.box_predictor.cls_score", dtype),
        "reg": _linear(sd, "roi_heads.box_predictor.bbox_pred", dtype),
    }
    dp_head = {
        "convs": [_conv(sd, f"roi_heads.densepose_head.body_conv_fcn{i + 1}",
                        dtype) for i in range(cfg.dp_convs)],
    }
    # ConvTranspose2d weights are (in, out, kh, kw) -> HWIO
    for ours, theirs in (("coarse_segm", "ann_index_lowres"),
                         ("fine_segm", "index_uv_lowres"),
                         ("u", "u_lowres"), ("v", "v_lowres")):
        w = as_numpy(sd[f"roi_heads.densepose_predictor.{theirs}.weight"])
        dp_head[ours] = {
            "kernel": tensor(np.transpose(w, (2, 3, 0, 1)), dtype),
            "bias": tensor(as_numpy(
                sd[f"roi_heads.densepose_predictor.{theirs}.bias"]), dtype),
        }
    tree = {"backbone": bb, "fpn": fpn, "rpn": rpn, "box_head": box_head,
            "dp_head": dp_head}
    if cfg.decoder_on:
        # Panoptic-FPN Decoder: modules registered by in_feature name,
        # roi_heads.decoder.p{2..5}.{seq_idx}; the sequence indices skip the
        # parameter-free nn.Upsample entries (0, 2, 4, ...)
        heads = [[_conv(sd, f"roi_heads.decoder.p{lvl + 2}.{2 * j}", dtype)
                  for j in range(max(1, lvl))] for lvl in range(4)]
        tree["decoder"] = {
            "scale_heads": heads,
            "predictor": _conv(sd, "roi_heads.decoder.predictor", dtype),
        }
    if strict:
        from idmvton_tpu_torch.weights.converter import check_consumed
        # pixel_mean/std + anchor cell buffers are constants, not weights
        check_consumed(sd, sd.touched, ignore_prefixes=(
            "pixel_mean", "pixel_std",
            "proposal_generator.anchor_generator."))
    return tree
