"""SCHP human parsing: AugmentCE2P (ResNet-101 + PSP + edge branch), the
reference's OpenCV postprocessing and the ATR + LIP fusion.

Counterpart of ``idmvton_tpu/preprocess/schp.py`` (the reference's
networks/AugmentCE2P.py, parsing_api.py's hole filling, arm-hole
refinement and neck label 18 from ATR-11 minus LIP-13). InPlaceABN at
inference is batch norm + leaky_relu(0.01) (``_abn``).

The net runs NHWC on its device; its stride-1, undilated 3x3 convs with at
least 128 channels (layer2-layer3's bottleneck conv2 after the first block,
the PSP bottleneck) take the conv kernels on the card through
``layers.conv2d``, as JAX sends them to its Pallas conv. The letterbox and
the un-letterbox resizes and the postprocessing are OpenCV / PIL host code,
as in JAX, imported inside the functions that use them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.models.layers import Conv, conv2d

ATR_CLASSES = 18
LIP_CLASSES = 20
_LAYERS = (3, 4, 23, 3)  # ResNet-101
_PSP_SIZES = (1, 2, 3, 6)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Inference batch norm: fp32 ``scale``, ``bias``, ``mean``, ``var``."""

    def __init__(self, ch, *, device):
        super().__init__()
        for name in ("scale", "bias", "mean", "var"):
            setattr(self, name, nn.Parameter(
                torch.empty(ch, dtype=torch.float32, device=device),
                requires_grad=False))

    def reset_own_parameters_(self, generator):
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)


def _bn(p, x, eps=1e-5):
    inv = torch.rsqrt(p.var + eps) * p.scale
    return (x - p.mean) * inv + p.bias


def _abn(p, x):
    """InPlaceABN inference: BN + leaky_relu(0.01)."""
    return F.leaky_relu(_bn(p, x), 0.01)


class ConvBN(nn.Module):
    def __init__(self, in_ch, out_ch, k, *, dtype, device):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, k, bias=False, dtype=dtype,
                         device=device)
        self.bn = BatchNorm(out_ch, device=device)


def _dilated_conv(p, x, *, dilation: int):
    y = F.conv2d(x.permute(0, 3, 1, 2), p.kernel.to(x.dtype).permute(
        3, 2, 0, 1), padding=dilation, dilation=dilation)
    y = y.permute(0, 2, 3, 1).contiguous()
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def adaptive_avg_pool(x, size: int):
    """torch AdaptiveAvgPool2d, NHWC."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), size)
    return y.permute(0, 2, 3, 1).contiguous()


def _ac_axis(out_n: int, in_n: int, device):
    """Source positions of align_corners=True bilinear: pos = i * (in - 1)
    / (out - 1) in fp32, as JAX computes them."""
    if out_n == 1 or in_n == 1:
        lo = torch.zeros(out_n, dtype=torch.long, device=device)
        return lo, lo, torch.zeros(out_n, device=device)
    pos = (torch.arange(out_n, dtype=torch.float32, device=device)
           * np.float32((in_n - 1) / (out_n - 1)))
    lo = torch.floor(pos).long().clamp(0, in_n - 2)
    return lo, lo + 1, pos - lo.float()


def _resize_bilinear(x, hw):
    """align_corners=True bilinear (the reference's F.interpolate(...,
    mode='bilinear', align_corners=True) throughout AugmentCE2P and its
    upsample to the input size), NHWC."""
    b, h, w, c = x.shape
    oh, ow = hw
    if (oh, ow) == (h, w):
        return x
    y0, y1, fy = _ac_axis(oh, h, x.device)
    x0, x1, fx = _ac_axis(ow, w, x.device)
    xf = x.float()
    rows = (xf[:, y0] * (1.0 - fy)[None, :, None, None]
            + xf[:, y1] * fy[None, :, None, None])
    out = (rows[:, :, x0] * (1.0 - fx)[None, None, :, None]
           + rows[:, :, x1] * fx[None, None, :, None])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# the net (JAX's tree key names)
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, in_ch, planes, downsample, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBN(in_ch, planes, 1, **kw)
        self.conv2 = ConvBN(planes, planes, 3, **kw)
        self.conv3 = ConvBN(planes, planes * 4, 1, **kw)
        self.downsample = (ConvBN(in_ch, planes * 4, 1, **kw) if downsample
                           else None)

    def forward(self, x, *, stride: int, dilation: int, impl=None):
        h = F.relu(_bn(self.conv1.bn, conv2d(self.conv1.conv, x,
                                             impl=impl)))
        if dilation > 1:
            h = _dilated_conv(self.conv2.conv, h, dilation=dilation)
        else:
            h = conv2d(self.conv2.conv, h, stride=stride,
                       padding=((1, 1), (1, 1)), impl=impl)
        h = F.relu(_bn(self.conv2.bn, h))
        h = _bn(self.conv3.bn, conv2d(self.conv3.conv, h, impl=impl))
        r = x
        if self.downsample is not None:
            r = _bn(self.downsample.bn, conv2d(self.downsample.conv, x,
                                               stride=stride, impl=impl))
        return F.relu(h + r)


def _module(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


# (stride, dilation) of layer1 .. layer4
_LAYER_STRIDES = ((1, 1), (2, 1), (2, 1), (1, 2))


class SCHPNet(nn.Module):
    def __init__(self, num_classes: int = ATR_CLASSES, *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.stem = nn.ModuleList([ConvBN(3, 64, 3, **kw),
                                   ConvBN(64, 64, 3, **kw),
                                   ConvBN(64, 128, 3, **kw)])
        inplanes = 128
        for li, planes in enumerate((64, 128, 256, 512)):
            stride = _LAYER_STRIDES[li][0]
            setattr(self, f"layer{li + 1}", nn.ModuleList(
                Bottleneck(inplanes if bi == 0 else planes * 4, planes,
                           bi == 0 and (stride != 1
                                        or inplanes != planes * 4), **kw)
                for bi in range(_LAYERS[li])))
            inplanes = planes * 4
        self.psp = _module(
            stages=nn.ModuleList(ConvBN(2048, 512, 1, **kw)
                                 for _ in _PSP_SIZES),
            bottleneck=ConvBN(2048 + 512 * len(_PSP_SIZES), 512, 3, **kw))
        self.edge = _module(
            conv1=ConvBN(256, 256, 1, **kw), conv2=ConvBN(512, 256, 1, **kw),
            conv3=ConvBN(1024, 256, 1, **kw), conv4=Conv(256, 2, 3, **kw),
            conv5=Conv(6, 2, 1, **kw))
        self.decoder = _module(
            conv1=ConvBN(512, 256, 1, **kw), conv2=ConvBN(256, 48, 1, **kw),
            conv3a=ConvBN(304, 256, 1, **kw),
            conv3b=ConvBN(256, 256, 1, **kw),
            conv4=Conv(256, num_classes, 1, **kw))
        self.fusion = _module(conv=ConvBN(1024, 256, 1, **kw),
                              out=Conv(256, num_classes, 1, **kw))

    def forward(self, x, *, impl=None):
        """x: (B, H, W, 3) BGR normalized with mean (0.406, 0.456, 0.485) /
        std (0.225, 0.224, 0.229). Returns (parsing_logits, fusion_logits,
        edge_logits) at H/4; the runtime consumer reads fusion_logits."""
        h = x
        for i, cb in enumerate(self.stem):
            h = conv2d(cb.conv, h, stride=2 if i == 0 else 1,
                       padding=((1, 1), (1, 1)), impl=impl)
            h = F.relu(_bn(cb.bn, h))
        # 3x3 stride-2 maxpool, padding 1
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(
            0, 2, 3, 1).contiguous()
        feats = []
        for li, (stride, dilation) in enumerate(_LAYER_STRIDES):
            for bi, blk in enumerate(getattr(self, f"layer{li + 1}")):
                h = blk(h, stride=stride if bi == 0 else 1,
                        dilation=dilation, impl=impl)
            feats.append(h)
        x2, x3, x4, x5 = feats

        # PSP context encoding
        hw = x5.shape[1:3]
        priors = []
        for size, st in zip(_PSP_SIZES, self.psp.stages):
            p = _abn(st.bn, conv2d(st.conv, adaptive_avg_pool(x5, size),
                                   impl=impl))
            priors.append(_resize_bilinear(p, hw))
        priors.append(x5)
        bott = self.psp.bottleneck
        ctx = _abn(bott.bn, conv2d(bott.conv, torch.cat(priors, -1),
                                   impl=impl))

        # decoder
        dec = self.decoder
        xt = _resize_bilinear(_abn(dec.conv1.bn, conv2d(dec.conv1.conv, ctx,
                                                        impl=impl)),
                              x2.shape[1:3])
        xl = _abn(dec.conv2.bn, conv2d(dec.conv2.conv, x2, impl=impl))
        d = torch.cat([xt, xl], -1)
        d = _abn(dec.conv3a.bn, conv2d(dec.conv3a.conv, d, impl=impl))
        d = _abn(dec.conv3b.bn, conv2d(dec.conv3b.conv, d, impl=impl))
        parsing = conv2d(dec.conv4, d, impl=impl)

        # edge branch
        e = self.edge
        hw2 = x2.shape[1:3]
        f1 = _abn(e.conv1.bn, conv2d(e.conv1.conv, x2, impl=impl))
        f2 = _abn(e.conv2.bn, conv2d(e.conv2.conv, x3, impl=impl))
        f3 = _abn(e.conv3.bn, conv2d(e.conv3.conv, x4, impl=impl))
        e1, e2, e3 = (conv2d(e.conv4, f, impl=impl) for f in (f1, f2, f3))
        f2, f3 = _resize_bilinear(f2, hw2), _resize_bilinear(f3, hw2)
        e2, e3 = _resize_bilinear(e2, hw2), _resize_bilinear(e3, hw2)
        edge = conv2d(e.conv5, torch.cat([e1, e2, e3], -1), impl=impl)
        edge_fea = torch.cat([f1, f2, f3], -1)

        # fusion branch (the served output)
        fu = self.fusion
        fused = _abn(fu.conv.bn, conv2d(fu.conv.conv,
                                        torch.cat([d, edge_fea], -1),
                                        impl=impl))
        return parsing, conv2d(fu.out, fused, impl=impl), edge


def init_schp(seed: int = 0, num_classes: int = ATR_CLASSES, *,
              dtype=torch.float32, device="cuda") -> SCHPNet:
    """The net with seeded random weights (fan-in normal kernels, zero
    biases, identity batch norms)."""
    from idmvton_tpu_torch.models.layers import reset_parameters_
    net = SCHPNet(num_classes, dtype=dtype, device=device)
    reset_parameters_(net, torch.Generator(device=device).manual_seed(seed))
    return net


def schp_from_tree(tree: dict, num_classes: int, *, dtype=torch.float32,
                   device="cuda") -> SCHPNet:
    """An ``SCHPNet`` filled from a converted tree; a conv whose leaf has a
    bias the init layout lacks (a BN-folded ONNX export) gets one."""
    from idmvton_tpu_torch.weights.from_jax import load_module_params
    net = SCHPNet(num_classes, dtype=dtype, device=device)

    def add_biases(module, sub):
        items = enumerate(sub) if isinstance(sub, list) else sub.items()
        for key, leaf in items:
            child = module[key] if isinstance(module, nn.ModuleList) \
                else getattr(module, key)
            if isinstance(child, Conv) and "bias" in leaf \
                    and child.bias is None:
                child.bias = nn.Parameter(torch.zeros(
                    child.kernel.shape[-1], dtype=dtype, device=device),
                    requires_grad=False)
            elif isinstance(leaf, (dict, list)) and not isinstance(child,
                                                                    Conv):
                add_biases(child, leaf)

    add_biases(net, tree)
    return load_module_params(net, tree)


# ---------------------------------------------------------------------------
# torch .pth converter
# ---------------------------------------------------------------------------


def convert_schp(sd, num_classes: int = ATR_CLASSES, dtype=torch.float32, *,
                 strict: bool = False) -> dict:
    """SCHP checkpoint (exp-schp-201908301523-atr.pth style state dict,
    possibly with 'module.' prefixes) -> the net's tree (CPU tensors)."""
    from idmvton_tpu_torch.preprocess.densepose.convert import (
        as_numpy, tensor,
    )
    sd = {k.replace("module.", ""): as_numpy(v) for k, v in sd.items()}
    used = set()

    def _g(key):
        used.add(key)
        return sd[key]

    def conv(key, bias=False):
        p = {"kernel": tensor(np.transpose(_g(key + ".weight"),
                                           (2, 3, 1, 0)), dtype)}
        # bias whenever present: BN-folded ONNX exports add biases to convs
        # that are bias-free in the .pth layout
        if key + ".bias" in sd:
            p["bias"] = tensor(_g(key + ".bias"), dtype)
        return p

    def bn(key):
        return {name: tensor(_g(key + suffix), torch.float32)
                for name, suffix in (("scale", ".weight"), ("bias", ".bias"),
                                     ("mean", ".running_mean"),
                                     ("var", ".running_var"))}

    def conv_bn(ck, bk):
        return {"conv": conv(ck), "bn": bn(bk)}

    params = {"stem": [conv_bn(f"conv{i}", f"bn{i}") for i in (1, 2, 3)]}
    for li in range(4):
        layer = []
        for bi in range(_LAYERS[li]):
            pre = f"layer{li + 1}.{bi}"
            blk = {f"conv{j}": conv_bn(f"{pre}.conv{j}", f"{pre}.bn{j}")
                   for j in (1, 2, 3)}
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = conv_bn(f"{pre}.downsample.0",
                                            f"{pre}.downsample.1")
            layer.append(blk)
        params[f"layer{li + 1}"] = layer
    params["psp"] = {
        "stages": [conv_bn(f"context_encoding.stages.{i}.1",
                           f"context_encoding.stages.{i}.2")
                   for i in range(len(_PSP_SIZES))],
        "bottleneck": conv_bn("context_encoding.bottleneck.0",
                              "context_encoding.bottleneck.1"),
    }
    params["edge"] = {
        "conv1": conv_bn("edge.conv1.0", "edge.conv1.1"),
        "conv2": conv_bn("edge.conv2.0", "edge.conv2.1"),
        "conv3": conv_bn("edge.conv3.0", "edge.conv3.1"),
        "conv4": conv("edge.conv4", bias=True),
        "conv5": conv("edge.conv5", bias=True),
    }
    params["decoder"] = {
        "conv1": conv_bn("decoder.conv1.0", "decoder.conv1.1"),
        "conv2": conv_bn("decoder.conv2.0", "decoder.conv2.1"),
        "conv3a": conv_bn("decoder.conv3.0", "decoder.conv3.1"),
        "conv3b": conv_bn("decoder.conv3.2", "decoder.conv3.3"),
        "conv4": conv("decoder.conv4", bias=True),
    }
    params["fusion"] = {
        "conv": conv_bn("fushion.0", "fushion.1"),
        "out": conv("fushion.3", bias=True),
    }
    if strict:
        from idmvton_tpu_torch.weights.converter import check_consumed
        check_consumed(sd, used)
    return params


# ---------------------------------------------------------------------------
# ONNX ingestion — the reference ships the parsing models ONLY as ONNX
# (run_parsing.py:20-22: ckpt/humanparsing/parsing_atr.onnx / parsing_lip.onnx)
# ---------------------------------------------------------------------------


def _trace_order(num_classes: int):
    """(kind, torch-key) sequence in AugmentCE2P.forward trace order
    (networks/AugmentCE2P.py:348-364; submodule forwards :162,:240,:286).
    This is the order Conv/BatchNormalization nodes appear in an ONNX export,
    used to bind anonymous initializers positionally."""
    del num_classes
    seq = []
    for i in (1, 2, 3):
        seq += [("conv", f"conv{i}"), ("bn", f"bn{i}")]
    for li in range(4):
        for bi in range(_LAYERS[li]):
            pre = f"layer{li + 1}.{bi}"
            for j in (1, 2, 3):
                seq += [("conv", f"{pre}.conv{j}"), ("bn", f"{pre}.bn{j}")]
            if bi == 0:  # first block of each layer has the projection
                seq += [("conv", f"{pre}.downsample.0"),
                        ("bn", f"{pre}.downsample.1")]
    for i in range(len(_PSP_SIZES)):
        seq += [("conv", f"context_encoding.stages.{i}.1"),
                ("bn", f"context_encoding.stages.{i}.2")]
    seq += [("conv", "context_encoding.bottleneck.0"),
            ("bn", "context_encoding.bottleneck.1")]
    # decoder before edge (AugmentCE2P.py:358-360)
    seq += [("conv", "decoder.conv1.0"), ("bn", "decoder.conv1.1"),
            ("conv", "decoder.conv2.0"), ("bn", "decoder.conv2.1"),
            ("conv", "decoder.conv3.0"), ("bn", "decoder.conv3.1"),
            ("conv", "decoder.conv3.2"), ("bn", "decoder.conv3.3"),
            ("conv", "decoder.conv4")]
    # edge trace: conv1,conv4, conv2,conv4(shared), conv3,conv4(shared), conv5
    seq += [("conv", "edge.conv1.0"), ("bn", "edge.conv1.1"),
            ("conv", "edge.conv4"),
            ("conv", "edge.conv2.0"), ("bn", "edge.conv2.1"),
            ("conv", "edge.conv3.0"), ("bn", "edge.conv3.1"),
            ("conv", "edge.conv5")]
    seq += [("conv", "fushion.0"), ("bn", "fushion.1"), ("conv", "fushion.3")]
    return seq


def _positional_state_dict(model, num_classes: int) -> Dict[str, np.ndarray]:
    """Bind anonymous ONNX initializers to torch keys by walking
    Conv/BatchNormalization nodes in graph (trace) order. Shared weights
    (edge.conv4 is applied three times, AugmentCE2P.py:245-250) bind on
    first occurrence only. BN-folded exports (no BatchNormalization nodes)
    simply skip past the bn slots."""
    inits = model.initializers
    order = _trace_order(num_classes)
    pos = 0
    sd: Dict[str, np.ndarray] = {}
    bound = set()

    def advance_to(kind):
        nonlocal pos
        # a Conv node may legitimately skip bn slots (folded exports); a
        # BatchNormalization node must never skip a conv slot
        while pos < len(order) and order[pos][0] != kind:
            if order[pos][0] == "conv":
                raise ValueError(f"trace mismatch: expected conv "
                                 f"'{order[pos][1]}' before next {kind}")
            pos += 1
        if pos >= len(order):
            raise ValueError(f"more {kind} nodes than trace slots")
        pos += 1
        return order[pos - 1][1]

    for node in model.nodes:
        if node.op_type == "Conv":
            w = node.inputs[1]
            if w not in inits or w in bound:
                continue  # dynamic weight, or a shared module re-applied
            bound.add(w)
            key = advance_to("conv")
            sd[key + ".weight"] = inits[w]
            if len(node.inputs) > 2 and node.inputs[2] in inits:
                sd[key + ".bias"] = inits[node.inputs[2]]
        elif node.op_type == "BatchNormalization":
            names = node.inputs[1:5]  # scale, B, mean, var
            if names[0] in bound:
                continue
            bound.add(names[0])
            key = advance_to("bn")
            for suffix, n in zip(
                    (".weight", ".bias", ".running_mean", ".running_var"),
                    names):
                sd[key + suffix] = inits[n]
    unbound_convs = [k for kind, k in order[pos:] if kind == "conv"]
    if unbound_convs:
        raise ValueError(f"unbound conv slots after node walk: "
                         f"{unbound_convs}")
    return sd


def _synthesize_identity_bn(sd: Dict[str, np.ndarray],
                            num_classes: int) -> Dict[str, np.ndarray]:
    """For BN-folded exports: every bn slot missing from sd becomes the
    identity under _bn's eps=1e-5 (scale=sqrt(1+eps), zero mean/bias).
    Channel count comes from the conv traced immediately before the bn."""
    out = dict(sd)
    order = _trace_order(num_classes)
    for i, (kind, key) in enumerate(order):
        if kind != "bn" or key + ".weight" in out:
            continue
        prev_kind, prev_key = order[i - 1]
        assert prev_kind == "conv", (key, prev_key)
        ch = out[prev_key + ".weight"].shape[0]
        out[key + ".weight"] = np.full((ch,), np.sqrt(1.0 + 1e-5), np.float32)
        out[key + ".bias"] = np.zeros((ch,), np.float32)
        out[key + ".running_mean"] = np.zeros((ch,), np.float32)
        out[key + ".running_var"] = np.ones((ch,), np.float32)
    return out


def convert_schp_onnx(path, num_classes: int = ATR_CLASSES,
                      dtype=torch.float32, *, strict: bool = False) -> dict:
    """An SCHP ONNX artifact (the format the reference ships,
    parsing_atr.onnx / parsing_lip.onnx) -> the net's tree. Handles
    name-preserving exports, name-preserving exports with BN folded into
    the convs (identity BN synthesized), and anonymous initializers (bound
    positionally by a walk of the node trace)."""
    from idmvton_tpu_torch.weights.onnx_reader import read_onnx

    model = read_onnx(path)
    sd = {k[7:] if k.startswith("module.") else k: v
          for k, v in model.initializers.items()}
    if "conv1.weight" not in sd:
        sd = _positional_state_dict(model, num_classes)
    if "bn1.weight" not in sd:  # BN folded into convs
        sd = _synthesize_identity_bn(sd, num_classes)
    # graph constants (Shape / Resize parameters) are expected leftovers of
    # an ONNX graph: strict consumption applies to the rebuilt dict
    return convert_schp(sd, num_classes, dtype, strict=strict)


# ---------------------------------------------------------------------------
# runtime wrapper: ATR + LIP fusion and the OpenCV postprocess
# ---------------------------------------------------------------------------

_MEAN_BGR = np.asarray([0.406, 0.456, 0.485], np.float32)
_STD_BGR = np.asarray([0.225, 0.224, 0.229], np.float32)


def _letterbox(image_rgb: np.ndarray, size: int):
    """Aspect-preserving center placement into (size, size) (the reference's
    box-to-center/scale affine on the whole image). Returns (input, meta)."""
    import cv2
    h, w = image_rgb.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = cv2.resize(image_rgb, (nw, nh), interpolation=cv2.INTER_LINEAR)
    canvas = np.zeros((size, size, 3), np.uint8)
    top, left = (size - nh) // 2, (size - nw) // 2
    canvas[top:top + nh, left:left + nw] = resized
    return canvas, (top, left, nh, nw, h, w)


def _unletterbox_logits(logits: np.ndarray, meta):
    import cv2
    top, left, nh, nw, h, w = meta
    crop = logits[top:top + nh, left:left + nw]
    return cv2.resize(crop, (w, h), interpolation=cv2.INTER_LINEAR)


class Parsing:
    """ATR (18-class) + LIP (20-class) parse with the reference postprocess:
    upper-cloth hole filling, arm-hole refinement, neck label 18. Returns
    (palette PIL image, face mask float array); ``labels`` gives the label
    array alone. The nets default to the seeded random ones (seeds 0, 1) on
    ``device``; ``impl`` is the conv sites' impl (None: follow the
    device)."""

    def __init__(self, atr: Optional[SCHPNet] = None,
                 lip: Optional[SCHPNet] = None, *, device="cuda", impl=None):
        self.atr = atr if atr is not None else init_schp(
            0, ATR_CLASSES, device=device)
        self.lip = lip if lip is not None else init_schp(
            1, LIP_CLASSES, device=device)
        self.impl = impl

    @staticmethod
    def from_torch(atr_path: str, lip_path: str, *,
                   device="cuda") -> "Parsing":
        from idmvton_tpu_torch.weights.converter import load_state_dict
        return Parsing(*(schp_from_tree(convert_schp(load_state_dict(p), n),
                                        n, device=device)
                         for p, n in ((atr_path, ATR_CLASSES),
                                      (lip_path, LIP_CLASSES))))

    @staticmethod
    def from_onnx(atr_path: str, lip_path: str, *,
                  device="cuda") -> "Parsing":
        """Load the artifact format the reference ships (parsing_atr.onnx /
        parsing_lip.onnx)."""
        return Parsing(*(schp_from_tree(convert_schp_onnx(p, n), n,
                                        device=device)
                         for p, n in ((atr_path, ATR_CLASSES),
                                      (lip_path, LIP_CLASSES))))

    @staticmethod
    def net_input(image_rgb: np.ndarray, size: int):
        """The letterboxed, normalized (1, size, size, 3) BGR input and the
        letterbox's meta."""
        inp, meta = _letterbox(image_rgb, size)
        bgr = inp[:, :, ::-1].astype(np.float32) / 255.0
        return ((bgr - _MEAN_BGR) / _STD_BGR)[None], meta

    def fusion_logits(self, net: SCHPNet, x: np.ndarray):
        """The net's fusion logits on one prepared input, upsampled
        (align_corners) to the input's size on the device: (1, S, S, C)."""
        dev = next(net.parameters()).device
        with torch.no_grad():
            _, fusion, _ = net(torch.from_numpy(
                np.ascontiguousarray(x)).to(dev), impl=self.impl)
            return _resize_bilinear(fusion, x.shape[1:3])

    def _logits(self, net: SCHPNet, image_rgb: np.ndarray,
                size: int) -> np.ndarray:
        x, meta = self.net_input(image_rgb, size)
        fusion = self.fusion_logits(net, x)[0].cpu().numpy()
        return _unletterbox_logits(fusion, meta)

    def labels(self, image_rgb: np.ndarray) -> np.ndarray:
        """The (H, W) label array: the refined ATR argmax with LIP's neck."""
        atr_logits = self._logits(self.atr, image_rgb, 512)
        parsing = refine_cloth(np.argmax(atr_logits, axis=2))
        lip_logits = self._logits(self.lip, image_rgb, 473)
        return add_neck(parsing, np.argmax(lip_logits, axis=2))

    def __call__(self, image_rgb: np.ndarray):
        from PIL import Image
        parsing = self.labels(image_rgb)
        out = Image.fromarray(parsing.astype(np.uint8))
        out.putpalette(get_palette(19))
        face_mask = (parsing == 11).astype(np.float32)
        return out, face_mask


def refine_cloth(parsing: np.ndarray) -> np.ndarray:
    """ATR postprocess: hole-fill the upper-cloth+arms union, keep >2000 px
    holes between arm and cloth (parsing_api.py:142-156 semantics).
    parsing: (H, W) int argmax of the ATR logits; returns same shape."""
    import cv2
    from idmvton_tpu_torch.preprocess.agnostic_mask import _fill_holes

    parsing = np.pad(parsing, 1, mode="constant")

    # hole-fill the upper cloth + arms union (parsing_api.py:144-150)
    arm = ((parsing == 14) | (parsing == 15)).astype(np.float32)
    cloth_union = (parsing == 4).astype(np.float32) + arm
    filled = _fill_holes(np.where(cloth_union, 255, 0).astype(np.uint8))
    filled4 = filled.astype(np.float32) / 255 * 4
    woarm = np.where(filled4 == 4, filled4, parsing)

    # refined holes between arm and cloth (> 2000 px) keep their label
    # (parsing_api.py:109-119 refine_hole, applied at :152-154)
    hole = cv2.bitwise_and(
        np.where(filled4 == 4, 255, 0).astype(np.uint8),
        np.where(parsing != 4, 255, 0).astype(np.uint8)) - \
        (arm * 255).astype(np.uint8)
    contours, _ = cv2.findContours(hole, cv2.RETR_CCOMP,
                                   cv2.CHAIN_APPROX_TC89_L1)
    refine = np.zeros_like(parsing, np.uint8)
    for c in contours:
        if abs(cv2.contourArea(c, True)) > 2000:
            cv2.drawContours(refine, [c], -1, 255, -1)
    refine = refine + (arm * 255).astype(np.uint8)
    return np.where(refine, parsing, woarm)[1:-1, 1:-1]


def add_neck(parsing: np.ndarray, lip_parsing: np.ndarray) -> np.ndarray:
    """neck = ATR head(11) minus LIP face(13) -> label 18
    (parsing_api.py:176-179)."""
    neck = np.logical_and(np.logical_not(lip_parsing == 13), parsing == 11)
    return np.where(neck, 18, parsing)


def get_palette(num_cls: int) -> List[int]:
    """Standard PASCAL-style segmentation palette."""
    palette = [0] * (num_cls * 3)
    for j in range(num_cls):
        lab, i = j, 0
        while lab:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette
