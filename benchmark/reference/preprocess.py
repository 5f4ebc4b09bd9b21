"""Plain fp32 reference of the demo's three preprocessing nets, in PyTorch.

Written from the published descriptions and frozen here as the
benchmark's yardstick for the configuration ``idmvton_demo_preprocess``;
it imports nothing of the program under test and no kernel, computes in
float32 with TF32 off (``stack.fp32_mode``) and rounds every product's
operands as ``stack.operands`` says (exactly, or through e4m3 for the
control). Feature maps are NHWC, conv kernels HWIO ``(kh, kw, in, out)``,
linear kernels ``(in, out)``; weights are the flat dict
``{"<component>.<name>": tensor}`` that ``param_specs`` lists from the
configuration alone, the names the program's modules carry.

- **OpenPose body** (CMU ``bodypose_model``, lllyasviel's ControlNet
  annotator ``body_pose_model.pth``): VGG-19's first ten convs and two CPM
  convs, then six stages of two branches (L1: 38 PAF channels, L2: 19
  heatmaps), stage 1 three 3x3 convs of 128 and two 1x1, stages 2-6 five
  7x7 convs of 128 and two 1x1 over [PAF | heatmap | trunk]; ReLU after
  every conv but each branch's last. ``openpose`` returns the last stage's
  (PAF, heatmap) at 1/8 of the input.
- **SCHP** (AugmentCE2P, ``networks/AugmentCE2P.py``): ResNet-101 with a
  three-conv stem, layer4 at stride 1 and dilation 2; the PSP module
  (pools 1, 2, 3, 6, 1x1 convs of 512, a 3x3 bottleneck of 512); the
  decoder (its 48-channel skip from layer1); the edge branch (one shared
  3x3 edge conv over three levels, a 1x1 fusion); the fusion head over
  [decoder | edge features]. InPlaceABN at inference is batch norm and
  leaky ReLU (0.01); the bottleneck's norms are plain batch norm with ReLU.
  Bilinear resizes keep ``align_corners=True``. ``schp`` returns the
  fusion logits at 1/4 of the input; ``letterbox`` is the demo's
  aspect-preserving centre placement.
- **DensePose R-50-FPN** (detectron2 ``densepose_rcnn_R_50_FPN_s1x.yaml``
  over ``Base-DensePose-RCNN-FPN.yaml``): ResNet-50 (stride in the 1x1,
  frozen batch norm), FPN P2-P6 (P6 a stride-2 subsample of P5), the box
  head (ROIAlign 7, two FC of 1024, person + background), the
  Panoptic-FPN decoder (max(1, level) 3x3 convs of 256 a level, bilinear
  x2 above stride 4, summed, a 1x1 predictor of 256), the
  ``DensePoseV1ConvXHead`` (eight 3x3 convs of 512 over ROIAlign 28 of the
  decoder) and its predictors (ConvTranspose 4, stride 2, then bilinear x2
  to 112: coarse segmentation 2, fine 25, U 25, V 25).
- **The mask step** (IDM-VTON ``gradio_demo/utils_mask.py::
  get_mask_location`` at "hd", "upper_body"): host code on numpy, OpenCV
  and PIL as published (``mask_location``), for the CPU tests; the cell's
  check leaves it out, as it leaves out every discrete decision.

Departures from the published nets, each kept because the program (and
the JAX package it holds parity with) makes it:

- DensePose's box head pools with ROIAlignV2 at a fixed sampling ratio of
  2; detectron2's ``POOLER_SAMPLING_RATIO`` for the box head is 0
  (adaptive: ceil(roi size / 7) points a bin). The DensePose head's ratio,
  2, is the published one.
- The box head's first FC reads the pooled features flattened (h, w, c)
  where detectron2 flattens (c, h, w): a layout of the same weights.
- The RPN's NMS runs once over all levels, where detectron2 runs it per
  level; the check gives the reference the program's own proposals, so
  it does not enter a comparison.
- SCHP's letterbox is a resize and a centred paste, where SCHP warps with
  one affine transform; both place the image at the same scale and
  centre.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import stack as S

# ---------------------------------------------------------------------------
# primitives (NHWC, fp32, operands rounded as ``stack.operands`` says)
# ---------------------------------------------------------------------------


def conv(p, x, *, stride=1, pad=None, dilation=1, bias=True):
    """NHWC conv with an HWIO kernel; ``pad`` on every side, by default
    ``dilation * (k // 2)``."""
    k = p("kernel")
    if pad is None:
        pad = dilation * (k.shape[0] // 2)
    y = F.conv2d(S._operand(x.permute(0, 3, 1, 2)),
                 S._operand(k.permute(3, 2, 0, 1)), stride=stride,
                 padding=pad, dilation=dilation).permute(0, 2, 3, 1)
    if bias and p.has("bias"):
        y = y + p("bias")
    return y


def deconv2x(p, x):
    """ConvTranspose2d(k=4, stride 2, padding 1), HWIO kernel (in, out at
    positions 2, 3)."""
    y = F.conv_transpose2d(S._operand(x.permute(0, 3, 1, 2)),
                           S._operand(p("kernel").permute(2, 3, 0, 1)),
                           stride=2, padding=1).permute(0, 2, 3, 1)
    return y + p("bias")


def batch_norm(p, x, eps=1e-5):
    return (x - p("mean")) * torch.rsqrt(p("var") + eps) * p("scale") \
        + p("bias")


def frozen_bn(p, x):
    return x * p("scale") + p("bias")


def nchw(fn, x, *a, **kw):
    return fn(x.permute(0, 3, 1, 2), *a, **kw).permute(0, 2, 3, 1)


def bilinear(x, hw, align_corners):
    return nchw(F.interpolate, x, size=tuple(hw), mode="bilinear",
                align_corners=align_corners)


# ---------------------------------------------------------------------------
# OpenPose body
# ---------------------------------------------------------------------------

OPENPOSE_TRUNK = (("conv1_1", 3, 64), ("conv1_2", 64, 64),
                  ("conv2_1", 64, 128), ("conv2_2", 128, 128),
                  ("conv3_1", 128, 256), ("conv3_2", 256, 256),
                  ("conv3_3", 256, 256), ("conv3_4", 256, 256),
                  ("conv4_1", 256, 512), ("conv4_2", 512, 512),
                  ("conv4_3_CPM", 512, 256), ("conv4_4_CPM", 256, 128))
OPENPOSE_POOL_AFTER = ("conv1_2", "conv2_2", "conv3_4")


def openpose_blocks(cfg: dict) -> dict:
    """{block: [(conv name, in, out, k)]} in the forward's order."""
    paf, heat = cfg["paf_channels"], cfg["heatmap_channels"]
    blocks = {"model0": [(n, i, o, 3) for n, i, o in OPENPOSE_TRUNK]}
    for br, out in (("L1", paf), ("L2", heat)):
        blocks[f"model1_{br[1]}"] = (
            [(f"conv5_{i}_CPM_{br}", 128, 128, 3) for i in (1, 2, 3)]
            + [(f"conv5_4_CPM_{br}", 128, 512, 1),
               (f"conv5_5_CPM_{br}", 512, out, 1)])
    for n in range(2, cfg["stages"] + 1):
        for br, out in (("L1", paf), ("L2", heat)):
            blocks[f"model{n}_{br[1]}"] = (
                [(f"Mconv1_stage{n}_{br}", 128 + paf + heat, 128, 7)]
                + [(f"Mconv{i}_stage{n}_{br}", 128, 128, 7)
                   for i in (2, 3, 4, 5)]
                + [(f"Mconv6_stage{n}_{br}", 128, 128, 1),
                   (f"Mconv7_stage{n}_{br}", 128, out, 1)])
    return blocks


def _openpose_block(W, cfg, block, x, relu_last):
    convs = openpose_blocks(cfg)[block]
    for i, (name, _, _, _) in enumerate(convs):
        x = conv(W.sub(f"{block}.{name}"), x)
        if relu_last or i < len(convs) - 1:
            x = F.relu(x)
        if name in OPENPOSE_POOL_AFTER:
            x = nchw(F.max_pool2d, x, 2, 2)
    return x


def openpose(W, cfg: dict, x, *, stages=None):
    """x (B, H, W, 3) BGR in [-0.5, 0.5] -> (PAF, heatmap) of stage
    ``stages`` (the last by default) at (H / 8, W / 8). The last stage's
    heatmap branch ends in a ReLU: the published ``no_relu_layers`` names
    ``Mconv7_stage6_L1`` twice and ``Mconv7_stage6_L2`` not at all, and the
    weights were trained so."""
    last = stages or cfg["stages"]
    feat = _openpose_block(W, cfg, "model0", x, True)
    paf = _openpose_block(W, cfg, "model1_1", feat, False)
    heat = _openpose_block(W, cfg, "model1_2", feat, False)
    for n in range(2, last + 1):
        inp = torch.cat([paf, heat, feat], -1)
        paf = _openpose_block(W, cfg, f"model{n}_1", inp, False)
        heat = _openpose_block(W, cfg, f"model{n}_2", inp,
                               n == cfg["stages"])
    return paf, heat


def openpose_spec(cfg: dict) -> list:
    out = []
    for block, convs in openpose_blocks(cfg).items():
        for name, i, o, k in convs:
            S._conv(out, f"{block}.{name}", i, o, k)
    return out


# ---------------------------------------------------------------------------
# SCHP (AugmentCE2P)
# ---------------------------------------------------------------------------


def _schp_layers(cfg):
    """[(layer name, planes, blocks, stride, dilation)]."""
    return [(f"layer{i + 1}", 64 * 2 ** i, n, s, d) for i, (n, s, d) in
            enumerate(zip(cfg["blocks"], cfg["strides"], cfg["dilations"]))]


def _abn(p, x):
    return F.leaky_relu(batch_norm(p, x), 0.01)


def _conv_bn(p, x, **kw):
    return batch_norm(p.sub("bn"), conv(p.sub("conv"), x, bias=False, **kw))


def schp(W, cfg: dict, x):
    """x (B, S, S, 3) BGR normalized by SCHP's mean and std -> the fusion
    logits (B, S / 4, S / 4, classes)."""
    h = x
    for i in range(3):
        h = F.relu(_conv_bn(W.sub(f"stem.{i}"), h, stride=2 if i == 0
                            else 1))
    h = nchw(F.max_pool2d, h, 3, 2, 1)
    feats = []
    for name, _, n, stride, dil in _schp_layers(cfg):
        for b in range(n):
            p = W.sub(f"{name}.{b}")
            s = stride if b == 0 else 1
            y = F.relu(_conv_bn(p.sub("conv1"), h))
            y = F.relu(_conv_bn(p.sub("conv2"), y, stride=s, dilation=dil))
            y = _conv_bn(p.sub("conv3"), y)
            r = _conv_bn(p.sub("downsample"), h, stride=s) if p.has(
                "downsample.conv.kernel") else h
            h = F.relu(y + r)
        feats.append(h)
    x2, x3, x4, x5 = feats
    hw = x5.shape[1:3]
    priors = [bilinear(_abn(W.sub(f"psp.stages.{i}.bn"), conv(
        W.sub(f"psp.stages.{i}.conv"),
        nchw(F.adaptive_avg_pool2d, x5, size), bias=False)), hw, True)
        for i, size in enumerate(cfg["psp_sizes"])]
    ctx = _abn(W.sub("psp.bottleneck.bn"), conv(
        W.sub("psp.bottleneck.conv"), torch.cat(priors + [x5], -1),
        bias=False))
    d = W.sub("decoder")
    xt = bilinear(_abn(d.sub("conv1.bn"), conv(d.sub("conv1.conv"), ctx,
                                               bias=False)),
                  x2.shape[1:3], True)
    xl = _abn(d.sub("conv2.bn"), conv(d.sub("conv2.conv"), x2, bias=False))
    dec = torch.cat([xt, xl], -1)
    for c in ("conv3a", "conv3b"):
        dec = _abn(d.sub(f"{c}.bn"), conv(d.sub(f"{c}.conv"), dec,
                                          bias=False))
    e = W.sub("edge")
    hw2 = x2.shape[1:3]
    edge_fea = [_abn(e.sub(f"conv{i}.bn"), conv(e.sub(f"conv{i}.conv"), f,
                                                bias=False))
                for i, f in ((1, x2), (2, x3), (3, x4))]
    edge_fea = [f if f.shape[1:3] == hw2 else bilinear(f, hw2, True)
                for f in edge_fea]
    fu = W.sub("fusion")
    fused = _abn(fu.sub("conv.bn"), conv(
        fu.sub("conv.conv"), torch.cat([dec] + edge_fea, -1), bias=False))
    return conv(fu.sub("out"), fused)


def schp_spec(cfg: dict, classes: int) -> list:
    out = []

    def conv_bn(name, i, o, k):
        S._conv(out, f"{name}.conv", i, o, k, bias=False)
        for leaf, kind in (("scale", "scale"), ("bias", "shift"),
                           ("mean", "shift"), ("var", "scale")):
            out.append((f"{name}.bn.{leaf}", (o,), kind))

    for i, (ci, co) in enumerate(((3, 64), (64, 64), (64, 128))):
        conv_bn(f"stem.{i}", ci, co, 3)
    inplanes = 128
    for name, planes, n, stride, _ in _schp_layers(cfg):
        for b in range(n):
            cin = inplanes if b == 0 else 4 * planes
            conv_bn(f"{name}.{b}.conv1", cin, planes, 1)
            conv_bn(f"{name}.{b}.conv2", planes, planes, 3)
            conv_bn(f"{name}.{b}.conv3", planes, 4 * planes, 1)
            if b == 0 and (stride != 1 or inplanes != 4 * planes):
                conv_bn(f"{name}.{b}.downsample", inplanes, 4 * planes, 1)
        inplanes = 4 * planes
    for i, _ in enumerate(cfg["psp_sizes"]):
        conv_bn(f"psp.stages.{i}", 2048, 512, 1)
    conv_bn("psp.bottleneck", 2048 + 512 * len(cfg["psp_sizes"]), 512, 3)
    for i, ci in ((1, 256), (2, 512), (3, 1024)):
        conv_bn(f"edge.conv{i}", ci, 256, 1)
    S._conv(out, "edge.conv4", 256, 2, 3)
    S._conv(out, "edge.conv5", 6, 2, 1)
    conv_bn("decoder.conv1", 512, 256, 1)
    conv_bn("decoder.conv2", 256, 48, 1)
    conv_bn("decoder.conv3a", 304, 256, 1)
    conv_bn("decoder.conv3b", 256, 256, 1)
    S._conv(out, "decoder.conv4", 256, classes, 1)
    conv_bn("fusion.conv", 1024, 256, 1)
    S._conv(out, "fusion.out", 256, classes, 1)
    return out


SCHP_MEAN_BGR = (0.406, 0.456, 0.485)
SCHP_STD_BGR = (0.225, 0.224, 0.229)


def letterbox(image_rgb, size: int):
    """(H, W, 3) uint8 -> (1, size, size, 3) fp32 SCHP input and the
    placement (top, left, nh, nw): the image scaled by size / max(H, W)
    (bilinear, half-pixel centres, rounded to uint8 as the demo's OpenCV
    resize of a uint8 image), pasted at the centre of a black square,
    BGR, normalized by SCHP's mean and std."""
    img = torch.as_tensor(image_rgb).float()
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        img = bilinear(img[None], (nh, nw), False)[0].round().clamp(0, 255)
    canvas = img.new_zeros(size, size, 3)
    top, left = (size - nh) // 2, (size - nw) // 2
    canvas[top:top + nh, left:left + nw] = img
    bgr = canvas.flip(-1) / 255.0
    mean = torch.tensor(SCHP_MEAN_BGR)
    std = torch.tensor(SCHP_STD_BGR)
    return ((bgr - mean) / std)[None], (top, left, nh, nw)


# ---------------------------------------------------------------------------
# DensePose R-50-FPN
# ---------------------------------------------------------------------------

R50_BLOCKS = (3, 4, 6, 3)
FPN_DIM = 256


def resnet50_fpn(W, x):
    """x (1, H, W, 3) BGR minus the pixel mean -> [P2 .. P6]."""
    b = W.sub("backbone")
    h = frozen_bn(b.sub("stem.bn"), conv(b.sub("stem.conv"), x, stride=2,
                                         bias=False))
    h = nchw(F.max_pool2d, F.relu(h), 3, 2, 1)
    res = []
    for li, n in enumerate(R50_BLOCKS):
        for bi in range(n):
            p = b.sub(f"res{li + 2}.{bi}")
            s = 2 if li and bi == 0 else 1
            y = F.relu(frozen_bn(p.sub("conv1.bn"), conv(
                p.sub("conv1.conv"), h, stride=s, bias=False)))
            y = F.relu(frozen_bn(p.sub("conv2.bn"), conv(
                p.sub("conv2.conv"), y, bias=False)))
            y = frozen_bn(p.sub("conv3.bn"), conv(p.sub("conv3.conv"), y,
                                                  bias=False))
            r = frozen_bn(p.sub("shortcut.bn"), conv(
                p.sub("shortcut.conv"), h, stride=s, bias=False)) \
                if bi == 0 else h
            h = F.relu(y + r)
        res.append(h)
    lat = [conv(W.sub(f"fpn.lateral.{i}"), r) for i, r in enumerate(res)]
    for i in (2, 1, 0):
        up = nchw(F.interpolate, lat[i + 1], scale_factor=2, mode="nearest")
        lat[i] = lat[i] + up[:, :lat[i].shape[1], :lat[i].shape[2]]
    ps = [conv(W.sub(f"fpn.output.{i}"), lat[i]) for i in range(4)]
    return ps + [ps[3][:, ::2, ::2]]


def roi_align(feat, boxes, out: int, scale: float, ratio: int):
    """detectron2 ROIAlignV2 (aligned=True) of (1, H, W, C) at
    ``ratio`` x ``ratio`` points a bin, averaged; boxes (R, 4) xyxy in
    image coordinates -> (R, out, out, C). Points outside (-1, size) read
    zero."""
    _, h, w, c = feat.shape
    bx = boxes.float() * scale - 0.5
    x1, y1 = bx[:, 0], bx[:, 1]
    bw = (bx[:, 2] - x1) / out
    bh = (bx[:, 3] - y1) / out
    grid = (torch.arange(out * ratio, dtype=torch.float32,
                         device=feat.device) + 0.5) / ratio
    ys = y1[:, None] + grid[None] * bh[:, None]          # (R, out * ratio)
    xs = x1[:, None] + grid[None] * bw[:, None]
    f = feat[0]

    def axis(v, n):
        inside = (v >= -1.0) & (v <= n)
        v = v.clamp(min=0.0)
        lo = v.floor().long()
        top = lo >= n - 1
        lo = torch.where(top, n - 1, lo)
        hi = torch.where(top, n - 1, lo + 1)
        frac = torch.where(top, torch.zeros_like(v), v - lo.float())
        return lo, hi, frac, inside

    y0, y1_, fy, iny = axis(ys, h)
    x0, x1_, fx, inx = axis(xs, w)
    rows = []
    for r in range(boxes.shape[0]):
        def g(yi, xi):
            return f[yi[r]][:, xi[r]]                    # (P, P, C)
        wy0, wy1 = (1 - fy[r])[:, None, None], fy[r][:, None, None]
        wx0, wx1 = (1 - fx[r])[None, :, None], fx[r][None, :, None]
        v = (g(y0, x0) * wy0 * wx0 + g(y0, x1_) * wy0 * wx1
             + g(y1_, x0) * wy1 * wx0 + g(y1_, x1_) * wy1 * wx1)
        v = v * (iny[r][:, None, None] & inx[r][None, :, None])
        rows.append(v.reshape(out, ratio, out, ratio, c).mean((1, 3)))
    return torch.stack(rows)


def fpn_levels(boxes):
    """The FPN level of each box (0 for P2 .. 3 for P5): floor(4 +
    log2(sqrt(area) / 224)), clamped."""
    area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    lvl = torch.floor(4 + torch.log2(area.clamp_min(1e-6).sqrt() / 224.0
                                     + 1e-8))
    return lvl.clamp(2, 5).long() - 2


def box_pooled(cfg, ps, boxes, chunk=200):
    """The box head's input of each proposal (R, 4): ROIAlign 7 on its
    level, flattened (h, w, c)."""
    lv = fpn_levels(boxes)
    out = []
    for c0 in range(0, boxes.shape[0], chunk):
        bx = boxes[c0:c0 + chunk]
        pooled = 0
        for i in range(4):
            sel = (lv[c0:c0 + chunk] == i).float()[:, None, None, None]
            pooled = pooled + sel * roi_align(
                ps[i], bx, cfg["box_pooler"], 1.0 / (4 * 2 ** i),
                cfg["sampling_ratio"])
        out.append(pooled.reshape(bx.shape[0], -1))
    return torch.cat(out)


def box_fc(W, h):
    """The box head's class logits (person, background) from its pooled
    input: two FC of 1024 with ReLU, the class FC."""
    h = F.relu(S.linear(W.sub("box_head.fc1"), h))
    h = F.relu(S.linear(W.sub("box_head.fc2"), h))
    return S.linear(W.sub("box_head.cls"), h)


def box_logits(W, cfg, ps, boxes):
    """The class logits (person, background) of each proposal (R, 4)."""
    return box_fc(W, box_pooled(cfg, ps, boxes))


def box_scores(W, cfg, ps, boxes):
    """The person probability of each proposal: softmax of ``box_logits``
    over (person, background)."""
    return torch.softmax(box_logits(W, cfg, ps, boxes), -1)[:, 0]


def decoder(W, ps):
    total = 0
    for lvl in range(4):
        h = ps[lvl]
        for j in range(max(1, lvl)):
            h = F.relu(conv(W.sub(f"decoder.scale_heads.{lvl}.{j}"), h))
            if lvl > 0:
                h = bilinear(h, (2 * h.shape[1], 2 * h.shape[2]), False)
        total = total + h
    return conv(W.sub("decoder.predictor"), total)


def densepose_head(W, cfg, dec, boxes, chunk=20):
    """The head's outputs on boxes (K, 4): ROIAlign 28 of the decoder's
    stride-4 map, eight 3x3 convs of 512 with ReLU, each predictor's
    ConvTranspose and bilinear to 112. {coarse, fine, u, v}."""
    outs = {k: [] for k in ("coarse", "fine", "u", "v")}
    size = (cfg["heatmap_size"],) * 2
    for c0 in range(0, boxes.shape[0], chunk):
        h = roi_align(dec, boxes[c0:c0 + chunk], cfg["dp_pooler"], 0.25,
                      cfg["sampling_ratio"])
        for i in range(cfg["dp_convs"]):
            h = F.relu(conv(W.sub(f"dp_head.convs.{i}"), h))
        for k, name in (("coarse", "coarse_segm"), ("fine", "fine_segm"),
                        ("u", "u"), ("v", "v")):
            outs[k].append(bilinear(deconv2x(W.sub(f"dp_head.{name}"), h),
                                    size, False))
    return {k: torch.cat(v) for k, v in outs.items()}


def densepose_spec(cfg: dict) -> list:
    out = []

    def conv_bn(name, i, o, k):
        S._conv(out, f"{name}.conv", i, o, k, bias=False)
        out.append((f"{name}.bn.scale", (o,), "scale"))
        out.append((f"{name}.bn.bias", (o,), "shift"))

    conv_bn("backbone.stem", 3, 64, 7)
    inplanes = 64
    for li, n in enumerate(R50_BLOCKS):
        planes = 64 * 2 ** li
        for bi in range(n):
            p = f"backbone.res{li + 2}.{bi}"
            conv_bn(f"{p}.conv1", inplanes if bi == 0 else 4 * planes,
                    planes, 1)
            conv_bn(f"{p}.conv2", planes, planes, 3)
            conv_bn(f"{p}.conv3", planes, 4 * planes, 1)
            if bi == 0:
                conv_bn(f"{p}.shortcut", inplanes, 4 * planes, 1)
        inplanes = 4 * planes
    for i, d in enumerate((256, 512, 1024, 2048)):
        S._conv(out, f"fpn.lateral.{i}", d, FPN_DIM, 1)
    for i in range(4):
        S._conv(out, f"fpn.output.{i}", FPN_DIM, FPN_DIM, 3)
    anchors = len(cfg["aspect_ratios"])
    S._conv(out, "rpn.conv", FPN_DIM, FPN_DIM, 3)
    S._conv(out, "rpn.objectness", FPN_DIM, anchors, 1)
    S._conv(out, "rpn.deltas", FPN_DIM, 4 * anchors, 1)
    pool = cfg["box_pooler"]
    S._lin(out, "box_head.fc1", FPN_DIM * pool * pool, cfg["box_fc"])
    S._lin(out, "box_head.fc2", cfg["box_fc"], cfg["box_fc"])
    S._lin(out, "box_head.cls", cfg["box_fc"], 2)
    S._lin(out, "box_head.reg", cfg["box_fc"], 4)
    dd, dim = cfg["decoder_dim"], cfg["dp_dim"]
    for i in range(cfg["dp_convs"]):
        S._conv(out, f"dp_head.convs.{i}", dd if i == 0 else dim, dim, 3)
    n = cfg["num_patches"] + 1
    for name, o in (("coarse_segm", 2), ("fine_segm", n), ("u", n),
                    ("v", n)):
        S._conv(out, f"dp_head.{name}", dim, o, 4)
    for lvl in range(4):
        for j in range(max(1, lvl)):
            S._conv(out, f"decoder.scale_heads.{lvl}.{j}",
                    FPN_DIM if j == 0 else dd, dd, 3)
    S._conv(out, "decoder.predictor", dd, dd, 1)
    return out


# ---------------------------------------------------------------------------
# the configuration's weights
# ---------------------------------------------------------------------------

# the scale of the pixels DensePose's stem reads (BGR minus the mean, not
# divided by a std: detectron2's PIXEL_STD of 1 for the MSRA weights):
# ImageNet's pixel std; the random stem is drawn that much smaller, as a
# trained caffe-style stem absorbs it
PIXEL_STD = 57.375


def param_specs(nets: dict) -> dict:
    """{component: [(name, shape, kind)]} of the three nets described by a
    configuration's ``nets`` section: ``openpose``, ``schp_atr``,
    ``schp_lip`` and ``densepose``."""
    return {"openpose": openpose_spec(nets["openpose"]),
            "schp_atr": schp_spec(nets["schp"], nets["schp"]["atr_classes"]),
            "schp_lip": schp_spec(nets["schp"], nets["schp"]["lip_classes"]),
            "densepose": densepose_spec(nets["densepose"])}


def scale_draw_(flat: dict) -> dict:
    """The draw rule's one departure from ``common.leaf_values``: the
    DensePose stem's kernel over ``PIXEL_STD``. In place; returns
    ``flat``."""
    k = flat["densepose.backbone.stem.conv.kernel"]
    k.div_(PIXEL_STD)
    return flat


# ---------------------------------------------------------------------------
# the mask step (IDM-VTON gradio_demo/utils_mask.py::get_mask_location),
# host code on numpy, OpenCV and PIL as published; "hd", upper_body
# ---------------------------------------------------------------------------

ATR_LABELS = {"background": 0, "hat": 1, "sunglasses": 3, "upper_clothes": 4,
              "skirt": 5, "pants": 6, "dress": 7, "left_shoe": 9,
              "right_shoe": 10, "head": 11, "left_arm": 14, "right_arm": 15,
              "bag": 16, "neck": 18}


def _hole_fill(img):
    import cv2
    img = np.pad(img[1:-1, 1:-1], pad_width=1, mode="constant",
                 constant_values=0)
    img_copy = img.copy()
    mask = np.zeros((img.shape[0] + 2, img.shape[1] + 2), dtype=np.uint8)
    cv2.floodFill(img, mask, (0, 0), 255)
    return cv2.bitwise_or(img_copy, cv2.bitwise_not(img))


def _refine_mask(mask):
    import cv2
    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_CCOMP,
                                   cv2.CHAIN_APPROX_TC89_L1)
    area = [abs(cv2.contourArea(c, True)) for c in contours]
    refine = np.zeros_like(mask).astype(np.uint8)
    if area:
        cv2.drawContours(refine, contours, area.index(max(area)), color=255,
                         thickness=-1)
    return refine


def mask_location(parse, keypoints, width=384, height=512):
    """The inpaint mask (height, width) uint8 0 / 255 of ATR labels with
    LIP's neck (label 18) and OpenPose's 18 keypoints in 384x512 pixels:
    the garment and arm regions dilated, head, shoes, hat, sunglasses, bag,
    lower cloth and hands kept, holes filled, the largest region kept."""
    import cv2
    from PIL import Image, ImageDraw
    L = ATR_LABELS
    p = np.asarray(parse)
    arm_width = 60
    head = (p == L["hat"]) + (p == L["sunglasses"]) + (p == L["head"])
    fixed = ((p == L["left_shoe"]) + (p == L["right_shoe"]) + (p == L["hat"])
             + (p == L["sunglasses"]) + (p == L["bag"])).astype(np.float32)
    changeable = (p == L["background"]).astype(np.float32)
    arms_left = (p == L["left_arm"]).astype(np.float32)
    arms_right = (p == L["right_arm"]).astype(np.float32)
    garment = ((p == L["upper_clothes"]) + (p == L["dress"])).astype(
        np.float32)
    fixed += ((p == L["skirt"]) + (p == L["pants"])).astype(np.float32)
    changeable += np.logical_and(p, np.logical_not(fixed))
    pose = np.asarray(keypoints["pose_keypoints_2d"]).reshape(-1, 2)
    k = height / 512.0
    line = int(arm_width / 512 * height)
    arms = {}
    for side, (s, e, w), parsed in (("right", (2, 3, 4), arms_right),
                                    ("left", (5, 6, 7), arms_left)):
        shoulder, elbow, wrist = (np.multiply(tuple(pose[j][:2]), k)
                                  for j in (s, e, w))
        if wrist[0] <= 1.0 and wrist[1] <= 1.0:
            arms[side] = parsed
            continue
        wrist = elbow + 1.2 * (wrist - elbow)
        im = Image.new("L", (width, height))
        draw = ImageDraw.Draw(im)
        pts = ((shoulder, elbow, wrist) if side == "right"
               else (wrist, elbow, shoulder))
        draw.line(np.concatenate(pts).astype(np.uint16).tolist(), "white",
                  line, "curve")
        draw.arc([shoulder[0] - line // 2, shoulder[1] - line // 2,
                  shoulder[0] + line // 2, shoulder[1] + line // 2], 0, 360,
                 "white", line // 2)
        arms[side] = np.asarray(im)
    fixed += (np.logical_and(np.logical_not(arms["left"]), arms_left)
              + np.logical_and(np.logical_not(arms["right"]), arms_right))
    fixed = np.logical_or(fixed, head)
    garment = cv2.dilate(garment, np.ones((5, 5), np.uint16), iterations=5)
    neck = cv2.dilate((p == L["neck"]).astype(np.float32),
                      np.ones((5, 5), np.uint16), iterations=1)
    garment = np.logical_or(garment, np.logical_and(neck,
                                                    np.logical_not(head)))
    arm = cv2.dilate(np.logical_or(arms["left"], arms["right"]).astype(
        "float32"), np.ones((5, 5), np.uint16), iterations=4)
    garment = garment + np.logical_or(garment, arm)
    keep = np.logical_or(np.logical_and(changeable, np.logical_not(garment)),
                         fixed)
    img = np.where(1 - keep, 255, 0).astype(np.uint8)
    return _refine_mask(_hole_fill(img))
