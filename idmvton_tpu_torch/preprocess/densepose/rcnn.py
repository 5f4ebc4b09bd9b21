"""DensePose GeneralizedRCNN (R50-FPN) with static shapes.

Counterpart of ``idmvton_tpu/preprocess/densepose/rcnn.py`` (detectron2
GeneralizedRCNN + DensePoseROIHeads + DensePoseV1ConvXHead, the
Base-DensePose-RCNN-FPN / densepose_rcnn_R_50_FPN_s1x configs): image ->
backbone / FPN -> RPN (per-level top-k, NMS -> ``rpn_post_nms_topk``
proposals) -> box head (ROIAlign 7, 2x FC-1024, class + deltas, NMS 0.5 ->
``num_detections``) -> Panoptic-FPN decoder -> densepose head (ROIAlign 28,
8x conv3x3-512, ConvTranspose predictors -> 112x112 coarse / fine segm and
U / V per detection). Proposal and detection counts are fixed, padded with
validity masks, as in JAX.

The 3x3 stride-1 convs with at least 128 channels (ResNet res3-res5's
conv2, the FPN outputs, the RPN conv, the decoder, the densepose head) take
the conv kernels on the card through ``layers.conv2d``, as JAX sends them
to its Pallas conv kernels; the rest is plain PyTorch on the same device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.models.layers import Conv, Linear, conv2d, linear
from idmvton_tpu_torch.ops.nms import nms_topk
from idmvton_tpu_torch.ops.roi_align import roi_align
from idmvton_tpu_torch.preprocess.densepose.backbone import (
    FPN, FPN_DIM, ResNet50,
)


@dataclasses.dataclass(frozen=True)
class DensePoseConfig:
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)  # per level P2-P6
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # serving capacities follow the served config: PRE_NMS_TOPK_TEST 1000 /
    # POST_NMS_TOPK_TEST 1000 and DETECTIONS_PER_IMAGE 100
    rpn_pre_nms_topk: int = 1000   # per level (test)
    rpn_post_nms_topk: int = 1000  # static proposal count fed to box head
    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    num_detections: int = 100      # static detection count
    dp_convs: int = 8
    dp_dim: int = 512
    dp_pooler: int = 28
    # the densepose head runs over detection chunks of this size (bounds the
    # 112x112x25 predictor activations; must divide num_detections)
    dp_chunk: int = 20
    # Panoptic-FPN Decoder ahead of the densepose pooler (DECODER_ON)
    decoder_on: bool = True
    decoder_dim: int = 256
    heatmap_size: int = 112
    num_patches: int = 24          # 24 body parts + bg fine channels = 25
    bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)


# ---------------------------------------------------------------------------
# modules (the JAX tree's key names)
# ---------------------------------------------------------------------------


class RPNHead(nn.Module):
    def __init__(self, n_anchors, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv = Conv(FPN_DIM, FPN_DIM, 3, **kw)
        self.objectness = Conv(FPN_DIM, n_anchors, 1, **kw)
        self.deltas = Conv(FPN_DIM, n_anchors * 4, 1, **kw)


class BoxHead(nn.Module):
    def __init__(self, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Linear(FPN_DIM * 7 * 7, 1024, **kw)
        self.fc2 = Linear(1024, 1024, **kw)
        self.cls = Linear(1024, 2, **kw)      # person + bg
        self.reg = Linear(1024, 4, **kw)


class DensePoseHead(nn.Module):
    def __init__(self, cfg: DensePoseConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        first = cfg.decoder_dim if cfg.decoder_on else FPN_DIM
        self.convs = nn.ModuleList(
            Conv(first if i == 0 else cfg.dp_dim, cfg.dp_dim, 3, **kw)
            for i in range(cfg.dp_convs))
        dp_out = cfg.num_patches + 1
        # ConvTranspose2d(512, ch, 4, stride 2, pad 1) predictors, HWIO
        self.coarse_segm = Conv(cfg.dp_dim, 2, 4, **kw)
        self.fine_segm = Conv(cfg.dp_dim, dp_out, 4, **kw)
        self.u = Conv(cfg.dp_dim, dp_out, 4, **kw)
        self.v = Conv(cfg.dp_dim, dp_out, 4, **kw)


class Decoder(nn.Module):
    """Panoptic-FPN semantic head: per level P2..P5, max(1, lvl) conv3x3 +
    ReLU, each followed by a bilinear 2x above stride 4; summed; a 1x1
    predictor."""

    def __init__(self, cfg: DensePoseConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        dd = cfg.decoder_dim
        self.scale_heads = nn.ModuleList(
            nn.ModuleList(Conv(FPN_DIM if j == 0 else dd, dd, 3, **kw)
                          for j in range(max(1, lvl)))
            for lvl in range(4))
        self.predictor = Conv(dd, dd, 1, **kw)

    def forward(self, ps, *, impl=None):
        total = None
        for lvl in range(4):
            h = ps[lvl]
            for conv in self.scale_heads[lvl]:
                h = F.relu(conv2d(conv, h, padding=((1, 1), (1, 1)),
                                  impl=impl))
                if lvl > 0:
                    h = resize_bilinear_up(h, (h.shape[1] * 2,
                                               h.shape[2] * 2))
            total = h if total is None else total + h
        return conv2d(self.predictor, total, impl=impl)


def resize_bilinear_up(x, hw):
    """NHWC bilinear upsampling with half-pixel centres: equals
    ``jax.image.resize(..., LINEAR)`` when every output dimension is at
    least its input's (the edge taps it drops are the ones torch clamps)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def deconv2x(p, x):
    """torch ConvTranspose2d(k=4, s=2, p=1) with the HWIO kernel (JAX's
    input-dilated conv with the flipped kernel and padding 2)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           p.kernel.to(x.dtype).permute(2, 3, 0, 1),
                           stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous() + p.bias.to(x.dtype)


# ---------------------------------------------------------------------------
# anchors + box transforms
# ---------------------------------------------------------------------------


def make_anchors(level_hw: Tuple[int, int], stride: int, size: int,
                 aspect_ratios) -> np.ndarray:
    """detectron2 DefaultAnchorGenerator: centered anchors on the grid."""
    anchors = []
    area = float(size * size)
    for ar in aspect_ratios:
        w = math.sqrt(area / ar)
        h = ar * w
        anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    base = np.asarray(anchors, np.float32)          # (A, 4)
    fh, fw = level_hw
    shift_x = (np.arange(fw, dtype=np.float32)) * stride
    shift_y = (np.arange(fh, dtype=np.float32)) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)      # (H*W*A, 4)


def apply_deltas(anchors, deltas, weights):
    """detectron2 Box2BoxTransform.apply_deltas."""
    wx, wy, ww, wh = weights
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    ctr_x = anchors[:, 0] + 0.5 * widths
    ctr_y = anchors[:, 1] + 0.5 * heights
    dx = deltas[:, 0] / wx
    dy = deltas[:, 1] / wy
    dw = (deltas[:, 2] / ww).clamp(max=math.log(1000.0 / 16))
    dh = (deltas[:, 3] / wh).clamp(max=math.log(1000.0 / 16))
    px = dx * widths + ctr_x
    py = dy * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2],
                       dim=-1)


def clip_boxes(boxes, img_hw):
    h, w = img_hw
    return torch.stack([boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                        boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)],
                       dim=-1)


def fpn_level_assign(boxes, k0: int = 4, canonical: float = 224.0):
    """FPN paper eq. 1: level = floor(k0 + log2(sqrt(area)/224)), clamped to
    P2..P5 (indices 0..3)."""
    area = ((boxes[:, 2] - boxes[:, 0])
            * (boxes[:, 3] - boxes[:, 1])).clamp_min(1e-6)
    lvl = torch.floor(k0 + torch.log2(torch.sqrt(area) / canonical + 1e-8))
    return lvl.clamp(2, 5).long() - 2


def multilevel_roi_align(ps, boxes, valid, out_size: int):
    """ROIAlign over each ROI's assigned FPN level, as a sum over levels
    (each ROI contributes from exactly one)."""
    lvls = fpn_level_assign(boxes)
    pooled = None
    for i in range(4):
        idx = torch.where((lvls == i) & valid, 0, -1)
        p = roi_align(ps[i], boxes, idx, output_size=out_size,
                      spatial_scale=1.0 / (4 * 2 ** i), sampling_ratio=2)
        pooled = p if pooled is None else pooled + p
    return pooled


def top_k(scores, k: int):
    """(values, indices) of the k largest, ties lower index first
    (``jax.lax.top_k``)."""
    idx = torch.argsort(-scores, stable=True)[:k]
    return scores[idx], idx


# ---------------------------------------------------------------------------
# forward (batch size 1: the serving contract of apply_net)
# ---------------------------------------------------------------------------


class DensePoseRCNN(nn.Module):
    def __init__(self, cfg: DensePoseConfig = DensePoseConfig(), *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.backbone = ResNet50(**kw)
        self.fpn = FPN(**kw)
        self.rpn = RPNHead(len(cfg.aspect_ratios), **kw)
        self.box_head = BoxHead(**kw)
        self.dp_head = DensePoseHead(cfg, **kw)
        self.decoder = Decoder(cfg, **kw) if cfg.decoder_on else None

    def _dp_head(self, dpp, *, impl=None):
        """8x conv3x3-512 + per-output deconv2x + bilinear to 112, over
        detection chunks of ``dp_chunk`` (identical results, bounded
        activations)."""
        cfg, head = self.cfg, self.dp_head
        k = dpp.shape[0]
        chunk = min(cfg.dp_chunk, k)
        if chunk <= 0 or k % chunk:
            chunk = k   # no clean split: run unchunked
        names = ("coarse_segm", "fine_segm", "u", "v")
        outs = {name: [] for name in names}
        size = (cfg.heatmap_size, cfg.heatmap_size)
        for c0 in range(0, k, chunk):
            h = dpp[c0:c0 + chunk]
            for conv in head.convs:
                h = F.relu(conv2d(conv, h, padding=((1, 1), (1, 1)),
                                  impl=impl))
            for name in names:
                outs[name].append(resize_bilinear_up(
                    deconv2x(getattr(head, name), h), size))
        return {name: torch.cat(o) for name, o in outs.items()}

    def forward(self, x, *, impl=None, record: Optional[dict] = None):
        """x: (1, H, W, 3) preprocessed BGR (caffe-style mean-subtracted).
        Returns a dict of fixed-size detections and densepose outputs:
        boxes (K, 4), scores (K,), valid (K,), coarse (K, 112, 112, 2),
        fine / u / v (K, 112, 112, 25). ``record``, when given, receives
        the FPN features (``fpn``) and the pre-NMS RPN boxes and scores
        (``rpn_boxes``, ``rpn_scores``)."""
        cfg = self.cfg
        img_hw = x.shape[1:3]
        ps = self.fpn(self.backbone(x, impl=impl), impl=impl)

        # --- RPN over 5 levels
        all_boxes, all_scores = [], []
        for lvl, p in enumerate(ps):
            h = F.relu(conv2d(self.rpn.conv, p, padding=((1, 1), (1, 1)),
                              impl=impl))
            obj = conv2d(self.rpn.objectness, h, impl=impl)[0]
            del_ = conv2d(self.rpn.deltas, h, impl=impl)[0]
            fh, fw, a = obj.shape
            anchors = torch.from_numpy(make_anchors(
                (fh, fw), 4 * 2 ** lvl, cfg.anchor_sizes[lvl],
                cfg.aspect_ratios)).to(x.device)
            scores = obj.reshape(-1)
            deltas = del_.reshape(-1, 4)
            top_scores, top_idx = top_k(scores,
                                        min(cfg.rpn_pre_nms_topk,
                                            scores.shape[0]))
            boxes = apply_deltas(anchors[top_idx], deltas[top_idx],
                                 (1.0, 1.0, 1.0, 1.0))
            all_boxes.append(clip_boxes(boxes, img_hw))
            all_scores.append(top_scores)
        rpn_boxes = torch.cat(all_boxes)
        rpn_scores = torch.cat(all_scores)
        if record is not None:
            record.update(fpn=ps, rpn_boxes=rpn_boxes, rpn_scores=rpn_scores)
        # one NMS over the level-concat (d2 runs it per level, then a
        # global top-k: they differ only for cross-level duplicates)
        prop_boxes, _, prop_idx = nms_topk(
            rpn_boxes, rpn_scores, iou_threshold=cfg.rpn_nms_thresh,
            topk=cfg.rpn_post_nms_topk)
        prop_valid = prop_idx >= 0

        # --- box head
        pooled = multilevel_roi_align(ps, prop_boxes, prop_valid, 7)
        flat = pooled.reshape(pooled.shape[0], -1)
        bh = self.box_head
        fc = F.relu(linear(bh.fc1, flat))
        fc = F.relu(linear(bh.fc2, fc))
        cls_logits = linear(bh.cls, fc)                    # (N, 2)
        reg = linear(bh.reg, fc)                           # (N, 4)
        person = torch.softmax(cls_logits, dim=-1)[:, 0]
        person = torch.where(prop_valid, person, person.new_full((), -1.0))
        det_boxes_all = clip_boxes(
            apply_deltas(prop_boxes, reg, cfg.bbox_reg_weights), img_hw)
        det_boxes, det_scores, det_idx = nms_topk(
            det_boxes_all, person, iou_threshold=cfg.box_nms_thresh,
            topk=cfg.num_detections, score_threshold=cfg.box_score_thresh)
        det_valid = det_idx >= 0

        # --- densepose head
        if cfg.decoder_on:
            # the pooler reads the decoder's single stride-4 feature
            dec = self.decoder(ps, impl=impl)
            idx = torch.where(det_valid, 0, -1)
            dpp = roi_align(dec, det_boxes, idx, output_size=cfg.dp_pooler,
                            spatial_scale=1.0 / 4.0, sampling_ratio=2)
        else:
            dpp = multilevel_roi_align(ps, det_boxes, det_valid,
                                       cfg.dp_pooler)
        outs = self._dp_head(dpp, impl=impl)
        return {"boxes": det_boxes, "scores": det_scores, "valid": det_valid,
                "coarse": outs["coarse_segm"], "fine": outs["fine_segm"],
                "u": outs["u"], "v": outs["v"]}


def init_densepose_rcnn(seed: int = 0,
                        cfg: DensePoseConfig = DensePoseConfig(), *,
                        dtype=torch.float32, device="cuda") -> DensePoseRCNN:
    """The R-CNN with seeded random weights (fan-in normal kernels, zero
    biases, identity frozen BN), as JAX's ``init_densepose_rcnn``."""
    from idmvton_tpu_torch.models.layers import reset_parameters_
    model = DensePoseRCNN(cfg, dtype=dtype, device=device)
    reset_parameters_(model, torch.Generator(device=device).manual_seed(seed))
    return model
