"""Detection training for the DensePose R-CNN: losses, matching, sampling,
the optimizer and the train step.

Counterpart of ``idmvton_tpu/preprocess/densepose/train.py`` (the training
half of the reference's vendored detectron2 stack; the serving model is
``rcnn.py``, the evaluation harness ``evaluate.py``). The reference
behaviour it follows, with JAX's static shapes:

- RPN losses (detectron2 rpn.py:366-428): BCE-with-logits objectness
  summed over the sampled anchors, L1 (smooth-L1 beta 0) localization on
  the positives, both over 256 x images. Anchor matcher (matcher.py):
  IoU thresholds [0.3, 0.7] -> labels {0, -1, 1}, every gt's best anchors
  forced positive. Sampling (sampling.py::subsample_labels): 256 an image
  at positive fraction 0.5; ROI heads 512 at 0.25, fg IoU 0.5, the gt
  boxes appended to the proposals.
- Box head losses (fast_rcnn.py:307-463): softmax CE over the sampled
  proposals, L1 deltas over the sampled foreground / the sampled count.
- DensePose chart losses (densepose/modeling/losses/chart.py): U / V
  smooth-L1 (beta 1, summed) at the annotated foreground points x 0.01;
  fine-segm CE at the annotated points (bilinear on the 112x112 logits)
  x 1.0; coarse-segm CE over the heatmap against the gt mask rasterized
  into the proposal x 5.0.
- SGD, momentum 0.9, lr 0.01, weight decay 1e-4; stem + res2 and every
  FrozenBatchNorm affine frozen (``detection_trainable_mask``).

Static shapes as in JAX: sampled subsets are {0, 1} weight vectors chosen
by masked random-priority ranking, the densepose head trains on a
fixed-capacity slab of foreground proposals with a validity mask.

Where the port differs in form, not in value:

- Parameters are a flat dict of fp32 masters (``detection_params``),
  handed to the model through ``torch.func.functional_call``; a trainable
  master requires grad, so the conv kernel sites cast it to bf16 inside the
  graph (``layers.kernel_weight``) and differentiate the launch through
  ``ops.autograd`` (the plain VJP), as JAX's Pallas convs.
- The backbone, FPN, RPN convs and decoder run on the whole batch (frozen
  BN couples no images); matching, sampling and the two heads then run
  image by image, as JAX's ``vmap`` of ``detection_loss_fn``.
- Randomness: JAX draws three uniform vectors an image from
  ``split(split(rng, B)[i], 3)``. Torch cannot reproduce those streams, so
  the port draws them from a ``torch.Generator`` (per image: the anchors',
  the proposals', the densepose slab's), or takes them from the caller
  (``uniforms=``), as ``init_noise=`` / ``step_noise=`` on the diffusion
  path. ``record=`` receives each image's sampled sets.
- Ties: stable sorts where JAX's are (``argsort``), lower index first
  where ``lax.top_k`` takes it (``rcnn.top_k``), the first maximum where
  ``argmax`` takes it.
- NMS over all anchors (217,413 boxes at 800x1088, no pre-NMS top-k, as
  JAX) runs through ``ops.nms.nms_topk``'s early-exit walk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from idmvton_tpu_torch.models.layers import conv2d, linear
from idmvton_tpu_torch.ops.nms import nms_topk
from idmvton_tpu_torch.ops.roi_align import roi_align
from idmvton_tpu_torch.preprocess.densepose.rcnn import (
    DensePoseConfig, apply_deltas, clip_boxes, make_anchors,
    multilevel_roi_align, top_k,
)


@dataclasses.dataclass(frozen=True)
class DetectionTrainConfig:
    """Training hyperparameters, the served config's values
    (detectron2/config/defaults.py + densepose/config.py)."""
    rpn_batch_per_image: int = 256        # defaults.py:219
    rpn_positive_fraction: float = 0.5    # defaults.py:221
    rpn_iou_low: float = 0.3              # defaults.py:216
    rpn_iou_high: float = 0.7
    roi_batch_per_image: int = 512        # defaults.py:267
    roi_positive_fraction: float = 0.25   # defaults.py:269
    roi_iou_thresh: float = 0.5           # defaults.py:261
    w_points: float = 0.01                # densepose/config.py:187
    w_part: float = 1.0                   # densepose/config.py:185
    w_segm: float = 5.0                   # densepose/config.py:183
    # static capacity of foreground proposals routed to the densepose head
    # per image (the reference's dynamic fg subset, bounded)
    n_dp_train: int = 16
    lr: float = 0.01            # configs/Base-DensePose-RCNN-FPN.yaml:43
    momentum: float = 0.9
    weight_decay: float = 1e-4
    freeze_at: int = 2          # BACKBONE.FREEZE_AT (defaults.py): stem+res2


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------


def pairwise_iou(a, b):
    """IoU matrix (Na, Nb); detectron2 structures/boxes.py::pairwise_iou."""
    area_a = ((a[:, 2] - a[:, 0]).clamp_min(0)
              * (a[:, 3] - a[:, 1]).clamp_min(0))
    area_b = ((b[:, 2] - b[:, 0]).clamp_min(0)
              * (b[:, 3] - b[:, 1]).clamp_min(0))
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), 0.0)


def get_deltas(src, target, weights=(1.0, 1.0, 1.0, 1.0)):
    """Box2BoxTransform.get_deltas (detectron2 box_regression.py): the
    regression target that ``apply_deltas`` inverts."""
    wx, wy, ww, wh = weights
    sw = (src[:, 2] - src[:, 0]).clamp_min(1e-6)
    sh = (src[:, 3] - src[:, 1]).clamp_min(1e-6)
    scx = src[:, 0] + 0.5 * sw
    scy = src[:, 1] + 0.5 * sh
    tw = (target[:, 2] - target[:, 0]).clamp_min(1e-6)
    th = (target[:, 3] - target[:, 1]).clamp_min(1e-6)
    tcx = target[:, 0] + 0.5 * tw
    tcy = target[:, 1] + 0.5 * th
    return torch.stack([
        wx * (tcx - scx) / sw, wy * (tcy - scy) / sh,
        ww * torch.log(tw / sw), wh * torch.log(th / sh)], dim=-1)


def smooth_l1(pred, target, beta: float):
    """fvcore smooth_l1_loss semantics (beta 0 -> pure L1)."""
    d = (pred - target).abs()
    if beta <= 0:
        return d
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


# ---------------------------------------------------------------------------
# matching + sampling (static shapes)
# ---------------------------------------------------------------------------


def match_boxes(candidates, gt_boxes, gt_valid, *, low: float, high: float,
                allow_low_quality: bool):
    """detectron2 Matcher: per-candidate best gt + {1, -1, 0} labels at the
    [low, high) thresholds; allow_low_quality forces each valid gt's
    max-overlap candidates positive (matcher.py::set_low_quality_matches_).
    Returns (matched_gt_idx (N,) int64, the first maximum as ``argmax``;
    labels (N,) int8 with 1 fg / 0 bg / -1 ignore). Candidates with no
    valid gt anywhere are all background."""
    iou = pairwise_iou(candidates, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best = iou.max(dim=1).values
    matched = iou.argmax(dim=1)
    labels = torch.where(best >= high, 1, torch.where(best < low, 0, -1))
    if allow_low_quality:
        per_gt_best = iou.max(dim=0).values                      # (G,)
        is_best = ((iou == per_gt_best[None, :]) & gt_valid[None, :]
                   & (per_gt_best[None, :] > 0))
        labels = torch.where(is_best.any(dim=1), 1, labels)
    # no valid gt at all -> everything background (d2: gt empty => all 0)
    labels = torch.where(gt_valid.any(), labels, 0)
    return matched, labels.to(torch.int8)


def _uniform(rand, n: int, device) -> torch.Tensor:
    """(n,) uniforms in [0, 1): ``rand`` as given, or drawn from it (a
    ``torch.Generator`` on ``device``)."""
    if isinstance(rand, torch.Generator):
        return torch.rand(n, generator=rand, device=device)
    if rand.shape != (n,):
        raise ValueError(f"expected ({n},) uniforms, got {tuple(rand.shape)}")
    return rand.to(device, torch.float32)


def subsample_labels(labels, rand, *, num_samples: int,
                     positive_fraction: float):
    """detectron2 sampling.py::subsample_labels as a static-shape weight
    vector: uniformly pick min(#pos, num * frac) positives and fill the
    remainder with negatives, by rank of a uniform priority (``rand``: (N,)
    uniforms or a generator to draw them from) in a stable descending sort.
    Returns float {0, 1} weights of labels' shape."""
    n = labels.shape[0]
    r = _uniform(rand, n, labels.device)
    pos = labels == 1
    neg = labels == 0
    n_pos = pos.sum().clamp(max=int(num_samples * positive_fraction))
    n_neg = torch.minimum(neg.sum(), num_samples - n_pos)
    ranks = torch.arange(n, device=labels.device)

    def pick(mask, k):
        pri = torch.where(mask, r, -1.0)
        order = torch.argsort(-pri, stable=True)
        rank = torch.empty_like(order)
        rank[order] = ranks
        return mask & (rank < k)

    return (pick(pos, n_pos) | pick(neg, n_neg)).float()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def rpn_losses(anchors, obj_logits, deltas_pred, gt_boxes, gt_valid, rand,
               tcfg: DetectionTrainConfig, record: Optional[dict] = None):
    """rpn.py:366-428. All inputs level-concatenated for one image:
    anchors (N, 4), obj_logits (N,), deltas_pred (N, 4); ``rand`` the
    sampler's uniforms (or a generator). ``record`` receives the sampled
    anchors' weights (``rpn_w``)."""
    matched, labels = match_boxes(
        anchors, gt_boxes, gt_valid, low=tcfg.rpn_iou_low,
        high=tcfg.rpn_iou_high, allow_low_quality=True)
    w = subsample_labels(labels, rand,
                         num_samples=tcfg.rpn_batch_per_image,
                         positive_fraction=tcfg.rpn_positive_fraction)
    if record is not None:
        record["rpn_w"] = w
    norm = float(tcfg.rpn_batch_per_image)
    tgt = (labels == 1).float()
    # BCE-with-logits, summed over the sampled anchors (rpn.py:416-419)
    bce = (obj_logits.clamp_min(0) - obj_logits * tgt
           + torch.log1p(torch.exp(-obj_logits.abs())))
    loss_cls = (bce * w).sum() / norm
    gt_deltas = get_deltas(anchors, gt_boxes[matched])
    pos_w = w * tgt
    loss_loc = (smooth_l1(deltas_pred, gt_deltas, 0.0)
                * pos_w[:, None]).sum() / norm
    return {"loss_rpn_cls": loss_cls, "loss_rpn_loc": loss_loc}


def box_head_losses(cls_logits, reg_pred, prop_boxes, matched_gt_boxes,
                    fg_mask, sample_w, cfg: DensePoseConfig):
    """fast_rcnn.py:307-463 for the single-class (person) head: CE mean over
    sampled proposals (bg class index 1), L1 deltas summed over sampled
    foreground / total sampled count."""
    n_sampled = sample_w.sum().clamp_min(1.0)
    gt_cls = torch.where(fg_mask, 0, 1)
    logp = F.log_softmax(cls_logits, dim=-1)
    ce = -torch.gather(logp, 1, gt_cls[:, None])[:, 0]
    loss_cls = (ce * sample_w).sum() / n_sampled
    gt_deltas = get_deltas(prop_boxes, matched_gt_boxes, cfg.bbox_reg_weights)
    fg_w = sample_w * fg_mask.float()
    loss_reg = (smooth_l1(reg_pred, gt_deltas, 0.0)
                * fg_w[:, None]).sum() / n_sampled
    return {"loss_cls": loss_cls, "loss_box_reg": loss_reg}


def _points_to_heatmap_coords(px, py, boxes, heatmap_size: int):
    """Map absolute image-space annotation points into the per-proposal
    heatmap grid (losses/utils.py::BilinearInterpolationHelper.from_matches:
    x_norm = (x - x1) * (S / w), valid iff inside [0, S-1])."""
    x1, y1 = boxes[:, 0:1], boxes[:, 1:2]
    w = (boxes[:, 2:3] - boxes[:, 0:1]).clamp_min(1e-6)
    h = (boxes[:, 3:4] - boxes[:, 1:2]).clamp_min(1e-6)
    hx = (px - x1) * (heatmap_size / w)
    hy = (py - y1) * (heatmap_size / h)
    inside = ((hx >= 0) & (hx <= heatmap_size - 1)
              & (hy >= 0) & (hy <= heatmap_size - 1))
    return hx, hy, inside


def _bilinear_at_points(maps, hx, hy):
    """Bilinearly sample maps (K, S, S, C) at per-proposal points
    (K, P) -> (K, P, C)."""
    k, s, _, c = maps.shape
    x0 = torch.floor(hx).clamp(0, s - 2)
    y0 = torch.floor(hy).clamp(0, s - 2)
    fx = (hx - x0).clamp(0.0, 1.0)[..., None]
    fy = (hy - y0).clamp(0.0, 1.0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = maps.reshape(k, s * s, c)

    def gather(yy, xx):
        idx = (yy * s + xx)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def _linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace(start, stop, num)`` (num >= 2) in fp32 as XLA
    computes it: start (1 - i c) + i (stop c) with c = 1 / (num - 1), the
    last product and the sum fused into one rounding (emulated in fp64),
    then ``stop``. An exactly rounded linspace differs from it by an ulp
    at some points, which moves a mask edge that a clipped proposal or an
    integer gt box puts exactly on a sample."""
    f32 = dict(dtype=torch.float32, device=device)
    c = torch.ones((), **f32) / (num - 1)
    st, sp = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    i = torch.arange(num - 1, **f32)
    head = st * (1 - i * c)
    out = (i.double() * (sp * c).double() + head.double()).float()
    return torch.cat([out, sp[None]])


def _mask_in_box(gt_mask, gt_box, prop_boxes, heatmap_size: int):
    """Rasterize the gt instance mask (M, M grid over gt_box) into each
    proposal box at heatmap resolution (losses/segm.py::resample_data
    semantics via bilinear sampling + 0.5 threshold). gt_mask (M, M) and
    gt_box (4,) for every proposal, or (K, M, M) and (K, 4), one each;
    prop_boxes (K, 4). Returns (K, S, S) bool."""
    k = prop_boxes.shape[0]
    m = gt_mask.shape[-1]
    s = heatmap_size
    gt_mask = gt_mask.reshape(-1, m * m).float().expand(k, -1)
    gt_box = gt_box.reshape(-1, 4).expand(k, -1)
    gs = _linspace(0.5 / s, 1 - 0.5 / s, s, prop_boxes.device)
    px = prop_boxes[:, 0:1] + gs[None, :] * (
        prop_boxes[:, 2:3] - prop_boxes[:, 0:1])       # (K, S)
    py = prop_boxes[:, 1:2] + gs[None, :] * (
        prop_boxes[:, 3:4] - prop_boxes[:, 1:2])
    gw = (gt_box[:, 2:3] - gt_box[:, 0:1]).clamp_min(1e-6)
    gh = (gt_box[:, 3:4] - gt_box[:, 1:2]).clamp_min(1e-6)
    mx = (px - gt_box[:, 0:1]) / gw * m - 0.5          # (K, S) mask coords
    my = (py - gt_box[:, 1:2]) / gh * m - 0.5
    x0 = torch.floor(mx).clamp(0, m - 2)
    y0 = torch.floor(my).clamp(0, m - 2)
    fx = (mx - x0).clamp(0.0, 1.0)
    fy = (my - y0).clamp(0.0, 1.0)
    x0, y0 = x0.long(), y0.long()

    def at(yy, xx):  # (K, Sy) x (K, Sx) -> (K, Sy, Sx)
        idx = (yy[:, :, None] * m + xx[:, None, :]).reshape(k, -1)
        return torch.gather(gt_mask, 1, idx).reshape(k, s, s)

    v = (at(y0, x0) * (1 - fy)[:, :, None] * (1 - fx)[:, None, :]
         + at(y0, x0 + 1) * (1 - fy)[:, :, None] * fx[:, None, :]
         + at(y0 + 1, x0) * fy[:, :, None] * (1 - fx)[:, None, :]
         + at(y0 + 1, x0 + 1) * fy[:, :, None] * fx[:, None, :])
    inside = (((mx >= -0.5) & (mx <= m - 0.5))[:, None, :]
              & ((my >= -0.5) & (my <= m - 0.5))[:, :, None])
    return torch.where(inside, v, 0.0) > 0.5


def densepose_chart_losses(outs, dp_boxes, dp_valid, gt, matched_gt,
                           tcfg: DetectionTrainConfig,
                           cfg: DensePoseConfig):
    """chart.py losses over the fixed-capacity dp training slab.

    outs: the dp head's dict, coarse_segm (K, S, S, 2), fine_segm / u / v
    (K, S, S, 25). dp_boxes (K, 4) proposal boxes, dp_valid (K,) bool,
    matched_gt (K,) index into the image's gt instances. gt carries
    per-instance point annotations dp_x / dp_y (abs px), dp_i (fine labels
    0..24), dp_u / dp_v, dp_pt_valid, and dp_mask (G, M, M) and boxes."""
    s = cfg.heatmap_size
    px = gt["dp_x"][matched_gt]            # (K, P)
    py = gt["dp_y"][matched_gt]
    gt_i = gt["dp_i"][matched_gt].long()
    gt_u = gt["dp_u"][matched_gt]
    gt_v = gt["dp_v"][matched_gt]
    pt_valid = gt["dp_pt_valid"][matched_gt] & dp_valid[:, None]

    hx, hy, inside = _points_to_heatmap_coords(px, py, dp_boxes, s)
    j_valid = pt_valid & inside
    j_valid_fg = j_valid & (gt_i > 0)
    fg_w = j_valid_fg.float()

    def at_label(maps):
        return torch.gather(_bilinear_at_points(maps, hx, hy), -1,
                            gt_i[..., None])[..., 0]

    loss_u = (smooth_l1(at_label(outs["u"]), gt_u, 1.0) * fg_w).sum() \
        * tcfg.w_points
    loss_v = (smooth_l1(at_label(outs["v"]), gt_v, 1.0) * fg_w).sum() \
        * tcfg.w_points

    fine_est = _bilinear_at_points(outs["fine_segm"], hx, hy)  # (K, P, 25)
    logp = F.log_softmax(fine_est, dim=-1)
    ce_i = -torch.gather(logp, -1, gt_i[..., None])[..., 0]
    n_pts = j_valid.sum().clamp_min(1)
    loss_i = (ce_i * j_valid).sum() / n_pts * tcfg.w_part

    masks = _mask_in_box(gt["dp_mask"][matched_gt], gt["boxes"][matched_gt],
                         dp_boxes, s)
    seg_logp = F.log_softmax(outs["coarse_segm"], dim=-1)
    ce_s = -torch.gather(seg_logp, -1, masks.long()[..., None])[..., 0]
    n_px = (dp_valid.sum() * s * s).clamp_min(1)
    loss_s = (ce_s * dp_valid[:, None, None]).sum() / n_px * tcfg.w_segm
    # _dp_pts / _dp_px let detection_total_loss rebuild the reference's
    # batch-global point / pixel means and point-sum U / V from these
    # per-image values (chart.py:239-240 reduction="sum"; the CE means run
    # over the batch-concatenated point / pixel sets, not per image)
    return {"loss_densepose_U": loss_u, "loss_densepose_V": loss_v,
            "loss_densepose_I": loss_i, "loss_densepose_S": loss_s,
            "_dp_pts": j_valid.sum().float(),
            "_dp_px": (dp_valid.sum() * s * s).float()}


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------


def _select_topk_mask(mask, priority, k: int):
    """Indices of the k highest-priority entries where mask holds (padded
    with index 0 + invalid flag); ties lower index first (``lax.top_k``)."""
    pri = torch.where(mask, priority, -float("inf"))
    top, idx = top_k(pri, k)
    valid = torch.isfinite(top)
    return torch.where(valid, idx, 0), valid


class _Bound(nn.Module):
    """``fn(model, ...)`` as a forward, so ``functional_call`` can hand
    ``model`` a dict of parameters."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def _with_params(model, params: Optional[Mapping[str, torch.Tensor]], fn,
                 *args, **kwargs):
    """``fn(model, *args, **kwargs)`` with ``model``'s parameters replaced
    by ``params`` (``None``: its own)."""
    if params is None:
        return fn(model, *args, **kwargs)
    return functional_call(_Bound(model),
                           {f"model.{k}": v for k, v in params.items()},
                           (fn,) + args, kwargs)


def _features(model, images, impl):
    """The batched part: backbone, FPN and the RPN convs on every level.
    Returns (ps, anchors (N, 4), objectness (B, N), deltas (B, N, 4)), the
    levels concatenated in JAX's order."""
    cfg = model.cfg
    ps = model.fpn(model.backbone(images, impl=impl), impl=impl)
    anchors_l, obj_l, del_l = [], [], []
    for lvl, p in enumerate(ps):
        h = F.relu(conv2d(model.rpn.conv, p, padding=((1, 1), (1, 1)),
                          impl=impl))
        obj = conv2d(model.rpn.objectness, h, impl=impl)
        dl = conv2d(model.rpn.deltas, h, impl=impl)
        b, fh, fw, _ = obj.shape
        anchors_l.append(torch.from_numpy(make_anchors(
            (fh, fw), 4 * 2 ** lvl, cfg.anchor_sizes[lvl],
            cfg.aspect_ratios)).to(images.device))
        obj_l.append(obj.reshape(b, -1))
        del_l.append(dl.reshape(b, -1, 4))
    return ps, torch.cat(anchors_l), torch.cat(obj_l, 1), torch.cat(del_l, 1)


def _draws(n_images: int, generator, uniforms) -> List[Sequence]:
    """Each image's three uniform vectors (anchors, proposals, densepose
    slab): ``uniforms`` as given, else drawn from ``generator`` in that
    order, image by image."""
    if uniforms is not None:
        if len(uniforms) != n_images:
            raise ValueError(f"uniforms for {len(uniforms)} images, "
                             f"expected {n_images}")
        return uniforms
    if generator is None:
        raise ValueError("pass a torch.Generator or the uniforms")
    return [[generator, generator, generator] for _ in range(n_images)]


def _image_losses(model, ps, dec, i: int, img_hw, anchors, obj, dl, gt,
                  draws, proposals, tcfg: DetectionTrainConfig, impl,
                  record):
    """``detection_loss_fn``'s body for image ``i`` of the batched
    features: RPN losses, proposals (detached) + the gt boxes, ROI
    sampling, the box head and the densepose head on its slab."""
    cfg = model.cfg
    u_rpn, u_roi, u_dp = draws
    rec = {} if record is not None else None
    losses = rpn_losses(anchors, obj, dl, gt["boxes"], gt["valid"], u_rpn,
                        tcfg, rec)

    # proposals (detached, rpn.py predict_proposals "no grad to boxes"),
    # gt boxes appended (roi_heads.py::add_ground_truth_to_proposals)
    nms_rec = {}
    with torch.no_grad():
        prop_all = clip_boxes(apply_deltas(anchors, dl.detach(),
                                           (1.0, 1.0, 1.0, 1.0)), img_hw)
        k_prop = min(cfg.rpn_post_nms_topk, prop_all.shape[0])
        if proposals is None:
            pb, _, pidx = nms_topk(prop_all, obj.detach(),
                                   iou_threshold=cfg.rpn_nms_thresh,
                                   topk=k_prop, record=nms_rec)
        else:   # NMS's choice from another run: this run's boxes
            pidx = proposals.to(prop_all.device)
            pb = torch.where((pidx >= 0)[:, None],
                             prop_all[pidx.clamp_min(0)], 0.0)
    prop_boxes = torch.cat([pb, gt["boxes"]])
    prop_present = torch.cat([pidx >= 0, gt["valid"]])

    matched, labels = match_boxes(
        prop_boxes, gt["boxes"], gt["valid"], low=tcfg.roi_iou_thresh,
        high=tcfg.roi_iou_thresh, allow_low_quality=False)
    labels = torch.where(prop_present, labels, -1)  # padding never sampled
    sample_w = subsample_labels(
        labels, u_roi, num_samples=tcfg.roi_batch_per_image,
        positive_fraction=tcfg.roi_positive_fraction)
    fg_mask = labels == 1

    # box head on all (static-capacity) proposals, losses masked
    ps_i = [p[i:i + 1] for p in ps[:4]]
    pooled = multilevel_roi_align(ps_i, prop_boxes, sample_w > 0, 7)
    bh = model.box_head
    fc = F.relu(linear(bh.fc1, pooled.reshape(pooled.shape[0], -1)))
    fc = F.relu(linear(bh.fc2, fc))
    losses.update(box_head_losses(
        linear(bh.cls, fc), linear(bh.reg, fc), prop_boxes,
        gt["boxes"][matched], fg_mask, sample_w, cfg))

    # densepose head on a fixed-size slab of sampled foreground proposals
    # (roi_head.py::DensePoseROIHeads.forward selects fg)
    fg_sampled = fg_mask & (sample_w > 0)
    dp_idx, dp_valid = _select_topk_mask(
        fg_sampled, _uniform(u_dp, fg_mask.shape[0], fg_mask.device),
        tcfg.n_dp_train)
    dp_boxes = prop_boxes[dp_idx]
    if dec is not None:
        dpp = roi_align(dec, dp_boxes, torch.where(dp_valid, i, -1),
                        output_size=cfg.dp_pooler, spatial_scale=0.25,
                        sampling_ratio=2)
    else:
        dpp = multilevel_roi_align(ps_i, dp_boxes, dp_valid, cfg.dp_pooler)
    outs = model._dp_head(dpp, impl=impl)
    losses.update(densepose_chart_losses(
        outs, dp_boxes, dp_valid, gt, matched[dp_idx], tcfg, cfg))
    if record is not None:
        rec.update(prop_idx=pidx, nms_visited=nms_rec.get("visited"),
                   roi_w=sample_w, fg=fg_mask, dp_idx=dp_idx,
                   dp_valid=dp_valid)
        record.append(rec)
    return losses


def _per_image(model, images, gts, generator, uniforms, proposals, tcfg,
               impl, record):
    ps, anchors, obj, dl = _features(model, images, impl)
    dec = model.decoder(ps, impl=impl) if model.cfg.decoder_on else None
    b = images.shape[0]
    draws = _draws(b, generator, uniforms)
    return [_image_losses(model, ps, dec, i, images.shape[1:3], anchors,
                          obj[i], dl[i], {k: v[i] for k, v in gts.items()},
                          draws[i], None if proposals is None
                          else proposals[i], tcfg, impl, record)
            for i in range(b)]


def detection_loss_fn(model, params, image, gt, generator=None, *,
                      tcfg: DetectionTrainConfig = DetectionTrainConfig(),
                      uniforms=None, proposals=None,
                      impl: Optional[str] = None,
                      record: Optional[list] = None) -> dict:
    """All detectron2 training losses for one image (GeneralizedRCNN's
    training branch, detectron2 meta_arch/rcnn.py:123-169), with the
    per-image point / pixel counts ``_dp_pts`` / ``_dp_px``.

    model: a ``DensePoseRCNN`` (its cfg is the model's); params: a flat
    dict of its parameters by name (``detection_params``), or None for its
    own. image: (1, H, W, 3) preprocessed; gt: dict with boxes (G, 4),
    valid (G,), dp_x / dp_y / dp_i / dp_u / dp_v / dp_pt_valid (G, P),
    dp_mask (G, M, M) bool. The sampler's uniforms come from ``generator``
    or ``uniforms`` ([[u_anchors, u_proposals, u_dp]]). ``record``, a
    list, receives a dict of the image's sampled sets. ``proposals``
    ([prop_idx], a record's): the proposals NMS kept in another run, in
    place of this run's NMS, so that two runs of different numerics
    (``impl``) sample the same sets."""
    gts = {k: v[None] for k, v in gt.items()}
    return _with_params(model, params, _per_image, image, gts, generator,
                        uniforms, proposals, tcfg, impl, record)[0]


def detection_total_loss(model, params, images, gts, generator=None, *,
                         tcfg: DetectionTrainConfig = DetectionTrainConfig(),
                         uniforms=None, proposals=None,
                         impl: Optional[str] = None,
                         record: Optional[list] = None):
    """Batch reduction with the reference's normalizers: images (B, H, W,
    3), gts a dict of stacked per-image gt tensors (leading dim B);
    ``uniforms``: one [u_anchors, u_proposals, u_dp] an image;
    ``proposals``, ``record``: ``detection_loss_fn``'s, one an image.
    Returns (total, losses).

    RPN / box losses are per-image normalized (rpn.py:416-428 divides by
    256 x images; fast_rcnn samples exactly 512 an image, so the batch mean
    equals the per-image mean). DensePose losses are not per-image
    normalized in the reference (chart.py:239-240): U / V are sums over
    every point of the batch x 0.01, and I / S are CE means over the
    batch-concatenated point / pixel sets, so U / V sum across images and
    I / S renormalize by the batch-total counts here."""
    per = _with_params(model, params, _per_image, images, gts, generator,
                       uniforms, proposals, tcfg, impl, record)
    stack = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    n_pts = stack.pop("_dp_pts")
    n_px = stack.pop("_dp_px")
    losses = {k: stack[k].mean() for k in sorted(stack)}
    losses["loss_densepose_U"] = stack["loss_densepose_U"].sum()
    losses["loss_densepose_V"] = stack["loss_densepose_V"].sum()
    # per-image means carry their own counts -> recover sums, renormalize
    losses["loss_densepose_I"] = ((stack["loss_densepose_I"] * n_pts).sum()
                                  / n_pts.sum().clamp_min(1.0))
    losses["loss_densepose_S"] = ((stack["loss_densepose_S"] * n_px).sum()
                                  / n_px.sum().clamp_min(1.0))
    total = sum(losses.values())
    return total, losses


# ---------------------------------------------------------------------------
# parameters, the optimizer, the step
# ---------------------------------------------------------------------------


def detection_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """fp32 masters of ``model``'s parameters by name (copies: the model
    keeps its own). ``make_detection_train_step``'s step marks the ones its
    optimizer trains as requiring grad."""
    return {n: p.detach().to(torch.float32, copy=True)
            for n, p in model.named_parameters()}


def detection_trainable_mask(params: Mapping[str, torch.Tensor],
                             tcfg: DetectionTrainConfig =
                             DetectionTrainConfig()) -> Dict[str, bool]:
    """True for the leaves the reference trains, by name. Not trainable:
    - backbone stages up to BACKBONE.FREEZE_AT=2, i.e. stem + res2
      (detectron2 backbone/resnet.py freeze());
    - every FrozenBatchNorm scale / bias (non-trainable buffers in
      detectron2 layers/batch_norm.py::FrozenBatchNorm2d), which also
      realizes SOLVER.WEIGHT_DECAY_NORM=0.0: the backbone's frozen BNs are
      the model's only norm layers.
    The same walk as JAX's over its tree, on the names' components."""
    # FREEZE_AT=0 freezes nothing, >=1 the stem, >=2 also res2..res{at}
    frozen_stages = ({"stem"} if tcfg.freeze_at >= 1 else set()) \
        | {f"res{i}" for i in range(2, tcfg.freeze_at + 1)}
    mask = {}
    for name in params:
        in_backbone = frozen = False
        for key in name.split("."):
            if in_backbone and (key in frozen_stages or key == "bn"):
                frozen = True
            in_backbone = in_backbone or key == "backbone"
        mask[name] = not frozen
    return mask


class DetectionSGD:
    """``make_detection_optimizer``'s transformation, in place:
    optax.chain(add_decayed_weights(wd), sgd(lr, momentum)) on the
    trainable leaves (``mask``; None: every leaf) and a zero update on the
    rest (optax.masked(set_to_zero)). form "optax" runs optax's arithmetic
    (g + wd p; trace g + m trace; p + (-lr) trace); form "torch" runs
    ``torch.optim.SGD(lr, momentum, dampening=0, weight_decay)`` over the
    trainable leaves, the same arithmetic (its first momentum buffer is
    g + wd p, as the trace's from zero)."""

    def __init__(self, tcfg: DetectionTrainConfig,
                 mask: Optional[Mapping[str, bool]] = None,
                 form: str = "optax"):
        if form not in ("optax", "torch"):
            raise ValueError(form)
        self.tcfg, self.mask, self.form = tcfg, mask, form

    def trains(self, name: str) -> bool:
        return True if self.mask is None else bool(self.mask[name])

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        train = [k for k in params if self.trains(k)]
        if self.form == "torch":
            t = self.tcfg
            return {"sgd": torch.optim.SGD(
                [params[k] for k in train], lr=t.lr, momentum=t.momentum,
                dampening=0.0, weight_decay=t.weight_decay)}
        return {"trace": {k: torch.zeros_like(params[k]) for k in train}}

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: dict,
                params: Mapping[str, torch.Tensor]) -> None:
        """Updates ``params`` (the trainable ones) and ``state`` in place;
        ``grads`` holds a gradient for every trainable leaf."""
        t = self.tcfg
        if self.form == "torch":
            for k, p in params.items():
                if self.trains(k):
                    p.grad = grads[k]
            state["sgd"].step()
            for p in params.values():
                p.grad = None
            return
        for k, trace in state["trace"].items():
            p = params[k]
            u = grads[k] + t.weight_decay * p
            trace.copy_(u + t.momentum * trace)
            p.add_(-t.lr * trace)


def make_detection_optimizer(tcfg: DetectionTrainConfig =
                             DetectionTrainConfig(), params=None, *,
                             form: str = "optax") -> DetectionSGD:
    """SGD + momentum + weight decay (detectron2 solver/build.py with the
    served config: BASE_LR 0.01). With ``params`` the frozen leaves
    (``detection_trainable_mask``) get zero updates and no weight decay
    (FREEZE_AT=2 + FrozenBatchNorm buffers + WEIGHT_DECAY_NORM=0.0);
    without, every leaf trains and decays, as JAX's."""
    mask = None if params is None else detection_trainable_mask(params, tcfg)
    return DetectionSGD(tcfg, mask, form)


def make_detection_train_step(tcfg: DetectionTrainConfig =
                              DetectionTrainConfig(), tx=None, *,
                              impl: Optional[str] = None):
    """Returns ``step(model, params, opt_state, images, gts,
    generator=None, uniforms=None, record=None) -> (opt_state,
    metrics)``: the gradient of ``detection_total_loss`` for every leaf
    ``tx`` trains (a leaf the loss does not reach gets zeros, as in JAX),
    then ``tx``'s update of ``params`` and ``opt_state`` in place. metrics:
    each loss and ``total_loss``, 0-dim fp32 tensors."""
    if tx is None:
        tx = make_detection_optimizer(tcfg)

    def step(model, params, opt_state, images, gts, generator=None,
             uniforms=None, record=None):
        train = [k for k in params if tx.trains(k)]
        for k, p in params.items():
            p.requires_grad_(tx.trains(k))
        total, losses = detection_total_loss(
            model, params, images, gts, generator, tcfg=tcfg,
            uniforms=uniforms, impl=impl, record=record)
        gs = torch.autograd.grad(total, [params[k] for k in train],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(train, gs)}
        tx.update_(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return opt_state, metrics

    return step
