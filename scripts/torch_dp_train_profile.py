#!/usr/bin/env python3
"""Where the time of one DensePose detection train step goes, on one NVIDIA
card: the R-50-FPN at ``DensePoseConfig()`` / ``DetectionTrainConfig()``,
its stem scaled to mean-subtracted pixels, masked SGD, B = 2 images of
800x1088 with 3 persons each (``dp_train_batch``).

Run from the root of a checkout: ``python3 scripts/torch_dp_train_profile.py
[--steps N]``. It needs one CUDA card and nvcc, and imports nothing of JAX.

It takes N train steps (default 6) through ``make_detection_train_step``
and logs each one's wall ms (host clock to a synchronize) beside its NMS
walks (boxes visited of 217,413, per image) and losses; then times, as the
mean of 3 after a warm-up, the loss forward alone (``no_grad``), forward +
backward, the optimizer update alone, and ``nms_topk`` alone on one image's
boxes; then profiles one step with ``torch.profiler`` (device busy time,
idle share, device ms by kernel group). The trace goes to
``chiprun_out/dp_train_step_trace.json``; the last line is one JSON object
with every reading.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as smoke  # noqa: E402
from torch_tiny_step_probe import GROUPS, grouped, profile_step  # noqa: E402

# the training step's own kernel groups before the serving ones: cuDNN's
# convolution backward, the plain attention's softmax backward
TRAIN_GROUPS = (("cuDNN (conv backward)", ("cudnn", "dgrad", "wgrad",
                                           "xmma", "conv2d")),
                ("softmax backward", ("softmax",))) + GROUPS

# the DensePose R-50-FPN trained at its served config: B images of
# DP_TRAIN_HW with G persons each (P annotated points, an M x M mask)
DP_TRAIN_HW = (800, 1088)
DP_TRAIN_B, DP_TRAIN_G, DP_TRAIN_P, DP_TRAIN_M = 2, 3, 128, 56


def dp_train_batch(dev, seed):
    """DP_TRAIN_B mean-subtracted BGR images and their ground truth, drawn
    on the card: G person boxes an image, P points in each (fine labels
    0-24, U / V in [0, 1)), an elliptic M x M mask each."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    (h, w), b, n, p, m = DP_TRAIN_HW, DP_TRAIN_B, DP_TRAIN_G, DP_TRAIN_P, \
        DP_TRAIN_M
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    mean = torch.tensor([103.530, 116.280, 123.675], device=dev)
    images = u(b, h, w, 3) * 255 - mean
    bw, bh = (0.15 + 0.25 * u(b, n)) * w, (0.3 + 0.4 * u(b, n)) * h
    x1, y1 = u(b, n) * (w - bw), u(b, n) * (h - bh)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, m, device=dev),
                            torch.linspace(-1, 1, m, device=dev),
                            indexing="ij")
    radius = 0.6 + 0.35 * u(b, n, 1, 1)
    gts = {"boxes": torch.stack([x1, y1, x1 + bw, y1 + bh], -1),
           "valid": torch.ones(b, n, dtype=torch.bool, device=dev),
           "dp_x": x1[..., None] + u(b, n, p) * bw[..., None],
           "dp_y": y1[..., None] + u(b, n, p) * bh[..., None],
           "dp_i": torch.randint(0, 25, (b, n, p), generator=g, device=dev),
           "dp_u": u(b, n, p), "dp_v": u(b, n, p),
           "dp_pt_valid": torch.ones(b, n, p, dtype=torch.bool, device=dev),
           "dp_mask": (xx ** 2 + yy ** 2)[None, None] < radius ** 2}
    return images, gts


def mean_ms(fn, reps=3):
    """Mean wall ms of ``reps`` calls after one warm-up, each ending in a
    synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this probe needs a "
                   "card")
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.ops.nms import nms_topk
    from idmvton_tpu_torch.preprocess.densepose import rcnn
    from idmvton_tpu_torch.preprocess.densepose import train as dt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    smoke.log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    dev = torch.device("cuda", 0)

    cfg, tcfg = rcnn.DensePoseConfig(), dt.DetectionTrainConfig()
    model = rcnn.init_densepose_rcnn(smoke.SEED + 60, cfg, device=dev)
    with torch.no_grad():
        model.backbone.stem.conv.kernel.div_(50.0)
    params = dt.detection_params(model)
    tx = dt.make_detection_optimizer(tcfg, params)
    state = tx.init(params)
    images, gts = dp_train_batch(dev, smoke.SEED + 61)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 63)
    step = dt.make_detection_train_step(tcfg, tx, impl="cuda")
    res = {"card": card, "steps": []}

    for i in range(args.steps):
        rec = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(model, params, state, images, gts, gen,
                              record=rec)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        visited = [r["nms_visited"] for r in rec]
        total = float(metrics["total_loss"])
        res["steps"].append({"ms": ms, "nms_visited": visited,
                             "total_loss": total})
        smoke.log(f"step {i + 1}: {ms:.1f} ms, NMS visited {visited} of "
                  f"217413, total loss {total:.5g}")

    holder = {"state": state}

    def one():
        holder["state"], _ = step(model, params, holder["state"], images,
                                  gts, gen)

    def forward():
        with torch.no_grad():
            dt.detection_total_loss(model, params, images, gts, gen,
                                    tcfg=tcfg, impl="cuda")

    train = [k for k in params if tx.trains(k)]

    def forward_backward():
        total, _ = dt.detection_total_loss(model, params, images, gts, gen,
                                           tcfg=tcfg, impl="cuda")
        return dict(zip(train, torch.autograd.grad(
            total, [params[k] for k in train])))

    out = {"step_ms": mean_ms(one), "forward_ms": mean_ms(forward),
           "forward_backward_ms": mean_ms(forward_backward)}
    updates = []
    for _ in range(3):
        grads = forward_backward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.update_(grads, holder["state"], params)
        torch.cuda.synchronize()
        updates.append((time.perf_counter() - t0) * 1e3)
    out["optimizer_ms"] = sum(updates) / len(updates)

    with torch.no_grad():
        _, anchors, obj, dl = dt._features(model, images, "cuda")
        prop = rcnn.clip_boxes(rcnn.apply_deltas(anchors, dl[0], (1.0,) * 4),
                               images.shape[1:3])
        rec = {}
        out["nms_ms"] = mean_ms(lambda: nms_topk(
            prop, obj[0], iou_threshold=cfg.rpn_nms_thresh,
            topk=cfg.rpn_post_nms_topk, record=rec))
        out["nms_visited"] = rec["visited"]
    del anchors, obj, dl, prop
    prof = profile_step(one, out["step_ms"], label="dp_train", top_n=15)
    prof["groups"] = grouped("dp_train", TRAIN_GROUPS)
    out["profile"] = prof
    smoke.log(f"dp train step {out['step_ms']:.1f} ms (forward "
              f"{out['forward_ms']:.1f}, forward + backward "
              f"{out['forward_backward_ms']:.1f}, optimizer "
              f"{out['optimizer_ms']:.1f}, nms_topk alone "
              f"{out['nms_ms']:.2f} ms over {out['nms_visited']} boxes); "
              f"{card}")
    res.update(out)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
