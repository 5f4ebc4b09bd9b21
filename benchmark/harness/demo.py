"""Closed-loop demo requests: one client sends two raw photos a request to
``TryonService.tryon`` (``idmvton_tpu_torch/cli/demo.py``), as the demo's
HTTP handler does: auto mask (OpenPose, SCHP ATR and LIP, the mask), the
DensePose pose image, then the try-on, under the service's lock.

The service is built by its own constructor over the try-on stack of the
configuration; the three nets' and the stack's weights are the
benchmark's, drawn from the seed. Per request the harness keeps, for the
requests the check may judge (``check_pool`` first, a sample drawn from
the seed), what the timed path produced: each net's input and outputs
(taps on the nets' forwards and on the R-CNN's NMS), the conditioning,
the latents after each step and the images. Once the window has closed
and the program is freed, those are judged against the fp32 reference
(``check``)."""

from __future__ import annotations

import argparse
import gc
import math
import time

import torch

from benchmark.harness import common, serve
from benchmark.reference import preprocess as ref_pre
from benchmark.reference import stack as ref
from benchmark.reference.scheduler import DDPM

NETS = ("openpose", "schp_atr", "schp_lip", "densepose")
STAGES = ("demo.openpose", "demo.parsing", "demo.mask", "demo.densepose")
NET_SPANS = ("openpose.net", "parsing.net", "densepose.net")
HOST_SPANS = ("openpose.decode", "parsing.post", "mask.build",
              "densepose.paint")


def net_weights(nets: dict, seed: int, device) -> dict:
    """The three nets' flat fp32 weights (one draw a component)."""
    return ref_pre.scale_draw_(common.make_weights(
        ref_pre.param_specs(nets), seed, device, dtype=torch.float32))


def net_modules(svc) -> dict:
    return {"openpose": svc.openpose.net, "schp_atr": svc.parsing.atr,
            "schp_lip": svc.parsing.lip, "densepose": svc.densepose.model}


# the DensePose settings the configuration states and the service's
# ``DensePoseConfig`` holds
DENSEPOSE_KEYS = ("anchor_sizes", "aspect_ratios", "rpn_pre_nms_topk",
                  "rpn_post_nms_topk", "rpn_nms_thresh", "box_score_thresh",
                  "box_nms_thresh", "num_detections", "dp_convs", "dp_dim",
                  "dp_pooler", "dp_chunk", "decoder_dim", "heatmap_size",
                  "num_patches")


def _served_as_stated(svc, nets):
    """Stops the run where the service's nets are not served as the
    configuration states."""
    op, dp, cfg = nets["openpose"], nets["densepose"], svc.densepose.cfg
    pairs = {"openpose.boxsize": (svc.openpose.boxsize, op["boxsize"]),
             "openpose.scales": (list(svc.openpose.scales), op["scales"]),
             "openpose.stride": (svc.openpose.stride, op["stride"]),
             "densepose.short_edge": (svc.densepose.short_edge,
                                      dp["short_edge"]),
             "densepose.max_size": (svc.densepose.max_size, dp["max_size"]),
             "densepose.decoder_on": (cfg.decoder_on, True)}
    for k in DENSEPOSE_KEYS:
        v = getattr(cfg, k)
        pairs[f"densepose.{k}"] = (list(v) if isinstance(v, tuple) else v,
                                   dp[k])
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if bad:
        raise SystemExit(f"the service's nets differ from the configuration"
                         f" (service, configuration): {bad}")


def make_service(cell: dict, seed: int, device):
    from idmvton_tpu_torch.cli.demo import TryonService
    config, traffic = cell["config"], cell["traffic"]
    models = serve.build_models(config, seed, device)
    args = argparse.Namespace(
        width=traffic["width"], height=traffic["height"], pretrained=None,
        tokenizer_dir=None, tiny=config["nets"]["tiny"], examples_dir=None,
        device=str(device))
    svc = TryonService(args, models=models)
    _served_as_stated(svc, config["nets"])
    flat = net_weights(config["nets"], seed, device)
    common.load_into(net_modules(svc), flat)
    del flat
    return svc


def make_request(traffic: dict, seed: int, i: int, device):
    """Request ``i``: a person and a garment photo (PIL, RGB, width x
    height), smooth random fields (a coarse uniform grid resized bilinearly,
    plus uniform noise of ``photo_noise``), a garment description from the
    traffic's list, and the try-on's seed."""
    from PIL import Image
    g = common.generator(device, seed, "photo", i)
    h, w = traffic["height"], traffic["width"]
    ch, cw = traffic["photo_cells"]

    def photo():
        coarse = torch.rand(1, 3, ch, cw, generator=g, device=device) * 255
        img = torch.nn.functional.interpolate(coarse, size=(h, w),
                                              mode="bilinear",
                                              align_corners=False)
        noise = (torch.rand(1, 3, h, w, generator=g, device=device) * 2
                 - 1) * traffic["photo_noise"]
        px = (img + noise).clamp(0, 255).round().to(torch.uint8)
        return Image.fromarray(px[0].permute(1, 2, 0).cpu().numpy())

    descs = traffic["descriptions"]
    k = int(torch.randint(0, len(descs), (1,), generator=g, device=device))
    return {"person": photo(), "garment": photo(), "desc": descs[k],
            "seed": common.sub_seed(seed, "tryon", i)}


class Taps:
    """Keeps, for a kept request, what the service's nets and try-on
    produced: each net's input and output (their forwards wrapped), the
    outputs of the R-CNN's NMS calls (the first: its proposals), its box
    head's input and class logits (its ``linear``), the try-on's inputs,
    conditioning, latents after each step and images. Every request's
    images leave a finiteness flag on the device."""

    def __init__(self, svc, steps: int):
        from idmvton_tpu_torch.preprocess.densepose import rcnn
        self.rec = None
        self.finite = []
        self._undo = []
        mods = net_modules(svc)

        def wrap_net(name):
            m = mods[name]
            orig = m.forward

            def fwd(x, *a, **kw):
                out = orig(x, *a, **kw)
                if self.rec is not None:
                    self.rec[name] = {"x": x, "out": out}
                return out
            m.forward = fwd
            self._undo.append(lambda: m.__dict__.pop("forward"))

        for name in ("openpose", "schp_atr", "schp_lip"):
            wrap_net(name)

        dp = mods["densepose"]
        dp_orig = dp.forward

        def dp_fwd(x, *, impl=None, record=None):
            rec = {} if record is None else record
            out = dp_orig(x, impl=impl, record=rec)
            if self.rec is not None:
                self.rec["densepose"] = {"x": x, "fpn": rec["fpn"],
                                         "out": out}
            return out
        dp.forward = dp_fwd
        self._undo.append(lambda: dp.__dict__.pop("forward"))

        bh, lin = mods["densepose"].box_head, rcnn.linear

        def lin_tap(p, x):
            out = lin(p, x)
            if self.rec is not None:
                if p is bh.fc1:
                    self.rec["box_fc_in"] = x
                elif p is bh.cls:
                    self.rec["box_logits"] = out
            return out
        rcnn.linear = lin_tap
        self._undo.append(lambda: setattr(rcnn, "linear", lin))

        nms = rcnn.nms_topk

        def nms_tap(boxes, scores, **kw):
            out = nms(boxes, scores, **kw)
            if self.rec is not None:
                self.rec.setdefault("nms", []).append(out)
            return out
        rcnn.nms_topk = nms_tap
        self._undo.append(lambda: setattr(rcnn, "nms_topk", nms))

        pipe = svc.pipe
        finish, loop = pipe._finish, pipe._loop

        def tapped_finish(generator, cond, *a, **kw):
            if self.rec is not None:
                self.rec["cond"] = cond
            return finish(generator, cond, *a, **kw)

        def on_step(p, i, t, d):
            if self.rec is not None:
                self.rec.setdefault("latents", []).append(d["latents"])

        def tapped_loop(*a, callback=None, **kw):
            return loop(*a, callback=on_step, **kw)

        pipe._finish, pipe._loop = tapped_finish, tapped_loop
        gen = svc._gen(steps)

        def tapped_gen(generator, **inputs):
            images = gen(generator, **inputs)
            self.finite.append(torch.isfinite(images).all())
            if self.rec is not None:
                self.rec["inputs"] = inputs
                self.rec["images"] = images
            return images
        svc._gens[steps] = tapped_gen

    def remove(self):
        for undo in self._undo:
            undo()


def _counter(name: str):
    """The program's counter ``name``, or None where it has none."""
    from benchmark.harness import spans
    prof = spans._profiling()
    return None if prof is None else prof.counters().get(name)


def traced_spans(res: dict, names) -> list:
    """The spans named in ``names`` of the traced request (the run's last
    ``len(res["done"])`` ``demo.request`` roots are the window's requests,
    in order), or [] where the program has none."""
    from benchmark.harness import spans
    prof = spans._profiling()
    done = res["done"]
    if prof is None or not done:
        return []
    ring = prof.spans()
    roots = [s for s in ring if s.name == "demo.request" and s.parent is None]
    if len(roots) < len(done):
        return []
    root = next((r for r, rec in zip(roots[len(roots) - len(done):], done)
                 if rec["traced"]), None)
    return [] if root is None else [s for s in ring if s.root == root.id
                                    and s.name in names]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kept_requests(traffic: dict, seed: int) -> list:
    """The requests the check judges: ``check_requests`` of the first
    ``check_pool``, drawn from the seed."""
    g = torch.Generator().manual_seed(common.sub_seed(seed, "sample"))
    k = min(traffic["check_requests"], traffic["check_pool"])
    return sorted(torch.randperm(traffic["check_pool"],
                                 generator=g)[:k].tolist())


def serve_one(svc, traffic, req):
    """One request through the service, as the HTTP handler calls it."""
    return svc.tryon(req["person"], req["garment"], req["desc"],
                     auto_mask=traffic["auto_mask"],
                     auto_crop=traffic["auto_crop"], steps=traffic["steps"],
                     seed=req["seed"])


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, prepare=None) -> dict:
    """Set-up, the window, the check; returns the result's parts.
    ``prepare(svc)``, when given, changes the program before it serves."""
    config, traffic = cell["config"], cell["traffic"]
    svc = make_service(cell, seed, device)
    if prepare is not None:
        prepare(svc)
    taps = Taps(svc, traffic["steps"])
    # warm-up: one whole request, which captures the batch-1 step graph
    # and meets every preprocessing shape
    for w in range(traffic["warmup_requests"]):
        serve_one(svc, traffic, make_request(traffic, seed, -1 - w, device))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    keep = set(kept_requests(traffic, seed))
    taps.finite.clear()
    counted = _counter("densepose.detections")
    done, traced = [], None
    w0 = time.perf_counter()
    i = 0
    while True:
        req = make_request(traffic, seed, i, device)
        taps.rec = {} if i in keep else None
        is_traced = trace and i == 1

        def one():
            _sync(device)
            t0 = time.perf_counter()
            serve_one(svc, traffic, req)
            _sync(device)
            return time.perf_counter() - t0

        if is_traced:
            from benchmark.harness.trace import profiled
            dt, traced = profiled(one)
        else:
            dt = one()
        done.append({"i": i, "seconds": dt, "traced": is_traced,
                     "tryon_seed": req["seed"], "taps": taps.rec})
        taps.rec = None
        i += 1
        if (time.perf_counter() - w0 >= seconds and (not trace or i > 2)
                and i > max(keep)):
            break
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = sum(1 for f in taps.finite if not bool(f))
    narrow = (common.narrow_tensors(svc.models.components(), config["dtype"])
              + common.narrow_tensors(net_modules(svc),
                                      config["nets"]["dtype"]))
    detections = _counter("densepose.detections")
    taps.remove()
    del svc, taps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings, info = check(cell, seed, [r for r in done if r["taps"]],
                           device)
    readings["narrow_tensors"] = narrow
    times = [r["seconds"] for r in done if not r["traced"]]
    return {"setup_s": setup_s, "done": done, "times": times,
            "e2e": {"request_s": sum(times) / len(times),
                    "request_s.p95": common.p95(times)},
            "peak": peak, "failed": failed, "readings": readings,
            "info": info, "trace": traced,
            "detections": (None if detections is None or counted is None
                           else detections - counted)}


# ---------------------------------------------------------------------------
# the check against the fp32 reference
# ---------------------------------------------------------------------------


def rel(got, want) -> float:
    """``common.rel``, and inf where the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return common.rel(got, want)


def judge_nets(W, nets, taps) -> dict:
    """The nets' readings of one request's taps against the reference on
    the same inputs:

    - ``openpose_rel``: the worse of the last stage's PAF and heatmap gaps;
    - ``parsing_rel``: the worse of ATR's and LIP's fusion-logit gaps;
    - ``fpn_rel``: the worst FPN level's gap (P2-P6);
    - ``box_logit_rel``: the box head's class logits over the program's
      own valid proposals, the reference's box head on its own features
      (logits, not the person probabilities: a random box head saturates
      most of them, which then move with no precision);
    - ``box_fc_rel``: the same logits against the reference's three FCs on
      the program's own pooled input: the FCs alone, stated in fp32;
    - ``dp_head_rel``: the worst of the DensePose head's coarse and fine
      segmentation and U and V on the program's kept detections, the
      reference's decoder, ROIAlign and head on its own features.
    """
    out = {}
    t = taps["openpose"]
    paf, heat = ref_pre.openpose(W.sub("openpose"), nets["openpose"],
                                 t["x"].float())
    out["openpose_rel"] = max(rel(t["out"][0], paf), rel(t["out"][1], heat))
    worst = 0.0
    for name in ("schp_atr", "schp_lip"):
        t = taps[name]
        fusion = ref_pre.schp(W.sub(name), nets["schp"], t["x"].float())
        worst = max(worst, rel(t["out"][1], fusion))
    out["parsing_rel"] = worst
    out.update(judge_densepose(W, nets["densepose"], taps))
    return out


def judge_densepose(W, cfg, taps) -> dict:
    t = taps["densepose"]
    w = W.sub("densepose")
    ps = ref_pre.resnet50_fpn(w, t["x"].float())
    fpn_rel = max(rel(g, r) for g, r in zip(t["fpn"], ps))
    prop_boxes, _, prop_idx = taps["nms"][0]
    valid = prop_idx >= 0
    logits = ref_pre.box_logits(w, cfg, ps, prop_boxes[valid].float())
    box_rel = rel(taps["box_logits"][valid], logits)
    fc_rel = rel(taps["box_logits"][valid],
                 ref_pre.box_fc(w, taps["box_fc_in"][valid].float()))
    o = t["out"]
    kept = o["valid"]
    head = ref_pre.densepose_head(w, cfg, ref_pre.decoder(w, ps),
                                  o["boxes"][kept].float())
    dp_rel = max(rel(o[k][kept], head[k]) for k in ("coarse", "fine", "u",
                                                    "v"))
    return {"fpn_rel": fpn_rel, "box_logit_rel": box_rel,
            "box_fc_rel": fc_rel, "dp_head_rel": dp_rel}


def tryon_noise(rec, shape, steps, device):
    """The draws the try-on took from its generator, in their order: the
    VAE posterior's (3 images), the initial noise, one a step; each as the
    program used it (the initial and step noise rounded to the latents'
    bf16)."""
    g = torch.Generator(device=device).manual_seed(rec["tryon_seed"])
    draw = lambda s: torch.randn(s, generator=g, device=device,
                                 dtype=torch.float32)
    vae = draw((3 * shape[0],) + tuple(shape[1:]))
    init = draw(shape).bfloat16().float()
    return vae, init, [draw(shape).bfloat16().float() for _ in range(steps)]


def judge_tryon(W, cell, rec, device) -> tuple:
    """``encode_ratio``, ``step_ratio`` and ``decode_rel`` of one request's
    try-on, the reference fed the program's own inputs (its mask and pose
    image among them) and draws. ``step_ratio`` and ``decode_rel`` are
    ``serve.check``'s. ``encode_ratio`` is the worst conditioning tensor's
    gap from the reference's encode, in units of the gap the reference
    itself makes with every product's operands in bf16 (as ``step_ratio``
    judges a step): the bare gap of the demo's pose latents
    (``serve.check``'s ``encode_rel``) moves tenfold from one painted pose
    image to another, and the reference's own bf16-operand gap with it
    (PERF.md §2). Info, not
    compared: ``step_rel``, ``step_unit``, ``encode_rel`` and each
    tensor's gap and unit (``encode_rel.<key>``, ``encode_unit.<key>``)."""
    config, traffic = cell["config"], cell["traffic"]
    stack = config["stack"]
    sched = DDPM(config["scheduler"])
    ts, prev = sched.timesteps(traffic["steps"])
    taps = rec["taps"]
    inputs = taps["inputs"]
    shape = tuple(taps["latents"][0].shape)
    vae_noise, init, step_noise = tryon_noise(rec, shape, traffic["steps"],
                                              device)
    out = {"encode_ratio": 0.0, "step_ratio": 0.0}
    info = {"encode_rel": 0.0, "step_rel": 0.0, "step_unit": 0.0}
    cond = serve.ref_encode(W, stack, inputs, vae_noise)
    with ref.operands("bf16"):
        cond_b = serve.ref_encode(W, stack, inputs, vae_noise)
    for k, v in cond.items():
        gap, unit = rel(taps["cond"][k], v), rel(cond_b[k], v)
        info[f"encode_rel.{k}"], info[f"encode_unit.{k}"] = gap, unit
        info["encode_rel"] = max(info["encode_rel"], gap)
        ratio = gap / unit if unit > 0 else (0.0 if gap == 0 else math.inf)
        out["encode_ratio"] = max(out["encode_ratio"], ratio)
    g = traffic["guidance_scale"]
    for k in range(traffic["eps_steps"]):
        x = init if k == 0 else taps["latents"][k - 1].float()
        a, bc, s = sched.coefficients(int(ts[k]), int(prev[k]))
        eps = serve.ref_guided_eps(W, stack, cond, x, int(ts[k]), g)
        with ref.operands("bf16"):
            eps_b = serve.ref_guided_eps(W, stack, cond_b, x, int(ts[k]), g)
        want = a * x + bc * eps + s * step_noise[k]
        unit = (bc * (eps_b - eps)).double().norm()
        got = taps["latents"][k]
        gap = (got.double() - want.double()).norm()
        term = (bc * eps).double().norm()
        out["step_ratio"] = max(out["step_ratio"], float(gap / unit)
                                if bool(torch.isfinite(got).all())
                                else float("inf"))
        info["step_rel"] = max(info["step_rel"], float(gap / term))
        info["step_unit"] = max(info["step_unit"], float(unit / term))
    img = ref.vae_decode(W.sub("vae"), stack["vae"],
                         taps["latents"][-1].float()).clamp(-1, 1)
    out["decode_rel"] = rel(taps["images"], img)
    return out, info


def check(cell, seed, kept, device, *, tryon=True):
    """(readings, info): each reading the worst over the kept requests;
    ``judge_nets``' six and, with ``tryon``, ``judge_tryon``'s three."""
    config = cell["config"]
    readings, info = {}, {}

    def worst(into, vals):
        for k, v in vals.items():
            into[k] = max(into.get(k, 0.0), v)

    with torch.no_grad(), ref.fp32_mode():
        W = ref.Root(net_weights(config["nets"], seed, device))
        for rec in kept:
            worst(readings, judge_nets(W, config["nets"], rec["taps"]))
        del W
        if tryon:
            W = ref.Root(common.make_weights(
                ref.param_specs(config["stack"]), seed, device))
            for rec in kept:
                r, i = judge_tryon(W, cell, rec, device)
                worst(readings, r)
                worst(info, i)
            del W
    return readings, info


# ---------------------------------------------------------------------------
# the control and the faults: what the check has to refuse
# ---------------------------------------------------------------------------


def one_request(cell, seed, device) -> dict:
    """Set-up and request 0 through the program, its taps kept; the
    program is freed before this returns."""
    traffic = cell["traffic"]
    svc = make_service(cell, seed, device)
    taps = Taps(svc, traffic["steps"])
    req = make_request(traffic, seed, 0, device)
    taps.rec = {}
    serve_one(svc, traffic, req)
    rec = {"i": 0, "traced": False, "tryon_seed": req["seed"],
           "taps": taps.rec}
    taps.remove()
    del svc, taps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _scatter(full, rows, values):
    out = full.clone()
    out[rows] = values.to(out.dtype)
    return out


def e4m3_control(cell, seed, device) -> tuple:
    """``operand_control`` with float8 e4m3 operands: the precision below
    the try-on's bf16."""
    return operand_control(cell, seed, device, "e4m3")


def operand_control(cell, seed, device, rounding: str, *,
                    tryon: bool = True, rec=None) -> tuple:
    """A control: the reference in the program's place, every product's
    operands rounded through ``rounding`` (``stack.operands``: "e4m3", or
    "bf16", the precision below the nets' TF32 and fp32 classes), on the
    inputs of the program's request 0: each net's outputs on the program's
    own inputs, proposals and detections (the box head's FCs on the
    control's own pooled input); with ``tryon``, the
    try-on's encode, ``eps_steps`` first steps and the decode of the
    latents after them. Judged by ``check`` as the program's are. ``rec``:
    the program's request 0 (``one_request``), made here by default; its
    taps are replaced by the control's."""
    config, traffic = cell["config"], cell["traffic"]
    nets, stack = config["nets"], config["stack"]
    rec = one_request(cell, seed, device) if rec is None else rec
    t = rec["taps"]
    with torch.no_grad(), ref.fp32_mode(), ref.operands(rounding):
        W = ref.Root(net_weights(nets, seed, device))
        x = t["openpose"]["x"].float()
        t["openpose"]["out"] = ref_pre.openpose(W.sub("openpose"),
                                                nets["openpose"], x)
        for name in ("schp_atr", "schp_lip"):
            fusion = ref_pre.schp(W.sub(name), nets["schp"],
                                  t[name]["x"].float())
            t[name]["out"] = (None, fusion, None)
        dp, w = t["densepose"], W.sub("densepose")
        ps = ref_pre.resnet50_fpn(w, dp["x"].float())
        dp["fpn"] = ps
        props, _, idx = t["nms"][0]
        valid = idx >= 0
        pooled = ref_pre.box_pooled(nets["densepose"], ps,
                                    props[valid].float())
        t["box_fc_in"] = _scatter(t["box_fc_in"], valid, pooled)
        t["box_logits"] = _scatter(t["box_logits"], valid,
                                   ref_pre.box_fc(w, pooled))
        o = dict(dp["out"])
        kept = o["valid"]
        head = ref_pre.densepose_head(w, nets["densepose"],
                                      ref_pre.decoder(w, ps),
                                      o["boxes"][kept].float())
        for k in ("coarse", "fine", "u", "v"):
            o[k] = _scatter(o[k], kept, head[k])
        dp["out"] = o
        del W
        if tryon:
            W = ref.Root(common.make_weights(ref.param_specs(stack), seed,
                                             device))
            sched = DDPM(config["scheduler"])
            ts, prev = sched.timesteps(traffic["steps"])
            shape = tuple(t["latents"][0].shape)
            vae, init, step_noise = tryon_noise(rec, shape,
                                                traffic["steps"], device)
            t["cond"] = serve.ref_encode(W, stack, t["inputs"], vae)
            lats, xk = [], init
            for k in range(traffic["eps_steps"]):
                eps = serve.ref_guided_eps(W, stack, t["cond"], xk,
                                           int(ts[k]),
                                           traffic["guidance_scale"])
                a, bc, s = sched.coefficients(int(ts[k]), int(prev[k]))
                xk = a * xk + bc * eps + s * step_noise[k]
                lats.append(xk)
            t["latents"] = lats
            t["images"] = ref.vae_decode(W.sub("vae"), stack["vae"],
                                         xk).clamp(-1, 1)
            del W
    return check(cell, seed, [rec], device, tryon=tryon)


def fault_readings(cell, seed, device) -> dict:
    """{fault: readings} of faults planted in the program's place on its
    request 0, each judged by ``check`` (the nets' numbers):

    - ``logits_x1.05``: SCHP's ATR fusion logits scaled by 1.05;
    - ``heatmaps_stage5``: OpenPose's PAF and heatmap of stage 5, not of
      the last stage (the reference's, on the program's input);
    - ``lip_for_atr``: the LIP net's logits in ATR's place.
    """
    nets = cell["config"]["nets"]
    rec = one_request(cell, seed, device)
    t = rec["taps"]
    with torch.no_grad(), ref.fp32_mode():
        W = ref.Root(net_weights(nets, seed, device))
        stage5 = ref_pre.openpose(W.sub("openpose"), nets["openpose"],
                                  t["openpose"]["x"].float(), stages=5)
        del W
    atr = t["schp_atr"]["out"]
    faults = {
        "logits_x1.05": {"schp_atr": dict(t["schp_atr"], out=(
            atr[0], atr[1] * 1.05, atr[2]))},
        "heatmaps_stage5": {"openpose": dict(t["openpose"], out=stage5)},
        "lip_for_atr": {"schp_atr": dict(t["schp_atr"],
                                         out=t["schp_lip"]["out"])},
    }
    out = {}
    for name, change in faults.items():
        bad = dict(rec, taps=dict(t, **change))
        out[name] = check(cell, seed, [bad], device, tryon=False)[0]
    return out
