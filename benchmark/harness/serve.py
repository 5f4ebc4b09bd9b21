"""Closed-loop try-on serving: one client sends requests back to back to
``TryonPipeline.stepwise_generate``; each request is drawn from the seed
at the traffic's shapes, with its mask and pose precomputed.

Per request the harness keeps what the timed path produced: the
conditioning the staged encoder handed to the denoise loop (read where the
pipeline passes it on), the latents after each step (the pipeline's
``callback_on_step_end``), and the images. Once the window has closed and
the program is freed, a sample of the finished requests drawn from the
seed is judged against the fp32 reference (``check``)."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.harness import common
from benchmark.reference import stack as ref
from benchmark.reference.scheduler import DDPM, cfg_combine


def _port_configs(stack: dict) -> dict:
    from idmvton_tpu_torch.core import config as C
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items()}
    return {"unet_cfg": C.UNetConfig(**tup(stack["unet"])),
            "garm_cfg": C.UNetConfig(**tup(stack["garm"])),
            "vae_cfg": C.VAEConfig(**tup(stack["vae"])),
            "clip_l_cfg": C.CLIPTextConfig(**stack["clip_l"]),
            "clip_g_cfg": C.CLIPTextConfig(**stack["clip_g"]),
            "vision_cfg": C.CLIPVisionConfig(**tup(stack["vision"])),
            "resampler_cfg": C.ResamplerConfig(**stack["resampler"])}


def build_models(config: dict, seed: int, device):
    """The program's stack with the benchmark's seeded weights."""
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    stack = config["stack"]
    models = TryonModels.init(seed=None, cfgs=_port_configs(stack),
                              device=device)
    flat = common.make_weights(ref.param_specs(stack), seed, device)
    common.load_into(models.components(), flat)
    del flat
    return models


def make_request(stack, traffic, seed: int, i: int, device) -> dict:
    """Request ``i``: person, pose and cloth images and the garment's
    CLIP image in [-1, 1], an inpaint mask (a rectangle over the torso,
    placed by the seed, the same area in every request), token ids of the
    three prompts for both towers, the initial and per-step noise, and the
    seed of the VAE posterior's draw."""
    g = common.generator(device, seed, "request", i)
    b, hh, ww = traffic["batch"], traffic["height"], traffic["width"]
    dt = torch.bfloat16

    def img(h, w):
        return (torch.rand(b, h, w, 3, generator=g, device=device) * 2
                - 1).to(dt)

    def ids():
        vocab = min(stack["clip_l"]["vocab_size"],
                    stack["clip_g"]["vocab_size"])
        return torch.randint(0, vocab, (b, 77), generator=g, device=device)

    mh, mw = int(hh * traffic["mask_frac"]), int(ww * traffic["mask_frac"])
    top = int(torch.randint(0, hh - mh + 1, (1,), generator=g,
                            device=device))
    left = int(torch.randint(0, ww - mw + 1, (1,), generator=g,
                             device=device))
    mask = torch.zeros(b, hh, ww, 1, device=device, dtype=dt)
    mask[:, top:top + mh, left:left + mw] = 1
    isz = stack["vision"]["image_size"]
    ds = 2 ** (len(stack["vae"]["channel_mults"]) - 1)
    lat = (b, hh // ds, ww // ds, stack["vae"]["latent_channels"])
    inputs = dict(person=img(hh, ww), pose=img(hh, ww), cloth=img(hh, ww),
                  mask=mask, ip_pixels=img(isz, isz),
                  prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                  neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids())
    noise = dict(init_noise=torch.randn(lat, generator=g, device=device),
                 step_noise=torch.randn((traffic["steps"],) + lat,
                                        generator=g, device=device))
    return {"inputs": inputs, "noise": noise,
            "vae_seed": common.sub_seed(seed, "vae", i)}


class Server:
    """The program's pipeline and its serving entry, with taps that keep
    what each request produced."""

    def __init__(self, models, traffic, device):
        from idmvton_tpu_torch.pipeline.tryon import TryonPipeline
        self.device = device
        self.pipe = TryonPipeline(models)
        self.latents = []
        self.conds = []
        finish = self.pipe._finish

        def tapped_finish(generator, cond, *a, **kw):
            self.conds.append(cond)
            return finish(generator, cond, *a, **kw)

        self.pipe._finish = tapped_finish
        self.fn = self.pipe.stepwise_generate(
            num_steps=traffic["steps"],
            guidance_scale=traffic["guidance_scale"],
            garment_cache=traffic["garment_cache"],
            callback_on_step_end=lambda pipe, i, t, d: self.latents.append(
                d["latents"]))

    def __call__(self, req, phases: dict):
        """Serves ``req``; returns (seconds, images, record)."""
        self.latents, self.conds = [], []
        gen = torch.Generator(device=self.device).manual_seed(req["vae_seed"])
        _sync(self.device)
        t0 = time.perf_counter()
        images = self.fn(gen, phase_seconds=phases, **req["inputs"],
                         **req["noise"])
        _sync(self.device)
        dt = time.perf_counter() - t0
        return dt, images, {"cond": self.conds[0],
                            "latents": list(self.latents)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, prepare=None) -> dict:
    """Set-up, the window, the check; returns the result's parts.
    ``prepare(models)``, when given, changes the program's stack before it
    serves (the control's lower-precision path)."""
    config, traffic = cell["config"], cell["traffic"]
    stack = config["stack"]
    models = build_models(config, seed, device)
    if prepare is not None:
        prepare(models)
    server = Server(models, traffic, device)
    # warm-up: every shape of the window (the step graph is captured here)
    for w in range(traffic["warmup_requests"]):
        server(make_request(stack, traffic, seed, -1 - w, device), {})
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    done, traced = [], None
    w0 = time.perf_counter()
    i = 0
    while True:
        req = make_request(stack, traffic, seed, i, device)
        phases = {}
        if trace and i == 1:
            from benchmark.harness.trace import profiled
            (dt, images, rec), traced = profiled(lambda: server(req, phases))
        else:
            dt, images, rec = server(req, phases)
        done.append({"i": i, "seconds": dt, "phases": phases,
                     "images": images, "traced": trace and i == 1, **rec})
        i += 1
        if time.perf_counter() - w0 >= seconds and (not trace or i > 2):
            break
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = sum(1 for r in done
                 if not bool(torch.isfinite(r["images"]).all()))
    narrow = common.narrow_tensors(models.components(), config["dtype"])

    # the program is freed before the reference runs
    del server, models
    gc.collect()  # the taps and closures hold cycles
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings, info = check(cell, seed, done, device)
    readings["narrow_tensors"] = narrow
    times = [r["seconds"] for r in done if not r["traced"]]
    return {"setup_s": setup_s, "done": done, "times": times,
            "e2e": {"request_s": sum(times) / len(times),
                    "request_s.p95": common.p95(times)},
            "peak": peak, "failed": failed, "readings": readings,
            "info": info, "trace": traced}


# ---------------------------------------------------------------------------
# the check against the fp32 reference
# ---------------------------------------------------------------------------


def sample_requests(traffic, seed, n_done):
    g = torch.Generator().manual_seed(common.sub_seed(seed, "sample"))
    k = min(traffic["check_requests"], n_done)
    return sorted(torch.randperm(n_done, generator=g)[:k].tolist())


def ref_encode(W, stack, inputs, vae_noise):
    """The reference's conditioning of one request (the pipeline's dict)."""
    f = lambda t: t.float()
    b, hh, ww, _ = inputs["person"].shape
    ids_l = torch.cat([inputs["prompt_ids_l"], inputs["neg_ids_l"],
                       inputs["cloth_ids_l"]])
    ids_g = torch.cat([inputs["prompt_ids_g"], inputs["neg_ids_g"],
                       inputs["cloth_ids_g"]])
    pen_l, _ = ref.clip_text(W.sub("clip_l"), stack["clip_l"], ids_l)
    pen_g, pooled = ref.clip_text(W.sub("clip_g"), stack["clip_g"], ids_g)
    embeds = torch.cat([pen_l, pen_g], -1)
    prompt, neg, cloth = embeds.chunk(3)
    pooled_p, pooled_n, _ = pooled.chunk(3)
    ip = f(inputs["ip_pixels"])
    vis = ref.clip_vision_penultimate(W.sub("vision"), stack["vision"],
                                      torch.cat([torch.zeros_like(ip), ip]))
    ip_u, ip_c = ref.resampler(W.sub("resampler"), stack["resampler"],
                               vis).chunk(2)
    mask = f(inputs["mask"])
    person = f(inputs["person"]) * (mask < 0.5).float()
    lat = ref.vae_encode(W.sub("vae"), stack["vae"],
                         torch.cat([person, f(inputs["pose"]),
                                    f(inputs["cloth"])]), vae_noise)
    masked, pose, cloth_lat = lat.chunk(3)
    ds = 2 ** (len(stack["vae"]["channel_mults"]) - 1)
    row = [hh, ww, 0, 0, hh, ww]
    return {
        "context": torch.cat([torch.cat([neg, ip_u], 1),
                              torch.cat([prompt, ip_c], 1)]),
        "add_text_embeds": torch.cat([pooled_n, pooled_p]),
        "time_ids": torch.tensor([row] * (2 * b), dtype=torch.float32,
                                 device=mask.device),
        "mask_lat": ref.resize_nearest(mask, (hh // ds, ww // ds)),
        "masked_lat": masked, "pose_lat": pose, "cloth_lat": cloth_lat,
        "cloth_embeds": cloth,
    }


def ref_guided_eps(W, stack, cond, x, t, guidance):
    feats = ref.unet(W.sub("garm"), stack["garm"], cond["cloth_lat"], t,
                     cond["cloth_embeds"])
    two = lambda v: torch.cat([v, v])
    unet_in = torch.cat([two(x), two(cond["mask_lat"]),
                         two(cond["masked_lat"]), two(cond["pose_lat"])], -1)
    eps = ref.unet(W.sub("unet"), stack["unet"], unet_in, t, cond["context"],
                   added_cond=(cond["add_text_embeds"], cond["time_ids"]),
                   garment_features=feats, uncond_zero=True)
    return cfg_combine(*eps.chunk(2), guidance)


def check(cell, seed, done, device):
    """(readings, info) of the sampled requests, each the worst over them.

    Readings, the numbers compared:

    - ``encode_rel``: the worst relative gap of a conditioning tensor from
      the reference's encode of the same inputs.
    - ``step_ratio``: for each of the ``eps_steps`` first steps, the gap of
      the program's latents after the step from the reference's step taken
      from the program's latents before it, over the gap that the
      reference itself makes with every product's operands rounded to bf16
      (its encode and its step, ``stack.operands("bf16")``): the guided noise
      prediction's error and the update's, in units of the error bf16
      operands give this network. Random networks of different seeds
      differ some threefold in their sensitivity, and the bare gap with
      them (``step_rel``); the unit moves with it.
    - ``decode_rel``: the gap of the images from the reference's decode of
      the program's final latents.

    Info, not compared: ``step_rel``, the step's gap over the norm of its
    noise-prediction term, and ``step_unit``, the bf16-operand reference's
    gap over it.
    Later steps are not judged: with random weights the latents grow some
    twenty times over the schedule, and their bf16 rounding, not the
    prediction, would set the gap.
    """
    config, traffic = cell["config"], cell["traffic"]
    stack = config["stack"]
    sched = DDPM(config["scheduler"])
    ts, prev = sched.timesteps(traffic["steps"])
    out = {"encode_rel": 0.0, "step_ratio": 0.0, "decode_rel": 0.0}
    info = {"step_rel": 0.0, "step_unit": 0.0}
    with torch.no_grad(), ref.fp32_mode():
        W = ref.Root(common.make_weights(ref.param_specs(stack), seed, device))
        for i in sample_requests(traffic, seed, len(done)):
            rec = done[i]
            req = make_request(stack, traffic, seed, rec["i"], device)
            b = traffic["batch"]
            shape = (3 * b,) + tuple(rec["latents"][0].shape[1:])
            vae_noise = torch.randn(shape, device=device, generator=torch.
                                    Generator(device=device).manual_seed(
                                        req["vae_seed"]))
            cond = ref_encode(W, stack, req["inputs"], vae_noise)
            for k, v in cond.items():
                out["encode_rel"] = max(out["encode_rel"],
                                        common.rel(rec["cond"][k], v))
            with ref.operands("bf16"):
                cond_b = ref_encode(W, stack, req["inputs"], vae_noise)
            noise = req["noise"]
            for k in range(traffic["eps_steps"]):
                x = (noise["init_noise"] if k == 0
                     else rec["latents"][k - 1].float())
                a, bc, s = sched.coefficients(int(ts[k]), int(prev[k]))
                g = traffic["guidance_scale"]
                eps = ref_guided_eps(W, stack, cond, x, int(ts[k]), g)
                with ref.operands("bf16"):
                    eps_b = ref_guided_eps(W, stack, cond_b, x, int(ts[k]), g)
                want = a * x + bc * eps + s * noise["step_noise"][k]
                unit = (bc * (eps_b - eps)).double().norm()
                got = rec["latents"][k]
                gap = (got.double() - want.double()).norm()
                term = (bc * eps).double().norm()
                ratio = (float(gap / unit) if bool(torch.isfinite(got).all())
                         else float("inf"))
                out["step_ratio"] = max(out["step_ratio"], ratio)
                info["step_rel"] = max(info["step_rel"], float(gap / term))
                info["step_unit"] = max(info["step_unit"],
                                        float(unit / term))
            img = ref.vae_decode(W.sub("vae"), stack["vae"],
                                 rec["latents"][-1].float()).clamp(-1, 1)
            out["decode_rel"] = max(out["decode_rel"],
                                    common.rel(rec["images"], img))
            del cond
    return out, info


def e4m3_control(cell, seed, device) -> dict:
    """The control: the reference in the serving program's place, every
    product's operands in float8 e4m3 (``stack.operands("e4m3")``), for the
    request the check would judge: its encode, its ``eps_steps`` first
    steps and the decode of the latents after them, judged by ``check``
    as the program's are."""
    config, traffic = cell["config"], cell["traffic"]
    stack = config["stack"]
    sched = DDPM(config["scheduler"])
    ts, prev = sched.timesteps(traffic["steps"])
    req = make_request(stack, traffic, seed, 0, device)
    b = traffic["batch"]
    lat0 = req["noise"]["init_noise"]
    with torch.no_grad(), ref.fp32_mode(), ref.operands("e4m3"):
        W = ref.Root(common.make_weights(ref.param_specs(stack), seed, device))
        vae_noise = torch.randn(
            (3 * b,) + tuple(lat0.shape[1:]), device=device,
            generator=torch.Generator(device=device).manual_seed(
                req["vae_seed"]))
        cond = ref_encode(W, stack, req["inputs"], vae_noise)
        lats, x = [], lat0
        for k in range(traffic["eps_steps"]):
            eps = ref_guided_eps(W, stack, cond, x, int(ts[k]),
                                 traffic["guidance_scale"])
            a, bc, s = sched.coefficients(int(ts[k]), int(prev[k]))
            x = a * x + bc * eps + s * req["noise"]["step_noise"][k]
            lats.append(x)
        img = ref.vae_decode(W.sub("vae"), stack["vae"], x).clamp(-1, 1)
        del W
    rec = {"i": 0, "cond": cond, "latents": lats, "images": img}
    one = dict(cell, traffic=dict(traffic, check_requests=1))
    return check(one, seed, [rec], device)
