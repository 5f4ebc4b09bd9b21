"""Back-to-back training steps: ``make_train_step``'s ``train_step`` on
seeded batches at the traffic's shapes, all rows different.

Set-up builds the one training object (the stack with the benchmark's
weights, fp32 masters of TryonNet and the Resampler, the optimizer's
state, the step) and drives it through its first ``check_steps`` steps on
batches 0, 1, ...; it keeps each step's loss, the first step's gradient norm
a leaf as the optimizer gets it (hooks on the masters read the backward's
gradient, scaled by the clip that the step's returned global norm calls
for) and, after the steps, each leaf's change from its starting value; then ``warmup_steps`` more. The
same object then runs the window. Once the window has closed and the
program is freed, the reference follows the same first steps from the
same weights and batches (``check``).

The cell judges one step (``check_steps`` 1): from the second step on,
the bf16 forward reads the fp32 masters rounded to bf16, in which an
update of the learning rate (1e-5) is about a twelfth of a weight's unit
in the last place, while the fp32 reference reads every update; the two
train different networks from then on, and later losses and changes part
by tens of percent in sound runs (PERF.md)."""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from benchmark.harness import common
from benchmark.harness.serve import _port_configs
from benchmark.reference import stack as ref
from benchmark.reference import train as ref_train

TRAINED = ref_train.TRAINED


def make_batch(stack, traffic, seed: int, i: int, device):
    """Batch ``i``: person, pose and cloth images, an inpaint mask (a
    rectangle placed by the seed, the same area in every batch), the
    garment's CLIP image, token ids of the prompt and the cloth prompt for
    both towers, the noise and the timesteps; and the seed of the
    generator whose first draw is the VAE posterior's."""
    g = common.generator(device, seed, "batch", i)
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
    mask = torch.zeros(b, hh, ww, 1, device=device, dtype=dt)
    for r in range(b):
        top = int(torch.randint(0, hh - mh + 1, (1,), generator=g,
                                device=device))
        left = int(torch.randint(0, ww - mw + 1, (1,), generator=g,
                                 device=device))
        mask[r, top:top + mh, left:left + mw] = 1
    isz = stack["vision"]["image_size"]
    ds = 2 ** (len(stack["vae"]["channel_mults"]) - 1)
    lat = (b, hh // ds, ww // ds, stack["vae"]["latent_channels"])
    batch = dict(person=img(hh, ww), pose=img(hh, ww), cloth=img(hh, ww),
                 mask=mask, ip_pixels=img(isz, isz), prompt_ids_l=ids(),
                 prompt_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids(),
                 noise=torch.randn(lat, generator=g, device=device),
                 timesteps=torch.randint(0, traffic["train_timesteps"], (b,),
                                         generator=g, device=device))
    return batch, common.sub_seed(seed, "vae", i)


def vae_draw(batch, vae_seed, device):
    """The VAE posterior's standard normal draw of a batch: the first draw
    of a generator seeded with ``vae_seed``, over the four encoded images
    of every row."""
    b, hh, ww = batch["person"].shape[:3]
    shape = (4 * b,) + tuple(batch["noise"].shape[1:])
    return torch.randn(shape, device=device, generator=torch.Generator(
        device=device).manual_seed(vae_seed))


def record_grad_norms(trainable: dict):
    """Hooks on the trained masters that keep each leaf's gradient norm
    as the step's backward computes it; returns (norms, handles)."""
    norms, handles = {}, []
    for comp in TRAINED:
        for n, p in trainable[comp].items():
            def keep(g, key=f"{comp}.{n}"):
                norms[key] = g.detach().norm()
            handles.append(p.register_hook(keep))
    return norms, handles


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, prepare=None) -> dict:
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.train_step import (
        init_train_state, make_optimizer, make_train_step,
    )
    config, traffic = cell["config"], cell["traffic"]
    stack = config["stack"]
    models = TryonModels.init(seed=None, cfgs=_port_configs(stack),
                              device=device)
    specs = ref.param_specs(stack)
    flat = common.make_weights(specs, seed, device)
    common.load_into(models.components(), flat)
    del flat
    if prepare is not None:
        prepare(models)
    sched = DDPMScheduler(SchedulerConfig(**config["scheduler"]))
    tx = make_optimizer(**config["optimizer"])
    state = init_train_state(models, tx)
    step = make_train_step(models, sched, tx, remat=config["remat"])

    def one(i, metrics=None):
        batch, vae_seed = make_batch(stack, traffic, seed, i, device)
        gen = torch.Generator(device=device).manual_seed(vae_seed)
        _sync(device)
        t0 = time.perf_counter()
        _, m = step(state, batch, gen)
        loss = m["loss"]
        _sync(device)
        if metrics is not None:
            metrics.update(m)
        return time.perf_counter() - t0, float(loss)

    # set-up: the judged steps, which the reference follows, then the
    # warm-up steps. The first step's gradient a leaf as the optimizer gets
    # it: the backward's, scaled by the clip the step's own global norm
    # (its ``grad_norm``) calls for.
    n_first = traffic["check_steps"]
    losses = []
    norms, hooks = record_grad_norms(state.trainable)
    for i in range(n_first):
        m = {}
        losses.append(one(i, m)[1])
        if i == 0:
            for h in hooks:
                h.remove()
            clip = min(1.0, config["optimizer"]["max_grad_norm"]
                       / float(m["grad_norm"]))
            grad = {f"{c}.{n}": float(norms.get(f"{c}.{n}", 0.0)) * clip
                    for c in TRAINED for n in state.trainable[c]}
    start = common.make_weights({c: specs[c] for c in TRAINED}, seed, device)
    with torch.no_grad():
        change = {f"{c}.{n}": float((p - start[f"{c}.{n}"].float()).norm())
                  for c in TRAINED for n, p in state.trainable[c].items()}
    del start
    for i in range(n_first, n_first + traffic["warmup_steps"]):
        one(i)
    n_first += traffic["warmup_steps"]
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    done, traced = [], None
    w0 = time.perf_counter()
    i = n_first
    while seconds > 0:
        if trace and i == n_first + 1:
            from benchmark.harness.trace import profiled
            (dt, loss), traced = profiled(lambda: one(i))
        else:
            dt, loss = one(i)
        done.append({"i": i, "seconds": dt, "loss": loss,
                     "traced": trace and i == n_first + 1})
        i += 1
        if (time.perf_counter() - w0 >= seconds
                and (not trace or i > n_first + 2)):
            break
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = sum(1 for r in done if not math.isfinite(r["loss"]))
    narrow = common.narrow_tensors(models.components(), config["dtype"])
    del step, state, models, tx
    gc.collect()  # the step's closures may hold cycles
    if device.type == "cuda":
        torch.cuda.empty_cache()
    program = {"losses": losses, "first_grad": grad, "change": change}
    readings = dict(check(cell, seed, program, device),
                    narrow_tensors=narrow)
    times = [r["seconds"] for r in done if not r["traced"]]
    return {"setup_s": setup_s, "done": done, "times": times,
            "e2e": {"train_step_s": sum(times) / max(len(times), 1)},
            "peak": peak, "failed": failed, "readings": readings,
            "info": {}, "trace": traced}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def reference_steps(cell, seed, device, fault=None):
    config, traffic = cell["config"], cell["traffic"]
    stack = config["stack"]
    with ref.fp32_mode():
        flat = common.make_weights(ref.param_specs(stack), seed, device)
        batches = []
        for i in range(traffic["check_steps"]):
            batch, vae_seed = make_batch(stack, traffic, seed, i, device)
            batches.append((batch, vae_draw(batch, vae_seed, device)))
        return ref_train.follow(flat, config, batches, fault=fault)


def compare(program: dict, want: dict) -> dict:
    """``loss_rel``: the worst step's loss gap over the reference's;
    ``grad_rel``: the worst leaf's gap of first-gradient norms (after the
    clip); and
    ``change_rel``: the worst leaf's gap of change norms after the steps,
    each leaf's gap over the larger of its reference norm and the median
    leaf's. Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the
    change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"],
                                                    want["losses"]))
    if not math.isfinite(loss):
        return {"loss_rel": math.inf, "grad_rel": math.inf,
                "change_rel": math.inf}

    def worst(got, ref_, keep):
        med = statistics.median(ref_[n] for n in keep)
        return max(abs(got[n] - ref_[n]) / max(ref_[n], med, 1e-30)
                   for n in keep)

    names = list(want["first_grad"])
    gmed = statistics.median(want["first_grad"].values())
    moving = [n for n in names if want["first_grad"][n] >= 1e-3 * gmed]
    return {"loss_rel": loss,
            "grad_rel": worst(program["first_grad"], want["first_grad"],
                              names),
            "change_rel": worst(program["change"], want["change"], moving)}


def check(cell, seed, program, device) -> dict:
    return compare(program, reference_steps(cell, seed, device))


def e4m3_control(cell, seed, device) -> tuple:
    """The control: the reference in the program's place with every
    product's operands rounded through float8 e4m3 in the forward
    (``stack.operands("e4m3")``; the gradient passes the rounding), judged
    against the fp32 reference as the program is."""
    want = reference_steps(cell, seed, device)
    with ref.operands("e4m3"):
        got = reference_steps(cell, seed, device)
    return compare(got, want), {}


def fault_readings(cell, seed, device) -> dict:
    """The readings of the faults a training step can have on one card,
    planted in the reference put in the program's place: half the batch
    left out (the mean over the rest), and the loss altered where it is
    produced (x1.05). A state left unchanged reads 1 by ``compare``'s
    measure of the change and needs no run."""
    want = reference_steps(cell, seed, device)
    return {f: compare(reference_steps(cell, seed, device, fault=f), want)
            for f in ("half_batch", "loss_x1.05")}
