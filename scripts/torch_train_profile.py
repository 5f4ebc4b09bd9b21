#!/usr/bin/env python3
"""Where the time and memory of one full-width training step go, on one
NVIDIA card: chip_smoke.py's train phase (the sdxl_tryon TryonNet and the
Resampler as fp32 masters, bf16 compute, the frozen towers of the try-on
stack with random biases and norm affines, batch 1 at 768x1024,
``SchedulerConfig.train()``).

Run from the root of a checkout: ``python3 scripts/torch_train_profile.py``.
It needs one CUDA card and nvcc, and imports nothing of JAX.

With adamw and remat it times (host clock around work that ends in a
synchronize, the mean of 3 after a warm-up): the loss forward alone
(``no_grad``: the frozen towers, GarmentNet and TryonNet once), the forward
and backward (``autograd.grad``, remat's recompute included), the
optimizer update alone and a whole ``train_step``; then profiles one step
with ``torch.profiler`` (device busy time, idle share, device ms by kernel
group: the port's kernels, cuBLAS, cuDNN, PyTorch's elementwise, copy and
reduce kernels). Then the same step with ``adamw8bit`` (its step time and
peak memory) and, last, with remat off (its step time and peak memory, or
the out-of-memory it meets). Peak memory is ``max_memory_allocated`` /
``max_memory_reserved`` from a reset before the timed steps. The trace goes
to ``chiprun_out/train_step_trace.json``; the last line is one JSON object
with every reading.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as smoke  # noqa: E402
from torch_step_profile import GROUPS  # noqa: E402
from torch_tiny_step_probe import OUT, profile_step  # noqa: E402

# the training step's own kernel groups before the serving ones: cuDNN's
# convolution backward, the plain attention's softmax backward
TRAIN_GROUPS = (("cuDNN (conv backward)", ("cudnn", "dgrad", "wgrad",
                                           "xmma", "conv2d")),
                ("softmax backward", ("softmax",))) + GROUPS


def grouped(label):
    """{group: (ms, calls)} of the profiled step's kernels."""
    trace = OUT / f"{label}_step_trace.json"
    out = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        name = next((g for g, keys in TRAIN_GROUPS
                     if any(k in e["name"] for k in keys)), "other")
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + e["dur"] / 1e3, n + 1)
    total = sum(ms for ms, _ in out.values())
    for name, (ms, n) in sorted(out.items(), key=lambda kv: -kv[1][0]):
        smoke.log(f"  {label} {name}: {ms:.3f} ms ({100 * ms / total:.1f}%, "
                  f"{n} kernels)")
    return out


def timed(fn, reps=3):
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


def peaks():
    import torch
    return {"peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}


def main():
    import torch
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this probe needs a "
                   "card")
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.train_step import (
        flat_params, init_train_state, make_optimizer, make_train_step,
        tryon_loss,
    )
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    smoke.log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    dev = torch.device("cuda", 0)
    res = {"card": card}

    models = TryonModels.init(smoke.SEED, device=dev, dtype=torch.bfloat16)
    for i, module in enumerate(models.components().values()):
        smoke.random_affine_(module, smoke.SEED + 10 + i)
    sched = DDPMScheduler(SchedulerConfig.train())
    batch = smoke.train_batch(models, dev, torch.Generator(
        device=dev).manual_seed(smoke.SEED + 40))

    def run(optimizer, remat):
        tx = make_optimizer(optimizer=optimizer)
        state = init_train_state(models, tx)
        step = make_train_step(models, sched, tx, impl="cuda", remat=remat,
                               vae_sample=False)
        holder = {"state": state}

        def one():
            holder["state"], _ = step(holder["state"], batch)

        one()                            # warm: plans, cuBLAS workspaces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"step_ms": timed(one)}
        out.update(peaks())
        return out, holder, tx

    # adamw, remat: the phases, then a profiled step
    out, holder, tx = run("adamw", True)
    state = holder["state"]
    params = flat_params(state.trainable)

    def forward():
        with torch.no_grad():
            tryon_loss(state.trainable, models, sched, batch, impl="cuda",
                       vae_sample=False)

    def forward_backward():
        loss = tryon_loss(state.trainable, models, sched, batch,
                          impl="cuda", vae_sample=False)
        return dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    out["forward_ms"] = timed(forward)
    out["forward_backward_ms"] = timed(forward_backward)
    updates = []

    def update():
        grads = forward_backward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.update_(grads, state.opt_state, params)
        torch.cuda.synchronize()
        updates.append((time.perf_counter() - t0) * 1e3)

    for _ in range(3):
        update()
    out["optimizer_ms"] = sum(updates) / len(updates)
    step = make_train_step(models, sched, tx, impl="cuda", vae_sample=False)
    prof = profile_step(lambda: step(state, batch), out["step_ms"],
                        label="train", top_n=20)
    prof["groups"] = grouped("train")
    out["profile"] = prof
    smoke.log(f"adamw, remat: step {out['step_ms']:.1f} ms (forward "
              f"{out['forward_ms']:.1f}, forward + backward "
              f"{out['forward_backward_ms']:.1f}, optimizer "
              f"{out['optimizer_ms']:.1f}); peak allocated "
              f"{out['peak_allocated_gib']:.2f} GiB, reserved "
              f"{out['peak_reserved_gib']:.2f} GiB; {card}")
    res["adamw"] = out
    del holder, state, params, step, tx
    gc.collect()
    torch.cuda.empty_cache()

    out, holder, _ = run("adamw8bit", True)
    smoke.log(f"adamw8bit, remat: step {out['step_ms']:.1f} ms; peak "
              f"allocated {out['peak_allocated_gib']:.2f} GiB, reserved "
              f"{out['peak_reserved_gib']:.2f} GiB")
    res["adamw8bit"] = out
    del holder
    gc.collect()
    torch.cuda.empty_cache()

    try:
        out, holder, _ = run("adamw", False)
        del holder
        smoke.log(f"adamw, no remat: step {out['step_ms']:.1f} ms; peak "
                  f"allocated {out['peak_allocated_gib']:.2f} GiB, reserved "
                  f"{out['peak_reserved_gib']:.2f} GiB")
    except torch.cuda.OutOfMemoryError as e:
        out = {"out_of_memory": str(e).splitlines()[0]}
        out.update(peaks())
        smoke.log(f"adamw, no remat: out of memory ({out})")
    res["adamw_no_remat"] = out
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
