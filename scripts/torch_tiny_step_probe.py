#!/usr/bin/env python3
"""Fault probe and profile of the PyTorch port's tiny try-on step on one
NVIDIA card: the inference CLI's ``--tiny`` mode (``UNetConfig.tiny``) at
768x1024, batch 2, 30 steps, the operating point of
``tests/test_torch_cuda_full.py``'s tiny CLI test (``tests/torch_card.py``).

Run from the root of a checkout: ``python3 scripts/torch_tiny_step_probe.py``.
It needs one CUDA card and nvcc, and imports nothing of JAX.

The tiny models get random biases and norm affines from the seed
(``parallel.onecard.random_affine_``), as that test gives them.

1. Runs the tiny CLI batch (``cli.infer.run``) three times, wall time each.
2. Times one tiny denoise step (``impl="cuda"``) unprofiled, the mean of 5
   after 2 warm-up steps, then profiles one with ``torch.profiler``: the
   device's busy time is the union of its kernel, memcpy and memset
   intervals in the trace, and the idle share is 1 - busy / unprofiled
   wall. The trace goes to ``chiprun_out/tiny_step_trace.json``.
3. Reads the tiny step's cuda-vs-torch guided noise prediction
   (``torch_card.step_readings``) clean and with a fault planted where
   ``flash_attention`` launches kernel #9 (more than 256 keys): its output
   x1.02 and x1.05, and the garment half of the concatenated KV dropped;
   and where the fused LayerNorm sites launch ``ln_linear`` (kernel #1):
   the bias dropped, and the LayerNorm's shift (beta) dropped -- faults the
   init's zero biases and shifts would hide. Every reading draws from the
   same seed, so only the fault differs.
4. Runs the CLI batch twice more.

Prints one JSON object with every reading as its last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as smoke  # noqa: E402
import torch_card as card  # noqa: E402

OUT = ROOT / "chiprun_out"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# kernel groups of a profiled step, by a substring of the kernel's name;
# the first group that matches takes the kernel, and the rest is "other"
GROUPS = (("ln_linear_i8 GEGLU", ("ln_linear_i8_kernel<true",
                                  "ln_linear_i8_kernel<128, true",
                                  "ln_linear_i8_kernel<256, true")),
          ("ln_linear_i8", ("ln_linear_i8_kernel",)),
          ("ln_linear_i8 quantization pre-pass", ("ln_quant_kernel",)),
          ("ln_linear GEGLU", ("ln_linear_kernel<true",
                               "ln_linear_kernel<128, true",
                               "ln_linear_kernel<256, true")),
          ("ln_linear", ("ln_linear_kernel",)),
          ("ln_linear statistics pre-pass", ("ln_stats_kernel",)),
          ("flash_attention_gemm", ("flash_gemm_kernel",)),
          ("cross_attention_small_kv", ("cross_small_kernel",)),
          ("conv3x3 / conv3x3_padacc (wgmma)", ("idm_conv::conv3x3_kernel",)),
          ("gn_spatial_stats", ("gn_",)),
          ("fused_layer_norm", ("layer_norm_kernel",)),
          ("cuBLAS GEMMs (aten::mm, bmm)", ("nvjet", "gemm")),
          ("copies (casts, cat, pad)", ("copy", "CatArray", "pad")),
          ("elementwise", ("elementwise",)),
          ("reductions", ("reduce",)))


def busy_us(events):
    """The union of the device intervals' lengths, in microseconds."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def profile_step(step, wall_ms, label="tiny", top_n=8):
    """Profiles one call of ``step``; the trace goes to
    ``chiprun_out/{label}_step_trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    trace = OUT / f"{label}_step_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in events]
    busy = busy_us(intervals) / 1e3
    span = (max(b for _, b in intervals) - min(a for a, _ in intervals)) / 1e3
    by_name = {}
    for e in events:
        if e["cat"] == "kernel":
            name = e["name"][:90]
            ms, n = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    res = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms,
           "profiled_device_span_ms": span,
           "kernels": sum(1 for e in events if e["cat"] == "kernel"),
           "top_kernels": [{"name": k, "ms": ms, "calls": n}
                           for k, (ms, n) in top]}
    smoke.log(f"{label} step: wall {wall_ms:.3f} ms unprofiled, device busy "
              f"{busy:.3f} ms ({res['kernels']} kernels), idle share "
              f"{res['idle_share']:.3f}; profiled device span {span:.3f} ms")
    for k, (ms, n) in top:
        smoke.log(f"  {ms:8.3f} ms {n:5d}x {k}")
    return res


def grouped(label, groups=GROUPS):
    """{group: (ms, calls)} of the kernels in ``profile_step``'s trace of
    ``label``."""
    trace = OUT / f"{label}_step_trace.json"
    out = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        name = next((g for g, keys in groups
                     if any(k in e["name"] for k in keys)), "other")
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + e["dur"] / 1e3, n + 1)
    total = sum(ms for ms, _ in out.values())
    for name, (ms, n) in sorted(out.items(), key=lambda kv: -kv[1][0]):
        smoke.log(f"  {label} {name}: {ms:.3f} ms ({100 * ms / total:.1f}%, "
                  f"{n} kernels)")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this probe needs a "
                   "card")
    from idmvton_tpu_torch.cli import infer
    from idmvton_tpu_torch.data.datasets import BatchLoader
    from idmvton_tpu_torch.models import attention as site
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.ops import cuda_attention as A
    from idmvton_tpu_torch.parallel.onecard import random_affine_

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smoke.log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    dev = torch.device("cuda", 0)
    res = {"card": smi.stdout.strip(), "batch_s": []}

    with torch.inference_mode():
        args = infer.parse_args(["--data_dir", "-", "--tiny",
                                 "--device", "cuda"])
        tiny = infer.load_models(args, torch.bfloat16)
        for i, module in enumerate(tiny.components().values()):
            random_affine_(module, card.SEED + 30 + i)
        pipe, tok1, tok2, gen = infer.build(args, tiny)
        loader = BatchLoader(card.synthetic_batch(card.BATCH, card.SEED + 2),
                             args.test_batch_size)

        def batch():
            t0 = time.perf_counter()
            out = list(infer.run(args, pipe, tiny, loader, tok1, tok2, gen))
            secs = time.perf_counter() - t0
            if len(out) != 1 or out[0][1].shape != (card.BATCH, card.HEIGHT,
                                                    card.WIDTH, 3):
                smoke.fail("tiny CLI batch: unexpected output")
            res["batch_s"].append(secs)
            smoke.log(f"tiny CLI batch: {secs:.3f} s")

        for _ in range(3):
            batch()

        g = torch.Generator(device=dev).manual_seed(card.SEED + 1)
        inputs = card.make_inputs(tiny, dev, g)
        cond = pipe.staged_encoder()(g, inputs)
        b, h, w, _ = inputs["person"].shape
        ds = tiny.vae_cfg.downscale
        lat_shape = (b, h // ds, w // ds, tiny.vae_cfg.latent_channels)
        lat = torch.randn(lat_shape, generator=g, device=dev).bfloat16()
        noise = torch.randn(lat_shape, generator=g, device=dev).bfloat16()
        ts, prev_ts = pipe.scheduler.timesteps_and_prev(card.STEPS)

        def step():
            return pipe.denoise_step(cond, lat, int(ts[0]), int(prev_ts[0]),
                                     guidance_scale=card.GUIDANCE,
                                     step_noise=noise, impl="cuda")

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        res["step"] = profile_step(step, (time.perf_counter() - t0) / 5 * 1e3)

        fa, fa_cat = A.flash_attention, A.flash_attention_concat_kv
        calls = [0]

        def scaled(f):
            def fault(q, k, v, *, scale=None):
                out = fa(q, k, v, scale=scale)
                if k.shape[1] <= A.XLA_KV_CUTOFF:   # the plain routing
                    return out
                calls[0] += 1
                return out * f
            # the wrapper counts its launches under its module name
            fault.launches = 0
            return fault

        def own_kv_only(q, k, v, k_ref, v_ref, *, scale=None):
            calls[0] += 1
            return fa(q, k, v, scale=scale)

        lnl = site.ln_linear

        def no_bias(x, gamma, beta, w, b=None, **kw):
            calls[0] += b is not None
            return lnl(x, gamma, beta, w, None, **kw)

        def no_shift(x, gamma, beta, w, b=None, **kw):
            calls[0] += 1
            return lnl(x, gamma, torch.zeros_like(beta), w, b, **kw)

        faults = {"clean": {},
                  "flash_attention x1.02": {"flash_attention": scaled(1.02)},
                  "flash_attention x1.05": {"flash_attention": scaled(1.05)},
                  "garment KV dropped": {
                      "flash_attention_concat_kv": own_kv_only},
                  "ln_linear bias dropped": {"ln_linear": no_bias},
                  "ln_linear beta dropped": {"ln_linear": no_shift}}
        res["probe"] = {}
        for label, patch in faults.items():
            calls[0] = 0
            for name, fn in patch.items():
                setattr(site if name == "ln_linear" else A, name, fn)
            try:
                r = card.step_readings(
                    pipe, inputs,
                    torch.Generator(device=dev).manual_seed(card.SEED + 3),
                    f"tiny [{label}]")
            finally:
                A.flash_attention, A.flash_attention_concat_kv = fa, fa_cat
                site.ln_linear = lnl
            res["probe"][label] = {"faulty_calls": calls[0],
                                   "noise_pred": r["noise_pred"],
                                   "latent": r["latent"]}
            smoke.log(f"tiny [{label}] ({calls[0]} faulty calls): noise_pred "
                      f"max rel {r['noise_pred'][0]:.3e} mean rel "
                      f"{r['noise_pred'][1]:.3e}; latent max rel "
                      f"{r['latent'][0]:.3e} (bounds "
                      f"{card.TINY_STEP_TOLS['noise_pred']})")

        for _ in range(2):
            batch()

    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
