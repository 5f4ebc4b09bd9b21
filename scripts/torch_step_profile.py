#!/usr/bin/env python3
"""Profile of one full-width denoise step of the PyTorch port on one NVIDIA
card, on the bf16 path and on the variant path: the SDXL try-on stack with
seeded random weights at 768x1024, batch 2, CFG 2.0 (chip_smoke.py's
operating point).

Run from the root of a checkout: ``python3 scripts/torch_step_profile.py``
(``--root DIR``: profile the ``idmvton_tpu_torch`` of another checkout,
e.g. an older commit unpacked with ``git archive``, for an A/B in one
call; ``--paths bf16``: the bf16 path only). It needs one CUDA card and
nvcc, and imports nothing of JAX.

For each path it times one ``denoise_step`` (``impl="cuda"``) unprofiled,
the mean of 3 after 2 warm-up steps, then profiles one with
``torch.profiler``: device ms and calls by kernel name, the device's busy
time (the union of its kernel, memcpy and memset intervals) and the idle
share, 1 - busy / unprofiled wall. The variant path quantizes both UNets
for W8A8 in place and sets ``IDMVTON_CROSS_KERNEL=1`` and
``IDMVTON_CONV_PADACC=1``, as chip_smoke's phase 7. Device time is also
summed by kernel group (``GROUPS``: each kernel of the port, cuBLAS
GEMMs, PyTorch's elementwise, copy and reduce kernels). Traces go to
``{tag}{bf16,variant}_step_trace.json`` in ``torch_tiny_step_probe.OUT``;
the last line is one JSON object with every reading. Each path is then
profiled again with the step replayed from its CUDA graph
(``TryonPipeline.step_graph``, as ``stepwise_generate`` and
``jit_generate`` run it on the card): ``{path}_graph`` in the JSON line,
``{tag}{path}_graph_step_trace.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as smoke  # noqa: E402
from torch_tiny_step_probe import OUT, profile_step  # noqa: E402

# (group, substrings of the kernel name), the first match wins
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


def grouped(label):
    """{group: (ms, calls)} of the profiled step's kernels."""
    trace = OUT / f"{label}_step_trace.json"
    out = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        name = next((g for g, keys in GROUPS
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="profile the idmvton_tpu_torch of this checkout")
    ap.add_argument("--paths", default="bf16,variant")
    ap.add_argument("--tag", default="",
                    help="prefix of the traces' names (an A/B's side)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this probe needs a "
                   "card")
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    from idmvton_tpu_torch.models.attention import quantize_unet_linears_int8
    from idmvton_tpu_torch.ops import _build
    from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smoke.log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["IDMVTON_CROSS_KERNEL"] = "0"
    os.environ["IDMVTON_CONV_PADACC"] = "0"
    _build.lib()
    dev = torch.device("cuda", 0)
    res = {"card": smi.stdout.strip(), "root": str(args.root or ROOT)}

    with torch.inference_mode():
        models = TryonModels.init(smoke.SEED, device=dev, dtype=torch.bfloat16)
        pipe = TryonPipeline(models)
        g = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
        inputs = smoke.make_inputs(models, dev, g)
        cond = pipe.staged_encoder()(g, inputs)
        b, h, w, _ = inputs["person"].shape
        ds = models.vae_cfg.downscale
        lat_shape = (b, h // ds, w // ds, models.vae_cfg.latent_channels)
        lat = torch.randn(lat_shape, generator=g, device=dev).bfloat16()
        noise = torch.randn(lat_shape, generator=g, device=dev).bfloat16()
        ts, prev_ts = pipe.scheduler.timesteps_and_prev(smoke.STEPS)
        table = torch.from_numpy(pipe.scheduler.step_table(
            ts, prev_ts)).to(dev)

        def step():
            return pipe.denoise_step(cond, lat, int(ts[0]), int(prev_ts[0]),
                                     guidance_scale=smoke.GUIDANCE,
                                     step_noise=noise, impl="cuda")

        for path in args.paths.split(","):
            if path == "variant":
                quantize_unet_linears_int8(models.unet)
                quantize_unet_linears_int8(models.garm, attn_qkv=False)
                torch.cuda.empty_cache()
                os.environ["IDMVTON_CROSS_KERNEL"] = "1"
                os.environ["IDMVTON_CONV_PADACC"] = "1"
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
            label = args.tag + path
            res[path] = profile_step(step, wall, label=label, top_n=15)
            res[path]["groups"] = grouped(label)
            if not hasattr(pipe, "step_graph"):   # a checkout before the graph
                continue
            # the same step replayed: 2 to capture, 3 timed, 1 profiled
            steps = pipe.step_graph(cond, lat, guidance_scale=smoke.GUIDANCE,
                                    impl="cuda")
            steps.start(table, lat, cond)
            for _ in range(2):
                steps.step(noise)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                steps.step(noise)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
            res[path + "_graph"] = profile_step(
                lambda: steps.step(noise), wall, label=label + "_graph",
                top_n=15)
            res[path + "_graph"]["groups"] = grouped(label + "_graph")
            res[path + "_graph"]["capture_s"] = steps.capture_seconds
            del steps
            torch.cuda.empty_cache()

    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
