#!/usr/bin/env python3
"""Bring-up smoke of the PyTorch port (idmvton_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch built for CUDA;
it imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   set the TF32 flags off (fp32 products in full fp32 on both sides);
2. build the kernels from ``idmvton_tpu_torch/ops/csrc`` with nvcc;
3. hold each of the nine kernel entry points against its plain PyTorch
   version at the serving path's shapes (bf16), and time both;
4. one full-width denoise step (GarmentNet, TryonNet, CFG, DDPM step) with
   ``impl="cuda"`` against ``impl="torch"`` on the same inputs;
5. serve 2 requests through ``TryonPipeline.stepwise_generate`` at
   768x1024, batch 2, 30 steps, CFG 2.0, garment_cache="every_step", on
   the full SDXL try-on stack with seeded random weights (the bf16 path);
6. the opt-in variants of the same path: quantize both UNets for W8A8
   serving (``IDMVTON_GEMM_INT8=2`` in the JAX bench: TryonNet's to_qkv and
   ff.proj_in, GarmentNet's ff.proj_in), set ``IDMVTON_CROSS_KERNEL=1`` and
   ``IDMVTON_CONV_PADACC=1``, hold one full-width step with ``impl="cuda"``
   against ``impl="torch"``, and serve 2 more requests (the variant path);
   the launch counters, zeroed before each serving phase and read after
   it, show that each path launched every kernel it runs (the variant
   path: the three variant kernels and the five it shares) and no other;
7. print a JSON line with each kernel's result, then the device line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HEIGHT, WIDTH, BATCH, STEPS, GUIDANCE = 1024, 768, 2, 30, 2.0
BF16_TOL = 2e-2   # max |kernel - plain| / max |plain|: a few bf16 ulps
# GroupNorm sums: fp32 over up to 786432 rows in another order (pass 2 adds
# up to 3072 block partials in sequence): max |err| / max |sum of squares|
GN_TOL = 5e-5
# One full denoise step, impl="cuda" against impl="torch", on both paths:
# (max rel, mean rel) bounds, max rel = max |diff| / max |torch| and mean
# rel = mean |diff| / mean |torch|, on the guided noise prediction (both
# UNets and CFG, before the scheduler step) and on the stepped latent. Near
# t = T the noise prediction enters the latent with a weight of about 1%, so
# the latent alone would hide a UNet fault. The two impls round at different
# places (~140 kernel sites) and the differences random-walk; on the variant
# path W8A8 (kernels) and weight-only int8 (plain) also differ in math, yet
# read the same: noise prediction max rel 3.2e-2 to 4.0e-2, mean rel
# 1.67e-2 to 1.75e-2 on an H100. The max is set by a few outliers and hardly
# moves under a fault; the mean bound catches a 5% output error of the W8A8
# kernel at every site (2.77e-2) and a lost IP branch (0.23).
STEP_TOLS = {"noise_pred": (8e-2, 2.5e-2), "latent": (5e-2, None)}
# the kernels each serving path must launch, and no others
PATH_KERNELS = {
    "bf16": ("ln_linear", "fused_layer_norm", "gn_spatial_stats", "conv3x3",
             "conv3x3_hblock", "flash_attention_gemm"),
    "variant": ("ln_linear", "fused_layer_norm", "gn_spatial_stats",
                "conv3x3_hblock", "flash_attention_gemm", "ln_linear_i8",
                "cross_attention_small_kv", "conv3x3_padacc"),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 10) -> float:
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(got, want):
    """(max |got - want|, that over max |want|); inf when got is not
    finite."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-6)


def kernel_cases(dev):
    """(name, source, replaces, [(label, kernel_fn, plain_fn, tol_kind,
    extra)]) at the shapes the serving path gives each kernel; ``extra``
    may name another function to hold the kernel against without a gate
    (``"vs"``) or to time beside it (``"time"``)."""
    import torch
    from idmvton_tpu_torch.ops import cuda_attention as A
    from idmvton_tpu_torch.ops import cuda_conv as CV
    from idmvton_tpu_torch.ops import cuda_norm as N
    from idmvton_tpu_torch.ops.quant import quantize_kernel_int8

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def ln_case(m_shape, c, n, geglu, bias):
        x = rn(*m_shape, c)
        gam, bet = rn(c, dtype=torch.float32) * 0.1 + 1, rn(c, dtype=torch.float32) * 0.1
        w = rn(c, n * (2 if geglu else 1), scale=c ** -0.5)
        b = rn(w.shape[1], dtype=torch.float32) * 0.1 if bias else None
        return (f"x{tuple(m_shape) + (c,)} w{tuple(w.shape)}"
                f"{' geglu' if geglu else ''}",
                lambda: N.ln_linear(x, gam, bet, w, b, geglu=geglu),
                lambda: N.ln_linear_torch(x, gam, bet, w, b, geglu=geglu),
                "bf16", {})

    def ln_i8_case(m_shape, c, n, geglu, bias):
        x = rn(*m_shape, c)
        gam, bet = rn(c, dtype=torch.float32) * 0.1 + 1, rn(c, dtype=torch.float32) * 0.1
        w = rn(c, n * (2 if geglu else 1), scale=c ** -0.5)
        w_i8, w_scale = quantize_kernel_int8(w)
        b = rn(w.shape[1], dtype=torch.float32) * 0.1 if bias else None
        return (f"x{tuple(m_shape) + (c,)} w_i8{tuple(w.shape)}"
                f"{' geglu' if geglu else ''}",
                lambda: N.ln_linear_i8(x, gam, bet, w_i8, w_scale, b,
                                       geglu=geglu),
                lambda: N.ln_linear_i8_torch(x, gam, bet, w_i8, w_scale, b,
                                             geglu=geglu),
                "bf16",
                {"vs": ("bf16 ln_linear_torch",
                        lambda: N.ln_linear_torch(x, gam, bet, w, b,
                                                  geglu=geglu))})

    def cross_case(b, n, heads, ip):
        hd = heads * 64
        q, kv = rn(b, n, hd), rn(b, 77, 2 * hd)
        kv_ip = rn(b, 16, 2 * hd) if ip else None
        return (f"q{(b, n, hd)} heads {heads} kv{tuple(kv.shape)}"
                f"{f' kv_ip{tuple(kv_ip.shape)}' if ip else ''}",
                lambda: A.cross_attention_small_kv(q, kv, kv_ip, heads=heads),
                lambda: A.cross_attention_small_kv_torch(q, kv, kv_ip,
                                                         heads=heads),
                "bf16", {})

    def lnorm_case(shape):
        x = rn(*shape)
        s, b = rn(shape[-1], dtype=torch.float32), rn(shape[-1], dtype=torch.float32)
        return (f"x{shape}", lambda: N.fused_layer_norm(x, s, b),
                lambda: N.layer_norm_torch(x, s, b), "bf16", {})

    def gn_case(shape):
        x = rn(*shape) + 0.2
        return (f"x{shape}", lambda: N.gn_spatial_stats(x),
                lambda: N.gn_spatial_stats_torch(x), "gn", {})

    def conv_case(fn, b, h, w, cin, cout):
        x = rn(b, h, w, cin)
        k = rn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        bias = rn(cout) * 0.1
        extra = ({"time": ("conv3x3", lambda: CV.conv3x3(x, k, bias))}
                 if fn is CV.conv3x3_padacc else {})
        return (f"x{(b, h, w, cin)} -> {cout}", lambda: fn(x, k, bias),
                lambda: CV.conv3x3_torch(x, k, bias), "bf16", extra)

    def flash_case(b, n, heads, garment, uncond):
        hd = heads * 64
        qkv = rn(b, n, 3 * hd)
        kv = rn(b - uncond, n, 2 * hd) if garment else None
        return (f"qkv{(b, n, 3 * hd)} heads {heads}"
                f"{f' garment M={n} uncond_rows={uncond}' if garment else ''}",
                lambda: A.flash_attention_gemm(qkv, kv, heads=heads,
                                               uncond_rows=uncond),
                lambda: A.flash_attention_gemm_torch(qkv, kv, heads=heads,
                                                     uncond_rows=uncond),
                "bf16", {})

    csrc = "idmvton_tpu_torch/ops/csrc/"
    return [
        ("ln_linear", csrc + "ln_linear.cu",
         "idmvton_tpu/ops/pallas_norm.py:131", [
             ln_case((4, 3072), 640, 1920, False, False),
             ln_case((4, 768), 1280, 1280, False, False),
             ln_case((4, 3072), 640, 2560, True, True),
             ln_case((4, 768), 1280, 5120, True, True)]),
        ("fused_layer_norm", csrc + "ln_linear.cu",
         "idmvton_tpu/ops/pallas_norm.py:26", [
             lnorm_case((2, 3072, 640)), lnorm_case((2, 768, 1280))]),
        ("gn_spatial_stats", csrc + "gn_stats.cu",
         "idmvton_tpu/ops/pallas_norm.py:575", [
             gn_case((4, 128, 96, 320)), gn_case((4, 32, 24, 2560)),
             gn_case((6, 1024, 768, 128))]),
        ("conv3x3", csrc + "conv3x3.cu",
         "idmvton_tpu/ops/pallas_conv.py:34", [
             conv_case(CV.conv3x3, 4, 128, 96, 320, 320),
             conv_case(CV.conv3x3, 4, 64, 48, 640, 640),
             conv_case(CV.conv3x3, 4, 32, 24, 1280, 1280),
             conv_case(CV.conv3x3, 4, 128, 96, 960, 320)]),
        ("conv3x3_hblock", csrc + "conv3x3.cu",
         "idmvton_tpu/ops/pallas_conv.py:187", [
             conv_case(CV.conv3x3_hblock, 6, 1024, 768, 128, 128),
             conv_case(CV.conv3x3_hblock, 2, 512, 384, 512, 256)]),
        ("flash_attention_gemm", csrc + "flash_attention_gemm.cu",
         "idmvton_tpu/ops/pallas_attention.py:356", [
             flash_case(4, 3072, 10, True, 2),
             flash_case(4, 768, 20, True, 2),
             flash_case(2, 3072, 10, False, 0)]),
        ("ln_linear_i8", csrc + "ln_linear_i8.cu",
         "idmvton_tpu/ops/pallas_norm.py:380", [
             ln_i8_case((4, 3072), 640, 1920, False, False),
             ln_i8_case((4, 768), 1280, 3840, False, False),
             ln_i8_case((4, 3072), 640, 2560, True, True),
             ln_i8_case((4, 768), 1280, 5120, True, True),
             ln_i8_case((2, 3072), 640, 2560, True, True),
             ln_i8_case((2, 768), 1280, 5120, True, True)]),
        ("cross_attention_small_kv", csrc + "cross_attention_small_kv.cu",
         "idmvton_tpu/ops/pallas_attention.py:847", [
             cross_case(4, 3072, 10, True), cross_case(4, 768, 20, True),
             cross_case(2, 3072, 10, False)]),
        ("conv3x3_padacc", csrc + "conv3x3_padacc.cu",
         "idmvton_tpu/ops/pallas_conv.py:67", [
             conv_case(CV.conv3x3_padacc, 4, 128, 96, 320, 320),
             conv_case(CV.conv3x3_padacc, 4, 64, 48, 640, 640),
             conv_case(CV.conv3x3_padacc, 4, 32, 24, 1280, 1280),
             conv_case(CV.conv3x3_padacc, 4, 128, 96, 960, 320),
             conv_case(CV.conv3x3_padacc, 6, 128, 96, 512, 512)]),
    ]


def check_kernels(dev):
    import torch
    results = {}
    for name, source, replaces, cases in kernel_cases(dev):
        worst_abs, worst_rel, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
        extra_ms = {}
        for label, kern, plain, kind, extra in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            aside = ""
            if "vs" in extra:   # on record, not a gate
                other, fn = extra["vs"]
                _, rel = errors(got, fn())
                aside = f", rel err vs {other} {rel:.3e} (no gate)"
            if kind == "gn":   # (sum, sum of squares), scaled by the latter
                abs_err = max(errors(got[i], want[i])[0] for i in (0, 1))
                err = abs_err / float(want[1].abs().max())
                tol = GN_TOL
            else:
                (abs_err, err), tol = errors(got, want), BF16_TOL
            del got, want
            # in turns: plain, kernel, kernel, plain
            p1 = cuda_time_ms(plain)
            k1 = cuda_time_ms(kern)
            k2 = cuda_time_ms(kern)
            p2 = cuda_time_ms(plain)
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            if "time" in extra:
                other, fn = extra["time"]
                o_ms = (cuda_time_ms(fn) + cuda_time_ms(fn)) / 2
                extra_ms[other] = extra_ms.get(other, 0.0) + o_ms
                aside += f", {other} {o_ms:.4f} ms"
            log(f"kernel {name} {label}: max abs err {abs_err:.4g}, rel "
                f"{err:.3e} (tol {tol:g}), kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms{aside}")
            if not err <= tol:
                fail(f"{name} {label}: error {err} above {tol}")
            worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, err)
            ms += k_ms
            plain_ms += p_ms
            torch.cuda.empty_cache()
        results[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "max_abs_err": worst_abs,
                         "max_rel_err": worst_rel, "tol_rel": tol,
                         "ms": ms, "plain_ms": plain_ms,
                         "shapes": len(cases)}
        results[name].update({f"{k}_ms": v for k, v in extra_ms.items()})
    return results


def make_inputs(models, dev, gen):
    import torch
    dt = torch.bfloat16

    def img():
        return (torch.rand(BATCH, HEIGHT, WIDTH, 3, generator=gen,
                           device=dev) * 2 - 1).to(dt)

    def ids():
        return torch.randint(0, models.clip_l_cfg.vocab_size, (BATCH, 77),
                             generator=gen, device=dev)

    mask = torch.zeros(BATCH, HEIGHT, WIDTH, 1, device=dev, dtype=dt)
    mask[:, HEIGHT // 5:4 * HEIGHT // 5, WIDTH // 6:5 * WIDTH // 6] = 1
    isz = models.vision_cfg.image_size
    return dict(person=img(), pose=img(), cloth=img(), mask=mask,
                prompt_ids_l=ids(), prompt_ids_g=ids(), neg_ids_l=ids(),
                neg_ids_g=ids(), cloth_ids_l=ids(), cloth_ids_g=ids(),
                ip_pixels=(torch.rand(BATCH, isz, isz, 3, generator=gen,
                                      device=dev) * 2 - 1).to(dt))


def check_step(pipe, inputs, gen, path):
    """One full-width denoise step with ``impl="cuda"`` against
    ``impl="torch"`` on the same inputs; fails where the guided noise
    prediction or the stepped latent differs by more than its bounds in
    ``STEP_TOLS``."""
    import torch
    from idmvton_tpu_torch.diffusion.scheduler import classifier_free_guidance
    dev = inputs["person"].device
    cond = pipe.staged_encoder()(gen, inputs)
    lat_shape = (BATCH, HEIGHT // 8, WIDTH // 8, 4)
    lat = torch.randn(lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    noise = torch.randn(lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    ts, prev_ts = pipe.scheduler.timesteps_and_prev(STEPS)
    out = {"noise_pred": {}, "latent": {}}
    # the TryonNet's output (uncond | cond halves), read as the step runs
    hook = pipe.models.unet.register_forward_hook(
        lambda mod, args, res: out.update(unet=res[0]))
    try:
        for impl in ("cuda", "torch"):
            t0 = time.perf_counter()
            out["latent"][impl] = pipe.denoise_step(
                cond, lat, int(ts[0]), int(prev_ts[0]),
                guidance_scale=GUIDANCE, step_noise=noise, impl=impl)
            torch.cuda.synchronize()
            out["noise_pred"][impl] = classifier_free_guidance(
                *out.pop("unet").chunk(2), GUIDANCE)
            log(f"{path} denoise step impl={impl}: "
                f"{time.perf_counter() - t0:.3f} s")
    finally:
        hook.remove()
    for what, (max_tol, mean_tol) in STEP_TOLS.items():
        got, want = out[what]["cuda"].float(), out[what]["torch"].float()
        _, err = errors(got, want)
        mean_rel = float((got - want).abs().mean() / want.abs().mean())
        log(f"{path} denoise step {what} cuda vs torch: max rel err "
            f"{err:.3e} (tol {max_tol:g}), mean rel err {mean_rel:.3e} "
            f"(tol {mean_tol if mean_tol is not None else 'none'})")
        if not err <= max_tol or (mean_tol is not None
                                  and not mean_rel <= mean_tol):
            fail(f"{path} full-width denoise step: {what} cuda vs torch "
                 f"max rel error {err}, mean rel error {mean_rel}")
    del cond, out
    torch.cuda.empty_cache()


def serve_requests(pipe, inputs, gen, wrappers, path):
    """Serve 2 requests through ``stepwise_generate``; returns the launch
    count of each kernel in that run (counts zeroed just before, read just
    after). Fails unless the run launched every kernel of
    ``PATH_KERNELS[path]`` and no other."""
    import torch
    serve = pipe.stepwise_generate(num_steps=STEPS, guidance_scale=GUIDANCE,
                                   garment_cache="every_step")
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for req in range(2):
        phases = {}
        t0 = time.perf_counter()
        images = serve(gen, phase_seconds=phases, **inputs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if tuple(images.shape) != (BATCH, HEIGHT, WIDTH, 3):
            fail(f"{path} request {req}: images {tuple(images.shape)}")
        if not bool(torch.isfinite(images).all()):
            fail(f"{path} request {req}: non-finite images")
        log(f"{path} request {req}: {secs:.3f} s ("
            + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
            + f"); images {tuple(images.shape)} finite, range "
            f"[{float(images.min()):.3f}, {float(images.max()):.3f}], "
            f"std {float(images.float().std()):.4f}")
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"{path} peak memory during serving: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{path} launches: {counts}")
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    if missing:
        fail(f"{path} path: kernels never launched: {missing}")
    stray = [k for k, n in counts.items()
             if n and k not in PATH_KERNELS[path]]
    if stray:
        fail(f"{path} path: kernels of another path launched: {stray}")
    return counts


def main():
    if not (ROOT / "idmvton_tpu_torch" / "ops" / "csrc").is_dir():
        fail("idmvton_tpu_torch/ not found beside chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")

    # -- phase 1: the card ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the bf16 path runs with the variant switches off, whatever the caller's
    # environment holds; the variant phase turns them on
    os.environ["IDMVTON_CROSS_KERNEL"] = "0"
    os.environ["IDMVTON_CONV_PADACC"] = "0"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- phase 2: build ------------------------------------------------------
    from idmvton_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    from idmvton_tpu_torch.ops import cuda_attention, cuda_conv, cuda_norm
    wrappers = {
        "ln_linear": cuda_norm.ln_linear,
        "fused_layer_norm": cuda_norm.fused_layer_norm,
        "gn_spatial_stats": cuda_norm.gn_spatial_stats,
        "conv3x3": cuda_conv.conv3x3,
        "conv3x3_hblock": cuda_conv.conv3x3_hblock,
        "flash_attention_gemm": cuda_attention.flash_attention_gemm,
        "ln_linear_i8": cuda_norm.ln_linear_i8,
        "cross_attention_small_kv": cuda_attention.cross_attention_small_kv,
        "conv3x3_padacc": cuda_conv.conv3x3_padacc,
    }

    with torch.inference_mode():
        # -- phase 3: each kernel against its plain version ------------------
        results = check_kernels(dev)

        # -- the full-width stack --------------------------------------------
        from idmvton_tpu_torch.pipeline.tryon import TryonModels, TryonPipeline
        t0 = time.perf_counter()
        models = TryonModels.init(SEED, device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for m in models.components().values()
                       for p in m.parameters())
        log(f"models: {n_params / 1e9:.3f} B params on {dev} in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        pipe = TryonPipeline(models)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        inputs = make_inputs(models, dev, gen)

        # -- phase 4: one denoise step, kernels vs plain ---------------------
        check_step(pipe, inputs, gen, "bf16")

        # -- phase 5: serve 2 requests through the bf16 path -----------------
        counts = {"bf16": serve_requests(pipe, inputs, gen, wrappers, "bf16")}

        # -- phase 6: the opt-in variants of the same path -------------------
        from idmvton_tpu_torch.models.attention import (
            quantize_unet_linears_int8,
        )
        t0 = time.perf_counter()
        quantize_unet_linears_int8(models.unet)
        quantize_unet_linears_int8(models.garm, attn_qkv=False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"variant: W8A8 quantization (TryonNet to_qkv + ff.proj_in, "
            f"GarmentNet ff.proj_in) in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        os.environ["IDMVTON_CROSS_KERNEL"] = "1"
        os.environ["IDMVTON_CONV_PADACC"] = "1"
        check_step(pipe, inputs, gen, "variant")
        counts["variant"] = serve_requests(pipe, inputs, gen, wrappers,
                                           "variant")

    kernels = []
    for name in wrappers:
        by_path = {path: c[name] for path, c in counts.items()}
        kernels.append(dict(results[name], launches=sum(by_path.values()),
                            launches_by_path=by_path))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
