"""What the card tests (``test_torch_cuda.py``, ``test_torch_cuda_full.py``),
``chip_smoke.py`` and the ``scripts/torch_*`` probes share: the full-width
operating point, the step gates' bounds, the request inputs, the step
readings, a synthetic batch, and the launches each path recorded.

This module imports only numpy, torch and the port (never JAX, pytest or a
test module), so ``chip_smoke.py`` and the probes import it on the card's
host, which has no JAX.
"""

from __future__ import annotations

import time

SEED = 0
HEIGHT, WIDTH, BATCH, STEPS, GUIDANCE = 1024, 768, 2, 30, 2.0

# One full denoise step, impl="cuda" against impl="torch", on both paths:
# (max rel, mean rel) bounds, max rel = max |diff| / max |torch| and mean
# rel = mean |diff| / mean |torch|, on the guided noise prediction (both
# UNets and CFG, before the scheduler step) and on the stepped latent. Near
# t = T the noise prediction enters the latent with a weight of about 1%, so
# the latent alone would hide a UNet fault. The two impls round at different
# places (~140 kernel sites) and the differences random-walk; on the variant
# path W8A8 (kernels) and weight-only int8 (plain) also differ in math, yet
# read the same: noise prediction max rel 3.2e-2 to 4.0e-2, mean rel
# 1.67e-2 to 1.75e-2 on an H100 on the init's parameters, max rel 3.2e-2 to
# 3.5e-2, mean rel 1.85e-2 to 1.96e-2 with random biases and norm affines.
# The max is set by a few outliers and hardly moves under a
# fault; the mean bound caught a 5% output error of the W8A8 kernel at every
# site (2.77e-2) and a lost IP branch (0.23) on the init's parameters.
STEP_TOLS = {"noise_pred": (8e-2, 2.5e-2), "latent": (5e-2, None)}
# The tiny step (UNetConfig.tiny at 768x1024), impl="cuda" against "torch",
# with random biases and norm affines reads mean rel 2.97e-2 to
# 3.00e-2 and max rel 3.3e-2 to 4.4e-2 on the noise prediction (latent
# ~7e-3) on an H100 (the init's zero biases and unit norms read mean rel
# 2.1e-2 to 2.3e-2). scripts/torch_tiny_step_probe.py planted faults under
# the same affines: the ln_linear bias dropped at its 24 sites read mean
# rel 6.95e-2 (max 8.3e-2), the LayerNorm shift dropped at its 60 sites
# 8.64e-2 (8.6e-2), the garment KV dropped 0.417 (0.36); the
# flash_attention output x1.05 3.20e-2 and x1.02 3.03e-2. The bounds sit at
# 1.33x the clean mean and 1.36x the largest clean max: they catch the
# bias, shift and KV faults and no longer a 5% output error at kernel #9,
# which reads within 8% of a clean run.
TINY_STEP_TOLS = {"noise_pred": (6e-2, 4e-2), "latent": (5e-2, None)}

# {path: {kernel: launches}}: what one run of each path launched, its
# counters zeroed just before it, as the card tests read it
# (``record``); ``chip_smoke.py`` prints it in its kernels line
LAUNCHES: dict[str, dict[str, int]] = {}


def record(path: str, counts: dict) -> dict:
    """Keep one run's launch counts under ``path``; returns them."""
    LAUNCHES[path] = dict(counts)
    return counts


def counted() -> dict:
    """Every counted kernel wrapper by name: the hand kernels
    (``ops.dispatch.launch_counters``) and adamw8bit's norm and update."""
    from idmvton_tpu_torch.ops.dispatch import launch_counters
    from idmvton_tpu_torch.train import quant_opt
    out = launch_counters()
    out.update(adam_int8_update=quant_opt.adamw_int8_fused_,
               adam_int8_norm=quant_opt.fused_global_norm)
    return out


def make_inputs(models, dev, gen):
    """A request's bf16 inputs at the operating point, from ``gen``."""
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


def step_readings(pipe, inputs, gen, path):
    """One denoise step with ``impl="cuda"`` and with ``impl="torch"`` on the
    same inputs; returns {"noise_pred" | "latent": (max rel, mean rel)} of
    the cuda result against the torch one: the guided noise prediction
    (read from the TryonNet's output as the step runs) and the stepped
    latent."""
    import torch
    from idmvton_tpu_torch.diffusion.scheduler import classifier_free_guidance
    dev = inputs["person"].device
    cond = pipe.staged_encoder()(gen, inputs)
    b, h, w, _ = inputs["person"].shape
    ds = pipe.models.vae_cfg.downscale
    lat_shape = (b, h // ds, w // ds, pipe.models.vae_cfg.latent_channels)
    lat = torch.randn(lat_shape, generator=gen, device=dev).to(torch.bfloat16)
    noise = torch.randn(lat_shape, generator=gen,
                        device=dev).to(torch.bfloat16)
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
            print(f"{path} denoise step impl={impl}: "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        hook.remove()
    readings = {}
    for what, by_impl in out.items():
        got, want = by_impl["cuda"].float(), by_impl["torch"].float()
        if not bool(got.isfinite().all()):
            readings[what] = (float("inf"), float("inf"))
            continue
        diff = (got - want).abs()
        readings[what] = (
            float(diff.max()) / max(float(want.abs().max()), 1e-6),
            float(diff.mean() / want.abs().mean()))
    del cond, out
    torch.cuda.empty_cache()
    return readings


def synthetic_batch(n, seed):
    """n samples of seeded numpy in the ``VitonHDDataset`` layout at
    HEIGHT x WIDTH (person / pose / cloth in [-1, 1], a {0, 1} mask, 224x224
    CLIP-normalized ip_pixels, captions), as an in-memory dataset."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)
    samples = []
    for i in range(n):
        mask = np.zeros((HEIGHT, WIDTH, 1), np.float32)
        mask[HEIGHT // 5:4 * HEIGHT // 5, WIDTH // 6:5 * WIDTH // 6] = 1.0
        samples.append({
            "im_name": f"{i:05d}_00.jpg", "c_name": f"{i:05d}_00.jpg",
            "person": img(), "mask": mask, "pose": img(), "cloth": img(),
            "ip_pixels": rng.standard_normal((224, 224, 3)).astype(
                np.float32),
            "caption": "model is wearing t shirts long ",
            "caption_cloth": "a photo of t shirts long "})
    return samples
