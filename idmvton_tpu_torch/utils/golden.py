"""The golden-parity gate: run the pipeline on a dumped fixture directory
and score SSIM against the reference's outputs (BASELINE.md's gate: SSIM
>= 0.99). Counterpart of ``idmvton_tpu/utils/golden.py``; the fixture
layout is the one ``scripts/dump_golden_fixtures.py`` writes, with every
``randn_tensor`` draw of the reference captured and injected again.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def run_golden_gate(golden_dir: str, *, device="cuda") -> dict:
    """Loads the models and fixtures of ``golden_dir`` on ``device``,
    regenerates with the reference's injected noises and returns
    {"ssim": float, "threshold": float, "passed": bool}.

    Layout:
      models/             the port's ``save_pipeline`` checkpoint, or a
                          diffusers tree (golden_config.json diffusers=true)
      inputs.npz          person/mask/pose/cloth/ip_pixels + token ids
      noise.npz           init_noise (B,h,w,4), step_noise (T,B,h,w,4)
      expected.npz        reference images, NHWC in [-1, 1]
      golden_config.json  num_steps/guidance_scale/seed/vae_sample/
                          ssim_threshold/dtype/diffusers
    """
    from idmvton_tpu_torch.pipeline.tryon import TryonPipeline
    from idmvton_tpu_torch.utils.metrics import ssim
    from idmvton_tpu_torch.weights.checkpoint import (
        from_diffusers, load_pipeline,
    )

    device = torch.device(device)
    cfg_path = os.path.join(golden_dir, "golden_config.json")
    cfg = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    models_dir = os.path.join(golden_dir, "models")
    dtype = getattr(torch, cfg.get("dtype", "bfloat16"))
    models = (from_diffusers(models_dir, dtype, device=device)
              if cfg.get("diffusers")
              else load_pipeline(models_dir, dtype, device=device))
    pipe = TryonPipeline(models)

    def tensor(v):
        t = torch.from_numpy(np.asarray(v)).to(device)
        return t.to(dtype) if t.is_floating_point() else t

    with np.load(os.path.join(golden_dir, "inputs.npz")) as f:
        inputs = {k: tensor(f[k]) for k in f.files}
    with np.load(os.path.join(golden_dir, "expected.npz")) as f:
        expected = torch.from_numpy(f["images"]).to(device)
    with np.load(os.path.join(golden_dir, "noise.npz")) as f:
        noise = {k: torch.from_numpy(f[k]).to(device) for k in f.files}

    fn = pipe.jit_generate(num_steps=cfg.get("num_steps", 30),
                           guidance_scale=cfg.get("guidance_scale", 2.0),
                           vae_sample=cfg.get("vae_sample", False))
    generator = torch.Generator(device=device).manual_seed(
        cfg.get("seed", 42))
    images = fn(generator, **inputs, init_noise=noise["init_noise"],
                step_noise=noise["step_noise"])
    s = float(ssim(images, expected))
    thr = float(cfg.get("ssim_threshold", 0.99))
    return {"ssim": s, "threshold": thr, "passed": s >= thr}
