"""DDPM (diffusers ``DDPMScheduler``: scaled_linear betas, leading spacing
with steps_offset, epsilon prediction, fixed_small variance, no clipping),
in float64, for the reference; the CFG combine."""

from __future__ import annotations

import numpy as np


class DDPM:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        n = cfg["num_train_timesteps"]
        if cfg["beta_schedule"] != "scaled_linear":
            raise ValueError(cfg["beta_schedule"])
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                            n, dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        if cfg.get("rescale_betas_zero_snr"):
            s = np.sqrt(ac)
            s = (s - s[-1]) * s[0] / (s[0] - s[-1])
            ac = s ** 2
        self.ac = ac

    def timesteps(self, steps: int):
        """(timesteps, previous timesteps), leading spacing."""
        n = self.cfg["num_train_timesteps"]
        ratio = n // steps
        ts = (np.arange(steps) * ratio)[::-1] + self.cfg["steps_offset"]
        return ts, ts - ratio

    def coefficients(self, t: int, prev_t: int):
        """x_prev = a * x + b * eps + s * z."""
        ac_t = self.ac[t]
        ac_p = self.ac[prev_t] if prev_t >= 0 else 1.0
        beta = 1.0 - ac_t / ac_p
        pred = np.sqrt(ac_p) * beta / (1.0 - ac_t)
        samp = np.sqrt(1.0 - beta) * (1.0 - ac_p) / (1.0 - ac_t)
        # x0 = (x - sqrt(1 - ac_t) eps) / sqrt(ac_t)
        a = pred / np.sqrt(ac_t) + samp
        b = -pred * np.sqrt(1.0 - ac_t) / np.sqrt(ac_t)
        var = max((1.0 - ac_p) / (1.0 - ac_t) * beta, 1e-20)
        s = np.sqrt(var) if prev_t >= 0 else 0.0
        return float(a), float(b), float(s)

    def add_noise(self, x, noise, t):
        """sqrt(ac_t) x + sqrt(1 - ac_t) noise, t a host array of rows."""
        import torch
        ac = torch.as_tensor(self.ac[np.asarray(t)], dtype=torch.float64,
                             device=x.device)
        shape = (-1,) + (1,) * (x.dim() - 1)
        return (ac.sqrt().view(shape) * x.double()
                + (1 - ac).sqrt().view(shape) * noise.double()).float()


def cfg_combine(uncond, cond, scale: float):
    return uncond + scale * (cond - uncond)
