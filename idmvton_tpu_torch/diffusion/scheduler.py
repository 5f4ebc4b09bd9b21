"""DDPM scheduler: fp32 tables and the reverse step.

Counterpart of ``idmvton_tpu/diffusion/scheduler.py`` for the serving
path: scaled_linear / linear / squaredcos_cap_v2 betas, the zero-terminal-
SNR rescale, leading / trailing / linspace spacing with ``prev_t`` taken
from the timestep array, epsilon / v / sample prediction, and the
classifier-free-guidance combine with its rescale, ``add_noise`` and the
strength truncation of the schedule. The denoising start/end trims and
custom timestep lists are not ported yet.

Timesteps are host integers: the serving loop runs on the host, so the
per-step coefficients are computed in numpy float32 (the JAX package's fp32
arithmetic) and applied to device tensors as exact Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from idmvton_tpu_torch.core.config import SchedulerConfig


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    sqrt_ac = np.sqrt(alphas_cumprod)
    a0, a_t = sqrt_ac[0], sqrt_ac[-1]
    sqrt_ac = (sqrt_ac - a_t) * a0 / (a0 - a_t)
    return sqrt_ac ** 2


class DDPMScheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        n = cfg.num_train_timesteps
        if cfg.beta_schedule == "scaled_linear":
            betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                                dtype=np.float64) ** 2
        elif cfg.beta_schedule == "linear":
            betas = np.linspace(cfg.beta_start, cfg.beta_end, n,
                                dtype=np.float64)
        elif cfg.beta_schedule == "squaredcos_cap_v2":
            t = np.arange(n + 1, dtype=np.float64) / n
            f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
            betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
        else:
            raise ValueError(cfg.beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas)
        if cfg.rescale_betas_zero_snr:
            alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)
        self.alphas_cumprod = alphas_cumprod.astype(np.float32)
        self.init_noise_sigma = 1.0

    def add_noise(self, sample, noise, timesteps):
        """sqrt(ac_t) * sample + sqrt(1 - ac_t) * noise in fp32, cast to the
        sample's type; ``timesteps`` an int or one per batch row."""
        ac = self.alphas_cumprod[np.asarray(timesteps)]
        shape = (-1,) + (1,) * (sample.dim() - 1)
        coef = lambda a: torch.from_numpy(
            np.atleast_1d(a).astype(np.float32)).to(sample.device).reshape(
            shape)
        return (coef(np.sqrt(ac)) * sample.float()
                + coef(np.sqrt(np.float32(1.0) - ac)) * noise.float()
                ).to(sample.dtype)

    def timesteps(self, num_inference_steps: int, strength: float = 1.0):
        """Descending int timesteps of the configured spacing; with
        ``strength`` < 1 only the last int(num_inference_steps * strength)
        (the reference's get_timesteps)."""
        n = self.cfg.num_train_timesteps
        spacing = self.cfg.timestep_spacing
        if spacing == "leading":
            ratio = n // num_inference_steps
            ts = (np.arange(num_inference_steps) * ratio).round()[::-1]
            ts = ts + self.cfg.steps_offset
        elif spacing == "trailing":
            ts = np.round(np.arange(n, 0, -n / num_inference_steps)) - 1
        else:
            ts = np.linspace(0, n - 1, num_inference_steps)[::-1].round()
        if strength < 1.0:
            init_t = min(int(num_inference_steps * strength),
                         num_inference_steps)
            ts = ts[num_inference_steps - init_t:]
        return ts.astype(np.int64)

    def timesteps_and_prev(self, num_inference_steps: int,
                           strength: float = 1.0):
        """(ts, prev_ts): prev of ts[i] is ts[i+1]; the last step's is -1."""
        ts = self.timesteps(num_inference_steps, strength)
        return ts, np.concatenate([ts[1:], [-1]]).astype(np.int64)

    def predict_x0(self, model_output, sample, t: int):
        ac = self.alphas_cumprod[t]
        sqrt_ac = float(np.sqrt(ac))
        sqrt_1mac = float(np.sqrt(np.float32(1.0) - ac))
        s, m = sample.float(), model_output.float()
        pt = self.cfg.prediction_type
        if pt == "epsilon":
            return (s - sqrt_1mac * m) / max(sqrt_ac, float(np.float32(1e-8)))
        if pt == "v_prediction":
            return sqrt_ac * s - sqrt_1mac * m
        if pt == "sample":
            return m
        raise ValueError(pt)

    def step(self, model_output, t: int, prev_t: int, sample, noise):
        """One reverse DDPM step: posterior mean + fixed_small variance
        noise (none on the final step, ``prev_t < 0``). Returns
        (prev_sample, x0), both in the sample's type."""
        one = np.float32(1.0)
        ac_t = self.alphas_cumprod[t]
        ac_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else one
        beta_prod_t = one - ac_t
        beta_prod_prev = one - ac_prev
        current_alpha = ac_t / ac_prev
        current_beta = one - current_alpha
        x0 = self.predict_x0(model_output, sample, t)
        pred_coeff = np.sqrt(ac_prev) * current_beta / beta_prod_t
        sample_coeff = np.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        prev = float(pred_coeff) * x0 + float(sample_coeff) * sample.float()
        if prev_t >= 0:
            variance = max(beta_prod_prev / beta_prod_t * current_beta,
                           np.float32(1e-20))
            prev = prev + float(np.sqrt(variance)) * noise.float()
        return prev.to(sample.dtype), x0.to(sample.dtype)


def classifier_free_guidance(noise_uncond, noise_text, scale: float,
                             guidance_rescale: float = 0.0):
    """CFG combine + optional Imagen-style rescale."""
    u, c = noise_uncond.float(), noise_text.float()
    guided = u + scale * (c - u)
    if guidance_rescale > 0.0:
        dims = tuple(range(1, guided.dim()))
        std_text = c.std(dim=dims, keepdim=True, correction=0)
        std_guided = guided.std(dim=dims, keepdim=True, correction=0)
        rescaled = guided * (std_text / std_guided.clamp_min(1e-8))
        guided = guidance_rescale * rescaled + (1.0 - guidance_rescale) * guided
    return guided.to(noise_uncond.dtype)
