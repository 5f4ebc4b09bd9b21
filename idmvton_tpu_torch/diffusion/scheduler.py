"""DDPM scheduler: fp32 tables and the reverse step.

Counterpart of ``idmvton_tpu/diffusion/scheduler.py``: scaled_linear /
linear / squaredcos_cap_v2 betas, the zero-terminal-SNR rescale, leading /
trailing / linspace spacing or a custom timestep list, the strength
truncation, the ``denoising_start`` / ``denoising_end`` trims (values
outside (0, 1) ignored, with ``prev_t`` taken before the end trim), epsilon
/ v / sample prediction, ``add_noise``, the training targets and weights
(``get_velocity``, ``snr``), and the classifier-free-guidance combine
with its rescale.

Timesteps are host integers. ``step`` computes its coefficients in numpy
float32 (the JAX package's fp32 arithmetic) from a Python-int ``t`` and
applies them as exact Python floats. ``step_table`` computes the same
values for a whole schedule, one row a step, and ``table_step`` /
``table_add_noise`` apply a row that lives on the device, in the same
order of operations: a captured CUDA graph gathers its row from a device
step index, so nothing is copied from the host inside the capture. On the
CPU ``table_step`` equals ``step`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from idmvton_tpu_torch.core.config import SchedulerConfig


def denoising_value_valid(x) -> bool:
    """A ``denoising_start`` / ``denoising_end`` counts only when it is a
    number strictly inside (0, 1); any other value is ignored."""
    return x is not None and 0.0 < float(x) < 1.0


def check_denoising_range(denoising_start, denoising_end):
    """(start, end) with invalid values as None; a valid start >= a valid
    end raises (the [start, end) window would be empty)."""
    start = float(denoising_start) if denoising_value_valid(
        denoising_start) else None
    end = float(denoising_end) if denoising_value_valid(
        denoising_end) else None
    if start is not None and end is not None and start >= end:
        raise ValueError(
            f"denoising_start ({start}) must be < denoising_end ({end}): "
            "the [start, end) window would be empty")
    return start, end


# the columns of a ``step_table`` row (fp32): the timestep; predict_x0's
# sqrt(ac_t), sqrt(1 - ac_t) and max(sqrt(ac_t), 1e-8); the posterior mean's
# pred_coeff and sample_coeff; the noise std and whether noise is added
# (prev_t >= 0); add_noise's two roots at the next timestep and whether
# there is one (the inpaint blend)
(COL_T, COL_SQRT_AC, COL_SQRT_1MAC, COL_X0_DEN, COL_PRED, COL_SAMPLE,
 COL_STD, COL_NOISE_ON, COL_NEXT_SQRT_AC, COL_NEXT_SQRT_1MAC,
 COL_HAS_NEXT) = range(11)
TABLE_COLS = 11


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

    def get_velocity(self, sample, noise, timesteps):
        """The v-prediction target sqrt(ac_t) * noise - sqrt(1 - ac_t) *
        sample in fp32, cast to the sample's type; ``timesteps`` as
        ``add_noise``'s."""
        ac = self.alphas_cumprod[np.asarray(timesteps)]
        shape = (-1,) + (1,) * (sample.dim() - 1)
        coef = lambda a: torch.from_numpy(
            np.atleast_1d(a).astype(np.float32)).to(sample.device).reshape(
            shape)
        return (coef(np.sqrt(ac)) * noise.float()
                - coef(np.sqrt(np.float32(1.0) - ac)) * sample.float()
                ).to(sample.dtype)

    def snr(self, timesteps) -> torch.Tensor:
        """Signal-to-noise ratio ac_t / max(1 - ac_t, 1e-12), fp32, one per
        timestep (a CPU tensor; min-SNR weighting moves it to the loss)."""
        ac = np.atleast_1d(self.alphas_cumprod[np.asarray(timesteps)])
        return torch.from_numpy(
            ac / np.maximum(np.float32(1.0) - ac, np.float32(1e-12)))

    def timesteps(self, num_inference_steps: int, strength: float = 1.0,
                  denoising_start: float = None, denoising_end: float = None,
                  custom_timesteps=None):
        """Descending int timesteps of the configured spacing, or
        ``custom_timesteps`` (strictly descending, in [0, T); their length
        is then the step count). ``denoising_start`` keeps only the
        timesteps below round(T - start * T) and ignores ``strength``;
        else ``strength`` < 1 keeps the last int(steps * strength).
        ``denoising_end`` keeps only those >= round(T - end * T)."""
        denoising_start, denoising_end = check_denoising_range(
            denoising_start, denoising_end)
        n = self.cfg.num_train_timesteps
        spacing = self.cfg.timestep_spacing
        if custom_timesteps is not None:
            ts = np.asarray(custom_timesteps, np.int64)
            if ts.ndim != 1 or ts.size == 0:
                raise ValueError("custom timesteps must be a non-empty 1-D "
                                 "sequence")
            if np.any(np.diff(ts) >= 0):
                raise ValueError("custom timesteps must be strictly "
                                 "descending (diffusers set_timesteps "
                                 "contract)")
            if ts[0] >= n or ts[-1] < 0:
                raise ValueError(f"custom timesteps must lie in [0, {n})")
            num_inference_steps = int(ts.size)
        elif spacing == "leading":
            ratio = n // num_inference_steps
            ts = (np.arange(num_inference_steps) * ratio).round()[::-1]
            ts = ts + self.cfg.steps_offset
        elif spacing == "trailing":
            ts = np.round(np.arange(n, 0, -n / num_inference_steps)) - 1
        else:
            ts = np.linspace(0, n - 1, num_inference_steps)[::-1].round()
        ts = ts.astype(np.int64)
        if denoising_start is not None:
            ts = ts[ts < int(round(n - denoising_start * n))]
        elif strength < 1.0:
            init_t = min(int(num_inference_steps * strength),
                         num_inference_steps)
            ts = ts[num_inference_steps - init_t:]
        if denoising_end is not None:
            ts = ts[ts >= int(round(n - denoising_end * n))]
        return ts.copy()

    def timesteps_and_prev(self, num_inference_steps: int,
                           strength: float = 1.0,
                           denoising_start: float = None,
                           denoising_end: float = None,
                           custom_timesteps=None):
        """(ts, prev_ts): prev of ts[i] is ts[i+1], the last one's -1, taken
        before the ``denoising_end`` trim, so a trimmed run's last step goes
        to the timestep a successor with ``denoising_start`` = this end
        starts from (chaining the two equals the unsplit run)."""
        denoising_start, denoising_end = check_denoising_range(
            denoising_start, denoising_end)
        full = self.timesteps(num_inference_steps, strength, denoising_start,
                              custom_timesteps=custom_timesteps)
        prev = self.prev_timesteps(full)
        if denoising_end is not None:
            n = self.cfg.num_train_timesteps
            keep = int(np.sum(full >= int(round(n - denoising_end * n))))
            full, prev = full[:keep], prev[:keep]
        return full, prev

    def prev_timesteps(self, timesteps, num_inference_steps: int = None):
        """prev of ts[i] is ts[i+1]; the last one's is -1 (fully denoised).
        ``num_inference_steps`` is accepted as JAX's and unused."""
        ts = np.asarray(timesteps, np.int64)
        return np.concatenate([ts[1:], [-1]]).astype(np.int64)

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

    def step_table(self, ts, prev_ts, next_ts=None) -> np.ndarray:
        """(T, TABLE_COLS) fp32: row i holds the values ``step(..., ts[i],
        prev_ts[i], ...)`` computes, and add_noise's roots at ``next_ts[i]``
        (the timestep the inpaint blend noises to; default ``prev_ts``),
        each by the same numpy float32 expression."""
        one = np.float32(1.0)
        next_ts = prev_ts if next_ts is None else next_ts
        rows = np.zeros((len(ts), TABLE_COLS), np.float32)
        for i, (t, prev_t, next_t) in enumerate(zip(ts, prev_ts, next_ts)):
            t, prev_t, next_t = int(t), int(prev_t), int(next_t)
            ac_t = self.alphas_cumprod[t]
            ac_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else one
            beta_prod_t = one - ac_t
            beta_prod_prev = one - ac_prev
            current_alpha = ac_t / ac_prev
            current_beta = one - current_alpha
            r = rows[i]
            r[COL_T] = t
            r[COL_SQRT_AC] = np.sqrt(ac_t)
            r[COL_SQRT_1MAC] = np.sqrt(one - ac_t)
            r[COL_X0_DEN] = max(np.sqrt(ac_t), np.float32(1e-8))
            r[COL_PRED] = np.sqrt(ac_prev) * current_beta / beta_prod_t
            r[COL_SAMPLE] = (np.sqrt(current_alpha) * beta_prod_prev
                             / beta_prod_t)
            if prev_t >= 0:
                r[COL_STD] = np.sqrt(max(
                    beta_prod_prev / beta_prod_t * current_beta,
                    np.float32(1e-20)))
                r[COL_NOISE_ON] = 1.0
            if next_t >= 0:
                ac_next = self.alphas_cumprod[next_t]
                r[COL_NEXT_SQRT_AC] = np.sqrt(ac_next)
                r[COL_NEXT_SQRT_1MAC] = np.sqrt(one - ac_next)
                r[COL_HAS_NEXT] = 1.0
        return rows

    def table_step(self, model_output, row, sample, noise):
        """``step`` with its coefficients read from ``row``, a (TABLE_COLS,)
        fp32 tensor on the sample's device: the same operations in the same
        order (the noise term kept only where the row's flag is set).
        Returns (prev_sample, x0)."""
        s, m = sample.float(), model_output.float()
        pt = self.cfg.prediction_type
        if pt == "epsilon":
            x0 = (s - row[COL_SQRT_1MAC] * m) / row[COL_X0_DEN]
        elif pt == "v_prediction":
            x0 = row[COL_SQRT_AC] * s - row[COL_SQRT_1MAC] * m
        elif pt == "sample":
            x0 = m
        else:
            raise ValueError(pt)
        prev = row[COL_PRED] * x0 + row[COL_SAMPLE] * s
        prev = torch.where(row[COL_NOISE_ON] > 0,
                           prev + row[COL_STD] * noise.float(), prev)
        return prev.to(sample.dtype), x0.to(sample.dtype)

    def table_add_noise(self, sample, noise, row):
        """``add_noise`` at the row's next timestep; the sample itself where
        the row has none."""
        noised = (row[COL_NEXT_SQRT_AC] * sample.float()
                  + row[COL_NEXT_SQRT_1MAC] * noise.float()).to(sample.dtype)
        return torch.where(row[COL_HAS_NEXT] > 0, noised, sample)


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
