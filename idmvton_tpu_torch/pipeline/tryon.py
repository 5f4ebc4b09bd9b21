"""Try-on serving pipeline: staged encode, per-step denoise loop, decode.

Counterpart of ``idmvton_tpu/pipeline/tryon.py`` for the serving path
(``TryonPipeline.stepwise_generate``; VITON-HD inference). Conditioning
layout of the 13-channel TryonNet input:
[noisy latent 4 | inpaint mask 1 | masked-person latent 4 | DensePose 4].
CFG batches are ordered [uncond | cond]; GarmentNet runs the cond half only
and TryonNet folds the uncond half's zero garment KV in analytically.

Randomness comes from one explicit ``torch.Generator``, consumed in a fixed
order (VAE posterior samples, initial noise, the person latent's posterior
sample when ``strength`` < 1, then one draw per step); parity runs pass
``vae_sample=False`` and inject ``init_noise`` / ``step_noise``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from idmvton_tpu_torch.core.config import (
    CLIPTextConfig, CLIPVisionConfig, ResamplerConfig, SchedulerConfig,
    UNetConfig, VAEConfig,
)
from idmvton_tpu_torch.diffusion.scheduler import (
    DDPMScheduler, classifier_free_guidance,
)
from idmvton_tpu_torch.models.clip import CLIPText, CLIPVision
from idmvton_tpu_torch.models.layers import reset_parameters_, resize_nearest
from idmvton_tpu_torch.models.resampler import Resampler
from idmvton_tpu_torch.models.unet import UNet
from idmvton_tpu_torch.models.vae import VAE

COMPONENTS = ("unet", "garm", "vae", "clip_l", "clip_g", "vision",
              "resampler")


@dataclasses.dataclass
class TryonModels:
    """The seven model components of the try-on stack and their configs."""

    unet_cfg: UNetConfig
    unet: UNet
    garm_cfg: UNetConfig
    garm: UNet
    vae_cfg: VAEConfig
    vae: VAE
    clip_l_cfg: CLIPTextConfig
    clip_l: CLIPText
    clip_g_cfg: CLIPTextConfig
    clip_g: CLIPText
    vision_cfg: CLIPVisionConfig
    vision: CLIPVision
    resampler_cfg: ResamplerConfig
    resampler: Resampler

    @staticmethod
    def configs(tiny: bool = False):
        if tiny:
            return (UNetConfig.tiny("consume"), UNetConfig.tiny("emit"),
                    VAEConfig.tiny(), CLIPTextConfig.tiny(),
                    CLIPTextConfig.tiny(hidden_size=32, projection_dim=64,
                                        use_final_projection=True),
                    CLIPVisionConfig.tiny(), ResamplerConfig.tiny())
        return (UNetConfig.sdxl_tryon(), UNetConfig.sdxl_garment(),
                VAEConfig.sdxl(), CLIPTextConfig.clip_l(),
                CLIPTextConfig.clip_bigg(), CLIPVisionConfig.vit_h(),
                ResamplerConfig.sdxl_plus())

    @staticmethod
    def init(seed: Optional[int] = 0, *, tiny: bool = False,
             device="cuda", dtype=torch.bfloat16) -> "TryonModels":
        """Build the stack on ``device`` (full SDXL widths, or the tiny test
        configs). With a ``seed``, parameters get the JAX package's random
        init from a generator on ``device``; with ``seed=None`` they are
        left uninitialized for a loader to fill."""
        device = torch.device(device)
        u, g, v, tl, tg, vi, rs = TryonModels.configs(tiny)
        kw = dict(dtype=dtype, device=device)
        models = TryonModels(
            unet_cfg=u, unet=UNet(u, **kw), garm_cfg=g, garm=UNet(g, **kw),
            vae_cfg=v, vae=VAE(v, **kw),
            clip_l_cfg=tl, clip_l=CLIPText(tl, **kw),
            clip_g_cfg=tg, clip_g=CLIPText(tg, **kw),
            vision_cfg=vi, vision=CLIPVision(vi, **kw),
            resampler_cfg=rs, resampler=Resampler(rs, **kw))
        if seed is not None:
            gen = torch.Generator(device=device).manual_seed(seed)
            for name in COMPONENTS:
                reset_parameters_(getattr(models, name), gen)
        return models

    def components(self) -> dict:
        return {name: getattr(self, name) for name in COMPONENTS}


def make_time_ids(img_h: int, img_w: int, batch: int, dtype, device, *,
                  original_size=None, crops_coords_top_left=(0, 0),
                  target_size=None, negative_original_size=None,
                  negative_crops_coords_top_left=(0, 0),
                  negative_target_size=None, aesthetic_score: float = 6.0,
                  negative_aesthetic_score: float = 2.5,
                  requires_aesthetics_score: bool = False):
    """SDXL micro-conditioning ids, CFG-batched [negative | positive]
    (JAX ``make_time_ids``, with the reference's quirk that the negative ids
    reuse the POSITIVE crops_coords_top_left outside the aesthetic branch).
    Returns (2 * batch, 6), or (2 * batch, 5) with aesthetics."""
    original_size = tuple(original_size or (img_h, img_w))
    target_size = tuple(target_size or (img_h, img_w))
    negative_original_size = tuple(negative_original_size or original_size)
    negative_target_size = tuple(negative_target_size or target_size)
    crops = tuple(crops_coords_top_left)
    neg_crops = tuple(negative_crops_coords_top_left)
    if requires_aesthetics_score:
        pos = original_size + crops + (aesthetic_score,)
        neg = negative_original_size + neg_crops + (negative_aesthetic_score,)
    else:
        pos = original_size + crops + target_size
        neg = negative_original_size + crops + negative_target_size
    rows = [neg] * batch + [pos] * batch
    return torch.tensor(rows, dtype=dtype, device=device)


def encode_prompt_sdxl(models: TryonModels, ids_l, ids_g):
    """SDXL dual text encode: concat of both penultimate states (768 + 1280
    = 2048) and bigG's pooled projection."""
    out_l = models.clip_l(ids_l)
    out_g = models.clip_g(ids_g)
    embeds = torch.cat([out_l["penultimate"], out_g["penultimate"]], dim=-1)
    return embeds, out_g["pooled"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TryonPipeline:
    def __init__(self, models: TryonModels,
                 scheduler: Optional[DDPMScheduler] = None):
        self.models = models
        self.scheduler = scheduler or DDPMScheduler(
            SchedulerConfig.sdxl_inference())

    # -- stage 1: conditioning encodes ---------------------------------------

    def staged_encoder(self, *, vae_sample: bool = True):
        """Returns encode(generator, inputs) -> cond dict, with batched tower
        calls: the 3 prompt sets in one text pass, [zeros | image] in one
        vision pass, the 3 VAE encodes in one pass.

        inputs: person / pose / cloth (B, H, W, 3) in [-1, 1], mask
        (B, H, W, 1) in {0, 1} (1 = inpaint), ip_pixels (B, 224, 224, 3),
        and the token ids prompt_ids_* / neg_ids_* / cloth_ids_* (B, 77)
        for the two towers (``_l``, ``_g``)."""
        m = self.models

        def encode(generator, inputs):
            person, mask = inputs["person"], inputs["mask"]
            b, img_h, img_w, _ = person.shape
            ds = m.vae_cfg.downscale
            dtype = person.dtype
            ids_l = torch.cat([inputs["prompt_ids_l"], inputs["neg_ids_l"],
                               inputs["cloth_ids_l"]], 0)
            ids_g = torch.cat([inputs["prompt_ids_g"], inputs["neg_ids_g"],
                               inputs["cloth_ids_g"]], 0)
            embeds, pooled = encode_prompt_sdxl(m, ids_l, ids_g)
            prompt_embeds, neg_embeds, cloth_embeds = embeds.chunk(3)
            pooled_p, pooled_n, _ = pooled.chunk(3)

            ip_pixels = inputs["ip_pixels"]
            vis = m.vision(torch.cat([torch.zeros_like(ip_pixels), ip_pixels]))
            ip_uncond, ip_cond = m.resampler(vis["penultimate"]).chunk(2)

            masked_person = person * (mask < 0.5).to(dtype)
            lats = m.vae.encode(
                torch.cat([masked_person, inputs["pose"], inputs["cloth"]]),
                generator, sample=vae_sample)
            masked_lat, pose_lat, cloth_lat = lats.chunk(3)
            mask_lat = resize_nearest(mask, (img_h // ds, img_w // ds))

            context = torch.cat([torch.cat([neg_embeds, ip_uncond], 1),
                                 torch.cat([prompt_embeds, ip_cond], 1)], 0)
            return {
                "context": context,
                "add_text_embeds": torch.cat([pooled_n, pooled_p], 0),
                "time_ids": make_time_ids(img_h, img_w, b, dtype,
                                          person.device),
                "mask_lat": mask_lat.to(dtype),
                "masked_lat": masked_lat,
                "pose_lat": pose_lat,
                "cloth_lat": cloth_lat,
                "cloth_embeds": cloth_embeds,
            }

        return encode

    # -- stage 2: one denoise step --------------------------------------------

    def garment_features(self, cond: dict, t: int, *, impl=None):
        """GarmentNet on the cond batch only (B rows)."""
        _, feats = self.models.garm(cond["cloth_lat"], t,
                                    cond["cloth_embeds"], impl=impl)
        return feats

    def denoise_step(self, cond: dict, latents, t: int, prev_t: int,
                     generator: Optional[torch.Generator] = None, *,
                     guidance_scale: float = 2.0, feats_cfg=None,
                     step_noise=None, impl=None):
        """GarmentNet -> TryonNet (CFG batch 2B) -> CFG -> DDPM step.
        ``feats_cfg``: cached garment features (garment_cache="once");
        ``step_noise``: injected DDPM variance noise, else drawn from
        ``generator``."""
        m = self.models
        if feats_cfg is None:
            feats_cfg = self.garment_features(cond, t, impl=impl)
        two = lambda x: torch.cat([x, x], 0)
        unet_in = torch.cat([two(latents), two(cond["mask_lat"]),
                             two(cond["masked_lat"]), two(cond["pose_lat"])],
                            dim=-1)
        noise_pred, _ = m.unet(
            unet_in, t, cond["context"],
            added_cond=(cond["add_text_embeds"], cond["time_ids"]),
            garment_features=feats_cfg, garment_uncond_zero=True, impl=impl)
        uncond, condp = noise_pred.chunk(2)
        guided = classifier_free_guidance(uncond, condp, guidance_scale)
        if step_noise is None:
            step_noise = torch.randn(latents.shape, generator=generator,
                                     device=latents.device,
                                     dtype=torch.float32).to(latents.dtype)
        new_latents, _ = self.scheduler.step(guided, t, prev_t, latents,
                                             step_noise)
        return new_latents

    # -- stage 3: decode -------------------------------------------------------

    def decode(self, latents):
        images = self.models.vae.decode(latents)
        return images.clamp(-1.0, 1.0).to(latents.dtype)

    # -- the serving entry point -----------------------------------------------

    def stepwise_generate(self, *, num_steps: int = 30,
                          guidance_scale: float = 2.0,
                          strength: float = 1.0,
                          garment_cache: str = "every_step",
                          vae_sample: bool = True, impl=None):
        """Returns fn(generator, *, init_noise=None, step_noise=None,
        phase_seconds=None, **inputs) -> images (B, H, W, 3) in [-1, 1].

        garment_cache: "every_step" runs GarmentNet each step (reference
        semantics); "once" computes its features at the schedule's middle
        timestep and reuses them. ``strength`` < 1 runs the last
        int(num_steps * strength) steps from the person image's VAE latents
        noised to the first of them (the reference's prepare_latents).
        init_noise (B, h, w, 4) / step_noise (T, B, h, w, 4), T the steps
        run, replace the generator's draws. A ``phase_seconds``
        dict receives the encode / denoise / decode wall times (each phase
        ends in a device synchronize)."""
        if garment_cache not in ("every_step", "once"):
            raise ValueError(f"garment_cache {garment_cache!r}")
        m = self.models
        sched = self.scheduler
        encode = self.staged_encoder(vae_sample=vae_sample)
        ts, prev_ts = sched.timesteps_and_prev(num_steps, strength)
        if len(ts) == 0:
            raise ValueError(f"strength {strength} leaves none of "
                             f"{num_steps} steps")

        @torch.inference_mode()
        def fn(generator, *, init_noise=None, step_noise=None,
               phase_seconds: Optional[dict] = None, **inputs):
            person = inputs["person"]
            device, dtype = person.device, person.dtype
            b, img_h, img_w, _ = person.shape
            ds = m.vae_cfg.downscale
            lshape = (b, img_h // ds, img_w // ds, m.vae_cfg.latent_channels)
            clock = time.perf_counter()

            def phase(name):
                nonlocal clock
                if phase_seconds is not None:
                    _sync(device)
                    now = time.perf_counter()
                    phase_seconds[name] = now - clock
                    clock = now

            cond = encode(generator, inputs)
            if init_noise is None:
                init_noise = torch.randn(lshape, generator=generator,
                                         device=device, dtype=torch.float32)
            if strength >= 1.0:
                lat = init_noise.to(dtype) * sched.init_noise_sigma
            else:
                image_lat = m.vae.encode(person, generator,
                                         sample=vae_sample)
                lat = sched.add_noise(image_lat.to(dtype),
                                      init_noise.to(dtype), int(ts[0]))
            phase("encode")
            feats = None
            if garment_cache == "once":
                feats = self.garment_features(cond, int(ts[len(ts) // 2]),
                                              impl=impl)
            for i in range(len(ts)):
                noise_i = None if step_noise is None else step_noise[i].to(
                    dtype)
                lat = self.denoise_step(
                    cond, lat, int(ts[i]), int(prev_ts[i]), generator,
                    guidance_scale=guidance_scale, feats_cfg=feats,
                    step_noise=noise_i, impl=impl)
            phase("denoise")
            images = self.decode(lat)
            phase("decode")
            return images

        return fn
