"""Try-on pipeline: conditioning encodes, the denoise loop, decode.

Counterpart of ``idmvton_tpu/pipeline/tryon.py``: ``encode_conditioning``
(one tower call a slot) and ``staged_encoder`` (batched tower calls),
``replicate_cond``, ``denoise_step``, ``denoise``, ``decode``,
``generate`` and the two serving entry points, ``jit_generate`` and
``stepwise_generate``. Conditioning layout of the 13-channel TryonNet
input: [noisy latent 4 | inpaint mask 1 | masked-person latent 4 |
DensePose 4]. CFG batches are ordered [uncond | cond]; GarmentNet runs the
cond half only and TryonNet folds the uncond half's zero garment KV in
analytically.

On a CUDA input ``jit_generate`` and ``stepwise_generate`` replay every
denoise step from one captured CUDA graph (``pipeline/graph.py``), the
counterpart of JAX's compiled step and fused program; there is no switch to
run them eagerly, and a failure to capture raises. ``generate``,
``denoise`` and ``denoise_step`` run eagerly, as on a CPU input. The step
reads its schedule from a device table (``DDPMScheduler.step_table``), so
the eager and the replayed steps run the same operations on the same
values.

Randomness comes from one explicit ``torch.Generator``, consumed in a fixed
order that each entry point's docstring states; where JAX folds a key
(``fold_in(rng, 7)`` for the person image's latents) the port takes the
generator's next draw. Parity runs pass ``vae_sample=False`` and inject
``init_noise`` / ``step_noise``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from idmvton_tpu_torch.core.config import (
    CLIPTextConfig, CLIPVisionConfig, ResamplerConfig, SchedulerConfig,
    UNetConfig, VAEConfig,
)
from idmvton_tpu_torch.diffusion.scheduler import (
    COL_T, TABLE_COLS, DDPMScheduler, check_denoising_range,
    classifier_free_guidance,
)
from idmvton_tpu_torch.models.clip import CLIPText, CLIPVision
from idmvton_tpu_torch.models.layers import reset_parameters_, resize_nearest
from idmvton_tpu_torch.models.resampler import Resampler
from idmvton_tpu_torch.models.unet import UNet
from idmvton_tpu_torch.models.vae import VAE
from idmvton_tpu_torch.ops.dispatch import resolve
from idmvton_tpu_torch.pipeline.graph import (
    GraphCache, StepGraph, graph_key, weights_fingerprint,
)
from idmvton_tpu_torch.utils.profiling import span, timed

COMPONENTS = ("unet", "garm", "vae", "clip_l", "clip_g", "vision",
              "resampler")
CFG_FIELDS = ("unet_cfg", "garm_cfg", "vae_cfg", "clip_l_cfg", "clip_g_cfg",
              "vision_cfg", "resampler_cfg")


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
    # the loader's fixed-shift softmax calibration report
    # (weights.checkpoint.calibrate_attention_softmax), None if it did not run
    calibration: Optional[dict] = None

    @staticmethod
    def configs(tiny: bool = False, micro: bool = False):
        """The seven configs: full SDXL widths; the tiny test stack; or,
        for ``micro``, the micro UNets (2 levels, depth 1) with the tiny
        frozen towers (JAX ``TryonModels.init(micro=True)``: the mechanics
        tests' stack)."""
        if micro or tiny:
            kind = UNetConfig.micro if micro else UNetConfig.tiny
            return (kind("consume"), kind("emit"),
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
             micro: bool = False, cfgs: Optional[dict] = None,
             device="cuda", dtype=torch.bfloat16) -> "TryonModels":
        """Build the stack on ``device`` (full SDXL widths, the tiny or
        micro test configs, or ``cfgs``: field of ``CFG_FIELDS`` -> config,
        in place of that choice). With a ``seed``, parameters get the JAX
        package's random init from a generator on ``device``; with
        ``seed=None`` they are left uninitialized for a loader to fill."""
        device = torch.device(device)
        u, g, v, tl, tg, vi, rs = (TryonModels.configs(tiny, micro)
                                   if cfgs is None
                                   else (cfgs[f] for f in CFG_FIELDS))
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


def encode_prompt_sdxl(models: TryonModels, ids_l, ids_g, *,
                       clip_skip: Optional[int] = None):
    """SDXL dual text encode: concat of both penultimate states (768 + 1280
    = 2048) and bigG's pooled projection. ``clip_skip`` applies to both
    towers' hidden-state pick; the pooled output is unaffected."""
    out_l = models.clip_l(ids_l, clip_skip=clip_skip)
    out_g = models.clip_g(ids_g, clip_skip=clip_skip)
    embeds = torch.cat([out_l["penultimate"], out_g["penultimate"]], dim=-1)
    return embeds, out_g["pooled"]


def replicate_cond(cond: dict, n: int) -> dict:
    """The conditioning for ``num_images_per_prompt=n``: CFG-batched
    tensors (2B rows, [uncond | cond]) repeat each row n times within each
    half, B-row tensors repeat each row n times."""
    if n == 1:
        return cond
    b = cond["mask_lat"].shape[0]

    def rep(x):
        if x.shape[0] == 2 * b:
            u, c = x.chunk(2)
            return torch.cat([u.repeat_interleave(n, 0),
                              c.repeat_interleave(n, 0)])
        return x.repeat_interleave(n, 0)

    return {k: rep(v) for k, v in cond.items()}


def _phase(name: str, phase_seconds: Optional[dict], device):
    """The request's phase ``name`` as the span ``serve.<name>``; with a
    ``phase_seconds`` dict it ends in a device synchronize and its wall
    seconds go into the dict."""
    return timed(f"serve.{name}", phase_seconds, name, device)


def _blend(lat, image_lat, noise, mask_lat, row, sched):
    """The inpaint blend after a step: the unmasked region pinned to the
    image latents noised to the row's next timestep (the image latents
    themselves after the last step)."""
    m = mask_lat.float()
    proper = sched.table_add_noise(image_lat, noise, row)
    return ((1.0 - m) * proper.float() + m * lat.float()).to(lat.dtype)


class TryonPipeline:
    def __init__(self, models: TryonModels,
                 scheduler: Optional[DDPMScheduler] = None):
        self.models = models
        self.scheduler = scheduler or DDPMScheduler(
            SchedulerConfig.sdxl_inference())
        self.graphs = GraphCache()

    # -- stage 1: conditioning encodes ---------------------------------------

    def encode_conditioning(self, generator=None, *, person, mask, pose,
                            cloth, prompt_ids_l=None, prompt_ids_g=None,
                            neg_ids_l=None, neg_ids_g=None,
                            cloth_ids_l=None, cloth_ids_g=None,
                            ip_pixels=None, vae_sample: bool = True,
                            micro_conditioning: Optional[dict] = None,
                            clip_skip: Optional[int] = None,
                            prompt_embeds=None, pooled_prompt_embeds=None,
                            negative_prompt_embeds=None,
                            negative_pooled_prompt_embeds=None,
                            cloth_prompt_embeds=None,
                            masked_image_latents=None) -> dict:
        """The static conditioning dict of ``denoise``, one tower call a
        slot. Images (B, H, W, C) in [-1, 1]; mask (B, H, W, 1) in {0, 1}
        (1 = inpaint); ip_pixels (B, 224, 224, 3) CLIP-normalized.

        Each prompt slot takes token ids or precomputed embeds:
        ``prompt_embeds`` (B, S, 2048) with ``pooled_prompt_embeds`` (B,
        1280), the negative pair likewise, ``cloth_prompt_embeds`` alone.
        ``masked_image_latents`` (B, h, w, 4), scaled, replaces the masked
        person's VAE encode. ``micro_conditioning``: ``make_time_ids``
        keywords. The VAE encodes of the masked person (unless passed), pose
        and cloth run as one batched call: one posterior draw from the
        generator."""
        m = self.models
        with span("encode.text"):
            if prompt_embeds is None:
                prompt_embeds, pooled = encode_prompt_sdxl(
                    m, prompt_ids_l, prompt_ids_g, clip_skip=clip_skip)
            else:
                if pooled_prompt_embeds is None:
                    raise ValueError(
                        "prompt_embeds requires pooled_prompt_embeds")
                pooled = pooled_prompt_embeds
            if negative_prompt_embeds is None:
                neg_embeds, neg_pooled = encode_prompt_sdxl(
                    m, neg_ids_l, neg_ids_g, clip_skip=clip_skip)
            else:
                if negative_pooled_prompt_embeds is None:
                    raise ValueError("negative_prompt_embeds requires "
                                     "negative_pooled_prompt_embeds")
                neg_embeds = negative_prompt_embeds
                neg_pooled = negative_pooled_prompt_embeds
            if cloth_prompt_embeds is None:
                cloth_embeds, _ = encode_prompt_sdxl(
                    m, cloth_ids_l, cloth_ids_g, clip_skip=clip_skip)
            else:
                cloth_embeds = cloth_prompt_embeds

        with span("encode.vision"):
            ip_cond = m.resampler(m.vision(ip_pixels)["penultimate"])
            ip_uncond = m.resampler(
                m.vision(torch.zeros_like(ip_pixels))["penultimate"])
        return self._cond(
            generator, person=person, mask=mask, pose=pose, cloth=cloth,
            masked_image_latents=masked_image_latents, vae_sample=vae_sample,
            micro_conditioning=micro_conditioning,
            text=(prompt_embeds, pooled, neg_embeds, neg_pooled,
                  cloth_embeds), ip=(ip_uncond, ip_cond))

    def _cond(self, generator, *, person, mask, pose, cloth,
              masked_image_latents, vae_sample, micro_conditioning, text,
              ip):
        """The conditioning dict from the text encodes (prompt, pooled,
        negative, negative pooled, cloth) and the IP tokens (uncond, cond):
        the VAE encodes of the masked person (unless passed), pose and cloth
        in one batched call (one posterior draw), the latent-sized mask, the
        CFG-batched context, pooled embeds and time ids."""
        m = self.models
        b, img_h, img_w, _ = person.shape
        ds = m.vae_cfg.downscale
        dtype = person.dtype
        prompt_embeds, pooled, neg_embeds, neg_pooled, cloth_embeds = text
        ip_uncond, ip_cond = ip
        with span("encode.vae"):
            if masked_image_latents is not None:
                pose_lat, cloth_lat = m.vae.encode(
                    torch.cat([pose, cloth]), generator,
                    sample=vae_sample).chunk(2)
                masked_lat = masked_image_latents.to(dtype)
            else:
                masked_lat, pose_lat, cloth_lat = m.vae.encode(
                    torch.cat([person * (mask < 0.5).to(dtype), pose,
                               cloth]), generator, sample=vae_sample).chunk(3)
        mask_lat = resize_nearest(mask, (img_h // ds, img_w // ds))
        context = torch.cat([torch.cat([neg_embeds, ip_uncond], 1),
                             torch.cat([prompt_embeds, ip_cond], 1)], 0)
        return {
            "context": context,
            "add_text_embeds": torch.cat([neg_pooled, pooled], 0),
            "time_ids": make_time_ids(img_h, img_w, b, dtype, person.device,
                                      **(micro_conditioning or {})),
            "mask_lat": mask_lat.to(dtype),
            "masked_lat": masked_lat,
            "pose_lat": pose_lat,
            "cloth_lat": cloth_lat,
            "cloth_embeds": cloth_embeds,
        }

    def staged_encoder(self, *, vae_sample: bool = True,
                       micro_conditioning: Optional[dict] = None,
                       clip_skip: Optional[int] = None):
        """Returns encode(generator, inputs) -> cond dict, with batched tower
        calls: the 3 prompt sets in one text pass, [zeros | image] in one
        vision pass, the VAE encodes in one pass (one posterior draw, as
        ``encode_conditioning``).

        inputs: person / pose / cloth (B, H, W, 3) in [-1, 1], mask
        (B, H, W, 1) in {0, 1} (1 = inpaint), ip_pixels (B, 224, 224, 3),
        and the token ids prompt_ids_* / neg_ids_* / cloth_ids_* (B, 77)
        for the two towers (``_l``, ``_g``); or, all or nothing, the embeds
        of ``encode_conditioning`` (prompt_embeds, pooled_prompt_embeds,
        negative_prompt_embeds, negative_pooled_prompt_embeds,
        cloth_prompt_embeds); optionally masked_image_latents."""
        m = self.models

        def encode(generator, inputs):
            if inputs.get("prompt_embeds") is not None:
                # the batched text pass needs all three slots, so embeds are
                # all or nothing here (per slot: encode_conditioning)
                need = ("pooled_prompt_embeds", "negative_prompt_embeds",
                        "negative_pooled_prompt_embeds",
                        "cloth_prompt_embeds")
                missing = [k for k in need if inputs.get(k) is None]
                if missing:
                    raise ValueError(
                        f"prompt_embeds passthrough via the staged encoder "
                        f"requires all of {need}; missing {missing}")
                prompt_embeds = inputs["prompt_embeds"]
                pooled_p = inputs["pooled_prompt_embeds"]
                neg_embeds = inputs["negative_prompt_embeds"]
                pooled_n = inputs["negative_pooled_prompt_embeds"]
                cloth_embeds = inputs["cloth_prompt_embeds"]
            else:
                with span("encode.text"):
                    ids_l = torch.cat([inputs["prompt_ids_l"],
                                       inputs["neg_ids_l"],
                                       inputs["cloth_ids_l"]], 0)
                    ids_g = torch.cat([inputs["prompt_ids_g"],
                                       inputs["neg_ids_g"],
                                       inputs["cloth_ids_g"]], 0)
                    embeds, pooled = encode_prompt_sdxl(m, ids_l, ids_g,
                                                        clip_skip=clip_skip)
                    prompt_embeds, neg_embeds, cloth_embeds = embeds.chunk(3)
                    pooled_p, pooled_n, _ = pooled.chunk(3)

            with span("encode.vision"):
                ip_pixels = inputs["ip_pixels"]
                vis = m.vision(torch.cat([torch.zeros_like(ip_pixels),
                                          ip_pixels]))
                ip = m.resampler(vis["penultimate"]).chunk(2)
            return self._cond(
                generator, person=inputs["person"], mask=inputs["mask"],
                pose=inputs["pose"], cloth=inputs["cloth"],
                masked_image_latents=inputs.get("masked_image_latents"),
                vae_sample=vae_sample, micro_conditioning=micro_conditioning,
                text=(prompt_embeds, pooled_p, neg_embeds, pooled_n,
                      cloth_embeds), ip=ip)

        return encode

    # -- stage 2: one denoise step --------------------------------------------

    def garment_features(self, cond: dict, t, *, impl=None):
        """GarmentNet on the cond batch only (B rows); ``t`` an int or a
        0-dim tensor on the device."""
        _, feats = self.models.garm(cond["cloth_lat"], t,
                                    cond["cloth_embeds"], impl=impl)
        return feats

    def _step(self, cond, latents, row, noise, feats=None, blend=None, *,
              guidance_scale: float, guidance_rescale: float, impl):
        """One step from ``row``, a (TABLE_COLS,) fp32 row of the
        schedule's ``step_table`` on the latents' device: GarmentNet (unless
        ``feats``), TryonNet (CFG batch 2B), CFG, the DDPM step with
        ``noise``, and the inpaint blend when ``blend`` = (image latents,
        noise). Reads nothing from the host: the eager loop runs it, and a
        CUDA graph captures it."""
        m = self.models
        t = row[COL_T]
        if feats is None:
            feats = self.garment_features(cond, t, impl=impl)
        two = lambda x: torch.cat([x, x], 0)
        unet_in = torch.cat([two(latents), two(cond["mask_lat"]),
                             two(cond["masked_lat"]), two(cond["pose_lat"])],
                            dim=-1)
        noise_pred, _ = m.unet(
            unet_in, t, cond["context"],
            added_cond=(cond["add_text_embeds"], cond["time_ids"]),
            garment_features=feats, garment_uncond_zero=True, impl=impl)
        uncond, condp = noise_pred.chunk(2)
        guided = classifier_free_guidance(uncond, condp, guidance_scale,
                                          guidance_rescale)
        new_latents, _ = self.scheduler.table_step(guided, row, latents,
                                                   noise)
        if blend is not None:
            new_latents = _blend(new_latents, *blend, cond["mask_lat"], row,
                                 self.scheduler)
        return new_latents

    def denoise_step(self, cond: dict, latents, t: int, prev_t: int,
                     generator: Optional[torch.Generator] = None, *,
                     guidance_scale: float = 2.0,
                     guidance_rescale: float = 0.0, feats_cfg=None,
                     step_noise=None, impl=None):
        """GarmentNet -> TryonNet (CFG batch 2B) -> CFG -> DDPM step, run
        eagerly. ``feats_cfg``: cached garment features
        (garment_cache="once"); ``step_noise``: injected DDPM variance
        noise, else drawn from ``generator``."""
        if step_noise is None:
            step_noise = torch.randn(latents.shape, generator=generator,
                                     device=latents.device,
                                     dtype=torch.float32).to(latents.dtype)
        row = torch.from_numpy(self.scheduler.step_table([t], [prev_t])[0])
        return self._step(cond, latents, row.to(latents.device), step_noise,
                          feats_cfg, guidance_scale=guidance_scale,
                          guidance_rescale=guidance_rescale, impl=impl)

    def step_graph(self, cond: dict, latents, *, feats=None, blend=None,
                   guidance_scale: float = 2.0,
                   guidance_rescale: float = 0.0, impl=None) -> StepGraph:
        """The pipeline's captured step for these tensors and options
        (``pipeline.graph``): made on first use, captured at its first
        step, dropped when the UNets' weights change."""
        body = functools.partial(self._step, guidance_scale=guidance_scale,
                                 guidance_rescale=guidance_rescale, impl=impl)
        key = graph_key(latents, cond, feats, blend,
                        impl=resolve(impl, latents),
                        guidance_scale=float(guidance_scale),
                        guidance_rescale=float(guidance_rescale),
                        prediction_type=self.scheduler.cfg.prediction_type)
        return self.graphs.get(
            weights_fingerprint(self.models.unet, self.models.garm), key,
            lambda: StepGraph(body, latents=latents, cond=cond, feats=feats,
                              blend=blend, table_cols=TABLE_COLS,
                              rows=self.scheduler.cfg.num_train_timesteps))

    def _loop(self, cond, lat, ts, prev_ts, *, generator, step_noise, feats,
              blend, guidance_scale, guidance_rescale, impl, callback,
              graph: bool):
        """The steps of ``ts``: eagerly, or replayed from the pipeline's
        captured step (``graph``). Each step's noise is drawn (or taken from
        ``step_noise``) before it runs; ``callback(pipeline, i, t,
        {"latents": lat})`` runs on the host after each step and may return
        {"latents": ...} to replace them."""
        dtype, dev = lat.dtype, lat.device
        next_ts = np.concatenate([ts[1:], [-1]])
        table = torch.from_numpy(
            self.scheduler.step_table(ts, prev_ts, next_ts)).to(dev)

        def noise_at(i):
            if step_noise is not None:
                return step_noise[i].to(dtype)
            return torch.randn(lat.shape, generator=generator, device=dev,
                               dtype=torch.float32).to(dtype)

        steps = None
        if graph:
            with span("graph.lookup"):
                steps = self.step_graph(cond, lat, feats=feats, blend=blend,
                                        guidance_scale=guidance_scale,
                                        guidance_rescale=guidance_rescale,
                                        impl=impl)
            steps.start(table, lat, cond, feats, blend)
        for i in range(len(ts)):
            if steps is not None:
                mode = "capture" if steps.graph is None else "replay"
                with span("serve.step", mode=mode):
                    steps.step(noise_at(i))
                lat = steps.lat
            else:
                with span("serve.step", mode="eager"):
                    lat = self._step(cond, lat, table[i], noise_at(i), feats,
                                     blend, guidance_scale=guidance_scale,
                                     guidance_rescale=guidance_rescale,
                                     impl=impl)
            if callback is not None:
                if steps is not None:
                    lat = lat.clone()
                out = callback(self, i, int(ts[i]), {"latents": lat}) or {}
                if "latents" in out:
                    lat = out["latents"]
                    if steps is not None:
                        steps.lat.copy_(lat)
        return steps.lat.clone() if steps is not None else lat

    def _denoise(self, generator, cond, *, latent_shape, num_steps,
                 guidance_scale, guidance_rescale, strength, dtype,
                 garment_cache, image_latents, inpaint_blend, init_noise,
                 step_noise, denoising_start, denoising_end, latents_in,
                 timesteps, impl, callback=None, graph: bool = False):
        if garment_cache not in ("every_step", "once"):
            raise ValueError(f"garment_cache {garment_cache!r}")
        denoising_start, denoising_end = check_denoising_range(
            denoising_start, denoising_end)
        sched = self.scheduler
        dtype = dtype or cond["masked_lat"].dtype
        dev = cond["masked_lat"].device
        if init_noise is None:
            init_noise = torch.randn(latent_shape, generator=generator,
                                     device=dev, dtype=torch.float32)
        init_noise = init_noise.to(dtype)
        ts, prev_ts = sched.timesteps_and_prev(
            num_steps, strength, denoising_start, denoising_end,
            custom_timesteps=timesteps)
        if len(ts) == 0:
            raise ValueError(f"strength {strength} / denoising_start "
                             f"{denoising_start} / end {denoising_end} "
                             f"leaves none of {num_steps} steps")
        if denoising_start is not None:
            start = latents_in if latents_in is not None else image_latents
            if start is None:
                raise ValueError("denoising_start requires latents_in (a "
                                 "predecessor's output) or image_latents")
            lat = start.to(dtype)
        elif strength >= 1.0:
            lat = init_noise * sched.init_noise_sigma
        else:
            if image_latents is None:
                raise ValueError("strength < 1 requires image_latents")
            lat = sched.add_noise(image_latents.to(dtype), init_noise,
                                  int(ts[0]))
        if inpaint_blend and image_latents is None:
            raise ValueError("inpaint_blend requires image_latents")
        feats = None
        if garment_cache == "once":
            # the middle of the schedule actually run
            feats = self.garment_features(cond, int(ts[len(ts) // 2]),
                                          impl=impl)
        blend = (image_latents.to(dtype), init_noise) if inpaint_blend \
            else None
        return self._loop(cond, lat, ts, prev_ts, generator=generator,
                          step_noise=step_noise, feats=feats, blend=blend,
                          guidance_scale=guidance_scale,
                          guidance_rescale=guidance_rescale, impl=impl,
                          callback=callback, graph=graph)

    def denoise(self, generator, cond: dict, *, latent_shape,
                num_steps: int = 30, guidance_scale: float = 2.0,
                guidance_rescale: float = 0.0, strength: float = 1.0,
                dtype=None, garment_cache: str = "every_step",
                image_latents=None, inpaint_blend: bool = False,
                init_noise=None, step_noise=None,
                denoising_start: Optional[float] = None,
                denoising_end: Optional[float] = None, latents_in=None,
                timesteps=None, impl=None):
        """The denoise loop, run eagerly; returns the final latents.

        ``garment_cache``: "every_step" runs GarmentNet each step
        (reference semantics); "once" computes its features at the middle
        timestep of the schedule run and reuses them. ``image_latents``
        (the person image's scaled VAE latents) start the loop from
        themselves noised to the first timestep when ``strength`` < 1, and
        feed ``inpaint_blend`` (after each step, the unmasked region is
        pinned to them noised to the next timestep). ``denoising_start`` /
        ``denoising_end`` (values outside (0, 1) ignored, start >= end
        raises) trim the schedule: with a start, strength is ignored and
        the loop starts, un-noised, from ``latents_in`` (a predecessor
        run's output with denoising_end = this start) or else
        ``image_latents``; chaining end = x then start = x equals the
        unsplit run. ``timesteps``: an explicit descending schedule.
        init_noise (B, h, w, 4) / step_noise (T, B, h, w, 4) replace the
        generator's draws (initial noise, then one a step)."""
        with torch.inference_mode():
            return self._denoise(
                generator, cond, latent_shape=latent_shape,
                num_steps=num_steps, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale, strength=strength,
                dtype=dtype, garment_cache=garment_cache,
                image_latents=image_latents, inpaint_blend=inpaint_blend,
                init_noise=init_noise, step_noise=step_noise,
                denoising_start=denoising_start,
                denoising_end=denoising_end, latents_in=latents_in,
                timesteps=timesteps, impl=impl)

    # -- stage 3: decode -------------------------------------------------------

    def decode(self, latents):
        images = self.models.vae.decode(latents)
        return images.clamp(-1.0, 1.0).to(latents.dtype)

    # -- the whole generation -------------------------------------------------

    def _generate(self, generator, *, person, mask, pose, cloth,
                  prompt_ids_l=None, prompt_ids_g=None, neg_ids_l=None,
                  neg_ids_g=None, cloth_ids_l=None, cloth_ids_g=None,
                  ip_pixels=None, prompt_embeds=None,
                  pooled_prompt_embeds=None, negative_prompt_embeds=None,
                  negative_pooled_prompt_embeds=None,
                  cloth_prompt_embeds=None, masked_image_latents=None,
                  timesteps=None, eta: float = 0.0, num_steps: int = 30,
                  guidance_scale: float = 2.0, guidance_rescale: float = 0.0,
                  strength: float = 1.0, garment_cache: str = "every_step",
                  inpaint_blend: bool = False, init_noise=None,
                  step_noise=None, vae_sample: bool = True, impl=None,
                  micro_conditioning: Optional[dict] = None,
                  num_images_per_prompt: int = 1,
                  clip_skip: Optional[int] = None,
                  denoising_start: Optional[float] = None,
                  denoising_end: Optional[float] = None, latents_in=None,
                  output_type: str = "image",
                  phase_seconds: Optional[dict] = None, graph: bool = False):
        denoise_kw = dict(
            num_steps=num_steps, guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale, strength=strength,
            garment_cache=garment_cache, inpaint_blend=inpaint_blend,
            init_noise=init_noise, step_noise=step_noise,
            denoising_start=denoising_start, denoising_end=denoising_end,
            latents_in=latents_in, timesteps=timesteps, impl=impl)
        with span("serve.request"):
            with _phase("encode", phase_seconds, person.device):
                cond = self.encode_conditioning(
                    generator, person=person, mask=mask, pose=pose,
                    cloth=cloth, prompt_ids_l=prompt_ids_l,
                    prompt_ids_g=prompt_ids_g, neg_ids_l=neg_ids_l,
                    neg_ids_g=neg_ids_g, cloth_ids_l=cloth_ids_l,
                    cloth_ids_g=cloth_ids_g, ip_pixels=ip_pixels,
                    vae_sample=vae_sample,
                    micro_conditioning=micro_conditioning,
                    clip_skip=clip_skip, prompt_embeds=prompt_embeds,
                    pooled_prompt_embeds=pooled_prompt_embeds,
                    negative_prompt_embeds=negative_prompt_embeds,
                    negative_pooled_prompt_embeds=(
                        negative_pooled_prompt_embeds),
                    cloth_prompt_embeds=cloth_prompt_embeds,
                    masked_image_latents=masked_image_latents)
                image_latents = self._image_latents(
                    generator, person, num_images_per_prompt, vae_sample,
                    denoise_kw)
            return self._finish(
                generator, cond, person, image_latents, phase_seconds,
                num_images_per_prompt=num_images_per_prompt,
                output_type=output_type, graph=graph, **denoise_kw)

    def _image_latents(self, generator, person, n, vae_sample, denoise_kw):
        """The person image's latents, each row repeated ``n`` times, when
        ``strength`` < 1, ``inpaint_blend`` or ``denoising_start`` needs
        them; else None."""
        start, _ = check_denoising_range(denoise_kw["denoising_start"],
                                         denoise_kw["denoising_end"])
        if not (denoise_kw["strength"] < 1.0 or denoise_kw["inpaint_blend"]
                or start is not None):
            return None
        with span("encode.vae"):
            return self.models.vae.encode(
                person, generator, sample=vae_sample).repeat_interleave(n, 0)

    def _finish(self, generator, cond, person, image_latents, phase_seconds,
                *, num_images_per_prompt, output_type, graph, **denoise_kw):
        """A request from its conditioning and the person image's latents
        on: ``replicate_cond`` and the denoise loop, then the decode, each
        phase a span (``_phase``)."""
        m = self.models
        n = num_images_per_prompt
        b, img_h, img_w, _ = person.shape
        ds = m.vae_cfg.downscale
        with _phase("denoise", phase_seconds, person.device):
            latents = self._denoise(
                generator, replicate_cond(cond, n),
                latent_shape=(b * n, img_h // ds, img_w // ds,
                              m.vae_cfg.latent_channels),
                dtype=person.dtype, image_latents=image_latents, graph=graph,
                **denoise_kw)
        if output_type == "latent":
            return latents
        with _phase("decode", phase_seconds, person.device):
            return self.decode(latents)

    def generate(self, generator, **kw):
        """The whole generation, run eagerly: ``encode_conditioning``,
        ``replicate_cond``, the person image's latents (drawn only when
        ``strength`` < 1, ``inpaint_blend`` or ``denoising_start`` is set),
        ``denoise`` and ``decode``. Takes ``encode_conditioning``'s inputs
        and ``denoise``'s options, and ``num_images_per_prompt`` (injected
        noises must have B * n rows), ``output_type`` ("image", or "latent"
        for the raw latents a successor run takes as ``latents_in``),
        ``phase_seconds`` (a dict for the encode / denoise / decode wall
        times, each phase ending in a device synchronize) and ``eta``,
        which DDPM ignores. A request is the span ``serve.request``
        (``utils.profiling``), its phases ``serve.encode`` /
        ``serve.denoise`` / ``serve.decode``. Returns images (B * n, H,
        W, 3) in [-1, 1].

        The generator gives, in this order: ``encode_conditioning``'s VAE
        posterior sample, the person image's, the initial noise, then one
        draw a step; injected noises take their draws' place."""
        with torch.inference_mode():
            return self._generate(generator, **kw)

    def jit_generate(self, *, num_steps: int = 30,
                     guidance_scale: float = 2.0,
                     guidance_rescale: float = 0.0, strength: float = 1.0,
                     inpaint_blend: bool = False, vae_sample: bool = True,
                     impl=None, donate: bool = False,
                     micro_conditioning: Optional[dict] = None,
                     num_images_per_prompt: int = 1,
                     clip_skip: Optional[int] = None,
                     denoising_start: Optional[float] = None,
                     denoising_end: Optional[float] = None,
                     output_type: str = "image", timesteps=None,
                     garment_cache: str = "every_step"):
        """Returns fn(generator, *, init_noise=None, step_noise=None,
        latents_in=None, phase_seconds=None, **inputs) -> ``generate``'s
        result with these options, the same draws in the same order. On a
        CUDA input every step is replayed from the pipeline's captured step
        (``pipeline.graph``; a failure to capture or replay raises); the
        encode and decode run eagerly, once a request. On a CPU input the
        loop runs eagerly. ``donate`` is accepted as JAX's and has no
        effect."""
        opts = dict(num_steps=num_steps, guidance_scale=guidance_scale,
                    guidance_rescale=guidance_rescale, strength=strength,
                    inpaint_blend=inpaint_blend, vae_sample=vae_sample,
                    impl=impl, micro_conditioning=micro_conditioning,
                    num_images_per_prompt=num_images_per_prompt,
                    clip_skip=clip_skip, denoising_start=denoising_start,
                    denoising_end=denoising_end, output_type=output_type,
                    timesteps=timesteps, garment_cache=garment_cache)

        @torch.inference_mode()
        def fn(generator, **inputs):
            return self._generate(generator, graph=inputs["person"].is_cuda,
                                  **opts, **inputs)

        return fn

    # -- the serving entry point -----------------------------------------------

    def stepwise_generate(self, *, num_steps: int = 30,
                          guidance_scale: float = 2.0,
                          guidance_rescale: float = 0.0,
                          strength: float = 1.0,
                          garment_cache: str = "every_step",
                          inpaint_blend: bool = False,
                          vae_sample: bool = True, impl=None,
                          micro_conditioning: Optional[dict] = None,
                          num_images_per_prompt: int = 1,
                          clip_skip: Optional[int] = None,
                          denoising_start: Optional[float] = None,
                          denoising_end: Optional[float] = None,
                          callback_on_step_end=None,
                          output_type: str = "image", timesteps=None):
        """Returns fn(generator, *, init_noise=None, step_noise=None,
        latents_in=None, phase_seconds=None, **inputs) -> images (B * n, H,
        W, 3) in [-1, 1], or the latents for ``output_type="latent"``.

        The staged encoder (batched tower calls), then the steps, then the
        decode; the options are ``generate``'s. On a CUDA input every step
        is replayed from the pipeline's captured step (``pipeline.graph``;
        a failure raises), on a CPU input it runs eagerly.
        ``callback_on_step_end(pipeline, i, t, {"latents": lat})`` runs on
        the host after each step; a returned {"latents": ...} replaces
        them. ``strength`` < 1 runs the last int(num_steps * strength)
        steps from the person image's latents noised to the first of them.
        init_noise (B * n, h, w, 4) / step_noise (T, B * n, h, w, 4), T the
        steps run, replace the generator's draws; ``latents_in`` starts a
        ``denoising_start`` run. A ``phase_seconds`` dict receives the
        encode / denoise / decode wall times (each phase ends in a device
        synchronize). The spans are ``generate``'s, each step a
        ``serve.step`` whose ``mode`` is "replay", "capture" or "eager".

        The generator gives, in this order: the staged encoder's VAE
        posterior sample, the person image's (when ``strength`` < 1,
        ``inpaint_blend`` or ``denoising_start``), the initial noise, then
        one draw a step."""
        if garment_cache not in ("every_step", "once"):
            raise ValueError(f"garment_cache {garment_cache!r}")
        encode = self.staged_encoder(vae_sample=vae_sample,
                                     micro_conditioning=micro_conditioning,
                                     clip_skip=clip_skip)
        # the schedule's errors at build time, as JAX's
        denoising_start, denoising_end = check_denoising_range(
            denoising_start, denoising_end)
        if len(self.scheduler.timesteps(
                num_steps, strength, denoising_start, denoising_end,
                custom_timesteps=timesteps)) == 0:
            raise ValueError(f"strength {strength} / denoising_start "
                             f"{denoising_start} / end {denoising_end} "
                             f"leaves none of {num_steps} steps")

        @torch.inference_mode()
        def fn(generator, *, init_noise=None, step_noise=None,
               latents_in=None, phase_seconds: Optional[dict] = None,
               **inputs):
            person = inputs["person"]
            denoise_kw = dict(
                num_steps=num_steps, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale, strength=strength,
                garment_cache=garment_cache, inpaint_blend=inpaint_blend,
                init_noise=init_noise, step_noise=step_noise,
                denoising_start=denoising_start,
                denoising_end=denoising_end, latents_in=latents_in,
                timesteps=timesteps, impl=impl)
            with span("serve.request"):
                with _phase("encode", phase_seconds, person.device):
                    cond = encode(generator, inputs)
                    image_latents = self._image_latents(
                        generator, person, num_images_per_prompt,
                        vae_sample, denoise_kw)
                return self._finish(
                    generator, cond, person, image_latents, phase_seconds,
                    num_images_per_prompt=num_images_per_prompt,
                    output_type=output_type, graph=person.is_cuda,
                    callback=callback_on_step_end, **denoise_kw)

        return fn
