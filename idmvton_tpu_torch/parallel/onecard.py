"""Two ranks sharing one card: the parallel paths at full width against
their single-process versions (the rank side of the two-rank tests of
``tests/test_torch_cuda.py``, run through ``parallel.dryrun.spawn``).

NCCL refuses two ranks on one device, so these ranks take the backend
their caller names: gloo, whose collectives take CUDA tensors (staged
through the host), or NCCL where it accepts. One card shows that the
parallel paths compute the single-process function and launch the
kernels the code routes them to; it cannot show scaling.

- ``denoise_ranks``: the full-width ``sdxl_tryon`` TryonNet and
  ``sdxl_garment`` GarmentNet (random weights from a seed, random biases
  and norm affines) take one denoise step (GarmentNet, TryonNet over the
  CFG batch, the guidance) on seeded inputs: once single-process
  (``impl="cuda"``), then under SP=2 (the rows gathered), then under TP=2;
  each parallel step's launches are counted alone.
- ``train_ranks``: a micro-stack train step at dp=2, replicated and with
  ZeRO-1 (adamw), and with ZeRO-1 under adamw8bit (the kernel on each
  rank's block range on the card).
- ``pipeline_ranks``: ViT-H (32 layers, full width, bf16) in 2 stages x 2
  microbatches against the sequential forward over the same microbatches.
"""

from __future__ import annotations

import torch

from idmvton_tpu_torch.ops.dispatch import launch_counters

# random biases ~ N(0, AFFINE_STD^2), norm scales ~ 1 + N(0, AFFINE_STD^2)
AFFINE_STD = 0.1
LATENT_HW = (128, 96)        # 1024 x 768 images (the tiny rehearsal: 16 x 16)
TEXT_TOKENS = 77
STEP_T = 999
GUIDANCE = 2.0


def random_affine_(module, seed: int):
    """Overwrites every bias (of the layers that have one) with N(0,
    AFFINE_STD^2) and every norm's scale with 1 + N(0, AFFINE_STD^2), from
    ``seed``, in place, each draw rounded through bf16 (what a bf16 load of
    any checkpoint gives the fp32 norm parameters)."""
    from idmvton_tpu_torch.models.layers import Norm
    p0 = next(module.parameters())
    gen = torch.Generator(device=p0.device).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            for name, p in m.named_parameters(recurse=False):
                if name not in ("bias", "scale") or p is None:
                    continue
                if name == "scale" and not isinstance(m, Norm):
                    continue
                r = torch.randn(p.shape, generator=gen, device=p.device)
                r.mul_(AFFINE_STD)
                if name == "scale":
                    r.add_(1.0)
                p.copy_(r.bfloat16())


def _counting(wrappers, fn):
    """``fn()``'s result and the launches it made."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {k: w.launches for k, w in wrappers.items()}


def _readings(got, want):
    """(max rel, mean rel): max |diff| / max |want|, mean |diff| / mean
    |want|; inf where ``got`` is not finite."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    d = (got - want).abs()
    return (float(d.max() / want.abs().max()),
            float(d.mean() / want.abs().mean()))


def step_inputs(unet_cfg, garm_cfg, dev, seed: int, hw=LATENT_HW,
                dtype=torch.bfloat16) -> dict:
    """Seeded inputs of one full-width CFG denoise step at batch 2: the
    13-channel TryonNet input and its context ([text | IP tokens]), pooled
    text and time ids for the [uncond | cond] batch of 4, GarmentNet's
    garment latents and text context for the cond batch of 2."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dtype
    b, (lh, lw) = 2, hw
    rn = lambda *s: torch.randn(s, generator=g, device=dev).to(bf)
    mask = (torch.rand(b, lh, lw, 1, generator=g, device=dev) > 0.5).to(bf)
    unet_in = torch.cat([rn(b, lh, lw, 4), mask, rn(b, lh, lw, 4),
                         rn(b, lh, lw, 4)], -1)
    ctx_dim = unet_cfg.cross_attention_dim
    context = torch.cat([rn(2 * b, TEXT_TOKENS, ctx_dim),
                         rn(2 * b, unet_cfg.ip_num_tokens, ctx_dim)], 1)
    pooled_dim = (unet_cfg.projection_class_embeddings_input_dim
                  - 6 * unet_cfg.addition_time_embed_dim)
    h, w = 8 * lh, 8 * lw
    return dict(unet_in=torch.cat([unet_in, unet_in]), context=context,
                pooled=rn(2 * b, pooled_dim),
                time_ids=torch.tensor([[h, w, 0, 0, h, w]], dtype=bf,
                                      device=dev).expand(2 * b, 6),
                garm_lat=rn(b, lh, lw, garm_cfg.in_channels),
                garm_ctx=rn(b, TEXT_TOKENS, garm_cfg.cross_attention_dim))


def guided_step(unet, garm, inp, *, impl=None):
    """GarmentNet's features of the cond batch, TryonNet over [uncond |
    cond] (the uncond rows see zero garment K/V), the guided noise
    prediction."""
    from idmvton_tpu_torch.diffusion.scheduler import (
        classifier_free_guidance,
    )
    _, feats = garm(inp["garm_lat"], STEP_T, inp["garm_ctx"], impl=impl)
    pred, _ = unet(inp["unet_in"], STEP_T, inp["context"],
                   added_cond=(inp["pooled"], inp["time_ids"]),
                   garment_features=feats, garment_uncond_zero=True,
                   impl=impl)
    return classifier_free_guidance(*pred.chunk(2), GUIDANCE)


def denoise_ranks(rank, world, seed: int, device="cuda", tiny=False,
                  dtype=torch.bfloat16):
    """One full-width denoise step single-process, under SP=2 and under
    TP=2 on this rank (see the module docstring). Returns the readings of
    each parallel step against the single-process one and each step's
    launches. ``tiny``: the tiny UNets at 16 x 16
    latents (on the CPU in fp32, ``device="cpu", dtype=torch.float32``:
    the parallel steps' arithmetic against the single-process one's)."""
    from idmvton_tpu_torch.models.unet import UNet
    from idmvton_tpu_torch.parallel.mesh import make_mesh
    from idmvton_tpu_torch.parallel.sp import (
        gather, shard_latent, shard_spatial, spatial_axis,
    )
    from idmvton_tpu_torch.parallel.tp import shard_unet_params
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.models.layers import reset_parameters_
    dev = torch.device(device)
    wrappers = launch_counters()
    u_cfg, g_cfg = TryonModels.configs(tiny=tiny)[:2]
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"backend": torch.distributed.get_backend()}
    with torch.inference_mode():
        unet = UNet(u_cfg, device=dev, dtype=dtype)
        garm = UNet(g_cfg, device=dev, dtype=dtype)
        for i, m in enumerate((unet, garm)):
            reset_parameters_(m, gen)
            random_affine_(m, seed + 10 + i)
        inp = step_inputs(u_cfg, g_cfg, dev, seed + 1,
                          (16, 16) if tiny else LATENT_HW, dtype)
        mesh = make_mesh(data=1, model=world)
        ref, out["single"] = _counting(
            wrappers, lambda: guided_step(unet, garm, inp))
        sp = spatial_axis(mesh)
        local = {k: shard_latent(v, mesh) if k in ("unet_in", "garm_lat")
                 else v for k, v in inp.items()}
        for m in (unet, garm):
            shard_spatial(m, sp)
        got, out["sp"] = _counting(
            wrappers, lambda: gather(guided_step(unet, garm, local), sp))
        out["sp_err"] = _readings(got, ref)
        for m in (unet, garm):
            shard_spatial(m, None)
        shard_unet_params(unet, mesh)
        shard_unet_params(garm, mesh)
        got, out["tp"] = _counting(
            wrappers, lambda: guided_step(unet, garm, inp))
        out["tp_err"] = _readings(got, ref)
    return out


def train_ranks(rank, world, seed: int, device="cuda", tiny=False) -> dict:
    """One micro-stack step at dp=``world`` (global batch 2 at 32x32, the
    draws from one seed): adamw replicated and with ZeRO-1, and adamw8bit
    with ZeRO-1. Each one's loss, gradient norm, updated masters (host
    copies) and the moment bytes this rank holds; adamw8bit's also the
    block range of its state and the kernel's launches."""
    from idmvton_tpu_torch.parallel.mesh import make_mesh
    from idmvton_tpu_torch.train import quant_opt
    del tiny    # the micro stack either way
    mesh = make_mesh()
    dev = torch.device(device)
    out = {}
    for name, zero1, opt in (("replicated", False, "adamw"),
                             ("zero1", True, "adamw"),
                             ("zero1_adamw8bit", True, "adamw8bit")):
        launches = quant_opt.adamw_int8_fused_.launches
        state, metrics = micro_step(dev, seed, mesh, zero1, opt)
        out[name] = _host(state, metrics)
        if opt == "adamw8bit":
            out[name]["blocks"] = state.zero1.blocks
            out[name]["launches"] = (quant_opt.adamw_int8_fused_.launches
                                     - launches)
    return out


def all_ranks(rank, world, seed: int, device="cuda", tiny=False) -> dict:
    """``denoise_ranks``, ``train_ranks`` and ``pipeline_ranks`` in turn,
    the card's cache emptied between them."""
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, fn in (("denoise", denoise_ranks), ("train", train_ranks),
                     ("pipeline", pipeline_ranks)):
        out[name] = fn(rank, world, seed, device, tiny)
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def micro_step(dev, seed: int, mesh=None, zero1: bool = False,
               optimizer: str = "adamw"):
    """The micro stack (random biases and norm affines), one ``optimizer``
    step on the global batch of 2 (this data rank's rows under
    ``mesh``)."""
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.parallel.dryrun import tiny_batch
    from idmvton_tpu_torch.parallel.mesh import shard_batch
    from idmvton_tpu_torch.parallel.zero import zero1_state_sharding
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.train_step import (
        init_train_state, make_optimizer, make_train_step,
    )
    models = TryonModels.init(seed, micro=True, device=dev,
                              dtype=torch.float32)
    for i, m in enumerate(models.components().values()):
        random_affine_(m, seed + 10 + i)
    tx = make_optimizer(optimizer=optimizer)
    state = init_train_state(models, tx)
    if zero1:
        state = zero1_state_sharding(state, mesh)
    batch = tiny_batch(models, 2, 32, 32, seed + 1)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    step = make_train_step(models, DDPMScheduler(SchedulerConfig.train()),
                           tx, compute_dtype=torch.float32, remat=False,
                           mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    return step(state, {k: torch.from_numpy(v).to(dev)
                        for k, v in batch.items()}, gen)


def _host(state, metrics) -> dict:
    from idmvton_tpu_torch.train.train_step import flat_params
    leaves = []

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                leaves.append(v)

    walk(state.opt_state)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in flat_params(state.trainable).items()},
            "mu": {k: v.cpu().numpy() for k, v in
                   state.opt_state.get("mu", {}).items()},
            "moment_bytes": sum(t.numel() * t.element_size()
                                for t in leaves)}


def pipeline_ranks(rank, world, seed: int, device="cuda", tiny=False,
                   batch: int = 4):
    """ViT-H through ``clip_vision_apply_pp`` on a (1, world) mesh, 2
    microbatches, against the same tower with its stack run sequentially
    over the same microbatch slices. Returns whether every output is equal
    bit for bit."""
    from idmvton_tpu_torch.core.config import CLIPVisionConfig
    from idmvton_tpu_torch.models.clip import CLIPVision, clip_vision_apply_pp
    from idmvton_tpu_torch.models.layers import ACTIVATIONS, reset_parameters_
    from idmvton_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device(device)
    cfg = CLIPVisionConfig.tiny() if tiny else CLIPVisionConfig.vit_h()
    gen = torch.Generator(device=dev).manual_seed(seed)
    tower = CLIPVision(cfg, device=dev)
    reset_parameters_(tower, gen)
    random_affine_(tower, seed + 10)
    px = (torch.rand(batch, cfg.image_size, cfg.image_size, 3, generator=gen,
                     device=dev) * 2 - 1).bfloat16()
    act = ACTIVATIONS[cfg.hidden_act]
    n_micro = 2

    def sequential(x, cap):
        outs, caps = [], []
        for xm in x.chunk(n_micro):
            for i, lyr in enumerate(tower.layers):
                if i == cap:
                    caps.append(xm)
                xm = lyr(xm, num_heads=cfg.num_heads, act=act, causal=False)
            outs.append(xm)
        return torch.cat(outs), torch.cat(caps)

    mesh = make_mesh(data=1, model=world)
    with torch.inference_mode():
        want = tower(px, stack_fn=sequential)
        got = clip_vision_apply_pp(tower, px, mesh=mesh, n_micro=n_micro)
    return {"equal": all(torch.equal(got[k], want[k]) for k in want)}


if __name__ == "__main__":
    raise SystemExit("run through tests/test_torch_cuda.py")
