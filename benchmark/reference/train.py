"""The reference's training step of TryonNet and the Resampler (IDM-VTON
``train_xl.py``'s loop body): the frozen towers' encodes, the DDPM
noise-prediction MSE, its gradient with respect to fp32 masters, and the
8-bit AdamW update (``optim.AdamW8bit``), in fp32 with TF32 off.

The batch is taken in blocks of rows (each row's work is independent of
the others': GroupNorm, attention and the loss are per sample), so the
fp32 activations of the whole batch never live at once; the gradients of
the blocks are summed. ``fault`` plants a fault where the step produces
its answer: ``"half_batch"`` takes the loss over the first half of the
rows only, ``"loss_x1.05"`` scales the loss by 1.05."""

from __future__ import annotations

import torch

from benchmark.reference import stack as ref
from benchmark.reference.optim import AdamW8bit
from benchmark.reference.scheduler import DDPM

TRAINED = ("unet", "resampler")
# batch rows a block: one, so the fp32 activations of a single row live
# at once whatever the batch
ROWS_PER_BLOCK = 1


def row_losses(W, stack, sched: DDPM, batch, vae_noise, rows, remat=True):
    """Per-row losses of batch rows ``rows`` (a list of indices)."""
    f = lambda k: batch[k][rows].float()
    b = batch["person"].shape[0]
    hh, ww = batch["person"].shape[1:3]
    with torch.no_grad():
        person, mask = f("person"), f("mask")
        masked = person * (mask < 0.5).float()
        noise4 = torch.cat([vae_noise[[j * b + r for r in rows]]
                            for j in range(4)])
        z = ref.vae_encode(W.sub("vae"), stack["vae"],
                           torch.cat([person, masked, f("pose"), f("cloth")]),
                           noise4)
        model_input, masked_lat, pose_lat, cloth_lat = z.chunk(4)
        lh, lw = model_input.shape[1:3]
        mask_lat = ref.resize_nearest(mask, (lh, lw))

        def text(kl, kg):
            pen_l, _ = ref.clip_text(W.sub("clip_l"), stack["clip_l"],
                                     batch[kl][rows])
            pen_g, pooled = ref.clip_text(W.sub("clip_g"), stack["clip_g"],
                                          batch[kg][rows])
            return torch.cat([pen_l, pen_g], -1), pooled

        prompt, pooled = text("prompt_ids_l", "prompt_ids_g")
        cloth_embeds, _ = text("cloth_ids_l", "cloth_ids_g")
        vis = ref.clip_vision_penultimate(W.sub("vision"), stack["vision"],
                                          f("ip_pixels"))
        t_host = batch["timesteps"][rows].cpu().numpy()
        t = batch["timesteps"][rows]
        noise = f("noise")
        noisy = sched.add_noise(model_input, noise, t_host)
        feats = ref.unet(W.sub("garm"), stack["garm"], cloth_lat, t,
                         cloth_embeds)
    ip = ref.resampler(W.sub("resampler"), stack["resampler"], vis)
    context = torch.cat([prompt, ip], 1)
    unet_in = torch.cat([noisy, mask_lat, masked_lat, pose_lat], -1)
    time_ids = torch.tensor([[hh, ww, 0, 0, hh, ww]] * len(rows),
                            dtype=torch.float32, device=noise.device)
    pred = ref.unet(W.sub("unet"), stack["unet"], unet_in, t, context,
                    added_cond=(pooled, time_ids), garment_features=feats,
                    remat=remat)
    return (pred - noise).square().mean(dim=(1, 2, 3))


def follow(flat: dict, config: dict, batches, *, fault=None):
    """The reference's first ``len(batches)`` steps from the weights
    ``flat`` (the trained leaves' masters start as their fp32 values).
    ``batches``: [(batch, vae_noise)]. Returns the losses, the first
    step's gradient norm a leaf as the optimizer gets it (after the clip
    by global norm), and the norm of each leaf's change after the
    steps."""
    stack = config["stack"]
    sched = DDPM(config["scheduler"])
    masters = {n: t.float().clone().requires_grad_()
               for n, t in flat.items() if n.split(".")[0] in TRAINED}
    start = {n: t for n, t in flat.items() if n in masters}
    W = ref.Root(dict(flat, **masters))
    opt = AdamW8bit(config["optimizer"])
    losses, first_grad = [], None
    for batch, vae_noise in batches:
        b = batch["person"].shape[0]
        use = b // 2 if fault == "half_batch" else b
        scale = 1.05 if fault == "loss_x1.05" else 1.0
        total = 0.0
        for r0 in range(0, use, ROWS_PER_BLOCK):
            rows = list(range(r0, min(r0 + ROWS_PER_BLOCK, use)))
            lr = row_losses(W, stack, sched, batch, vae_noise, rows,
                            remat=config.get("remat", True))
            (lr.sum() * scale / use).backward()
            total += float(lr.sum().detach()) * scale / use
        losses.append(total)
        grads = {n: p.grad for n, p in masters.items()}
        with torch.no_grad():
            opt.step_(masters, grads)
        if first_grad is None:    # step_ clipped the gradients in place
            first_grad = {n: float(g.norm()) for n, g in grads.items()}
        for p in masters.values():
            p.grad = None
    with torch.no_grad():
        change = {n: float((p - start[n].float()).norm())
                  for n, p in masters.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
