"""Fine-tuning: DDPM noise-prediction MSE on TryonNet (+ Resampler), every
other tower frozen (counterpart of ``idmvton_tpu/train/train_step.py``;
the reference trains only the hacked UNet, its Resampler included, with
GarmentNet, the VAE and the text and image encoders frozen:
train_xl.py:389-394).

- The trainable parameters are fp32 masters (``TrainState.trainable``),
  cast to the compute type inside the loss: ``torch.func.functional_call``
  hands the modules fresh ``master.to(compute_dtype)`` tensors, so the
  kernels read this step's weights (never ``layers.kernel_weight``'s
  cached copies) and the casts are part of the autograd graph. The
  serving modules' own parameters are not read by a step.
- Remat (``UNet(..., remat=True)``: each resnet block and Transformer2D
  under ``torch.utils.checkpoint``) replaces JAX's ``jax.checkpoint``
  (train_xl.py:407-409's gradient checkpointing).
- The frozen towers run under ``torch.no_grad()``: no gradient reaches
  them, as none does in JAX, where they are not in ``trainable``.
- The optimizer copies optax's semantics (``make_optimizer``): AdamW(lr
  1e-5, b1 0.9, b2 0.999, wd 1e-2) after a global-norm clip of 1.0
  (train_xl.py:270-274, 283-286, 752), the int8-moment AdamW, Adafactor,
  and ``optax.MultiSteps`` gradient accumulation. Where JAX returns new
  arrays, the port updates the masters and the optimizer state in place:
  at full width one copy of the masters is 12 GB.
- Optional min-SNR-gamma loss weighting (train_xl.py:726-742).

Over several ranks (``make_train_step(mesh=...)``, ``parallel/``): each
rank takes its data rank's rows of the global batch and draws the VAE
sample, the noise and the timesteps for the whole global batch from the
shared generator, keeping its rows, as JAX draws them from one key and
shards them (dp ranks at a global batch equal one rank at that batch);
the gradients are averaged over the data group in buckets after the
backward (JAX's all-reduce; not ``DistributedDataParallel``, whose hooks
sit on module parameters, while the step differentiates masters through
``functional_call``); the loss is the global mean. Under tensor
parallelism (``parallel.tp.shard_unet_params`` before
``init_train_state``) the masters of split leaves are this rank's shards
and the clip norm counts each shard once; under ZeRO-1
(``parallel.zero.zero1_state_sharding``) each rank updates its slice of
the moments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
from idmvton_tpu_torch.models.layers import resize_nearest, weights_changed_
from idmvton_tpu_torch.parallel import mesh as _mesh
from idmvton_tpu_torch.parallel import zero as _zero
from idmvton_tpu_torch.pipeline.tryon import TryonModels, encode_prompt_sdxl
from idmvton_tpu_torch.train import quant_opt
from idmvton_tpu_torch.utils.profiling import span

TRAINABLE = ("unet", "resampler")


@dataclasses.dataclass
class TrainState:
    step: int                # micro-steps taken (one a train_step call)
    trainable: dict          # {"unet": {name: fp32}, "resampler": {...}}
    opt_state: dict          # make_optimizer's state (Optimizer.init)
    # set by parallel.zero.zero1_state_sharding: opt_state holds this
    # rank's slices of the moments
    zero1: Optional[_zero.Zero1] = None


def flat_params(trainable: dict) -> Dict[str, torch.Tensor]:
    """``{"unet": {n: t}, ...}`` -> ``{"unet.n": t, ...}``."""
    return {f"{c}.{n}": t for c in TRAINABLE for n, t in trainable[c].items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, fp32
    (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclasses.dataclass
class Parallel:
    """How a train step spreads over the mesh (``make_train_step(mesh=)``):
    the data axis (rows, averaged gradients), the model axis and the flat
    names of the leaves tensor parallelism split over it."""
    data: _mesh.Axis
    model: _mesh.Axis
    sharded: frozenset

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``global_norm`` of the whole leaves: a split leaf's squares
        summed over the model group, a replicated leaf's counted once."""
        rep = [g for k, g in grads.items() if k not in self.sharded]
        split = [g for k, g in grads.items() if k in self.sharded]
        sq = sum(t.float().square().sum() for t in rep)
        if split:
            part = sum(t.float().square().sum() for t in split)
            dist.all_reduce(part, group=self.model.group)
            sq = sq + part
        return torch.sqrt(sq)


# ---------------------------------------------------------------------------
# the optimizer (optax semantics, in place)
# ---------------------------------------------------------------------------


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax ``factorized._factored_dims``: the two largest axes (numpy's
    argsort order) when the second largest has at least 128 entries."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Optimizer:
    """``make_optimizer``'s transformation: optax.chain(clip_by_global_norm,
    inner) (optax ``_src/clipping.py``), wrapped as optax.MultiSteps for
    ``accum_steps > 1``. ``init(params)`` gives the state; ``update_(grads,
    state, params)`` updates ``state`` and ``params`` in place and returns
    whether the parameters moved (False mid-accumulation).

    adamw8bit on the card runs one kernel a step over every leaf
    (``quant_opt.adamw_int8_fused_``, its leaf table made once a parameter
    set and kept here); on the CPU, and for the other kinds, the plain
    per-leaf update."""

    def __init__(self, kind: str, learning_rate: float, weight_decay: float,
                 b1: float, b2: float, eps: float, max_grad_norm: float,
                 accum_steps: int):
        if kind not in ("adamw", "adamw8bit", "adafactor"):
            raise ValueError(kind)
        self.kind = kind
        self.lr, self.wd = learning_rate, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.accum_steps = accum_steps
        self._table = None    # quant_opt.LeafTable of the last masters

    def _inner_init(self, params):
        if self.kind == "adamw8bit":
            return quant_opt.init_state(params)
        if self.kind == "adamw":
            zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        # adafactor (optax ``factorized.scale_by_factored_rms.init_fn``)
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            dims = _factored_dims(p.shape)
            if dims is None:
                v[k] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                v_row[k] = torch.zeros(np.delete(p.shape, d0).tolist(),
                                       dtype=p.dtype, device=p.device)
                v_col[k] = torch.zeros(np.delete(p.shape, d1).tolist(),
                                       dtype=p.dtype, device=p.device)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        inner = self._inner_init(params)
        if self.accum_steps <= 1:
            return inner
        return {"mini_step": 0, "gradient_step": 0,
                "acc": {k: torch.zeros_like(p) for k, p in params.items()},
                "inner": inner}

    def _fused(self, params) -> Optional[quant_opt.LeafTable]:
        """adamw8bit on the card: the kernel's leaf table of ``params``,
        made again only for other masters; None where the plain update
        runs."""
        if self.kind != "adamw8bit" or not next(iter(params.values())).is_cuda:
            return None
        if self._table is None or (self._table.key
                                   != quant_opt.LeafTable.key_of(params)):
            self._table = None       # the old table's buffers go first
            self._table = quant_opt.LeafTable(params)
        return self._table

    @torch.no_grad()
    def global_norm(self, grads: Dict[str, torch.Tensor],
                    params: Dict[str, torch.Tensor],
                    parallel: Optional[Parallel] = None) -> torch.Tensor:
        """The global norm of ``grads`` (0-dim fp32): over tensor-parallel
        shards ``parallel.global_norm``; adamw8bit on the card the kernel's
        multi-tensor sum of squares; else ``global_norm``."""
        if parallel is not None and parallel.sharded:
            return parallel.global_norm(grads)
        table = self._fused(params)
        if table is not None:
            return quant_opt.fused_global_norm(table, grads)
        return global_norm(grads.values())

    @torch.no_grad()
    def update_(self, grads: Dict[str, torch.Tensor], state: dict,
                params: Dict[str, torch.Tensor], *,
                parallel: Optional[Parallel] = None,
                zero1: Optional[_zero.Zero1] = None,
                norm: Optional[torch.Tensor] = None) -> bool:
        """``parallel``: the clip norm over tensor-parallel shards;
        ``zero1``: ``state`` holds this rank's slices of the moments;
        ``norm``: ``global_norm(grads, params, parallel)`` where the caller
        has it (``train_step``'s ``grad_norm``), else computed here. The
        plain update turns ``grads`` into the updates in place; adamw8bit's
        kernel only reads them, and no caller reads them afterwards."""
        ctx = (parallel, zero1)
        if self.accum_steps <= 1:
            self._step(grads, state, params, *ctx, norm=norm)
            return True
        # optax.MultiSteps: a running mean of the micro-gradients, acc + (g
        # - acc) / (n + 1); the clip and the inner update once, at the
        # boundary, on the mean; zero updates before it
        n = state["mini_step"]
        for k, g in grads.items():
            acc = state["acc"][k]
            acc.add_((g - acc) / (n + 1))
        if n < self.accum_steps - 1:
            state["mini_step"] = n + 1
            return False
        self._step(state["acc"], state["inner"], params, *ctx)
        for acc in state["acc"].values():
            acc.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return True

    def _step(self, grads, state, params, parallel=None, zero1=None,
              norm=None):
        # optax.clip_by_global_norm: g if |g| < max, else g / |g| * max
        if norm is None:
            norm = self.global_norm(grads, params, parallel)
        with span("train.wait"):      # the host reads the norm
            small = bool(norm < self.max_grad_norm)
        clip = None if small else norm
        table = self._fused(params)   # adamw8bit's kernel clips as it reads
        if table is None and clip is not None:
            for g in grads.values():
                g.div_(norm).mul_(self.max_grad_norm)
        if zero1 is not None:
            _zero.update_(self, grads, state, params, zero1, table, clip)
            return
        if table is not None:
            self._adamw8bit_fused_(table, grads, state, params, clip)
            return
        getattr(self, f"_{self.kind}")(grads, state, params)
        for k, p in params.items():
            p.add_(grads[k])      # optax.apply_updates

    def _adamw(self, grads, state, params):
        """optax.adamw: scale_by_adam (eps_root 0), add_decayed_weights,
        scale_by_learning_rate (optax ``_src/alias.py``,
        ``_src/transform.py``)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        count = state["count"] + 1
        bc1, bc2 = quant_opt.bias_corrections(b1, b2, count)
        for k, g in grads.items():
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * g.square() + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            g.copy_((u + self.wd * params[k]) * -self.lr)
        state["count"] = count

    def _adamw8bit(self, grads, state, params):
        """JAX ``quant_opt.adamw_int8``: scale_by_adam_int8, then
        add_decayed_weights and scale(-lr)."""
        quant_opt.adam_int8_(grads, state, b1=self.b1, b2=self.b2,
                             eps=self.eps)
        for k, g in grads.items():
            g.copy_((g + self.wd * params[k]) * -self.lr)

    def _adamw8bit_fused_(self, table, grads, state, params, clip,
                          blocks=None):
        """``_adamw8bit`` and optax.apply_updates as one launch of
        adamw8bit's kernel over ``table``'s leaves: ``grads`` are only read,
        clipped by the global norm ``clip`` (None: not clipped); ``blocks``:
        the block range ZeRO-1 gives this rank's state."""
        quant_opt.adamw_int8_fused_(
            table, grads, params, state, b1=self.b1, b2=self.b2,
            eps=self.eps, weight_decay=self.wd, lr=self.lr, clip=clip,
            max_norm=self.max_grad_norm, blocks=blocks)

    def _adafactor(self, grads, state, params):
        """optax.adafactor(learning_rate) with its defaults:
        scale_by_factored_rms (factored for dims >= 128, decay 0.8, eps
        1e-30), clip_by_block_rms(1.0), scale by the learning rate,
        scale_by_param_block_rms (min 1e-3), scale(-1) (optax
        ``_src/alias.py``, ``_src/factorized.py``)."""
        count = state["count"]
        t = np.float32(count + 1)
        decay = np.float32(1.0) - t ** np.float32(-0.8)
        d, d_ = float(decay), float(np.float32(1.0) - decay)
        for k, g in grads.items():
            gsq = g.square() + 1e-30
            dims = _factored_dims(g.shape)
            if dims is not None:
                d1, d0 = dims
                v_row, v_col = state["v_row"][k], state["v_col"][k]
                v_row.copy_(d * v_row + d_ * gsq.mean(d0))
                v_col.copy_(d * v_col + d_ * gsq.mean(d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row.mean(reduced_d1, keepdim=True)
                row_factor = (v_row / row_col_mean) ** -0.5
                col_factor = v_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            else:
                v = state["v"][k]
                v.copy_(d * v + d_ * gsq)
                u = g * v ** -0.5
            u = u / torch.clamp(torch.sqrt(u.square().mean()) / 1.0, min=1.0)
            u = u * self.lr
            rms = torch.sqrt(params[k].square().mean())
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            g.copy_(u * -1)
        state["count"] = count + 1


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 1e-2,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: float = 1.0, optimizer: str = "adamw",
                   accum_steps: int = 1) -> Optimizer:
    """optimizer:
    - "adamw": fp32 moments (reference default, train_xl.py:421).
    - "adamw8bit": int8 block-quantized moments (``train/quant_opt.py``),
      the reference's bitsandbytes --use_8bit_adam analog
      (train_xl.py:412-420).
    - "adafactor": factored second moment, ``optax.adafactor``'s defaults
      (not ``torch.optim.Adafactor``, whose rule differs).

    accum_steps > 1: gradient accumulation (train_xl.py:265,491): the
    micro-gradients are averaged, then the clip and the update apply once
    at the boundary (``optax.MultiSteps``)."""
    return Optimizer(optimizer, learning_rate, weight_decay, b1, b2, eps,
                     max_grad_norm, accum_steps)


# ---------------------------------------------------------------------------
# the state, the loss, the step
# ---------------------------------------------------------------------------


def init_train_state(models: TryonModels, tx: Optimizer) -> TrainState:
    """fp32 masters of TryonNet's and the Resampler's parameters (copies:
    the serving modules keep theirs) and the optimizer's state."""
    trainable = {
        c: {n: p.detach().to(torch.float32, copy=True).requires_grad_()
            for n, p in getattr(models, c).named_parameters()}
        for c in TRAINABLE}
    return TrainState(step=0, trainable=trainable,
                      opt_state=tx.init(flat_params(trainable)))


@torch.no_grad()
def copy_to_models_(models: TryonModels, trainable: dict,
                    dtype=torch.bfloat16) -> TryonModels:
    """The masters into the serving modules, rounded through ``dtype`` as
    JAX's ``tree_map(astype(dtype))`` rounds every leaf (norm affines too),
    then ``weights_changed_``: a captured step is captured again and no
    cached bf16 copy is reused. For eval and checkpoints."""
    for c in TRAINABLE:
        module = getattr(models, c)
        for n, p in module.named_parameters():
            p.copy_(trainable[c][n].to(dtype))
        weights_changed_(module)
    return models


def tryon_loss(trainable: dict, models: TryonModels,
               scheduler: DDPMScheduler, batch: dict,
               generator: Optional[torch.Generator] = None, *,
               snr_gamma: Optional[float] = None,
               compute_dtype=torch.bfloat16, impl: Optional[str] = None,
               remat: bool = True, vae_sample: bool = True,
               data: Optional[_mesh.Axis] = None):
    """One training loss (reference loop body, train_xl.py:598-742).

    batch: person, mask, pose, cloth (B, H, W, C) in [-1, 1] / mask {0, 1};
    prompt_ids_l/g, cloth_ids_l/g; ip_pixels. Optional "noise" (B, lh, lw,
    4) fp32 and "timesteps" (B,) int override the in-loss draws (parity
    and accumulation tests), as in JAX. ``generator`` (on the batch's
    device) draws, in order: the VAE posteriors (one batched draw), the
    noise, the timesteps. ``data``: the batch is this data rank's rows;
    each draw is made for the global batch and this rank's rows kept."""
    m = models
    cd = compute_dtype
    params = {c: {n: t.to(cd) if t.dtype == torch.float32 else t
                  for n, t in trainable[c].items()} for c in TRAINABLE}
    person = batch["person"].to(cd)
    mask = batch["mask"].to(cd)
    b, h, w = person.shape[:3]
    dev = person.device
    n_data = 1 if data is None else data.size

    def rows(t, dim=0):
        """This data rank's rows of a draw made for the global batch."""
        return t if data is None else t.narrow(dim, data.rank * b, b)

    with torch.no_grad(), span("train.frozen"):
        # the frozen towers: no gradient reaches them
        masked = person * (mask < 0.5).to(cd)
        eps = None
        if data is not None and vae_sample and generator is not None:
            f, vc = m.vae.cfg.downscale, m.vae.cfg.latent_channels
            eps = rows(torch.randn((4, b * n_data, h // f, w // f, vc),
                                   generator=generator, device=dev,
                                   dtype=torch.float32), 1).reshape(
                4 * b, h // f, w // f, vc)
        model_input, masked_lat, pose_lat, cloth_lat = m.vae.encode(
            torch.cat([person, masked, batch["pose"].to(cd),
                       batch["cloth"].to(cd)]),
            generator, sample=vae_sample, noise=eps).chunk(4)
        lh, lw = model_input.shape[1:3]
        mask_lat = resize_nearest(mask, (lh, lw))
        prompt_embeds, pooled = encode_prompt_sdxl(
            m, batch["prompt_ids_l"], batch["prompt_ids_g"])
        cloth_embeds, _ = encode_prompt_sdxl(
            m, batch["cloth_ids_l"], batch["cloth_ids_g"])
        vis = m.vision(batch["ip_pixels"].to(cd))["penultimate"]

    # the trainable Resampler -> IP tokens after the text context
    ip_tokens = functional_call(m.resampler, params["resampler"], (vis,))
    context = torch.cat([prompt_embeds.to(cd), ip_tokens], dim=1)

    # noise and uniform timesteps (train_xl.py:619-627)
    noise = batch.get("noise")
    if noise is None:
        noise = rows(torch.randn((b * n_data,) + model_input.shape[1:],
                                 generator=generator, device=dev,
                                 dtype=torch.float32))
    noise = noise.to(dev, torch.float32)
    t = batch.get("timesteps")
    if t is None:
        t = rows(torch.randint(0, scheduler.cfg.num_train_timesteps,
                               (b * n_data,), generator=generator,
                               device=dev))
    with span("train.wait"):
        t_host = t.cpu()   # the scheduler's tables index on the host
    t = t.to(dev)
    noisy = scheduler.add_noise(model_input, noise.to(cd), t_host)
    unet_in = torch.cat([noisy, mask_lat, masked_lat, pose_lat], dim=-1)

    with torch.no_grad(), span("train.garment"):
        # GarmentNet: the cond batch only, no CFG zeros (train_xl.py:707-8)
        _, feats = m.garm(cloth_lat, t, cloth_embeds, impl=impl)

    time_ids = torch.tensor([h, w, 0, 0, h, w], dtype=cd,
                            device=dev)[None].expand(b, 6)
    with span("train.tryonnet"):
        pred, _ = functional_call(
            m.unet, params["unet"], (unet_in, t, context),
            dict(added_cond=(pooled, time_ids), garment_features=feats,
                 impl=impl, remat=remat))

    pt = scheduler.cfg.prediction_type
    if pt == "epsilon":
        target = noise
    elif pt == "v_prediction":
        target = scheduler.get_velocity(model_input, noise.to(cd),
                                        t_host).float()
    elif pt == "sample":
        # the reference subtracts the noise residual from the prediction
        # before comparing to the clean latents (train_xl.py:718-721)
        target = model_input.float()
        pred = pred.float() - noise
    else:
        raise ValueError(pt)

    per_example = (pred.float() - target).square().mean(dim=(1, 2, 3))
    if snr_gamma is not None:
        snr = scheduler.snr(t_host).to(dev)
        if pt == "v_prediction":
            # shift snr by +1 BEFORE both the min and the division
            # (train_xl.py:732-737 divides min(snr + 1, g) by snr + 1);
            # epsilon and sample use the plain snr
            snr_v = snr + 1.0
            weight = torch.clamp(snr_v, max=snr_gamma) / snr_v
        else:
            weight = (torch.clamp(snr, max=snr_gamma)
                      / torch.clamp(snr, min=1e-8))
        per_example = per_example * weight
    return per_example.mean()


def make_train_step(models: TryonModels, scheduler: DDPMScheduler,
                    tx: Optimizer, *, snr_gamma: Optional[float] = None,
                    compute_dtype=torch.bfloat16, impl: Optional[str] = None,
                    remat: bool = True, vae_sample: bool = True,
                    mesh=None):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``: one micro-step; with accumulation (``make_optimizer``
    accum_steps > 1) the parameters change only at its boundary. The state
    is updated in place and returned; metrics hold the loss and the global
    norm of this micro-step's gradients, as 0-dim fp32 tensors.

    ``mesh`` (``parallel.mesh.make_mesh``): ``batch`` is this data rank's
    rows (``shard_batch``) and ``generator`` is seeded alike on every
    rank; the gradients are averaged over the data group, the loss is the
    global mean, and a tensor-parallel TryonNet's shards and a ZeRO-1
    state's slices are updated as ``parallel/`` sets them.

    A step is the span ``train.step`` (``utils.profiling``) holding
    ``train.forward`` (``tryon_loss``: ``train.frozen``, the no-grad VAE
    and towers; ``train.wait``, the host read of the timesteps;
    ``train.garment``; ``train.tryonnet``), ``train.backward`` and
    ``train.optimizer`` (with the clip's host read of the norm,
    ``train.wait``)."""
    par = None
    if mesh is not None:
        par = Parallel(_mesh.mesh_axis(mesh, _mesh.DATA_AXIS),
                       _mesh.mesh_axis(mesh, _mesh.MODEL_AXIS),
                       frozenset(f"unet.{n}" for n in
                                 getattr(models.unet, "tp_sharded", ())))

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None):
        with span("train.step"):
            params = flat_params(state.trainable)
            with span("train.forward"):
                loss = tryon_loss(state.trainable, models, scheduler, batch,
                                  generator, snr_gamma=snr_gamma,
                                  compute_dtype=compute_dtype, impl=impl,
                                  remat=remat, vae_sample=vae_sample,
                                  data=None if par is None else par.data)
            with span("train.backward"):
                vjps = torch.autograd.grad(loss, list(params.values()),
                                           allow_unused=True)
                # a parameter the loss does not read gets a zero gradient,
                # as in JAX
                grads = {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(params.items(), vjps)}
            loss = loss.detach()
            if par is not None:
                _mesh.all_reduce_mean_(list(grads.values()) + [loss],
                                       par.data)
            with span("train.optimizer"):
                gnorm = tx.global_norm(grads, params, par)
                tx.update_(grads, state.opt_state, params, parallel=par,
                           zero1=state.zero1, norm=gnorm)
            state.step += 1
            return state, {"loss": loss, "grad_norm": gnorm}

    return train_step
