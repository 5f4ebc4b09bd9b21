"""Rank functions of the port's parallel tests (``test_torch_parallel.py``),
run by ``idmvton_tpu_torch.parallel.dryrun.spawn`` in fresh processes.

This module imports only numpy, torch and the port (never JAX or a test
module), so a spawned rank loads none of them. Each function takes numpy
inputs made by the test (parameter trees exported from JAX, batches) and
returns numpy results; every rank computes, rank 0's result is read
unless a test reads them all.
"""

import contextlib
import io

import numpy as np
import torch

from idmvton_tpu_torch.core.config import (
    CLIPTextConfig, CLIPVisionConfig, SchedulerConfig, UNetConfig,
)
from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
from idmvton_tpu_torch.models.clip import (
    CLIPText, CLIPVision, clip_text_apply_pp, clip_vision_apply_pp,
)
from idmvton_tpu_torch.models.layers import ACTIVATIONS, reset_parameters_
from idmvton_tpu_torch.models.unet import UNet
from idmvton_tpu_torch.parallel import pp, zero
from idmvton_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, make_mesh, mesh_axis, replicate_params,
    shard_batch,
)
from idmvton_tpu_torch.parallel.sp import (
    shard_latent, shard_spatial, spatial_axis,
)
from idmvton_tpu_torch.parallel.tp import shard_unet_params
from idmvton_tpu_torch.pipeline.tryon import TryonModels
from idmvton_tpu_torch.train.train_step import (
    flat_params, init_train_state, make_optimizer, make_train_step,
)
from idmvton_tpu_torch.weights.checkpoint import save_train_state
from idmvton_tpu_torch.weights.from_jax import (
    load_jax_params, load_module_params,
)

F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return tree


def _coords(mesh):
    return (mesh_axis(mesh, DATA_AXIS).rank, mesh_axis(mesh, MODEL_AXIS).rank)


# ---------------------------------------------------------------------------
# tensor and spatial parallelism (UNet forwards)
# ---------------------------------------------------------------------------


def unet_parallel(rank, world, tree, x, ctx, pooled, tids):
    """On a (2, 2) mesh: the tiny "none" UNet on H-sharded ``x`` (SP), a
    random tiny GarmentNet's emitted features under dp=2 x sp=2, then the
    same UNet tensor-parallel on this data rank's rows (TP)."""
    cfg = UNetConfig.tiny("none", in_channels=4, ip_adapter=False)
    unet = load_module_params(UNet(cfg, dtype=F32), tree)
    mesh = make_mesh(data=2, model=2)
    sp = spatial_axis(mesh)
    ctx_d, pooled_d, tids_d, x_d = shard_batch(
        (_t(ctx), _t(pooled), _t(tids), _t(x)), mesh)
    out = {"coords": _coords(mesh)}
    with torch.no_grad():
        out["sp"] = shard_spatial(unet, sp)(
            shard_latent(_t(x), mesh), 300, ctx_d,
            added_cond=(pooled_d, tids_d))[0]
        shard_spatial(unet, None)
        ecfg = UNetConfig.tiny("emit")
        emit = UNet(ecfg, dtype=F32)
        reset_parameters_(emit, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(5)
        xe = _t(rng.standard_normal((2, 16, 8, 4)).astype(np.float32))
        ce = _t(rng.standard_normal((2, 7, ecfg.cross_attention_dim))
                .astype(np.float32))
        _, feats = shard_spatial(emit, sp)(shard_latent(xe, mesh), 5,
                                           shard_batch(ce, mesh))
        out["emit"] = (len(feats), ecfg.num_garment_features,
                       all(bool(torch.isfinite(f).all()) for f in feats))
        out["tp"] = shard_unet_params(unet, mesh)(
            x_d, 300, ctx_d, added_cond=(pooled_d, tids_d))[0]
    return _np(out)


# ---------------------------------------------------------------------------
# training: data parallelism, ZeRO-1, tensor parallelism
# ---------------------------------------------------------------------------


def _bytes(tree) -> int:
    """The bytes of every tensor in a nested dict."""
    return sum(_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size()
               if isinstance(v, torch.Tensor) else 0 for v in tree.values())


def _micro(tree):
    tm = TryonModels.init(None, micro=True, device="cpu", dtype=F32)
    return load_jax_params(tm, tree)


def _train(tm, tx, batch, mesh, zero1=False):
    step = make_train_step(tm, DDPMScheduler(SchedulerConfig.train()), tx,
                           compute_dtype=F32, remat=False, vae_sample=False,
                           mesh=mesh)
    state = init_train_state(tm, tx)
    formula = (zero.opt_state_bytes_per_device(state, mesh),
               _bytes(state.opt_state))
    if zero1:
        state = zero.zero1_state_sharding(state, mesh)
    state, metrics = step(state, {k: _t(v) for k, v in
                                  shard_batch(batch, mesh).items()})
    return state, metrics, formula


def train_parallel(rank, world, tree, batch, state_dir):
    """Four ranks: adamw replicated and ZeRO-1 at dp=4 (the ZeRO state
    gathered and saved by rank 0 into ``state_dir``), adamw8bit replicated
    and ZeRO-1 at dp=4, then a dp=2 x tp=2 adamw step."""
    mesh = make_mesh()
    out = {}
    tm = _micro(tree)
    for opt in ("adamw", "adamw8bit"):
        for z in (False, True):
            tx = make_optimizer(optimizer=opt)
            state, metrics, formula = _train(tm, tx, batch, mesh, zero1=z)
            key = f"{opt}{'_zero1' if z else ''}"
            out[key] = {"loss": metrics["loss"],
                        "grad_norm": metrics["grad_norm"],
                        "params": flat_params(state.trainable),
                        "resident": _bytes(state.opt_state),
                        "formula": formula[0], "whole": formula[1]}
            if z and opt == "adamw":
                whole = zero.gather_state(state)
                if rank == 0:
                    save_train_state(state_dir, whole)
                torch.distributed.barrier()
    tp_mesh = make_mesh(data=world // 2, model=2)
    shard_unet_params(tm.unet, tp_mesh)
    state, metrics, _ = _train(tm, make_optimizer(), batch, tp_mesh)
    out["tp"] = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                 "sharded": sorted(tm.unet.tp_sharded)}
    return _np(out)


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------


def _layer_fn(cfg):
    act = ACTIVATIONS[cfg.hidden_act]
    return lambda lyr, h: lyr(h, num_heads=cfg.num_heads, act=act,
                              causal=True)


def pipeline_parallel(rank, world, text_tree, ids, hidden, vision_tree,
                      pixels, bf16_tree, bf16_x):
    """Four ranks: every GPipe case of the JAX package's tests on the 4-rank
    meshes that correspond to its 8-device ones."""
    cfg = CLIPTextConfig.tiny(num_layers=8, use_final_projection=True)
    tower = load_module_params(CLIPText(cfg, dtype=F32), text_tree)
    ids = _t(ids)
    out = {}
    m22 = make_mesh(data=2, model=2)
    m14 = make_mesh(data=1, model=4)
    m41 = make_mesh(data=4, model=1)
    with torch.no_grad():
        out["dp2_pp2"] = clip_text_apply_pp(tower, ids, mesh=m22, n_micro=2)
        out["pure_pp4"] = clip_text_apply_pp(tower, ids, mesh=m14, n_micro=4)
        out["single_micro"] = clip_text_apply_pp(tower, ids, mesh=m22,
                                                 n_micro=1)
        out["single_stage"] = clip_text_apply_pp(tower, ids, mesh=m41,
                                                 n_micro=1)
        out["clip_skip"] = clip_text_apply_pp(tower, ids, mesh=m22,
                                              n_micro=2, clip_skip=2)
        staged = pp.shard_stages(tower.layers, m14)
        x = _t(hidden)
        out["captures"] = {
            k: pp.gpipe(_layer_fn(cfg), staged, x, mesh=m14, n_micro=2,
                        capture_before=k) for k in (0, 2, 4)}
        staged = pp.shard_stages(tower.layers, m22)
        headless = CLIPText(cfg, dtype=F32)
        load_module_params(headless, text_tree)
        headless.layers = torch.nn.ModuleList()
        out["prestaged"] = [clip_text_apply_pp(headless, ids, mesh=m22,
                                               n_micro=2, staged=staged)
                            for _ in range(2)]
        errors = []
        try:
            pp.shard_stages(tower.layers[:6], m14)
        except ValueError as e:
            errors.append(str(e))
        try:
            clip_text_apply_pp(tower, ids, mesh=m22, n_micro=3)
        except ValueError as e:
            errors.append(str(e))
        out["errors"] = errors
        vcfg = CLIPVisionConfig.tiny()
        vision = load_module_params(CLIPVision(vcfg, dtype=F32), vision_tree)
        out["vision"] = clip_vision_apply_pp(vision, _t(pixels), mesh=m22,
                                             n_micro=2)
        # bf16: the schedule against the sequential forward over the same
        # microbatches (batch 8 / (data 2 x micro 2): slices of 2 rows)
        bcfg = CLIPTextConfig.tiny(num_layers=8)
        btower = load_module_params(CLIPText(bcfg, dtype=torch.bfloat16),
                                    bf16_tree)
        xb = _t(bf16_x).to(torch.bfloat16)
        fn = _layer_fn(bcfg)
        y = pp.gpipe(fn, pp.shard_stages(btower.layers, m22), xb, mesh=m22,
                     n_micro=2)
        ref = []
        for i in range(0, 8, 2):
            h = xb[i:i + 2]
            for lyr in btower.layers:
                h = fn(lyr, h)
            ref.append(h)
        out["bf16_equal"] = bool(torch.equal(y, torch.cat(ref)))
    # replicate_params: every rank ends with rank 0's seeded values
    mine = CLIPText(cfg, dtype=F32)
    reset_parameters_(mine, torch.Generator().manual_seed(100 + rank))
    replicate_params(mine, m22)
    out["replicated"] = mine.final_ln.scale.sum() + sum(
        p.sum() for p in mine.parameters())
    # gradients through the schedule: this stage's layers' parameters
    staged = pp.shard_stages(tower.layers, m22)
    for p in staged.layers.parameters():
        p.requires_grad_(True)
    x = _t(hidden)
    loss = pp.gpipe(_layer_fn(cfg), staged, x, mesh=m22,
                    n_micro=2).square().mean()
    loss.backward()
    stage = mesh_axis(m22, MODEL_AXIS).rank
    out["grads"] = {
        f"{stage * staged.per + j}.{n}": p.grad
        for j, lyr in enumerate(staged.layers)
        for n, p in lyr.named_parameters()}
    return _np(out)


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def train_cli(rank, world, argv):
    """``cli.train.main(argv)`` on every rank; returns the logged lines,
    whether the moments were partitioned and the resident moment bytes."""
    from idmvton_tpu_torch.cli import train as cli_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = cli_train.main(argv)
    return {"log": buf.getvalue(), "zero1": state.zero1 is not None,
            "bytes": _bytes(state.opt_state)}
