"""A multi-rank dry run of every parallel path (counterpart of
``__graft_entry__.dryrun_multichip``), and the process launcher it and
the tests use.

  python -m idmvton_tpu_torch.parallel.dryrun 4 [--device cpu]

``dryrun_multichip(n)`` spawns n ranks (one card a rank over NCCL, or
gloo CPU processes with ``device="cpu"``) and runs JAX's phases with JAX's
bounds on the tiny stack, fp32: a data-parallel train step (finite, step
1); the same step with ZeRO-1 (loss within 1e-5); then on a (n/2, 2)
mesh, for n >= 4 and even: GarmentNet's features under tensor
parallelism against the replicated forward (1e-4), the same under
spatial parallelism (1e-4), a data x tensor parallel train step's loss
against the data-parallel one's (1e-4), and a pipeline-parallel CLIP text
tower against its sequential forward (1e-4). The ranks import only torch
and this package.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails its rank
GROUP_TIMEOUT_S = 60.0


def _rank_main(rank, world, root, backend, fn, args, threads):
    torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(root, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, backend: str = "gloo",
          timeout: float = 300.0, threads: int = 1) -> List:
    """Runs ``fn(rank, nprocs, *args)`` (a module-level function) in
    ``nprocs`` fresh processes (``spawn``), joined into one process group
    on a ``FileStore`` in a temporary directory, each collective bounded
    by ``GROUP_TIMEOUT_S``; returns the ranks' return values in rank
    order. A rank that raises fails the call with its traceback; ranks
    still running after ``timeout`` seconds are killed and the call
    raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    root = tempfile.mkdtemp(prefix="idmvton_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, root, backend, fn, args, threads),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks still running "
                                       f"after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        return [torch.load(os.path.join(root, f"out{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the dry run's rank
# ---------------------------------------------------------------------------


def tiny_batch(models, b: int, h: int, w: int, seed: int) -> dict:
    """A seeded numpy train batch of the tiny stack (JAX ``dryrun``'s
    fields), the same on every rank."""
    rng = np.random.default_rng(seed)
    img = lambda: rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    vocab = models.clip_l_cfg.vocab_size
    isz = models.vision_cfg.image_size
    ids_p, ids_c = (rng.integers(0, vocab, (b, 7)) for _ in range(2))
    return dict(person=img(), pose=img(), cloth=img(),
                mask=(rng.uniform(size=(b, h, w, 1)) > 0.5).astype(
                    np.float32),
                prompt_ids_l=ids_p, prompt_ids_g=ids_p, cloth_ids_l=ids_c,
                cloth_ids_g=ids_c,
                ip_pixels=rng.uniform(-1, 1, (b, isz, isz, 3)).astype(
                    np.float32))


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _dryrun_rank(rank, world, device_type):
    from idmvton_tpu_torch.core.config import (
        CLIPTextConfig, SchedulerConfig,
    )
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.models.clip import CLIPText, clip_text_apply_pp
    from idmvton_tpu_torch.models.layers import reset_parameters_
    from idmvton_tpu_torch.models.unet import UNet
    from idmvton_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from idmvton_tpu_torch.parallel.sp import (
        shard_latent, shard_spatial, spatial_axis,
    )
    from idmvton_tpu_torch.parallel.tp import shard_unet_params
    from idmvton_tpu_torch.parallel.zero import zero1_state_sharding
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.train.train_step import (
        init_train_state, make_optimizer, make_train_step,
    )
    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.time()

    def say(msg):
        if rank == 0:
            print(f"[dryrun {time.time() - t0:5.1f}s] {msg}", flush=True)

    dtype = torch.float32
    models = TryonModels.init(0, tiny=True, device=dev, dtype=dtype)
    sched = DDPMScheduler(SchedulerConfig.train())
    tx = make_optimizer()
    mesh = make_mesh()
    host = tiny_batch(models, world, 32, 32, seed=1)
    to_dev = lambda tree: {k: torch.from_numpy(v).to(dev)
                           for k, v in tree.items()}
    gen = lambda: torch.Generator(device=dev).manual_seed(7)

    # remat=False: the dry run checks the parallel paths, not remat
    step = make_train_step(models, sched, tx, snr_gamma=5.0,
                           compute_dtype=dtype, remat=False, mesh=mesh)
    state, metrics = step(init_train_state(models, tx),
                          to_dev(shard_batch(host, mesh)), gen())
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    assert state.step == 1
    say(f"dryrun_multichip({world}): dp train ok, loss={loss:.4f}, "
        f"mesh={tuple(mesh.shape)}")

    state_z = zero1_state_sharding(init_train_state(models, tx), mesh)
    _, metrics_z = step(state_z, to_dev(shard_batch(host, mesh)), gen())
    loss_z = float(metrics_z["loss"])
    assert abs(loss_z - loss) < 1e-5, (loss_z, loss)
    say(f"dryrun_multichip({world}): dp + zero-1 train ok, "
        f"loss={loss_z:.4f}")
    out = {"loss": loss, "loss_zero1": loss_z}
    if world < 4 or world % 2:
        return out

    tp_mesh = make_mesh(data=world // 2, model=2)
    db = world // 2
    rng = np.random.default_rng(2)
    cfg = models.garm_cfg
    lat = torch.from_numpy(rng.standard_normal((db, 8, 8, 4)).astype(
        np.float32)).to(dev)
    ctx = torch.from_numpy(rng.standard_normal(
        (db, 7, cfg.cross_attention_dim)).astype(np.float32)).to(dev)
    lat_d, ctx_d = shard_batch((lat, ctx), tp_mesh)
    with torch.no_grad():
        _, ref = models.garm(lat_d, 10, ctx_d)
        garm_tp = UNet(cfg, dtype=dtype, device=dev)
        garm_tp.load_state_dict(models.garm.state_dict())
        _, feats = shard_unet_params(garm_tp, tp_mesh)(lat_d, 10, ctx_d)
        errs = [_max_err(a, r) for a, r in zip(feats, ref)]
        assert max(errs) < 1e-4, errs
        say(f"dryrun_multichip({world}): dp x tp inference ok "
            f"(== replicated, max err {max(errs):.2e}), "
            f"mesh={tuple(tp_mesh.shape)}")

        sp = spatial_axis(tp_mesh)
        _, feats_sp = shard_spatial(models.garm, sp)(
            shard_latent(lat, tp_mesh), 10, ctx_d)
        shard_spatial(models.garm, None)
        errs = []
        for a, r in zip(feats_sp, ref):
            per = r.shape[1] // sp.size
            errs.append(_max_err(a, r[:, sp.rank * per:(sp.rank + 1) * per]))
        assert max(errs) < 1e-4, errs
        say(f"dryrun_multichip({world}): dp x sp inference ok "
            f"(== replicated, max err {max(errs):.2e}), "
            f"mesh={tuple(tp_mesh.shape)}")

    shard_unet_params(models.unet, tp_mesh)
    step_tp = make_train_step(models, sched, tx, snr_gamma=5.0,
                              compute_dtype=dtype, remat=False, mesh=tp_mesh)
    _, metrics_tp = step_tp(init_train_state(models, tx),
                            to_dev(shard_batch(host, tp_mesh)), gen())
    loss_tp = float(metrics_tp["loss"])
    assert abs(loss_tp - loss) < 1e-4, (loss_tp, loss)
    say(f"dryrun_multichip({world}): dp x tp train ok, loss={loss_tp:.4f} "
        f"(dp {loss:.4f})")

    pcfg = CLIPTextConfig.tiny(num_layers=4, use_final_projection=True)
    tower = CLIPText(pcfg, dtype=dtype, device=dev)
    reset_parameters_(tower, torch.Generator(device=dev).manual_seed(3))
    ids = torch.from_numpy(rng.integers(0, pcfg.vocab_size,
                                        (world, 12))).to(dev)
    with torch.no_grad():
        want = tower(ids)
        got = clip_text_apply_pp(tower, ids, mesh=tp_mesh, n_micro=2)
    errs = {k: _max_err(got[k], want[k])
            for k in ("penultimate", "last_hidden", "pooled")}
    assert max(errs.values()) < 1e-4, errs
    say(f"dryrun_multichip({world}): dp x pp (GPipe, 2 stages, 2 "
        f"microbatches) ok (== sequential), mesh={tuple(tp_mesh.shape)}")
    out.update(loss_tp=loss_tp)
    return out


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """Runs the dry run on ``n`` spawned ranks, one card a rank over NCCL
    (``device="cpu"``: gloo CPU processes); returns rank 0's losses."""
    backend = "nccl" if device == "cuda" else "gloo"
    return spawn(_dryrun_rank, n, device, backend=backend)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, help="number of ranks")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)
    print(dryrun_multichip(args.n, args.device))


if __name__ == "__main__":
    main()
