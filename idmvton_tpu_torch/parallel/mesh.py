"""The process mesh and the data-parallel helpers (counterpart of
``idmvton_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``(data, model)`` mesh and lets XLA place
the collectives. The port runs one process a rank (``torchrun``, or the
dry run's spawned ranks) over ``torch.distributed``: NCCL between cards,
gloo between CPU processes. ``make_mesh`` arranges the ranks as JAX
arranges its devices (row-major: rank r is data row ``r // model``, model
column ``r % model``); the 'data' axis carries the batch, the 'model' axis
tensor, spatial or pipeline parallelism. Each rank holds whole tensors:
a batch "sharded over data" is this rank's slice of it, and replicated
values are held by every rank, so nothing moves to replicate them.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
# gradients are all-reduced in buckets of about this size (DDP's default)
BUCKET_BYTES = 25 * 2**20


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: the process group along it,
    this rank's index on it and its size."""
    group: object
    rank: int
    size: int


def init_distributed(device, *, timeout: Optional[datetime.timedelta] = None
                     ) -> torch.device:
    """Joins the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and
    returns this rank's device: NCCL for a CUDA ``device`` (this rank's
    card is ``cuda:LOCAL_RANK`` unless ``device`` names one), gloo for the
    CPU. The backend follows the caller's device; an NCCL initialisation
    that fails raises, it does not fall back to gloo."""
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(
            backend, rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return device


def make_mesh(world: Optional[int] = None, *, data: Optional[int] = None,
              model: int = 1):
    """A 2-D ``DeviceMesh`` over ("data", "model") of the initialised
    process group (JAX ``make_mesh``'s divisibility rules): ``data`` defaults
    to ``world // model``."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world if world is not None else dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks do not divide into model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"data={data} x model={model} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_axis(mesh, name: str) -> Axis:
    """``name``'s process group, this rank's index on it and its size."""
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(mesh.mesh_dim_names.index(name)))


@torch.no_grad()
def all_reduce_mean_(tensors, axis: Axis, bucket_bytes: int = BUCKET_BYTES):
    """Replaces each tensor, in place, by its mean over ``axis``'s group:
    same-type tensors flattened into buckets of about ``bucket_bytes``,
    one all-reduce a bucket (the sum, then divided by the group's size)."""
    pending, sizes = {}, {}

    def flush(key):
        group = pending.pop(key)
        sizes.pop(key)
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=axis.group)
        flat.div_(axis.size)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()

    for t in tensors:
        key = (t.dtype, t.device)
        pending.setdefault(key, []).append(t)
        sizes[key] = sizes.get(key, 0) + t.numel() * t.element_size()
        if sizes[key] >= bucket_bytes:
            flush(key)
    for key in list(pending):
        flush(key)


def _rows(x, axis: Axis):
    n = x.shape[0]
    if n % axis.size:
        raise ValueError(f"batch {n} does not divide over {axis.size} "
                         f"data ranks")
    per = n // axis.size
    return x[axis.rank * per:(axis.rank + 1) * per]


def shard_batch(tree, mesh):
    """This data rank's contiguous slice of axis 0 of every tensor or
    array in ``tree`` (dicts, lists, tuples), as JAX's batch sharding lays
    the rows out; other leaves pass as they are."""
    data = mesh_axis(mesh, DATA_AXIS)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        if isinstance(t, (torch.Tensor, np.ndarray)):
            return _rows(t, data)
        return t

    return go(tree)


@torch.no_grad()
def replicate_params(module: nn.Module, mesh) -> nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, so
    all ranks hold rank 0's values; returns ``module``."""
    del mesh   # the whole world holds the replica
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


def replicated(mesh):
    """The placement of a replicated value (JAX ``replicated``): every rank
    already holds all of it, so the placement returns its input."""
    del mesh
    return lambda tree: tree
