"""ZeRO-1: the optimizer state partitioned over the data axis
(counterpart of ``idmvton_tpu/parallel/zero.py``).

Each moment leaf is split on its largest axis divisible by the number of
data ranks (JAX's rule, ``_moment_spec``), and each rank keeps only its
slice; the masters stay replicated. JAX pins the shardings and GSPMD
places the collectives; here the step does (``train/train_step.py``):
the gradients are averaged over the data group as in plain data
parallelism, each rank updates its slice of every split master with its
slice of the moments, and the updated slices are all-gathered, so every
rank again holds the whole masters.

- fp32 AdamW: ``mu`` / ``nu`` split like their masters;
- int8 AdamW (``train/quant_opt.py``): the flat (nblocks, 256) code
  buffers and their (nblocks, 1) scales split on the block axis (JAX pads
  nblocks to a multiple of 8 for this split); each rank updates the
  elements of its blocks, and the block-space slices are all-gathered.
  Where JAX's rule would split the buffers inside the blocks (fewer than
  256 blocks), they stay replicated: a block's absmax spans its 256
  elements;
- Adafactor's factored moments and the accumulation buffer of
  ``optax.MultiSteps`` stay replicated.

``gather_state`` puts the whole state back together (a checkpoint saved
at dp=2 resumes at dp=1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from idmvton_tpu_torch.parallel.mesh import DATA_AXIS, Axis, mesh_axis


def _moment_spec(shape, axis_size: int) -> Optional[int]:
    """The dim JAX's ``_moment_spec`` splits (the largest one divisible
    by ``axis_size``), or None (replicated)."""
    shape = tuple(shape)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] >= axis_size and shape[d] % axis_size == 0:
            return d
    return None


@dataclasses.dataclass
class Zero1:
    """A state's partition: the data axis, each fp32 moment's split dim by
    parameter name (None: replicated), and the int8 buffers' block range
    (lo, hi) this rank holds (None: replicated)."""
    axis: Axis
    dims: Dict[str, Optional[int]]
    blocks: Optional[Tuple[int, int]]

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice (a view) of ``t``, shaped as ``name``'s
        master."""
        d = self.dims.get(name)
        if d is None:
            return t
        per = t.shape[d] // self.axis.size
        return t.narrow(d, self.axis.rank * per, per)


def _inner(opt_state: dict) -> dict:
    return opt_state.get("inner", opt_state)


def _all_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim)


def zero1_state_sharding(state, mesh):
    """Partitions ``state``'s optimizer moments over the data axis in
    place (each rank keeps its slice) and returns ``state``, its
    ``zero1`` set."""
    from idmvton_tpu_torch.train.train_step import flat_params
    axis = mesh_axis(mesh, DATA_AXIS)
    n = axis.size
    inner = _inner(state.opt_state)
    dims, blocks = {}, None
    if "mu" in inner:                                   # fp32 AdamW
        for k, p in flat_params(state.trainable).items():
            dims[k] = _moment_spec(p.shape, n)
    z = Zero1(axis, dims, None)
    for key in ("mu", "nu"):
        if key in inner:
            inner[key] = {k: z.local(k, t).clone()
                          for k, t in inner[key].items()}
    if "mu_q" in inner and _moment_spec(inner["mu_q"].shape, n) == 0:
        per = inner["mu_q"].shape[0] // n
        blocks = (axis.rank * per, (axis.rank + 1) * per)
        for key in ("mu_q", "mu_scale", "nu_q", "nu_scale"):
            inner[key] = inner[key][blocks[0]:blocks[1]].clone()
    z.blocks = blocks
    state.zero1 = z
    return state


@torch.no_grad()
def update_(tx, grads, state: dict, params, z: Zero1, table=None,
            clip=None) -> None:
    """The optimizer's inner update on this rank's slices, then the updated
    masters all-gathered: ``params`` hold the whole update on every rank.
    ``state`` is the inner state. ``table``: adamw8bit's leaf table where
    its kernel runs (the card), which clips by the global norm ``clip``
    (None: no clip) as it reads ``grads``; else ``grads`` come clipped."""
    if tx.kind == "adamw":
        g_loc = {k: z.local(k, g) for k, g in grads.items()}
        p_loc = {k: z.local(k, p) for k, p in params.items()}
        tx._adamw(g_loc, state, p_loc)
        for k, p in params.items():
            p_loc[k].add_(g_loc[k])
            if z.dims[k] is not None:
                p.copy_(_all_gather(p_loc[k], z.axis, z.dims[k]))
        return
    if tx.kind == "adamw8bit" and z.blocks is not None:
        from idmvton_tpu_torch.train.quant_opt import BLOCK, layout
        from idmvton_tpu_torch.train import quant_opt
        if table is not None:
            tx._adamw8bit_fused_(table, grads, state, params, clip, z.blocks)
        else:
            quant_opt.adam_int8_(grads, state, b1=tx.b1, b2=tx.b2,
                                 eps=tx.eps, blocks=z.blocks)
            for k, g in grads.items():
                g.copy_((g + tx.wd * params[k]) * -tx.lr)
                params[k].add_(g)
        # this rank's blocks of the updated masters, in block space
        lo, hi = z.blocks
        offs, _ = layout([p.shape for p in params.values()])
        mine = next(iter(params.values())).new_zeros((hi - lo) * BLOCK)
        spans = []
        for p, o in zip(params.values(), offs):
            n = p.numel()
            spans.append((p, o * BLOCK, n))
            a, b = max(o * BLOCK, lo * BLOCK), min(o * BLOCK + n, hi * BLOCK)
            if a < b:
                mine[a - lo * BLOCK:b - lo * BLOCK] = \
                    p.view(-1)[a - o * BLOCK:b - o * BLOCK]
        whole = _all_gather(mine, z.axis, 0)
        for p, start, n in spans:
            p.view(-1).copy_(whole[start:start + n])
        return
    if table is not None:            # the kernel over the replicated state
        tx._adamw8bit_fused_(table, grads, state, params, clip)
        return
    getattr(tx, f"_{tx.kind}")(grads, state, params)   # replicated state
    for k, p in params.items():
        p.add_(grads[k])


def gather_state(state):
    """A whole copy of a ZeRO-1 ``state`` (every rank takes part; the
    masters are shared, the moments gathered), for ``save_train_state``."""
    from idmvton_tpu_torch.train.train_step import TrainState
    z = state.zero1
    if z is None:
        return state

    def whole(tree):
        out = dict(tree)
        inner = out.get("inner")
        if inner is not None:
            out["inner"] = whole(inner)
            return out
        for key in ("mu", "nu"):
            if key in out:
                out[key] = {k: t if z.dims.get(k) is None
                            else _all_gather(t, z.axis, z.dims[k])
                            for k, t in out[key].items()}
        if z.blocks is not None:
            for key in ("mu_q", "mu_scale", "nu_q", "nu_scale"):
                out[key] = _all_gather(out[key], z.axis, 0)
        return out

    return TrainState(step=state.step, trainable=state.trainable,
                      opt_state=whole(state.opt_state))


def opt_state_bytes_per_device(state, mesh) -> int:
    """Optimizer-state bytes resident on each rank: JAX's formula (a split
    leaf counts 1/n of its bytes) on a whole state; a partitioned state's
    own slices as they are held."""
    n = mesh_axis(mesh, DATA_AXIS).size
    leaves = []

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                leaves.append(v)

    walk(state.opt_state)
    if getattr(state, "zero1", None) is not None:
        return sum(t.numel() * t.element_size() for t in leaves)
    return sum(t.numel() * t.element_size()
               // (n if _moment_spec(t.shape, n) is not None else 1)
               for t in leaves)
