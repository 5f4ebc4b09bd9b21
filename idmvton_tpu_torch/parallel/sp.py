"""Spatial parallelism for the UNets' latent path (counterpart of
``idmvton_tpu/parallel/sp.py``).

JAX shards the NHWC latent's H over the mesh's 'model' axis and lets
GSPMD insert halo exchanges for the convs and gathers for attention. The
port hands the UNet's layers the model axis (``shard_spatial(unet,
spatial_axis(mesh))``, then the forward on the rows ``shard_latent``
keeps) and they place the collectives:

- a 3x3 stride-1 conv runs the same kernel (SAME) on this rank's rows
  with one row of each neighbour above and below (zeros past the ends, as
  the padding) and drops the two halo rows of its output;
- the stride-2 downsample (padding (0, 1) below) needs only the next
  rank's first row; the nearest upsample is local;
- GroupNorm sums its per-channel sums, sums of squares and counts over
  the group before the group statistics (on the card the sums are
  ``gn_spatial_stats``'s output);
- self-attention gathers K / V over the group (tokens are H-major, so
  rank order is token order) and keeps its queries local; TryonNet
  gathers the garment features an SP GarmentNet emits the same way;
- time embeddings and the text / IP context are replicated.

Forward only, as the JAX package tests and uses it: a collective here
refuses a tensor autograd records.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from idmvton_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Axis, mesh_axis,
)


def latent_spec():
    """(B, H, W, C): batch over 'data', H over 'model'."""
    return (DATA_AXIS, MODEL_AXIS)


def spatial_axis(mesh) -> Axis:
    """The axis the latent's rows are split over."""
    return mesh_axis(mesh, MODEL_AXIS)


def shard_latent(x, mesh):
    """This rank's block of an NHWC tensor: its data rank's contiguous
    batch rows and its model rank's contiguous H rows."""
    out = x
    for dim, name in enumerate(latent_spec()):
        ax = mesh_axis(mesh, name)
        n = out.shape[dim]
        if n % ax.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {ax.size} {name} ranks")
        per = n // ax.size
        out = out.narrow(dim, ax.rank * per, per)
    return out.contiguous()


def shard_spatial(unet, axis: Optional[Axis]):
    """Hands ``axis`` to every layer of ``unet`` whose output depends on
    rows outside this rank's (``spatial`` on its convs, norms and
    self-attentions); ``unet``'s forward then takes and returns this rank's
    rows, and so are its emitted garment features. ``axis=None`` gives the
    layers the whole map again. Returns ``unet``."""
    for m in unet.modules():
        if hasattr(m, "spatial"):
            m.spatial = axis
    return unet


def _forward_only(t: torch.Tensor):
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError("spatial parallelism is forward only: its "
                           "collectives carry no gradient")


def gather(t: torch.Tensor, sp: Axis, dim: int = 1) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    _forward_only(t)
    parts = [torch.empty_like(t) for _ in range(sp.size)]
    dist.all_gather(parts, t.contiguous(), group=sp.group)
    return torch.cat(parts, dim)


def all_sum(t: torch.Tensor, sp: Axis) -> torch.Tensor:
    """``t`` summed over the group (in place on a fresh tensor)."""
    _forward_only(t)
    dist.all_reduce(t, group=sp.group)
    return t


def halo(x: torch.Tensor, sp: Axis, *, above: int, below: int
         ) -> torch.Tensor:
    """NHWC ``x`` with the previous rank's last row on top (``above``=1)
    and the next rank's first row below (``below``=1); the first and last
    ranks take zero rows there, as the padding."""
    edges = gather(torch.cat([x[:, :1], x[:, -1:]], 1), sp)
    zero = torch.zeros_like(x[:, :1])
    rows = [x]
    if above:
        rows.insert(0, edges[:, 2 * sp.rank - 1:2 * sp.rank]
                    if sp.rank > 0 else zero)
    if below:
        rows.append(edges[:, 2 * sp.rank + 2:2 * sp.rank + 3]
                    if sp.rank < sp.size - 1 else zero)
    return torch.cat(rows, 1)


def group_sums(s1: torch.Tensor, s2: torch.Tensor, n: int,
               sp: Optional[Axis]):
    """Per-channel means of x and x^2 from this rank's sums over its ``n``
    positions, the sums and counts of every rank added first."""
    if sp is None:
        return s1 / n, s2 / n
    b, c = s1.shape
    tot = all_sum(torch.cat([s1, s2, s1.new_full((b, 1), float(n))], 1), sp)
    count = tot[:, 2 * c:]
    return tot[:, :c] / count, tot[:, c:2 * c] / count
