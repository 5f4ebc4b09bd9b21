"""Tensor parallelism for the UNets (counterpart of
``idmvton_tpu/parallel/tp.py``).

JAX states TP as parameter shardings alone: the attention QKV / FF-in
kernels split on their output dim, the out-projections on their input
dim, and GSPMD places the collectives. PyTorch has no GSPMD and the
port's kernels take plain tensors, so ``shard_unet_params`` keeps each
rank's shard of those weights and hands the blocks the model group, and
the blocks place the collectives themselves (Megatron's scheme):

- a column-parallel projection keeps this rank's heads: of each section
  of a fused layout (``to_qkv``'s [q | k | v], ``to_kv``'s [k | v],
  GEGLU's [value | gate]) the same heads' columns, so the local heads
  attend as the whole layer's would, and the kernels see the narrower
  widths (``heads / M``);
- a row-parallel projection (``to_out``, ``proj_out``) multiplies this
  rank's input columns, sums the partial products over the model group
  and adds its bias once, after the sum;
- Transformer2D's ``proj_in`` (column) and ``proj_out`` (row) sit around
  full-width blocks: the ``proj_in`` output is gathered over the group,
  and ``proj_out`` reads this rank's columns of the full hidden state.

Under autograd the collectives are Megatron's *f* (identity forward,
all-reduce backward) where a replicated activation enters a column
split, and *g* (all-reduce forward, identity backward) after a row split,
so replicated parameters get the whole gradient on every rank and each
shard its own. Convs, norms and embeddings stay replicated, as in JAX.

``unet_param_spec`` gives JAX's specs leaf for leaf: (None, "model") for a
column split, ("model", None) for a row split, ("model",) for a split
bias, () for a replicated leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from idmvton_tpu_torch.parallel.mesh import MODEL_AXIS, Axis, mesh_axis

_COL = ((None, MODEL_AXIS), (MODEL_AXIS,))     # split output dim
_ROW = ((MODEL_AXIS, None), ())                # split input dim, sum after
_RULES = {
    "to_qkv": _COL,
    "to_q": _COL,
    "to_kv": _COL,
    "to_kv_ip": _COL,
    "to_out": _ROW,
    "proj_in": _COL,   # GEGLU's and Transformer2D's
    "proj_out": _ROW,
}


def _spec_for(name: str, shape, model_axis_size: int) -> Tuple:
    """JAX ``_spec_for`` on a parameter name ("a.b.proj_in.kernel")."""
    parts = name.split(".")
    rule = _RULES.get(parts[-2]) if len(parts) >= 2 else None
    if rule is None:
        return ()
    kernel_spec, bias_spec = rule
    if parts[-1] == "kernel" and len(shape) == 2:
        split_dim = 1 if kernel_spec == _COL[0] else 0
        if shape[split_dim] % model_axis_size != 0:
            return ()
        return kernel_spec
    if parts[-1] == "bias" and len(shape) == 1:
        if bias_spec == () or shape[0] % model_axis_size != 0:
            return ()
        return bias_spec
    return ()


def unet_param_spec(unet: nn.Module, model_axis_size: int = 2
                    ) -> Dict[str, Tuple]:
    """{parameter name: JAX PartitionSpec as a tuple} for a UNet, every
    split dim checked against ``model_axis_size``."""
    return {n: _spec_for(n, tuple(p.shape), model_axis_size)
            for n, p in unet.named_parameters()}


# ---------------------------------------------------------------------------
# the collectives (Megatron's f and g, and the gather)
# ---------------------------------------------------------------------------


class _EnterColumns(torch.autograd.Function):
    """f: identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumRows(torch.autograd.Function):
    """g: the partial products summed forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    """Last-dim all-gather; backward keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, -1)[ctx.rank].contiguous(), None, None, None


def _recording(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def enter(x, tp: Optional[Axis]):
    """A replicated activation entering column-split projections."""
    if tp is None or not _recording(x):
        return x
    return _EnterColumns.apply(x, tp.group)


def row_linear(p, x, tp: Optional[Axis]):
    """``layers.linear`` of a row-split projection: this rank's input
    columns (``x`` holds just those) times its rows, summed over the
    group, then the bias once."""
    y = torch.matmul(x, p.kernel.to(x.dtype))
    if _recording(y):
        y = _SumRows.apply(y, tp.group)
    else:
        dist.all_reduce(y, group=tp.group)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def gather_columns(x, tp: Axis):
    """The column shards of every rank, concatenated in rank order."""
    if _recording(x):
        return _GatherColumns.apply(x, tp.group, tp.rank, tp.size)
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, -1)


# ---------------------------------------------------------------------------
# sharding the weights
# ---------------------------------------------------------------------------


def _columns(width: int, sections: int, tp: Axis) -> torch.Tensor:
    """Indices of this rank's share of each of ``sections`` equal sections
    of ``width`` columns."""
    sec = width // sections
    per = sec // tp.size
    return torch.cat([torch.arange(s * sec + tp.rank * per,
                                   s * sec + (tp.rank + 1) * per)
                      for s in range(sections)])


def _keep(module, name: str, t: torch.Tensor):
    setattr(module, name, nn.Parameter(t.contiguous(), requires_grad=False))


def _shard_col(lin, sections: int, tp: Axis):
    from idmvton_tpu_torch.models.layers import QuantLinear
    if isinstance(lin, QuantLinear):
        raise ValueError("tensor parallelism takes bf16 / fp32 projections, "
                         "not int8 ones")
    idx = _columns(lin.kernel.shape[1], sections, tp).to(lin.kernel.device)
    _keep(lin, "kernel", lin.kernel.detach().index_select(1, idx))
    if lin.bias is not None:
        _keep(lin, "bias", lin.bias.detach().index_select(0, idx))


def _shard_row(lin, tp: Axis):
    per = lin.kernel.shape[0] // tp.size
    _keep(lin, "kernel",
          lin.kernel.detach()[tp.rank * per:(tp.rank + 1) * per])


def shard_unet_params(unet: nn.Module, mesh) -> nn.Module:
    """Keeps this model rank's shard of every weight ``unet_param_spec``
    splits, sets the model group on the modules that hold them (their
    forward then places the collectives), records the split parameters'
    names as ``unet.tp_sharded`` and returns ``unet``. A module whose split
    dims do not divide stays replicated, as JAX's rule replicates its
    leaves; one whose leaves JAX would split only in part, or whose heads
    do not divide, raises."""
    from idmvton_tpu_torch.models.attention import (
        CrossAttention, FeedForward, SelfAttention,
    )
    from idmvton_tpu_torch.models.layers import weights_changed_
    from idmvton_tpu_torch.models.transformer import Transformer2D
    tp = mesh_axis(mesh, MODEL_AXIS)
    m = tp.size
    spec = unet_param_spec(unet, m)
    kinds = (SelfAttention, CrossAttention, FeedForward, Transformer2D)
    for name, mod in list(unet.named_modules()):
        if not isinstance(mod, kinds) or m == 1:
            continue
        depth = name.count(".") + 2 if name else 1
        kernels = [s for k, s in spec.items() if k.endswith(".kernel")
                   and k.startswith(name + ".") and k.count(".") == depth]
        if not any(kernels):
            continue
        heads = getattr(mod, "heads", m)
        if not all(kernels) or heads % m:
            raise ValueError(f"{name}: JAX's rule splits only some of its "
                             f"kernels over {m} model ranks, or its {heads} "
                             f"heads do not divide")
        if isinstance(mod, SelfAttention):
            _shard_col(mod.to_qkv, 3, tp)
        elif isinstance(mod, CrossAttention):
            _shard_col(mod.to_q, 1, tp)
            _shard_col(mod.to_kv, 2, tp)
            if mod.to_kv_ip is not None:
                _shard_col(mod.to_kv_ip, 2, tp)
        else:   # GEGLU's [value | gate], or Transformer2D's proj_in
            _shard_col(mod.proj_in, 2 if isinstance(mod, FeedForward)
                       else 1, tp)
        _shard_row(mod.to_out if hasattr(mod, "to_out") else mod.proj_out,
                   tp)
        if hasattr(mod, "heads"):
            mod.heads //= m
        mod.tp = tp
    unet.tp_sharded = frozenset(k for k, s in spec.items() if s)
    return weights_changed_(unet)
