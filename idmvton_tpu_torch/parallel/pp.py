"""Pipeline parallelism: a GPipe schedule over homogeneous layer stacks
(counterpart of ``idmvton_tpu/parallel/pp.py``).

The targets are the frozen encoder towers (CLIP-L, bigG, ViT-H): stacks of
identical layers. ``shard_stages`` keeps this model rank's L/S contiguous
layers (stage s = model rank s); ``gpipe`` runs JAX's tick schedule: T =
n_micro + S - 1 ticks, at tick t stage s applies its layers to
microbatch t - s and hands the activation to stage s + 1 (a point-to-point
send / recv where JAX's ``lax.ppermute`` rides the ring). JAX computes the
warm-up and drain ticks on zeros and masks their writes; here those ticks
compute nothing. Each data row of the mesh runs its own pipeline on its
rows of the batch.

``gpipe`` takes the whole batch on every rank and returns the whole
result on every rank, in JAX's ``collect`` order (data row, then
microbatch): the last stage's outputs are broadcast over the model group
and the data rows' all-gathered. Under autograd the schedule is one
``torch.autograd.Function``: its backward runs the ticks in reverse,
recomputing each stage's forward from the input it saved, sending each
input gradient to the previous stage, and summing each stage's parameter
gradients over the data rows (JAX's gpipe is differentiable the same way).

A gloo group's send / recv move host memory only, so a CUDA activation
hops between stages through pinned host memory there (two ranks sharing
one card); NCCL moves it on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from idmvton_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Axis, mesh_axis,
)


def stack_layers(layers) -> Dict[str, torch.Tensor]:
    """L identical modules -> {parameter name: the L leaves stacked on a
    new leading axis}."""
    per = [dict(lyr.named_parameters()) for lyr in layers]
    return {n: torch.stack([p[n] for p in per]) for n in per[0]}


@dataclasses.dataclass
class Staged:
    """This model rank's pipeline stage: its contiguous ``per`` layers."""
    layers: nn.ModuleList
    per: int
    n_stages: int
    stage: int


def shard_stages(layers, mesh) -> Staged:
    """Splits L layers into as many stages as the mesh has model ranks and
    keeps this rank's L/S contiguous ones."""
    model = mesh_axis(mesh, MODEL_AXIS)
    n = len(layers)
    if n % model.size:
        raise ValueError(f"{n} layers not divisible into {model.size} "
                         f"pipeline stages")
    per = n // model.size
    return Staged(nn.ModuleList(list(layers)[model.rank * per:
                                             (model.rank + 1) * per]),
                  per, model.size, model.rank)


class _Hops:
    """Point-to-point activation hops along this data row's pipeline."""

    def __init__(self, model: Axis):
        self.model = model
        self.host = dist.get_backend(model.group) == "gloo"

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.model.group, stage)

    def send(self, t: torch.Tensor, stage: int):
        t = t.contiguous()
        if self.host and t.is_cuda:
            t = t.to("cpu").pin_memory()
        dist.send(t, self._peer(stage), group=self.model.group)

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        buf = torch.empty_like(like, device="cpu" if self.host else None)
        dist.recv(buf, self._peer(stage), group=self.model.group)
        return buf.to(like.device)

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        dist.broadcast(t, self._peer(stage), group=self.model.group)
        return t


class _Plan:
    """One gpipe call's schedule on this rank."""

    def __init__(self, layer_fn, staged: Staged, mesh, n_micro: int,
                 capture_before: Optional[int]):
        self.layer_fn, self.staged = layer_fn, staged
        self.data = mesh_axis(mesh, DATA_AXIS)
        self.model = mesh_axis(mesh, MODEL_AXIS)
        self.hops = _Hops(self.model)
        self.n_micro, self.cap = n_micro, capture_before
        s, per = staged.stage, staged.per
        self.cap_stage = None if capture_before is None \
            else capture_before // per
        self.cap_here = self.cap_stage == s

    def apply(self, h):
        """This stage's layers; the hidden state before layer
        ``capture_before`` when this stage holds it."""
        base = self.staged.stage * self.staged.per
        cap = None
        for j, lyr in enumerate(self.staged.layers):
            if self.cap == base + j:
                cap = h
            h = self.layer_fn(lyr, h)
        return h, cap

    def rows(self, x):
        per = x.shape[0] // self.data.size
        return x[self.data.rank * per:(self.data.rank + 1) * per]

    def forward(self, x):
        """The tick schedule; returns (y, captured or None, each stage
        input kept for the backward)."""
        s, last = self.staged.stage, self.model.size - 1
        xm = self.rows(x).chunk(self.n_micro)
        outs: List = [None] * self.n_micro
        caps: List = [None] * self.n_micro
        inputs: List = [None] * self.n_micro
        for t in range(self.n_micro + self.model.size - 1):
            m = t - s
            if not 0 <= m < self.n_micro:
                continue            # warm-up / drain: JAX masks these out
            h = xm[m] if s == 0 else self.hops.recv(xm[m], s - 1)
            inputs[m] = h
            y, cap = self.apply(h)
            caps[m] = cap
            if s < last:
                self.hops.send(y, s + 1)
            else:
                outs[m] = y
        y = self.collect(outs, last, xm)
        cap = None if self.cap is None else self.collect(caps, self.cap_stage,
                                                          xm)
        return y, cap, inputs

    def collect(self, parts, stage, xm):
        """The owning stage's microbatches broadcast over the model group,
        then every data row's rows gathered: the whole batch."""
        if self.staged.stage == stage:
            local = torch.cat(parts)
        else:
            local = torch.empty((sum(p.shape[0] for p in xm),)
                                + xm[0].shape[1:], dtype=xm[0].dtype,
                                device=xm[0].device)
        local = self.hops.broadcast(local.contiguous(), stage)
        if self.data.size == 1:
            return local
        rows = [torch.empty_like(local) for _ in range(self.data.size)]
        dist.all_gather(rows, local, group=self.data.group)
        return torch.cat(rows)

    def backward(self, inputs, params, gy, gcap):
        """The ticks in reverse: recompute each microbatch's stage forward,
        back-propagate the output gradient (received from the next stage,
        or this data row's rows of ``gy`` on the last), send the input
        gradient to the previous stage. Returns (the whole input gradient,
        this stage's parameter gradients summed over the data rows)."""
        s, last = self.staged.stage, self.model.size - 1
        gym = self.rows(gy).chunk(self.n_micro)
        gcm = None if gcap is None or not self.cap_here \
            else self.rows(gcap).chunk(self.n_micro)
        pgrads = [torch.zeros_like(p) for p in params]
        gx: List = [None] * self.n_micro
        for m in reversed(range(self.n_micro)):
            g = gym[m] if s == last else self.hops.recv(gym[m], s + 1)
            h = inputs[m].detach().requires_grad_()
            with torch.enable_grad():
                y, cap = self.apply(h)
            outs, grads = [y], [g]
            if gcm is not None:
                outs.append(cap)
                grads.append(gcm[m])
            got = torch.autograd.grad(outs, [h] + list(params), grads,
                                      allow_unused=True)
            for acc, gp in zip(pgrads, got[1:]):
                if gp is not None:
                    acc.add_(gp)
            if s > 0:
                self.hops.send(got[0], s - 1)
            else:
                gx[m] = got[0]
        for gp in pgrads:
            dist.all_reduce(gp, group=self.data.group)
        gx_whole = self.collect(gx, 0, gym)
        return gx_whole, pgrads


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan, *params):
        with torch.no_grad():
            y, cap, inputs = plan.forward(x)
        ctx.plan, ctx.inputs, ctx.params = plan, inputs, params
        if cap is None:
            return y
        return y, cap

    @staticmethod
    def backward(ctx, gy, gcap=None):
        gx, pgrads = ctx.plan.backward(ctx.inputs, ctx.params, gy, gcap)
        return (gx, None, *pgrads)


def gpipe(layer_fn: Callable, staged: Staged, x, *, mesh, n_micro: int,
          capture_before: Optional[int] = None):
    """Applies a pipelined homogeneous layer stack to the batch ``x`` (the
    whole batch, on every rank).

    ``layer_fn(layer, h) -> h`` applies ONE layer (h keeps its shape and
    type); ``staged`` is ``shard_stages``'s. ``x.shape[0]`` must divide
    into data ranks x ``n_micro`` equal microbatches. ``capture_before=k``
    also returns the hidden state just before layer k (global index), the
    seam of CLIP's penultimate / clip_skip outputs.

    Returns y (B, ...), or (y, captured) with ``capture_before``, whole on
    every rank."""
    n_data = mesh_axis(mesh, DATA_AXIS).size
    batch = x.shape[0]
    if batch % (n_data * n_micro) != 0:
        raise ValueError(f"batch {batch} not divisible by data axis "
                         f"{n_data} x n_micro {n_micro}")
    if capture_before is not None and not \
            0 <= capture_before < staged.n_stages * staged.per:
        raise ValueError(f"capture_before={capture_before} out of range")
    plan = _Plan(layer_fn, staged, mesh, n_micro, capture_before)
    params = [p for p in staged.layers.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        out = _GPipe.apply(x, plan, *params)
    else:
        y, cap, _ = plan.forward(x)
        out = y if cap is None else (y, cap)
    return out
