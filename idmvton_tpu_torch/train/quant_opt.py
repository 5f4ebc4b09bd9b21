"""AdamW with int8-quantized moments (counterpart of
``idmvton_tpu/train/quant_opt.py``).

The reference offers bitsandbytes AdamW8bit (--use_8bit_adam,
train_xl.py:412-422) to cut optimizer-state memory: both Adam moments
stored as 8-bit codes with block-wise scales, 2 bytes a parameter of
moment state (+ ~2% scales) instead of 8. The codes and their arithmetic
are the JAX package's:

- a DYNAMIC (log-spaced) 8-bit map per 256-element block: code i in
  [-127, 127] stands for sign(i) * 10**(SPAN * (|i|/127 - 1)) * absmax,
  levels covering 10^-SPAN..1 of the block max (SPAN = 7). A linear
  absmax map quantizes small but active second moments to 0 and the next
  step divides by eps (JAX's note: parameter blow-ups within 5 steps);
- both moments in ONE flat (nblocks, 256) buffer over all parameters,
  every leaf starting on a block boundary (so the blocks, and the
  quantized trajectory, are those of quantizing each leaf alone), nblocks
  padded to a multiple of 8 (JAX's ZeRO-1 split of the block axis).

JAX dequantizes, updates and requantizes the whole buffer in one fused XLA
program. Eagerly that would hold the moments of every parameter in fp32
at once (40 GB at full width), so the plain version (``adam_int8_``, the
CPU's path) updates one leaf's blocks at a time, in place: the same
arithmetic on the same blocks, since no block spans two leaves. On the
card one hand-written kernel (``ops/csrc/adam_int8.cu``) does the whole
AdamW update of every leaf in one pass, the moments dequantized only in
registers (``adamw_int8_fused_``), and a multi-tensor sum of squares gives
the clip's global norm (``fused_global_norm``); both read the leaves
through a ``LeafTable``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from idmvton_tpu_torch.ops import _build
from idmvton_tpu_torch.utils import profiling

BLOCK = 256
SPAN = 7.0      # decades of dynamic range below the block absmax
# exp2 of SPAN * log2(10) * (mag / 127 - 1) is 10 ** (SPAN * (mag/127 - 1))
_EXP2_SPAN = SPAN * 3.321928094887362


def quantize(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, BLOCK) fp32 -> (int8 log-map codes (n, BLOCK), fp32 block
    absmax (n, 1)) (JAX ``_quantize``)."""
    scale = blocks.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    a = blocks.abs() / scale
    mag = torch.round(127.0 * (torch.log10(a.clamp_min(1e-30)) / SPAN + 1.0))
    mag = mag.clamp_(0.0, 127.0)
    return (torch.sign(blocks) * mag).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The fp32 values of codes ``q`` (n, BLOCK) with block absmax
    ``scale`` (n, 1) (JAX ``_dequantize``)."""
    qf = q.float()
    mag = qf.abs()
    val = torch.where(mag > 0, torch.exp2(_EXP2_SPAN * (mag / 127.0 - 1.0)),
                      torch.zeros_like(mag))
    return torch.sign(qf) * val * scale


def layout(shapes) -> Tuple[List[int], int]:
    """Per-leaf first block and the buffer's block count (JAX ``_layout``,
    in blocks): each leaf padded up to a block boundary, the total padded
    to a multiple of 8 (at least 8)."""
    offs, nb = [], 0
    for shape in shapes:
        offs.append(nb)
        nb += -(-math.prod(shape) // BLOCK)
    return offs, max(-(-nb // 8) * 8, 8)


def init_state(params: Dict[str, torch.Tensor]) -> dict:
    """Zero moments: codes 0 and scales 1e-30 (JAX ``_q_zeros``) for both,
    on the parameters' device."""
    _, nblocks = layout([p.shape for p in params.values()])
    dev = next(iter(params.values())).device
    zeros = lambda: torch.zeros(nblocks, BLOCK, dtype=torch.int8, device=dev)
    tiny = lambda: torch.full((nblocks, 1), 1e-30, dtype=torch.float32,
                              device=dev)
    return {"count": 0, "mu_q": zeros(), "mu_scale": tiny(),
            "nu_q": zeros(), "nu_scale": tiny()}


def adam_int8_(grads: Dict[str, torch.Tensor], state: dict, *, b1: float,
               b2: float, eps: float, blocks: Tuple[int, int] = None) -> None:
    """JAX ``scale_by_adam_int8``'s update: each gradient in ``grads`` is
    replaced, in place, by its bias-corrected Adam direction (mu / bc1) /
    (sqrt(nu / bc2) + eps), and the quantized moments of its blocks by the
    new ones; ``state["count"]`` advances once. ``blocks=(lo, hi)``: the
    state holds only the buffer's blocks lo..hi-1 (ZeRO-1,
    ``parallel/zero.py``); only the gradients' elements in those blocks are
    replaced."""
    count = state["count"] + 1
    bc1, bc2 = bias_corrections(b1, b2, count)
    offs, nblocks = layout([g.shape for g in grads.values()])
    lo, hi = blocks or (0, nblocks)
    for g, o in zip(grads.values(), offs):
        n = g.numel()
        nb = -(-n // BLOCK)
        first, last = max(o, lo), min(o + nb, hi)
        if first >= last:
            continue
        flat = torch.zeros(nb * BLOCK, dtype=torch.float32, device=g.device)
        flat[:n] = g.reshape(-1)
        gb = flat.view(nb, BLOCK)[first - o:last - o]
        sl = slice(first - lo, last - lo)
        mu = (b1 * dequantize(state["mu_q"][sl], state["mu_scale"][sl])
              + (1 - b1) * gb)
        nu = (b2 * dequantize(state["nu_q"][sl], state["nu_scale"][sl])
              + (1 - b2) * gb * gb)
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        a, b = (first - o) * BLOCK, min((last - o) * BLOCK, n)
        out = g.view(-1) if g.is_contiguous() else g.reshape(-1)
        out[a:b] = step.view(-1)[:b - a]
        if not g.is_contiguous():
            g.copy_(out.view(g.shape))
        state["mu_q"][sl], state["mu_scale"][sl] = quantize(mu)
        state["nu_q"][sl], state["nu_scale"][sl] = quantize(nu)
    state["count"] = count


def bias_corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """Adam's 1 - b1**t and 1 - b2**t in fp32, as optax computes them."""
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** np.float32(step)),
            float(one - np.float32(b2) ** np.float32(step)))


# ---------------------------------------------------------------------------
# the kernel (ops/csrc/adam_int8.cu)
# ---------------------------------------------------------------------------


class LeafTable:
    """The kernel's view of one parameter set, leaves in ``params``' order:
    the int64 table of their first blocks (``layout``) followed by the
    blocks they cover in all (``used``), their sizes and their masters'
    addresses, made once (``static``); and the gradients' addresses, which
    each call writes to a pinned host buffer and copies to the card with
    one non-blocking copy, only when they changed.

    The masters must stay where they are: ``key`` tells a table of the same
    tensors, and a table outlives no parameter set."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        ps = list(params.values())
        for k, p in params.items():
            if (p.dtype != torch.float32 or not p.is_contiguous()
                    or p.data_ptr() % 16):
                raise ValueError(f"{k}: the fused update takes contiguous, "
                                 f"16-byte aligned fp32 masters")
        self.device = ps[0].device
        self.first, self.nblocks = layout([p.shape for p in ps])
        self.sizes = [p.numel() for p in ps]
        self.used = self.first[-1] + -(-self.sizes[-1] // BLOCK)
        if self.used >= 2 ** 31:
            raise ValueError(f"{self.used} blocks: the kernel counts blocks "
                             f"in 32 bits")
        self.key = LeafTable.key_of(params)
        self.static = torch.tensor(
            self.first + [self.used] + self.sizes + [p.data_ptr() for p in ps],
            dtype=torch.int64).to(self.device)
        self.grads = torch.zeros(len(ps), dtype=torch.int64,
                                 device=self.device)
        self._pinned = self._copied = self._loaded = None

    @staticmethod
    def key_of(params: Dict[str, torch.Tensor]) -> tuple:
        return tuple((p.data_ptr(), p.numel()) for p in params.values())

    def span(self, blocks: Optional[Tuple[int, int]] = None
             ) -> Tuple[int, int]:
        """The blocks the kernel walks of the state's range ``blocks``
        (all ``nblocks`` by default): those a leaf covers."""
        lo, hi = blocks or (0, self.nblocks)
        return lo, max(min(hi, self.used), lo)

    def load(self, grads: Dict[str, torch.Tensor]) -> list:
        """Points the table at ``grads`` (fp32, the masters' sizes, on their
        device); returns the tensors it points at, which the caller keeps
        alive over its launch: a non-contiguous or unaligned gradient is
        read from a contiguous copy."""
        gs = []
        for (k, g), n in zip(grads.items(), self.sizes):
            if (g.dtype != torch.float32 or g.device != self.device
                    or g.numel() != n):
                raise ValueError(f"{k}: expected {n} fp32 elements on "
                                 f"{self.device}, got {g.numel()} "
                                 f"{g.dtype} on {g.device}")
            if not g.is_contiguous() or g.data_ptr() % 16:
                g = g.clone(memory_format=torch.contiguous_format)
            gs.append(g)
        if len(gs) != len(self.sizes):
            raise ValueError(f"{len(gs)} gradients for {len(self.sizes)} "
                             f"leaves")
        ptrs = [g.data_ptr() for g in gs]
        if ptrs != self._loaded:
            if self._pinned is None:
                self._pinned = torch.empty(len(ptrs), dtype=torch.int64,
                                           pin_memory=True)
            else:
                self._copied.synchronize()   # the last copy has read it
            self._pinned.numpy()[:] = ptrs
            self.grads.copy_(self._pinned, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
            self._loaded = ptrs
        return gs


def fused_global_norm(table: LeafTable,
                      grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The global norm of ``grads`` (0-dim fp32 on the card): the kernel's
    multi-tensor sum of squares, fp64 partials added in a fixed order."""
    keep = table.load(grads)    # alive over the launch
    dev = table.device
    # the kernel's grid holds at most 8 blocks of 256 threads an SM
    cap = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty(cap, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _build.call("idm_adam_int8_norm", table.static.data_ptr(),
                table.grads.data_ptr(), len(table.sizes), table.used,
                _build.ptr(partial, "partial", torch.float64), cap,
                _build.ptr(out, "out", torch.float32),
                _build.stream_ptr(dev))
    fused_global_norm.launches += 1
    return out


fused_global_norm.launches = 0


def adamw_int8_fused_(table: LeafTable, grads: Dict[str, torch.Tensor],
                      params: Dict[str, torch.Tensor], state: dict, *,
                      b1: float, b2: float, eps: float, weight_decay: float,
                      lr: float, clip: Optional[torch.Tensor] = None,
                      max_norm: float = 1.0,
                      blocks: Optional[Tuple[int, int]] = None) -> None:
    """``adam_int8_`` followed by JAX ``adamw_int8``'s decay, the learning
    rate and ``optax.apply_updates``, as one kernel over every leaf of
    ``table``: the masters ``params`` and the quantized moments in
    ``state`` are updated in place, ``state["count"]`` advances once, and
    the gradients are only read. ``clip`` (the global norm, a 0-dim tensor
    on the card): each gradient is taken as g / clip * max_norm (optax's
    ``clip_by_global_norm`` above the limit). ``blocks=(lo, hi)``: the
    state holds only the buffer's blocks lo..hi-1 (ZeRO-1), and only the
    masters' elements in those blocks change."""
    if LeafTable.key_of(params) != table.key:
        raise ValueError("the leaf table was made for other masters")
    keep = table.load(grads)    # alive over the launch
    dev = table.device
    lo, hi = blocks or (0, table.nblocks)
    for name, dtype, cols in (("mu_q", torch.int8, BLOCK),
                              ("nu_q", torch.int8, BLOCK),
                              ("mu_scale", torch.float32, 1),
                              ("nu_scale", torch.float32, 1)):
        if tuple(state[name].shape) != (hi - lo, cols):
            raise ValueError(f"{name}: shape {tuple(state[name].shape)}, "
                             f"expected {(hi - lo, cols)}")
        _build.ptr(state[name], name, dtype, dev)
    t = state["count"] + 1
    bc1, bc2 = bias_corrections(b1, b2, t)
    lo, end = table.span((lo, hi))
    if end > lo:
        _build.call("idm_adam_int8_update", table.static.data_ptr(),
                    table.grads.data_ptr(), len(table.sizes),
                    state["mu_q"].data_ptr(), state["mu_scale"].data_ptr(),
                    state["nu_q"].data_ptr(), state["nu_scale"].data_ptr(),
                    None if clip is None else _build.ptr(clip, "clip",
                                                         torch.float32, dev),
                    int(clip is not None), max_norm, b1, 1 - b1, b2, 1 - b2,
                    bc1, bc2, eps, weight_decay, -lr, _EXP2_SPAN, SPAN, lo,
                    end, _build.stream_ptr(dev))
        adamw_int8_fused_.launches += 1
        profiling.count("adamw8bit.fused_blocks", end - lo)
    state["count"] = t


adamw_int8_fused_.launches = 0
