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
at once (40 GB at full width), so the port updates one leaf's blocks at a
time, in place: the same arithmetic on the same blocks, since no block
spans two leaves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

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
    one = np.float32(1.0)
    bc1 = float(one - np.float32(b1) ** np.float32(count))
    bc2 = float(one - np.float32(b2) ** np.float32(count))
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
