"""AdamW with 8-bit block-quantized moments, for the reference: the
configuration's optimizer (IDM-VTON's ``--use_8bit_adam``) as the JAX
package states its codes, frozen here.

- clip by global norm (``max_grad_norm``), then per leaf:
- each moment kept as int8 codes over blocks of 256 elements of the
  flattened leaf (zero-padded), with the block's absmax in fp32: code i in
  [-127, 127] stands for sign(i) * 10 ** (7 * (|i| / 127 - 1)) * absmax
  (0 for i = 0);
- mu = b1 * deq(mu) + (1 - b1) g, nu = b2 * deq(nu) + (1 - b2) g^2; the
  step (mu / bc1) / (sqrt(nu / bc2) + eps) uses them before they are
  quantized again; p -= lr * (step + wd * p).
"""

from __future__ import annotations

import math

import torch

BLOCK = 256
SPAN = 7.0


def quantize(blocks):
    scale = blocks.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    a = (blocks.abs() / scale).clamp_min(1e-30)
    mag = torch.round(127.0 * (torch.log10(a) / SPAN + 1.0)).clamp(0.0,
                                                                   127.0)
    return (torch.sign(blocks) * mag).to(torch.int8), scale


def dequantize(q, scale):
    qf = q.float()
    mag = qf.abs()
    val = torch.where(mag > 0, 10.0 ** (SPAN * (mag / 127.0 - 1.0)),
                      torch.zeros_like(mag))
    return torch.sign(qf) * val * scale


def blocks_of(t):
    n = t.numel()
    nb = -(-n // BLOCK)
    flat = torch.zeros(nb * BLOCK, dtype=torch.float32, device=t.device)
    flat[:n] = t.reshape(-1).float()
    return flat.view(nb, BLOCK)


class AdamW8bit:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.count = 0
        self.state = {}

    def zero_state(self, name, t):
        nb = -(-t.numel() // BLOCK)
        z = lambda: torch.zeros(nb, BLOCK, dtype=torch.int8, device=t.device)
        s = lambda: torch.full((nb, 1), 1e-30, device=t.device)
        self.state[name] = [z(), s(), z(), s()]

    def clip_(self, grads: dict):
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        if norm >= self.cfg["max_grad_norm"]:
            for g in grads.values():
                g.mul_(self.cfg["max_grad_norm"] / norm)
        return norm

    def step_(self, params: dict, grads: dict):
        """Clips ``grads`` in place and updates ``params`` in place."""
        c = self.cfg
        self.clip_(grads)
        self.count += 1
        bc1 = 1.0 - c["b1"] ** self.count
        bc2 = 1.0 - c["b2"] ** self.count
        for name, p in params.items():
            if name not in self.state:
                self.zero_state(name, p)
            mq, ms, vq, vs = self.state[name]
            g = blocks_of(grads[name])
            mu = c["b1"] * dequantize(mq, ms) + (1 - c["b1"]) * g
            nu = c["b2"] * dequantize(vq, vs) + (1 - c["b2"]) * g * g
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + c["eps"])
            step = step.reshape(-1)[:p.numel()].view(p.shape)
            p.sub_(c["learning_rate"] * (step + c["weight_decay"] * p))
            self.state[name] = [*quantize(mu), *quantize(nu)]
