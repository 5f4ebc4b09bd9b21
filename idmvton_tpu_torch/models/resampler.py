"""IP-Adapter-plus Perceiver Resampler: learned latent queries attend over
[image tokens | latents], then project to the UNet's context width.
Counterpart of ``idmvton_tpu/models/resampler.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.core.config import ResamplerConfig
from idmvton_tpu_torch.models.layers import (
    Linear, Norm, fill_normal_, layer_norm, linear,
)
from idmvton_tpu_torch.ops.attention import sdpa


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig, *, dtype=torch.bfloat16,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        inner = cfg.heads * cfg.dim_head
        self.latents = nn.Parameter(
            torch.empty(cfg.num_queries, cfg.dim, **kw), requires_grad=False)
        self.proj_in = Linear(cfg.embedding_dim, cfg.dim, **kw)
        self.layers = nn.ModuleList(nn.ModuleDict({
            "ln_x": Norm(cfg.dim, device=device),
            "ln_latents": Norm(cfg.dim, device=device),
            "to_q": Linear(cfg.dim, inner, bias=False, **kw),
            "to_kv": Linear(cfg.dim, 2 * inner, bias=False, **kw),
            "to_out": Linear(inner, cfg.dim, bias=False, **kw),
            "ff_ln": Norm(cfg.dim, device=device),
            "ff_in": Linear(cfg.dim, cfg.dim * cfg.ff_mult, bias=False, **kw),
            "ff_out": Linear(cfg.dim * cfg.ff_mult, cfg.dim, bias=False, **kw),
        }) for _ in range(cfg.depth))
        self.proj_out = Linear(cfg.dim, cfg.output_dim, **kw)
        self.norm_out = Norm(cfg.output_dim, device=device)

    def reset_own_parameters_(self, generator):
        fill_normal_(self.latents, self.cfg.dim ** -0.5, generator)

    def forward(self, x):
        """x (B, S, embedding_dim) image tokens -> (B, num_queries,
        output_dim) IP tokens."""
        cfg = self.cfg
        b = x.shape[0]
        heads, hd = cfg.heads, cfg.dim_head
        lat = self.latents[None].to(x.dtype).expand(b, -1, -1)
        x = linear(self.proj_in, x)
        for lyr in self.layers:
            xn = layer_norm(lyr["ln_x"], x)
            ln = layer_norm(lyr["ln_latents"], lat)
            kv_in = torch.cat([xn, ln], dim=1)
            q = linear(lyr["to_q"], ln).reshape(b, cfg.num_queries, heads, hd)
            kv = linear(lyr["to_kv"], kv_in).reshape(b, kv_in.shape[1], 2,
                                                     heads, hd)
            attn = sdpa(q, kv[:, :, 0], kv[:, :, 1], impl="torch")
            lat = lat + linear(lyr["to_out"],
                               attn.reshape(b, cfg.num_queries, heads * hd))
            h = linear(lyr["ff_in"], layer_norm(lyr["ff_ln"], lat))
            h = F.gelu(h.float()).to(lat.dtype)
            lat = lat + linear(lyr["ff_out"], h)
        return layer_norm(self.norm_out, linear(self.proj_out, lat))
