"""Spatial Transformer2D: GN -> proj_in -> BasicTransformerBlocks ->
proj_out -> + residual (SDXL ``use_linear_projection`` layout).

Counterpart of ``idmvton_tpu/models/transformer.py``; garment features flow
as explicit tuples, one per block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from idmvton_tpu_torch.models.attention import TransformerBlock
from idmvton_tpu_torch.models.layers import Linear, Norm, group_norm, linear
from idmvton_tpu_torch.parallel import tp as _tp


class Transformer2D(nn.Module):
    # the model axis once parallel.tp.shard_unet_params split proj_in /
    # proj_out: the blocks run at full width between them
    tp = None

    def __init__(self, channels, *, depth, heads, head_dim, context_dim,
                 num_groups, ip_adapter=False, dtype, device):
        super().__init__()
        inner = heads * head_dim
        kw = dict(dtype=dtype, device=device)
        self.num_groups = num_groups
        self.norm = Norm(channels, device=device)
        self.proj_in = Linear(channels, inner, **kw)
        self.blocks = nn.ModuleList([
            TransformerBlock(inner, heads=heads, head_dim=head_dim,
                             context_dim=context_dim, ip_adapter=ip_adapter,
                             **kw)
            for _ in range(depth)])
        self.proj_out = Linear(inner, channels, **kw)

    def forward(self, x, context, *, garment_mode="none",
                garment_feats: Optional[Tuple[torch.Tensor, ...]] = None,
                garment_uncond_zero=False, ip_num_tokens=0, ip_scale=1.0,
                impl=None):
        """x (B, H, W, C). consume mode takes one (B or B/2, H*W, C)
        feature per block; emit mode returns them. Returns (out, emitted)."""
        b, h, w, c = x.shape
        tp = self.tp
        hs = group_norm(self.norm, x, num_groups=self.num_groups, eps=1e-6,
                        impl=impl)
        hs = hs.reshape(b, h * w, c)
        if tp is None:
            hs = linear(self.proj_in, hs)
        else:
            hs = _tp.gather_columns(linear(self.proj_in, _tp.enter(hs, tp)),
                                    tp)
        emitted = []
        for i, blk in enumerate(self.blocks):
            gf = garment_feats[i] if garment_mode == "consume" else None
            hs, em = blk(hs, context, garment_mode=garment_mode,
                         garment_feat=gf,
                         garment_uncond_zero=garment_uncond_zero,
                         ip_num_tokens=ip_num_tokens, ip_scale=ip_scale,
                         impl=impl)
            if garment_mode == "emit":
                emitted.append(em)
        if tp is None:
            hs = linear(self.proj_out, hs)
        else:
            hs = _tp.row_linear(self.proj_out,
                                _tp.enter(hs, tp).chunk(tp.size, -1)[tp.rank],
                                tp)
        return hs.reshape(b, h, w, c) + x, tuple(emitted)
