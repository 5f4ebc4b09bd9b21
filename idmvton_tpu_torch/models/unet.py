"""One parametric SDXL UNet2DCondition: TryonNet, GarmentNet, vanilla SDXL.

Counterpart of ``idmvton_tpu/models/unet.py``::

  UNet(cfg)(sample, timesteps, context, added_cond=(pooled, time_ids) | None,
            garment_features=tuple | None) -> (noise_pred | None, emitted)

- consume mode takes ``cfg.num_garment_features`` features in execution
  order (down -> mid -> up), the order emit mode produces them;
- emit mode (GarmentNet, ``skip_final_output``) stops after the cross-attn
  up blocks and returns (None, features);
- ``remat=True`` (JAX ``_maybe_remat``, models/unet.py:171-228) runs each
  resnet block and each Transformer2D under ``torch.utils.checkpoint``
  (non-reentrant) where autograd records the forward: their activations
  are recomputed in the backward, so their kernels launch twice a step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from idmvton_tpu_torch.core.config import UNetConfig
from idmvton_tpu_torch.models.layers import (
    Conv, Linear, Norm, conv2d, group_norm, linear, timestep_embedding,
)
from idmvton_tpu_torch.models.resnet import (
    Downsample2D, ResnetBlock, Upsample2D,
)
from idmvton_tpu_torch.models.transformer import Transformer2D


def _mlp(in_dim, dim, kw):
    return nn.ModuleDict({"linear_1": Linear(in_dim, dim, **kw),
                          "linear_2": Linear(dim, dim, **kw)})


def _mlp_apply(p, x, dtype):
    h = linear(p["linear_1"], x)
    return linear(p["linear_2"], F.silu(h.float()).to(dtype))


def _remat(module, *args, **kw):
    """``module(*args, **kw)`` under non-reentrant checkpointing. The
    recompute runs in the backward, after an enclosing ``functional_call``
    (the training step's bf16 weights) has put the module's own parameters
    back, so the tensors it reads now are passed in again. The blocks draw
    no random numbers: no RNG state is kept."""
    params = dict(module.named_parameters())
    return checkpoint(lambda *a: functional_call(module, params, a, kw),
                      *args, use_reentrant=False, preserve_rng_state=False)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, *, dtype=torch.bfloat16,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        chans = cfg.block_out_channels
        temb_dim = chans[0] * cfg.time_embed_dim_mult
        ng = cfg.norm_num_groups
        head_dim = cfg.attention_head_dim

        def res(i, o):
            return ResnetBlock(i, o, temb_dim=temb_dim, num_groups=ng, **kw)

        def t2d(ch, depth):
            return Transformer2D(ch, depth=depth, heads=ch // head_dim,
                                 head_dim=head_dim,
                                 context_dim=cfg.cross_attention_dim,
                                 num_groups=ng, ip_adapter=cfg.ip_adapter,
                                 **kw)

        self.conv_in = Conv(cfg.in_channels, chans[0], 3, **kw)
        self.time_embedding = _mlp(chans[0], temb_dim, kw)
        self.add_embedding = (
            _mlp(cfg.projection_class_embeddings_input_dim, temb_dim, kw)
            if cfg.addition_embed else None)

        down = []
        in_ch = chans[0]
        for lvl, btype in enumerate(cfg.down_block_types):
            out_ch = chans[lvl]
            blk = nn.ModuleDict({"resnets": nn.ModuleList(
                res(in_ch if i == 0 else out_ch, out_ch)
                for i in range(cfg.layers_per_block))})
            if btype == "attn":
                blk["attentions"] = nn.ModuleList(
                    t2d(out_ch, cfg.transformer_depth[lvl])
                    for _ in range(cfg.layers_per_block))
            if lvl < cfg.num_levels - 1:
                blk["downsample"] = Downsample2D(out_ch, **kw)
            down.append(blk)
            in_ch = out_ch
        self.down_blocks = nn.ModuleList(down)

        mid_ch = chans[-1]
        self.mid_block = nn.ModuleDict({
            "resnets": nn.ModuleList([res(mid_ch, mid_ch),
                                      res(mid_ch, mid_ch)]),
            "attentions": nn.ModuleList([t2d(mid_ch,
                                             cfg.transformer_depth[-1])]),
        })

        up = []
        rev = list(reversed(chans))
        for i, btype in enumerate(cfg.up_block_types):
            lvl = cfg.num_levels - 1 - i
            if cfg.skip_final_output and btype == "plain":
                break   # GarmentNet never runs its trailing plain up blocks
            out_ch = rev[i]
            prev_out = rev[max(i - 1, 0)]
            in_skip = rev[min(i + 1, cfg.num_levels - 1)]
            resnets = []
            for j in range(cfg.layers_per_block + 1):
                res_skip = in_skip if j == cfg.layers_per_block else out_ch
                res_in = prev_out if j == 0 else out_ch
                resnets.append(res(res_in + res_skip, out_ch))
            blk = nn.ModuleDict({"resnets": nn.ModuleList(resnets)})
            if btype == "attn":
                blk["attentions"] = nn.ModuleList(
                    t2d(out_ch, cfg.transformer_depth[lvl])
                    for _ in range(cfg.layers_per_block + 1))
            if i < cfg.num_levels - 1:
                blk["upsample"] = Upsample2D(out_ch, **kw)
            up.append(blk)
        self.up_blocks = nn.ModuleList(up)

        if not cfg.skip_final_output:
            self.conv_norm_out = Norm(chans[0], device=device)
            self.conv_out = Conv(chans[0], cfg.out_channels, 3, **kw)

    def _time_embed(self, timesteps, added_cond, dtype):
        cfg = self.cfg
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = _mlp_apply(self.time_embedding, temb.to(dtype), dtype)
        if cfg.addition_embed and added_cond is not None:
            # SDXL "text_time": 6 micro-cond ids -> sinusoidal embeddings,
            # concatenated with the pooled text embedding -> 2-layer MLP
            pooled_text, time_ids = added_cond
            b = time_ids.shape[0]
            tid = timestep_embedding(time_ids.reshape(-1),
                                     cfg.addition_time_embed_dim)
            add_in = torch.cat([pooled_text.to(dtype),
                                tid.reshape(b, -1).to(dtype)], dim=-1)
            temb = temb + _mlp_apply(self.add_embedding, add_in, dtype)
        return temb

    def forward(self, sample, timesteps, context, *, added_cond=None,
                garment_features: Optional[Tuple[torch.Tensor, ...]] = None,
                garment_uncond_zero: bool = False, impl=None,
                remat: bool = False):
        """sample (B, H, W, in_channels); timesteps (B,) or scalar; context
        (B, S, cross_attention_dim). ``garment_uncond_zero``: the features
        carry only the cond half (B/2 rows) and the leading B/2 rows attend
        to all-zero garment KV. ``remat``: checkpoint each resnet block and
        Transformer2D when autograd records the call."""
        cfg = self.cfg
        dtype = sample.dtype
        mode = cfg.garment_mode
        if mode == "consume":
            n_feat = len(garment_features or ())
            if n_feat != cfg.num_garment_features:
                raise ValueError(f"{n_feat} garment features, expected "
                                 f"{cfg.num_garment_features}")
        if isinstance(timesteps, torch.Tensor):
            timesteps = timesteps.to(sample.device)
        elif isinstance(timesteps, (int, float)):
            # a fill on the device, not a copy from the host: capturable
            timesteps = torch.full((), timesteps, device=sample.device)
        else:
            timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = self._time_embed(timesteps, added_cond, dtype)
        ip_tokens = cfg.ip_num_tokens if cfg.ip_adapter else 0
        feat_idx = 0
        emitted = []
        call = (_remat if remat and torch.is_grad_enabled()
                else lambda module, *a, **kw: module(*a, **kw))

        def run_t2d(t2d, h):
            nonlocal feat_idx
            depth = len(t2d.blocks)
            gf = None
            if mode == "consume":
                gf = tuple(garment_features[feat_idx:feat_idx + depth])
                feat_idx += depth
            h, em = call(t2d, h, context, garment_mode=mode,
                         garment_feats=gf,
                         garment_uncond_zero=garment_uncond_zero,
                         ip_num_tokens=ip_tokens, ip_scale=cfg.ip_scale,
                         impl=impl)
            emitted.extend(em)
            return h

        h = conv2d(self.conv_in, sample, impl=impl)
        res_stack = [h]
        for blk in self.down_blocks:
            for i, res in enumerate(blk["resnets"]):
                h = call(res, h, temb, impl=impl)
                if "attentions" in blk:
                    h = run_t2d(blk["attentions"][i], h)
                res_stack.append(h)
            if "downsample" in blk:
                h = blk["downsample"](h, impl=impl)
                res_stack.append(h)

        mid = self.mid_block
        h = call(mid["resnets"][0], h, temb, impl=impl)
        h = run_t2d(mid["attentions"][0], h)
        h = call(mid["resnets"][1], h, temb, impl=impl)

        for blk in self.up_blocks:
            for j, res in enumerate(blk["resnets"]):
                h = torch.cat([h, res_stack.pop()], dim=-1)
                h = call(res, h, temb, impl=impl)
                if "attentions" in blk:
                    h = run_t2d(blk["attentions"][j], h)
            if "upsample" in blk:
                target = tuple(res_stack[-1].shape[1:3]) if res_stack else None
                h = blk["upsample"](h, out_hw=target, impl=impl)

        if cfg.skip_final_output:
            return None, tuple(emitted)
        h = group_norm(self.conv_norm_out, h, num_groups=cfg.norm_num_groups,
                       act="silu", impl=impl)
        return conv2d(self.conv_out, h, impl=impl), tuple(emitted)
