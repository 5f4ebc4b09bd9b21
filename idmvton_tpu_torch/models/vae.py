"""AutoencoderKL (SDXL VAE): encoder / decoder with a single-head mid-block
attention, NHWC. Counterpart of ``idmvton_tpu/models/vae.py``.

Every 3x3 conv and GroupNorm here goes through ``layers.conv2d`` /
``layers.group_norm`` with ``impl=None``, as in the JAX package: on a CUDA
tensor the kernels, on a CPU tensor the plain versions. With
``VAEConfig.force_upcast`` the decode runs in fp32: the conv kernels take
the fp32 activations with the bf16 weights (fp32 out, as the TPU kernel at
DEFAULT precision) and the GroupNorm statistics kernel takes fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from idmvton_tpu_torch.core.config import VAEConfig
from idmvton_tpu_torch.models.layers import (
    Conv, Linear, Norm, conv2d, group_norm, linear,
)
from idmvton_tpu_torch.models.resnet import (
    Downsample2D, ResnetBlock, Upsample2D,
)
from idmvton_tpu_torch.ops.attention import sdpa


class VAEAttention(nn.Module):
    def __init__(self, ch, *, num_groups, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_groups = num_groups
        self.norm = Norm(ch, device=device)
        self.to_q = Linear(ch, ch, **kw)
        self.to_k = Linear(ch, ch, **kw)
        self.to_v = Linear(ch, ch, **kw)
        self.to_out = Linear(ch, ch, **kw)

    def forward(self, x):
        b, h, w, c = x.shape
        hs = group_norm(self.norm, x, num_groups=self.num_groups, eps=1e-6)
        hs = hs.reshape(b, h * w, c)
        q = linear(self.to_q, hs)[:, :, None, :]    # single head
        k = linear(self.to_k, hs)[:, :, None, :]
        v = linear(self.to_v, hs)[:, :, None, :]
        out = linear(self.to_out, sdpa(q, k, v, impl="torch")[:, :, 0, :])
        return x + out.reshape(b, h, w, c)


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig, *, dtype=torch.bfloat16,
                 device="cpu"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        chans = [cfg.base_channels * m for m in cfg.channel_mults]
        ng = cfg.norm_num_groups

        def res(i, o):
            return ResnetBlock(i, o, temb_dim=None, num_groups=ng, **kw)

        def mid():
            return nn.ModuleDict({
                "resnets": nn.ModuleList([res(chans[-1], chans[-1]),
                                          res(chans[-1], chans[-1])]),
                "attn": VAEAttention(chans[-1], num_groups=ng, **kw)})

        down = []
        in_ch = chans[0]
        for lvl, out_ch in enumerate(chans):
            blk = nn.ModuleDict({"resnets": nn.ModuleList(
                res(in_ch if i == 0 else out_ch, out_ch)
                for i in range(cfg.layers_per_block))})
            if lvl < len(chans) - 1:
                blk["downsample"] = Downsample2D(out_ch, **kw)
            down.append(blk)
            in_ch = out_ch
        self.encoder = nn.ModuleDict({
            "conv_in": Conv(cfg.in_channels, chans[0], 3, **kw),
            "down_blocks": nn.ModuleList(down),
            "mid": mid(),
            "norm_out": Norm(chans[-1], device=device),
            "conv_out": Conv(chans[-1], 2 * cfg.latent_channels, 3, **kw),
        })

        up = []
        rev = list(reversed(chans))
        in_ch = rev[0]
        for lvl, out_ch in enumerate(rev):
            blk = nn.ModuleDict({"resnets": nn.ModuleList(
                res(in_ch if i == 0 else out_ch, out_ch)
                for i in range(cfg.layers_per_block + 1))})
            if lvl < len(chans) - 1:
                blk["upsample"] = Upsample2D(out_ch, **kw)
            up.append(blk)
            in_ch = out_ch
        self.decoder = nn.ModuleDict({
            "conv_in": Conv(cfg.latent_channels, chans[-1], 3, **kw),
            "mid": mid(),
            "up_blocks": nn.ModuleList(up),
            "norm_out": Norm(chans[0], device=device),
            "conv_out": Conv(chans[0], cfg.in_channels, 3, **kw),
        })
        self.quant_conv = Conv(2 * cfg.latent_channels,
                               2 * cfg.latent_channels, 1, **kw)
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels,
                                    1, **kw)

    def _mid(self, mid, h):
        h = mid["resnets"][0](h)
        h = mid["attn"](h)
        return mid["resnets"][1](h)

    def encode_moments(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, 3) in [-1, 1] -> (mean, logvar), each (B, H/8, W/8, 4)."""
        enc = self.encoder
        h = conv2d(enc["conv_in"], x)
        for blk in enc["down_blocks"]:
            for r in blk["resnets"]:
                h = r(h)
            if "downsample" in blk:
                h = blk["downsample"](h)
        h = self._mid(enc["mid"], h)
        h = group_norm(enc["norm_out"], h,
                       num_groups=self.cfg.norm_num_groups, act="silu")
        h = conv2d(self.quant_conv, conv2d(enc["conv_out"], h))
        mean, logvar = h.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, generator: Optional[torch.Generator] = None, *,
               sample: bool = True, noise: Optional[torch.Tensor] = None):
        """Latents scaled by ``scaling_factor``; the posterior mode when
        ``sample`` is False or neither a generator nor ``noise`` is given
        (JAX ``vae_encode``). ``noise`` (the latents' shape, fp32) is the
        posterior's standard normal draw in place of one from
        ``generator``."""
        mean, logvar = self.encode_moments(x)
        z = mean
        if sample and (generator is not None or noise is not None):
            std = torch.exp(0.5 * logvar.float())
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device, dtype=torch.float32)
            elif noise.shape != mean.shape:
                raise ValueError(f"noise {tuple(noise.shape)} is not the "
                                 f"latents' {tuple(mean.shape)}")
            z = mean + (std * noise).to(mean.dtype)
        return z * torch.tensor(self.cfg.scaling_factor, dtype=z.dtype,
                                device=z.device)

    def decode(self, z):
        """z (B, h, w, 4) scaled latents -> (B, 8h, 8w, 3) in about [-1, 1]."""
        z = z / torch.tensor(self.cfg.scaling_factor, dtype=z.dtype,
                             device=z.device)
        if self.cfg.force_upcast:
            z = z.float()
        dec = self.decoder
        h = conv2d(dec["conv_in"], conv2d(self.post_quant_conv, z))
        h = self._mid(dec["mid"], h)
        for blk in dec["up_blocks"]:
            for r in blk["resnets"]:
                h = r(h)
            if "upsample" in blk:
                h = blk["upsample"](h)
        h = group_norm(dec["norm_out"], h,
                       num_groups=self.cfg.norm_num_groups, act="silu")
        return conv2d(dec["conv_out"], h)
