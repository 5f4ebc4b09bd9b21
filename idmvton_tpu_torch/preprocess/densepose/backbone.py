"""ResNet-50 + FPN backbone (frozen BN) of the DensePose R-CNN.

Counterpart of ``idmvton_tpu/preprocess/densepose/backbone.py``
(detectron2 ``build_resnet_fpn_backbone``, OUT_FEATURES res2-res5, FPN
P2-P6). FrozenBatchNorm is an inference scale + bias (``Norm``). Modules
keep the JAX tree's key names (``weights/from_jax.py``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.models.layers import (
    Conv, Norm, conv2d, resize_nearest,
)

R50_BLOCKS = (3, 4, 6, 3)
FPN_DIM = 256


def fbn(p, x):
    """FrozenBatchNorm: x * scale + bias in x's type."""
    return x * p.scale.to(x.dtype) + p.bias.to(x.dtype)


class ConvBN(nn.Module):
    """A bias-free conv and its frozen BN (JAX ``_init_conv_bn``)."""

    def __init__(self, in_ch, out_ch, k, *, dtype, device):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, k, bias=False, dtype=dtype,
                         device=device)
        self.bn = Norm(out_ch, device=device)


class Bottleneck(nn.Module):
    def __init__(self, in_ch, planes, shortcut, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBN(in_ch, planes, 1, **kw)
        self.conv2 = ConvBN(planes, planes, 3, **kw)
        self.conv3 = ConvBN(planes, planes * 4, 1, **kw)
        self.shortcut = (ConvBN(in_ch, planes * 4, 1, **kw) if shortcut
                         else None)

    def forward(self, h, stride, *, impl=None):
        y = F.relu(fbn(self.conv1.bn, conv2d(self.conv1.conv, h,
                                             stride=stride, impl=impl)))
        y = F.relu(fbn(self.conv2.bn, conv2d(self.conv2.conv, y,
                                             padding=((1, 1), (1, 1)),
                                             impl=impl)))
        y = fbn(self.conv3.bn, conv2d(self.conv3.conv, y, impl=impl))
        r = h
        if self.shortcut is not None:
            r = fbn(self.shortcut.bn, conv2d(self.shortcut.conv, h,
                                             stride=stride, impl=impl))
        return F.relu(y + r)


def max_pool_nhwc(x, k: int, stride: int, pad: int):
    """``reduce_window`` max with -inf padding, NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, pad)
    return y.permute(0, 2, 3, 1).contiguous()


class ResNet50(nn.Module):
    def __init__(self, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvBN(3, 64, 7, **kw)
        inplanes = 64
        for li, blocks in enumerate(R50_BLOCKS):
            planes = 64 * 2 ** li
            setattr(self, f"res{li + 2}", nn.ModuleList(
                Bottleneck(inplanes if bi == 0 else planes * 4, planes,
                           bi == 0, **kw) for bi in range(blocks)))
            inplanes = planes * 4

    def forward(self, x, *, impl=None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) preprocessed BGR. Returns {res2..res5} NHWC."""
        h = conv2d(self.stem.conv, x, stride=2, padding=((3, 3), (3, 3)),
                   impl=impl)
        h = max_pool_nhwc(F.relu(fbn(self.stem.bn, h)), 3, 2, 1)
        outs = {}
        for li in range(4):
            for bi, blk in enumerate(getattr(self, f"res{li + 2}")):
                h = blk(h, 2 if li and bi == 0 else 1, impl=impl)
            outs[f"res{li + 2}"] = h
        return outs


class FPN(nn.Module):
    def __init__(self, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.lateral = nn.ModuleList(Conv(d, FPN_DIM, 1, **kw)
                                     for d in (256, 512, 1024, 2048))
        self.output = nn.ModuleList(Conv(FPN_DIM, FPN_DIM, 3, **kw)
                                    for _ in range(4))

    def forward(self, feats, *, impl=None) -> List[torch.Tensor]:
        """Returns [p2, p3, p4, p5, p6] (p6 = stride-2 subsample of p5)."""
        laterals = [conv2d(self.lateral[i], feats[f"res{i + 2}"], impl=impl)
                    for i in range(4)]
        for i in range(2, -1, -1):   # top-down nearest upsample
            laterals[i] = laterals[i] + resize_nearest(
                laterals[i + 1], laterals[i].shape[1:3])
        ps = [conv2d(self.output[i], laterals[i], padding=((1, 1), (1, 1)),
                     impl=impl) for i in range(4)]
        return ps + [ps[3][:, ::2, ::2].contiguous()]
