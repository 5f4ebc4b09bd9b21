"""Image quality metrics: SSIM, PSNR and LPIPS (counterpart of
``idmvton_tpu/utils/metrics.py``).

The reference computes no quality metric; these serve the golden-image
gate (SSIM >= 0.99 against the reference's outputs) and VITON-HD
evaluation. Images are NHWC in [-1, 1] (data range 2.0).

- SSIM's 11x11 Gaussian window is a depthwise ``F.conv2d`` (groups = C),
  VALID, in fp32, as JAX's ``lax.conv`` outside any kernel.
- LPIPS's VGG16 runs through ``models.layers.conv2d``, so on the card its
  3x3 convs of >= 128 channels take the conv kernels (#5 / #6) on fp32
  activations, as JAX's ``conv2d`` takes its Pallas kernel. The network
  is an ``LPIPS`` module with JAX's tree layout ({"vgg": [conv ...],
  "lin": [conv ...]}); ``convert_lpips`` reads torchvision's
  ``vgg16.features.*`` and the lpips package's ``lin{0-4}.model.1.weight``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.models.layers import Conv, conv2d, reset_parameters_


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a, b, *, data_range: float = 2.0, window: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over (B, H, W, C) images (range 2.0 for [-1, 1])."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ch = a.shape[-1]
    kern = _gaussian_kernel(window, sigma).to(a.device)[None, None].expand(
        ch, 1, window, window)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kern, groups=ch)

    a, b = a.float(), b.float()
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = filt(a * a) - mu_aa
    var_b = filt(b * b) - mu_bb
    cov = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * cov + c2)
         / ((mu_aa + mu_bb + c1) * (var_a + var_b + c2)))
    return s.mean()


def psnr(a, b, *, data_range: float = 2.0) -> torch.Tensor:
    mse = (a.float() - b.float()).square().mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


# ---------------------------------------------------------------------------
# LPIPS (VGG16 backbone + linear heads)
# ---------------------------------------------------------------------------

_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)
_TAP_LAYERS = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """The VGG16 convs (``vgg``) and the five 1x1 heads (``lin``)."""

    def __init__(self, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        convs, taps, in_ch = [], [], 3
        for v in _VGG_CFG:
            if v == "M":
                continue
            if len(convs) in _TAP_LAYERS:
                taps.append(v)
            convs.append(Conv(in_ch, v, 3, **kw))
            in_ch = v
        self.vgg = nn.ModuleList(convs)
        self.lin = nn.ModuleList(Conv(ch, 1, 1, bias=False, **kw)
                                 for ch in taps)


def init_lpips(seed: int = 0, *, dtype=torch.float32,
               device="cuda") -> LPIPS:
    """Random-init LPIPS(VGG) (the JAX package's init); real weights
    through ``convert_lpips``."""
    net = LPIPS(dtype=dtype, device=device)
    reset_parameters_(net, torch.Generator(device=device).manual_seed(seed))
    return net


def _max_pool2(h):
    """2x2 stride-2 VALID max pool, NHWC."""
    b, hh, ww, c = h.shape
    h = h[:, :hh // 2 * 2, :ww // 2 * 2]
    return h.reshape(b, hh // 2, 2, ww // 2, 2, c).amax((2, 4))


def lpips(net: LPIPS, a, b, *, impl=None) -> torch.Tensor:
    """LPIPS distance (B,) between (B, H, W, 3) images in [-1, 1]."""
    shift = torch.from_numpy(_SHIFT).to(a.device)
    scale = torch.from_numpy(_SCALE).to(a.device)

    def features(x):
        h = (x.float() - shift) / scale
        feats, conv_i = [], 0
        for v in _VGG_CFG:
            if v == "M":
                h = _max_pool2(h)
                continue
            h = F.relu(conv2d(net.vgg[conv_i], h, padding=((1, 1), (1, 1)),
                              impl=impl))
            if conv_i in _TAP_LAYERS:
                feats.append(h)
            conv_i += 1
        return feats

    total = 0.0
    for lin, x, y in zip(net.lin, features(a), features(b)):
        xn = x / torch.sqrt(x.square().sum(-1, keepdim=True) + 1e-10)
        yn = y / torch.sqrt(y.square().sum(-1, keepdim=True) + 1e-10)
        d = conv2d(lin, (xn - yn).square(), impl=impl)
        total = total + d.mean(dim=(1, 2, 3))
    return total


def convert_lpips(vgg_sd, lin_sd, *, dtype=torch.float32,
                  device="cuda") -> LPIPS:
    """torchvision ``vgg16.features.*`` + lpips ``lin{0-4}.model.1.weight``
    (OIHW arrays or tensors) -> ``LPIPS`` (HWIO kernels)."""
    net = LPIPS(dtype=dtype, device=device)

    def hwio(w):
        return torch.as_tensor(np.asarray(w)).permute(2, 3, 1, 0)

    with torch.no_grad():
        for conv, li in zip(net.vgg, _expand_vgg_layer_ids()):
            conv.kernel.copy_(hwio(vgg_sd[f"features.{li}.weight"]))
            conv.bias.copy_(torch.as_tensor(
                np.asarray(vgg_sd[f"features.{li}.bias"])))
        for i, lin in enumerate(net.lin):
            lin.kernel.copy_(hwio(lin_sd[f"lin{i}.model.1.weight"]))
    return net


def _expand_vgg_layer_ids():
    """torchvision vgg16.features indices of the conv layers."""
    ids, i = [], 0
    for v in _VGG_CFG:
        if v == "M":
            i += 1  # pool layer
            continue
        ids.append(i)
        i += 2      # conv + relu
    return ids
