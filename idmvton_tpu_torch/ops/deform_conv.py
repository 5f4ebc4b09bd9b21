"""Deformable / modulated-deformable convolution in plain PyTorch.

Counterpart of ``idmvton_tpu/ops/deform_conv.py`` (the reference's CUDA
im2col in detectron2 csrc/deformable, SURVEY N1: an optional backbone op,
not on the R-50-FPN DensePose path): sample the input at grid + learned
offset positions with a batched bilinear gather (taps outside the image
read zero), then contract the K*C samples with the kernel in fp32.
"""

from __future__ import annotations

import torch


def deform_conv2d(x, offsets, kernel, *, mask=None, stride: int = 1,
                  padding: int = 1, bias=None):
    """x: (B, H, W, C); offsets: (B, Ho, Wo, 2*K) in (dy, dx) pairs per tap
    (torchvision / detectron2 channel order); kernel: (kh, kw, C, O);
    mask: optional (B, Ho, Wo, K) modulation (DCNv2). Returns (B, Ho, Wo,
    O) in x's type."""
    b, h, w, c = x.shape
    kh, kw, _, o = kernel.shape
    k = kh * kw
    _, ho, wo, _ = offsets.shape
    dev = x.device

    # base sampling grid (top-left aligned, torch semantics)
    ys = torch.arange(ho, device=dev) * stride - padding
    xs = torch.arange(wo, device=dev) * stride - padding
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev),
                            torch.arange(kw, device=dev), indexing="ij")
    base_y = ys[:, None, None] + ky.reshape(-1)[None, None, :]   # (Ho,1,K)
    base_x = xs[None, :, None] + kx.reshape(-1)[None, None, :]   # (1,Wo,K)

    off = offsets.reshape(b, ho, wo, k, 2)
    sy = base_y[None] + off[..., 0]
    sx = base_x[None] + off[..., 1]

    # bilinear sample: zero outside
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    flat = x.reshape(b, h * w, c)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(b, ho, wo, k, c)
        return torch.where(inside[..., None], vals, vals.new_zeros(()))

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    samples = ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
               + wy * (1 - wx) * v10 + wy * wx * v11)      # (B,Ho,Wo,K,C)
    if mask is not None:
        samples = samples * mask[..., None]

    out = torch.einsum("bhwkc,kco->bhwo", samples.float(),
                       kernel.reshape(k, c, o).float()).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
