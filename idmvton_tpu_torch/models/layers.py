"""Parameter modules and the primitive ops that use them.

Counterpart of ``idmvton_tpu/models/layers.py``. Layouts are the JAX
package's: feature maps NHWC, conv kernels HWIO ``(kh, kw, in, out)``,
linear kernels ``(in, out)``, so parameter trees load without transposes
(``weights/from_jax.py``). Parameters are frozen (``requires_grad=False``:
training differentiates fp32 masters of its own, handed to the modules
through ``torch.func.functional_call``, ``train/train_step.py``); norm
affine parameters are fp32 as in the JAX package.

``conv2d`` routes 3x3 stride-1 SAME convs to the ``conv3x3`` kernels and
``group_norm`` its statistics to ``gn_spatial_stats`` exactly where the JAX
package takes its Pallas kernels, and there the rest of the GroupNorm (group
combine, affine, SiLU: what XLA fuses for the JAX package) to ``gn_apply``;
everything else is plain PyTorch.
``IDMVTON_CONV_PADACC=1`` swaps the ``conv3x3`` sites (not the
``conv3x3_hblock`` ones) to the padded-accumulator kernel, as in JAX. The
conv kernels take an fp32 x (the VAE's fp32 decode, the preprocessing nets)
with bf16 weights; an fp32 weight reaches them as its bf16 copy
(``kernel_weight``), made once per weights version.
``QuantLinear`` is the int8 form of ``Linear`` for W8A8 serving.

The kernel sites call the kernels through ``ops.autograd``, so a forward
under autograd (training) differentiates each launch by its plain
version's VJP; a trainable weight (one that requires grad: the training
step's fresh bf16 copies of its fp32 masters) reaches them as it is, never
through ``kernel_weight``'s cached copy.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.ops.autograd import (
    conv3x3, conv3x3_hblock, conv3x3_padacc, gn_apply, gn_spatial_stats,
)
from idmvton_tpu_torch.ops.dispatch import resolve
from idmvton_tpu_torch.ops.cuda_conv import (
    conv3x3_hblock_supported, conv3x3_supported, conv3x3_torch,
    conv_padacc_enabled,
)
from idmvton_tpu_torch.ops.cuda_norm import (
    gn_apply_torch, gn_stats_supported, layer_norm_torch,
)
from idmvton_tpu_torch.ops.quant import (
    dequantize_kernel_int8, quantize_kernel_int8,
)
from idmvton_tpu_torch.parallel.sp import group_sums, halo


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def fill_normal_(t, std: float, generator: torch.Generator):
    """Seeded normal(0, std) fill (drawn in fp32, then cast)."""
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                        dtype=torch.float32).mul_(std))


# ---------------------------------------------------------------------------
# parameter modules
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """kernel (in, out), optional bias (out,)."""

    def __init__(self, in_dim, out_dim, *, bias=True, dtype, device):
        super().__init__()
        self.kernel = _param((in_dim, out_dim), dtype, device)
        self.bias = _param((out_dim,), dtype, device) if bias else None

    def reset_parameters_(self, generator):
        fill_normal_(self.kernel, 1.0 / math.sqrt(max(self.kernel.shape[0], 1)),
                     generator)
        if self.bias is not None:
            self.bias.zero_()

    def dequantized(self, dtype):
        """The projection as ``linear`` takes it: already plain."""
        return self


class Proj(NamedTuple):
    """A plain (kernel, bias) pair, as ``linear`` takes it."""
    kernel: torch.Tensor
    bias: Optional[torch.Tensor]


class QuantLinear(nn.Module):
    """An int8-quantized ``Linear`` (JAX ``ops.quant.quantize_linear_int8``
    layout and key names): ``kernel_i8`` (in, out) int8 with symmetric
    per-output-channel fp32 ``kernel_scale`` (out,), and the unquantized
    ``bias`` (or None). Built by ``quantize_linear_int8``; all three are
    parameters, so the loader's every-parameter check covers them.
    ``kernel_i8`` is the (in, out) view of (out, in) storage, the K-major
    layout the W8A8 kernel reads; ``Module.to`` and the loader's
    ``copy_`` keep it, so the weight is stored once."""

    def __init__(self, in_dim, out_dim, *, bias=None, device):
        super().__init__()
        self.kernel_i8 = nn.Parameter(
            torch.empty(out_dim, in_dim, dtype=torch.int8, device=device).t(),
            requires_grad=False)
        self.kernel_scale = _param((out_dim,), torch.float32, device)
        self.bias = bias

    def dequantized(self, dtype) -> Proj:
        """The ``dtype`` view (JAX ``pallas_norm.dequantize_int8``):
        ``kernel_i8 * kernel_scale``, and the bias."""
        return Proj(dequantize_kernel_int8(self.kernel_i8, self.kernel_scale,
                                           dtype), self.bias)


def quantize_linear_int8(lin: Linear) -> QuantLinear:
    """``Linear`` -> ``QuantLinear`` (``quantize_kernel_int8`` of its
    kernel); the bias is kept as it is."""
    w_i8, scale = quantize_kernel_int8(lin.kernel)
    q = QuantLinear(w_i8.shape[0], w_i8.shape[1], bias=lin.bias,
                    device=w_i8.device)
    with torch.no_grad():
        q.kernel_i8.copy_(w_i8)
        q.kernel_scale.copy_(scale)
    return q


class Conv(nn.Module):
    """kernel (k, k, in, out) HWIO, optional bias (out,)."""

    # the model axis once parallel.sp.shard_spatial split the rows this
    # conv sees (``conv2d`` then exchanges halo rows)
    spatial = None

    def __init__(self, in_ch, out_ch, kernel_size=3, *, bias=True, dtype,
                 device):
        super().__init__()
        self.kernel = _param((kernel_size, kernel_size, in_ch, out_ch),
                             dtype, device)
        self.bias = _param((out_ch,), dtype, device) if bias else None

    def reset_parameters_(self, generator):
        fan_in = math.prod(self.kernel.shape[:3])
        fill_normal_(self.kernel, 1.0 / math.sqrt(max(fan_in, 1)), generator)
        if self.bias is not None:
            self.bias.zero_()


class Norm(nn.Module):
    """fp32 affine ``scale`` / ``bias`` of a LayerNorm or GroupNorm."""

    spatial = None     # as Conv's (``group_norm`` then sums over the axis)

    def __init__(self, channels, *, device):
        super().__init__()
        self.scale = _param((channels,), torch.float32, device)
        self.bias = _param((channels,), torch.float32, device)

    def reset_parameters_(self, generator):
        self.scale.fill_(1.0)
        self.bias.zero_()


class Embedding(nn.Module):
    def __init__(self, vocab, dim, *, dtype, device, std=0.02):
        super().__init__()
        self.embedding = _param((vocab, dim), dtype, device)
        self.std = std

    def reset_parameters_(self, generator):
        fill_normal_(self.embedding, self.std, generator)


def reset_parameters_(module: nn.Module, generator: torch.Generator):
    """Seeded random init of every parameter, in registration order (the
    JAX package's init: fan-in normal kernels, zero biases, unit norm
    scales). A module that holds parameters of its own outside these leaf
    modules defines ``reset_own_parameters_``."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv, Norm, Embedding)):
            m.reset_parameters_(generator)
        elif hasattr(m, "reset_own_parameters_"):
            m.reset_own_parameters_(generator)


# bumped by every weights_changed_: the bf16 weight copies of
# kernel_weight are made again after it
_weights_epoch = 0


def weights_changed_(module: nn.Module) -> nn.Module:
    """Marks ``module``'s weights as rewritten or replaced (the loader, an
    in-place quantization): a CUDA graph captured over them
    (``pipeline.graph``) is captured again, and the bf16 copies of
    ``kernel_weight`` are made again."""
    global _weights_epoch
    _weights_epoch += 1
    module.weights_version = getattr(module, "weights_version", 0) + 1
    return module


def weights_version(module: nn.Module) -> int:
    """The sum of ``weights_changed_`` marks over ``module`` and its
    submodules."""
    return sum(getattr(m, "weights_version", 0) for m in module.modules())


def kernel_weight(owner: nn.Module) -> torch.Tensor:
    """``owner.kernel`` as the kernels take a weight: bf16 (their operands
    are bf16, accumulated in fp32: the TPU kernels' DEFAULT precision). A
    bf16 weight passes as it is; another type (an fp32 stack, the fp32
    preprocessing nets) gets a bf16 copy kept on ``owner``, made once per
    weights version: again after any ``weights_changed_`` or when the
    weight moves, never at every call. A weight that requires grad (an
    fp32 master under training, which the optimizer updates in place, so
    neither the epoch nor the address would tell a stale copy) is cast at
    every call, inside the autograd graph."""
    w = owner.kernel
    if w.dtype == torch.bfloat16:
        return w
    if w.requires_grad:
        return w.to(torch.bfloat16)
    key = (_weights_epoch, w.data_ptr(), w.device)
    cached = owner.__dict__.get("_kernel_bf16")
    if cached is None or cached[0] != key:
        cached = (key, w.detach().to(torch.bfloat16))
        owner.__dict__["_kernel_bf16"] = cached
    return cached[1]


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------


def linear(p, x):
    """x @ kernel (+ bias), product rounded to x's type (JAX ``linear``)."""
    y = torch.matmul(x, p.kernel.to(x.dtype))
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def _same_pads(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_torch(x, kernel, bias=None, *, stride: int = 1, padding="SAME"):
    """Plain NHWC conv with JAX padding semantics ("SAME", "VALID" or
    explicit ((top, bottom), (left, right)))."""
    k = kernel.shape[0]
    if padding == "SAME":
        padding = (_same_pads(x.shape[1], k, stride),
                   _same_pads(x.shape[2], k, stride))
    elif padding == "VALID":
        padding = ((0, 0), (0, 0))
    (pt, pb), (pl, pr) = padding
    xc = x.permute(0, 3, 1, 2)
    if (pt, pb, pl, pr) != (0, 0, 0, 0):
        xc = F.pad(xc, (pl, pr, pt, pb))
    y = F.conv2d(xc, kernel.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1).contiguous()
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def conv2d(p, x, *, stride: int = 1, padding="SAME", impl=None):
    """Once ``parallel.sp.shard_spatial`` handed ``p`` its axis
    (``p.spatial``), ``x`` holds this rank's H rows of the feature map: a
    3x3 stride-1 SAME conv runs on them with a neighbour's row above and
    below and drops its two halo output rows; the stride-2 downsample
    (padding (0, 1) below) takes the next rank's first row."""
    sp, k = p.spatial, p.kernel
    if sp is None or k.shape[0] == 1:
        return _conv2d(p, x, stride=stride, padding=padding, impl=impl)
    if stride == 2 and padding == ((0, 1), (0, 1)):
        return _conv2d(p, halo(x, sp, above=0, below=1), stride=2,
                       padding=((0, 0), (0, 1)), impl=impl)
    if not (stride == 1 and k.shape[0] == 3
            and padding in ("SAME", ((1, 1), (1, 1)))):
        raise ValueError(f"spatial parallelism takes 1x1 convs, 3x3 "
                         f"stride-1 SAME ones and the downsample, not "
                         f"{tuple(k.shape)} stride {stride} padding "
                         f"{padding}")
    y = _conv2d(p, halo(x, sp, above=1, below=1), stride=1,
                padding="SAME", impl=impl)
    return y[:, 1:-1].contiguous()


def _conv2d(p, x, *, stride: int, padding, impl):
    k = p.kernel
    if (stride == 1 and tuple(k.shape[:2]) == (3, 3)
            and padding in ("SAME", ((1, 1), (1, 1)))):
        if resolve(impl, x) == "cuda":
            # the kernels take bf16 weights for a bf16 or an fp32 x (bf16
            # operands, fp32 accumulation: the TPU kernel's DEFAULT
            # precision), so an fp32 x does not upcast them
            kk = kernel_weight(p)
            if conv3x3_supported(x, kk):
                if conv_padacc_enabled():
                    return conv3x3_padacc(x, kk, p.bias)
                return conv3x3(x, kk, p.bias)
            if conv3x3_hblock_supported(x, kk):
                return conv3x3_hblock(x, kk, p.bias)
        return conv3x3_torch(x, k, p.bias)
    return conv2d_torch(x, k, p.bias, stride=stride, padding=padding)


def group_norm(p, x, *, num_groups: int, eps: float = 1e-5,
               act: Optional[str] = None, impl=None):
    """GroupNorm over channel-last input of any spatial rank, one-pass fp32
    statistics per channel combined into groups, optional fused SiLU.
    Once ``p.spatial`` is set (``parallel.sp.shard_spatial``), ``x`` holds
    this rank's rows; the per-channel sums and counts of every rank are
    added before the statistics."""
    spatial = p.spatial
    b, c = x.shape[0], x.shape[-1]
    n_spatial = x.numel() // (b * c)
    kw = dict(num_groups=num_groups, eps=eps, silu=act == "silu")
    if (resolve(impl, x) == "cuda" and gn_stats_supported(x)
            and n_spatial >= 64):
        s1, s2 = gn_spatial_stats(x)
        mean_c, mean2_c = group_sums(s1, s2, n_spatial, spatial)
        return gn_apply(x, mean_c, mean2_c, p.scale.float(), p.bias.float(),
                        **kw)
    xf = x.float().reshape(b, -1, c)
    if spatial is not None:
        mean_c, mean2_c = group_sums(xf.sum(1), xf.square().sum(1),
                                     n_spatial, spatial)
    else:
        mean_c, mean2_c = xf.mean(1), xf.square().mean(1)
    return gn_apply_torch(x, mean_c, mean2_c, p.scale.float(),
                          p.bias.float(), **kw)


def layer_norm(p, x, *, eps: float = 1e-5):
    return layer_norm_torch(x, p.scale, p.bias, eps)


def timestep_embedding(timesteps, dim: int, *, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0):
    """Sinusoidal fp32 embedding (diffusers Timesteps, flip_sin_to_cos)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device)
                      / (half - downscale_freq_shift))
    args = timesteps.float()[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def resize_nearest(x, out_hw):
    """NHWC nearest resize with half-pixel centres, as
    ``jax.image.resize(..., "nearest")`` (torch ``"nearest-exact"``):
    source index floor((i + 0.5) * in / out)."""
    h, w = x.shape[1], x.shape[2]
    th, tw = out_hw

    def idx(n_in, n_out):
        i = torch.arange(n_out, device=x.device, dtype=torch.float64)
        return ((i + 0.5) * (n_in / n_out)).floor().long().clamp_(max=n_in - 1)

    return x.index_select(1, idx(h, th)).index_select(2, idx(w, tw))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "gelu": F.gelu,
    "quick_gelu": quick_gelu,
}
