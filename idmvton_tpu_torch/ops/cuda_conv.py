"""3x3 stride-1 SAME convolution (NHWC, HWIO weights).

Counterpart of ``idmvton_tpu/ops/pallas_conv.py``. Both Pallas variants --
``conv3x3`` (whole activation resident in VMEM) and ``conv3x3_hblock``
(input left in HBM, halo rows DMA'd) -- differ only in where the TPU kept
the input, so both wrappers launch the one implicit-GEMM kernel of
``csrc/conv3x3.cu``, which reads its halo tiles straight from the NHWC
input. Each wrapper keeps its own launch count.

The JAX package picks the variant by its VMEM budget. The port keeps the
same split with a size rule that reproduces that choice at every shape of
the serving path: an input of at least ``HBLOCK_MIN_BYTES`` per image takes
``conv3x3_hblock`` (the VAE's 1024x768 / 512x384 / 256x192 levels), a
smaller one ``conv3x3`` (every UNet conv, the VAE's 128x96 level). The
kernel takes a bf16 or fp32 x with bf16 weights: an fp32 x (the VAE's
``force_upcast`` decode) gives an fp32 output from bf16 operands with fp32
accumulation and bias, as the TPU kernel at ``Precision.DEFAULT``; the
wrappers raise on anything else.

The JAX package's opt-in ``IDMVTON_CONV_PADACC=1`` variant of the
``conv3x3`` sites (``_conv3_kernel_padacc``) is a kernel of its own here,
``conv3x3_padacc`` (``csrc/conv3x3_padacc.cu``), with its own count.

Both sources instantiate one templated kernel (``csrc/conv3x3.cuh``: TMA
boxes, an mbarrier ring, ``wgmma``). ``conv_plan`` picks its launch
geometry from the shape alone, so every wrapper gives one shape the same
tiles, and passes it to the C entry point.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from idmvton_tpu_torch.ops import _build

_LANE = 128
HBLOCK_MIN_BYTES = 32 * 1024 * 1024

BK = 64                      # input channels a K chunk: 128-byte A box rows
# the (BM output positions, BN output channels) tiles csrc/conv3x3.cuh is
# built for (its launch<>); BM * BN <= 40960 keeps the accumulators of a
# consumer thread at <= 160 registers
TILES = ((128, 128), (128, 160), (128, 256), (256, 128), (256, 160))
# the tiles of an fp32 x: its raw 256-byte A rows leave BM = 256 one stage
F32_TILES = TILES[:3]
SMS = 132                    # streaming multiprocessors of an H100 SXM
# TFLOP/s of each tile at shapes it divides, read on an H100 80GB HBM3 at
# 700 W by scripts/torch_conv_tiles.py: the plan's cost model
TILE_TFLOPS = {(128, 128): 600, (128, 160): 500, (128, 256): 760,
               (256, 128): 760, (256, 160): 720}
INT32_MAX = 2**31 - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TensorMap(NamedTuple):
    """A TMA descriptor as the C entry point encodes it: dims and box
    innermost first, strides in bytes of dims 1.., swizzle span in bytes,
    element size in bytes (2 bf16, 4 fp32, 1 int8)."""
    dims: tuple
    strides: tuple
    box: tuple
    swizzle: int
    elem: int = 2


class ConvPlan(NamedTuple):
    bm: int                 # output positions a tile (GEMM rows)
    bn: int                 # output channels a tile
    n_tiles: int
    m_tiles: int
    tiles: int              # m_tiles * n_tiles, N tiles fastest
    tile_h: int             # halo kernel: a tile is tile_h x tile_w pixels
    tile_w: int
    tiles_per_image: int    # padded kernel: BM-position tiles an image
    x_map: TensorMap
    w_map: TensorMap


def _pick_tile_hw(h: int, w: int, bm: int) -> tuple:
    """(tile_h, tile_w) of bm pixels: fewest padded pixels, then the
    smallest halo footprint, then the wider. 16 x 8 tiles every level of
    the serving path exactly at bm = 128 (W in 24 .. 768)."""
    best = None
    tw = 1
    while tw <= min(bm, 256):
        th = bm // tw
        if th <= 256:
            key = (_cdiv(h, th) * th * _cdiv(w, tw) * tw,
                   (th + 2) * (tw + 2), -tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
        tw *= 2
    return best[1]


def _tile_plan(b, h, w, cin, cout, padded, bm, bn, f32=False) -> ConvPlan:
    atom = 64 if bn % 64 == 0 else 32     # B box width: its swizzle span
    w_map = TensorMap((cout, cin, 9), (2 * cout, 2 * cin * cout),
                      (atom, BK, 1), 2 * atom)
    # an fp32 x: 256-byte box rows, unswizzled (the consumers narrow them)
    es, swizzle = (4, 0) if f32 else (2, 128)
    if padded:
        wp = w + 2
        tiles_per_image = _cdiv(h * wp, bm)
        tile_h = tile_w = 0
        m_tiles = b * tiles_per_image
        x_map = TensorMap((cin, b * (h + 2) * wp), (es * cin,), (BK, bm),
                          swizzle, es)
    else:
        tile_h, tile_w = _pick_tile_hw(h, w, bm)
        tiles_per_image = 0
        m_tiles = b * _cdiv(h, tile_h) * _cdiv(w, tile_w)
        x_map = TensorMap((cin, w, h, b), (es * cin, es * cin * w,
                                           es * cin * w * h),
                          (BK, tile_w, tile_h, 1), swizzle, es)
    n_tiles = _cdiv(cout, bn)
    return ConvPlan(bm, bn, n_tiles, m_tiles, m_tiles * n_tiles, tile_h,
                    tile_w, tiles_per_image, x_map, w_map)


def _cost(plan: ConvPlan, sms: int) -> float:
    """Time of the busiest SM, in units of a K chunk: waves of tiles, each
    BM x BN at its tile's measured rate."""
    return (_cdiv(plan.tiles, sms) * plan.bm * plan.bn
            / TILE_TFLOPS[plan.bm, plan.bn])


# a request has a few dozen conv shapes and the plan costs ~0.1 ms of host
# time, about a kernel's time, so each shape is planned once
@functools.lru_cache(maxsize=1024)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int,
              padded: bool = False, tile=None, sms: int = SMS,
              f32: bool = False) -> ConvPlan:
    """Launch geometry of the conv kernel for x (b, h, w, cin) and w (3, 3,
    cin, cout); ``padded``: the ``conv3x3_padacc`` kernel, whose input is
    the (b, h+2, w+2, cin) padded copy flattened to rows; ``f32``: an fp32
    x. The (BM, BN) tile is ``tile`` or, of ``TILES`` (``F32_TILES``), the
    one of least ``_cost`` on ``sms`` SMs (then fewer tiles). Raises where a
    coordinate or tile index would not fit in int32."""
    if cin % 8 or cout % 8:
        raise ValueError(f"conv3x3 kernel needs Cin % 8 == 0 and Cout % 8 "
                         f"== 0 (16-byte TMA strides), got {cin}, {cout}")
    tiles = F32_TILES if f32 else TILES
    if tile is not None:
        if tuple(tile) not in tiles:
            raise ValueError(f"conv3x3 kernel: no {tile} tile in {tiles}")
        plan = _tile_plan(b, h, w, cin, cout, padded, *tile, f32)
    else:
        plan = min((_tile_plan(b, h, w, cin, cout, padded, *t, f32)
                    for t in tiles),
                   key=lambda p: (_cost(p, sms), p.tiles))
    # the last row or coordinate a box can reach
    rows = b * (h + 2) * (w + 2)
    last = (rows + plan.tiles_per_image * plan.bm + 2 * (w + 2) + 2
            if padded else max(h, w, b) + 257)
    if max(plan.tiles, last) > INT32_MAX:
        raise ValueError(f"conv3x3 kernel: x {(b, h, w, cin)} -> {cout} "
                         f"overflows its int32 tile or row indices")
    return plan


def _cuda_plan(x, w, padded=False) -> ConvPlan:
    """The plan of a launch on x's card, after the checks that x is a CUDA
    bf16 or fp32 tensor and w its (3, 3, Cin, Cout) kernel."""
    _build.ptr(x, "x", torch.float32 if x.dtype == torch.float32
               else torch.bfloat16)
    bsz, h, wdt, cin = x.shape
    cout = w.shape[-1]
    if w.shape != (3, 3, cin, cout):
        raise ValueError(f"conv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}")
    return conv_plan(bsz, h, wdt, cin, cout, padded=padded,
                     sms=_sm_count(x.device.index),
                     f32=x.dtype == torch.float32)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3_torch(x, w, b=None):
    """Plain version (JAX ``_conv3_xla``): x (B,H,W,Cin), w (3,3,Cin,Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _launch(x, w, b, name):
    _build.no_autograd(name, x, w, b)
    plan = _cuda_plan(x, w)
    bsz, h, wdt, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty(bsz, h, wdt, cout, dtype=x.dtype, device=x.device)
    dev = x.device
    bias = None if b is None else b.float()
    _build.call("idm_conv3x3",
                _build.ptr(x, "x", x.dtype),
                _build.ptr(w, "w", torch.bfloat16, dev),
                _build.ptr(bias, "b", torch.float32, dev),
                _build.ptr(out, "out", x.dtype),
                bsz, h, wdt, cin, cout, int(x.dtype == torch.float32),
                plan.bn, plan.tile_h, plan.tile_w, _build.stream_ptr(dev))
    return out


def conv3x3(x, w, b=None):
    """x (B,H,W,Cin) bf16 or fp32, w (3,3,Cin,Cout) bf16, b (Cout,) or
    None; the output has x's type."""
    out = _launch(x, w, b, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


def conv3x3_hblock(x, w, b=None):
    """Large-activation site of the same kernel (see the module doc)."""
    out = _launch(x, w, b, "conv3x3_hblock")
    conv3x3_hblock.launches += 1
    return out


conv3x3_hblock.launches = 0


def _shape_ok(x, w) -> bool:
    # the shape part of the JAX predicates (Cin, Cout >= 128, W >= 8) plus
    # Cin % 32 and Cout % 8 (the kernel itself needs only multiples of 8:
    # 16-byte TMA strides and output vectors)
    if tuple(w.shape[:2]) != (3, 3) or x.dim() != 4:
        return False
    cin, cout, wdt = x.shape[-1], w.shape[-1], x.shape[2]
    return (cin >= _LANE and cout >= _LANE and wdt >= 8 and cin % 32 == 0
            and cout % 8 == 0)


def _image_bytes(x) -> int:
    return x[0].numel() * x.element_size()


def conv3x3_supported(x, w) -> bool:
    return _shape_ok(x, w) and _image_bytes(x) < HBLOCK_MIN_BYTES


def conv3x3_hblock_supported(x, w) -> bool:
    return _shape_ok(x, w)


def conv_padacc_enabled() -> bool:
    """JAX ``pallas_conv._padacc``: ``IDMVTON_CONV_PADACC=1``, read at call
    time, swaps the ``conv3x3`` sites to ``conv3x3_padacc``."""
    return os.environ.get("IDMVTON_CONV_PADACC", "0") == "1"


def conv3x3_padacc(x, w, b=None):
    """The padded-row variant (``csrc/conv3x3_padacc.cu``) of the same conv:
    x (B,H,W,Cin) bf16 or fp32, w (3,3,Cin,Cout) bf16, b (Cout,) or None;
    the output has x's type.

    As the TPU variant, it makes one explicit zero-padded copy of x and runs
    GEMMs over whole padded rows, so no tap needs a halo predicate, on an
    output indexed on the (W+2)-pitch padded grid whose two margin columns
    are dropped. The TPU shifted each tap's product into an fp32
    accumulator; here each tap reads its input rows shifted by
    dy * (W+2) + dx instead, so all taps share one accumulator."""
    _build.no_autograd("conv3x3_padacc", x, w, b)
    plan = _cuda_plan(x, w, padded=True)
    bsz, h, wdt, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.empty(bsz, h, wdt, cout, dtype=x.dtype, device=x.device)
    dev = x.device
    bias = None if b is None else b.float()
    _build.call("idm_conv3x3_padacc",
                _build.ptr(xp, "x", x.dtype),
                _build.ptr(w, "w", torch.bfloat16, dev),
                _build.ptr(bias, "b", torch.float32, dev),
                _build.ptr(out, "out", x.dtype),
                bsz, h, wdt, cin, cout, int(x.dtype == torch.float32),
                plan.bm, plan.bn, plan.tiles_per_image,
                _build.stream_ptr(dev))
    conv3x3_padacc.launches += 1
    return out


conv3x3_padacc.launches = 0
