// 3x3 stride-1 SAME convolution + bias, NHWC input, HWIO weights.
//
// Replaces idmvton_tpu/ops/pallas_conv.py::conv3x3 (_conv3_kernel) and
// ::conv3x3_hblock (_conv3_hblock_kernel). The two Pallas kernels differ
// only in where the TPU kept the input (whole activation in VMEM, or HBM
// with DMA'd halo rows); this one kernel serves both call sites.
//
// What bounds it on the H100: tensor-core throughput (an implicit GEMM of
// M = B*H*W pixels, N = Cout, K = 9*Cin; e.g. 49152 x 640 x 5760 at the
// UNet's 128x96 level, ~700 FLOP a byte moved).
// Design (conv3x3.cuh, mode kHalo): output tiles of Ht x Wt = 128 or 256
// pixels of one image; each tap's A tile is one 4-D TMA box of the NHWC
// input whose out-of-image part (the halo) TMA zero-fills, the B tile a box
// of the HWIO weights read in place; a TMA/mbarrier ring feeds two wgmma
// consumer warpgroups; persistent blocks; bias and the one bf16 rounding in
// the register epilogue. The tile shape and N tile come from the wrapper's
// plan (cuda_conv.py::conv_plan). An fp32 x (f32) gives an fp32 output from
// the same bf16 weights (the F32 instance of conv3x3.cuh).

#include "conv3x3.cuh"

// x (B, H, W, Cin) bf16, or fp32 with f32 (then out is fp32); w (3, 3, Cin,
// Cout) bf16; bias (Cout,) fp32 or NULL; then the plan: bn and the tile_h x
// tile_w pixels of a tile
extern "C" int idm_conv3x3(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int Cin, int Cout,
                           int f32, int bn, int tile_h, int tile_w,
                           void* stream) {
  using namespace idm_conv;
  if ((long)B * H * W <= 0) return 0;
  const int bm = tile_h * tile_w;
  if (Cin % 8 != 0 || Cout % 8 != 0 || bn <= 0 || tile_h <= 0 ||
      tile_w <= 0 || tile_w > 256 || tile_h > 256)
    return (int)cudaErrorInvalidValue;
  Geom g{};
  g.H = H, g.W = W, g.Cout = Cout, g.kc = idm::cdiv(Cin, BK);
  g.tile_h = tile_h, g.tile_w = tile_w;
  g.tiles_x = idm::cdiv(W, tile_w), g.tiles_y = idm::cdiv(H, tile_h);
  g.n_tiles = idm::cdiv(Cout, bn);
  const long tiles = (long)B * g.tiles_y * g.tiles_x * g.n_tiles;
  if (tiles > 2147483647L) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * es,
                                 (cuuint64_t)Cin * W * es,
                                 (cuuint64_t)Cin * W * H * es};
  const cuuint32_t box[4] = {BK, (cuuint32_t)tile_w, (cuuint32_t)tile_h, 1};
  // fp32: 256-byte box rows, unswizzled (the consumers narrow them)
  cudaError_t e = idm::encode_tiled(&xmap, x, 4, dims, strides, box,
                                    f32 ? 0 : 128, f32 ? 4 : 2);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) return (int)launch<kHalo, true>(bm, bn, xmap, w, Cin, bias, out, g, st);
  return (int)launch<kHalo>(bm, bn, xmap, w, Cin, bias, out, g, st);
}
