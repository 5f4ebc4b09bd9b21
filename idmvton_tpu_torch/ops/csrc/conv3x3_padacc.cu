// 3x3 stride-1 SAME convolution + bias over a zero-padded NHWC copy, with
// GEMMs over whole padded rows.
//
// Replaces idmvton_tpu/ops/pallas_conv.py::conv3x3 with IDMVTON_CONV_PADACC=1
// (_conv3_kernel_padacc), the TPU variant that trades its per-tap input
// relayouts for GEMMs over full padded rows plus shifted output adds.
//
// Semantics: xp (B, H+2, W+2, Cin) is x zero-padded by one pixel (made by the
// wrapper, as the jnp.pad of the JAX code); out (B, H, W, Cout) =
// conv(x, w) + bias with w (3, 3, Cin, Cout) HWIO.
//
// What bounds it on the H100: tensor-core throughput, as conv3x3.cu, plus
// 2/(W+2) more GEMM rows (the margin columns) and the padded copy.
// Design (conv3x3.cuh, mode kPadded): the variant's padded-row GEMMs with the
// tap's shift moved from the output to the input. The output is indexed on
// the padded grid, p = y * (W+2) + j, in tiles of BM (128 or 256) positions
// of one image (BM and tiles_per_image from the wrapper's plan). Output p of
// tap (dy, dx) reads row p + dy * (W+2) + dx of xp flattened to
// (B*(H+2)*(W+2), Cin), so each tap's A tile is one 2-D TMA box of BM
// consecutive rows -- no halo predicate -- and all nine taps accumulate into
// the same wgmma registers: the TPU kernel's shifted fp32 accumulator and its
// read-modify-write passes are gone. Rows past the tensor are zero-filled
// by TMA; the positions they feed (j >= W, or past the image's H * (W+2))
// are dropped at the store. An fp32 xp (f32) gives an fp32 output, as
// conv3x3.cu's fp32 instance.

#include "conv3x3.cuh"

extern "C" int idm_conv3x3_padacc(const void* xp, const void* w,
                                  const void* bias, void* out, int B, int H,
                                  int W, int Cin, int Cout, int f32, int bm,
                                  int bn, int tiles_per_image, void* stream) {
  using namespace idm_conv;
  if ((long)B * H * W <= 0) return 0;
  const long rows = (long)B * (H + 2) * (W + 2);
  const long tiles =
      (long)B * tiles_per_image * idm::cdiv(Cout, bn > 0 ? bn : 1);
  if (Cin % 8 != 0 || Cout % 8 != 0 || bm <= 0 || bm > 256 || bn <= 0 ||
      (long)tiles_per_image * bm < (long)H * (W + 2) ||
      rows + (long)tiles_per_image * bm + 2L * (W + 2) + 2 > 2147483647L ||
      tiles > 2147483647L)
    return (int)cudaErrorInvalidValue;
  Geom g{};
  g.H = H, g.W = W, g.Cout = Cout, g.kc = idm::cdiv(Cin, BK);
  g.tiles_per_image = tiles_per_image;
  g.n_tiles = idm::cdiv(Cout, bn);
  g.tiles = (int)tiles;
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)Cin, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Cin * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {BK, (cuuint32_t)bm};
  cudaError_t e = idm::encode_tiled(&xmap, xp, 2, dims, strides, box,
                                    f32 ? 0 : 128, f32 ? 4 : 2);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)launch<kPadded, true>(bm, bn, xmap, w, Cin, bias, out, g, st);
  return (int)launch<kPadded>(bm, bn, xmap, w, Cin, bias, out, g, st);
}
