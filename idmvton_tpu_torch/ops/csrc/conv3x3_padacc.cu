// 3x3 stride-1 SAME convolution + bias over a zero-padded NHWC copy, with
// whole-padded-row GEMMs and a shifted fp32 accumulator.
//
// Replaces idmvton_tpu/ops/pallas_conv.py::conv3x3 with IDMVTON_CONV_PADACC=1
// (_conv3_kernel_padacc), the TPU variant that trades its per-tap input
// relayouts for GEMMs over full padded rows plus shifted output adds.
//
// Semantics: xp (B, H+2, W+2, Cin) is x zero-padded by one pixel (made by the
// wrapper, as the jnp.pad of the JAX code); out (B, H, W, Cout) =
// conv(x, w) + bias with w (3, 3, Cin, Cout) HWIO.
//
// What bounds it on the H100: tensor-core throughput, as conv3x3.cu.
// Design, the TPU variant's own: index the output on the padded grid, p =
// y * (W+2) + col. For each tap (dy, dx) the block runs one GEMM over 128
// consecutive padded pixels p' = a0 - 2 + i, reading the A rows
// xp[p' + dy * (W+2)] -- whole padded rows, contiguous, so no tap needs a
// halo predicate -- and adds the tap's product into an fp32 accumulator in
// shared memory shifted by 2 - dx: acc[p] += D[p - 2 + dx]. Output pixel
// (y, j) is acc[y * (W+2) + 2 + j]: columns [2, 2 + W) of each padded row
// are kept, and the two margin columns, which also absorb the wrap-around of
// the row before, are dropped. A block keeps 126 positions (two GEMM rows
// feed the shifts). The few A rows outside the image (at an image's first
// and last block) only feed dropped positions, so their addresses are
// clamped into the image rather than predicated. The K loop, the 3-stage
// cp.async ring and the bf16 WMMA tiles are those of conv3x3.cu; after each
// tap's last K step the warps add their fragments into the accumulator at
// the tap's shift (the loop's barriers order the adds of two taps).

#include "common.cuh"

using namespace nvcuda;
using idm::bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int KEEP = BM - 2;      // accumulator positions a block writes
constexpr int ACC_ROWS = BM + 2;  // shifts 0..2 of 128 GEMM rows
constexpr int LDA = BK + 8, LDB = BN + 8;
// fp32 accumulator pitch: 136 floats = 544 bytes, a multiple of 32, so a
// fragment shifted by whole rows stays 256-bit aligned for WMMA
constexpr int LDC = BN + 8;
constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;  // elements
constexpr size_t ACC_OFF = (size_t)STAGES * (A_STAGE + B_STAGE) * sizeof(bf16);
constexpr size_t SMEM = ACC_OFF + (size_t)ACC_ROWS * LDC * sizeof(float);

__global__ void __launch_bounds__(THREADS)
    conv3x3_padacc_kernel(const bf16* __restrict__ xp,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, int H, int W, int Cin,
                          int Cout, int tiles_per_image) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  float* Acc = reinterpret_cast<float*>(smem + ACC_OFF);

  const int tid = threadIdx.x, warp = tid >> 5;
  // 1-D grid, N tiles fastest: the blocks that share an A tile run together
  const int n_tiles = idm::cdiv(Cout, BN);
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int rest = blockIdx.x / n_tiles;
  const int b = rest / tiles_per_image;
  const int a0 = (rest % tiles_per_image) * KEEP;
  const int Wp = W + 2;
  const int img_pixels = (H + 2) * Wp;  // padded pixels of one image
  const bf16* xb = xp + (size_t)b * img_pixels * Cin;
  const int kc = Cin / BK;  // K chunks per tap
  const int KT = 9 * kc;

  for (int i = tid; i < ACC_ROWS * LDC; i += THREADS) Acc[i] = 0.f;

  // the two A rows (padded pixels p') and 16-byte chunks this thread copies
  int a_row[2], a_cc[2], a_p[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * THREADS;
    a_row[i] = id >> 2;
    a_cc[i] = id & 3;
    a_p[i] = a0 - 2 + a_row[i];
  }

  auto load_stage = [&](int stage, int kt) {
    const int tap = kt / kc, ci0 = (kt - tap * kc) * BK;
    const int dy = tap / 3;
    bf16* as = As + stage * A_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pix = min(max(a_p[i] + dy * Wp, 0), img_pixels - 1);
      idm::cp_async16(as + a_row[i] * LDA + a_cc[i] * 8,
                      xb + (size_t)pix * Cin + ci0 + a_cc[i] * 8, true);
    }
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * THREADS;
      const int r = id >> 4, cc = id & 15;
      const int n = n0 + cc * 8;
      const bool ok = n < Cout;
      const bf16* src = ok ? w + (size_t)(tap * Cin + ci0 + r) * Cout + n : w;
      idm::cp_async16(bs + r * LDB + cc * 8, src, ok);
    }
  };

  const int wm = warp / 4, wn = warp % 4;  // warp tile: 64 rows x 32 cols
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    idm::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    idm::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    idm::cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    if ((kt + 1) % kc == 0) {
      // the tap is complete: GEMM row i lands on accumulator row i + 2 - dx
      const int dx = (kt / kc) % 3;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* dst = Acc + (wm * 64 + i * 16 + 2 - dx) * LDC + wn * 32 +
                       j * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> t;
          wmma::load_matrix_sync(t, dst, LDC, wmma::mem_row_major);
#pragma unroll
          for (int e = 0; e < t.num_elements; ++e) t.x[e] += acc[i][j].x[e];
          wmma::store_matrix_sync(dst, t, LDC, wmma::mem_row_major);
          wmma::fill_fragment(acc[i][j], 0.f);
        }
    }
  }
  idm::cp_async_wait<0>();
  __syncthreads();

  // keep positions [a0, a0 + KEEP) = accumulator rows 2.. whose padded
  // column lies in [2, 2 + W); 16-byte bf16 vectors out
  const int keep_rows = min(KEEP, H * Wp - a0);
  for (int idx = tid; idx < keep_rows * (BN / 8); idx += THREADS) {
    const int l = idx / (BN / 8), c8 = (idx % (BN / 8)) * 8;
    const int p = a0 + l, y = p / Wp, col = p - y * Wp;
    const int n = n0 + c8;
    if (col < 2 || n >= Cout) continue;
    const float* src = Acc + (l + 2) * LDC + c8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[e] + (bias ? bias[n + e] : 0.f);
    *reinterpret_cast<uint4*>(out + (((size_t)b * H + y) * W + col - 2) * Cout +
                              n) = idm::pack8(v);
  }
}

}  // namespace

extern "C" int idm_conv3x3_padacc(const void* xp, const void* w,
                                  const void* bias, void* out, int B, int H,
                                  int W, int Cin, int Cout, void* stream) {
  if ((long)B * H * W <= 0) return 0;
  const long tiles = ((long)H * (W + 2) + KEEP - 1) / KEEP;
  const long blocks = (long)B * tiles * idm::cdiv(Cout, BN);
  if (Cin % BK != 0 || Cout % 8 != 0 ||
      (long)B * (H + 2) * (W + 2) > 2147483647L || blocks > 2147483647L)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = idm::allow_smem(conv3x3_padacc_kernel, SMEM);
  if (e != cudaSuccess) return (int)e;
  conv3x3_padacc_kernel<<<(unsigned)blocks, THREADS, SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xp), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, Cin,
      Cout, (int)tiles);
  return (int)cudaGetLastError();
}
