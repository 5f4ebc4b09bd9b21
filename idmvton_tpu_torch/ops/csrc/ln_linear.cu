// LayerNorm + GEMM (+ GEGLU epilogue), and the standalone LayerNorm.
//
// Replaces idmvton_tpu/ops/pallas_norm.py::ln_linear (_ln_mm_kernel) and
// ::fused_layer_norm (_ln_kernel).
//
// What bounds it on the H100: ln_linear is a GEMM (to_qkv 12288x640x1920,
// GEGLU 12288x1280x10240 at the serving shapes), so tensor-core throughput;
// the LayerNorm is a row reduction over x, bound by HBM bandwidth.
// Design: one block per (64-row tile, 128-column tile). The block reads its
// row tile once, normalizes it (fp32 one-pass statistics, clamped variance,
// as the JAX package) into shared memory as bf16, and runs the GEMM off it
// with bf16 WMMA tensor-core tiles and fp32 accumulation, streaming the
// weight tile through a 2-stage cp.async ring. The column tiles of one row
// tile are neighbours in the grid, so the re-read row tile comes from L2.
// GEGLU computes the value and gate halves in the same block and applies
// value * gelu(gate) (erff) in the epilogue, so the 2x-wide intermediate
// never reaches HBM. The standalone LayerNorm is one warp per row with the
// same statistics routine.

#include "common.cuh"

using namespace nvcuda;
using idm::bf16;

namespace {

constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256;
constexpr int APAD = 8, BPAD = 8, EPAD = 4;
constexpr int LDB = BN + BPAD, LDE = BN + EPAD;

// Writes LN(row) (gamma, beta applied) as bf16 to dst; warp-wide.
__device__ __forceinline__ void normalize_row(const bf16* row, bf16* dst,
                                              const float* gamma,
                                              const float* beta, int C,
                                              float mean, float inv) {
  const int lane = threadIdx.x & 31;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    idm::unpack8(*reinterpret_cast<const uint4*>(row + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = (f[i] - mean) * inv * gamma[c + i] + beta[c + i];
    *reinterpret_cast<uint4*>(dst + c) = idm::pack8(f);
  }
}

__global__ void layer_norm_kernel(const bf16* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  bf16* __restrict__ out, int M, int C,
                                  float eps) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warp leaves together
  float mean, inv;
  idm::ln_row_stats(x + row * C, C, eps, mean, inv);
  normalize_row(x + row * C, out + row * C, gamma, beta, C, mean, inv);
}

size_t a_region_bytes(int C, bool geglu) {
  size_t a = (size_t)BM * (C + APAD) * sizeof(bf16);
  size_t e = (size_t)(geglu ? 2 : 1) * BM * LDE * sizeof(float);
  size_t r = a > e ? a : e;
  return (r + 127) / 128 * 128;
}

size_t smem_bytes(int C, bool geglu) {
  return a_region_bytes(C, geglu) +
         (size_t)2 * (geglu ? 2 : 1) * BK * LDB * sizeof(bf16);
}

template <bool GEGLU>
__global__ void __launch_bounds__(THREADS)
    ln_linear_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int M, int C, int n_out, float eps, int a_region) {
  constexpr int G = GEGLU ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + APAD;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + a_region);
  float* Es = reinterpret_cast<float*>(smem);  // epilogue, aliases As

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_total = G * n_out;

  auto load_b = [&](int stage, int k0) {
    constexpr int CHUNKS = BK * BN / 8;
    for (int i = tid; i < G * CHUNKS; i += THREADS) {
      const int half = i / CHUNKS, j = i % CHUNKS;
      const int r = j / (BN / 8), cc = j % (BN / 8);
      const bf16* src = w + (size_t)(k0 + r) * n_total + half * n_out + n0 +
                        cc * 8;
      bf16* dst = Bs + ((stage * G + half) * BK + r) * LDB + cc * 8;
      idm::cp_async16(dst, src, true);
    }
  };

  load_b(0, 0);
  idm::cp_async_commit();

  // normalized row tile -> shared memory (rows past M are zeros)
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    bf16* dst = As + r * lda;
    if (row < M) {
      float mean, inv;
      idm::ln_row_stats(x + (size_t)row * C, C, eps, mean, inv);
      normalize_row(x + (size_t)row * C, dst, gamma, beta, C, mean, inv);
    } else {
      for (int c = lane * 8; c < C; c += 256)
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
    }
  }

  const int wm = warp / 4, wn = warp % 4;  // warp tile: 32 rows x 32 cols
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> accg[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      if (GEGLU) wmma::fill_fragment(accg[i][j], 0.f);
    }

  const int ktiles = C / BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_b((kt + 1) & 1, (kt + 1) * BK);
    idm::cp_async_commit();
    idm::cp_async_wait<1>();
    __syncthreads();
    const bf16* Bt = Bs + (kt & 1) * G * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * lda + kt * BK + kk,
                               lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bt + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        if (GEGLU) {
          wmma::load_matrix_sync(b, Bt + (BK + kk) * LDB + wn * 32 + j * 16,
                                 LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(accg[i][j], a[i], b, accg[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: fragments -> fp32 tile (aliasing the A tile) -> bias, GEGLU
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wm * 32 + i * 16) * LDE + wn * 32 + j * 16;
      wmma::store_matrix_sync(Es + off, acc[i][j], LDE, wmma::mem_row_major);
      if (GEGLU)
        wmma::store_matrix_sync(Es + BM * LDE + off, accg[i][j], LDE,
                                wmma::mem_row_major);
    }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, row = m0 + r;
    if (row >= M) continue;
    float v = Es[r * LDE + c] + (bias ? bias[n0 + c] : 0.f);
    if (GEGLU) {
      const float g = Es[BM * LDE + r * LDE + c] +
                      (bias ? bias[n_out + n0 + c] : 0.f);
      v *= 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
    }
    out[(size_t)row * n_out + n0 + c] = __float2bfloat16(v);
  }
}

template <bool GEGLU>
int launch_ln_linear(const bf16* x, const float* gamma, const float* beta,
                     const bf16* w, const float* bias, bf16* out, int M, int C,
                     int n_out, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, GEGLU);
  cudaError_t e = idm::allow_smem(ln_linear_kernel<GEGLU>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_out / BN, idm::cdiv(M, BM));
  ln_linear_kernel<GEGLU><<<grid, THREADS, smem, stream>>>(
      x, gamma, beta, w, bias, out, M, C, n_out, eps,
      (int)a_region_bytes(C, GEGLU));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int idm_ln_linear(const void* x, const void* gamma,
                             const void* beta, const void* w, const void* bias,
                             void* out, int M, int C, int n_out, int geglu,
                             float eps, void* stream) {
  if (M <= 0) return 0;
  if (C % BK != 0 || n_out % BN != 0) return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const bf16*>(x), static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), static_cast<const bf16*>(w),
                  static_cast<const float*>(bias), static_cast<bf16*>(out), M,
                  C, n_out, eps, static_cast<cudaStream_t>(stream));
  };
  return geglu ? args(launch_ln_linear<true>) : args(launch_ln_linear<false>);
}

extern "C" int idm_layer_norm(const void* x, const void* gamma,
                              const void* beta, void* out, int M, int C,
                              float eps, void* stream) {
  if (M <= 0) return 0;
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  constexpr int ROWS = 8;  // one warp per row
  layer_norm_kernel<<<idm::cdiv(M, ROWS), ROWS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), M, C, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* idm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
