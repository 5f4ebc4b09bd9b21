// W8A8 int8 LayerNorm + GEMM (+ GEGLU epilogue).
//
// Replaces idmvton_tpu/ops/pallas_norm.py::ln_linear on an int8-quantized
// projection (_ln_mm_forward_i8 / _ln_mm_kernel_i8).
//
// Semantics: xn = LN(x) in fp32 (one-pass statistics, clamped variance);
// per row rs = max(max |xn|, 1e-8) / 127; codes q = clamp(rint(xn * (1/rs)),
// -127, 127), rounding half to even; an s8 x s8 -> s32 GEMM with the
// per-output-channel int8 weight; then acc * rs * w_scale + b in fp32 and,
// for GEGLU, value * gelu(gate) with the erf gelu of ln_linear.cu.
//
// What bounds it on the H100: the GEMM (TryonNet to_qkv 12288x640x1920,
// the 1280-channel GEGLU 3072x1280x10240 at the serving shapes), on the int8
// tensor cores.
// Design: one block per (64-row tile, 128-column tile), as ln_linear.cu. The
// TPU kernel quantizes its row tile once, at the first column step, and
// keeps the codes in VMEM for the later steps; CUDA blocks run in parallel
// and in no order, so every column block recomputes its rows' statistics,
// absmax and codes (three warp passes over a row that stays in L1/L2) into
// shared memory. The GEMM runs on int8 WMMA tiles (16x16x16, int32
// accumulate) off that tile while the int8 weight tile streams through a
// 2-stage cp.async ring. WMMA wants 256-bit aligned tile pointers and a
// 16-deep int8 step is only 16 bytes, so both shared tiles are k-blocked --
// A as [C/16][64 rows][16], B as [128/16][BK][16] -- which makes every
// 16x16 sub-tile one contiguous, aligned 256-byte run.

#include "common.cuh"

using namespace nvcuda;
using idm::bf16;

namespace {

constexpr int BM = 64, BN = 128, BK = 64, THREADS = 256;
constexpr int LDE = BN + 4;  // int32 epilogue tile

// The A tile (or the int32 epilogue tile that aliases it), then the 2-stage
// B ring, then the 64 row scales.
size_t a_region_bytes(int C, bool geglu) {
  size_t a = (size_t)BM * C;
  size_t e = (size_t)(geglu ? 2 : 1) * BM * LDE * sizeof(int);
  size_t r = a > e ? a : e;
  return (r + 127) / 128 * 128;
}

size_t smem_bytes(int C, bool geglu) {
  return a_region_bytes(C, geglu) + (size_t)2 * (geglu ? 2 : 1) * BK * BN +
         BM * sizeof(float);
}

// (x - mean) * inv * gamma + beta with every operation rounded on its own
// (no FMA contraction), as the plain version computes it elementwise.
__device__ __forceinline__ float ln_elem(float f, float mean, float inv,
                                         float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f, mean), inv), g), b);
}

template <bool GEGLU>
__global__ void __launch_bounds__(THREADS)
    ln_linear_i8_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        int M, int C, int n_out, float eps, int a_region) {
  constexpr int G = GEGLU ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int* Es = reinterpret_cast<int*>(smem);  // epilogue, aliases As
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + a_region);
  float* rs_s = reinterpret_cast<float*>(smem + a_region + 2 * G * BK * BN);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_total = G * n_out;

  // B stage layout: [half][BN/16][BK][16]
  auto load_b = [&](int stage, int k0) {
    constexpr int CHUNKS = BK * BN / 16;
    for (int i = tid; i < G * CHUNKS; i += THREADS) {
      const int half = i / CHUNKS, j = i % CHUNKS;
      const int r = j / (BN / 16), cc = j % (BN / 16);
      const int8_t* src = w + (size_t)(k0 + r) * n_total + half * n_out + n0 +
                          cc * 16;
      int8_t* dst = Bs + ((stage * G + half) * (BN / 16) + cc) * (BK * 16) +
                    r * 16;
      idm::cp_async16(dst, src, true);
    }
  };

  load_b(0, 0);
  idm::cp_async_commit();

  // LN -> row absmax -> codes, one warp per row (rows past M: codes 0)
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    if (row < M) {
      const bf16* xr = x + (size_t)row * C;
      float mean, inv;
      idm::ln_row_stats(xr, C, eps, mean, inv);
      float amax = 0.f;
      for (int c = lane * 8; c < C; c += 256) {
        float f[8];
        idm::unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          amax = fmaxf(amax, fabsf(ln_elem(f[i], mean, inv, gamma[c + i],
                                           beta[c + i])));
      }
      amax = idm::warp_max(amax);
      const float rs = fmaxf(amax, 1e-8f) / 127.f;
      const float rcp = 1.f / rs;
      for (int c = lane * 8; c < C; c += 256) {
        float f[8];
        idm::unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
        union {
          int8_t q[8];
          uint2 v;
        } codes;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xn = ln_elem(f[i], mean, inv, gamma[c + i], beta[c + i]);
          const int q = __float2int_rn(__fmul_rn(xn, rcp));
          codes.q[i] = (int8_t)max(-127, min(127, q));
        }
        *reinterpret_cast<uint2*>(As + (c / 16) * (BM * 16) + r * 16 +
                                  (c % 16)) = codes.v;
      }
      if (lane == 0) rs_s[r] = rs;
    } else {
      for (int c = lane * 8; c < C; c += 256)
        *reinterpret_cast<uint2*>(As + (c / 16) * (BM * 16) + r * 16 +
                                  (c % 16)) = make_uint2(0, 0);
      if (lane == 0) rs_s[r] = 0.f;
    }
  }

  const int wm = warp / 4, wn = warp % 4;  // warp tile: 32 rows x 32 cols
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> accg[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0);
      if (GEGLU) wmma::fill_fragment(accg[i][j], 0);
    }

  const int ktiles = C / BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_b((kt + 1) & 1, (kt + 1) * BK);
    idm::cp_async_commit();
    idm::cp_async_wait<1>();
    __syncthreads();
    const int8_t* Bt = Bs + (kt & 1) * G * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int kb = (kt * BK + kk) / 16;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], reinterpret_cast<const signed char*>(
                      As + ((size_t)kb * BM + wm * 32 + i * 16) * 16),
            16);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major>
            b;
        wmma::load_matrix_sync(
            b, reinterpret_cast<const signed char*>(
                   Bt + ((wn * 2 + j) * BK + kk) * 16),
            16);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        if (GEGLU) {
          wmma::load_matrix_sync(
              b, reinterpret_cast<const signed char*>(
                     Bt + BK * BN + ((wn * 2 + j) * BK + kk) * 16),
              16);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(accg[i][j], a[i], b, accg[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: int32 fragments -> tile (aliasing A) -> dequant, bias, GEGLU
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
    const float rs = rs_s[r];
    float v = __fmul_rn(__fmul_rn((float)Es[r * LDE + c], rs), w_scale[n0 + c]);
    if (bias) v = __fadd_rn(v, bias[n0 + c]);
    if (GEGLU) {
      float g = __fmul_rn(__fmul_rn((float)Es[BM * LDE + r * LDE + c], rs),
                          w_scale[n_out + n0 + c]);
      if (bias) g = __fadd_rn(g, bias[n_out + n0 + c]);
      v *= 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
    }
    out[(size_t)row * n_out + n0 + c] = __float2bfloat16(v);
  }
}

template <bool GEGLU>
int launch(const bf16* x, const float* gamma, const float* beta,
           const int8_t* w, const float* w_scale, const float* bias, bf16* out,
           int M, int C, int n_out, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, GEGLU);
  cudaError_t e = idm::allow_smem(ln_linear_i8_kernel<GEGLU>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_out / BN, idm::cdiv(M, BM));
  ln_linear_i8_kernel<GEGLU><<<grid, THREADS, smem, stream>>>(
      x, gamma, beta, w, w_scale, bias, out, M, C, n_out, eps,
      (int)a_region_bytes(C, GEGLU));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int idm_ln_linear_i8(const void* x, const void* gamma,
                                const void* beta, const void* w_i8,
                                const void* w_scale, const void* bias,
                                void* out, int M, int C, int n_out, int geglu,
                                float eps, void* stream) {
  if (M <= 0) return 0;
  if (C % BK != 0 || n_out % BN != 0 || idm::cdiv(M, BM) > 65535 ||
      smem_bytes(C, geglu != 0) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch_fn) {
    return launch_fn(static_cast<const bf16*>(x),
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(beta),
                     static_cast<const int8_t*>(w_i8),
                     static_cast<const float*>(w_scale),
                     static_cast<const float*>(bias), static_cast<bf16*>(out),
                     M, C, n_out, eps, static_cast<cudaStream_t>(stream));
  };
  return geglu ? args(launch<true>) : args(launch<false>);
}
