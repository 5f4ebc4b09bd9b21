// GroupNorm on the card: #3, the spatial statistics (per-(B, C) fp32 sum
// and sum of squares), and #13, the apply (group combine, affine, SiLU).
// Between the two, models/layers.py::group_norm turns the sums into
// per-channel means (parallel/sp.py::group_sums, which adds the sums of
// every rank first on the spatial-parallel path).
//
// #3 replaces idmvton_tpu/ops/pallas_norm.py::gn_spatial_stats
// (_gn_stats_kernel). What bounds it on the H100: one read of x, so HBM
// bandwidth (the VAE's (6, 1024, 768, 128) bf16 input is 1.2 GB).
// Design: the TPU kernel carried its sums across the sequential grid; here
// blocks run in parallel, so pass 1 gives each block a (batch, 64-channel,
// 256-row) slab: a lane owns a channel pair (one 4-byte load per row, a warp
// covers 64 contiguous channels), the 8 warps stride over the rows, and the
// block's fp32 partials go to a scratch buffer. Pass 2 adds the partials of
// each (B, C) in a fixed order -- deterministic, no atomics.
//
// #13 replaces no Pallas kernel: the JAX package leaves the tail after the
// statistics to XLA, which fuses it into one pass. Run eagerly (and so in
// the captured step) it was ~11 small launches for the group combine and
// five fp32 passes over x (widen, scale, shift, SiLU, narrow: 36 bytes an
// element of bf16 x), the fp32 temporaries setting the VAE encode's peak.
// What bounds it on the H100: HBM bytes, one read of x and one write of the
// output in x's type, plus the (B, C) means and the (C,) affine, over
// 3.35 TB/s. With SiLU on bf16 x the exact expf and IEEE division add
// enough instructions an element that instruction throughput limits it
// too (the VAE's (6, 1024, 768, 128): 0.96 ms against 0.72 ms of bytes on
// an H100).
// Design: at most one wave of blocks; the blocks of a (batch, 128-channel)
// column walk its chunks of rows in a block-stride loop, so the UNets'
// small levels leave no tail wave and the prologue runs once a block. The
// prologue combines the channel means of the groups that meet the block's
// 128 channels (a warp a group, lanes summing in a fixed order) into mean
// and rsqrt(max(E[x^2] - E[x]^2, 0) + eps), then each channel's
// w = inv * scale and shift = bias - mean * w, kept in registers. The body:
// 16-byte loads (8 bf16 or 4 fp32 channels a lane; 2 where C is not a
// multiple of that), four rows in flight a thread, y = x * w + shift in
// fp32 as a separate multiply and add (the plain version's roundings, no
// FMA), SiLU as y / (1 + expf(-y)) (PyTorch's CUDA formula), one rounding
// to x's type, 16-byte stores. No fp32 tensor reaches device memory.

#include <algorithm>

#include "common.cuh"

using idm::bf16;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, CH = 64;

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// grid (C / 64 tiles, row blocks R, B); partial (B, R, 2, C)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                      int S, int C, int rows_per_block) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * CH + lane * 2;
  const int rb = blockIdx.y, b = blockIdx.z, R = gridDim.y;
  const int r0 = rb * rows_per_block;
  const int r1 = min(r0 + rows_per_block, S);
  float s1x = 0.f, s1y = 0.f, s2x = 0.f, s2y = 0.f;
  if (c < C) {
    const T* base = x + (size_t)b * S * C + c;
    for (int r = r0 + warp; r < r1; r += WARPS) {
      const float2 v = load2(base + (size_t)r * C);
      s1x += v.x;
      s1y += v.y;
      s2x += v.x * v.x;
      s2y += v.y * v.y;
    }
  }
  __shared__ float4 red[WARPS][32];
  red[warp][lane] = make_float4(s1x, s1y, s2x, s2y);
  __syncthreads();
  if (warp == 0 && c < C) {
    float4 t = red[0][lane];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) {
      const float4 u = red[i][lane];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    float* p = partial + ((size_t)b * R + rb) * 2 * C + c;
    p[0] = t.x;
    p[1] = t.y;
    p[C] = t.z;
    p[C + 1] = t.w;
  }
}

// grid (ceil(C / 256), B): one thread per channel adds its R partials
__global__ void gn_final_kernel(const float* __restrict__ partial,
                                float* __restrict__ s1,
                                float* __restrict__ s2, int R, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (c >= C) return;
  const float* p = partial + (size_t)b * R * 2 * C + c;
  float a = 0.f, q = 0.f;
  for (int r = 0; r < R; ++r) {
    a += p[(size_t)r * 2 * C];
    q += p[(size_t)r * 2 * C + C];
  }
  s1[(size_t)b * C + c] = a;
  s2[(size_t)b * C + c] = q;
}

// ---- #13: the apply -------------------------------------------------------

constexpr int ACH = 128;    // channels a block (256 bytes of a bf16 row)
constexpr int UNROLL = 4;   // rows a thread has in flight

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float* f) {
    idm::unpack8(*reinterpret_cast<const uint4*>(p), f);
  }
  static __device__ __forceinline__ void store(bf16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = idm::pack8(f);
  }
};

template <>
struct Vec<bf16, 2> {
  static __device__ __forceinline__ void load(const bf16* p, float* f) {
    const float2 t = load2(p);
    f[0] = t.x;
    f[1] = t.y;
  }
  static __device__ __forceinline__ void store(bf16* p, const float* f) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x;
    f[1] = t.y;
    f[2] = t.z;
    f[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float2 t = load2(p);
    f[0] = t.x;
    f[1] = t.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  }
};

// grid (blocks a column, ceil(C / 128), B); x and out (B, S, C), the means
// (B, C)
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean_c,
                    const float* __restrict__ mean2_c,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ out,
                    int S, int C, int cpg, float eps) {
  __shared__ float g_mean[ACH], g_inv[ACH], w_s[ACH], sh_s[ACH];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, c0 = blockIdx.y * ACH;
  const int c_end = min(c0 + ACH, C);
  const int g0 = c0 / cpg, ng = (c_end - 1) / cpg - g0 + 1;  // <= ACH
  const float* m1 = mean_c + (size_t)b * C;
  const float* m2 = mean2_c + (size_t)b * C;
  const float inv_n = __fdiv_rn(1.0f, (float)cpg);
  for (int i = warp; i < ng; i += WARPS) {
    const int base = (g0 + i) * cpg;
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < cpg; j += 32) {
      s1 += m1[base + j];
      s2 += m2[base + j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // every lane ends with the same sums
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      const float mean = __fmul_rn(s1, inv_n), mean2 = __fmul_rn(s2, inv_n);
      const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
      g_mean[i] = mean;
      g_inv[i] = rsqrtf(__fadd_rn(var, eps));
    }
  }
  __syncthreads();
  if (tid < c_end - c0) {
    const int c = c0 + tid, i = c / cpg - g0;
    const float w = __fmul_rn(g_inv[i], scale[c]);
    w_s[tid] = w;
    sh_s[tid] = __fsub_rn(bias[c], __fmul_rn(g_mean[i], w));
  }
  __syncthreads();

  constexpr int LANES = ACH / VEC;    // lanes a row
  constexpr int RPI = THREADS / LANES;  // rows a load of the block
  constexpr int CHUNK = RPI * UNROLL;   // rows an iteration of the block
  const int cl = (tid % LANES) * VEC;
  if (c0 + cl >= C) return;           // C % VEC == 0: a vector is in or out
  float w[VEC], sh[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    w[v] = w_s[cl + v];
    sh[v] = sh_s[cl + v];
  }
  const size_t base = (size_t)b * S * C + c0 + cl;
  for (int r = (int)blockIdx.x * CHUNK + tid / LANES; r < S;
       r += (int)gridDim.x * CHUNK) {
    float f[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * RPI < S)
        Vec<T, VEC>::load(x + base + (size_t)(r + u * RPI) * C, f[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * RPI >= S) break;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float y = __fadd_rn(__fmul_rn(f[u][v], w[v]), sh[v]);
        if (SILU) y = y / (1.0f + expf(-y));
        f[u][v] = y;
      }
      Vec<T, VEC>::store(out + base + (size_t)(r + u * RPI) * C, f[u]);
    }
  }
}

// at most one wave (the blocks an SM holds of this instance, times the
// SMs) over the B x column blocks, and at most one block a chunk of rows
template <typename T, int VEC, bool SILU>
cudaError_t launch_apply(const void* x, const void* mean_c,
                         const void* mean2_c, const void* scale,
                         const void* bias, void* out, int B, int S, int C,
                         int cpg, float eps, int sms, cudaStream_t st) {
  static int per_sm = 0;  // the instance's occupancy, read once
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gn_apply_kernel<T, VEC, SILU>, THREADS, 0);
    if (e != cudaSuccess) return e;
    per_sm = std::max(per_sm, 1);
  }
  constexpr int CHUNK = THREADS / (ACH / VEC) * UNROLL;
  const int cols = idm::cdiv(C, ACH);
  const int nx = std::max(1, std::min(idm::cdiv(S, CHUNK),
                                      per_sm * sms / (cols * B)));
  gn_apply_kernel<T, VEC, SILU><<<dim3(nx, cols, B), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean_c),
      static_cast<const float*>(mean2_c), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), S, C, cpg, eps);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_apply(int silu, const void* x, const void* mean_c,
                         const void* mean2_c, const void* scale,
                         const void* bias, void* out, int B, int S, int C,
                         int cpg, float eps, int sms, cudaStream_t st) {
  return silu ? launch_apply<T, VEC, true>(x, mean_c, mean2_c, scale, bias,
                                           out, B, S, C, cpg, eps, sms, st)
              : launch_apply<T, VEC, false>(x, mean_c, mean2_c, scale, bias,
                                            out, B, S, C, cpg, eps, sms, st);
}

}  // namespace

extern "C" int idm_gn_stats(const void* x, void* partial, void* s1, void* s2,
                            int B, int S, int C, int rows_per_block,
                            int is_bf16, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const int R = idm::cdiv(S, rows_per_block);
  if (C % 2 != 0 || R < 1 || R > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(idm::cdiv(C, CH), R, B);
  if (is_bf16)
    gn_partial_kernel<bf16><<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<float*>(partial), S, C,
        rows_per_block);
  else
    gn_partial_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(partial), S, C,
        rows_per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_final_kernel<<<dim3(idm::cdiv(C, 256), B), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(s1),
      static_cast<float*>(s2), R, C);
  return (int)cudaGetLastError();
}

extern "C" int idm_gn_apply(const void* x, const void* mean_c,
                            const void* mean2_c, const void* scale,
                            const void* bias, void* out, int B, int S, int C,
                            int G, float eps, int silu, int is_bf16, int sms,
                            void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return 0;
  if (G <= 0 || C % G != 0 || C % 2 != 0 || sms <= 0 || B > 65535 ||
      idm::cdiv(C, ACH) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cpg = C / G;
  if (is_bf16)
    return (int)(C % 8 == 0
                     ? launch_apply<bf16, 8>(silu, x, mean_c, mean2_c, scale,
                                             bias, out, B, S, C, cpg, eps,
                                             sms, st)
                     : launch_apply<bf16, 2>(silu, x, mean_c, mean2_c, scale,
                                             bias, out, B, S, C, cpg, eps,
                                             sms, st));
  return (int)(C % 4 == 0
                   ? launch_apply<float, 4>(silu, x, mean_c, mean2_c, scale,
                                            bias, out, B, S, C, cpg, eps, sms,
                                            st)
                   : launch_apply<float, 2>(silu, x, mean_c, mean2_c, scale,
                                            bias, out, B, S, C, cpg, eps, sms,
                                            st));
}
