// Shared device helpers of the idmvton_tpu_torch kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace idm {

typedef __nv_bfloat16 bf16;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// 16-byte global -> shared async copy; pred == false zero-fills the
// destination (src-size 0: nothing is read from `gmem`).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 (one 16-byte vector) <-> 8 floats
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Mean and 1/std of one row of C bf16 values (C % 8 == 0), warp-wide:
// one-pass fp32 statistics with the clamped variance of the JAX package.
__device__ __forceinline__ void ln_row_stats(const bf16* row, int C, float eps,
                                             float& mean, float& inv) {
  const int lane = threadIdx.x & 31;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(row + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1 += f[i];
      s2 += f[i] * f[i];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  mean = s1 / C;
  inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
}

// Sets the dynamic shared-memory limit of `kernel` when it needs more than
// the default 48 KB.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace idm
