// AdamW with int8 log-map moments over every trainable leaf in one pass,
// and the gradients' global norm in front of it.
//
// Replaces no Pallas kernel: the JAX package runs this update as one fused
// XLA program (idmvton_tpu/train/quant_opt.py::scale_by_adam_int8 and
// adamw_int8). The port's plain version (train/quant_opt.py::adam_int8_,
// then train/train_step.py::Optimizer._adamw8bit) walks the leaves one at a
// time, about 85 PyTorch ops a leaf, each a pass over the leaf in fp32.
//
// What bounds it on the H100: bytes. Per trainable parameter the update
// reads the fp32 gradient (4 B) and the fp32 master (4 B), writes the master
// (4 B), reads and writes both int8 moment codes (4 B) and one fp32 scale a
// moment per 256 elements; the norm reads the gradient once more (4 B):
// about 20 B a parameter, 18 ms for TryonNet + Resampler's 2.991 B at
// 3.35 TB/s.
// Design: the flat moment buffers' 256-element quantization blocks are the
// unit of work. A warp takes one block (8 elements a lane, as two 16-byte
// vectors) in a persistent grid-stride loop, finds the block's leaf by a
// binary search over the leaves' first blocks (kept in shared memory; no
// per-block index table), dequantizes the old codes through a 255-entry
// table, updates both moments, the Adam step, the decay and the master in
// fp32 registers, takes each moment's new block absmax with warp shuffles
// and requantizes: the dequantized moments never reach device memory.
// Every operation is the plain version's, in its order and rounding
// (__f*_rn: no contraction into fused multiply-adds); positions past a
// leaf's last element take a zero gradient, as the plain version's
// zero-padded copy gives them. The norm: each block of the first launch
// writes a partial sum of squares (fp64) in a fixed order and one block adds
// them, so the norm is deterministic (no atomics).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, QBLOCK = 256;
constexpr int CODES = 255;  // codes -127..127

struct Hyper {
  float max_norm, b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr, exp2_span,
      span;
};

// The table (int64): the leaves' first blocks and, after them, the blocks
// they cover in all (L + 1), their sizes (L), their masters' addresses (L).
// The gradients' addresses (L) come apart: they change every step.
struct Leaf {
  int begin = 0, end = 0;  // its blocks
  long long n = 0;         // its elements
  const float* g = nullptr;
  float* p = nullptr;
};

// the leaf of block b: the last leaf whose first block is <= b (an empty
// leaf shares its first block with the next and is passed over)
__device__ __forceinline__ int find_leaf(const int* first, int L, int b) {
  int lo = 0, hi = L;  // first[lo] <= b < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= b)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void enter(Leaf& leaf, const int* first,
                                      const long long* table,
                                      const long long* grads, int L, int b) {
  if (b >= leaf.begin && b < leaf.end) return;
  const int i = find_leaf(first, L, b);
  leaf.begin = first[i];
  leaf.end = first[i + 1];
  leaf.n = table[L + 1 + i];
  leaf.p = reinterpret_cast<float*>(table[2 * L + 1 + i]);
  leaf.g = reinterpret_cast<const float*>(grads[i]);
}

// 4 elements from e on; those at n or past it read 0
__device__ __forceinline__ void load4(const float* src, long long e,
                                      long long n, float* v) {
  if (e + 4 <= n) {
    const float4 t = *reinterpret_cast<const float4*>(src + e);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = e + j < n ? src[e + j] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* dst, long long e, long long n,
                                       const float* v) {
  if (e + 4 <= n) {
    *reinterpret_cast<float4*>(dst + e) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < n) dst[e + j] = v[j];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// quant_opt.quantize of one element against its block's scale
__device__ __forceinline__ unsigned quantize(float x, float scale,
                                             const Hyper& h) {
  const float a = __fdiv_rn(fabsf(x), scale);
  const float l = log10f(fmaxf(a, 1e-30f));
  float mag = rintf(__fmul_rn(127.f, __fadd_rn(__fdiv_rn(l, h.span), 1.f)));
  mag = fminf(fmaxf(mag, 0.f), 127.f);
  const int m = static_cast<int>(mag);
  const int q = x > 0.f ? m : (x < 0.f ? -m : 0);
  return static_cast<unsigned>(q) & 0xffu;
}

__device__ __forceinline__ int code(unsigned word, int j) {
  return static_cast<int>(static_cast<signed char>((word >> (8 * j)) & 0xffu));
}

__global__ void __launch_bounds__(THREADS)
    adam_int8_kernel(const long long* __restrict__ table,
                     const long long* __restrict__ grads, int L,
                     signed char* __restrict__ mu_q, float* __restrict__ mu_s,
                     signed char* __restrict__ nu_q, float* __restrict__ nu_s,
                     const float* __restrict__ norm, int clip, Hyper h, int lo,
                     int hi) {
  extern __shared__ __align__(16) unsigned char dyn[];
  // deq[c + 127]: quant_opt.dequantize of code c at scale 1
  float* deq = reinterpret_cast<float*>(dyn);
  int* first = reinterpret_cast<int*>(dyn + 256 * sizeof(float));
  for (int i = threadIdx.x; i <= L; i += THREADS)
    first[i] = static_cast<int>(table[i]);
  if (threadIdx.x < CODES) {
    const int c = static_cast<int>(threadIdx.x) - 127;
    const float mag = fabsf(static_cast<float>(c));
    const float v =
        mag > 0.f ? exp2f(__fmul_rn(h.exp2_span,
                                    __fsub_rn(__fdiv_rn(mag, 127.f), 1.f)))
                  : 0.f;
    deq[threadIdx.x] = c > 0 ? v : (c < 0 ? -v : 0.f);
  }
  __syncthreads();
  const float gn = clip ? *norm : 1.f;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  Leaf leaf;
  for (int b = lo + blockIdx.x * WARPS + (threadIdx.x >> 5); b < hi;
       b += stride) {
    enter(leaf, first, table, grads, L, b);
    const long long e0 = static_cast<long long>(b - leaf.begin) * QBLOCK +
                         lane * 4;
    const long long e1 = e0 + 128;
    const size_t s = static_cast<size_t>(b - lo);
    float g[8], p[8], mu[8], nu[8];
    load4(leaf.g, e0, leaf.n, g);
    load4(leaf.g, e1, leaf.n, g + 4);
    load4(leaf.p, e0, leaf.n, p);
    load4(leaf.p, e1, leaf.n, p + 4);
    const unsigned* mq = reinterpret_cast<const unsigned*>(mu_q + s * QBLOCK);
    const unsigned* nq = reinterpret_cast<const unsigned*>(nu_q + s * QBLOCK);
    const unsigned mw[2] = {mq[lane], mq[32 + lane]};
    const unsigned nw[2] = {nq[lane], nq[32 + lane]};
    const float smu = mu_s[s], snu = nu_s[s];
    float amu = 0.f, anu = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float gj = g[j];
      if (clip) gj = __fmul_rn(__fdiv_rn(gj, gn), h.max_norm);
      const float dm = __fmul_rn(deq[code(mw[j >> 2], j & 3) + 127], smu);
      const float dn = __fmul_rn(deq[code(nw[j >> 2], j & 3) + 127], snu);
      mu[j] = __fadd_rn(__fmul_rn(h.b1, dm), __fmul_rn(h.omb1, gj));
      nu[j] = __fadd_rn(__fmul_rn(h.b2, dn),
                        __fmul_rn(__fmul_rn(h.omb2, gj), gj));
      amu = fmaxf(amu, fabsf(mu[j]));
      anu = fmaxf(anu, fabsf(nu[j]));
      const float step =
          __fdiv_rn(__fdiv_rn(mu[j], h.bc1),
                    __fadd_rn(__fsqrt_rn(__fdiv_rn(nu[j], h.bc2)), h.eps));
      p[j] = __fadd_rn(
          p[j], __fmul_rn(__fadd_rn(step, __fmul_rn(h.wd, p[j])), h.neg_lr));
    }
    amu = fmaxf(warp_max(amu), 1e-30f);
    anu = fmaxf(warp_max(anu), 1e-30f);
    unsigned mo[2] = {0u, 0u}, no[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mo[j >> 2] |= quantize(mu[j], amu, h) << (8 * (j & 3));
      no[j >> 2] |= quantize(nu[j], anu, h) << (8 * (j & 3));
    }
    unsigned* mqo = reinterpret_cast<unsigned*>(mu_q + s * QBLOCK);
    unsigned* nqo = reinterpret_cast<unsigned*>(nu_q + s * QBLOCK);
    mqo[lane] = mo[0];
    mqo[32 + lane] = mo[1];
    nqo[lane] = no[0];
    nqo[32 + lane] = no[1];
    if (lane == 0) {
      mu_s[s] = amu;
      nu_s[s] = anu;
    }
    store4(leaf.p, e0, leaf.n, p);
    store4(leaf.p, e1, leaf.n, p + 4);
  }
}

// partial[blockIdx.x]: the sum of squares of the gradients in this block's
// share of the quantization blocks, in a fixed order
__global__ void __launch_bounds__(THREADS)
    sumsq_kernel(const long long* __restrict__ table,
                 const long long* __restrict__ grads, int L,
                 double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char dyn[];
  int* first = reinterpret_cast<int*>(dyn);
  for (int i = threadIdx.x; i <= L; i += THREADS)
    first[i] = static_cast<int>(table[i]);
  __syncthreads();
  const int used = first[L];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * WARPS;
  Leaf leaf;
  double acc = 0.0;
  for (int b = blockIdx.x * WARPS + warp; b < used; b += stride) {
    enter(leaf, first, table, grads, L, b);
    const long long e0 = static_cast<long long>(b - leaf.begin) * QBLOCK +
                         lane * 4;
    float g[8];
    load4(leaf.g, e0, leaf.n, g);
    load4(leaf.g, e0 + 128, leaf.n, g + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc += static_cast<double>(__fmul_rn(g[j], g[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ double red[WARPS];
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) t += red[i];
    partial[blockIdx.x] = t;
  }
}

// out[0] = sqrt of the n partials' sum, added in a fixed order
__global__ void __launch_bounds__(THREADS)
    norm_final_kernel(const double* __restrict__ partial, int n,
                      float* __restrict__ out) {
  __shared__ double red[THREADS];
  double t = 0.0;
  for (int i = threadIdx.x; i < n; i += THREADS) t += partial[i];
  red[threadIdx.x] = t;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(sqrt(red[0]));
}

// the persistent grid: as many blocks as stay resident on the card, and no
// more than the work has warps for
template <typename K>
cudaError_t grid_for(K kernel, size_t smem, int work_blocks, int* grid) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return e;
  *grid = std::min(std::max(sms * per_sm, 1), idm::cdiv(work_blocks, WARPS));
  return cudaSuccess;
}

}  // namespace

// table, grads: as above (L leaves); partial: `capacity` doubles of scratch;
// out: one float, the global norm
extern "C" int idm_adam_int8_norm(const void* table, const void* grads, int L,
                                  int used, void* partial, int capacity,
                                  void* out, void* stream) {
  if (L <= 0 || used < 0 || capacity <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(L + 1) * sizeof(int);
  int grid = 0;
  if (used > 0) {
    cudaError_t e = grid_for(sumsq_kernel, smem, used, &grid);
    if (e != cudaSuccess) return (int)e;
    grid = std::min(grid, capacity);
    sumsq_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const long long*>(table),
        static_cast<const long long*>(grads), L,
        static_cast<double*>(partial));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  norm_final_kernel<<<1, THREADS, 0, st>>>(static_cast<const double*>(partial),
                                           grid, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Blocks lo..hi-1 of the flat moment buffers, each below the table's covered
// count; the state holds exactly those blocks (mu_q / nu_q (hi - lo, 256)
// int8, mu_s / nu_s (hi - lo, 1) fp32). clip != 0: each gradient is taken as
// g / *norm * max_norm.
extern "C" int idm_adam_int8_update(
    const void* table, const void* grads, int L, void* mu_q, void* mu_s,
    void* nu_q, void* nu_s, const void* norm, int clip, float max_norm,
    float b1, float omb1, float b2, float omb2, float bc1, float bc2,
    float eps, float wd, float neg_lr, float exp2_span, float span, int lo,
    int hi, void* stream) {
  if (L <= 0 || lo < 0 || hi < lo || (clip && norm == nullptr))
    return (int)cudaErrorInvalidValue;
  if (hi == lo) return 0;
  const size_t smem = 256 * sizeof(float) + (L + 1) * sizeof(int);
  int grid = 0;
  cudaError_t e = grid_for(adam_int8_kernel, smem, hi - lo, &grid);
  if (e != cudaSuccess) return (int)e;
  const Hyper h{max_norm, b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr,
                exp2_span, span};
  adam_int8_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table),
      static_cast<const long long*>(grads), L,
      static_cast<signed char*>(mu_q), static_cast<float*>(mu_s),
      static_cast<signed char*>(nu_q), static_cast<float*>(nu_s),
      static_cast<const float*>(norm), clip, h, lo, hi);
  return (int)cudaGetLastError();
}
