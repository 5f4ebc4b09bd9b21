// LayerNorm + GEMM (+ GEGLU epilogue), and the standalone LayerNorm.
//
// Replaces idmvton_tpu/ops/pallas_norm.py::ln_linear (_ln_mm_kernel) and
// ::fused_layer_norm (_ln_kernel).
//
// ln_linear computes out = LN(x) W + b (GEGLU: value * gelu_erf(gate) of the
// [value | gate] halves), with the TPU kernel's numbers: one-pass fp32 row
// statistics with the clamped variance max(E[x^2] - E[x]^2, 0); xn = (x -
// mean) rsqrt(var + eps) gamma + beta rounded to bf16 before the product (the
// TPU kernel's xn scratch is x's type); a bf16 x bf16 product with fp32
// accumulation; the bias (bf16 or fp32, widened exactly) and GEGLU in fp32
// (erf by the TPU kernel's Abramowitz-Stegun formula, |error| <= 1.5e-7);
// one bf16 rounding at the end.
//
// What bounds it on the H100: tensor-core throughput (12288 x 640 x 1920 at
// TryonNet's to_qkv, 12288 x 640 x 5120 at its 640-wide GEGLU: 2 C FLOP an
// output element against 2 (C + N) bytes an output row), and, behind it, the
// L2 traffic of re-reading W once per 128-row block.
//
// Design: a warp-specialized wgmma GEMM whose A operand is normalized on its
// way from shared memory to the tensor cores. Output tiles are 128 rows x VW
// columns (VW = BN, or BN / 2 value and BN / 2 gate columns for GEGLU). A
// producer warpgroup issues TMA boxes into a STAGES-deep mbarrier ring: per
// 64-deep K chunk the raw x box (64 columns x 128 rows, 128-byte swizzle)
// and the W boxes (64 K rows x 64 columns each, MN-major: W is (C, G*N) with
// N contiguous, as the conv kernel reads HWIO; GEGLU's gate boxes sit at
// column N + n0 of the same map, after the value boxes in the stage, so one
// m64nBNk16 a 16-deep step covers both halves). Two consumer warpgroups own
// 64 rows each.
// The row statistics come first, from a pre-pass kernel launched just
// before on the same stream (half a warp a row over all M rows, written as
// (inv, -mean * inv)): taken inside the GEMM, each block's consumers waited
// on latency-bound row reads at every new row block, 35-45% of the kernel's
// time (scripts/torch_ln_tiles.py --probe). Per chunk a consumer thread
// reads its wgmma A fragment (rows g and g + 8 of its warp's 16, four bf16
// pairs of each 16-deep step) from the raw swizzled box, normalizes it in
// fp32 -- x inv - mean inv by one FMA, then gamma and beta by another --
// rounds to bf16 and issues the RS wgmma (A from registers, B from the
// ring): LayerNorm costs no shared-memory round trip and no proxy fence.
// The fragments are double buffered, so chunk k's normalization runs while
// chunk k - 1's product is in flight. Blocks are persistent and walk a
// contiguous range of the tiles (row blocks outer, column tiles inner), so
// a thread reloads its rows' statistics only when its range crosses a row
// block, and the producer loads the next tile while the consumers store the
// last. Epilogue: bias, GEGLU (erf as
// the TPU kernel's rational approximation), one bf16 rounding, a quad
// transpose by shuffles, 16-byte stores, rows and columns past the output
// clipped. The tile (BN) and the tensor maps come from the wrapper's plan
// (cuda_norm.py::ln_linear_plan).
//
// The standalone LayerNorm reads each row once into registers (half a warp
// a row, 16-byte loads), takes the same statistics by shuffles and writes
// 16-byte stores; it is bound by HBM bandwidth.

#include "common.cuh"

namespace {

using idm::bf16;

// The ring depth: the value scripts/torch_ln_tiles.py's sweep chose; it
// builds the others with -DIDM_LN_STAGES=...
#ifndef IDM_LN_STAGES
#define IDM_LN_STAGES 4
#endif
// Measurement builds of the sweep only (wrong results): IDM_LN_PROBE bit 0
// skips the statistics pre-pass and its reads (inv 1, mean 0), bit 1 the
// normalization of the fragments (raw x into the product).
#ifndef IDM_LN_PROBE
#define IDM_LN_PROBE 0
#endif
constexpr int SMEM_LIMIT = 232448;
constexpr int BM = 128, BK = 64, THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;  // the x box: 128 rows of 128 bytes
constexpr int W_BOX = BK * 128;       // a W box: 64 K rows of 64 columns

template <int BN, bool GEGLU>
struct Cfg {
  static constexpr int VW = GEGLU ? BN / 2 : BN;  // output columns a tile
  static constexpr int ACC = BN / 2;  // fp32 accumulators a thread
  static constexpr int STAGE = A_BYTES + BN * BK * 2;
  static constexpr int STAGES = IDM_LN_STAGES;
  // the ring, the barriers, slack to align to 1024
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 16 * STAGES;
  static_assert(BN == 128 || BN == 256, "BN");
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "ring");
};

// A 2-D TMA map as the plan gives it: dims and box innermost first, the
// byte stride of dim 1, the swizzle span in bytes, the element size.
struct MapDesc {
  long long dims[2], stride, box[2], swizzle, elem;
};

// cuda_norm.py::LnLinearPlan.c_plan, field for field (int64 each)
struct Plan {
  long long bn, geglu;                  // the instance
  long long m_tiles, n_tiles, tiles;    // n_tiles VW-column tiles a row block
  long long grid;                       // persistent blocks
  long long n_out, kc;                  // output columns; 64-deep K chunks
  MapDesc x_map, w_map;
};
static_assert(sizeof(Plan) == 22 * sizeof(long long), "Plan");

struct Args {
  const float2* stats;  // (M,) (inv, -mean * inv) of each row
  const float* gamma;
  const float* beta;
  const void* bias;  // (G * n_out,) bf16 or fp32, or null
  int bias_bf16;
  bf16* out;
  int M, n_out, kc, n_tiles, tiles;
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(idm::smem_u32(p)));
  return v;
}

// a bf16 pair of x, normalized with its row's st = (inv, -mean * inv) and
// the columns' gamma / beta, as a bf16 pair
__device__ __forceinline__ uint32_t norm2(uint32_t xv, float2 st, float2 g,
                                          float2 b) {
  if (IDM_LN_PROBE & 2) return xv;
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  return idm::pack_bf16x2(fmaf(fmaf(f.x, st.x, st.y), g.x, b.x),
                          fmaf(fmaf(f.y, st.x, st.y), g.y, b.y));
}

// gelu(v) = v Phi(v) with erf by Abramowitz-Stegun 7.1.26 (|error| <=
// 1.5e-7, far below a bf16 ulp), the TPU kernel's _gelu_erf: branch-free,
// where erff's branches would make ptxas serialize the wgmma instructions
__device__ __forceinline__ float gelu_erf(float v) {
  const float z = v * 0.70710678118654752f, az = fabsf(z);
  const float t = __frcp_rn(1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * __expf(-az * az);
  return 0.5f * v * (1.f + copysignf(e, z));
}

__device__ __forceinline__ float2 bias2(const Args& a, int col) {
  if (a.bias == nullptr) return make_float2(0.f, 0.f);
  if (a.bias_bf16)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const bf16*>(a.bias) + col));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(a.bias) +
                                          col);
}

template <int BN, bool GEGLU>
__global__ void __launch_bounds__(THREADS, 1)
    ln_linear_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const Args a) {
  using C = Cfg<BN, GEGLU>;
  constexpr int VW = C::VW, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  int t0, t1;
  idm::tile_range(a.tiles, t0, t1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      idm::mbar_init(&full[s], 1);
      idm::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    idm::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer --------------------------------------------------------
    idm::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // chunk count over all this block's tiles
      for (int t = t0; t < t1; ++t) {
        const int m0 = (t / a.n_tiles) * BM, n0 = (t % a.n_tiles) * VW;
        for (int k = 0; k < a.kc; ++k, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES)
            idm::mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
          uint8_t* st = smem + s * C::STAGE;
          idm::mbar_expect_tx(&full[s], C::STAGE);
          idm::tma_load_2d(st, &xmap, &full[s], k * BK, m0);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b) {
            // GEGLU: value boxes, then the gate boxes n_out columns on
            const int half = GEGLU && b >= BN / 128;
            const int col = n0 + 64 * (GEGLU ? b % (BN / 128) : b) +
                            (half ? a.n_out : 0);
            idm::tma_load_2d(st + A_BYTES + b * W_BOX, &wmap, &full[s], col,
                             k * BK);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ---------------------------------------------------------
  idm::reg_alloc<232>();
  const int ct = threadIdx.x - 128;
  const int w = ct / 128;  // rows [64 w, 64 w + 64) of the tile
  const int warp = (ct / 32) % 4, lane = ct % 32, g = lane / 4, q = lane % 4;
  const int rw = 64 * w + 16 * warp;  // the warp's first row in the tile
  float acc[C::ACC];
  uint32_t fa[16], fb[16];  // A fragments of two chunks: 4 k steps x 4
  float2 st0 = make_float2(0.f, 0.f), st1 = st0;  // rows g, g + 8
  int it = 0, cur_mb = -1;

  // The normalized A fragments of chunk k in stage s: four 16-deep steps,
  // a step's registers (row g, k 2q..), (g + 8, 2q..), (g, 2q + 8..), (g +
  // 8, 2q + 8..). Row r's 16-byte unit j of the box lies at unit j ^ (r %
  // 8) (128-byte swizzle), and r % 8 == g for both rows.
  auto fragments = [&](int s, int k, uint32_t(&f)[16]) {
    const uint8_t* lo = smem + s * C::STAGE + (rw + g) * 128 + 4 * q;
    const uint8_t* hi = lo + 8 * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = k * BK + 16 * kk + 2 * q;
      const float2 g0 = __ldg(reinterpret_cast<const float2*>(a.gamma + c));
      const float2 g1 = __ldg(reinterpret_cast<const float2*>(a.gamma + c + 8));
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(a.beta + c));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(a.beta + c + 8));
      const int u0 = ((2 * kk) ^ g) * 16, u1 = ((2 * kk + 1) ^ g) * 16;
      f[4 * kk + 0] = norm2(lds32(lo + u0), st0, g0, b0);
      f[4 * kk + 1] = norm2(lds32(hi + u0), st1, g0, b0);
      f[4 * kk + 2] = norm2(lds32(lo + u1), st0, g1, b1);
      f[4 * kk + 3] = norm2(lds32(hi + u1), st1, g1, b1);
    }
  };
  // chunk in stage s times the fragments: per 16-deep step one m64nBNk16
  // over the stage's BN / 64 W boxes side by side (GEGLU: the value boxes,
  // then the gate boxes, so acc[0, VW / 2) holds the value columns and
  // acc[VW / 2, VW) the gate columns)
  auto issue = [&](int s, const uint32_t(&f)[16]) {
    const uint8_t* bs = smem + s * C::STAGE + A_BYTES;
    idm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      idm::wgmma_bf16_rs<BN>(acc, &f[4 * kk],
                             idm::smem_desc(bs + kk * 16 * 128, W_BOX, 1024,
                                            128));
    idm::wgmma_commit();
  };
  auto release = [&](int s) {
    if (lane == 0) idm::mbar_arrive(&empty[s]);
  };

  for (int t = t0; t < t1; ++t) {
    const int mb = t / a.n_tiles;
    const int m0 = mb * BM, n0 = (t % a.n_tiles) * VW;
    if (IDM_LN_PROBE & 1) {
      st0 = st1 = make_float2(1.f, 0.f);
    } else if (mb != cur_mb) {  // the rows' statistics, from the pre-pass
      cur_mb = mb;
      const int r = m0 + rw + g;
      const float2 zero = make_float2(0.f, 0.f);
      st0 = r < a.M ? __ldg(a.stats + r) : zero;
      st1 = r + 8 < a.M ? __ldg(a.stats + r + 8) : zero;
    }

#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
    // chunk k's fragments are built while chunk k - 1's product runs; the
    // fences keep a buffer's registers live until its product is done
    int s = it % STAGES;
    idm::mbar_wait(&full[s], (it / STAGES) & 1);
    fragments(s, 0, fa);
    issue(s, fa);
    int prev = s;
    ++it;
    for (int k = 1; k < a.kc; ++k, ++it) {
      s = it % STAGES;
      idm::mbar_wait(&full[s], (it / STAGES) & 1);
      if (k & 1) {
        fragments(s, k, fb);
        issue(s, fb);
        idm::wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 16; ++i) idm::fence_u32(fa[i]);
      } else {
        fragments(s, k, fa);
        issue(s, fa);
        idm::wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 16; ++i) idm::fence_u32(fb[i]);
      }
      release(prev);
      prev = s;
    }
    idm::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      idm::fence_u32(fa[i]);
      idm::fence_u32(fb[i]);
    }
    release(prev);
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) idm::fence_operand(acc[i]);

    // ---- epilogue: rows r0, r0 + 8; per 32 columns, this thread holds
    // columns 8u + 2q, +1 of the 8-column blocks u = 0..3
    const int r0 = m0 + rw + g;
#pragma unroll
    for (int jj = 0; jj < VW / 32; ++jj) {
      const int c32 = n0 + 32 * jj;
      float2 bv[4], bg[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = c32 + 8 * u + 2 * q;
        const bool in = col < a.n_out;
        bv[u] = in ? bias2(a, col) : make_float2(0.f, 0.f);
        if (GEGLU) bg[u] = in ? bias2(a, a.n_out + col) : make_float2(0.f, 0.f);
      }
      const int col = c32 + 8 * q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = (4 * jj + u) * 4 + 2 * i;
          float v0 = acc[e] + bv[u].x, v1 = acc[e + 1] + bv[u].y;
          if (GEGLU) {
            const float q0 = acc[VW / 2 + e] + bg[u].x;
            const float q1 = acc[VW / 2 + e + 1] + bg[u].y;
            v0 *= gelu_erf(q0);
            v1 *= gelu_erf(q1);
          }
          v[u] = idm::pack_bf16x2(v0, v1);
        }
        idm::quad_store(v, q, a.out + (size_t)(r0 + 8 * i) * a.n_out + col,
                        r0 + 8 * i < a.M && col < a.n_out);
      }
    }
  }
}

// The statistics pre-pass: (inv, -mean * inv) of each row of x (M, C),
// one-pass fp32 sums with the clamped variance; half a warp a row.
__global__ void __launch_bounds__(256)
    ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats,
                    int M, int C, float eps) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 16;
  if (row >= M) return;  // the half warp leaves together
  const int hl = threadIdx.x % 16;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  const bf16* xr = x + row * C;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int c = 8 * hl; c < C; c += 128) {
    float f[8];
    idm::unpack8(__ldg(reinterpret_cast<const uint4*>(xr + c)), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1 += f[j];
      s2 += f[j] * f[j];
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(mask, s1, o);
    s2 += __shfl_xor_sync(mask, s2, o);
  }
  if (hl == 0) {
    const float mean = s1 / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
    stats[row] = make_float2(inv, -mean * inv);
  }
}

inline cudaError_t encode_map(CUtensorMap* map, const void* base,
                              const MapDesc& m) {
  const cuuint64_t dims[2] = {(cuuint64_t)m.dims[0], (cuuint64_t)m.dims[1]};
  const cuuint64_t strides[1] = {(cuuint64_t)m.stride};
  const cuuint32_t box[2] = {(cuuint32_t)m.box[0], (cuuint32_t)m.box[1]};
  return idm::encode_tiled(map, base, 2, dims, strides, box, (int)m.swizzle,
                           (int)m.elem);
}

template <int BN, bool GEGLU>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const Args& a, int grid, cudaStream_t st) {
  auto kernel = ln_linear_kernel<BN, GEGLU>;
  static const cudaError_t e = idm::allow_smem(kernel, Cfg<BN, GEGLU>::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, Cfg<BN, GEGLU>::SMEM, st>>>(xmap, wmap, a);
  return cudaGetLastError();
}

// The standalone LayerNorm: half a warp a row, NCH 16-byte chunks a lane
// (C = 128 NCH), the row held in registers between the statistics and the
// store.
template <int NCH>
__global__ void __launch_bounds__(256)
    layer_norm_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, bf16* __restrict__ out,
                      int M, float eps) {
  constexpr int C = 128 * NCH;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 16;
  if (row >= M) return;  // the half warp leaves together
  const int hl = threadIdx.x % 16;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  const bf16* xr = x + row * C + 8 * hl;
  uint4 v[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    v[i] = __ldg(reinterpret_cast<const uint4*>(xr + 128 * i));
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    float f[8];
    idm::unpack8(v[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1 += f[j];
      s2 += f[j] * f[j];
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(mask, s1, o);
    s2 += __shfl_xor_sync(mask, s2, o);
  }
  const float mean = s1 / C;
  const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
  bf16* orow = out + row * C + 8 * hl;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = 8 * hl + 128 * i;
    const float4 ga = __ldg(reinterpret_cast<const float4*>(gamma + c));
    const float4 gb = __ldg(reinterpret_cast<const float4*>(gamma + c + 4));
    const float4 ba = __ldg(reinterpret_cast<const float4*>(beta + c));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(beta + c + 4));
    const float gg[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const float be[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    float f[8];
    idm::unpack8(v[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * inv * gg[j] + be[j];
    *reinterpret_cast<uint4*>(orow + 128 * i) = idm::pack8(f);
  }
}

template <int NCH>
cudaError_t launch_ln(const void* x, const void* gamma, const void* beta,
                      void* out, int M, float eps, cudaStream_t st) {
  constexpr int ROWS = 16;  // a block of 256 threads: 16 rows
  layer_norm_kernel<NCH><<<idm::cdiv(M, ROWS), 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out), M, eps);
  return cudaGetLastError();
}

}  // namespace

// x (M, C), w (C, G * n_out) bf16; gamma, beta (C,) fp32; bias (G * n_out,)
// bf16 (bias_bf16) or fp32, or NULL; stats (M,) float2 scratch; out (M,
// n_out) bf16; then the plan (cuda_norm.py::LnLinearPlan.c_plan): the
// instance, the tile counts and the x and w maps, encoded as given. Launches
// the statistics pre-pass, then the GEMM.
extern "C" int idm_ln_linear(const void* x, const void* gamma,
                             const void* beta, const void* w, const void* bias,
                             int bias_bf16, void* stats, void* out, int M,
                             int C, int n_out, float eps, const void* plan,
                             void* stream) {
  if (M <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  if (C % BK != 0 || n_out % 8 != 0 || p.kc != C / BK || p.n_out != n_out ||
      p.tiles <= 0 || p.grid <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.stats = static_cast<const float2*>(stats);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.bias = bias, a.bias_bf16 = bias_bf16;
  a.out = static_cast<bf16*>(out);
  a.M = M, a.n_out = n_out, a.kc = (int)p.kc;
  a.n_tiles = (int)p.n_tiles, a.tiles = (int)p.tiles;
  CUtensorMap xmap, wmap;
  cudaError_t e = encode_map(&xmap, x, p.x_map);
  if (e == cudaSuccess) e = encode_map(&wmap, w, p.w_map);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)p.grid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(IDM_LN_PROBE & 1)) {
    ln_stats_kernel<<<idm::cdiv(M, 16), 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<float2*>(stats), M, C, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (p.bn == 128 && !p.geglu)
    return (int)launch<128, false>(xmap, wmap, a, grid, st);
  if (p.bn == 256 && !p.geglu)
    return (int)launch<256, false>(xmap, wmap, a, grid, st);
  if (p.bn == 128 && p.geglu)
    return (int)launch<128, true>(xmap, wmap, a, grid, st);
  if (p.bn == 256 && p.geglu)
    return (int)launch<256, true>(xmap, wmap, a, grid, st);
  return (int)cudaErrorInvalidValue;
}

// x, out (M, C) bf16 with C = 128 NCH, NCH 1..16; gamma, beta (C,) fp32
extern "C" int idm_layer_norm(const void* x, const void* gamma,
                              const void* beta, void* out, int M, int C,
                              float eps, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
#define IDM_LN_CASE(N) \
  case 128 * N:        \
    return (int)launch_ln<N>(x, gamma, beta, out, M, eps, st);
    IDM_LN_CASE(1) IDM_LN_CASE(2) IDM_LN_CASE(3) IDM_LN_CASE(4)
    IDM_LN_CASE(5) IDM_LN_CASE(6) IDM_LN_CASE(7) IDM_LN_CASE(8)
    IDM_LN_CASE(9) IDM_LN_CASE(10) IDM_LN_CASE(11) IDM_LN_CASE(12)
    IDM_LN_CASE(13) IDM_LN_CASE(14) IDM_LN_CASE(15) IDM_LN_CASE(16)
#undef IDM_LN_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* idm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
