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
// What bounds it on the H100: the int8 tensor cores (2 C operations an
// output element: 12288 x 640 x 1920 at TryonNet's to_qkv, 3072 x 1280 x
// 10240 at its 1280-wide GEGLU) and, at the narrow shapes, the bytes of x,
// the codes and the output.
//
// Design: the one C entry point launches two kernels on the caller's
// stream, as ln_linear.cu does.
// 1. A quantization pre-pass, half a warp a row with the row held in
//    registers (ln_linear.cu's statistics pre-pass and standalone
//    LayerNorm): the statistics, the normalized row, its absmax, rs and the
//    int8 codes, written as codes (M, C) int8 and rs (M,) fp32. Every
//    operation is rounded on its own, in the order the plain version
//    (cuda_norm.py::ln_linear_i8_torch) runs its tensor ops on the card --
//    the means as sum * fl(1/C), rs as absmax * fl(1/127), 1/rs a correctly
//    rounded reciprocal -- so the codes and rs equal the plain version's
//    wherever the two sum a row's statistics to the same floats (summation
//    order is the one freedom; integer-valued rows, exact in any order,
//    give equal codes: tests/test_torch_cuda.py). The TPU kernel quantizes
//    a row tile at its first column step and keeps the codes in VMEM; CUDA
//    blocks run in no order, so the codes go through HBM once instead: 1
//    byte written and read again where a fused GEMM would read the 2-byte x.
// 2. An int8 GEMM: wgmma m64nBNk32 .s32.s8.s8 with both operands K-major in
//    shared memory (the only layout int8 wgmma takes; W is stored (N, C),
//    the (C, N) parameter is its transposed view: models/layers.py::
//    QuantLinear). Output tiles are 128 rows x VW columns (VW = BN, or BN / 2
//    value and BN / 2 gate columns for GEGLU). A producer warp issues TMA
//    boxes into a STAGES-deep mbarrier ring, per 128-deep K chunk the codes
//    box (128 K bytes x 128 rows) and the W box(es) (128 K bytes x BN / G
//    rows), all under the 128-byte swizzle; GEGLU's gate box (rows n_out +
//    n0) sits right after the value box, so one m64nBNk32 covers both halves
//    and acc[0, VW / 2) holds the value columns, acc[VW / 2, VW) the gate
//    columns. Two consumer warpgroups own 64 rows each and keep a chunk's
//    products in flight while the next chunk's are issued. Blocks are
//    persistent and walk a contiguous range of the tiles (row blocks outer,
//    column tiles inner). Epilogue in registers: (acc rs) w_scale + b
//    rounded as the plain version rounds it, GEGLU, one bf16 rounding, a
//    quad transpose by shuffles and 16-byte stores; rows and columns past
//    the output clipped. The epilogue bounds the GEGLU shapes (half their
//    time: scripts/torch_ln_tiles.py --i8 --probe), so a tile's row scales
//    and column scales and biases are loaded at its start, the latter into
//    shared memory, and gelu takes an approximate reciprocal. The tile
//    (BN), the grid and both tensor maps come from the wrapper's plan
//    (cuda_norm.py::ln_linear_i8_plan).

#include "common.cuh"

namespace {

using idm::bf16;

// The ring depth: the value scripts/torch_ln_tiles.py --i8 chose; it
// builds the others with -DIDM_I8_STAGES=...
#ifndef IDM_I8_STAGES
#define IDM_I8_STAGES 4
#endif
// Measurement builds of the sweep only (wrong results): IDM_I8_PROBE bit 0
// loads a block's codes boxes for its first tile's chunks only (later
// stages carry W alone: what the A bytes from L2 cost), bit 1 skips the
// epilogue's arithmetic and stores (what the epilogue costs), bit 2 the
// GEGLU's gelu.
#ifndef IDM_I8_PROBE
#define IDM_I8_PROBE 0
#endif
constexpr int SMEM_LIMIT = 232448;
constexpr int BM = 128, BK = 128, THREADS = 384;
constexpr int A_BYTES = BM * BK;  // the codes box: 128 rows of 128 bytes

template <int BN, bool GEGLU>
struct Cfg {
  static constexpr int VW = GEGLU ? BN / 2 : BN;  // output columns a tile
  static constexpr int ACC = BN / 2;  // s32 accumulators a thread
  static constexpr int STAGE = A_BYTES + BN * BK;
  static constexpr int STAGES = IDM_I8_STAGES;
  // a tile's column parameters: w_scale and bias of its value (and gate)
  // columns, two buffers
  static constexpr int COLS = 2 * BN;
  // the ring, the column buffers, the barriers, slack to align to 1024
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE +
                                 2 * COLS * sizeof(float) + 16 * STAGES;
  static_assert(BN == 128 || BN == 256, "BN");
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "ring");
};

// A 2-D TMA map as the plan gives it: dims and box innermost first, the
// byte stride of dim 1, the swizzle span in bytes, the element size.
struct MapDesc {
  long long dims[2], stride, box[2], swizzle, elem;
};

// cuda_norm.py::LnLinearI8Plan.c_plan, field for field (int64 each)
struct Plan {
  long long bn, geglu;                  // the instance
  long long m_tiles, n_tiles, tiles;    // n_tiles VW-column tiles a row block
  long long grid;                       // persistent blocks
  long long n_out, kc;                  // output columns; 128-deep K chunks
  MapDesc a_map, w_map;                 // codes (M, C), W (G * n_out, C)
};
static_assert(sizeof(Plan) == 22 * sizeof(long long), "Plan");

struct Args {
  const float* rs;       // (M,) row scales, from the pre-pass
  const float* w_scale;  // (G * n_out,)
  const void* bias;      // (G * n_out,) bf16 or fp32, or null
  int bias_bf16;
  bf16* out;
  int M, n_out, kc, n_tiles, tiles;
};

// (x - mean) * inv * gamma + beta with every operation rounded on its own
// (no FMA contraction), as the plain version computes it elementwise.
__device__ __forceinline__ float ln_elem(float f, float mean, float inv,
                                         float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f, mean), inv), g), b);
}

// ln_linear.cu's gelu_erf with its reciprocal by rcp.approx (relative error
// 2^-23, below the formula's 1.5e-7) in place of the IEEE reciprocal's
// longer sequence
__device__ __forceinline__ float gelu(float v) {
  if (IDM_I8_PROBE & 4) return v;
  const float z = v * 0.70710678118654752f, az = fabsf(z);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(t) : "f"(1.f + 0.3275911f * az));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * __expf(-az * az);
  return 0.5f * v * (1.f + copysignf(e, z));
}

// acc rs w_scale + b in fp32, each product and the sum rounded on its own
__device__ __forceinline__ float dequant(int acc, float rs, float ws,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), ws), b);
}

template <int BN, bool GEGLU>
__global__ void __launch_bounds__(THREADS, 1)
    ln_linear_i8_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap wmap,
                        const Args a) {
  using C = Cfg<BN, GEGLU>;
  constexpr int VW = C::VW, STAGES = C::STAGES, WBOX = BN / (GEGLU ? 2 : 1);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* colbuf = reinterpret_cast<float*>(smem + STAGES * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(colbuf + 2 * C::COLS);
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
          const bool load_a = !(IDM_I8_PROBE & 1) || it < a.kc;
          idm::mbar_expect_tx(&full[s], C::STAGE - (load_a ? 0 : A_BYTES));
          if (load_a) idm::tma_load_2d(st, &amap, &full[s], k * BK, m0);
          idm::tma_load_2d(st + A_BYTES, &wmap, &full[s], k * BK, n0);
          if (GEGLU)  // the gate rows, n_out on, right after the value rows
            idm::tma_load_2d(st + A_BYTES + WBOX * BK, &wmap, &full[s],
                             k * BK, a.n_out + n0);
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
  int acc[C::ACC];
  int it = 0;

  // chunk in stage s: four 32-deep steps, each one m64nBNk32 of this
  // warpgroup's 64 codes rows against the stage's BN W rows; a step's
  // operands start 32 bytes on in their 128-byte swizzled rows
  auto issue = [&](int s) {
    const uint8_t* as = smem + s * C::STAGE + w * 64 * BK;
    const uint8_t* bs = smem + s * C::STAGE + A_BYTES;
    idm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      idm::wgmma_s8<BN>(acc, idm::smem_desc(as + 32 * kk, 16, 1024, 128),
                        idm::smem_desc(bs + 32 * kk, 16, 1024, 128), 1);
    idm::wgmma_commit();
  };
  auto release = [&](int s) {
    if (lane == 0) idm::mbar_arrive(&empty[s]);
  };

  for (int t = t0; t < t1; ++t) {
    const int m0 = (t / a.n_tiles) * BM, n0 = (t % a.n_tiles) * VW;
    const int r0 = m0 + rw + g;
    // the epilogue's row scales and the tile's column parameters, loaded
    // now so their latency hides under the products (read from global
    // memory in the epilogue, they made it 1.5x slower:
    // scripts/torch_ln_tiles.py --i8): cols[f * VW + c] is w_scale (f = 0,
    // 2) or bias (f = 1, 3) of value (f < 2) or gate column n0 + c, in the
    // buffer of this tile's parity
    const float rs0 = r0 < a.M ? __ldg(a.rs + r0) : 0.f;
    const float rs1 = r0 + 8 < a.M ? __ldg(a.rs + r0 + 8) : 0.f;
    float* cols = colbuf + ((t - t0) & 1) * C::COLS;
    for (int i = ct; i < 2 * BN; i += 256) {
      const int f = i / VW, c = n0 + i % VW;
      const int gc = (f >= 2 ? a.n_out : 0) + c;
      float v = 0.f;
      if (c < a.n_out) {
        if (f & 1)
          v = a.bias == nullptr ? 0.f
              : a.bias_bf16 ? __bfloat162float(
                                  static_cast<const bf16*>(a.bias)[gc])
                            : static_cast<const float*>(a.bias)[gc];
        else
          v = __ldg(a.w_scale + gc);
      }
      cols[i] = v;
    }
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] = 0;
    // chunk k's products are issued while chunk k - 1's run; its stage is
    // released once they are done
    int prev = -1;
    for (int k = 0; k < a.kc; ++k, ++it) {
      const int s = it % STAGES;
      idm::mbar_wait(&full[s], (it / STAGES) & 1);
      issue(s);
      idm::wgmma_wait<1>();
      if (prev >= 0) release(prev);
      prev = s;
    }
    idm::wgmma_wait<0>();
    release(prev);
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) idm::fence_s32(acc[i]);

    idm::consumers_sync();  // the column buffer is written
    if (IDM_I8_PROBE & 2) continue;
    // ---- epilogue: rows r0, r0 + 8; per 32 columns, this thread holds
    // columns 8u + 2q, +1 of the 8-column blocks u = 0..3
#pragma unroll
    for (int jj = 0; jj < VW / 32; ++jj) {
      const int c32 = n0 + 32 * jj;
      float2 sv[4], bv[4], sg[4], bg[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2* cp =
            reinterpret_cast<const float2*>(cols + 32 * jj + 8 * u + 2 * q);
        sv[u] = cp[0];
        bv[u] = cp[VW / 2];
        if (GEGLU) sg[u] = cp[VW], bg[u] = cp[3 * VW / 2];
      }
      const int col = c32 + 8 * q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float rs = i ? rs1 : rs0;
        uint32_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = (4 * jj + u) * 4 + 2 * i;
          float v0 = dequant(acc[e], rs, sv[u].x, bv[u].x);
          float v1 = dequant(acc[e + 1], rs, sv[u].y, bv[u].y);
          if (GEGLU) {
            v0 *= gelu(dequant(acc[VW / 2 + e], rs, sg[u].x, bg[u].x));
            v1 *= gelu(dequant(acc[VW / 2 + e + 1], rs, sg[u].y, bg[u].y));
          }
          v[u] = idm::pack_bf16x2(v0, v1);
        }
        idm::quad_store(v, q, a.out + (size_t)(r0 + 8 * i) * a.n_out + col,
                        r0 + 8 * i < a.M && col < a.n_out);
      }
    }
  }
}

// The quantization pre-pass: half a warp a row, lane hl holding the 8
// columns 8 hl + 128 i of chunk i < NCH (C <= 128 NCH, C % 8 == 0) in
// registers, then their normalized values (gamma and beta by 16-byte
// loads); writes the row's codes and its scale rs.
template <int NCH>
__global__ void __launch_bounds__(256)
    ln_quant_kernel(const bf16* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ codes,
                    float* __restrict__ rs_out, int M, int C, float eps) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 16;
  if (row >= M) return;  // the half warp leaves together
  const int hl = threadIdx.x % 16;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  const bf16* xr = x + row * C;
  float xn[NCH][8];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = 8 * hl + 128 * i;
    const uint4 v = c < C ? __ldg(reinterpret_cast<const uint4*>(xr + c))
                          : make_uint4(0, 0, 0, 0);
    idm::unpack8(v, xn[i]);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1 = __fadd_rn(s1, xn[i][j]);
      s2 = __fadd_rn(s2, __fmul_rn(xn[i][j], xn[i][j]));
    }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    s1 = __fadd_rn(s1, __shfl_xor_sync(mask, s1, o));
    s2 = __fadd_rn(s2, __shfl_xor_sync(mask, s2, o));
  }
  // the plain version's ops: mean() as sum * fl(1/C), the clamped
  // variance, rsqrt(var + eps)
  const float rc = 1.f / (float)C;
  const float mean = __fmul_rn(s1, rc), mean2 = __fmul_rn(s2, rc);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float inv = rsqrtf(__fadd_rn(var, eps));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = 8 * hl + 128 * i;
    if (c >= C) break;
    const float4* g4 = reinterpret_cast<const float4*>(gamma + c);
    const float4* b4 = reinterpret_cast<const float4*>(beta + c);
    const float4 ga = __ldg(g4), gb = __ldg(g4 + 1);
    const float4 ba = __ldg(b4), bb = __ldg(b4 + 1);
    const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xn[i][j] = ln_elem(xn[i][j], mean, inv, g[j], b[j]);
      amax = fmaxf(amax, fabsf(xn[i][j]));
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(mask, amax, o));
  // rs = max(amax, 1e-8) / 127 as the card divides by a scalar (times its
  // reciprocal), and 1 / rs correctly rounded
  const float rs = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
  const float rcp = __frcp_rn(rs);
  int8_t* crow = codes + row * C;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = 8 * hl + 128 * i;
    if (c >= C) break;
    union {
      int8_t q[8];
      uint2 u;
    } out;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qv = __float2int_rn(__fmul_rn(xn[i][j], rcp));
      out.q[j] = (int8_t)max(-127, min(127, qv));
    }
    *reinterpret_cast<uint2*>(crow + c) = out.u;
  }
  if (hl == 0) rs_out[row] = rs;
}

// Launches the pre-pass for C <= 2048 (C % 8 == 0).
cudaError_t quantize(const void* x, const void* gamma, const void* beta,
                     void* codes, void* rs, int M, int C, float eps,
                     cudaStream_t st) {
  const int blocks = idm::cdiv(M, 16);  // 256 threads: 16 rows a block
  const bf16* xx = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(codes);
  float* r = static_cast<float*>(rs);
  switch (idm::cdiv(C, 128)) {
#define IDM_I8_CASE(N)                                                  \
  case N:                                                               \
    ln_quant_kernel<N><<<blocks, 256, 0, st>>>(xx, g, b, q, r, M, C, eps); \
    break;
    IDM_I8_CASE(1) IDM_I8_CASE(2) IDM_I8_CASE(3) IDM_I8_CASE(4)
    IDM_I8_CASE(5) IDM_I8_CASE(6) IDM_I8_CASE(7) IDM_I8_CASE(8)
    IDM_I8_CASE(9) IDM_I8_CASE(10) IDM_I8_CASE(11) IDM_I8_CASE(12)
    IDM_I8_CASE(13) IDM_I8_CASE(14) IDM_I8_CASE(15) IDM_I8_CASE(16)
#undef IDM_I8_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
cudaError_t launch(const CUtensorMap& amap, const CUtensorMap& wmap,
                   const Args& a, int grid, cudaStream_t st) {
  auto kernel = ln_linear_i8_kernel<BN, GEGLU>;
  static const cudaError_t e = idm::allow_smem(kernel, Cfg<BN, GEGLU>::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, Cfg<BN, GEGLU>::SMEM, st>>>(amap, wmap, a);
  return cudaGetLastError();
}

}  // namespace

// x (M, C) bf16; gamma, beta (C,) fp32; w (G * n_out, C) int8 (the (C, G *
// n_out) parameter's storage); w_scale (G * n_out,) fp32; bias (G *
// n_out,) bf16 (bias_bf16) or fp32, or NULL; codes (M, C) int8 and rs (M,)
// fp32 scratch; out (M, n_out) bf16; then the plan (cuda_norm.py::
// LnLinearI8Plan.c_plan): the instance, the tile counts and the codes and
// W maps, encoded as given. Launches the quantization pre-pass, then the
// GEMM.
extern "C" int idm_ln_linear_i8(const void* x, const void* gamma,
                                const void* beta, const void* w,
                                const void* w_scale, const void* bias,
                                int bias_bf16, void* codes, void* rs,
                                void* out, int M, int C, int n_out, float eps,
                                const void* plan, void* stream) {
  if (M <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  if (C % 64 != 0 || C > 2048 || n_out % 8 != 0 || p.kc != idm::cdiv(C, BK) ||
      p.n_out != n_out || p.tiles <= 0 || p.grid <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.rs = static_cast<const float*>(rs);
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = bias, a.bias_bf16 = bias_bf16;
  a.out = static_cast<bf16*>(out);
  a.M = M, a.n_out = n_out, a.kc = (int)p.kc;
  a.n_tiles = (int)p.n_tiles, a.tiles = (int)p.tiles;
  CUtensorMap amap, wmap;
  cudaError_t e = encode_map(&amap, codes, p.a_map);
  if (e == cudaSuccess) e = encode_map(&wmap, w, p.w_map);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((e = quantize(x, gamma, beta, codes, rs, M, C, eps, st)) != cudaSuccess)
    return (int)e;
  const int grid = (int)p.grid;
  if (p.bn == 128 && !p.geglu)
    return (int)launch<128, false>(amap, wmap, a, grid, st);
  if (p.bn == 256 && !p.geglu)
    return (int)launch<256, false>(amap, wmap, a, grid, st);
  if (p.bn == 128 && p.geglu)
    return (int)launch<128, true>(amap, wmap, a, grid, st);
  if (p.bn == 256 && p.geglu)
    return (int)launch<256, true>(amap, wmap, a, grid, st);
  return (int)cudaErrorInvalidValue;
}

// The pre-pass alone (a debug entry: the tests hold its codes and rs
// against the plain version's): x (M, C) bf16 -> codes (M, C) int8, rs (M,)
// fp32.
extern "C" int idm_ln_quant_i8(const void* x, const void* gamma,
                               const void* beta, void* codes, void* rs, int M,
                               int C, float eps, void* stream) {
  if (M <= 0) return 0;
  if (C % 8 != 0 || C > 2048) return (int)cudaErrorInvalidValue;
  return (int)quantize(x, gamma, beta, codes, rs, M, C, eps,
                       static_cast<cudaStream_t>(stream));
}
