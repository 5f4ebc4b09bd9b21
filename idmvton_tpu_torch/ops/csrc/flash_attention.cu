// Online-softmax flash attention over (B, S, H, D) rows read through strides.
//
// Replaces idmvton_tpu/ops/pallas_attention.py::flash_attention /
// flash_attention_concat_kv (_flash_kernel) and flash_attention_fused_qkv
// (_flash_kernel_fused): the two Pallas kernels run one online-softmax body
// over two layouts, and so does this one kernel. q (B, Sq, H, D), k/v
// (B, Skv, H, D) are addressed as base + b * batch_stride + s * row_stride
// + h * D, so the views of a fused to_qkv output (split heads, or
// (B, St, 3, H, D) slices) are read in place: no transpose, no pad copy.
//
// Semantics (_flash_kernel): logits = (q . k) * scale in fp32, the KV tail
// past Skv masked to -1e30; a running row max m and sum l in fp32, rescaled
// by alpha = exp(m_prev - m_new) at every KV tile; p = exp(s - m_new) summed
// in fp32 and cast to bf16 for the PV product, which accumulates in fp32;
// out = acc / max(l, 1e-30) in bf16. The exact online max, no fixed shift.
//
// What bounds it on the H100: at the narrow head dims that reach it (D = 16
// in the tiny UNet's 64-wide level) the exp count B*H*Sq*Skv, not the MMA:
// 4 * D FLOP per logit against one exp on the SFU. At D = 64 the MMA.
// Design: one block of 4 warps per (64-query tile, head, batch row); each
// warp owns 16 query rows end to end. K/V tiles of 64 keys stream through a
// 2-stage cp.async ring in shared memory; key rows past Skv and head columns
// past D are zero-filled by the copy, so padded columns add 0 to q . k and
// masked keys meet V = 0. S = Q K^T and O += P V are mma.sync m16n8k16 bf16
// products with fp32 accumulators. Their register layout is known (thread
// lane holds rows lane/4 and lane/4 + 8, columns 2*(lane%4) + {0, 1} of each
// 8-column tile), so the softmax runs in registers: a row's max and sum are
// reduced over the 4 lanes of a quad, the rescale multiplies the thread's
// own O registers, and the S accumulators of two 8-key tiles are exactly
// the A operand of the next PV step (no shared-memory round trip, unlike
// the WMMA kernels whose row mapping is hidden). D is zero-padded to the
// 16-deep MMA step: the template DP in {16, 32, 64, 128} covers D = 8..128.

#include "common.cuh"

using idm::bf16;

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr float NEG = -1e30f;
static_assert(BQ == BKV, "load_tile copies BQ rows for Q and K/V tiles");

template <int DP>
struct Layout {
  static constexpr int LD = DP + 8;  // row pitch (bf16): conflict-free frags
  static constexpr int TILE = BQ * LD;
  static constexpr size_t BYTES = 5 * TILE * sizeof(bf16);  // Q, 2 K, 2 V
};

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two rows (the transposed B operand of P V)
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 t;
  t.x = lo;
  t.y = hi;
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// rows [row0, row0 + BQ) x DP columns of one head into a shared tile; rows
// at or past `rows` and columns at or past D are zero-filled
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long row_stride, int row0,
                                          int rows, int D) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, j = row0 + r;
    const bool ok = j < rows && c * 8 < D;
    const bf16* src = ok ? base + (long long)j * row_stride + c * 8 : base;
    idm::cp_async16(dst + r * Layout<DP>::LD + c * 8, src, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                 int Skv, int D, long long qb, long long qr, long long kb,
                 long long kr, long long vb, long long vr, long long ob,
                 long long orow, float scale) {
  using L = Layout<DP>;
  constexpr int NT = BKV / 8;  // 8-key tiles of S per KV tile
  constexpr int DT = DP / 8;   // 8-column tiles of O
  constexpr int KS = DP / 16;  // 16-deep steps of Q K^T
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::TILE;
  bf16* Vs = Ks + 2 * L::TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;  // row group, thread in group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qh = q + b * qb + (long long)h * D;
  const bf16* kh = k + b * kb + (long long)h * D;
  const bf16* vh = v + b * vb + (long long)h * D;
  const int tiles = idm::cdiv(Skv, BKV);

  load_tile<DP>(Qs, qh, qr, q0, Sq, D);
  load_tile<DP>(Ks, kh, kr, 0, Skv, D);
  load_tile<DP>(Vs, vh, vr, 0, Skv, D);
  idm::cp_async_commit();

  uint32_t qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // rows g and g + 8 of the warp's 16: running max and this thread's
  // share of the running sum (the quad's shares add up at the end)
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int st = (t + 1) & 1;
      load_tile<DP>(Ks + st * L::TILE, kh, kr, (t + 1) * BKV, Skv, D);
      load_tile<DP>(Vs + st * L::TILE, vh, vr, (t + 1) * BKV, Skv, D);
    }
    idm::cp_async_commit();
    idm::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      const bf16* qw = Qs + (warp * 16 + g) * L::LD + tg * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qf[ks][0] = ld32(qw + ks * 16);
        qf[ks][1] = ld32(qw + 8 * L::LD + ks * 16);
        qf[ks][2] = ld32(qw + ks * 16 + 8);
        qf[ks][3] = ld32(qw + 8 * L::LD + ks * 16 + 8);
      }
    }
    const bf16* ks_ = Ks + (t & 1) * L::TILE;
    const bf16* vs_ = Vs + (t & 1) * L::TILE;

    // S = Q K^T: 16 rows x 64 keys of this warp, in NT accumulator tiles
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kw = ks_ + (n * 8 + g) * L::LD + tg * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma16816(s[n], qf[kk], ld32(kw + kk * 16), ld32(kw + kk * 16 + 8));
    }

    // scale, mask the KV tail, row max over the quad
    const int key0 = t * BKV + tg * 2;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = key0 + n * 8 + e < Skv;
        s[n][e] = ok ? s[n][e] * scale : NEG;
        s[n][2 + e] = ok ? s[n][2 + e] * scale : NEG;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = __expf(s[n][e] - mn0);
        s[n][2 + e] = __expf(s[n][2 + e] - mn1);
        ps0 += s[n][e];
        ps1 += s[n][2 + e];
      }
    }
    l0 = a0 * l0 + ps0;
    l1 = a1 * l1 + ps1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }

    // O += P V: the S tiles 2j, 2j + 1 are the A operand of keys 16j..16j+15
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_f2(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_f2(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_f2(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_f2(s[2 * j + 1][2], s[2 * j + 1][3]);
      const bf16* vr0 = vs_ + (j * 16 + tg * 2) * L::LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const bf16* vp = vr0 + d * 8;
        const uint32_t b0 = pack2(vp[0], vp[L::LD]);
        const uint32_t b1 = pack2(vp[8 * L::LD], vp[9 * L::LD]);
        mma16816(o[d], pa, b0, b1);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  idm::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g;
  bf16* o0 = out + b * ob + r0 * orow + (long long)h * D + tg * 2;
  bf16* o1 = o0 + 8 * orow;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (d * 8 >= D) break;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + d * 8) =
          __floats2bfloat162_rn(o[d][0] * inv0, o[d][1] * inv0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + d * 8) =
          __floats2bfloat162_rn(o[d][2] * inv1, o[d][3] * inv1);
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
           int Sq, int Skv, int H, int D, const long long* st, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<DP>::BYTES;
  cudaError_t e = idm::allow_smem(flash_kernel<DP>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(idm::cdiv(Sq, BQ), H, B);
  flash_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: {q, k, v, out} x {batch, row}. The head stride
// is D and the element stride 1; D % 8 == 0, every stride % 8 == 0 and the
// pointers 16-byte aligned (the wrapper checks), for the 16-byte copies.
extern "C" int idm_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int D, long long q_batch,
                                   long long q_row, long long k_batch,
                                   long long k_row, long long v_batch,
                                   long long v_row, long long o_batch,
                                   long long o_row, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Skv <= 0 || H > 65535 || B > 65535 || D <= 0 || D > 128 || D % 8)
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {q_batch, q_row, k_batch, k_row,
                           v_batch, v_row, o_batch, o_row};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(qp, kp, vp, op, B, Sq, Skv, H, D, st, scale, s);
  if (D <= 32) return launch<32>(qp, kp, vp, op, B, Sq, Skv, H, D, st, scale, s);
  if (D <= 64) return launch<64>(qp, kp, vp, op, B, Sq, Skv, H, D, st, scale, s);
  return launch<128>(qp, kp, vp, op, B, Sq, Skv, H, D, st, scale, s);
}
