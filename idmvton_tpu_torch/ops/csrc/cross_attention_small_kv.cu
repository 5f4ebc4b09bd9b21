// Small-KV cross-attention in GEMM layouts: text and IP branches, two
// softmaxes summed.
//
// Replaces idmvton_tpu/ops/pallas_attention.py::cross_attention_small_kv
// (_cross_small_core / _cross_small_kernel).
//
// Semantics: q (B, N, H*D) is the to_q output (merged heads); kv (B, S, 2*H*D)
// the fused to_kv output [K | V] of the S text tokens; kv_ip (B, S_ip,
// 2*H*D) that of the IP tokens, or null. Per head and branch: fp32 logits
// q.k * scale, an exact softmax over the branch's tokens (max-subtracted,
// normalized before the PV product), probabilities cast to bf16, PV with
// fp32 accumulation. The output is out_text + ip_scale * out_ip, summed in
// fp32 and cast once, written in merged heads (B, N, H*D).
//
// What bounds it on the H100: bytes. At the serving shapes the context is
// 77 + 16 tokens, so each query row costs ~2 x 93 x D multiply-adds per head
// against 4 bytes of q and out per column: reading q and writing out (~31 MB
// at the TryonNet 640 level) is the floor.
// Design: one block of 4 warps per (64-query tile, 128-column head group,
// batch row); each warp owns 16 query rows, a lane pair one row. The group's
// K/V rows of a branch (up to KC = 80 tokens per chunk: the 77 text tokens
// in one) sit in shared memory; rows past the branch's length are
// zero-filled, so masked columns meet p = 0 and V = 0. S = QK^T and O += PV
// are bf16 WMMA products with fp32 accumulation; S goes through a per-warp
// fp32 tile where the lane pair of a row takes its max, sum and the
// normalized probabilities. The softmax is exact for any context length: a
// first pass over the chunks finds each row's max and sum, a second forms p
// and PV (one chunk at the serving shapes, so each K/V row is loaded once).
// The text result waits in a per-warp fp32 tile for the IP branch to be
// added.

#include "common.cuh"

using namespace nvcuda;
using idm::bf16;

namespace {

constexpr int BQ = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int GC = 128;  // columns of a head group
constexpr int KC = 80;   // context tokens per chunk
constexpr float NEG = -1e30f;

constexpr int LDQ = GC + 8;  // Q / K / V tiles (bf16)
constexpr int LDS = KC + 4;  // S tile (fp32)
constexpr int LDP = KC + 8;  // P tile (bf16)
constexpr int LDO = GC + 4;  // O tile (fp32)
constexpr size_t Q_OFF = 0;
constexpr size_t K_OFF = Q_OFF + (size_t)BQ * LDQ * sizeof(bf16);
constexpr size_t V_OFF = K_OFF + (size_t)KC * LDQ * sizeof(bf16);
constexpr size_t S_OFF = V_OFF + (size_t)KC * LDQ * sizeof(bf16);
constexpr size_t P_OFF = S_OFF + (size_t)WARPS * 16 * LDS * sizeof(float);
constexpr size_t O_OFF = P_OFF + (size_t)WARPS * 16 * LDP * sizeof(bf16);
constexpr size_t SMEM = O_OFF + (size_t)WARPS * 16 * LDO * sizeof(float);

template <int D>
__global__ void __launch_bounds__(THREADS)
    cross_small_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                       const bf16* __restrict__ kv_ip, bf16* __restrict__ out,
                       int N, int H, int s_text, int s_ip, float scale,
                       float ip_scale) {
  constexpr int HPB = GC / D;  // heads per group
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + V_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Sw = reinterpret_cast<float*>(smem + S_OFF) + warp * 16 * LDS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + P_OFF) + warp * 16 * LDP;
  float* Ow = reinterpret_cast<float*>(smem + O_OFF) + warp * 16 * LDO;

  const int q0 = blockIdx.x * BQ, col0 = blockIdx.y * GC, b = blockIdx.z;
  const int HD = H * D;
  const size_t ld_kv = 2 * (size_t)HD;

  for (int i = tid; i < BQ * (GC / 8); i += THREADS) {
    const int r = i / (GC / 8), c = i % (GC / 8), n = q0 + r;
    const bool ok = n < N;
    const bf16* src = ok ? q + ((size_t)b * N + n) * HD + col0 + c * 8 : q;
    idm::cp_async16(Qs + r * LDQ + c * 8, src, ok);
  }
  idm::cp_async_commit();

  // K/V rows [c0, c0 + len) of a branch -> Ks / Vs rows [0, KC), zeros past
  auto load_chunk = [&](const bf16* base, int c0, int len) {
    for (int i = tid; i < KC * (GC / 8); i += THREADS) {
      const int r = i / (GC / 8), c = i % (GC / 8);
      const bool ok = r < len;
      const bf16* row = base + (size_t)(ok ? c0 + r : 0) * ld_kv;
      idm::cp_async16(Ks + r * LDQ + c * 8, ok ? row + col0 + c * 8 : base,
                      ok);
      idm::cp_async16(Vs + r * LDQ + c * 8, ok ? row + HD + col0 + c * 8 : base,
                      ok);
    }
    idm::cp_async_commit();
    idm::cp_async_wait<0>();
    __syncthreads();
  };

  // S = Q_h K_h^T for this warp's 16 rows and `tiles` 16-token column tiles
  auto scores = [&](int h, int tiles) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
    for (int d = 0; d < D / 16; ++d)
      wmma::load_matrix_sync(qf[d], Qs + warp * 16 * LDQ + h * D + d * 16, LDQ);
    for (int j = 0; j < tiles; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * LDQ + h * D + d * 16, LDQ);
        wmma::mma_sync(s, qf[d], kf, s);
      }
      wmma::store_matrix_sync(Sw + j * 16, s, LDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  const int r = lane >> 1, half = lane & 1;  // lane pair (2r, 2r+1): row r
  const int branches = kv_ip != nullptr && s_ip > 0 ? 2 : 1;
  for (int br = 0; br < branches; ++br) {
    const int S = br == 0 ? s_text : s_ip;
    const bf16* base = (br == 0 ? kv : kv_ip) + (size_t)b * S * ld_kv;
    const int chunks = idm::cdiv(S, KC);

    // pass 1: each row's max and sum of exp over the branch's tokens
    float m[HPB], l[HPB];
#pragma unroll
    for (int h = 0; h < HPB; ++h) {
      m[h] = NEG;
      l[h] = 0.f;
    }
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = ch * KC, len = min(KC, S - c0);
      __syncthreads();  // every warp is done with the previous chunk
      load_chunk(base, c0, len);
#pragma unroll
      for (int h = 0; h < HPB; ++h) {
        scores(h, idm::cdiv(len, 16));
        float tmax = NEG;
        for (int e = half * (KC / 2); e < (half + 1) * (KC / 2); ++e)
          if (e < len) tmax = fmaxf(tmax, Sw[r * LDS + e] * scale);
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        const float m_new = fmaxf(m[h], tmax);
        float psum = 0.f;
        for (int e = half * (KC / 2); e < (half + 1) * (KC / 2); ++e)
          if (e < len) psum += expf(Sw[r * LDS + e] * scale - m_new);
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        l[h] = l[h] * expf(m[h] - m_new) + psum;
        m[h] = m_new;
        __syncwarp();  // the next head rewrites Sw
      }
    }

    // pass 2: p = exp(s - max) / sum as bf16, O += P V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HPB][D / 16];
#pragma unroll
    for (int h = 0; h < HPB; ++h)
#pragma unroll
      for (int d = 0; d < D / 16; ++d) wmma::fill_fragment(o[h][d], 0.f);
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = ch * KC, len = min(KC, S - c0), tiles = idm::cdiv(len, 16);
      if (chunks > 1) {  // one chunk is still resident from pass 1
        __syncthreads();
        load_chunk(base, c0, len);
      }
#pragma unroll
      for (int h = 0; h < HPB; ++h) {
        scores(h, tiles);
        for (int e = half * (KC / 2); e < (half + 1) * (KC / 2); ++e)
          if (e < tiles * 16)
            Pw[r * LDP + e] = __float2bfloat16(
                e < len ? expf(Sw[r * LDS + e] * scale - m[h]) / l[h] : 0.f);
        __syncwarp();
        for (int kk = 0; kk < tiles; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
          wmma::load_matrix_sync(pf, Pw + kk * 16, LDP);
#pragma unroll
          for (int d = 0; d < D / 16; ++d) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                vf;
            wmma::load_matrix_sync(vf, Vs + kk * 16 * LDQ + h * D + d * 16,
                                   LDQ);
            wmma::mma_sync(o[h][d], pf, vf, o[h][d]);
          }
        }
        __syncwarp();  // the next head rewrites Sw and Pw
      }
    }

    // text: park O in the warp's tile; IP: add ip_scale * O to it (fp32)
#pragma unroll
    for (int h = 0; h < HPB; ++h)
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        float* dst = Ow + h * D + d * 16;
        if (br == 1) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> t;
          wmma::load_matrix_sync(t, dst, LDO, wmma::mem_row_major);
#pragma unroll
          for (int e = 0; e < t.num_elements; ++e)
            o[h][d].x[e] = __fadd_rn(t.x[e], __fmul_rn(ip_scale, o[h][d].x[e]));
        }
        wmma::store_matrix_sync(dst, o[h][d], LDO, wmma::mem_row_major);
      }
    __syncwarp();
  }

  const int n = q0 + warp * 16 + r;
  if (n < N) {
    bf16* dst = out + ((size_t)b * N + n) * HD + col0;
    for (int c = half * (GC / 2); c < (half + 1) * (GC / 2); c += 8)
      *reinterpret_cast<uint4*>(dst + c) = idm::pack8(Ow + r * LDO + c);
  }
}

template <int D>
int launch(const bf16* q, const bf16* kv, const bf16* kv_ip, bf16* out, int B,
           int N, int H, int s_text, int s_ip, float scale, float ip_scale,
           cudaStream_t stream) {
  cudaError_t e = idm::allow_smem(cross_small_kernel<D>, SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(idm::cdiv(N, BQ), H * D / GC, B);
  cross_small_kernel<D><<<grid, THREADS, SMEM, stream>>>(
      q, kv, kv_ip, out, N, H, s_text, s_ip, scale, ip_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int idm_cross_attention_small_kv(const void* q, const void* kv,
                                            const void* kv_ip, void* out,
                                            int B, int N, int H, int D,
                                            int s_text, int s_ip, float scale,
                                            float ip_scale, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if ((H * D) % GC != 0 || s_text <= 0 || s_ip < 0 ||
      (kv_ip != nullptr && s_ip <= 0) || B > 65535 || (H * D) / GC > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* t = static_cast<const bf16*>(kv);
  const bf16* ip = static_cast<const bf16*>(kv_ip);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(qq, t, ip, o, B, N, H, s_text, s_ip, scale, ip_scale, st);
    case 32:
      return launch<32>(qq, t, ip, o, B, N, H, s_text, s_ip, scale, ip_scale, st);
    case 64:
      return launch<64>(qq, t, ip, o, B, N, H, s_text, s_ip, scale, ip_scale, st);
    case 128:
      return launch<128>(qq, t, ip, o, B, N, H, s_text, s_ip, scale, ip_scale,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
