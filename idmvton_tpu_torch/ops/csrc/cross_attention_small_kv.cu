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
//
// Design: persistent blocks walk a contiguous range of 128-query tiles,
// ordered (batch row, 128-column head group) outer, so a block holds one
// group's K and V of both branches in shared memory (the KC_T = 80 padded
// text rows and KC_I = 16 IP rows of its 128 / D heads: 48 KB) and loads
// them again only when its range enters the next group. A producer warp
// streams the 128-row q boxes of its tiles through a STAGES-deep TMA ring
// (32 KB a stage). Each of two consumer warpgroups owns 64 rows of a tile
// and, per head and branch, issues S = Q K^T (wgmma m64nKCk16, Q and K
// K-major from shared memory: K's rows hold D contiguous values), masks
// the key columns past the branch's length to -inf, takes the row max and
// sum in registers with quad shuffles, normalizes, rounds P to bf16 A
// fragments in registers and issues O += P V (wgmma m64nDk16 with A from
// registers, V MN-major); the text result waits in fp32 registers for
// ip_scale * o_ip, then each thread stores its bf16 pairs. Every box is one
// head's D columns (two 64-column boxes at D = 128) under the swizzle of
// its row bytes, as flash_attention.cuh's; TMA zero-fills key rows past the
// context and query rows past N. Contexts longer than a chunk (not on the
// serving path) keep the exact two-pass scheme in the same kernel: a pass
// over the chunks for the row max and sum, a second for P and PV, each
// chunk loaded into the branch's region in turn. The tile counts and the
// tensor maps come from the wrapper's plan (cuda_attention.py::
// cross_attention_plan).

#include "common.cuh"

namespace {

using idm::bf16;
using idm::ex2;

// The ring depth: the value scripts/torch_attention_tiles.py --cross chose;
// it builds the others with -DIDM_CROSS_STAGES=...
#ifndef IDM_CROSS_STAGES
#define IDM_CROSS_STAGES 3
#endif
// Measurement builds of the sweep only (wrong results): IDM_CROSS_PROBE
// bit 0 skips the IP branch, bit 1 the output stores, bit 2 the softmax
// (P is S rounded to bf16).
#ifndef IDM_CROSS_PROBE
#define IDM_CROSS_PROBE 0
#endif
constexpr int STAGES = IDM_CROSS_STAGES;
static_assert(STAGES >= 2 && STAGES <= 4, "the ring takes 2 to 4 stages");
constexpr int BQ = 128, GC = 128, THREADS = 384;
constexpr int KC_T = 80, KC_I = 16;  // key rows a chunk: text, IP
constexpr int Q_BYTES = BQ * GC * 2;
constexpr int KV_T_BYTES = 2 * KC_T * GC * 2;  // a group's K and V rows
constexpr int KV_I_BYTES = 2 * KC_I * GC * 2;
constexpr size_t SMEM =
    1024 + (size_t)STAGES * Q_BYTES + KV_T_BYTES + KV_I_BYTES +
    8 * (2 * STAGES + 2);
static_assert(SMEM <= 232448, "shared memory");
constexpr float LOG2E = 1.4426950408889634f;
#define NEG_INF __int_as_float(0xff800000)  // a masked logit

// A 4-D TMA map as the plan gives it: dims and box innermost first, byte
// strides of dims 1..3, the swizzle span in bytes, the element size;
// dims[0] == 0: no map.
struct MapDesc {
  long long dims[4], strides[3], box[4], swizzle, elem;
};

// cuda_attention.py::CrossPlan.c_plan, field for field (int64 each)
struct Plan {
  long long dp;                  // head dim: the instance
  long long groups, q_tiles;     // 128-column head groups; 128-query tiles
  long long tiles, grid;         // (b, group, q tile) tiles; blocks
  long long text_chunks, ip_chunks;  // KC_T / KC_I-row chunks of a context
  MapDesc maps[3];               // q, kv, kv_ip
};
static_assert(sizeof(Plan) == 46 * sizeof(long long), "Plan");

struct Args {
  int N, H, groups, q_tiles, tiles;
  int s_text, s_ip, text_chunks, ip_chunks;
  float scale, ip_scale;
  bf16* out;
};

// A head's geometry: its TMA boxes are BOX columns of SW-byte rows, NBOX
// of them (two at D = 128), KPB 16-deep k steps a box.
template <int D>
struct Geo {
  static constexpr int BOX = D < 64 ? D : 64;
  static constexpr int SW = 2 * BOX;
  static constexpr int NBOX = D / BOX;
  static constexpr int KPB = BOX / 16;
  static constexpr int HPB = GC / D;  // heads a group
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "D");
};

// S (64 x KC) = Q_h K_h^T over D / 16 k steps: Q (this warpgroup's 64 rows
// of the stage's head boxes) and K (KC rows) K-major in shared memory
template <int D, int KC>
__device__ __forceinline__ void issue_qk(float* s, const uint8_t* qh,
                                         const uint8_t* kh) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / G::KPB, off = 32 * (kk % G::KPB);
    idm::wgmma_bf16_kb<KC>(
        s, idm::smem_desc(qh + x * BQ * G::SW + off, 16, 8 * G::SW, G::SW),
        idm::smem_desc(kh + x * KC * G::SW + off, 16, 8 * G::SW, G::SW),
        kk > 0);
  }
}

// O (64 x D) += P V_h over KC / 16 k steps: P in registers, V (KC rows x D)
// MN-major, its 64-column boxes KC * 128 bytes apart at D = 128
template <int D, int KC>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p,
                                         const uint8_t* vh) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk)
    idm::wgmma_bf16_rs<D>(
        o, p + 4 * kk,
        idm::smem_desc(vh + kk * 16 * G::SW, KC * G::SW, 8 * G::SW, G::SW));
}

// The logits of an S tile in place: s * scale, keys at or past `len`
// (columns of this chunk) -inf; returns this thread's maxima of its rows 0
// / 1 (lane / 4 and lane / 4 + 8 of its warp's 16), quad-reduced.
template <int N>
__device__ __forceinline__ void logits(float (&s)[N], int len, int q,
                                       float scale, float& x0, float& x1) {
  x0 = x1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int col = 8 * (i / 4) + 2 * q + (i & 1);
    s[i] = col < len ? s[i] * scale : NEG_INF;
    if (i & 2) x1 = fmaxf(x1, s[i]);
    else x0 = fmaxf(x0, s[i]);
  }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, sh));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, sh));
  }
}

// exp(s - m) of a logit tile in place (log2 units); returns the quad's row
// sums
template <int N>
__device__ __forceinline__ void exps(float (&s)[N], float m0, float m1,
                                     float& l0, float& l1) {
  l0 = l1 = 0.f;
  const float n0 = m0 * LOG2E, n1 = m1 * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2) {
      s[i] = ex2(fmaf(s[i], LOG2E, -n1));
      l1 += s[i];
    } else {
      s[i] = ex2(fmaf(s[i], LOG2E, -n0));
      l0 += s[i];
    }
  }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
}

// What the consumers share: the K/V regions of the two branches, which
// (unit, chunk) each holds, and the phase of its barrier.
struct KvState {
  uint8_t* region[2];
  uint64_t* bar;
  const CUtensorMap* map[2];
  int held[2];
  unsigned phase[2];
};

// Makes chunk `ch` of branch `br` of `unit` resident in the branch's
// region: both consumer warpgroups call it at the same points and wait
// until neither reads the region (every wgmma of theirs is done by then);
// then one thread loads the K and V boxes of the group's heads.
template <int D>
__device__ __forceinline__ void ensure(KvState& kv, const Args& a, int ct,
                                       int br, int unit, int ch, int chunks) {
  using G = Geo<D>;
  const int tag = unit * chunks + ch;
  if (kv.held[br] == tag) return;
  idm::consumers_sync();
  const int kc = br ? KC_I : KC_T;
  if (ct == 0) {
    const int b = unit / a.groups, h0 = (unit % a.groups) * G::HPB;
    uint8_t* region = kv.region[br];
    idm::mbar_expect_tx(&kv.bar[br], 2 * kc * GC * 2);
#pragma unroll
    for (int h = 0; h < G::HPB; ++h)
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x) {
        const int off = (h * G::NBOX + x) * kc * G::SW;
        idm::tma_load_4d(region + off, kv.map[br], &kv.bar[br], x * G::BOX,
                         h0 + h, ch * kc, b);
        idm::tma_load_4d(region + kc * GC * 2 + off, kv.map[br], &kv.bar[br],
                         x * G::BOX, a.H + h0 + h, ch * kc, b);
      }
  }
  idm::mbar_wait(&kv.bar[br], kv.phase[br]);
  kv.phase[br] ^= 1u;
  kv.held[br] = tag;
}

// One branch (KC-row chunks) of head h for this warpgroup's 64 rows, whose
// Q boxes start at qh: the exact softmax over the branch's keys, o = P V.
template <int D, int KC>
__device__ __forceinline__ void branch(KvState& kv, const Args& a, int ct,
                                       int q, int br, int unit, int h,
                                       const uint8_t* qh, float* o) {
  using G = Geo<D>;
  const int S = br ? a.s_ip : a.s_text;
  const int chunks = br ? a.ip_chunks : a.text_chunks;
  const uint8_t* kh = kv.region[br] + h * G::NBOX * KC * G::SW;
  const uint8_t* vh = kh + KC * GC * 2;
  float s[KC / 2];
  uint32_t p[KC / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  if (chunks > 1) {  // pass 1: the rows' max and sum over all chunks
    for (int ch = 0; ch < chunks; ++ch) {
      ensure<D>(kv, a, ct, br, unit, ch, chunks);
      idm::wgmma_fence();
      issue_qk<D, KC>(s, qh, kh);
      idm::wgmma_commit();
      idm::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) idm::fence_operand(s[i]);
      float x0, x1, c0, c1;
      logits(s, S - ch * KC, q, a.scale, x0, x1);
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      exps(s, n0, n1, c0, c1);
      l0 = l0 * ex2((m0 - n0) * LOG2E) + c0;
      l1 = l1 * ex2((m1 - n1) * LOG2E) + c1;
      m0 = n0, m1 = n1;
    }
  }
  // pass 2 (the only pass for one chunk): P = exp(s - m) / l, o += P V
  for (int ch = 0; ch < chunks; ++ch) {
    ensure<D>(kv, a, ct, br, unit, ch, chunks);
    idm::wgmma_fence();
    issue_qk<D, KC>(s, qh, kh);
    idm::wgmma_commit();
    idm::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) idm::fence_operand(s[i]);
    float x0, x1, c0, c1, i0 = 1.f, i1 = 1.f;
    if (!(IDM_CROSS_PROBE & 4)) {
      logits(s, S - ch * KC, q, a.scale, x0, x1);
      if (chunks == 1) m0 = x0, m1 = x1;
      exps(s, m0, m1, c0, c1);
      if (chunks == 1) l0 = c0, l1 = c1;
      i0 = 1.f / l0, i1 = 1.f / l1;
    }
#pragma unroll
    for (int i = 0; i < KC / 4; ++i) {
      const float r = (i & 1) ? i1 : i0;  // elements 2i, 2i + 1: one row
      p[i] = idm::pack_bf16x2(s[2 * i] * r, s[2 * i + 1] * r);
    }
    idm::wgmma_fence();
    issue_pv<D, KC>(o, p, vh);
    idm::wgmma_commit();
    idm::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) idm::fence_operand(o[i]);
#pragma unroll
    for (int i = 0; i < KC / 4; ++i) idm::fence_u32(p[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    cross_small_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kvmap,
                       const __grid_constant__ CUtensorMap ipmap,
                       const Args a) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* kv_t = ring + STAGES * Q_BYTES;
  uint8_t* kv_i = kv_t + KV_T_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_i + KV_I_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;  // one a branch
  int t0, t1;
  idm::tile_range(a.tiles, t0, t1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      idm::mbar_init(&full[s], 1);
      idm::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    idm::mbar_init(&kvbar[0], 1);
    idm::mbar_init(&kvbar[1], 1);
    idm::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: the q boxes of each tile ------------------------------
    idm::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      for (int t = t0, it = 0; t < t1; ++t, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) idm::mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
        const int unit = t / a.q_tiles, qt = t % a.q_tiles;
        const int b = unit / a.groups, h0 = (unit % a.groups) * G::HPB;
        uint8_t* st = ring + s * Q_BYTES;
        idm::mbar_expect_tx(&full[s], Q_BYTES);
#pragma unroll
        for (int h = 0; h < G::HPB; ++h)
#pragma unroll
          for (int x = 0; x < G::NBOX; ++x)
            idm::tma_load_4d(st + (h * G::NBOX + x) * BQ * G::SW, &qmap,
                             &full[s], x * G::BOX, h0 + h, qt * BQ, b);
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  idm::reg_alloc<232>();
  const int ct = threadIdx.x - 128;
  const int w = ct / 128;  // query rows [64 w, 64 w + 64) of the tile
  const int warp = (ct / 32) % 4, lane = ct % 32, q = lane % 4;
  KvState kv;
  kv.region[0] = kv_t, kv.region[1] = kv_i;
  kv.bar = kvbar;
  kv.map[0] = &kvmap, kv.map[1] = &ipmap;
  kv.held[0] = kv.held[1] = -1;
  kv.phase[0] = kv.phase[1] = 0u;
  float ot[D / 2], oi[D / 2];
  for (int t = t0, it = 0; t < t1; ++t, ++it) {
    const int s = it % STAGES;
    const int unit = t / a.q_tiles, qt = t % a.q_tiles;
    const int b = unit / a.groups, col0 = (unit % a.groups) * GC;
    idm::mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* qs = ring + s * Q_BYTES + w * 64 * G::SW;
    const int r0 = qt * BQ + 64 * w + 16 * warp + lane / 4;
    bf16* o0 = a.out + ((size_t)b * a.N + r0) * (a.H * D) + col0 + 2 * q;
    bf16* o1 = o0 + (size_t)8 * a.H * D;
#pragma unroll 1
    for (int h = 0; h < G::HPB; ++h) {
      const uint8_t* qh = qs + h * G::NBOX * BQ * G::SW;
      branch<D, KC_T>(kv, a, ct, q, 0, unit, h, qh, ot);
      if (a.s_ip > 0 && !(IDM_CROSS_PROBE & 1)) {
        branch<D, KC_I>(kv, a, ct, q, 1, unit, h, qh, oi);
#pragma unroll
        for (int i = 0; i < D / 2; ++i)
          ot[i] = __fadd_rn(ot[i], __fmul_rn(a.ip_scale, oi[i]));
      }
      if (IDM_CROSS_PROBE & 2) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (r0 < a.N)
          *reinterpret_cast<uint32_t*>(o0 + h * D + 8 * j) =
              idm::pack_bf16x2(ot[4 * j], ot[4 * j + 1]);
        if (r0 + 8 < a.N)
          *reinterpret_cast<uint32_t*>(o1 + h * D + 8 * j) =
              idm::pack_bf16x2(ot[4 * j + 2], ot[4 * j + 3]);
      }
    }
    if (lane == 0) idm::mbar_arrive(&empty[s]);  // the tile's Q is read
  }
}

// Encodes the plan's map i over `base`.
inline cudaError_t encode_map(CUtensorMap* map, const void* base,
                              const Plan& p, int i) {
  const MapDesc& m = p.maps[i];
  if (m.dims[0] <= 0 || base == nullptr) return cudaErrorInvalidValue;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  for (int j = 0; j < 4; ++j)
    dims[j] = (cuuint64_t)m.dims[j], box[j] = (cuuint32_t)m.box[j];
  for (int j = 0; j < 3; ++j) strides[j] = (cuuint64_t)m.strides[j];
  return idm::encode_tiled(map, base, 4, dims, strides, box, (int)m.swizzle,
                           (int)m.elem);
}

template <int D>
cudaError_t launch(const CUtensorMap& qmap, const CUtensorMap& kvmap,
                   const CUtensorMap& ipmap, const Args& a, int grid,
                   cudaStream_t st) {
  auto kernel = cross_small_kernel<D>;
  static const cudaError_t e = idm::allow_smem(kernel, SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, SMEM, st>>>(qmap, kvmap, ipmap, a);
  return cudaGetLastError();
}

}  // namespace

// q (B, N, H*D), kv (B, S_text, 2*H*D), kv_ip (B, S_ip, 2*H*D) or NULL, out
// (B, N, H*D), all bf16; then the plan (cuda_attention.py::CrossPlan.c_plan):
// the tile counts and the q, kv and kv_ip maps, encoded as given.
extern "C" int idm_cross_attention_small_kv(const void* q, const void* kv,
                                            const void* kv_ip, void* out,
                                            int B, int N, int H, int D,
                                            int s_text, int s_ip, float scale,
                                            float ip_scale, const void* plan,
                                            void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  if ((H * D) % GC != 0 || s_text <= 0 || s_ip < 0 ||
      (kv_ip != nullptr) != (s_ip > 0) || p.dp != D ||
      p.groups != (H * D) / GC || p.tiles <= 0 || p.grid <= 0 ||
      p.text_chunks != idm::cdiv(s_text, KC_T) ||
      p.ip_chunks != idm::cdiv(s_ip, KC_I))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.N = N, a.H = H, a.groups = (int)p.groups, a.q_tiles = (int)p.q_tiles;
  a.tiles = (int)p.tiles;
  a.s_text = s_text, a.s_ip = s_ip;
  a.text_chunks = (int)p.text_chunks, a.ip_chunks = (int)p.ip_chunks;
  a.scale = scale, a.ip_scale = ip_scale;
  a.out = static_cast<bf16*>(out);
  CUtensorMap qmap, kvmap, ipmap;
  cudaError_t e = encode_map(&qmap, q, p, 0);
  if (e == cudaSuccess) e = encode_map(&kvmap, kv, p, 1);
  // without an IP branch the kernel never reads ipmap: the text map fills it
  if (e == cudaSuccess)
    e = s_ip > 0 ? encode_map(&ipmap, kv_ip, p, 2) : encode_map(&ipmap, kv, p, 1);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (int)p.grid;
  switch (D) {
    case 16:
      return (int)launch<16>(qmap, kvmap, ipmap, a, grid, st);
    case 32:
      return (int)launch<32>(qmap, kvmap, ipmap, a, grid, st);
    case 64:
      return (int)launch<64>(qmap, kvmap, ipmap, a, grid, st);
    case 128:
      return (int)launch<128>(qmap, kvmap, ipmap, a, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
