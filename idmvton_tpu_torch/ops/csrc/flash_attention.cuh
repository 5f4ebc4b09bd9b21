// Flash attention for Hopper: TMA tiles, an mbarrier ring and wgmma, the
// softmax in registers. One templated kernel serves both sources, which
// differ only in where Q, K and V lie and what each batch row attends over:
//
//   flash_gemm_kernel (flash_attention_gemm.cu, #4): Q, K and V are the
//     column sections of the to_qkv output (B, N, 3*H*D), read through one
//     4-D tensor map of dims (D, 3*H, N, B) at head coordinates h, H + h,
//     2*H + h; the garment K|V (B - uncond_rows, M, 2*H*D) through a second
//     map (D, 2*H, M, B - uncond_rows). A row attends over its N own keys,
//     then (rows >= uncond_rows) its M garment keys; the leading uncond_rows
//     rows start from the analytic sink of M zero logits (m = 0, l = M) and
//     never read garment memory. sink_tokens adds that many more.
//   flash_kernel (flash_attention.cu, #9 / #10): q (B, Sq, H, D), k / v
//     (B, Skv, H, D) and, for flash_attention_concat_kv, the garment k / v
//     (B, M, H, D) are views read in place through their strides: maps of
//     dims (D, H, S, B), so the split-head views of a to_qkv output and the
//     (B, St, 3, H, D) slices need no copy, and [own | garment] keys no
//     concatenated copy.
//
// A map's box is (min(DP, 64) columns, 1 head, rows, 1 batch row): TMA
// zero-fills what lies outside the tensor, so key rows past N (or M, Skv)
// arrive as K = V = 0 (masked keys meet V = 0, never garbage) and head
// columns past D as zeros (D = 8..128 runs at the padded width DP in {16,
// 32, 64, 128}: zero columns add nothing to q . k, and O's are not stored).
// The box row is DP * 2 bytes under the swizzle of that span (32, 64 or 128
// bytes): exactly wgmma's K-major layout for Q and K and its MN-major layout
// for V. At DP = 128 each tile is two 64-column boxes, as the conv kernel
// splits its N.
//
// The launch geometry is the wrapper's plan (cuda_attention.py::
// attention_plan), passed as a `Plan`: the instance (DP, BKV, WGS), the
// grid and its tile counts, the head coordinates and every tensor map's
// dims, strides and box, which the entry points encode as given.
//
// Block (BQ = 64 WGS queries of one head and batch row): warpgroup 0 is
// the producer (one thread issues the Q box, then the K and V boxes of BKV
// keys into a ring of STAGES stages, a full/empty mbarrier pair a stage);
// each of the WGS = 2 or 3 consumer warpgroups owns 64 query rows. Per KV
// tile a consumer issues S = Q K^T (wgmma m64nBKVk16, Q and K from shared
// memory), masks the keys past the tile's limit and exponentiates the
// logits in log2 units with
// ex2.approx (fixed shift: p = 2^min(s * scale * log2 e, 60 log2 e), no
// running max; online max: the quad-shuffle row max of the raw logits, p =
// 2^(s * scale * log2 e - m) in one FFMA, and O rescaled in its own
// registers), keeps its share of the row sum, packs P to bf16 in registers
// and issues O += P V (wgmma m64nDPk16 with A from registers: an fp32
// accumulator pair is the A fragment, so P never touches shared memory).
// Tile t's S product is issued with tile t - 1's PV product, and tile t's
// exponentials run while that PV product is in flight. With PINGPONG the
// consumers take turns through named barriers to issue their products, so
// one's exponentials overlap another's matrix work. The quad reduces
// the row sum once at the end; the output is O / max(l, 1e-30) in bf16 at
// (b, n, h, 0:D) of a (B, Nq, H, D) tensor. WGS = 3 consumer warpgroups
// (BQ = 192, 160 registers a consumer thread) read each K/V tile for 192
// queries and keep 12 warps on an SM busy at the softmax.
//
// What bounds it on the H100: the tensor cores (4 * D FLOP a logit) and the
// exponentials (one a logit, ~3.9e12/s on the special-function units) cost
// the same at D = 64; at D = 16 the exponentials cost 4x the MMA.
#pragma once

#include "common.cuh"

namespace idm_attn {

using idm::bf16;
using idm::ex2;
using idm::fence_u32;
using idm::pack_bf16x2;

// The ring depth and the consumers' turn-taking: the values
// scripts/torch_attention_tiles.py's sweep chose, which builds the others
// with -DIDM_ATTN_STAGES=... -DIDM_ATTN_PINGPONG=...
#ifndef IDM_ATTN_STAGES
#define IDM_ATTN_STAGES 3
#endif
#ifndef IDM_ATTN_PINGPONG
#define IDM_ATTN_PINGPONG 1
#endif
constexpr int STAGES = IDM_ATTN_STAGES;
constexpr bool PINGPONG = IDM_ATTN_PINGPONG != 0;
// One stage would hang: tile 1 waits for stage 0's refill, which waits for
// tile 0's PV product, issued after that wait.
static_assert(STAGES >= 2 && STAGES <= 4, "the ring takes 2 to 4 stages");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLAMP = 60.f;  // pallas_attention.py::_FIXED_SHIFT_CLAMP
constexpr float NEG = -1e30f;
// shared memory a block may take
constexpr int SMEM_LIMIT = 232448;

// A block of WGS consumer warpgroups (64 queries each: BQ = 64 WGS) and a
// producer warpgroup, one block an SM; its registers a thread after
// setmaxnreg: the producer gives up what the consumers take, within the
// block's launch allocation of 65536 (rounded down to 8 a thread).
template <int WGS>
struct Regs;
template <>
struct Regs<2> {  // 384 x 168 at launch
  static constexpr int PRODUCER = 40, CONSUMER = 232;
};
template <>
struct Regs<3> {  // 512 x 128
  static constexpr int PRODUCER = 24, CONSUMER = 160;
};

template <int DP, int BKV, int WGS>
struct Cfg {
  static constexpr int BQ = 64 * WGS;
  static constexpr int BOX = DP < 64 ? DP : 64;  // head columns a TMA box
  static constexpr int SW = 2 * BOX;             // its row bytes = swizzle
  static constexpr int NBOX = DP / BOX;          // boxes a tile: 1, or 2
  static constexpr int KPB = BOX / 16;           // 16-deep k steps a box
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;  // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int S_ACC = BKV / 2;          // fp32 accumulators a thread
  static constexpr int O_ACC = DP / 2;
  static_assert(DP == 16 || DP == 32 || DP == 64 || DP == 128, "DP");
  static_assert(BKV == 64 || BKV == 128, "BKV");
  // the Q tile, the ring, the barriers and slack to align it to 1024 bytes
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)STAGES * STAGE + 8 * (2 * STAGES + 1);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

// A 4-D TMA map as the plan gives it: dims and box innermost first, byte
// strides of dims 1..3, the swizzle span in bytes, the element size;
// dims[0] == 0: no map.
struct MapDesc {
  long long dims[4], strides[3], box[4], swizzle, elem;
};

// cuda_attention.py::AttentionPlan.c_plan, field for field (int64 each)
struct Plan {
  long long dp, bkv, wgs;   // the instance
  long long q_tiles, grid;  // BQ-query tiles of a (row, head); blocks
  long long own_tiles, garm_tiles;  // K/V tiles over the own, garment keys
  long long uncond;         // leading rows with the analytic garment sink
  long long heads0[5];      // head coordinates of Q, K, V, garment K, V
  MapDesc maps[5];          // q, k, v, garment k, garment v
};
static_assert(sizeof(Plan) == 78 * sizeof(long long), "Plan");

struct Args {
  int Nq, N, M;        // query rows, own keys, garment keys (0: none)
  int B, H, D;
  int uncond;          // leading rows with the analytic garment sink
  int q_tiles;         // BQ-query tiles of Nq
  int own_tiles, garm_tiles;
  int qh, kh, vh;      // head coordinates of Q, K, V in their maps
  int kgh, vgh;        // and of the garment K, V
  float sc;            // scale * log2(e)
  float sink;          // sink_tokens
  int fixed_shift;
  long long o_batch, o_row;  // output strides in elements (head stride D)
};

// The kernel's arguments: the shape, then the plan's tile counts and head
// coordinates. The output is a contiguous (B, Nq, H, D).
inline Args make_args(const Plan& p, int Nq, int N, int M, int B, int H,
                      int D, float scale) {
  Args a{};
  a.Nq = Nq, a.N = N, a.M = M, a.B = B, a.H = H, a.D = D;
  a.uncond = (int)p.uncond;
  a.q_tiles = (int)p.q_tiles;
  a.own_tiles = (int)p.own_tiles, a.garm_tiles = (int)p.garm_tiles;
  a.qh = (int)p.heads0[0], a.kh = (int)p.heads0[1], a.vh = (int)p.heads0[2];
  a.kgh = (int)p.heads0[3], a.vgh = (int)p.heads0[4];
  a.sc = scale * LOG2E;
  a.o_row = (long long)H * D, a.o_batch = (long long)Nq * H * D;
  return a;
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

__device__ __forceinline__ float neg_inf() {  // a masked logit
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S (64 x BKV) = Q K^T over DP / 16 k steps: Q (this warpgroup's 64 rows)
// and K (BKV keys) K-major in shared memory, a 64-column box each k steps
// 0..3 and 4..7 at DP = 128
template <int DP, int BKV, int WGS>
__device__ __forceinline__ void issue_qk(float* s, const uint8_t* qw,
                                         const uint8_t* ks) {
  using C = Cfg<DP, BKV, WGS>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int x = kk / C::KPB, off = 32 * (kk % C::KPB);
    idm::wgmma_bf16_kb<BKV>(
        s,
        idm::smem_desc(qw + x * C::BQ * C::SW + off, 16, 8 * C::SW, C::SW),
        idm::smem_desc(ks + x * BKV * C::SW + off, 16, 8 * C::SW, C::SW),
        kk > 0);
  }
}

// O (64 x DP) += P V over BKV / 16 k steps: P in registers, V (BKV keys x
// DP) MN-major, its 64-column boxes BKV * 128 bytes apart at DP = 128
template <int DP, int BKV, int WGS>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p,
                                         const uint8_t* vs) {
  using C = Cfg<DP, BKV, WGS>;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    idm::wgmma_bf16_rs<DP>(
        o, p + 4 * kk,
        idm::smem_desc(vs + kk * 16 * C::SW, BKV * C::SW, 8 * C::SW, C::SW));
}

// The softmax of one S tile, in place: keys at or past `limit` masked, then
// the exponentials of the logits in log2 units, s * sc (fixed shift:
// 2^min(s * sc, 60 log2 e); online max: 2^(s * sc - m), one FFMA a logit,
// after the quad's row max of the raw s). Updates the running max m and
// this thread's share of the row sum l of its rows 0 / 1 (lane / 4 and
// lane / 4 + 8 of its warp's 16) and returns the factors al by which O must
// be rescaled (not read under the fixed shift).
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], int key0,
                                             int limit, int q, float sc,
                                             int fixed_shift, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  if (!(sc > 0.f)) {  // the row max below is of s * sc only for sc > 0
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= sc;
    sc = 1.f;
  }
  if (key0 + 2 * N > limit) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (key0 + 8 * (i / 4) + 2 * q + (i & 1) >= limit) s[i] = neg_inf();
  }
  if (fixed_shift) {
    const float clamp2 = CLAMP * LOG2E;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = ex2(fminf(s[i] * sc, clamp2));
      if (i & 2) l1 += s[i];
      else l0 += s[i];
    }
    return;
  }
  float x0 = NEG, x1 = NEG;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2) x1 = fmaxf(x1, s[i]);
    else x0 = fmaxf(x0, s[i]);
  }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, sh));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, sh));
  }
  const float n0 = fmaxf(m0, x0 * sc), n1 = fmaxf(m1, x1 * sc);
  al0 = ex2(m0 - n0);
  al1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2) {
      s[i] = ex2(fmaf(s[i], sc, -n1));
      ps1 += s[i];
    } else {
      s[i] = ex2(fmaf(s[i], sc, -n0));
      ps0 += s[i];
    }
  }
  l0 = al0 * l0 + ps0;
  l1 = al1 * l1 + ps1;
}

template <int DP, int BKV, int WGS>
__device__ __forceinline__ void attn_body(const CUtensorMap* qmap,
                                          const CUtensorMap* kmap,
                                          const CUtensorMap* vmap,
                                          const CUtensorMap* kgmap,
                                          const CUtensorMap* vgmap,
                                          bf16* __restrict__ out,
                                          const Args& a) {
  using C = Cfg<DP, BKV, WGS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ring = smem + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // the tile: BQ queries of head h of batch row b; the rows that see the
  // garment (b >= uncond) first, as they have the most tiles
  const int qt = blockIdx.x % a.q_tiles;
  const int h = (blockIdx.x / a.q_tiles) % a.H;
  const int b = (blockIdx.x / a.q_tiles / a.H + a.uncond) % a.B;
  const int q0 = qt * C::BQ;
  const bool garm = a.garm_tiles > 0 && b >= a.uncond;
  const int own_tiles = a.own_tiles;
  const int tiles = own_tiles + (garm ? a.garm_tiles : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      idm::mbar_init(&full[s], 1);
      idm::mbar_init(&empty[s], 4 * WGS);  // one arrival a consumer warp
    }
    idm::mbar_init(qbar, 1);
    idm::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----------------------------------------------------------
    idm::reg_dealloc<Regs<WGS>::PRODUCER>();
    if (threadIdx.x == 0) {
      idm::mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < C::NBOX; ++x)
        idm::tma_load_4d(qs + x * C::BQ * C::SW, qmap, qbar, x * C::BOX,
                         a.qh + h, q0, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) idm::mbar_wait(&empty[s], ((t / STAGES) + 1) & 1);
        uint8_t* ks = ring + s * C::STAGE;
        uint8_t* vs = ks + C::KV_BYTES;
        idm::mbar_expect_tx(&full[s], C::STAGE);
        const bool own = t < own_tiles;
        const int row = (own ? t : t - own_tiles) * BKV;
        const int bb = own ? b : b - a.uncond;
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x) {
          idm::tma_load_4d(ks + x * BKV * C::SW, own ? kmap : kgmap, &full[s],
                           x * C::BOX, (own ? a.kh : a.kgh) + h, row, bb);
          idm::tma_load_4d(vs + x * BKV * C::SW, own ? vmap : vgmap, &full[s],
                           x * C::BOX, (own ? a.vh : a.vgh) + h, row, bb);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    idm::reg_alloc<Regs<WGS>::CONSUMER>();
    const int ct = threadIdx.x - 128;
    const int w = ct / 128;  // query rows [64 w, 64 w + 64) of the tile
    const int warp = (ct / 32) % 4, lane = ct % 32, q = lane % 4;
    const float sink = a.sink + (a.M > 0 && b < a.uncond ? (float)a.M : 0.f);
    // rows 0 / 1: this thread's rows lane / 4 and lane / 4 + 8 of its warp's
    // 16; running max (log2 units) and this thread's share of the row sum
    // (the sink counted once, on the quad's first lane)
    float m0 = sink > 0.f ? 0.f : NEG, m1 = m0;
    float l0 = q == 0 ? sink : 0.f, l1 = l0;
    float o[C::O_ACC], s[C::S_ACC];
    uint32_t p[BKV / 4];
#pragma unroll
    for (int i = 0; i < C::O_ACC; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::S_ACC; ++i) s[i] = 0.f;
    const uint8_t* qw = qs + w * 64 * C::SW;
    float al0 = 1.f, al1 = 1.f;
    // the turns go round the consumers from warpgroup 0: warpgroup w waits
    // at barrier 1 + w, then passes the turn on
    const int turn = 1 + w, pass = 1 + (w + 1) % WGS;
    if (PINGPONG && w == WGS - 1) named_arrive(1);
    idm::mbar_wait(qbar, 0);

    // Tile t's S product and tile t - 1's PV product are issued together;
    // tile t's softmax runs while the PV product is in flight, then O is
    // rescaled and P packed once the PV product has read the old P.
    idm::mbar_wait(&full[0], 0);
    if (PINGPONG) named_sync(turn);
    idm::wgmma_fence();
    issue_qk<DP, BKV, WGS>(s, qw, ring);
    idm::wgmma_commit();
    if (PINGPONG) named_arrive(pass);
    idm::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < C::S_ACC; ++i) idm::fence_operand(s[i]);
    softmax_tile(s, 0, a.N, q, a.sc, a.fixed_shift, m0, m1, l0, l1, al0, al1);
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i)
      p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);

    for (int t = 1; t < tiles; ++t) {
      const int st = t % STAGES, sp = (t - 1) % STAGES;
      idm::mbar_wait(&full[st], (t / STAGES) & 1);
      if (PINGPONG) named_sync(turn);
      idm::wgmma_fence();
      issue_qk<DP, BKV, WGS>(s, qw, ring + st * C::STAGE);
      idm::wgmma_commit();
      issue_pv<DP, BKV, WGS>(o, p, ring + sp * C::STAGE + C::KV_BYTES);
      idm::wgmma_commit();
      if (PINGPONG) named_arrive(pass);
      idm::wgmma_wait<1>();  // S is in; the PV product may still run
#pragma unroll
      for (int i = 0; i < C::S_ACC; ++i) idm::fence_operand(s[i]);
      const bool own = t < own_tiles;
      softmax_tile(s, (own ? t : t - own_tiles) * BKV, own ? a.N : a.M, q,
                   a.sc, a.fixed_shift, m0, m1, l0, l1, al0, al1);
      idm::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < C::O_ACC; ++i) idm::fence_operand(o[i]);
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) fence_u32(p[i]);
      if (lane == 0) idm::mbar_arrive(&empty[sp]);
      if (!a.fixed_shift) {
#pragma unroll
        for (int i = 0; i < C::O_ACC; ++i) o[i] *= (i & 2) ? al1 : al0;
      }
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i)
        p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
    }

    // the last tile's PV product
    const int sl = (tiles - 1) % STAGES;
    if (PINGPONG) named_sync(turn);
    idm::wgmma_fence();
    issue_pv<DP, BKV, WGS>(o, p, ring + sl * C::STAGE + C::KV_BYTES);
    idm::wgmma_commit();
    if (PINGPONG) named_arrive(pass);
    idm::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < C::O_ACC; ++i) idm::fence_operand(o[i]);
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) fence_u32(p[i]);
    if (lane == 0) idm::mbar_arrive(&empty[sl]);
    // the turn the last warpgroup passed after its last product
    if (PINGPONG && w == 0) named_sync(1);

#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int r0 = q0 + 64 * w + 16 * warp + lane / 4;
    bf16* o0 = out + b * a.o_batch + (long long)r0 * a.o_row +
               (long long)h * a.D + 2 * q;
    bf16* o1 = o0 + 8 * a.o_row;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= a.D) break;
      if (r0 < a.Nq)
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
            pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r0 + 8 < a.Nq)
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
            pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// q_map and kv_map are two boxings of the same to_qkv map (BQ and BKV rows)
template <int DP, int BKV, int WGS>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
    flash_gemm_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap kv_map,
                      const __grid_constant__ CUtensorMap garm_map,
                      bf16* __restrict__ out, const Args a) {
  attn_body<DP, BKV, WGS>(&q_map, &kv_map, &kv_map, &garm_map, &garm_map,
                           out, a);
}

template <int DP, int BKV, int WGS>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
    flash_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap kgmap,
                 const __grid_constant__ CUtensorMap vgmap,
                 bf16* __restrict__ out, const Args a) {
  attn_body<DP, BKV, WGS>(&qmap, &kmap, &vmap, &kgmap, &vgmap, out, a);
}

// Launches the plan's instance (dp, bkv, wgs) through the source's own
// functor: `launch_one.operator()<DP, BKV, WGS>(smem)` launches that
// instance. The built instances are cuda_attention.py's INSTANCES: the
// plan's BKV at each DP with the 2 or 3 warpgroups it weighs; the sweep
// (-DIDM_ATTN_SWEEP) adds the BKV 64 tiles it compares at the path's head
// dims.
template <typename L>
cudaError_t dispatch(const Plan& p, L&& launch_one) {
#define IDM_ATTN_TILE(P, K, W)                           \
  if (p.dp == P && p.bkv == K && p.wgs == W)             \
    return launch_one.template operator()<P, K, W>(Cfg<P, K, W>::SMEM);
  IDM_ATTN_TILE(16, 128, 2)
  IDM_ATTN_TILE(16, 128, 3)
  IDM_ATTN_TILE(32, 128, 2)
  IDM_ATTN_TILE(32, 128, 3)
  IDM_ATTN_TILE(64, 128, 2)
  IDM_ATTN_TILE(64, 128, 3)
  IDM_ATTN_TILE(128, 64, 2)
#ifdef IDM_ATTN_SWEEP
  IDM_ATTN_TILE(16, 64, 2)
  IDM_ATTN_TILE(64, 64, 2)
  IDM_ATTN_TILE(64, 64, 3)
#endif
#undef IDM_ATTN_TILE
  return cudaErrorInvalidValue;
}

}  // namespace idm_attn
