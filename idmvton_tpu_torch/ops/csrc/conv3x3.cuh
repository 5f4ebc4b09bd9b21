// 3x3 stride-1 SAME convolution + bias as an implicit GEMM for Hopper: TMA
// tiles, an mbarrier ring and wgmma. One templated kernel serves both
// sources, which differ only in how a tap's A tile is addressed:
//
//   kHalo (conv3x3.cu, #5 and #6): the output tile is Ht x Wt = BM pixels
//     of one image; the A tile of tap (dy, dx) and channel chunk c0 is one
//     4-D TMA box (64 ch, Wt, Ht, 1) of the NHWC input at (c0, x0 + dx - 1,
//     y0 + dy - 1, b). TMA zero-fills what lies outside the image, negative
//     coordinates included, so the halo needs no predicate and no padded
//     copy.
//   kPadded (conv3x3_padacc.cu, #7): the output is indexed on the (W+2)-pitch
//     padded grid, p = y * (W+2) + j; the tap's A tile is one 2-D box of BM
//     consecutive rows of xp flattened to (B*(H+2)*(W+2), Cin), starting at
//     row b*(H+2)*(W+2) + p0 + dy*(W+2) + dx. The tap's shift is moved to the
//     input, so all nine taps accumulate into the same registers; positions
//     with j >= W or past the image are dropped at the store.
//
// GEMM: M = BM (128 or 256) output positions a tile, N = BN (128, 160 or
// 256) output channels, K = 9 taps x Cin in 64-channel chunks (the A box
// row is 128 bytes: exactly wgmma's K-major layout under 128-byte swizzle).
// B is read in place from the HWIO weights as a 3-D tensor (Cout, Cin, 9),
// in boxes of (ATOM cout, 64 cin, 1 tap): Cout is contiguous, so wgmma reads
// B MN-major (trans-b). Channels past Cin are zero-filled on both sides, so
// a ragged last chunk reads no row of the next tap.
//
// fp32 input (F32, #5 and #6 only): x is fp32 and the output fp32, the
// weights stay bf16 -- the TPU kernel at Precision.DEFAULT: bf16 operands,
// fp32 accumulation and bias, no bf16 rounding of the output. TMA copies
// bytes and cannot narrow, and a 64-channel fp32 row is 256 bytes, past the
// 128-byte swizzle span, so the A box lands unswizzled in a raw region of
// the stage; each consumer warpgroup narrows its own rows to bf16 into the
// stage's swizzled A tile (the layout TMA gives the bf16 path), fences the
// async proxy and syncs its warpgroup, then runs the bf16 path's wgmma as
// it is. B is read as in the bf16 path. Only BM = 128 tiles fit two stages.
//
// Block: warpgroup 0 is the producer (one thread issues the TMA loads into a
// STAGES-deep ring, a full/empty mbarrier pair a stage); warpgroups 1 and 2
// consume BM/2 rows each, as BM/128 blocks of 64 rows with one m64nBNk16
// wgmma a block for each 16 channels of a chunk, the fp32 accumulators in
// registers, one chunk's wgmma group in flight. Blocks are
// persistent (grid = min(tiles, SMs)) and walk the tiles with stride
// gridDim.x, N tiles fastest, so the producer loads the next tile while the
// consumers store the last. Epilogue: fp32 bias added in registers, one bf16
// rounding, a quad transpose by shuffles and 16-byte stores, clipped per row.
#pragma once

#include "common.cuh"

namespace idm_conv {

using idm::bf16;

enum Mode { kHalo = 0, kPadded = 1 };

constexpr int BK = 64, THREADS = 384;

__device__ __forceinline__ uint32_t sel4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int BM, int BN, bool F32 = false>
struct Cfg {
  static constexpr int WM = BM / 128;  // 64-row blocks a consumer warpgroup
  // B columns a TMA box (its swizzle span): 64 (128 B), or 32 (64 B) where
  // BN is not a multiple of 64
  static constexpr int ATOM = BN % 64 == 0 ? 64 : 32;
  static constexpr int SWB = 2 * ATOM;  // B swizzle bytes
  static constexpr int ATOM_BYTES = BK * SWB;
  static constexpr int A_BYTES = BM * BK * 2;  // BM rows of 128 bytes
  static constexpr int B_BYTES = BN * BK * 2;
  // F32: the raw fp32 A box (BM rows of 256 bytes) after the bf16 tiles
  static constexpr int A_RAW = F32 ? BM * BK * 4 : 0;
  static constexpr int LOAD = (F32 ? A_RAW : A_BYTES) + B_BYTES;  // TMA bytes
  static constexpr int STAGE = A_BYTES + B_BYTES + A_RAW;
  static constexpr int STAGES = 220 * 1024 / STAGE < 6 ? 220 * 1024 / STAGE : 6;
  static constexpr int ACC = WM * BN / 2;  // fp32 accumulators a thread
  // stages, the barriers, and slack to align the ring to 1024 bytes
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 16 * STAGES + 1024;
  static_assert(BM == 128 || BM == 256, "BM");
  static_assert(BN % 32 == 0 && BN <= 256 && ACC <= 160, "BN");
  // one stage would hang: a chunk's stage is released after the next
  // chunk's product is issued
  static_assert(STAGES >= 2, "the ring takes 2 stages or more");
};

// F32: this consumer warpgroup's rows [BM/2 cw, BM/2 (cw + 1)) of the raw
// fp32 A box narrowed to bf16 into the stage's 128-byte-swizzled A tile
// (row r's 16-byte unit j at unit j ^ (r % 8)), made visible to wgmma
template <int BM, int BN>
__device__ __forceinline__ void narrow_a(uint8_t* stage, int cw, int ct) {
  using C = Cfg<BM, BN, true>;
  const uint8_t* raw = stage + C::A_BYTES + C::B_BYTES;
  for (int i = ct % 128; i < BM / 2 * 16; i += 128) {
    const int r = cw * (BM / 2) + i / 16, sub = i % 16;  // 4 channels
    const float4 f = *reinterpret_cast<const float4*>(raw + r * 256 + sub * 16);
    const uint2 v = make_uint2(pack_bf16x2(f.x, f.y), pack_bf16x2(f.z, f.w));
    *reinterpret_cast<uint2*>(stage + r * 128 + (((sub / 2) ^ (r % 8)) * 16) +
                              (sub % 2) * 8) = v;
  }
  idm::fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

struct Geom {
  int H, W, Cout, kc;  // kc: 64-channel chunks a tap
  int tile_h, tile_w, tiles_x, tiles_y;  // kHalo
  int tiles_per_image;                   // kPadded
  int n_tiles, tiles;
};

// the tile's image, first output position (kHalo: its pixel (y0, x0);
// kPadded: p0 on the padded grid) and first output channel
template <int MODE, int BM, int BN>
__device__ __forceinline__ void tile_origin(const Geom& g, int t, int& b,
                                            int& y0, int& x0, int& n0) {
  n0 = (t % g.n_tiles) * BN;
  int m = t / g.n_tiles;
  if (MODE == kHalo) {
    x0 = (m % g.tiles_x) * g.tile_w;
    m /= g.tiles_x;
    y0 = (m % g.tiles_y) * g.tile_h;
    b = m / g.tiles_y;
  } else {
    b = m / g.tiles_per_image;
    y0 = (m % g.tiles_per_image) * BM;  // p0
    x0 = 0;
  }
}

template <int MODE, int BM, int BN, bool F32>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ bias, void* __restrict__ out,
                   const Geom g) {
  using C = Cfg<BM, BN, F32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int KT = 9 * g.kc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
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
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        int b, y0, x0, n0;
        tile_origin<MODE, BM, BN>(g, t, b, y0, x0, n0);
        const int row0 = MODE == kPadded ? b * (g.H + 2) * (g.W + 2) + y0 : 0;
        for (int k = 0; k < KT; ++k, ++it) {
          const int s = it % C::STAGES;
          if (it >= C::STAGES)
            idm::mbar_wait(&empty[s], ((it / C::STAGES) + 1) & 1);
          uint8_t* a = smem + s * C::STAGE;
          idm::mbar_expect_tx(&full[s], C::LOAD);
          const int tap = k / g.kc, c0 = (k - tap * g.kc) * BK;
          const int dy = tap / 3, dx = tap - 3 * dy;
          uint8_t* a_dst = F32 ? a + C::A_BYTES + C::B_BYTES : a;
          if (MODE == kHalo)
            idm::tma_load_4d(a_dst, &xmap, &full[s], c0, x0 + dx - 1,
                             y0 + dy - 1, b);
          else
            idm::tma_load_2d(a_dst, &xmap, &full[s], c0,
                             row0 + dy * (g.W + 2) + dx);
#pragma unroll
          for (int at = 0; at < BN / C::ATOM; ++at)
            idm::tma_load_3d(a + C::A_BYTES + at * C::ATOM_BYTES, &wmap,
                             &full[s], n0 + at * C::ATOM, c0, tap);
        }
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    idm::reg_alloc<232>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;  // rows [BM/2 * cw, BM/2 * (cw + 1)) of the tile
    const int warp = (ct / 32) % 4, lane = ct % 32, q = lane % 4;
    // acc[wm * BN / 2 + k]: 64-row block wm
    float acc[C::ACC];
    int it = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int b, y0, x0, n0;
      tile_origin<MODE, BM, BN>(g, t, b, y0, x0, n0);
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
      for (int k = 0; k < KT; ++k, ++it) {
        const int s = it % C::STAGES;
        idm::mbar_wait(&full[s], (it / C::STAGES) & 1);
        if constexpr (F32) narrow_a<BM, BN>(smem + s * C::STAGE, cw, ct);
        const uint8_t* a = smem + s * C::STAGE + cw * C::WM * (64 * 128);
        const uint8_t* bs = smem + s * C::STAGE + C::A_BYTES;
        idm::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int wm = 0; wm < C::WM; ++wm)
            idm::wgmma_bf16<BN>(
                acc + wm * (BN / 2),
                idm::smem_desc(a + wm * (64 * 128) + 32 * kk, 16, 1024, 128),
                idm::smem_desc(bs + kk * 16 * C::SWB, C::ATOM_BYTES,
                               8 * C::SWB, C::SWB));
        idm::wgmma_commit();
        idm::wgmma_wait<1>();  // the previous chunk's group is done
        if (k > 0 && lane == 0) idm::mbar_arrive(&empty[(it - 1) % C::STAGES]);
      }
      idm::wgmma_wait<0>();
      if (lane == 0) idm::mbar_arrive(&empty[(it - 1) % C::STAGES]);
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) idm::fence_operand(acc[i]);

#pragma unroll
      for (int wm = 0; wm < C::WM; ++wm) {
        // the two rows this thread holds in block wm: output offsets, or
        // dropped
        size_t off[2];
        bool ok[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = (cw * C::WM + wm) * 64 + warp * 16 + lane / 4 + 8 * i;
          int y, x;
          if (MODE == kHalo) {
            y = y0 + r / g.tile_w;
            x = x0 + r % g.tile_w;
          } else {
            const int p = y0 + r;
            y = p / (g.W + 2);
            x = p - y * (g.W + 2);
          }
          ok[i] = y < g.H && x < g.W;
          off[i] = (((size_t)b * g.H + y) * g.W + x) * g.Cout;
        }
#pragma unroll
        for (int jj = 0; jj < BN / 32; ++jj) {
          // 32 columns: 8-column blocks 4jj..4jj+3, of which this thread
          // holds columns 2q, 2q+1 in each
          const float* d = acc + wm * (BN / 2);
          const int c32 = n0 + 32 * jj;
          float2 bb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = c32 + 8 * u + 2 * q;
            bb[u] = bias != nullptr && col < g.Cout
                        ? *reinterpret_cast<const float2*>(bias + col)
                        : make_float2(0.f, 0.f);
          }
          if constexpr (F32) {  // fp32 out: each thread's column pairs
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int cu = c32 + 8 * u + 2 * q;
                if (ok[i] && cu < g.Cout)
                  *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                             off[i] + cu) =
                      make_float2(d[(4 * jj + u) * 4 + 2 * i] + bb[u].x,
                                  d[(4 * jj + u) * 4 + 2 * i + 1] + bb[u].y);
              }
            continue;
          }
          const int col = c32 + 8 * q;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t v[4], r[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              v[u] = pack_bf16x2(d[(4 * jj + u) * 4 + 2 * i] + bb[u].x,
                                 d[(4 * jj + u) * 4 + 2 * i + 1] + bb[u].y);
            // quad transpose: r[s] is pair q ^ s of block 4jj + q, from
            // lane q ^ s
#pragma unroll
            for (int s = 0; s < 4; ++s)
              r[s] = __shfl_xor_sync(0xffffffffu, sel4(v, q ^ s), s);
            const uint4 o = make_uint4(sel4(r, q), sel4(r, q ^ 1),
                                       sel4(r, q ^ 2), sel4(r, q ^ 3));
            if (ok[i] && col < g.Cout)
              *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + off[i] +
                                        col) = o;
          }
        }
      }
    }
  }
}

template <int MODE, int BM, int BN, bool F32>
cudaError_t launch_tile(const CUtensorMap& xmap, const void* w, int Cin,
                        const void* bias, void* out, Geom g, cudaStream_t st) {
  using C = Cfg<BM, BN, F32>;
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {(cuuint64_t)g.Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)g.Cout * 2,
                                 (cuuint64_t)Cin * g.Cout * 2};
  const cuuint32_t box[3] = {C::ATOM, BK, 1};
  cudaError_t e = idm::encode_tiled(&wmap, w, 3, dims, strides, box, C::SWB);
  if (e != cudaSuccess) return e;
  auto kernel = conv3x3_kernel<MODE, BM, BN, F32>;
  if ((e = idm::allow_smem(kernel, C::SMEM)) != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  kernel<<<g.tiles < sms ? g.tiles : sms, THREADS, C::SMEM, st>>>(
      xmap, wmap, static_cast<const float*>(bias), out, g);
  return cudaGetLastError();
}

// The (BM, BN) tiles the kernel is built for (cuda_conv.py::TILES, and
// F32_TILES for an fp32 input); the wrapper's plan picks one by shape.
template <int MODE, bool F32 = false>
cudaError_t launch(int bm, int bn, const CUtensorMap& xmap, const void* w,
                   int Cin, const void* bias, void* out, Geom g,
                   cudaStream_t st) {
#define IDM_CONV_TILE(M, N) \
  if (bm == M && bn == N)   \
    return launch_tile<MODE, M, N, F32>(xmap, w, Cin, bias, out, g, st);
  IDM_CONV_TILE(128, 128)
  IDM_CONV_TILE(128, 160)
  IDM_CONV_TILE(128, 256)
  if constexpr (!F32) {
    IDM_CONV_TILE(256, 128)
    IDM_CONV_TILE(256, 160)
  }
#undef IDM_CONV_TILE
  return cudaErrorInvalidValue;
}

}  // namespace idm_conv
