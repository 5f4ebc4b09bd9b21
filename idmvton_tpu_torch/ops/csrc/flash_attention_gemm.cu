// Flash attention over the fused-QKV GEMM output, with garment KV and the
// analytic CFG sink.
//
// Replaces idmvton_tpu/ops/pallas_attention.py::flash_attention_gemm
// (_flash_gemm_core / _flash_kernel_gemm).
//
// Semantics: qkv (B, N, 3*H*D) is the to_qkv output of the own tokens;
// kv_ref (B - uncond_rows, M, 2*H*D) the garment K|V. Row b attends over
// its N own tokens, then (b >= uncond_rows) its M garment tokens. The
// leading uncond_rows rows see M all-zero garment keys/values: zero logits
// add exactly M * exp(0 - m) to the softmax denominator and nothing to the
// numerator, so those rows start from (m = 0, l = M) and never read garment
// memory. sink_tokens adds that many zero tokens to every row. Fixed-shift
// softmax (default) takes p = exp(min(s, 60)) with no running max -- exact
// for logits <= 60 and the denominator cannot overflow fp32; online-max is
// the classical rescaled softmax. Output is merged heads (B, N, H*D).
//
// What bounds it on the H100: tensor-core work (4 * D FLOP a logit) and, as
// much, the softmax's exponentials: N x (N + M) logits a head, 3072 x 6144 x
// 10 heads x 4 rows at the 640-channel level.
// Design (flash_attention.cuh, flash_gemm_kernel): TMA boxes read Q, K and V
// in place from the to_qkv output and the garment K|V from kv_ref (ragged
// key tiles zero-filled), a producer warp keeps an mbarrier ring of K/V
// tiles full, two or three consumer warpgroups of 64 queries each run
// S = QK^T and O += PV as wgmma with the softmax between them in registers
// (ex2.approx on logits pre-scaled by log2 e), taking turns at the matrix
// unit. The
// instance (padded D, BKV, consumer warpgroups), the grid and the tensor
// maps come from the wrapper's plan (cuda_attention.py::attention_plan).

#include "flash_attention.cuh"

using namespace idm_attn;

namespace {

struct Launch {
  const CUtensorMap* q_map;
  const CUtensorMap* kv_map;
  const CUtensorMap* garm_map;
  bf16* out;
  const Args* a;
  int grid;
  cudaStream_t st;
  template <int DP, int BKV, int WGS>
  cudaError_t operator()(size_t smem) const {
    auto kernel = flash_gemm_kernel<DP, BKV, WGS>;
    // once an instance: the most a block of it may take
    static const cudaError_t e = idm::allow_smem(kernel, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    kernel<<<grid, 128 * (WGS + 1), smem, st>>>(*q_map, *kv_map, *garm_map,
                                                out, *a);
    return cudaGetLastError();
  }
};

}  // namespace

// qkv (B, N, 3*H*D), kv_ref (B - uncond_rows, M, 2*H*D) or NULL, out (B,
// N, H*D), all bf16; then the plan (flash_attention.cuh's Plan): its maps
// q (the to_qkv output boxed by BQ rows), k = v (boxed by BKV) and the
// garment k = v over kv_ref (absent when no row reads it).
extern "C" int idm_flash_attention_gemm(const void* qkv, const void* kv_ref,
                                        void* out, int B, int N, int M, int H,
                                        int D, int sink_tokens, float scale,
                                        int fixed_shift, const void* plan,
                                        void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  Args a = make_args(p, N, N, M, B, H, D, scale);
  a.sink = (float)sink_tokens;
  a.fixed_shift = fixed_shift;
  CUtensorMap q_map, kv_map, garm_map;
  cudaError_t e = encode_map(&q_map, qkv, p, 0);
  if (e == cudaSuccess) e = encode_map(&kv_map, qkv, p, 1);
  if (e == cudaSuccess) {
    if (p.garm_tiles > 0)
      e = encode_map(&garm_map, kv_ref, p, 3);
    else
      garm_map = kv_map;  // never read
  }
  if (e != cudaSuccess) return (int)e;
  Launch launch{&q_map, &kv_map, &garm_map, static_cast<bf16*>(out), &a,
                (int)p.grid, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(p, launch);
}
