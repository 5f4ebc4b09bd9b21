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
// past Skv masked; a running row max m and sum l in fp32, rescaled by alpha
// = exp(m_prev - m_new) at every KV tile; p = exp(s - m_new) summed in fp32
// and cast to bf16 for the PV product, which accumulates in fp32; out = acc
// / max(l, 1e-30) in bf16. The exact online max, no fixed shift.
//
// What bounds it on the H100: at the narrow head dims that reach it (D = 16
// in the tiny UNet's 64-wide level) the exp count B*H*Sq*Skv, not the MMA:
// 4 * D FLOP per logit against one exp on the SFU. At D = 64 the MMA.
// Design (flash_attention.cuh, flash_kernel): the kernel of
// flash_attention_gemm.cu with 4-D tensor maps of dims (D, H, S, B) and the
// views' strides (q, k, v and, for flash_attention_concat_kv, the garment
// k, v as a second key segment, so [own | garment] needs no concatenated
// copy); head columns past D are zero-filled by TMA up to the padded width
// DP in {16, 32, 64, 128}. The wrapper's plan
// (cuda_attention.py::attention_plan) gives the instance (DP, BKV, consumer
// warpgroups), the grid and the maps, strides and boxes included.

#include "flash_attention.cuh"

using namespace idm_attn;

namespace {

struct Launch {
  const CUtensorMap* q_map;
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  const CUtensorMap* kg_map;
  const CUtensorMap* vg_map;
  bf16* out;
  const Args* a;
  int grid;
  cudaStream_t st;
  template <int DP, int BKV, int WGS>
  cudaError_t operator()(size_t smem) const {
    auto kernel = flash_kernel<DP, BKV, WGS>;
    // once an instance: the most a block of it may take
    static const cudaError_t e = idm::allow_smem(kernel, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    kernel<<<grid, 128 * (WGS + 1), smem, st>>>(*q_map, *k_map, *v_map, *kg_map,
                                        *vg_map, out, *a);
    return cudaGetLastError();
  }
};

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, H, D) and, for
// flash_attention_concat_kv, the garment kg / vg (B, M, H, D) that follow
// k / v's keys (NULL with M = 0): bf16 views read through the plan's maps
// (flash_attention.cuh's Plan: their strides, D % 8 == 0 and every stride a
// multiple of 8 elements, the pointers 16-byte aligned, as the wrapper
// checks). out is a contiguous (B, Sq, H, D).
extern "C" int idm_flash_attention(const void* q, const void* k,
                                   const void* v, const void* kg,
                                   const void* vg, void* out, int B, int Sq,
                                   int Skv, int M, int H, int D, float scale,
                                   const void* plan, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  const Plan& p = *static_cast<const Plan*>(plan);
  Args a = make_args(p, Sq, Skv, M, B, H, D, scale);
  CUtensorMap q_map, k_map, v_map, kg_map, vg_map;
  cudaError_t e = encode_map(&q_map, q, p, 0);
  if (e == cudaSuccess) e = encode_map(&k_map, k, p, 1);
  if (e == cudaSuccess) e = encode_map(&v_map, v, p, 2);
  if (e == cudaSuccess && p.garm_tiles > 0) e = encode_map(&kg_map, kg, p, 3);
  if (e == cudaSuccess && p.garm_tiles > 0) e = encode_map(&vg_map, vg, p, 4);
  if (e != cudaSuccess) return (int)e;
  if (p.garm_tiles == 0) kg_map = k_map, vg_map = v_map;  // never read
  Launch launch{&q_map, &k_map, &v_map, &kg_map, &vg_map,
                static_cast<bf16*>(out), &a, (int)p.grid,
                static_cast<cudaStream_t>(stream)};
  return (int)dispatch(p, launch);
}
