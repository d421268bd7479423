// Causal GQA flash attention for fresh prefill (positions 0..T-1), Hopper.
//
// Replaces: qwen_inference_engine_tpu/ops/flash_attention.py::flash_attention
// (_flash_bhtd, kernel body _flash_kernel).
//
// q [B, T, Hq, D], k / v [B, T, Hk, D] bf16 (token-major, as the
// projections produce them; no transpose, no copy), out [B, T, Hq, D] bf16.
// Query head h reads KV head h / G.  f32 online softmax; scores never leave
// registers.
//
// What bounds it on the H100: 2 * B * Hq * T^2 * D flops for the causal half
// (7.5 GFLOP per layer at B=4, T=512, Qwen2.5-7B) against
// 4 * B * T * (Hq + Hk) * D bytes (34 MB): T * Hq / (2 * (Hq + Hk)) = 224
// operations per byte, just under the bf16 ridge (~295), so at peak rates
// bytes bound it by a small margin (10 us against 7.6 us of tensor-core
// time).
//
// Design: the contiguous chunk kernel (chunk_attention.cu) at start 0, with
// the fresh token-major K/V in place of the cache: attend_gqa_block of
// attention_mma.cuh.  A block packs 64 rows r = t * G + g of one KV head,
// so each K/V tile (64 keys, key stride Hk * D) is staged once, by cp.async
// into a ring of two, for all G query heads; both products run on the
// tensor cores (mma.sync bf16 -> f32) and row r sees keys [0, r / G].
// Grid: Hk x B x ceil(T * G / 64), later tokens first; any T >= 1.

#include "attention_mma.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(32 * qie::kGqaWarps, 2)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int T, int Hq, int Hk,
             float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<
      qie::MmaSmem<D, qie::kGqaWarps, __nv_bfloat16>*>(smem_raw);
  const long long kv0 =
      (static_cast<long long>(blockIdx.y) * T * Hk + blockIdx.x) * D;
  qie::attend_gqa_block<D, __nv_bfloat16>(
      sm, q, out, k + kv0, v + kv0,
      qie::ContiguousKeys{static_cast<long long>(Hk) * D}, nullptr, nullptr,
      T, Hq, Hk, T, 0, scale);
}

}  // namespace

extern "C" int qie_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int T,
                                   int Hq, int Hk, int D, float scale,
                                   void* stream) {
  // cp.async copies 16-byte chunks of q, k and v
  const bool aligned = (reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  if (B <= 0 || T <= 0 || Hk <= 0 || Hq % Hk || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    return qie::launch_gqa<128, __nv_bfloat16>(flash_kernel<128>, B, T, Hq,
                                               Hk, st, qp, kp, vp, op, T, Hq,
                                               Hk, scale);
  }
  if (D == 64) {
    return qie::launch_gqa<64, __nv_bfloat16>(flash_kernel<64>, B, T, Hq, Hk,
                                              st, qp, kp, vp, op, T, Hq, Hk,
                                              scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
