// Causal GQA flash attention for fresh prefill (positions 0..T-1), Hopper.
//
// Replaces: qwen_inference_engine_tpu/ops/flash_attention.py::flash_attention
// (_flash_bhtd, kernel body _flash_kernel).
//
// q [B, T, Hq, D], k / v [B, T, Hk, D] bf16 (token-major, as the
// projections produce them; no transpose), out [B, T, Hq, D] bf16.  Query
// head h reads KV head h / G.  f32 online softmax; scores never leave
// shared memory.
//
// What bounds it on the H100: 2 * B * Hq * T^2 * D flops for the causal half
// (7.5 GFLOP per layer at B=4, T=512, Qwen2.5-7B) against
// 4 * B * T * (Hq + Hk) * D bytes (34 MB): T * Hq / (2 * (Hq + Hk)) = 224
// operations per byte, just under the bf16 ridge (~295), so at peak rates
// bytes bound it by a small margin (10 us against 7.6 us of tensor-core
// time); on the CUDA cores used here, operations bound it.
//
// Design: simple and right first.  A block of D threads takes 16 query rows
// of one head (grid: T/16 x Hq x B; blocks run in any order and share
// nothing) and walks the key tiles of 64 up to its last row, so tiles above
// the causal diagonal are never read; the ragged edge (T not a multiple of
// the tiles) is masked in the kernel, so any T >= 1 is taken.  The products
// are fp32 FMAs on the CUDA cores (attention_common.cuh); moving them onto
// the tensor cores (mma / wgmma on bf16) is later work.

#include "attention_common.cuh"

namespace {

constexpr int kRows = 16;   // query rows per block
constexpr int kKeys = 64;   // keys per tile

template <int D>
__global__ void __launch_bounds__(D)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int T, int Hq, int Hk,
             float scale) {
  __shared__ qie::AttnSmem<D, kRows, kKeys, __nv_bfloat16> sm;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int n_rows = min(kRows, T - q0);

  for (int c = tid; c < kRows * D; c += D) {
    const int i = c / D, d = c % D;
    float val = 0.f;
    if (i < n_rows) {
      val = __bfloat162float(
          q[((static_cast<long long>(b) * T + q0 + i) * Hq + h) * D + d]) * scale;
    }
    sm.q[i][d] = val;
  }
  const long long kv0 = static_cast<long long>(b) * T * Hk * D +
                        static_cast<long long>(hk) * D;
  float acc[kRows];
  qie::attend<D, kRows, kKeys, __nv_bfloat16>(
      sm, acc, n_rows, k + kv0, v + kv0,
      qie::ContiguousKeys{static_cast<long long>(Hk) * D},
      nullptr, nullptr, min(T, q0 + kRows), q0, 1, nullptr, nullptr, -1);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < n_rows) {
      const float denom = fmaxf(sm.l[i], 1e-30f);
      out[((static_cast<long long>(b) * T + q0 + i) * Hq + h) * D + tid] =
          __float2bfloat16(acc[i] / denom);
    }
  }
}

}  // namespace

extern "C" int qie_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int T,
                                   int Hq, int Hk, int D, float scale,
                                   void* stream) {
  if (B <= 0 || T <= 0 || Hk <= 0 || Hq % Hk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((T + kRows - 1) / kRows, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    flash_kernel<128><<<grid, 128, 0, st>>>(qp, kp, vp, op, T, Hq, Hk, scale);
  } else if (D == 64) {
    flash_kernel<64><<<grid, 64, 0, st>>>(qp, kp, vp, op, T, Hq, Hk, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
