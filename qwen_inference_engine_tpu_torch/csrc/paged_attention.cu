// T=1 GQA decode attention over the stacked page pool, Hopper.
//
// Replaces qwen_inference_engine_tpu/ops/paged_attention.py::_paged_bhgd
// (body _paged_kernel) for plain decode (n_t == 1), behind
// paged_decode_attention_stacked / paged_decode_attention.
//
// q [B, 1, Hq, D] bf16; pools k_pages / v_pages [L, P, Hk, page, D] bf16
// (head-major within a page); tables [B, max_pages] int32 page ids; lens
// [B] int32 valid keys per row (position + 1), read on the device so the
// host never waits for them; out [B, Hq, D] bf16.  Key j of row b is row
// j % page of page tables[b, j / page].
//
// What bounds it on the H100: each row reads 2 * len * Hk * D bf16 of K/V
// for 4 * len * Hq * D flops, G = 7 operations per byte for Qwen2.5-7B, far
// below the ridge (~295): bytes bound it, as in the contiguous decode.
//
// Design: the contiguous decode kernel's block (decode_attention.cu) with
// paged key addressing.  A block of D threads takes one (row, KV head)
// (grid: Hk x B) and all G <= 8 query heads as its rows, so each K/V byte
// is read once per step.  The TPU kernel DMAs whole pages through the
// table in its BlockSpec index map; here the staging loop of
// attention_common.cuh resolves each key's page from the table in device
// memory (qie::PagedKeys), so a 64-key tile may span pages of any size
// that is a multiple of 8.  Keys at or past the row's length are never
// loaded (stale or freed pages, even NaN, cannot leak in); a length of 0
// (an idle row) gives zeros.  The page pool is read straight from the
// stacked [L, ...] tensor at the layer index, no slab copy.  Only Hk * B
// blocks run (32 at 8 slots for Qwen2.5-7B): splitting the keys across
// blocks (flash-decoding) is later work.

#include "attention_common.cuh"

namespace {

constexpr int kRows = 8;    // query heads per KV head (G <= 8)
constexpr int kKeys = 64;   // keys per tile

template <int D>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out, int P, int Hq, int Hk,
                    int page, int max_pages, int layer, float scale) {
  __shared__ qie::AttnSmem<D, kRows, kKeys, __nv_bfloat16> sm;
  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hk;
  const int len = max(0, min(lens[b], max_pages * page));

  for (int c = tid; c < kRows * D; c += D) {
    const int i = c / D, d = c % D;
    float val = 0.f;
    if (i < G) {
      val = __bfloat162float(
          q[(static_cast<long long>(b) * Hq + hk * G + i) * D + d]) * scale;
    }
    sm.q[i][d] = val;
  }
  // page 0 of (layer, hk); the table picks the page
  const long long base =
      (static_cast<long long>(layer) * P * Hk + hk) * page * D;
  const qie::PagedKeys keys{tables + static_cast<long long>(b) * max_pages,
                            page, D, static_cast<long long>(Hk) * page * D};
  float acc[kRows];
  qie::attend<D, kRows, kKeys, __nv_bfloat16>(
      sm, acc, G, k_pages + base, v_pages + base, keys, nullptr, nullptr, len,
      len - 1, 0, nullptr, nullptr, -1);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < G) {
      const float denom = fmaxf(sm.l[i], 1e-30f);
      out[(static_cast<long long>(b) * Hq + hk * G + i) * D + tid] =
          __float2bfloat16(acc[i] / denom);
    }
  }
}

}  // namespace

extern "C" int qie_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages,
                                          const void* tables,
                                          const void* lens, void* out, int L,
                                          int P, int B, int Hq, int Hk,
                                          int page, int max_pages, int D,
                                          int layer, float scale,
                                          void* stream) {
  if (B <= 0 || Hk <= 0 || Hq % Hk || Hq / Hk > kRows || page <= 0 ||
      page % 8 || max_pages <= 0 || P <= 0 || layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(Hk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    paged_decode_kernel<128><<<grid, 128, 0, st>>>(
        qp, kp, vp, tp, lp, op, P, Hq, Hk, page, max_pages, layer, scale);
  } else if (D == 64) {
    paged_decode_kernel<64><<<grid, 64, 0, st>>>(
        qp, kp, vp, tp, lp, op, P, Hq, Hk, page, max_pages, layer, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
