// GQA attention of T fresh query tokens per row over the stacked page pool
// (bf16 or int8), Hopper: plain decode (T = 1) and the speculative verify
// (any T >= 2).
//
// Replaces two kernels of qwen_inference_engine_tpu/ops/paged_attention.py:
//   * _paged_bhgd (body _paged_kernel), bf16 pool: decode (n_t == 1) behind
//     paged_decode_attention_stacked, and the multi-query verify (n_t > 1)
//     behind paged_verify_attention_stacked;
//   * _paged_bhgd_q8 (body _paged_kernel_q8), int8 pool with per-token
//     f32 scales: paged_decode_attention_stacked_q8 and
//     paged_verify_attention_stacked_q8.
//
// q [B, T, Hq, D] bf16; pools k_pages / v_pages [L, P, Hk, page, D] bf16 or
// int8 (head-major within a page); scales [L, P, Hk, page] f32 (int8
// only); tables [B, max_pages] int32 page ids; lens [B] int32 valid keys
// per row, the T fresh tokens included (already appended), read on the
// device so the host never waits for them; out [B, T, Hq, D] bf16.  Key j
// of row b is row j % page of page tables[b, j / page].  Token t of row b
// sits at len - T + t and sees keys [0, len - T + t] (the TPU kernel's
// mask k_pos < seq_len - (n_t - 1) + t).  int8 scores are
// (q . k_i8) * k_scale * D^-1/2 and each value is scaled by its V scale
// before the P @ V sum (the TPU kernel folds v_scale into P).
//
// What bounds it on the H100: each row reads 2 * len * Hk * D K/V elements
// (bf16: 2 bytes, int8: 1 byte + 8 bytes of scales a key and head) for
// 4 * len * T * Hq * D flops: at T = 1, G = 7 (Qwen2.5-7B) 7 operations a
// bf16 byte, at T = 5 35; both far below the ridge (~295): bytes bound it.
//
// Design: the contiguous decode kernel's block (decode_attention.cu) with
// paged key addressing (attention_common.cuh, qie::PagedKeys: each key's
// page, and its scale, looked up in the row's table as the tile is staged,
// so a 64-key tile may span pages of any multiple of 8 tokens).  A block
// of D threads takes one (row, KV head) and BR of its T * G query rows,
// flattened token-major (row r is token r / G, head r % G, no padding of G
// to 8): decode has G <= 8 rows, one block (BR = 8) that reads each K/V
// byte once a step; the verify has T * G rows (35 at T = 5 for Qwen2.5-7B)
// in blocks of BR = 16 (grid Hk x B x ceil(T * G / 16)), each block
// reading the keys up to its last token's limit, so a row's K/V tiles are
// read ceil(T * G / 16) times (3 at T = 5), where the TPU kernel scores all
// T * 8 rows of a page in one pass: 16 rows is what a block's 48 KB of
// static shared memory holds (f32 queries, the bf16 K/V tile and the
// scores).  Each row's causal limit is len - T + t, so a block never reads
// a key past its last token.  Keys at or past the row's length are never
// loaded (stale or freed pages, even NaN, cannot leak in); a length of 0
// (an idle row) gives zeros.  int8 K/V are staged as raw bytes with the
// tile's scales and dequantized in registers.  Splitting the keys across
// blocks (flash-decoding) and the tensor cores are later work.

#include "attention_common.cuh"

namespace {

constexpr int kKeys = 64;   // keys per tile

template <int D, int BR, typename KV>
__global__ void __launch_bounds__(D)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens,
                       __nv_bfloat16* __restrict__ out, int P, int T, int Hq,
                       int Hk, int page, int max_pages, int layer,
                       float scale) {
  __shared__ qie::AttnSmem<D, BR, kKeys, KV> sm;
  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hk;
  const int r0 = blockIdx.z * BR;            // first flattened (t, g) row
  const int n_rows = min(BR, T * G - r0);
  const int len = max(0, min(lens[b], max_pages * page));

  for (int c = tid; c < BR * D; c += D) {
    const int i = c / D, d = c % D;
    float val = 0.f;
    if (i < n_rows) {
      const int t = (r0 + i) / G, g = (r0 + i) % G;
      val = __bfloat162float(
          q[((static_cast<long long>(b) * T + t) * Hq + hk * G + g) * D + d]) *
          scale;
    }
    sm.q[i][d] = val;
  }
  // the block's last token sees keys [0, len - T + t_last]
  const int t_last = (r0 + n_rows - 1) / G;
  const int n_keys = max(0, min(len, len - T + t_last + 1));
  // page 0 of (layer, hk); the table picks the page
  const long long sbase = (static_cast<long long>(layer) * P * Hk + hk) * page;
  const long long base = sbase * D;
  const qie::PagedKeys keys{tables + static_cast<long long>(b) * max_pages,
                            page, D, static_cast<long long>(Hk) * page * D,
                            static_cast<long long>(Hk) * page};
  const float* ks = k_scale == nullptr ? nullptr : k_scale + sbase;
  const float* vs = v_scale == nullptr ? nullptr : v_scale + sbase;
  float acc[BR];
  qie::attend<D, BR, kKeys, KV>(sm, acc, n_rows, k_pages + base,
                                v_pages + base, keys, ks, vs, n_keys,
                                len - T, 1, r0, G);
#pragma unroll
  for (int i = 0; i < BR; ++i) {
    if (i < n_rows) {
      const int t = (r0 + i) / G, g = (r0 + i) % G;
      const float denom = fmaxf(sm.l[i], 1e-30f);
      out[((static_cast<long long>(b) * T + t) * Hq + hk * G + g) * D + tid] =
          __float2bfloat16(acc[i] / denom);
    }
  }
}

template <int D, typename KV>
void launch(int BR, dim3 grid, cudaStream_t st, const void* q,
            const void* k_pages, const void* v_pages, const void* k_scale,
            const void* v_scale, const void* tables, const void* lens,
            void* out, int P, int T, int Hq, int Hk, int page, int max_pages,
            int layer, float scale) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k_pages);
  const auto* vp = static_cast<const KV*>(v_pages);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (BR == 8) {
    paged_attention_kernel<D, 8, KV><<<grid, D, 0, st>>>(
        qp, kp, vp, ksp, vsp, tp, lp, op, P, T, Hq, Hk, page, max_pages,
        layer, scale);
  } else {
    paged_attention_kernel<D, 16, KV><<<grid, D, 0, st>>>(
        qp, kp, vp, ksp, vsp, tp, lp, op, P, T, Hq, Hk, page, max_pages,
        layer, scale);
  }
}

}  // namespace

// k_scale / v_scale null: a bf16 pool; both given: an int8 pool.  T = 1 is
// the decode, T >= 2 the verify (any window: its T * G query rows go to
// ceil(T * G / 16) blocks).
extern "C" int qie_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* lens, void* out, int L, int P,
                                   int B, int T, int Hq, int Hk, int page,
                                   int max_pages, int D, int layer,
                                   float scale, void* stream) {
  const bool quant = k_scale != nullptr;
  if (B <= 0 || T < 1 || Hk <= 0 || Hq % Hk || Hq / Hk > 8 ||
      page <= 0 || page % 8 || max_pages <= 0 || P <= 0 || layer < 0 ||
      layer >= L || quant != (v_scale != nullptr) || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int BR = T == 1 ? 8 : 16;
  const long long blocks_z =
      (static_cast<long long>(T) * (Hq / Hk) + BR - 1) / BR;
  if (blocks_z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Hk, B, static_cast<unsigned>(blocks_z));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    if (quant) {
      launch<128, int8_t>(BR, grid, st, q, k_pages, v_pages, k_scale, v_scale,
                          tables, lens, out, P, T, Hq, Hk, page, max_pages,
                          layer, scale);
    } else {
      launch<128, __nv_bfloat16>(BR, grid, st, q, k_pages, v_pages, nullptr,
                                 nullptr, tables, lens, out, P, T, Hq, Hk,
                                 page, max_pages, layer, scale);
    }
  } else if (D == 64) {
    if (quant) {
      launch<64, int8_t>(BR, grid, st, q, k_pages, v_pages, k_scale, v_scale,
                         tables, lens, out, P, T, Hq, Hk, page, max_pages,
                         layer, scale);
    } else {
      launch<64, __nv_bfloat16>(BR, grid, st, q, k_pages, v_pages, nullptr,
                                nullptr, tables, lens, out, P, T, Hq, Hk,
                                page, max_pages, layer, scale);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
