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
// of row b is row j % page of page tables[b, j / page]; a row holds at
// most S = max_pages * page keys.  Token t of row b sits at len - T + t
// and sees keys [0, len - T + t] (the TPU kernel's mask k_pos < seq_len -
// (n_t - 1) + t), of the first min(len, S).  int8 scores are (q . k_i8) *
// k_scale * D^-1/2, and the values are the int8 ones times their V scales
// (attention_mma.cuh says why not the TPU kernel's order).
//
// What bounds it on the H100: each row reads 2 * len * Hk * D K/V elements
// (bf16: 2 bytes, int8: 1 byte + 8 bytes of scales a key and head) for
// 4 * len * T * Hq * D flops: at T = 1, G = 7 (Qwen2.5-7B) 7 operations a
// bf16 byte, at T = 5 35; both far below the ridge (~295): bytes bound it.
// Serving's 8 slots of at most a few thousand keys are a few MB a layer,
// so what bounds a call in practice is how many SMs it keeps busy.
//
// paged_split_kernel is flash-decoding on the tensor cores over paged keys,
// the contiguous decodes' decode_split_kernel (decode_attention.cu) with
// PagedKeys addressing and row groups.  Grid (Hk, B, row_groups * splits):
// block (hk, b, g, s) takes the query rows [64 g, 64 g + 64) of row b's
// T * G rows of KV head hk, packed token-major (r = t * G + h, GqaRows,
// no padding of G to 8), and attends keys [s * span, min((s + 1) * span,
// n)) of row b through its block table, n the block's last row's limit
// (the last split takes every key up to n, whatever its span), on
// attend_mma (attention_mma.cuh) with the PagedKeys policy counting from
// the split's first key: each 16-byte chunk of a 64-key tile resolves its
// own page, so a tile may span pages of any multiple of 8 tokens and a
// split need not start a page.  The decode's G <= 8 rows and the verify's
// T * G <= 64 rows (T <= 9 at G = 7) are one row group, so each K/V tile
// is read once a split, not once for every 16 rows as in the CUDA-core
// kernel this replaces; wider verify windows take ceil(T * G / 64) row
// groups.  Row r's causal limit is len - T + r / G (lim0 = len - T - k0,
// lim_row0 = 64 g, lim_group = G), so a block never reads a key past its
// last row's limit.  Keys at or past min(len, S) are never loaded (stale
// or freed pages, even NaN, cannot leak in); a length of 0 (an idle row)
// gives zeros.  bf16 tiles are staged by cp.async straight into shared
// memory; int8 ones raw with their scales (PagedKeys::scale), then widened:
// K exact, its scale on the score columns; V times its scale, rounded
// once.  span (a multiple of the 64-key tile) and splits come from the
// host's shapes alone (ops/paged_attention.plan_paged_split: B, Hk, the
// row groups and S), so a call reads nothing back from the device and is
// capturable in a CUDA graph; the serving callers pass tables of their
// full max_pages_per_seq width, so a row's splits, and so its bits, do not
// follow the rows beside it (splits past a row's keys are empty).  Each split
// writes its f32 output, normalised, and its log-sum-exp to the workspace
// [splits, B * T * Hq, D] + [splits, B * T * Hq]; decode_merge
// (attention_mma.cuh) adds the splits in split order, no atomics, so two
// calls are bit-identical.  A bf16 call of one split writes bf16 straight
// from attend_mma and launches no merge; an int8 call always merges.  The
// plan depends on S and not on the table's contents, so one cache gives
// the same bits through pages of any size, in any order; and while a
// verify's rows are one row group, its row for token t is, bit for bit,
// the decode of that token (the same plan, blocks and arithmetic a row).
//
// The paged chunks (chunk_attention.cu) run the same core with the same
// PagedKeys, one block a 64-row tile and no key split.

#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kKeys = qie::kMmaKeys;      // keys per tile
constexpr int kWarps = qie::kGqaWarps;    // warps of a block
constexpr int kGroupRows = qie::kGqaRows;  // packed query rows of a block

// Block (hk, b, g, s): row group g = blockIdx.z % row_groups, split s =
// blockIdx.z / row_groups.  kSplit: the f32 partial to part [splits, B *
// T * Hq, D], its log-sum-exp to lse [splits, B * T * Hq]; else (one
// split, bf16) the output to out [B, T, Hq, D].
template <int D, typename KV, bool kSplit>
__global__ void __launch_bounds__(32 * kWarps, 1)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ k_pages,
                   const KV* __restrict__ v_pages,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens, float* __restrict__ part,
                   float* __restrict__ lse, __nv_bfloat16* __restrict__ out,
                   int P, int B, int T, int Hq, int Hk, int page,
                   int max_pages, int layer, int span, int row_groups,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<qie::MmaSmem<D, kWarps, KV>*>(smem_raw);
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g = blockIdx.z % row_groups, s = blockIdx.z / row_groups;
  const int splits = gridDim.z / row_groups;
  const int G = Hq / Hk;
  const int r0 = g * kGroupRows;
  const int n_rows = min(kGroupRows, T * G - r0);
  const int k0 = s * span;
  // row r sees keys [0, len - T + r / G] of the first min(len, S); the
  // block's last row bounds what it reads
  const int len = lens[b];
  const int n = max(0, min(min(len, max_pages * page),
                           len - T + (r0 + n_rows - 1) / G + 1));
  const int end = s == splits - 1 ? n : min(k0 + span, n);
  const int n_keys = max(0, end - k0);
  // page 0 of (layer, hk); the row's table picks each key's page
  const long long sbase =
      (static_cast<long long>(layer) * P * Hk + hk) * page;
  const long long base = sbase * D;
  const bool quant = sizeof(KV) == 1;
  const long long head = static_cast<long long>(b) * T * Hq + hk * G;
  const long long split = static_cast<long long>(s) * B * T * Hq;
  qie::attend_mma<D, kWarps, KV, qie::PagedKeys, qie::GqaRows, kSplit>(
      sm, qie::GqaRows{r0, G, Hq, D}, n_rows, q + head * D,
      kSplit ? nullptr : out + head * D, k_pages + base, v_pages + base,
      qie::PagedKeys{tables + static_cast<long long>(b) * max_pages, page, D,
                     static_cast<long long>(Hk) * page * D,
                     static_cast<long long>(Hk) * page, k0},
      quant ? k_scale + sbase : nullptr, quant ? v_scale + sbase : nullptr,
      n_keys, len - T - k0, r0, G, scale,
      kSplit ? part + (split + head) * D : nullptr,
      kSplit ? lse + split + head : nullptr);
}

// The split kernel, then (int8, or more than one split) the merge; ws
// holds part [splits, B * T * Hq, D] then lse [splits, B * T * Hq], f32
// (null for a bf16 call of one split, which writes out directly).
template <int D, typename KV>
cudaError_t launch_split(const __nv_bfloat16* q, const KV* kp, const KV* vp,
                         const float* ks, const float* vs, const int* tables,
                         const int* lens, float* ws, __nv_bfloat16* out,
                         int P, int B, int T, int Hq, int Hk, int page,
                         int max_pages, int layer, int span, int splits,
                         int row_groups, float scale, cudaStream_t st) {
  constexpr int smem = sizeof(qie::MmaSmem<D, kWarps, KV>);
  auto kern = paged_split_kernel<D, KV, true>;
  bool merge = true;
  if constexpr (sizeof(KV) == 2) {
    if (splits == 1) {
      kern = paged_split_kernel<D, KV, false>;
      merge = false;
    }
  }
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  const int rows = B * T * Hq;
  float* lse = merge ? ws + static_cast<size_t>(splits) * rows * D : nullptr;
  kern<<<dim3(Hk, B, row_groups * splits), 32 * kWarps, smem, st>>>(
      q, kp, vp, ks, vs, tables, lens, ws, lse, out, P, B, T, Hq, Hk, page,
      max_pages, layer, span, row_groups, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return err;
  return qie::launch_merge<D>(ws, lse, out, rows, splits, st);
}

// The split plan (span, splits) of ops/paged_attention.plan_paged_split:
// span a multiple of 64 keys, splits covering S exactly once.
bool bad_plan(long long S, int span, int splits) {
  return S <= 0 || span <= 0 || span % kKeys || splits < 1 ||
         static_cast<long long>(splits - 1) * span >= S ||
         static_cast<long long>(splits) * span < S;
}

}  // namespace

// k_scale / v_scale null: a bf16 pool; both given: an int8 pool.  T = 1 is
// the decode, T >= 2 the verify (any window: its T * G query rows go to
// ceil(T * G / 64) row groups).  ws: the partials (4 * splits * B * T *
// Hq * (D + 1) bytes), null only for a bf16 call of one split.  cp.async
// copies 16-byte chunks of q and the pools and 4-byte scales; the merge
// reads the partials in 16-byte words.
extern "C" int qie_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* lens, void* ws, void* out,
                                   int L, int P, int B, int T, int Hq, int Hk,
                                   int page, int max_pages, int D, int layer,
                                   int span, int splits, float scale,
                                   void* stream) {
  const bool quant = k_scale != nullptr;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages) |
       reinterpret_cast<uintptr_t>(ws)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(k_scale) |
       reinterpret_cast<uintptr_t>(v_scale)) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (B <= 0 || T < 1 || Hk <= 0 || Hq % Hk || Hq / Hk > 8 ||
      page <= 0 || page % 8 || max_pages <= 0 || P <= 0 || layer < 0 ||
      layer >= L || quant != (v_scale != nullptr) || B > 65535 ||
      (D != 64 && D != 128) || tables == nullptr || lens == nullptr ||
      bad_plan(static_cast<long long>(max_pages) * page, span, splits) ||
      ((quant || splits > 1) && ws == nullptr) || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row_groups =
      (static_cast<long long>(T) * (Hq / Hk) + kGroupRows - 1) / kGroupRows;
  if (row_groups * splits > 65535 ||
      static_cast<long long>(B) * T * Hq * D / 4 > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf16 = __nv_bfloat16;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  auto* wp = static_cast<float*>(ws);
  auto* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rg = static_cast<int>(row_groups);
  cudaError_t rc;
  if (quant) {
    const auto* kp = static_cast<const int8_t*>(k_pages);
    const auto* vp = static_cast<const int8_t*>(v_pages);
    rc = D == 128 ? launch_split<128, int8_t>(
                        qp, kp, vp, ks, vs, tp, lp, wp, op, P, B, T, Hq, Hk,
                        page, max_pages, layer, span, splits, rg, scale, st)
                  : launch_split<64, int8_t>(
                        qp, kp, vp, ks, vs, tp, lp, wp, op, P, B, T, Hq, Hk,
                        page, max_pages, layer, span, splits, rg, scale, st);
  } else {
    const auto* kp = static_cast<const bf16*>(k_pages);
    const auto* vp = static_cast<const bf16*>(v_pages);
    rc = D == 128 ? launch_split<128, bf16>(
                        qp, kp, vp, nullptr, nullptr, tp, lp, wp, op, P, B,
                        T, Hq, Hk, page, max_pages, layer, span, splits, rg,
                        scale, st)
                  : launch_split<64, bf16>(
                        qp, kp, vp, nullptr, nullptr, tp, lp, wp, op, P, B,
                        T, Hq, Hk, page, max_pages, layer, span, splits, rg,
                        scale, st);
  }
  return static_cast<int>(rc);
}
