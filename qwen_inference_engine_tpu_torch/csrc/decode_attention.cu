// T=1 GQA flash decode over the stacked contiguous KV cache, Hopper.
//
// Replaces four kernels of qwen_inference_engine_tpu/ops/decode_attention.py:
//   * decode_attention_contiguous (_decode_attention, body _decode_kernel):
//     bf16 cache, per-row lengths, the ragged batch;
//   * decode_attention_appending (_decode_attention_append, body
//     _decode_append_kernel): bf16 cache, one shared position for every row;
//     the fresh K/V row is written into the cache in place and attended in
//     the same kernel;
//   * decode_attention_contiguous_fresh (_decode_attention_fresh, body
//     _decode_kernel_fresh, merge _merge_fresh): bf16 cache, per-row old
//     lengths; the current token's K/V, which the deferred-append decode
//     has not written yet, joins the softmax from the inputs;
//   * decode_attention_contiguous_q8 (_decode_attention_q8, body
//     _decode_kernel_q8): int8 cache with per-token-per-head f32 scales,
//     per-row lengths (INT8 KV, aligned and ragged batches alike).
// All four share one kernel, split S on the tensor cores
// (decode_split_kernel, over the KV type and whether a fresh row joins).
//
// q [B, 1, Hq, D] bf16; cache k / v [L, Bc, Hk, S, D] bf16 or int8
// (head-major), scales k_scale / v_scale [L, Bc, Hk, S] f32 (int8 only);
// lengths [B] int32 (contiguous and int8; the fresh variant's old lengths,
// which exclude the current token; clamped to [0, S]) or position [1]
// int32 (appending variant, length = position + 1; read on the device, so
// the host never waits for it); k_new / v_new [B, Hk, D] bf16; out [B, Hq,
// D] bf16.  Row b of q, lengths, k_new / v_new and out is cache row row0 +
// b (the TPU kernels' row0: the pipeline's 1F1B decode attends, and the
// appending decode writes, one microbatch's window [row0, row0 + B) of the
// whole cache in place; 0 elsewhere, and always for the fresh variant).
//
// What bounds it on the H100: each row reads 2 * len * Hk * D cache
// elements (2 bytes each in bf16; 1 in int8, plus 8 bytes of scales per key
// and head) for 4 * len * Hq * D flops: G = 7 operations per byte for
// Qwen2.5-7B in bf16, ~14 in int8, far below the ridge (~295), so bytes
// bound it; INT8 KV halves them.  The fresh variant reads the cache bytes
// the appending one reads and writes none.  At a few rows the bytes are
// few (check_decode's 4000 keys: 8.2 MB, 0.0025 ms; its ragged lengths
// 69..1000, 1553 keys: 3.2 MB), so what bounds a call there is how many
// SMs it keeps busy and its launches; at the batch-192
// default dispatch (768 heads of ~270 keys: ~107 MB, ~0.032 ms) it is the
// bytes.
//
// decode_split_kernel is flash-decoding on the tensor cores: grid (Hk, B,
// splits), block (hk, b, s) attends keys [s * span, min((s + 1) * span,
// n_b)) of its row through attend_mma (attention_mma.cuh) with the G query
// heads of the KV head as the rows of one m16 tile (GqaRows at T = 1).
// bf16 K/V tiles are staged by cp.async straight into shared memory; int8
// ones raw, then widened (K exact, its scale on the score columns; V times
// its scale, rounded once).  span (a multiple of the 64-key tile) and
// splits come from the host's shapes alone
// (ops/decode_attention.plan_decode_split: B, Hk, S), so a call reads
// nothing back from the device and is capturable in a CUDA graph (a
// device position may change between replays); at B = 4 it gives at least
// ~2 x 132 blocks.  Each split writes its f32 output, normalised, and its
// log-sum-exp to the workspace; a split that starts at or past its row's
// keys reads nothing and writes an empty partial (0, lse -inf).
// decode_merge (attention_mma.cuh, shared with the paged decode) adds the
// splits in split order, weighted by 2^(lse - max lse), and rounds once to
// bf16; a row with no key (every split empty)
// gives 0.  No atomics: two calls are bit-identical.
//
// The fresh row (bf16).  Row b attends n_b = f + 1 keys, where f is the
// shared position (appending) or old_lengths[b] (fresh).  Key f is staged
// from k_new / v_new by the split that holds it (attend_mma's FreshKeys
// policy), never read from the cache; in the appending decode the same
// block stores the row to cache position f, which no other block of the
// launch reads, so nothing races.  A fresh key past the splits
// (old_lengths[b] == S where splits * span == S: the TPU kernel merges it
// after its S loop) goes to the last split, which then attends up to span
// + 1 keys.  A position outside the cache attends nothing and writes
// nothing (output 0).  At one shared position the two bf16 entry points
// run the same blocks on the same values, so their outputs are
// bit-identical, and the appending decode's cache row is k_new / v_new's
// bits.  Where the plan has one split (B * Hk >= 264: the batch-192
// default dispatch), a bf16 call writes bf16 straight from attend_mma and
// launches no merge: the merge of one split rounds the same value (weight
// 1).  The int8 entry point always merges.
//
// The ragged decode (bf16, per-row lengths, no fresh row) runs the int8
// entry point's blocks over bf16 tiles: n_b = lengths[b], every key from
// the cache (ContiguousKeys), bf16 out directly at one split as above.
// After the appending decode has written position f, this decode at
// lengths f + 1 stages the same bits into the same blocks, so its output
// equals the appending one bit for bit.

#include <math_constants.h>

#include "attention_mma.cuh"

namespace {

constexpr int kRows = 8;    // query heads per KV head (G <= 8)
constexpr int kKeys = 64;   // keys per tile
// decode_split_kernel's warps: one computes the m16 tile of G <= 8 rows,
// all stage (and widen int8 tiles); for bf16, 1, 2 and 4 warps time alike
// at B 4 and B 192 (scripts/sweep_decode_warps_torch.py), 4 as fast as any
constexpr int kWarps = 4;

// Block (hk, b, s): the G query heads of KV head hk of row b over keys
// [span s, min(span (s + 1), n_b)) of its cache row row0 + b (the last
// split up to n_b).  Without kFresh: n_b = lengths[b], every key from the
// cache (int8: the scales beside).  kFresh (bf16): n_b = f + 1 with key f
// from k_new / v_new, f the shared position (`position` given: the
// appending decode, which also writes row f to the cache) or
// old_lengths[b] (`lengths`).
// kSplit: the f32 partial to part [splits, B, Hq, D], its log-sum-exp to
// lse [splits, B, Hq]; else (one split, bf16) the output to out [B, Hq,
// D].
template <int D, typename KV, bool kFresh, bool kSplit>
__global__ void __launch_bounds__(32 * kWarps)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    KV* __restrict__ k_cache, KV* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths,
                    const int* __restrict__ position,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new,
                    float* __restrict__ part, float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ out, int Bc, int B, int Hq,
                    int Hk, int S, int layer, int row0, int span,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<qie::MmaSmem<D, kWarps, KV>*>(smem_raw);
  const int hk = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int G = Hq / Hk;
  const int k0 = s * span;
  const long long row =
      (static_cast<long long>(layer) * Bc + row0 + b) * Hk + hk;
  const long long kv = (row * S + k0) * D;
  const long long head = static_cast<long long>(b) * Hq + hk * G;
  const long long split = static_cast<long long>(s) * B * Hq;
  float* const part_at = kSplit ? part + (split + head) * D : nullptr;
  float* const lse_at = kSplit ? lse + split + head : nullptr;
  if constexpr (!kFresh) {
    const int len = max(0, min(lengths[b], S));
    const int n_keys = max(0, min(span, len - k0));
    const bool quant = sizeof(KV) == 1;
    qie::attend_mma<D, kWarps, KV, qie::ContiguousKeys, qie::GqaRows,
                    kSplit>(
        sm, qie::GqaRows{0, G, Hq, D}, G, q + head * D,
        kSplit ? nullptr : out + head * D, k_cache + kv, v_cache + kv,
        qie::ContiguousKeys{D}, quant ? k_scale + row * S + k0 : nullptr,
        quant ? v_scale + row * S + k0 : nullptr, n_keys, n_keys - 1, 0, G,
        scale, part_at, lse_at);
  } else {
    static_assert(sizeof(KV) == 2, "a fresh row joins bf16 caches only");
    // the fresh key f; a position outside the cache has none (and no keys)
    int f;
    if (position != nullptr) {
      const int p = *position;
      f = p >= 0 && p < S ? p : -1;
    } else {
      f = max(0, min(lengths[b], S));
    }
    const bool last = s == static_cast<int>(gridDim.z) - 1;
    const int end = last ? f + 1 : min(k0 + span, f + 1);
    const int n_keys = max(0, end - k0);
    const long long fresh = (static_cast<long long>(b) * Hk + hk) * D;
    if (position != nullptr && f >= k0 && f < end) {
      // this block holds the fresh key: store it to the cache (16 bytes a
      // thread); the block stages it from k_new / v_new, not from here
      const long long at = (row * S + f) * D;
      for (int c = threadIdx.x; c < D / 8; c += 32 * kWarps) {
        *reinterpret_cast<uint4*>(k_cache + at + 8 * c) =
            *reinterpret_cast<const uint4*>(k_new + fresh + 8 * c);
        *reinterpret_cast<uint4*>(v_cache + at + 8 * c) =
            *reinterpret_cast<const uint4*>(v_new + fresh + 8 * c);
      }
    }
    qie::attend_mma<D, kWarps, KV, qie::FreshKeys, qie::GqaRows,
                    kSplit>(
        sm, qie::GqaRows{0, G, Hq, D}, G, q + head * D, out + head * D,
        k_cache + kv, v_cache + kv,
        qie::FreshKeys{D, f - k0, k_new + fresh, v_new + fresh}, nullptr,
        nullptr, n_keys, n_keys - 1, 0, G, scale, part_at, lse_at);
  }
}

// The split kernel, then (int8, or more than one split) the merge; ws
// holds part [splits, B, Hq, D] then lse [splits, B, Hq], f32 (null for a
// bf16 call of one split, which writes out directly).
template <int D, typename KV, bool kFresh>
cudaError_t launch_split(const __nv_bfloat16* q, KV* kc, KV* vc,
                         const float* ks, const float* vs, const int* lens,
                         const int* pos, const __nv_bfloat16* kn,
                         const __nv_bfloat16* vn, float* ws,
                         __nv_bfloat16* out, int Bc, int B, int Hq, int Hk,
                         int S, int layer, int row0, int span, int splits,
                         float scale, cudaStream_t st) {
  constexpr int smem = sizeof(qie::MmaSmem<D, kWarps, KV>);
  auto kern = decode_split_kernel<D, KV, kFresh, true>;
  bool merge = true;
  if constexpr (sizeof(KV) == 2) {
    if (splits == 1) {
      kern = decode_split_kernel<D, KV, kFresh, false>;
      merge = false;
    }
  }
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  const int rows = B * Hq;
  float* lse = merge ? ws + static_cast<size_t>(splits) * rows * D : nullptr;
  kern<<<dim3(Hk, B, splits), 32 * kWarps, smem, st>>>(
      q, kc, vc, ks, vs, lens, pos, kn, vn, ws, lse, out, Bc, B, Hq, Hk, S,
      layer, row0, span, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return err;
  return qie::launch_merge<D>(ws, lse, out, rows, splits, st);
}

// The rows [row0, row0 + B) inside the cache's Bc.
bool bad_shape(int L, int Bc, int B, int row0, int Hq, int Hk, int layer) {
  return B <= 0 || row0 < 0 || row0 > Bc - B || Hk <= 0 || Hq % Hk ||
         Hq / Hk > kRows || layer < 0 || layer >= L;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The split plan (span, splits) of ops/decode_attention.plan_decode_split:
// span a multiple of 64 keys, splits covering S exactly once.
bool bad_plan(int S, int span, int splits) {
  return S <= 0 || span <= 0 || span % kKeys || splits < 1 ||
         static_cast<long long>(splits - 1) * span >= S ||
         static_cast<long long>(splits) * span < S;
}

// The three bf16 split entry points' common guard and launch: cp.async
// copies 16-byte chunks of q, the cache rows and k_new / v_new, the cache
// row is stored in 16-byte words and the merge reads the partials in
// 16-byte words; a workspace (4 * splits * B * Hq * (D + 1) bytes) is
// needed where the plan has more than one split.  kFresh: k_new / v_new
// and either lengths (old lengths) or a position; else lengths alone (the
// ragged decode).
template <bool kFresh>
int launch_bf16(const void* q, void* k_cache, void* v_cache,
                const void* lengths, const void* position, const void* k_new,
                const void* v_new, void* ws, void* out, int L, int Bc, int B,
                int Hq, int Hk, int S, int D, int layer, int row0, int span,
                int splits, float scale, void* stream) {
  if (bad_shape(L, Bc, B, row0, Hq, Hk, layer) ||
      bad_plan(S, span, splits) ||
      (D != 64 && D != 128) ||
      (kFresh ? k_new == nullptr || v_new == nullptr ||
                    (lengths == nullptr) == (position == nullptr)
              : lengths == nullptr || position != nullptr ||
                    k_new != nullptr || v_new != nullptr) ||
      (splits > 1 && ws == nullptr) || !aligned16(q) ||
      !aligned16(k_cache) || !aligned16(v_cache) || !aligned16(k_new) ||
      !aligned16(v_new) || !aligned16(ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf16 = __nv_bfloat16;
  const auto* qp = static_cast<const bf16*>(q);
  auto* kc = static_cast<bf16*>(k_cache);
  auto* vc = static_cast<bf16*>(v_cache);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* pp = static_cast<const int*>(position);
  const auto* kn = static_cast<const bf16*>(k_new);
  const auto* vn = static_cast<const bf16*>(v_new);
  auto* wp = static_cast<float*>(ws);
  auto* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      D == 128
          ? launch_split<128, bf16, kFresh>(
                qp, kc, vc, nullptr, nullptr, lp, pp, kn, vn, wp, op, Bc, B,
                Hq, Hk, S, layer, row0, span, splits, scale, st)
          : launch_split<64, bf16, kFresh>(
                qp, kc, vc, nullptr, nullptr, lp, pp, kn, vn, wp, op, Bc, B,
                Hq, Hk, S, layer, row0, span, splits, scale, st);
  return static_cast<int>(rc);
}

}  // namespace

// Per-row lengths, no fresh row, cache rows [row0, row0 + B); the cache is
// only read.
extern "C" int qie_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lengths,
                                    void* ws, void* out, int L, int Bc, int B,
                                    int Hq, int Hk, int S, int D, int layer,
                                    int row0, int span, int splits,
                                    float scale, void* stream) {
  if (lengths == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<false>(
      q, const_cast<void*>(k_cache), const_cast<void*>(v_cache), lengths,
      nullptr, nullptr, nullptr, ws, out, L, Bc, B, Hq, Hk, S, D, layer, row0,
      span, splits, scale, stream);
}

// Every row at the one device position (read by the kernel), cache rows
// [row0, row0 + B); writes the fresh row into the cache in place.
extern "C" int qie_decode_attention_appending(
    const void* q, void* k_cache, void* v_cache, const void* k_new,
    const void* v_new, const void* position, void* ws, void* out, int L,
    int Bc, int B, int Hq, int Hk, int S, int D, int layer, int row0,
    int span, int splits, float scale, void* stream) {
  if (position == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true>(q, k_cache, v_cache, nullptr, position, k_new,
                           v_new, ws, out, L, Bc, B, Hq, Hk, S, D, layer,
                           row0, span, splits, scale, stream);
}

// Per-row old lengths; the cache is only read.
extern "C" int qie_decode_attention_fresh(
    const void* q, const void* k_cache, const void* v_cache,
    const void* old_lengths, const void* k_new, const void* v_new, void* ws,
    void* out, int L, int Bc, int B, int Hq, int Hk, int S, int D, int layer,
    int span, int splits, float scale, void* stream) {
  if (old_lengths == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true>(
      q, const_cast<void*>(k_cache), const_cast<void*>(v_cache), old_lengths,
      nullptr, k_new, v_new, ws, out, L, Bc, B, Hq, Hk, S, D, layer, 0, span,
      splits, scale, stream);
}

// ws the partials (4 * splits * B * Hq * (D + 1) bytes); cache rows
// [row0, row0 + B).
extern "C" int qie_decode_attention_q8(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* lengths, void* ws,
                                       void* out, int L, int Bc, int B,
                                       int Hq, int Hk, int S, int D,
                                       int layer, int row0, int span,
                                       int splits, float scale,
                                       void* stream) {
  // cp.async copies 16-byte chunks of q and the cache rows, 4-byte scales;
  // the merge reads the partials in 16-byte words
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_cache) |
       reinterpret_cast<uintptr_t>(v_cache) | reinterpret_cast<uintptr_t>(ws)) %
              16 == 0 &&
      (reinterpret_cast<uintptr_t>(k_scale) |
       reinterpret_cast<uintptr_t>(v_scale)) % 4 == 0;
  if (bad_shape(L, Bc, B, row0, Hq, Hk, layer) || k_scale == nullptr ||
      v_scale == nullptr || lengths == nullptr || bad_plan(S, span, splits) ||
      ws == nullptr || (D != 64 && D != 128) || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kc = static_cast<int8_t*>(const_cast<void*>(k_cache));
  auto* vc = static_cast<int8_t*>(const_cast<void*>(v_cache));
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* lp = static_cast<const int*>(lengths);
  auto* wp = static_cast<float*>(ws);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      D == 128 ? launch_split<128, int8_t, false>(
                     qp, kc, vc, ks, vs, lp, nullptr, nullptr, nullptr, wp,
                     op, Bc, B, Hq, Hk, S, layer, row0, span, splits, scale,
                     st)
               : launch_split<64, int8_t, false>(
                     qp, kc, vc, ks, vs, lp, nullptr, nullptr, nullptr, wp,
                     op, Bc, B, Hq, Hk, S, layer, row0, span, splits, scale,
                     st);
  return static_cast<int>(rc);
}
