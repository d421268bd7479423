// T=1 GQA flash decode over the stacked contiguous KV cache, Hopper.
//
// Replaces four kernels of qwen_inference_engine_tpu/ops/decode_attention.py:
//   * decode_attention_contiguous (_decode_attention, body _decode_kernel):
//     bf16 cache, per-row lengths, the ragged batch;
//   * decode_attention_appending (_decode_attention_append, body
//     _decode_append_kernel): bf16 cache, one shared position for every row;
//     the fresh K/V row is written into the cache in place and attended in
//     the same kernel;
//   * decode_attention_contiguous_q8 (_decode_attention_q8, body
//     _decode_kernel_q8): int8 cache with per-token-per-head f32 scales,
//     per-row lengths (INT8 KV, aligned and ragged batches alike);
//   * decode_attention_contiguous_fresh (_decode_attention_fresh, body
//     _decode_kernel_fresh, merge _merge_fresh): bf16 cache, per-row old
//     lengths; the current token's K/V, which the deferred-append decode
//     has not written yet, joins the softmax from the inputs.
// The three bf16 entry points share one kernel (decode_kernel) and select
// the variant: a position with k_new / v_new appends, lengths with k_new /
// v_new merge the fresh token, lengths alone attend the cache.  The int8
// entry point is a kernel of its own, split S on the tensor cores.
//
// q [B, 1, Hq, D] bf16; cache k / v [L, Bc, Hk, S, D] bf16 or int8
// (head-major), scales k_scale / v_scale [L, Bc, Hk, S] f32 (int8 only);
// lengths [B] int32 (contiguous variants; the fresh variant's old lengths,
// which exclude the current token) or position [1] int32 (appending
// variant, length = position + 1; read on the device, so the host never
// waits for it); k_new / v_new [B, Hk, D] bf16; out [B, Hq, D] bf16.
//
// What bounds it on the H100: each row reads 2 * len * Hk * D cache
// elements (2 bytes each in bf16; 1 in int8, plus 8 bytes of scales per key
// and head) for 4 * len * Hq * D flops: G = 7 operations per byte for
// Qwen2.5-7B in bf16, ~14 in int8, far below the ridge (~295), so bytes
// bound it; INT8 KV halves them.  The fresh variant reads the cache bytes
// the appending one reads and writes none.  At a few rows the bytes are
// few (check_decode_q8's 4177 keys: 4.3 MB, 0.0013 ms), so what bounds a
// call in practice is how many SMs it keeps busy and its launches.
//
// The int8 entry point (decode_q8_kernel) is flash-decoding on the tensor
// cores: grid (Hk, B, splits), block (hk, b, s) attends keys
// [s * span, min((s + 1) * span, lengths[b])) of its row through
// attend_mma (attention_mma.cuh) with the G query heads of the KV head as
// the rows of one m16 tile (GqaRows at T = 1), the K/V tiles staged raw by
// cp.async and widened in shared memory (K exact, its scale on the score
// columns; V times its scale, rounded once).  span (a multiple of the
// 64-key tile) and splits come from the host's shapes alone
// (ops/decode_attention.plan_decode_split: B, Hk, S), so a call reads
// nothing back from the device and is capturable in a CUDA graph; at
// B = 4 it gives at least ~2 x 132 blocks.  Each split writes its f32
// output, normalised, and its log-sum-exp to the workspace; a split that
// starts at or past its row's length reads nothing and writes an empty
// partial (0, lse -inf).  decode_merge adds the splits in split order,
// weighted by 2^(lse - max lse), and rounds once to bf16; a row of length
// 0 (every split empty) gives 0, as the one-block kernel did.
//
// The bf16 entry points: simple and right first.  A block of D threads
// takes one (row, KV head) pair (grid: Hk x B) and all G query heads of
// the group as the rows of attention_common.cuh, so each K/V byte is read
// from device memory once per step; G = 7 needs no padding (rows are
// masked in the kernel).  Keys past a row's length are never read.  In the
// appending variant the block of (b, hk) is the only reader and writer of
// that cache row, so it writes the fresh K/V row to the cache and stages
// the same row into its tile from k_new / v_new: the fresh token enters
// the softmax from the inputs, never from a cache read.  The fresh variant
// is the same call of the core with the cache left alone: keys
// [0, old_len) from the cache and key old_len from k_new / v_new, so it
// never reads cache position old_len, and a row with old_len = 0 attends
// its fresh token alone (the core's running max starts at a finite -1e30,
// so no exp(-inf + inf) NaN can arise; the TPU kernel merges the fresh
// token after its S-block loop, the same sum in another order).  Only
// Hk * B blocks run (16 at B = 4 for Qwen2.5-7B): the split-S path of the
// int8 kernel is their next step.

#include <math_constants.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

constexpr int kRows = 8;    // query heads per KV head (G <= 8)
constexpr int kKeys = 64;   // keys per tile
constexpr int kQ8Warps = 4;         // decode_q8_kernel: 128 threads
constexpr int kMergeThreads = 128;  // decode_merge

template <int D>
__global__ void __launch_bounds__(D)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              __nv_bfloat16* __restrict__ k_cache,
              __nv_bfloat16* __restrict__ v_cache,
              const int* __restrict__ lengths,
              const __nv_bfloat16* __restrict__ k_new,
              const __nv_bfloat16* __restrict__ v_new,
              const int* __restrict__ position_ptr,
              __nv_bfloat16* __restrict__ out, int Bc, int Hq, int Hk, int S,
              int layer, float scale) {
  __shared__ qie::AttnSmem<D, kRows, kKeys, __nv_bfloat16> sm;
  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hk;
  const bool appending = position_ptr != nullptr;  // else lengths are given
  const int position = appending ? *position_ptr : -1;
  // a position outside the cache attends nothing and writes nothing
  int len = appending ? (position < S ? position + 1 : 0) : lengths[b];
  len = max(0, min(len, S));

  for (int c = tid; c < kRows * D; c += D) {
    const int i = c / D, d = c % D;
    float val = 0.f;
    if (i < G) {
      val = __bfloat162float(
          q[(static_cast<long long>(b) * Hq + hk * G + i) * D + d]) * scale;
    }
    sm.q[i][d] = val;
  }
  const long long row = (static_cast<long long>(layer) * Bc + b) * Hk + hk;
  const long long base = row * S * D;
  const __nv_bfloat16* kf = nullptr;
  const __nv_bfloat16* vf = nullptr;
  int fresh = -1;
  int n_keys = len;
  if (k_new != nullptr && (!appending || len > 0)) {
    kf = k_new + (static_cast<long long>(b) * Hk + hk) * D;
    vf = v_new + (static_cast<long long>(b) * Hk + hk) * D;
    if (appending) {
      fresh = position;
      k_cache[base + static_cast<long long>(position) * D + tid] = kf[tid];
      v_cache[base + static_cast<long long>(position) * D + tid] = vf[tid];
    } else {  // the fresh merge: the old keys, then the current one
      fresh = len;
      n_keys = len + 1;
    }
  }
  float acc[kRows];
  qie::attend<D, kRows, kKeys, __nv_bfloat16>(
      sm, acc, G, k_cache + base, v_cache + base, qie::ContiguousKeys{D},
      nullptr, nullptr, n_keys, n_keys - 1, 0, kf, vf, fresh);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < G) {
      const float denom = fmaxf(sm.l[i], 1e-30f);
      out[(static_cast<long long>(b) * Hq + hk * G + i) * D + tid] =
          __float2bfloat16(acc[i] / denom);
    }
  }
}

int launch(const void* q, void* k_cache, void* v_cache, const void* lengths,
           const void* k_new, const void* v_new, const void* position,
           void* out, int Bc, int B, int Hq, int Hk, int S, int D, int layer,
           float scale, void* stream) {
  dim3 grid(Hk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kc = static_cast<__nv_bfloat16*>(k_cache);
  auto* vc = static_cast<__nv_bfloat16*>(v_cache);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* kn = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vn = static_cast<const __nv_bfloat16*>(v_new);
  const auto* pp = static_cast<const int*>(position);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    decode_kernel<128><<<grid, 128, 0, st>>>(qp, kc, vc, lp, kn, vn, pp, op,
                                             Bc, Hq, Hk, S, layer, scale);
  } else if (D == 64) {
    decode_kernel<64><<<grid, 64, 0, st>>>(qp, kc, vc, lp, kn, vn, pp, op,
                                           Bc, Hq, Hk, S, layer, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Block (hk, b, s): the G query heads of KV head hk of row b over keys
// [span s, min(span (s + 1), lengths[b])) of its int8 cache row; the f32
// partial to part [splits, B, Hq, D], its log-sum-exp to lse [splits, B,
// Hq].
template <int D>
__global__ void __launch_bounds__(32 * kQ8Warps)
decode_q8_kernel(const __nv_bfloat16* __restrict__ q,
                 const int8_t* __restrict__ k_cache,
                 const int8_t* __restrict__ v_cache,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ lengths, float* __restrict__ part,
                 float* __restrict__ lse, int Bc, int B, int Hq, int Hk,
                 int S, int layer, int span, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<qie::MmaSmem<D, kQ8Warps, int8_t>*>(smem_raw);
  const int hk = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int G = Hq / Hk;
  const int len = max(0, min(lengths[b], S));
  const int k0 = s * span;
  const int n_keys = max(0, min(span, len - k0));
  const long long row = (static_cast<long long>(layer) * Bc + b) * Hk + hk;
  const long long kv = (row * S + k0) * D;
  const long long head = static_cast<long long>(b) * Hq + hk * G;
  const long long split = static_cast<long long>(s) * B * Hq;
  qie::attend_mma<D, kQ8Warps, int8_t, qie::ContiguousKeys, qie::GqaRows,
                  true>(sm, qie::GqaRows{0, G, Hq, D}, G, q + head * D,
                        nullptr, k_cache + kv, v_cache + kv,
                        qie::ContiguousKeys{D}, k_scale + row * S + k0,
                        v_scale + row * S + k0, n_keys, n_keys - 1, 0, G,
                        scale, part + (split + head) * D, lse + split + head);
}

// out [rows, D] bf16 (rows = B * Hq): the f32 partials part [splits, rows,
// D] weighted by 2^(lse - max lse) over lse [splits, rows], added in split
// order, divided by the weights' sum and rounded once; 0 where every split
// of the row is empty (lse -inf).  Each thread 4 adjacent columns.
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge(const float* __restrict__ part, const float* __restrict__ lse,
             __nv_bfloat16* __restrict__ out, int rows, int splits) {
  const int idx = blockIdx.x * kMergeThreads + threadIdx.x;
  if (idx >= rows * (D / 4)) return;
  const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, lse[s * rows + r]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (mx != -CUDART_INF_F) {
    float den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = exp2f(lse[s * rows + r] - mx);  // 0 for an empty split
      const float4 p = *reinterpret_cast<const float4*>(
          part + (static_cast<size_t>(s) * rows + r) * D + c);
      den += w;
      acc[0] += w * p.x;
      acc[1] += w * p.y;
      acc[2] += w * p.z;
      acc[3] += w * p.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] /= den;
  }
  *reinterpret_cast<uint2*>(out + static_cast<size_t>(r) * D + c) =
      make_uint2(qie::mma::pack_bf16(acc[0], acc[1]),
                 qie::mma::pack_bf16(acc[2], acc[3]));
}

// The split kernel, then the merge; ws holds part [splits, B, Hq, D] then
// lse [splits, B, Hq], f32.
template <int D>
cudaError_t launch_q8(const __nv_bfloat16* q, const int8_t* kc,
                      const int8_t* vc, const float* ks, const float* vs,
                      const int* lens, float* ws, __nv_bfloat16* out, int Bc,
                      int B, int Hq, int Hk, int S, int layer, int span,
                      int splits, float scale, cudaStream_t st) {
  constexpr int smem = sizeof(qie::MmaSmem<D, kQ8Warps, int8_t>);
  const auto kern = decode_q8_kernel<D>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  const int rows = B * Hq;
  float* lse = ws + static_cast<size_t>(splits) * rows * D;
  kern<<<dim3(Hk, B, splits), 32 * kQ8Warps, smem, st>>>(
      q, kc, vc, ks, vs, lens, ws, lse, Bc, B, Hq, Hk, S, layer, span,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = rows * (D / 4);
  decode_merge<D><<<(threads + kMergeThreads - 1) / kMergeThreads,
                    kMergeThreads, 0, st>>>(ws, lse, out, rows, splits);
  return cudaGetLastError();
}

bool bad_shape(int L, int Bc, int B, int Hq, int Hk, int layer) {
  return B <= 0 || B > Bc || Hk <= 0 || Hq % Hk || Hq / Hk > kRows ||
         layer < 0 || layer >= L;
}

}  // namespace

extern "C" int qie_decode_attention(const void* q, void* k_cache,
                                    void* v_cache, const void* lengths,
                                    const void* k_new, const void* v_new,
                                    const void* position, void* out, int L,
                                    int Bc, int B, int Hq, int Hk, int S,
                                    int D, int layer, float scale,
                                    void* stream) {
  const bool appending = k_new != nullptr;
  if (bad_shape(L, Bc, B, Hq, Hk, layer) ||
      (appending && (v_new == nullptr || position == nullptr)) ||
      (!appending && (lengths == nullptr || position != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(q, k_cache, v_cache, lengths, k_new, v_new, position, out, Bc,
                B, Hq, Hk, S, D, layer, scale, stream);
}

extern "C" int qie_decode_attention_fresh(
    const void* q, const void* k_cache, const void* v_cache,
    const void* old_lengths, const void* k_new, const void* v_new, void* out,
    int L, int Bc, int B, int Hq, int Hk, int S, int D, int layer,
    float scale, void* stream) {
  if (bad_shape(L, Bc, B, Hq, Hk, layer) || old_lengths == nullptr ||
      k_new == nullptr || v_new == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(q, const_cast<void*>(k_cache), const_cast<void*>(v_cache),
                old_lengths, k_new, v_new, nullptr, out, Bc, B, Hq, Hk, S, D,
                layer, scale, stream);
}

// The split plan (span, splits) of ops/decode_attention.plan_decode_split:
// span a multiple of 64 keys, splits covering S exactly once; ws the
// partials (4 * splits * B * Hq * (D + 1) bytes).
extern "C" int qie_decode_attention_q8(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* lengths, void* ws,
                                       void* out, int L, int Bc, int B,
                                       int Hq, int Hk, int S, int D,
                                       int layer, int span, int splits,
                                       float scale, void* stream) {
  // cp.async copies 16-byte chunks of q and the cache rows, 4-byte scales;
  // the merge reads the partials in 16-byte words
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_cache) |
       reinterpret_cast<uintptr_t>(v_cache) | reinterpret_cast<uintptr_t>(ws)) %
              16 == 0 &&
      (reinterpret_cast<uintptr_t>(k_scale) |
       reinterpret_cast<uintptr_t>(v_scale)) % 4 == 0;
  if (bad_shape(L, Bc, B, Hq, Hk, layer) || k_scale == nullptr ||
      v_scale == nullptr || lengths == nullptr || S <= 0 || span <= 0 ||
      span % kKeys || splits < 1 ||
      static_cast<long long>(splits - 1) * span >= S ||
      static_cast<long long>(splits) * span < S ||
      ws == nullptr || (D != 64 && D != 128) || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kc = static_cast<const int8_t*>(k_cache);
  const auto* vc = static_cast<const int8_t*>(v_cache);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* lp = static_cast<const int*>(lengths);
  auto* wp = static_cast<float*>(ws);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      D == 128 ? launch_q8<128>(qp, kc, vc, ks, vs, lp, wp, op, Bc, B, Hq, Hk,
                                S, layer, span, splits, scale, st)
               : launch_q8<64>(qp, kc, vc, ks, vs, lp, wp, op, Bc, B, Hq, Hk,
                               S, layer, span, splits, scale, st);
  return static_cast<int>(rc);
}
