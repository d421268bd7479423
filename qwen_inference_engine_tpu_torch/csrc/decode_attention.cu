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
// One kernel templated on the cache's element type; the bf16 entry points
// select the variant: a position with k_new / v_new appends, lengths with
// k_new / v_new merge the fresh token, lengths alone attend the cache.
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
// the appending one reads and writes none.
//
// Design: simple and right first.  A block of D threads takes one (row, KV
// head) pair (grid: Hk x B) and all G query heads of the group as the rows
// of attention_common.cuh, so each K/V byte is read from device memory once
// per step; G = 7 needs no padding (rows are masked in the kernel).  Keys
// past a row's length are never read.  The int8 variant stages the raw
// bytes and the tile's scales in shared memory and dequantizes in
// registers: the score is (q . k_i8) * k_scale, and the V scale multiplies
// each value before the P @ V sum (the TPU kernel folds it into the
// probabilities; the product is the same).  In the appending variant the
// block of (b, hk) is the only reader and writer of that cache row, so it
// writes the fresh K/V row to the cache and stages the same row into its
// tile from k_new / v_new: the fresh token enters the softmax from the
// inputs, never from a cache read.  The fresh variant is the same call of
// the core with the cache left alone: keys [0, old_len) from the cache and
// key old_len from k_new / v_new, so it never reads cache position
// old_len, and a row with old_len = 0 attends its fresh token alone (the
// core's running max starts at a finite -1e30, so no exp(-inf + inf) NaN
// can arise; the TPU kernel merges the fresh token after its S-block loop,
// the same sum in another order).  Only Hk * B blocks run (16 at B = 4 for
// Qwen2.5-7B), a small share of the 132 SMs: splitting S across blocks with
// a second reduction pass (flash-decoding) is the next step for speed.

#include "attention_common.cuh"

namespace {

constexpr int kRows = 8;    // query heads per KV head (G <= 8)
constexpr int kKeys = 64;   // keys per tile

template <int D, typename KV>
__global__ void __launch_bounds__(D)
decode_kernel(const __nv_bfloat16* __restrict__ q, KV* __restrict__ k_cache,
              KV* __restrict__ v_cache, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths, const KV* __restrict__ k_new,
              const KV* __restrict__ v_new,
              const int* __restrict__ position_ptr,
              __nv_bfloat16* __restrict__ out, int Bc, int Hq, int Hk, int S,
              int layer, float scale) {
  __shared__ qie::AttnSmem<D, kRows, kKeys, KV> sm;
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
  const KV* kf = nullptr;
  const KV* vf = nullptr;
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
  const float* ks = k_scale == nullptr ? nullptr : k_scale + row * S;
  const float* vs = v_scale == nullptr ? nullptr : v_scale + row * S;
  float acc[kRows];
  qie::attend<D, kRows, kKeys, KV>(sm, acc, G, k_cache + base, v_cache + base,
                                   qie::ContiguousKeys{D}, ks, vs, n_keys,
                                   n_keys - 1, 0, kf, vf, fresh);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < G) {
      const float denom = fmaxf(sm.l[i], 1e-30f);
      out[(static_cast<long long>(b) * Hq + hk * G + i) * D + tid] =
          __float2bfloat16(acc[i] / denom);
    }
  }
}

template <typename KV>
int launch(const void* q, void* k_cache, void* v_cache, const void* k_scale,
           const void* v_scale, const void* lengths, const void* k_new,
           const void* v_new, const void* position, void* out, int Bc, int B,
           int Hq, int Hk, int S, int D, int layer, float scale,
           void* stream) {
  dim3 grid(Hk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kc = static_cast<KV*>(k_cache);
  auto* vc = static_cast<KV*>(v_cache);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* kn = static_cast<const KV*>(k_new);
  const auto* vn = static_cast<const KV*>(v_new);
  const auto* pp = static_cast<const int*>(position);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    decode_kernel<128, KV><<<grid, 128, 0, st>>>(
        qp, kc, vc, ksp, vsp, lp, kn, vn, pp, op, Bc, Hq, Hk, S, layer, scale);
  } else if (D == 64) {
    decode_kernel<64, KV><<<grid, 64, 0, st>>>(
        qp, kc, vc, ksp, vsp, lp, kn, vn, pp, op, Bc, Hq, Hk, S, layer, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, lengths,
                               k_new, v_new, position, out, Bc, B, Hq, Hk, S,
                               D, layer, scale, stream);
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
  return launch<__nv_bfloat16>(q, const_cast<void*>(k_cache),
                               const_cast<void*>(v_cache), nullptr, nullptr,
                               old_lengths, k_new, v_new, nullptr, out, Bc, B,
                               Hq, Hk, S, D, layer, scale, stream);
}

extern "C" int qie_decode_attention_q8(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* lengths, void* out, int L,
                                       int Bc, int B, int Hq, int Hk, int S,
                                       int D, int layer, float scale,
                                       void* stream) {
  if (bad_shape(L, Bc, B, Hq, Hk, layer) || k_scale == nullptr ||
      v_scale == nullptr || lengths == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<int8_t>(q, const_cast<void*>(k_cache),
                        const_cast<void*>(v_cache), k_scale, v_scale, lengths,
                        nullptr, nullptr, nullptr, out, Bc, B, Hq, Hk, S, D,
                        layer, scale, stream);
}
