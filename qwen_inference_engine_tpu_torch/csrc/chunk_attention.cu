// Prefill continuation-chunk flash attention over the stacked contiguous
// KV cache or over the stacked page pool, bf16 or int8, Hopper.
//
// Replaces four kernels of qwen_inference_engine_tpu/ops/chunk_attention.py:
//   * chunk_attention_contiguous (_chunk_attention, body _chunk_kernel):
//     bf16 cache;
//   * chunk_attention_contiguous_q8 (_chunk_attention_q8, body
//     _chunk_kernel_q8): int8 cache with per-token-per-head f32 scales;
//   * paged_chunk_attention (_paged_chunk, body _paged_chunk_kernel): bf16
//     page pool [L, P, Hk, page, D] addressed through a block table
//     [B, max_pages] (the serving scheduler's continuation pieces);
//   * paged_chunk_attention_q8 (_paged_chunk_q8, body
//     _paged_chunk_kernel_q8): the same over the int8 page pool with its
//     scales [L, P, Hk, page].
// One kernel templated on the cache's element type and on the key
// addressing (attention_common.cuh: qie::ContiguousKeys / qie::PagedKeys).
//
// q [B, T, Hq, D] bf16: the chunk's queries at absolute positions
// [start, start + T); the cache holds the chunk's own keys already
// written; scales [L, Bc, Hk, S] or [L, P, Hk, page] f32 (int8 only); out
// [B, T, Hq, D] bf16.  `start` is a host int shared by every row, or, for
// the contiguous cache, a [B] int32 device tensor of per-row starts (the
// fixed-batch speculative verify: each row at its own length), read by the
// kernel so the host never waits for it; a row's keys are clamped to the
// cache.  Query t attends keys [0, start + t], f32 online softmax; scores
// never leave shared memory.  int8 scores are (q . k_i8) * k_scale *
// D^-1/2 and each value is scaled by its V scale before the P @ V sum, as
// the TPU kernel folds the V scale into the probabilities.
//
// What bounds it on the H100: at B=4, T=512, start=1536 for Qwen2.5-7B a
// layer reads 2 * B * Hk * (start + T) * D elements of cache (16.8 MB bf16,
// 8.4 MB int8) for 4 * B * Hq * D * (T * start + T * (T + 1) / 2) = 52.6
// GFLOP: ~3,100 (bf16) or ~6,200 (int8) operations per byte, far above the
// ridge (~295), so operations bound it (53 us on the bf16 tensor cores); on
// the CUDA cores used here they bound it the more.  The serving piece (B=1,
// T=256) is bound the same way; the speculative verify (T = k + 1 <= 16)
// is bound by bytes, as decode is.
//
// Design: simple and right first, the flash prefill kernel's layout
// (attention_common.cuh) with the cache in place of fresh K/V.  A block of
// D threads takes 16 query rows of one head (grid: T/16 x Hq x B; blocks
// share nothing) and walks the key tiles of 64 of its (layer, row, KV head)
// keys straight from the stacked cache or pool, no slab copy and no
// gathered copy of the pages, up to its last row's position, so no tile
// above the causal diagonal is read.  Tiles wholly below `start` pass
// every key; only the tiles that overlap the chunk take the triangle.  In
// the page pool each key's page (and an int8 key's scale) is looked up in
// the row's block table as the tile is staged, so a tile may span pages
// and `start` need not be page-aligned (a prefix-cache hit with a
// partial-page copy starts its first piece mid-page); keys past the
// chunk's end are never loaded, nor keys past the table's end (a
// bucket-padded last piece may reach there).  G = 7 is not padded: each
// query head is its own block.  Any T >= 1 is taken (the ragged edge is
// masked in the kernel); the wrappers limit T to the engine's chunk of
// 512, with no T % 8 or VMEM condition (the TPU kernel's).  int8 K/V are
// staged as raw bytes, so a tile costs half the shared-memory traffic of
// bf16, and dequantized in registers.  The products run as fp32 FMAs on
// the CUDA cores; the tensor cores (mma / wgmma) are later work.

#include "attention_common.cuh"

namespace {

constexpr int kRows = 16;   // query rows per block
constexpr int kKeys = 64;   // keys per tile

// kPaged: k_cache / v_cache are the page pool [L, P, Hk, page, D] and
// (Bc, S) stand for (P, page); tables is [B, max_pages].  starts: per-row
// starts on the device (contiguous only), or null for the host `start`.
template <int D, typename KV, bool kPaged>
__global__ void __launch_bounds__(D)
chunk_kernel(const __nv_bfloat16* __restrict__ q,
             const KV* __restrict__ k_cache, const KV* __restrict__ v_cache,
             const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ tables, const int* __restrict__ starts,
             __nv_bfloat16* __restrict__ out, int Bc, int T, int Hq, int Hk,
             int S, int max_pages, int layer, int start_arg, float scale) {
  __shared__ qie::AttnSmem<D, kRows, kKeys, KV> sm;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int n_rows = min(kRows, T - q0);
  const int start = starts == nullptr ? start_arg : starts[b];

  for (int c = tid; c < kRows * D; c += D) {
    const int i = c / D, d = c % D;
    float val = 0.f;
    if (i < n_rows) {
      val = __bfloat162float(
          q[((static_cast<long long>(b) * T + q0 + i) * Hq + h) * D + d]) * scale;
    }
    sm.q[i][d] = val;
  }
  // row i sits at position start + q0 + i and sees keys [0, that position]
  int n_keys = max(0, start + q0 + n_rows);
  float acc[kRows];
  if constexpr (kPaged) {
    // bucket padding may run past the table's last page: those rows see
    // the whole table (as the TPU kernel's grid walks only the table)
    n_keys = min(n_keys, max_pages * S);
    // page 0 of (layer, hk); the row's table picks each key's page
    const long long sbase =
        (static_cast<long long>(layer) * Bc * Hk + hk) * static_cast<long long>(S);
    const long long base = sbase * D;
    const qie::PagedKeys keys{tables + static_cast<long long>(b) * max_pages,
                              S, D, static_cast<long long>(Hk) * S * D,
                              static_cast<long long>(Hk) * S};
    const float* ks = k_scale == nullptr ? nullptr : k_scale + sbase;
    const float* vs = v_scale == nullptr ? nullptr : v_scale + sbase;
    qie::attend<D, kRows, kKeys, KV>(sm, acc, n_rows, k_cache + base,
                                     v_cache + base, keys, ks, vs, n_keys,
                                     start + q0, 1, nullptr, nullptr, -1);
  } else {
    n_keys = min(n_keys, S);
    const long long row = (static_cast<long long>(layer) * Bc + b) * Hk + hk;
    const long long base = row * S * D;
    const float* ks = k_scale == nullptr ? nullptr : k_scale + row * S;
    const float* vs = v_scale == nullptr ? nullptr : v_scale + row * S;
    qie::attend<D, kRows, kKeys, KV>(sm, acc, n_rows, k_cache + base,
                                     v_cache + base, qie::ContiguousKeys{D},
                                     ks, vs, n_keys, start + q0, 1, nullptr,
                                     nullptr, -1);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < n_rows) {
      const float denom = fmaxf(sm.l[i], 1e-30f);
      out[((static_cast<long long>(b) * T + q0 + i) * Hq + h) * D + tid] =
          __float2bfloat16(acc[i] / denom);
    }
  }
}

template <typename KV, bool kPaged>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* starts, void* out, int Bc, int B, int T, int Hq,
           int Hk, int S, int max_pages, int D, int layer, int start,
           float scale, void* stream) {
  dim3 grid((T + kRows - 1) / kRows, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kc = static_cast<const KV*>(k_cache);
  const auto* vc = static_cast<const KV*>(v_cache);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* tp = static_cast<const int*>(tables);
  const auto* sp = static_cast<const int*>(starts);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    chunk_kernel<128, KV, kPaged><<<grid, 128, 0, st>>>(
        qp, kc, vc, ksp, vsp, tp, sp, op, Bc, T, Hq, Hk, S, max_pages, layer,
        start, scale);
  } else if (D == 64) {
    chunk_kernel<64, KV, kPaged><<<grid, 64, 0, st>>>(
        qp, kc, vc, ksp, vsp, tp, sp, op, Bc, T, Hq, Hk, S, max_pages, layer,
        start, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k_scale / v_scale null: a bf16 cache; both given: an int8 cache.  starts
// null: every row starts at `start` (checked here); else per-row starts
// [B] int32 on the device (each row's keys clamped to the cache).
extern "C" int qie_chunk_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_scale,
                                   const void* v_scale, const void* starts,
                                   void* out, int L, int Bc, int B, int T,
                                   int Hq, int Hk, int S, int D, int layer,
                                   int start, float scale, void* stream) {
  const bool quant = k_scale != nullptr;
  if (B <= 0 || B > Bc || T <= 0 || Hk <= 0 || Hq % Hk || layer < 0 ||
      layer >= L || quant != (v_scale != nullptr) ||
      (starts == nullptr && (start < 0 || start + T > S))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (quant) {
    return launch<int8_t, false>(q, k_cache, v_cache, k_scale, v_scale,
                                 nullptr, starts, out, Bc, B, T, Hq, Hk, S, 0,
                                 D, layer, start, scale, stream);
  }
  return launch<__nv_bfloat16, false>(q, k_cache, v_cache, nullptr, nullptr,
                                      nullptr, starts, out, Bc, B, T, Hq, Hk,
                                      S, 0, D, layer, start, scale, stream);
}

// Page pool [L, P, Hk, page, D], bf16 (k_scale / v_scale null) or int8 with
// its scales [L, P, Hk, page]; every row's piece starts at `start` (a host
// int) and follows its own row of tables [B, max_pages].  The piece may end
// past the table (the scheduler pads its last piece to a bucket); it must
// start inside it.
extern "C" int qie_paged_chunk_attention(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* k_scale,
                                         const void* v_scale,
                                         const void* tables, void* out, int L,
                                         int P, int B, int T, int Hq, int Hk,
                                         int page, int max_pages, int D,
                                         int layer, int start, float scale,
                                         void* stream) {
  const bool quant = k_scale != nullptr;
  if (B <= 0 || T <= 0 || Hk <= 0 || Hq % Hk || layer < 0 || layer >= L ||
      P <= 0 || page <= 0 || page % 8 || max_pages <= 0 || start < 0 ||
      start >= max_pages * page || quant != (v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (quant) {
    return launch<int8_t, true>(q, k_pages, v_pages, k_scale, v_scale,
                                tables, nullptr, out, P, B, T, Hq, Hk, page,
                                max_pages, D, layer, start, scale, stream);
  }
  return launch<__nv_bfloat16, true>(q, k_pages, v_pages, nullptr, nullptr,
                                     tables, nullptr, out, P, B, T, Hq, Hk,
                                     page, max_pages, D, layer, start, scale,
                                     stream);
}
