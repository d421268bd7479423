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
//
// q [B, T, Hq, D] bf16: the chunk's queries at absolute positions
// [start, start + T); the cache holds the chunk's own keys already
// written; scales [L, Bc, Hk, S] or [L, P, Hk, page] f32 (int8 only); out
// [B, T, Hq, D] bf16.  `start` is a host int shared by every row, or, for
// the contiguous cache, a [B] int32 device tensor of per-row starts (the
// fixed-batch speculative verify: each row at its own length), read by the
// kernel so the host never waits for it; a row's keys are clamped to the
// cache.  Query t attends keys [0, start + t], f32 online softmax; scores
// never leave registers or shared memory.  int8 scores are
// (q . k_i8) * k_scale * D^-1/2, and the values are the int8 ones times
// their V scales (the TPU kernel folds the V scale into the probabilities;
// attention_mma.cuh says why the contiguous kernels do not).
//
// What bounds it on the H100: at B=4, T=512, start=1536 for Qwen2.5-7B a
// layer reads 2 * B * Hk * (start + T) * D elements of cache (16.8 MB bf16,
// 8.4 MB int8) for 4 * B * Hq * D * (T * start + T * (T + 1) / 2) = 52.6
// GFLOP: ~3,100 (bf16) or ~6,200 (int8) operations per byte, far above the
// ridge (~295), so the tensor cores bound it (53 us at 989 TFLOP/s).  The
// serving piece (B=1, T=256) is bound the same way; the speculative verify
// (T = k + 1 <= 17) is bound by bytes, as decode is.
//
// Both kernels (chunk_mma_kernel over the contiguous cache,
// paged_chunk_mma_kernel over the page pool) run on the tensor-core core
// of attention_mma.cuh, one block body (attend_gqa_block) with the key
// addressing as its policy:
//   * GQA-packed rows: a block takes 64 flattened query rows r = t * G + g
//     of ONE KV head (query head hk * G + g, token t), so each K/V tile is
//     staged once for all G heads of its group (the TPU kernel's T * G8
//     rows per dot, without padding G to 8); row r sees keys up to
//     start + r / G.  Grid: KV heads x batch rows x ceil(T * G / 64) row
//     tiles, the tiles with later tokens (more keys) launched first.
//   * Both products on mma.sync.m16n8k16 (bf16 -> f32), fragments by
//     ldmatrix / ldmatrix.trans from padded shared rows; the softmax in
//     registers; P cast to bf16 in registers as the A operand of P V.
//   * K/V tiles of 64 keys staged by cp.async in a ring of two stages; an
//     int8 tile raw (half the bytes), widened to bf16 in shared memory.
//   * Only tiles that cross a warp's first row's limit take the element
//     mask; none past the block's last row's limit is loaded.
//   * The verify (T <= 17) runs B * Hk * ceil(T * G / 64) blocks (16 at
//     B = 4, T = 5 for the 7B; 32 at T = 16), each streaming its row's
//     keys; no key split.
//   * Paged (the serving scheduler's pieces after a prompt's first): keys
//     through PagedKeys, each 16-byte chunk of a tile resolving its own
//     page tables[b, j / page], so a tile may span pages of any multiple
//     of 8 tokens and a piece may start mid-page; an int8 pool's scales
//     [L, P, Hk, page] through PagedKeys::scale.  The TPU kernel's grid
//     axis over pages, with its running sums carried in VMEM across grid
//     steps, is the loop over 64-key tiles inside attend_mma.  A bucket-
//     padded last piece may run past the table (S = max_pages * page
//     keys): its rows there see all S keys, as in the TPU kernel, and no
//     key at or past S is loaded.  No key split: a block does the
//     arithmetic of the contiguous kernel's block at the same start, so
//     through identity tables over a pool that holds a contiguous cache's
//     rows the two give the same bits.  The launch reads nothing back from
//     the device, so it is capturable in a CUDA graph.
// Any T >= 1 is taken (the ragged edge is masked in the kernels); the
// wrappers limit T to the engine's chunk of 512.

#include "attention_mma.cuh"

namespace {

// One block: kGqaRows packed rows r = t * G + g of KV head blockIdx.x,
// batch row blockIdx.y (attend_gqa_block); starts: per-row starts on the
// device, or null for the host `start`.
template <int D, typename KV>
__global__ void __launch_bounds__(32 * qie::kGqaWarps, 2)
chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const KV* __restrict__ k_cache,
                 const KV* __restrict__ v_cache,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ starts,
                 __nv_bfloat16* __restrict__ out, int Bc, int T, int Hq,
                 int Hk, int S, int layer, int start_arg, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<qie::MmaSmem<D, qie::kGqaWarps, KV>*>(smem_raw);
  const int b = blockIdx.y;
  const long long row =
      (static_cast<long long>(layer) * Bc + b) * Hk + blockIdx.x;
  qie::attend_gqa_block<D, KV>(
      sm, q, out, k_cache + row * S * D, v_cache + row * S * D,
      qie::ContiguousKeys{D}, k_scale == nullptr ? nullptr : k_scale + row * S,
      v_scale == nullptr ? nullptr : v_scale + row * S, T, Hq, Hk, S,
      starts == nullptr ? start_arg : starts[b], scale);
}

template <int D, typename KV>
int launch_contiguous(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* starts, void* out, int Bc, int B, int T,
                      int Hq, int Hk, int S, int layer, int start,
                      float scale, cudaStream_t st) {
  return qie::launch_gqa<D, KV>(
      chunk_mma_kernel<D, KV>, B, T, Hq, Hk, st,
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k_cache),
      static_cast<const KV*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(starts),
      static_cast<__nv_bfloat16*>(out), Bc, T, Hq, Hk, S, layer, start,
      scale);
}

// One block: kGqaRows packed rows of KV head blockIdx.x, batch row
// blockIdx.y (attend_gqa_block) over the page pool [L, P, Hk, page, D]
// through row b of tables [B, max_pages]; every row's piece starts at
// `start`.
template <int D, typename KV>
__global__ void __launch_bounds__(32 * qie::kGqaWarps, 2)
paged_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       __nv_bfloat16* __restrict__ out, int P, int T, int Hq,
                       int Hk, int page, int max_pages, int layer, int start,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<qie::MmaSmem<D, qie::kGqaWarps, KV>*>(smem_raw);
  // page 0 of (layer, hk); the row's table picks each key's page
  const long long sbase =
      (static_cast<long long>(layer) * P * Hk + blockIdx.x) * page;
  const long long base = sbase * D;
  qie::attend_gqa_block<D, KV>(
      sm, q, out, k_pages + base, v_pages + base,
      qie::PagedKeys{tables + static_cast<long long>(blockIdx.y) * max_pages,
                     page, D, static_cast<long long>(Hk) * page * D,
                     static_cast<long long>(Hk) * page},
      k_scale == nullptr ? nullptr : k_scale + sbase,
      v_scale == nullptr ? nullptr : v_scale + sbase, T, Hq, Hk,
      max_pages * page, start, scale);
}

template <int D, typename KV>
int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                 const void* k_scale, const void* v_scale, const void* tables,
                 void* out, int P, int B, int T, int Hq, int Hk, int page,
                 int max_pages, int layer, int start, float scale,
                 cudaStream_t st) {
  return qie::launch_gqa<D, KV>(
      paged_chunk_mma_kernel<D, KV>, B, T, Hq, Hk, st,
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<__nv_bfloat16*>(out), P, T, Hq, Hk, page, max_pages, layer,
      start, scale);
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
  // cp.async copies 16-byte chunks of q and of the cache rows
  const bool aligned = (reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k_cache) |
                        reinterpret_cast<uintptr_t>(v_cache)) % 16 == 0;
  if (B <= 0 || B > Bc || T <= 0 || Hk <= 0 || Hq % Hk || layer < 0 ||
      layer >= L || quant != (v_scale != nullptr) ||
      (starts == nullptr && (start < 0 || start + T > S)) ||
      (D != 64 && D != 128) || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant) {
    return D == 128
        ? launch_contiguous<128, int8_t>(q, k_cache, v_cache, k_scale,
                                         v_scale, starts, out, Bc, B, T, Hq,
                                         Hk, S, layer, start, scale, st)
        : launch_contiguous<64, int8_t>(q, k_cache, v_cache, k_scale,
                                        v_scale, starts, out, Bc, B, T, Hq,
                                        Hk, S, layer, start, scale, st);
  }
  return D == 128
      ? launch_contiguous<128, __nv_bfloat16>(q, k_cache, v_cache, nullptr,
                                              nullptr, starts, out, Bc, B, T,
                                              Hq, Hk, S, layer, start, scale,
                                              st)
      : launch_contiguous<64, __nv_bfloat16>(q, k_cache, v_cache, nullptr,
                                             nullptr, starts, out, Bc, B, T,
                                             Hq, Hk, S, layer, start, scale,
                                             st);
}

// Page pool [L, P, Hk, page, D], bf16 (k_scale / v_scale null) or int8 with
// its scales [L, P, Hk, page]; every row's piece starts at `start` (a host
// int) and follows its own row of tables [B, max_pages].  The piece may end
// past the table (the scheduler pads its last piece to a bucket); it must
// start inside it.  cp.async copies 16-byte chunks of q and the pools and
// 4-byte scales.
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
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(k_scale) |
       reinterpret_cast<uintptr_t>(v_scale)) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (B <= 0 || B > 65535 || T <= 0 || Hk <= 0 || Hq % Hk || layer < 0 ||
      layer >= L || P <= 0 || page <= 0 || page % 8 || max_pages <= 0 ||
      start < 0 || start >= max_pages * page ||
      quant != (v_scale != nullptr) || (D != 64 && D != 128) ||
      tables == nullptr || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant) {
    return D == 128
        ? launch_paged<128, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                    tables, out, P, B, T, Hq, Hk, page,
                                    max_pages, layer, start, scale, st)
        : launch_paged<64, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                   tables, out, P, B, T, Hq, Hk, page,
                                   max_pages, layer, start, scale, st);
  }
  return D == 128
      ? launch_paged<128, __nv_bfloat16>(q, k_pages, v_pages, nullptr,
                                         nullptr, tables, out, P, B, T, Hq,
                                         Hk, page, max_pages, layer, start,
                                         scale, st)
      : launch_paged<64, __nv_bfloat16>(q, k_pages, v_pages, nullptr,
                                        nullptr, tables, out, P, B, T, Hq,
                                        Hk, page, max_pages, layer, start,
                                        scale, st);
}
