// KV appends into the stacked caches, Hopper.
//
// Replaces seven kernels of qwen_inference_engine_tpu/ops/kv_append.py:
//   * kv_append_uniform (body _uniform_append_kernel): a bf16 (or f32)
//     decode append into the contiguous cache, rows [row0, row0 + Bn) at
//     one shared position (the double-pumped decode's per-half append);
//   * kv_append_all_uniform (body _append_all_kernel): every layer's fresh
//     K/V row at one shared position in one launch (the deferred-append
//     decode step writes its L layers' rows after the layer loop);
//   * kv_append_uniform_q8 (body _uniform_append_q8_kernel): INT8-KV decode
//     append into the contiguous cache, rows [row0, row0 + B) at one
//     shared position (row0: the pipeline's 1F1B microbatch window);
//   * kv_append_ragged_t (body _ragged_t_kernel): T consecutive K/V rows
//     per batch row at a per-row start into the contiguous cache (the
//     ragged decode's write at T = 1, the contiguous verify's window at
//     T = k + 1), bf16, f32 or int8 with its scales;
//   * paged_append_ragged (body _paged_ragged_kernel): one K/V row per
//     batch row into the page pool, each at its own position;
//   * paged_append_ragged_t (body _paged_ragged_t_kernel): T consecutive
//     K/V rows per batch row at a per-row start (the speculative verify's
//     window; it may straddle two pages);
//   * paged_append_prefill (body _paged_prefill_kernel): a prefill piece's
//     T K/V rows of one sequence into the page pool.
// The paged appends take a bf16 pool, or an int8 pool whose per-token f32
// scales [L, P, Hk, page] they write in the same launch (the JAX package
// runs its kernels on the int8 bytes and scatters the scales with XLA).
//
// kv_append_uniform: in place, k_new / v_new [Bn, Hk, D] into
// cache[layer, row0 + b, hk, position] of the caches [L, Bc, Hk, S, D]
// (the row's D * elem_bytes bytes; bf16 or f32), at the one position read
// on the device; a position outside [0, S) writes nothing.
// kv_append_all_uniform is the same kernel over L layers: k_new / v_new
// [L, B, Hk, D] into cache[l, b, hk, position] for every layer l and rows
// b < B.
//
// kv_append_q8: in place, int8 k_new / v_new [B, Hk, D] and f32 ks_new /
// vs_new [B, Hk] into cache[layer, b, hk, position] of the int8 caches
// [L, Bc, Hk, S, D] and the scales [L, Bc, Hk, S], for rows b < B.  Every
// row shares the one position, a 1-element int32 tensor read on the device,
// so the host never waits for it; a position outside [0, S) writes nothing.
//
// kv_append_ragged_t: in place, k_new / v_new [B, T, Hk, D] (bf16, f32 or
// int8) into cache[layer, b, hk, starts[b] + t] of the caches [L, Bc, Hk,
// S, D] for rows b < B, and for an int8 cache ks_new / vs_new [B, T, Hk]
// into the scales [L, Bc, Hk, S].  starts [B] int32 is read on the device;
// starts[b] < 0 skips row b, and a token at or past S is dropped (the JAX
// kernel never selects it: its band is clamped to the cache's end).
//
// paged_append_ragged / _ragged_t: in place, k_new / v_new [B, T, Hk, D]
// (T = 1 for the ragged decode append) into the pools [L, P, Hk, page, D]
// at positions starts[b] + t, row p % page of page tables[b, p / page];
// starts and tables are read on the device (no host sync inside a decode
// tick or a speculation round); starts[b] < 0 skips row b.
//
// paged_append_prefill: in place, k_new / v_new [T, Hk, D] at positions
// start .. start + T - 1 through tables [max_pages] (one sequence).  The
// window may cross pages; bucket padding past the allocated pages follows
// the table's zero entries onto scratch page 0, as in the JAX package.
//
// The paged appends follow the table as it is: a position whose logical
// page is past the table's width writes nothing (the JAX scatter drops
// it), and so does a page id outside [0, P).  Several rows may write the
// same scratch row in one launch (idle slots at position 0 of page 0): a
// benign race, never read back.
//
// What bounds them on the H100: kv_append_uniform moves 2 * Bn * Hk * D
// elements in and as many out (196 KB each way for a Qwen2.5-7B half batch
// of 96 rows in bf16); kv_append_all_uniform L times that for a whole batch
// (28 layers x 192 rows: 11 MB each way, 3.3 us at 3.35 TB/s: the one
// append that bytes, not the launch, could bound); kv_append_q8 moves
// 2 * B * Hk * (D + 4) bytes in and as many out (4.2 KB at B=4 for
// Qwen2.5-7B); kv_append_ragged_t 2 * B * T * Hk * D elements each way (8 KB
// at B = 4, T = 1 in bf16; 40 KB for a verify window of 5); the ragged
// paged append 2 * 2 * B * Hk * D bytes each way (16 KB at 8 slots, 8 KB +
// 256 B of scales int8); the verify window T times that (80 KB at T = 5);
// the prefill append 2 * 2 * T * Hk * D bytes each way (512 KB at T=256):
// a few nanoseconds to a few microseconds at 3.35 TB/s.  So the launch
// itself (a few microseconds) bounds every one of them but the 28-layer
// append in practice, and after the launch the chain of dependent loads a
// thread waits on before it can store: one (the position or the row's
// start) for the uniform appends and the contiguous row appends, two (the
// row's start, then its page id) for the paged decode and verify appends,
// one (the page id) for the prefill append, whose start the host gives.
//
// The file holds two kernels.
// kv_append_uniform_kernel, the uniform bf16 / f32 copy (kv_append_uniform
// and kv_append_all_uniform): threads walk a flat index over (layer, row,
// KV head, vector of the head row) with a grid-stride loop, each moving
// one vector of K and one of V: 16 bytes (uint4) where the row's bytes and
// the four base pointers are 16-byte aligned, else 4-byte words (the
// launcher picks the width from the operands; the copy is the same bits
// either way).  Blocks of 256 threads, at most 8 for each SM (a full SM
// each, read from the device at launch), so on the H100's 132 SMs the
// all-layer append at 28 x 192 rows (344064 vectors of 16 bytes) runs 1056
// blocks whose threads move one or two vectors each; each block reads the
// position once.
// append_rows_kernel<V, Layout>, the row copy (the other five appends):
// one thread a vector of one (row b, token t, KV head) head row over a
// flat index of B * T * Hk * W vectors, no loop: 16 bytes (uint4) where
// the row's bytes and the four data pointers are 16-byte aligned, else
// 4-byte words, as ops/kv_append.plan_paged_append plans it and the
// launcher checks (W = 16 vectors for a bf16 head row of D 128, 8 for
// int8 D 128 or bf16 D 64, 32 for f32 D 128).  Every token of a window
// runs in parallel; the layout resolves where token t of row b lands from
// the row's start p0 (p = p0 + t):
//   * PagedRows (the three paged appends): row p % page of page
//     tables[b, p / page] of pools[layer] [P, Hk, page], so a window may
//     span any number of pages;
//   * ContiguousRows (kv_append_ragged_t, kv_append_uniform_q8): row
//     ((layer Bc + row0 + b) Hk + hk) S + p of the caches [L, Bc, Hk, S]
//     (row0 0 for kv_append_ragged_t); a token at or past S writes nothing.  The start is starts[b * stride]:
//     stride 1 for kv_append_ragged_t's per-row starts, 0 for
//     kv_append_uniform_q8's one shared position (T = 1), so every row
//     reads the same element.
// The vector-0 thread of an int8 row also moves its two scales, indexed by
// the same row.  A thread loads its source vectors (and those scales)
// first, as they do not depend on the position, then the row's start,
// then (paged) the page id, so one dependent load (two for the paged
// decode and verify, one for the prefill, whose start the host gives)
// stands between the launch and the stores, with the data loads already
// in flight beside it; its divisions (by Hk W, W,
// T and the page) are multiply-highs by constants the launcher computes
// (FastDiv), a few cycles each on that chain, where a runtime division
// costs dozens.  Blocks of 128 threads: a 256-token prefill piece of the
// 7B (16384 vectors in bf16) spreads over 128 of the 132 SMs in one wave,
// where 256 would use 64 (on the H100 the two time the same: the launch
// and the loads, not the SMs, set the time); the serving decode's 8 slots
// take 4 blocks, the 7B ragged decode's 4 rows 2, its verify window of 5
// 10, and the INT8 uniform append at B 4 one.
// The TPU kernels read and wrote back whole bands, tiles or pages (an
// 8-row bf16 band, a 32-row int8 band, a 128-lane scale tile, a [Hk, page,
// D] page block for the prefill append) because their memory moves in
// (8/32, 128) tiles, and the all-layer append double-buffers those bands
// across layers; that is tiling, not semantics: here only the rows being
// appended are written, bit for bit, and nothing else of the cache is
// touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAppendThreads = 256;  // the uniform appends' block
constexpr int kAppendBlocksPerSm = 8;  // 2048 threads on each SM
constexpr int kRowThreads = 128;  // the row appends' block

// The uniform appends: vector i of the flat source [n_layers, Bn, Hk, W]
// (W vectors V a head row) of k_new / v_new goes to vector i % W of row
// (layer0 + l, row0 + b, hk) at `position` of the caches [L, Bc, Hk, S, W].
// With r = i / W = (l Bn + b) Hk + hk, that cache row is
// (layer0 Bc + row0) Hk + r + l (Bc - Bn) Hk, l = r / (Bn Hk).
template <typename V>
__global__ void __launch_bounds__(kAppendThreads)
kv_append_uniform_kernel(V* __restrict__ k_cache, V* __restrict__ v_cache,
                         const V* __restrict__ k_new,
                         const V* __restrict__ v_new,
                         const int* __restrict__ position_ptr, int Bc, int Bn,
                         int Hk, int S, unsigned W, int layer0, int row0,
                         unsigned total) {
  __shared__ int position;
  if (threadIdx.x == 0) position = *position_ptr;
  __syncthreads();
  if (position < 0 || position >= S) return;
  const unsigned rows_a_layer = static_cast<unsigned>(Bn) * Hk;
  const long long base = (static_cast<long long>(layer0) * Bc + row0) * Hk;
  const long long gap = static_cast<long long>(Bc - Bn) * Hk;
  for (unsigned i = blockIdx.x * kAppendThreads + threadIdx.x; i < total;
       i += gridDim.x * kAppendThreads) {
    const unsigned r = i / W;
    const long long row = base + r + (r / rows_a_layer) * gap;
    const long long dst = (row * S + position) * W + (i - r * W);
    k_cache[dst] = k_new[i];
    v_cache[dst] = v_new[i];
  }
}

// Division of n < 2^31 by a divisor 1 <= d < 2^31 fixed at launch, as a
// multiply-high and a shift (Granlund and Montgomery: mul = ceil(2^(31 +
// l) / d), l = ceil(log2 d), exact for every such n), so each step of an
// index chain costs a few cycles where a division costs dozens.
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv fast_div(unsigned d) {
  if (d == 1) return {1, 0, 0};
  const unsigned l = 32 - __builtin_clz(d - 1);
  const unsigned long long p = 31ull + l;
  return {d, static_cast<unsigned>(((1ull << p) + d - 1) / d),
          static_cast<unsigned>(p - 32)};
}

__device__ __forceinline__ unsigned quot(unsigned n, FastDiv f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

// The row appends' two layouts.  start_at(b) is the element of `starts`
// row b reads; row(b, t, hk, Hk, p0, &out) puts in `out` the head row that
// token t of row b, KV head hk, lands in from the row's start p0 >= 0 (p =
// p0 + t), counted in head rows from the destination's base, and returns
// false where it writes nothing.  (The early returns, and by_page ahead of
// the table pointer, keep the paged instances at the 24 registers of the
// kernel they replaced; a -1 sentinel took 22 / 26.)

// The page pools [L, P, Hk, page]: row p % page of page tables[b, p /
// page] of pools[layer]; nothing past the table's width or for a page id
// outside [0, P).
struct PagedRows {
  FastDiv by_page;
  const int* tables;
  int P, max_pages, layer;

  __device__ __forceinline__ unsigned start_at(unsigned b) const { return b; }

  __device__ __forceinline__ bool row(unsigned b, unsigned t, unsigned hk,
                                      int Hk, unsigned p0,
                                      long long* out) const {
    // p = lp page + slot; s < page + T < 2^31
    const unsigned q0 = quot(p0, by_page);
    const unsigned s = p0 - q0 * by_page.d + t;
    const unsigned sq = quot(s, by_page);
    const unsigned lp = q0 + sq;
    if (lp >= static_cast<unsigned>(max_pages)) return false;  // past it
    const unsigned slot = s - sq * by_page.d;
    const int pg = __ldg(tables + static_cast<long long>(b) * max_pages + lp);
    if (pg < 0 || pg >= P) return false;
    *out = ((static_cast<long long>(layer) * P + pg) * Hk + hk) * by_page.d +
           slot;
    return true;
  }
};

// The contiguous caches [L, Bc, Hk, S]: row ((layer Bc + row0 + b) Hk + hk)
// S + p, batch row b landing in cache row row0 + b (the TPU kernels' row0:
// the pipeline's 1F1B decode writes one microbatch's window [row0, row0 +
// B) of the whole cache in place); nothing at or past S.  The start is
// starts[b * stride].
struct ContiguousRows {
  int Bc, S, layer, row0;
  unsigned stride;

  __device__ __forceinline__ unsigned start_at(unsigned b) const {
    return b * stride;
  }

  __device__ __forceinline__ bool row(unsigned b, unsigned t, unsigned hk,
                                      int Hk, unsigned p0,
                                      long long* out) const {
    const unsigned p = p0 + t;  // p0 < 2^31, t < 2^16: no wrap
    if (p >= static_cast<unsigned>(S)) return false;
    *out = ((static_cast<long long>(layer) * Bc + row0 + b) * Hk + hk) * S +
           p;
    return true;
  }
};

// The row appends: vector i of the flat source [B, T, Hk, W] (W vectors V
// a head row) of k_new / v_new goes to vector w of the head row that
// layout.row(b, t, hk, ...) gives, from p0 = starts[layout.start_at(b)]
// (the paged prefill: starts null, p0 = start); i = (b T + t) Hk W + hk W
// + w.  The source vectors (and an int8 row's two scales, loaded by its
// vector 0) are loaded first, as they do not depend on the position; then
// the start, then whatever the layout loads: the data loads are already
// in flight, and two divisions (by Hk W, then T) come before the start.
template <typename V, typename Layout>
__global__ void __launch_bounds__(kRowThreads)
append_rows_kernel(V* __restrict__ k_dst, V* __restrict__ v_dst,
                   float* __restrict__ k_scale, float* __restrict__ v_scale,
                   const V* __restrict__ k_new, const V* __restrict__ v_new,
                   const float* __restrict__ ks_new,
                   const float* __restrict__ vs_new,
                   const int* __restrict__ starts, int start, Layout layout,
                   int Hk, FastDiv by_vt, FastDiv by_w, FastDiv by_t,
                   unsigned total) {
  const unsigned i = blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= total) return;
  const V k = k_new[i];
  const V v = v_new[i];
  const unsigned bt = quot(i, by_vt);  // the token b T + t
  const unsigned b = quot(bt, by_t);
  const unsigned j = i - bt * by_vt.d;  // its vector hk W + w
  const unsigned hk = quot(j, by_w);
  const unsigned w = j - hk * by_w.d;
  const bool scales = k_scale != nullptr && w == 0;
  float ks = 0.f, vs = 0.f;
  if (scales) {
    ks = ks_new[bt * Hk + hk];
    vs = vs_new[bt * Hk + hk];
  }
  const int p0 = starts != nullptr ? __ldg(starts + layout.start_at(b))
                                   : start;
  if (p0 < 0) return;  // a skipped row
  long long row;
  if (!layout.row(b, bt - b * by_t.d, hk, Hk, static_cast<unsigned>(p0),
                  &row)) {
    return;
  }
  k_dst[row * by_w.d + w] = k;
  v_dst[row * by_w.d + w] = v;
  if (scales) {
    k_scale[row] = ks;
    v_scale[row] = vs;
  }
}

}  // namespace

template <typename V>
static void launch_uniform_as(int blocks, cudaStream_t st, void* k_cache,
                              void* v_cache, const void* k_new,
                              const void* v_new, const void* position, int Bc,
                              int Bn, int Hk, int S, unsigned W, int layer0,
                              int row0, unsigned total) {
  kv_append_uniform_kernel<V><<<blocks, kAppendThreads, 0, st>>>(
      static_cast<V*>(k_cache), static_cast<V*>(v_cache),
      static_cast<const V*>(k_new), static_cast<const V*>(v_new),
      static_cast<const int*>(position), Bc, Bn, Hk, S, W, layer0, row0,
      total);
}

// kv_append_uniform (n_layers = 1 from `layer`) and kv_append_all_uniform
// (n_layers = L from layer 0, row0 = 0) share the kernel: 16-byte vectors
// where the row and all four operands allow them, else 4-byte words.
static int launch_uniform(void* k_cache, void* v_cache, const void* k_new,
                          const void* v_new, const void* position, int L,
                          int Bc, int Bn, int Hk, int S, int D,
                          int elem_bytes, int layer0, int n_layers, int row0,
                          void* stream) {
  const long long row_bytes = static_cast<long long>(D) * elem_bytes;
  if (Bn <= 0 || row0 < 0 || row0 + Bn > Bc || Hk <= 0 || D <= 0 ||
      elem_bytes <= 0 || row_bytes % 4 || S <= 0 || layer0 < 0 ||
      n_layers <= 0 || layer0 + n_layers > L ||
      static_cast<long long>(n_layers) * Bn * Hk * (row_bytes / 4) >
          0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide =
      row_bytes % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(k_cache) |
       reinterpret_cast<uintptr_t>(v_cache) |
       reinterpret_cast<uintptr_t>(k_new) |
       reinterpret_cast<uintptr_t>(v_new)) % 16 == 0;
  const unsigned W = static_cast<unsigned>(row_bytes / (wide ? 16 : 4));
  const unsigned total =
      static_cast<unsigned>(static_cast<long long>(n_layers) * Bn * Hk * W);
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long want = (total + kAppendThreads - 1) / kAppendThreads;
  const long long most = static_cast<long long>(sms) * kAppendBlocksPerSm;
  const int blocks = static_cast<int>(want < most ? want : most);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    launch_uniform_as<uint4>(blocks, st, k_cache, v_cache, k_new, v_new,
                             position, Bc, Bn, Hk, S, W, layer0, row0, total);
  } else {
    launch_uniform_as<unsigned>(blocks, st, k_cache, v_cache, k_new, v_new,
                                position, Bc, Bn, Hk, S, W, layer0, row0,
                                total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qie_kv_append_uniform(void* k_cache, void* v_cache,
                                     const void* k_new, const void* v_new,
                                     const void* position, int L, int Bc,
                                     int Bn, int Hk, int S, int D,
                                     int elem_bytes, int layer, int row0,
                                     void* stream) {
  return launch_uniform(k_cache, v_cache, k_new, v_new, position, L, Bc, Bn,
                        Hk, S, D, elem_bytes, layer, 1, row0, stream);
}

extern "C" int qie_kv_append_all_uniform(void* k_cache, void* v_cache,
                                         const void* k_new, const void* v_new,
                                         const void* position, int L, int Bc,
                                         int B, int Hk, int S, int D,
                                         int elem_bytes, void* stream) {
  return launch_uniform(k_cache, v_cache, k_new, v_new, position, L, Bc, B,
                        Hk, S, D, elem_bytes, 0, L, 0, stream);
}

// k_scale / v_scale / ks_new / vs_new: all null for a bf16 (f32) cache or
// pool, all given for an int8 one.
static bool quant_args(const void* a, const void* b, const void* c,
                       const void* d, bool* quant) {
  *quant = a != nullptr;
  return (b != nullptr) == *quant && (c != nullptr) == *quant &&
         (d != nullptr) == *quant;
}

template <typename V, typename Layout>
static void launch_rows_as(int blocks, cudaStream_t st, void* k_dst,
                           void* v_dst, void* k_scale, void* v_scale,
                           const void* k_new, const void* v_new,
                           const void* ks_new, const void* vs_new,
                           const void* starts, int start, Layout layout,
                           int Hk, int T, unsigned W, unsigned total) {
  append_rows_kernel<V, Layout><<<blocks, kRowThreads, 0, st>>>(
      static_cast<V*>(k_dst), static_cast<V*>(v_dst),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const V*>(k_new), static_cast<const V*>(v_new),
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      static_cast<const int*>(starts), start, layout, Hk,
      fast_div(Hk * W), fast_div(W), fast_div(T), total);
}

// The row appends' plan (ops/kv_append.plan_paged_append), checked against
// the shapes: `vec` bytes a thread, 16 or 4, dividing the head row of
// `row_bytes` and every data pointer; blocks of kRowThreads covering the
// B * T * Hk head rows' vectors once, fewer than 2^31.  The scale pointers
// are f32.
template <typename Layout>
static int launch_rows(long long row_bytes, void* k_dst, void* v_dst,
                       void* k_scale, void* v_scale, const void* k_new,
                       const void* v_new, const void* ks_new,
                       const void* vs_new, const void* starts, int start,
                       Layout layout, int B, int T, int Hk, int vec,
                       int threads, int blocks, void* stream) {
  if (vec != 16 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(B) * T * Hk * (row_bytes / vec);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(k_dst) |
                         reinterpret_cast<uintptr_t>(v_dst) |
                         reinterpret_cast<uintptr_t>(k_new) |
                         reinterpret_cast<uintptr_t>(v_new);
  if (row_bytes % vec || ptrs % vec || threads != kRowThreads ||
      total > 0x7fffffffll || blocks <= 0 ||
      static_cast<long long>(blocks - 1) * threads >= total ||
      static_cast<long long>(blocks) * threads < total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned W = static_cast<unsigned>(row_bytes / vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16) {
    launch_rows_as<uint4>(blocks, st, k_dst, v_dst, k_scale, v_scale, k_new,
                          v_new, ks_new, vs_new, starts, start, layout, Hk, T,
                          W, static_cast<unsigned>(total));
  } else {
    launch_rows_as<unsigned>(blocks, st, k_dst, v_dst, k_scale, v_scale,
                             k_new, v_new, ks_new, vs_new, starts, start,
                             layout, Hk, T, W, static_cast<unsigned>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

// kv_append_ragged_t: the scale pointers all null for a bf16 or f32
// cache, all given for an int8 one (elem_bytes 1); row b reads starts[b].
extern "C" int qie_kv_append_ragged_t(
    void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, const void* starts, int L, int Bc, int B, int T,
    int Hk, int S, int D, int elem_bytes, int layer, int vec, int threads,
    int blocks, void* stream) {
  bool quant;
  if (!quant_args(k_scale, v_scale, ks_new, vs_new, &quant) ||
      (quant && elem_bytes != 1) || B <= 0 || B > 65535 || B > Bc ||
      T <= 0 || T > 65535 || Hk <= 0 || D <= 0 || elem_bytes <= 0 ||
      S <= 0 || layer < 0 || layer >= L || starts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(static_cast<long long>(D) * elem_bytes, k_cache, v_cache,
                     k_scale, v_scale, k_new, v_new, ks_new, vs_new, starts,
                     0, ContiguousRows{Bc, S, layer, 0, 1u}, B, T, Hk, vec,
                     threads, blocks, stream);
}

// kv_append_uniform_q8: int8 rows and their f32 scales, every row at the
// one position (starts[0]: stride 0, one token a row), into cache rows
// [row0, row0 + B).
extern "C" int qie_kv_append_q8(void* k_cache, void* v_cache, void* k_scale,
                                void* v_scale, const void* k_new,
                                const void* v_new, const void* ks_new,
                                const void* vs_new, const void* position,
                                int L, int Bc, int B, int Hk, int S, int D,
                                int layer, int row0, int vec, int threads,
                                int blocks, void* stream) {
  bool quant;
  if (!quant_args(k_scale, v_scale, ks_new, vs_new, &quant) || !quant ||
      B <= 0 || row0 < 0 || row0 > Bc - B || Hk <= 0 || D <= 0 ||
      D > 1024 || S <= 0 || layer < 0 || layer >= L || position == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(D, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                     ks_new, vs_new, position, 0,
                     ContiguousRows{Bc, S, layer, row0, 0u}, B, 1, Hk, vec,
                     threads, blocks, stream);
}

// The paged appends: int8 pools take their scales; pages of at most 2^30
// tokens keep the kernel's index arithmetic in 32 bits.
static int launch_paged(bool quant, void* k_pages, void* v_pages,
                        void* k_scale, void* v_scale, const void* k_new,
                        const void* v_new, const void* ks_new,
                        const void* vs_new, const void* starts,
                        const void* tables, int start, int P, int B, int T,
                        int Hk, int page, int D, int max_pages, int layer,
                        int vec, int threads, int blocks, void* stream) {
  if (page > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows layout{fast_div(page), static_cast<const int*>(tables), P,
                         max_pages, layer};
  return launch_rows(D * (quant ? 1 : 2), k_pages, v_pages, k_scale, v_scale,
                     k_new, v_new, ks_new, vs_new, starts, start, layout, B,
                     T, Hk, vec, threads, blocks, stream);
}

// paged_append_ragged (T = 1) and paged_append_ragged_t (the verify
// window, any T: each token finds its own page, so a window may span
// several) through tables [B, max_pages] at the device's starts [B].
extern "C" int qie_paged_append_ragged_t(
    void* k_pages, void* v_pages, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, const void* starts, const void* tables, int L, int P,
    int B, int T, int Hk, int page, int D, int max_pages, int layer, int vec,
    int threads, int blocks, void* stream) {
  bool quant;
  if (!quant_args(k_scale, v_scale, ks_new, vs_new, &quant) || B <= 0 ||
      B > 65535 || T <= 0 || Hk <= 0 || D <= 0 || D > 1024 || P <= 0 ||
      page <= 0 || max_pages <= 0 || layer < 0 || layer >= L ||
      starts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_paged(quant, k_pages, v_pages, k_scale, v_scale, k_new,
                      v_new, ks_new, vs_new, starts, tables, 0, P, B, T, Hk,
                      page, D, max_pages, layer, vec, threads, blocks,
                      stream);
}

// paged_append_prefill: one sequence's T tokens from the host's `start`
// through table [max_pages].
extern "C" int qie_paged_append_prefill(
    void* k_pages, void* v_pages, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, const void* table, int L, int P, int T, int Hk,
    int page, int D, int max_pages, int layer, int start, int vec,
    int threads, int blocks, void* stream) {
  bool quant;
  if (!quant_args(k_scale, v_scale, ks_new, vs_new, &quant) || T <= 0 ||
      T > 65535 || Hk <= 0 || D <= 0 || D > 1024 || P <= 0 || page <= 0 ||
      max_pages <= 0 || layer < 0 || layer >= L || start < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_paged(quant, k_pages, v_pages, k_scale, v_scale, k_new,
                      v_new, ks_new, vs_new, nullptr, table, start, P, 1, T,
                      Hk, page, D, max_pages, layer, vec, threads, blocks,
                      stream);
}
