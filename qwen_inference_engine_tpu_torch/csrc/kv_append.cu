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
//     append into the contiguous cache;
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
// int8, copied as 32-bit words) into cache[layer, b, hk, starts[b] + t] of
// the caches [L, Bc, Hk, S, D] for rows b < B, and for an int8 cache ks_new
// / vs_new [B, T, Hk] into the scales [L, Bc, Hk, S].  starts [B] int32 is
// read on the device; starts[b] < 0 skips row b, and a token at or past S
// is dropped (the JAX kernel never selects it: its band is clamped to the
// cache's end).
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
// a few nanoseconds to a few microseconds at 3.35 TB/s, so the launch
// itself (a few microseconds) bounds them in practice, and after it, for
// the paged appends, the chain of dependent loads a thread waits on
// before it can store (the row's start, then its page id).
//
// Design of the two uniform appends: one kernel, whose threads walk a flat
// index over (layer, row, KV head, vector of the head row) with a
// grid-stride loop, each moving one vector of K and one of V: 16 bytes
// (uint4) where the row's bytes and the four base pointers are 16-byte
// aligned, else 4-byte words (the launcher picks the width from the
// operands; the copy is the same bits either way).  Blocks of 256
// threads, at most 8 for each SM (a full SM each, read from the device at
// launch), so on the H100's 132 SMs the all-layer append at 28 x 192 rows
// (344064 vectors of 16 bytes) runs 1056 blocks whose threads move one
// or two vectors each; each block reads the position once.
// Design of the three paged appends: one kernel, paged_append_kernel<V>,
// one thread a vector of one (row b, token t, KV head) head row over a
// flat index of B * T * Hk * W vectors, no loop: 16 bytes (uint4) where
// the row's bytes and the four data pointers are 16-byte aligned, else
// 4-byte words, as ops/kv_append.plan_paged_append plans it and the
// launcher checks (W = 16 vectors for a bf16 head row of D 128, 8 for
// int8 D 128 or bf16 D 64).  Every token of a verify window runs in
// parallel and resolves its own page, so a window may span any number of
// pages; the vector-0 thread of an int8 row also moves its two scales.
// A thread loads its source vectors first, then the row's start, then the
// page id, so only two loads (one for the prefill's host start) stand
// between the launch and the stores, and the data loads are already in
// flight beside them; its divisions (by Hk W, W, T and the page) are
// multiply-highs by constants the launcher computes (FastDiv), a few
// cycles each on that chain, where a runtime division costs dozens.
// Blocks of 128 threads: a 256-token prefill piece of the 7B (16384
// vectors in bf16) spreads over 128 of the 132 SMs in one wave, where 256
// would use 64 (on the H100 the two time the same: the launch and the
// loads, not the SMs, set the time); the decode's 8 slots take 4 blocks.
// The other appends: one block per (KV head, row), one thread per element
// of the head vector (kv_append_ragged_t: one thread per 32-bit word of
// it, the token the grid's third axis); thread 0 also writes the row's two
// scales (int8).  The TPU kernels read and wrote back whole bands, tiles
// or pages (an 8-row bf16 band, a 32-row int8 band, a 128-lane scale tile,
// a [Hk, page, D] page block for the prefill append) because their memory
// moves in (8/32, 128) tiles, and the all-layer append double-buffers
// those bands across layers; that is tiling, not semantics: here only the
// rows being appended are written, bit for bit, and nothing else of the
// cache is touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAppendThreads = 256;  // the uniform appends' block
constexpr int kAppendBlocksPerSm = 8;  // 2048 threads on each SM
constexpr int kPagedThreads = 128;  // the paged appends' block

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

// one (KV head, row, token) per block: token t goes to starts[b] + t
__global__ void kv_append_ragged_t_kernel(
    unsigned* __restrict__ k_cache, unsigned* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const unsigned* __restrict__ k_new, const unsigned* __restrict__ v_new,
    const float* __restrict__ ks_new, const float* __restrict__ vs_new,
    const int* __restrict__ starts, int Bc, int Hk, int S, int W, int T,
    int layer) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int t = blockIdx.z;
  const int p0 = starts[b];
  // a skipped row, or a token at or past the cache's end
  if (p0 < 0 || p0 >= S || t >= S - p0) return;
  const int p = p0 + t;
  const long long row = (static_cast<long long>(layer) * Bc + b) * Hk + hk;
  const long long src = (static_cast<long long>(b) * T + t) * Hk + hk;
  const long long dst = (row * S + p) * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    k_cache[dst + w] = k_new[src * W + w];
    v_cache[dst + w] = v_new[src * W + w];
  }
  if (k_scale != nullptr && threadIdx.x == 0) {
    k_scale[row * S + p] = ks_new[src];
    v_scale[row * S + p] = vs_new[src];
  }
}

__global__ void kv_append_q8_kernel(
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int8_t* __restrict__ k_new, const int8_t* __restrict__ v_new,
    const float* __restrict__ ks_new, const float* __restrict__ vs_new,
    const int* __restrict__ position_ptr, int Bc, int Hk, int S, int D,
    int layer) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int position = *position_ptr;
  if (position < 0 || position >= S) return;
  const long long row = (static_cast<long long>(layer) * Bc + b) * Hk + hk;
  const long long src = static_cast<long long>(b) * Hk + hk;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    k_cache[(row * S + position) * D + d] = k_new[src * D + d];
    v_cache[(row * S + position) * D + d] = v_new[src * D + d];
  }
  if (threadIdx.x == 0) {
    k_scale[row * S + position] = ks_new[src];
    v_scale[row * S + position] = vs_new[src];
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

// The paged appends: vector i of the flat source [B, T, Hk, W] (W vectors
// V a head row) of k_new / v_new goes to vector w of row p % page of page
// tables[b, p / page], KV head hk, of pools[layer] [L, P, Hk, page, W],
// with p = starts[b] + t (the prefill: starts null, p = start + t, b =
// 0); i = (b T + t) Hk W + hk W + w.  The source vectors (and an int8
// row's two scales, loaded by its vector 0) are loaded first, as they do
// not depend on the position; then the start, then the page id: two
// dependent loads (one for the prefill) with the data loads already in
// flight, and two divisions (by Hk W, then T) before the first of them.
template <typename V>
__global__ void __launch_bounds__(kPagedThreads)
paged_append_kernel(V* __restrict__ k_pages, V* __restrict__ v_pages,
                    float* __restrict__ k_scale, float* __restrict__ v_scale,
                    const V* __restrict__ k_new, const V* __restrict__ v_new,
                    const float* __restrict__ ks_new,
                    const float* __restrict__ vs_new,
                    const int* __restrict__ starts,
                    const int* __restrict__ tables, int start, int P, int Hk,
                    int max_pages, int layer, FastDiv by_vt, FastDiv by_w,
                    FastDiv by_t, FastDiv by_page, unsigned total) {
  const unsigned i = blockIdx.x * kPagedThreads + threadIdx.x;
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
  const int p0 = starts != nullptr ? __ldg(starts + b) : start;
  if (p0 < 0) return;  // a skipped row
  // p = p0 + t = lp page + slot; s < page + T < 2^31
  const unsigned q0 = quot(static_cast<unsigned>(p0), by_page);
  const unsigned s = static_cast<unsigned>(p0) - q0 * by_page.d +
                     (bt - b * by_t.d);
  const unsigned sq = quot(s, by_page);
  const unsigned lp = q0 + sq;
  if (lp >= static_cast<unsigned>(max_pages)) return;  // past the table
  const unsigned slot = s - sq * by_page.d;
  const int pg = __ldg(tables + static_cast<long long>(b) * max_pages + lp);
  if (pg < 0 || pg >= P) return;
  const long long row =
      ((static_cast<long long>(layer) * P + pg) * Hk + hk) * by_page.d +
      slot;
  k_pages[row * by_w.d + w] = k;
  v_pages[row * by_w.d + w] = v;
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

extern "C" int qie_kv_append_q8(void* k_cache, void* v_cache, void* k_scale,
                                void* v_scale, const void* k_new,
                                const void* v_new, const void* ks_new,
                                const void* vs_new, const void* position,
                                int L, int Bc, int B, int Hk, int S, int D,
                                int layer, void* stream) {
  if (B <= 0 || B > Bc || Hk <= 0 || D <= 0 || D > 1024 || S <= 0 ||
      layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(Hk, B);
  kv_append_q8_kernel<<<grid, D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int8_t*>(k_new), static_cast<const int8_t*>(v_new),
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      static_cast<const int*>(position), Bc, Hk, S, D, layer);
  return static_cast<int>(cudaGetLastError());
}

// k_scale / v_scale / ks_new / vs_new: all null for a bf16 pool, all given
// for an int8 one.
static bool quant_args(const void* a, const void* b, const void* c,
                       const void* d, bool* quant) {
  *quant = a != nullptr;
  return (b != nullptr) == *quant && (c != nullptr) == *quant &&
         (d != nullptr) == *quant;
}

// kv_append_ragged_t: the scale pointers all null for a bf16 or f32
// cache, all given for an int8 one (elem_bytes 1).
extern "C" int qie_kv_append_ragged_t(
    void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, const void* starts, int L, int Bc, int B, int T,
    int Hk, int S, int D, int elem_bytes, int layer, void* stream) {
  bool quant;
  const int row_bytes = D * elem_bytes;
  if (!quant_args(k_scale, v_scale, ks_new, vs_new, &quant) ||
      (quant && elem_bytes != 1) || B <= 0 || B > 65535 || B > Bc ||
      T <= 0 || T > 65535 || Hk <= 0 || D <= 0 || elem_bytes <= 0 ||
      row_bytes % 4 || S <= 0 || layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = row_bytes / 4;
  dim3 grid(Hk, B, T);
  kv_append_ragged_t_kernel<<<grid, W < 256 ? W : 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(k_cache), static_cast<unsigned*>(v_cache),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const unsigned*>(k_new), static_cast<const unsigned*>(v_new),
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      static_cast<const int*>(starts), Bc, Hk, S, W, T, layer);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
static void launch_paged_as(int blocks, cudaStream_t st, void* k_pages,
                            void* v_pages, void* k_scale, void* v_scale,
                            const void* k_new, const void* v_new,
                            const void* ks_new, const void* vs_new,
                            const void* starts, const void* tables,
                            int start, int P, int Hk, int page,
                            int max_pages, int layer, int T, unsigned W,
                            unsigned total) {
  paged_append_kernel<V><<<blocks, kPagedThreads, 0, st>>>(
      static_cast<V*>(k_pages), static_cast<V*>(v_pages),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const V*>(k_new), static_cast<const V*>(v_new),
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      static_cast<const int*>(starts), static_cast<const int*>(tables),
      start, P, Hk, max_pages, layer, fast_div(Hk * W), fast_div(W),
      fast_div(T), fast_div(page), total);
}

// The paged appends' plan (ops/kv_append.plan_paged_append), checked
// against the shapes: `vec` bytes a thread, 16 or 4, dividing the head row
// and every data pointer; blocks of kPagedThreads covering the
// B * T * Hk head rows' vectors once, fewer than 2^31.  The scale pointers
// are f32.  Pages of at most 2^30 tokens keep the kernel's index
// arithmetic in 32 bits.
static int launch_paged(bool quant, void* k_pages, void* v_pages,
                        void* k_scale, void* v_scale, const void* k_new,
                        const void* v_new, const void* ks_new,
                        const void* vs_new, const void* starts,
                        const void* tables, int start, int P, int B, int T,
                        int Hk, int page, int D, int max_pages, int layer,
                        int vec, int threads, int blocks, void* stream) {
  const int row_bytes = D * (quant ? 1 : 2);
  if (vec != 16 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(B) * T * Hk * (row_bytes / vec);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(k_pages) |
                         reinterpret_cast<uintptr_t>(v_pages) |
                         reinterpret_cast<uintptr_t>(k_new) |
                         reinterpret_cast<uintptr_t>(v_new);
  if (row_bytes % vec || ptrs % vec || threads != kPagedThreads ||
      total > 0x7fffffffll || blocks <= 0 || page > (1 << 30) ||
      static_cast<long long>(blocks - 1) * threads >= total ||
      static_cast<long long>(blocks) * threads < total) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned W = static_cast<unsigned>(row_bytes / vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16) {
    launch_paged_as<uint4>(blocks, st, k_pages, v_pages, k_scale, v_scale,
                           k_new, v_new, ks_new, vs_new, starts, tables,
                           start, P, Hk, page, max_pages, layer, T, W,
                           static_cast<unsigned>(total));
  } else {
    launch_paged_as<unsigned>(blocks, st, k_pages, v_pages, k_scale,
                              v_scale, k_new, v_new, ks_new, vs_new, starts,
                              tables, start, P, Hk, page, max_pages, layer,
                              T, W, static_cast<unsigned>(total));
  }
  return static_cast<int>(cudaGetLastError());
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
