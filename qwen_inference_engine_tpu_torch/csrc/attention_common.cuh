// CUDA-core core of fused_attn_matmul's attention (fused_step.cu), the one
// attention kernel of the port not on the tensor cores; flash, the
// contiguous and paged chunks, the four contiguous decodes (ragged bf16,
// appending, fresh and INT8-KV), the paged decode and verify and
// fused_attn_mlp's attention run on the tensor-core core of
// attention_mma.cuh, which takes its key policies (ContiguousKeys,
// PagedKeys) and kNegInf from here.
//
// One block of D threads (one per output dimension) runs the online
// softmax of up to BR query rows over keys [0, n_keys) in tiles of BK keys:
//   1. the K/V tile is staged in shared memory in its stored type (16-byte
//      loads; the K rows padded by 4 bytes so the per-key dot products below
//      do not conflict on banks), with the tile's per-key scales for int8;
//   2. each thread scores one key against BR / (D / BK) rows, fp32 dot
//      products over D (int8 keys dequantized in registers: the dot of the
//      raw bytes times the key's scale), and masks keys past each row's
//      causal limit (key j is visible to row i iff
//      j <= lim0 + i * lim_step);
//   3. one warp per row updates the running max / sum and turns scores
//      into probabilities;
//   4. each thread rescales its BR accumulators and adds P @ V for its
//      dimension (an int8 value times its key's V scale).
// Where key j lives is a policy (`Keys`): `ContiguousKeys` puts it at
// j * stride elements from key 0 (a contiguous cache slab, fresh K/V);
// `PagedKeys` follows a block table, page tables[j / page], row j % page,
// resolved for every key in the staging loop, so a 64-key tile may span
// any number of pages (a page only has to be a multiple of 8 tokens); an
// int8 pool's scales [L, P, Hk, page] follow the same table.
// Keys at or past n_keys are never loaded: their tile rows are zeros and
// their scores -inf, so stale pages (even NaN) cannot leak in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qie {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <int D, int BR, int BK, typename KV>
struct AttnSmem {
  float q[BR][D];                           // pre-scaled queries
  KV k[BK][D + 4 / sizeof(KV)];             // padded: conflict-free key reads
  __align__(16) KV v[BK][D];
  float s[BR][BK];                          // scores, then probabilities
  float m[BR];                              // running max
  float l[BR];                              // running sum
  float alpha[BR];                          // this tile's rescale factor
  int lim[BR];                              // each row's last visible key
  float ks[BK];                             // int8 KV: the tile's key scales
  float vs[BK];                             //          and value scales
};

// Key j at j * stride elements from key 0; its scale at j.
struct ContiguousKeys {
  long long stride;
  __device__ __forceinline__ long long offset(int j) const {
    return j * stride;
  }
  __device__ __forceinline__ long long scale(int j) const { return j; }
};

// Key j of one (layer, KV head) in the stacked page pool [L, P, Hk, page,
// D], counted from the row's key `first` (0 unless a caller splits the
// keys across blocks): the base pointers point at page 0 of that layer
// and head, so key j is sequence key t = first + j, at tables[t / page] *
// page_stride + (t % page) * D elements, and its scale (an int8 pool's
// [L, P, Hk, page]) at tables[t / page] * scale_stride + t % page.  A
// split's first key need not start a page.
struct PagedKeys {
  const int* table;        // this row's block table
  int page;                // tokens per page
  int D;
  long long page_stride;   // elements from one page to the next: Hk*page*D
  long long scale_stride;  // scales from one page to the next: Hk*page
  int first = 0;           // sequence key of key 0
  __device__ __forceinline__ long long offset(int j) const {
    const int t = first + j;
    return static_cast<long long>(table[t / page]) * page_stride +
           static_cast<long long>(t % page) * D;
  }
  __device__ __forceinline__ long long scale(int j) const {
    const int t = first + j;
    return static_cast<long long>(table[t / page]) * scale_stride + t % page;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dot of a pre-scaled f32 query row with one staged key row
template <int D>
__device__ __forceinline__ float key_dot(const float* q,
                                         const __nv_bfloat16* k) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
  float s = 0.f;
#pragma unroll 16
  for (int d2 = 0; d2 < D / 2; ++d2) {
    const float2 kf = __bfloat1622float2(k2[d2]);
    s = fmaf(q[2 * d2], kf.x, s);
    s = fmaf(q[2 * d2 + 1], kf.y, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ float key_dot(const float* q, const int8_t* k) {
  const char4* k4 = reinterpret_cast<const char4*>(k);
  float s = 0.f;
#pragma unroll 8
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const char4 c = k4[d4];
    s = fmaf(q[4 * d4], static_cast<float>(c.x), s);
    s = fmaf(q[4 * d4 + 1], static_cast<float>(c.y), s);
    s = fmaf(q[4 * d4 + 2], static_cast<float>(c.z), s);
    s = fmaf(q[4 * d4 + 3], static_cast<float>(c.w), s);
  }
  return s;
}

// Online-softmax attention; the caller has filled sm.q (rows >= n_rows may
// hold anything) and reads acc / sm.l afterwards.  kbase / vbase point at
// the K/V base that `keys` addresses from.  For an int8 cache ks_base /
// vs_base are the scale bases `keys.scale` addresses from; for bf16 they
// are null.
template <int D, int BR, int BK, typename KV, typename Keys>
__device__ void attend(AttnSmem<D, BR, BK, KV>& sm, float (&acc)[BR],
                       int n_rows, const KV* __restrict__ kbase,
                       const KV* __restrict__ vbase, const Keys& keys,
                       const float* __restrict__ ks_base,
                       const float* __restrict__ vs_base, int n_keys,
                       int lim0, int lim_step) {
  static_assert(D % 32 == 0 && BK == 64 && D % BK == 0, "attention tiling");
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int NT = D;            // threads
  constexpr int NW = NT / 32;      // warps
  constexpr int ROW_STEP = NT / BK;
  constexpr int PER_CHUNK = 16 / sizeof(KV);   // elements per 16-byte load
  constexpr int CHUNKS = D / PER_CHUNK;        // 16-byte chunks per row
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < BR; i += NT) {
    sm.m[i] = kNegInf;
    sm.l[i] = 0.f;
    sm.lim[i] = lim0 + i * lim_step;
  }
#pragma unroll
  for (int i = 0; i < BR; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < n_keys; j0 += BK) {
    // 1. stage the K/V tile (and its scales)
    for (int c = tid; c < BK * CHUNKS; c += NT) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * PER_CHUNK;
      const int j = j0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < n_keys) {
        const long long off = keys.offset(j) + col;
        kv = *reinterpret_cast<const uint4*>(kbase + off);
        vv = *reinterpret_cast<const uint4*>(vbase + off);
      }
      unsigned* kd = reinterpret_cast<unsigned*>(&sm.k[r][col]);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<uint4*>(&sm.v[r][col]) = vv;
    }
    if constexpr (kQuant) {
      if (tid < BK) {
        const int j = j0 + tid;
        sm.ks[tid] = j < n_keys ? ks_base[keys.scale(j)] : 0.f;
        sm.vs[tid] = j < n_keys ? vs_base[keys.scale(j)] : 0.f;
      }
    }
    __syncthreads();

    // 2. scores of key jj against rows i = tid / BK, + ROW_STEP, ...
    {
      const int jj = tid % BK;
      const int j = j0 + jj;
      float kscale = 1.f;
      if constexpr (kQuant) kscale = sm.ks[jj];
      for (int i = tid / BK; i < BR; i += ROW_STEP) {
        const float s = key_dot<D>(&sm.q[i][0], &sm.k[jj][0]) * kscale;
        const bool ok = i < n_rows && j < n_keys && j <= sm.lim[i];
        sm.s[i][jj] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per row
    for (int i = warp; i < BR; i += NW) {
      const float a = sm.s[i][lane], b = sm.s[i][lane + 32];
      const float m_prev = sm.m[i];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, b)));
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      sm.s[i][lane] = pa;
      sm.s[i][lane + 32] = pb;
      const float sum = warp_sum(pa + pb);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sm.alpha[i] = alpha;
        sm.l[i] = sm.l[i] * alpha + sum;
        sm.m[i] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P @ V for this thread's dimension
#pragma unroll
    for (int i = 0; i < BR; ++i) acc[i] *= sm.alpha[i];
    for (int jj = 0; jj < BK; ++jj) {
      float vf = to_float(sm.v[jj][tid]);
      if constexpr (kQuant) vf *= sm.vs[jj];
#pragma unroll
      for (int i = 0; i < BR; ++i) acc[i] = fmaf(sm.s[i][jj], vf, acc[i]);
    }
    __syncthreads();
  }
}

}  // namespace qie
