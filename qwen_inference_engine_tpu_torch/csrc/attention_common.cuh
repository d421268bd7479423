// Shared core of the port's attention kernels (flash prefill and decode).
//
// One block of D threads (one per output dimension) runs the online
// softmax of up to BR query rows over keys [0, n_keys) in tiles of BK keys:
//   1. the K/V tile is staged in shared memory as bf16 (16-byte loads; the K
//      rows padded by one bf16 pair so the per-key dot products below do
//      not conflict on banks);
//   2. each thread scores one key against BR / (D / BK) rows, fp32 dot
//      products over D, and masks keys past each row's causal limit
//      (key j is visible to row i iff j <= lim0 + i * lim_step);
//   3. one warp per row updates the running max / sum and turns scores
//      into probabilities;
//   4. each thread rescales its BR accumulators and adds P @ V for its
//      dimension.
// A key position `fresh_pos` (>= 0) is read from `k_fresh` / `v_fresh`
// instead of the cache: the appending decode uses it so the token being
// written enters the softmax from its inputs, never from a cache read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qie {

constexpr float kNegInf = -1e30f;

template <int D, int BR, int BK>
struct AttnSmem {
  float q[BR][D];                  // pre-scaled queries
  __nv_bfloat16 k[BK][D + 2];      // padded: conflict-free per-key reads
  __align__(16) __nv_bfloat16 v[BK][D];
  float s[BR][BK];                 // scores, then probabilities
  float m[BR];                     // running max
  float l[BR];                     // running sum
  float alpha[BR];                 // this tile's rescale factor
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

// Online-softmax attention; the caller has filled sm.q (rows >= n_rows may
// hold anything) and reads acc / sm.l afterwards.  kbase / vbase point at
// key 0, consecutive keys are kv_stride elements apart.
template <int D, int BR, int BK>
__device__ void attend(AttnSmem<D, BR, BK>& sm, float (&acc)[BR], int n_rows,
                       const __nv_bfloat16* __restrict__ kbase,
                       const __nv_bfloat16* __restrict__ vbase,
                       long long kv_stride, int n_keys, int lim0, int lim_step,
                       const __nv_bfloat16* k_fresh,
                       const __nv_bfloat16* v_fresh, int fresh_pos) {
  static_assert(D % 32 == 0 && BK == 64 && D % BK == 0, "attention tiling");
  constexpr int NT = D;            // threads
  constexpr int NW = NT / 32;      // warps
  constexpr int ROW_STEP = NT / BK;
  constexpr int CHUNKS = D / 8;    // 16-byte chunks per K/V row
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < BR; i += NT) {
    sm.m[i] = kNegInf;
    sm.l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BR; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < n_keys; j0 += BK) {
    // 1. stage the K/V tile
    for (int c = tid; c < BK * CHUNKS; c += NT) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const int j = j0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < n_keys) {
        const __nv_bfloat16* ks = j == fresh_pos ? k_fresh + col
                                                 : kbase + j * kv_stride + col;
        const __nv_bfloat16* vs = j == fresh_pos ? v_fresh + col
                                                 : vbase + j * kv_stride + col;
        kv = *reinterpret_cast<const uint4*>(ks);
        vv = *reinterpret_cast<const uint4*>(vs);
      }
      unsigned* kd = reinterpret_cast<unsigned*>(&sm.k[r][col]);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<uint4*>(&sm.v[r][col]) = vv;
    }
    __syncthreads();

    // 2. scores of key jj against rows i = tid / BK, + ROW_STEP, ...
    {
      const int jj = tid % BK;
      const int j = j0 + jj;
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(&sm.k[jj][0]);
      for (int i = tid / BK; i < BR; i += ROW_STEP) {
        float s = 0.f;
#pragma unroll 16
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 kf = __bfloat1622float2(kr[d2]);
          s = fmaf(sm.q[i][2 * d2], kf.x, s);
          s = fmaf(sm.q[i][2 * d2 + 1], kf.y, s);
        }
        const bool ok = i < n_rows && j < n_keys && j <= lim0 + i * lim_step;
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
      const float vf = __bfloat162float(sm.v[jj][tid]);
#pragma unroll
      for (int i = 0; i < BR; ++i) acc[i] = fmaf(sm.s[i][jj], vf, acc[i]);
    }
    __syncthreads();
  }
}

}  // namespace qie
