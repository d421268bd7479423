// Tensor-core core of every attention kernel of the port: attend_gqa_block
// for flash (flash_attention.cu) and the contiguous and paged chunks
// (chunk_attention.cu); attend_mma itself for the four contiguous decodes
// (decode_attention.cu), the paged decode and verify (paged_attention.cu)
// and the attention blocks of fused_attn_mlp and fused_attn_matmul
// (fused_step.cu).  attend_mma is the online softmax of
// up to 16 * NW query rows over keys [0, n_keys) in tiles of 64 keys, both
// products (Q K^T and P V) on Hopper's tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), the K/V tiles staged by
// cp.async into a ring of two stages, so the next tile's copy overlaps
// this tile's math (FlashAttention-2's structure).
//
//   * Rows.  Each of the NW warps owns 16 rows.  Its Q fragments are loaded
//     once (ldmatrix) and stay in registers; its running max / sum stay in
//     registers too, reduced across the 4 threads of a quad by shuffles;
//     its output accumulators (16 x D f32) are registers, never memory.
//     Where row i reads its query and writes its output is a policy
//     (`Rows`: offset(i) elements from the q / out bases); row i sees key
//     j iff j <= lim0 + ((lim_row0 + i) / lim_group): lim_group rows share
//     a limit, as the G query heads of one token do when a block packs the
//     G heads of one KV head into its rows (r = t * G + g).
//   * Keys.  Where key j lives is the `Keys` policy of attention_common.cuh
//     (ContiguousKeys, PagedKeys), resolved for each 16-byte chunk as the
//     tile is staged; FreshKeys (below) stages one key, the token a decode
//     step is writing, from its inputs instead of the cache.  Keys at or
//     past n_keys are never loaded: the copy's source size is 0, so their
//     rows (and an int8 tile's scales) are zero, and their scores are -inf;
//     stale cache (even NaN) cannot leak in.
//   * Layout.  Q, K and V tiles are row-major in shared memory with each
//     row padded by 16 bytes, so the 8 row addresses of every ldmatrix
//     phase fall on distinct banks.  K feeds the B operand of Q K^T with
//     plain ldmatrix; V feeds the B operand of P V with ldmatrix.trans.
//   * Probabilities.  The f32 score fragment of two adjacent 8-key column
//     tiles is the A fragment of one 16-key step of P V, so P is rounded
//     to bf16 in registers (as the TPU kernels cast p) and never stored.
//   * int8 K/V.  The tiles are staged raw (half the bytes of bf16) with
//     their per-key f32 scales, then widened to bf16 in shared memory by
//     the whole block before the fragments load: K exactly (int8 -> bf16
//     is exact for -128..127), its scale multiplying the f32 score columns,
//     so scores are (q . k_i8) * k_scale * D^-1/2; V times its key's scale,
//     rounded once to bf16 (the plain version's dequantized value).  The
//     TPU q8 kernel folds the V scale into P before P's bf16 cast instead;
//     that order rounds each term twice and strays up to 1 bf16 ulp of the
//     output (0.031 at |out| >= 4) from the plain version, past the 2e-2
//     the kernels are held to.
//   * Masks.  A warp skips a tile wholly past its last row's limit, and
//     masks per element only a tile that crosses its first row's limit or
//     the end of the keys.
//   * Splits.  A caller that splits a long key range across blocks (the
//     decodes of decode_attention.cu and paged_attention.cu) takes each
//     row's f32 output and log-sum-exp instead of its bf16 output, and
//     merges the splits with decode_merge (below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace qie {

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 reads nothing and zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared; `bytes` 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major); bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 32, row-major) * b (32 x 8, column-major); s8 in, s32 out
// (exact); the W8A8 and W4A8 matmuls (quant_matmul.cu) use it
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// eight int8 (one 8-byte word) times `scale` -> eight bf16 (one 16-byte
// word); exact for scale 1
__device__ __forceinline__ uint4 widen8(uint2 raw, float scale) {
  const char4 a = *reinterpret_cast<const char4*>(&raw.x);
  const char4 b = *reinterpret_cast<const char4*>(&raw.y);
  return make_uint4(pack_bf16(a.x * scale, a.y * scale),
                    pack_bf16(a.z * scale, a.w * scale),
                    pack_bf16(b.x * scale, b.y * scale),
                    pack_bf16(b.z * scale, b.w * scale));
}

// 2^x on the special-function unit (-inf -> 0)
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma

constexpr int kMmaKeys = 64;   // keys per tile
constexpr int kMmaStages = 2;  // K/V tiles in flight

// Shared memory of one block: NW warps of 16 rows, head dim D, cache type
// KV.  bf16 tiles are staged straight into k / v; int8 tiles into k8 / v8
// (with their scales), then widened into k[0] / v[0].
template <int D, int NW, typename KV>
struct MmaSmem {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kPad = D + 8;             // bf16 row: +16 bytes
  static constexpr int kPad8 = D + 16;           // int8 row: +16 bytes
  static constexpr int kBf16Stages = kQuant ? 1 : kMmaStages;
  static constexpr int kRawStages = kQuant ? kMmaStages : 1;
  static constexpr int kRawRow = kQuant ? kPad8 : 16;
  static constexpr int kScaleStages = kQuant ? kMmaStages : 1;
  __nv_bfloat16 q[16 * NW][kPad];
  __nv_bfloat16 k[kBf16Stages][kMmaKeys][kPad];
  __nv_bfloat16 v[kBf16Stages][kMmaKeys][kPad];
  int8_t k8[kRawStages][kMmaKeys][kRawRow];      // int8 only
  int8_t v8[kRawStages][kMmaKeys][kRawRow];
  float ks[kScaleStages][kMmaKeys];               // int8 only
  float vs[kScaleStages][kMmaKeys];
};

// Row i's query at q + offset(i), its output at out + offset(i), for a
// block of rows r = r0 + i of one KV head packed as r = t * G + g (query
// head g of the group, token t); the bases point at token 0, head 0 of
// the group.
struct GqaRows {
  int r0, G, Hq, D;
  // (token, head) of row i: t * Hq + g
  __device__ __forceinline__ long long index(int i) const {
    const int r = r0 + i;
    const int t = r / G;
    return static_cast<long long>(t) * Hq + (r - t * G);
  }
  __device__ __forceinline__ long long offset(int i) const {
    return index(i) * D;
  }
};

// Key j at j * stride elements from key 0 (as ContiguousKeys), except key
// `fresh`, which is staged from k_new / v_new (D bf16 each): the token the
// appending and fresh decodes attend before (or without) its cache write.
// A `fresh` outside [0, n_keys) stages nothing from the inputs.
struct FreshKeys {
  long long stride;
  int fresh;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  __device__ __forceinline__ long long offset(int j) const {
    return j * stride;
  }
};

// The core.  Call with 32 * NW threads and the dynamic shared memory
// `sm`.  Rows >= n_rows are computed on zeros and never written.  kbase /
// vbase point at the K/V base that `keys` addresses from; for an int8
// cache ks_base / vs_base are the scale bases `keys.scale` addresses from
// (null for bf16).  `scale` is D^-1/2.  Row i's output O / l goes to
// out + rows.offset(i) rounded to bf16; with kSplit (one split of a
// longer key range, merged by the caller) it goes to part +
// rows.offset(i) in f32 instead, with its log-sum-exp (log2 units of the
// scaled scores: max + log2(sum); -inf where no key was seen) at
// lse + rows.index(i).
template <int D, int NW, typename KV, typename Keys, typename Rows,
          bool kSplit = false>
__device__ void attend_mma(MmaSmem<D, NW, KV>& sm, const Rows& rows,
                           int n_rows, const __nv_bfloat16* __restrict__ q,
                           __nv_bfloat16* __restrict__ out,
                           const KV* __restrict__ kbase,
                           const KV* __restrict__ vbase, const Keys& keys,
                           const float* __restrict__ ks_base,
                           const float* __restrict__ vs_base, int n_keys,
                           int lim0, int lim_row0, int lim_group,
                           float scale, float* __restrict__ part = nullptr,
                           float* __restrict__ lse = nullptr) {
  static_assert(D == 64 || D == 128, "head dim");
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int NT = 32 * NW;
  constexpr int BM = 16 * NW;
  constexpr int BN = kMmaKeys;
  constexpr int KC = D / 16;     // 16-wide steps of Q K^T
  constexpr int DT = D / 8;      // 8-wide output column tiles
  constexpr int NTILE = BN / 8;  // 8-key score column tiles
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int quad = lane % 4, grp = lane / 4;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units

  // ---- staging: Q once, K/V (and int8 scales) per tile into a stage
  auto stage_q = [&]() {
    constexpr int CH = D / 8;  // 16-byte chunks a row
    for (int c = tid; c < BM * CH; c += NT) {
      const int i = c / CH, col = (c % CH) * 8;
      const bool ok = i < n_rows;
      mma::cp_async16(&sm.q[i][col], ok ? q + rows.offset(i) + col : q,
                      ok ? 16 : 0);
    }
  };
  auto stage_kv = [&](int j0, int st) {
    constexpr int PER = 16 / sizeof(KV);  // elements a chunk
    constexpr int CH = D / PER;
    for (int c = tid; c < BN * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * PER;
      const int j = j0 + r;
      const bool ok = j < n_keys;
      const long long off = ok ? keys.offset(j) + col : 0;
      const KV* ksrc = kbase + off;
      const KV* vsrc = vbase + off;
      if constexpr (std::is_same<Keys, FreshKeys>::value) {
        if (j == keys.fresh) {
          ksrc = keys.k_new + col;
          vsrc = keys.v_new + col;
        }
      }
      if constexpr (kQuant) {
        mma::cp_async16(&sm.k8[st][r][col], ksrc, ok ? 16 : 0);
        mma::cp_async16(&sm.v8[st][r][col], vsrc, ok ? 16 : 0);
      } else {
        mma::cp_async16(&sm.k[st][r][col], ksrc, ok ? 16 : 0);
        mma::cp_async16(&sm.v[st][r][col], vsrc, ok ? 16 : 0);
      }
    }
    if constexpr (kQuant) {
      for (int c = tid; c < 2 * BN; c += NT) {
        const int r = c % BN, j = j0 + r;
        const bool ok = j < n_keys;
        const long long off = ok ? keys.scale(j) : 0;
        if (c < BN) {
          mma::cp_async4(&sm.ks[st][r], ks_base + off, ok ? 4 : 0);
        } else {
          mma::cp_async4(&sm.vs[st][r], vs_base + off, ok ? 4 : 0);
        }
      }
    }
  };

  // ---- this warp's rows and limits
  const int wr0 = 16 * warp;                         // first row of the warp
  const int w_last = min(wr0 + 15, n_rows - 1);      // last valid row
  const bool active = wr0 < n_rows;
  const int lim_first = lim0 + (lim_row0 + wr0) / lim_group;
  const int lim_last = lim0 + (lim_row0 + max(w_last, wr0)) / lim_group;
  const int lim_a = lim0 + (lim_row0 + wr0 + grp) / lim_group;
  const int lim_b = lim0 + (lim_row0 + wr0 + grp + 8) / lim_group;

  uint32_t qf[KC][4];
  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;  // running max (log2 units), finite
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the sum

  const int n_tiles = (n_keys + BN - 1) / BN;
  if (n_tiles > 0) {
    stage_q();
    stage_kv(0, 0);
  }
  mma::cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * BN;
    const int st = it % kMmaStages;
    if (it + 1 < n_tiles) stage_kv(j0 + BN, (it + 1) % kMmaStages);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // tile it (and Q) have landed
    __syncthreads();

    if (it == 0 && active) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mma::ldmatrix_x4(qf[kc], &sm.q[wr0 + (lane % 8) + ((lane / 8) % 2) * 8]
                                      [16 * kc + (lane / 16) * 8]);
      }
    }
    int kvs = st;  // the bf16 stage the fragments read
    if constexpr (kQuant) {
      constexpr int CH = D / 8;
      for (int c = tid; c < BN * CH; c += NT) {
        const int r = c / CH, col = (c % CH) * 8;
        *reinterpret_cast<uint4*>(&sm.k[0][r][col]) = mma::widen8(
            *reinterpret_cast<const uint2*>(&sm.k8[st][r][col]), 1.f);
        *reinterpret_cast<uint4*>(&sm.v[0][r][col]) = mma::widen8(
            *reinterpret_cast<const uint2*>(&sm.v8[st][r][col]),
            sm.vs[st][r]);
      }
      __syncthreads();
      kvs = 0;
    }

    if (active && j0 <= lim_last) {
      // S = Q K^T: 16 rows x 64 keys, f32
      float s[NTILE][4];
#pragma unroll
      for (int t = 0; t < NTILE; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int tp = 0; tp < NTILE / 2; ++tp) {
          uint32_t b[4];
          mma::ldmatrix_x4(b, &sm.k[kvs][16 * tp + (lane / 16) * 8 + (lane % 8)]
                                   [16 * kc + ((lane / 8) % 2) * 8]);
          mma::mma_bf16(s[2 * tp], qf[kc], b[0], b[1]);
          mma::mma_bf16(s[2 * tp + 1], qf[kc], b[2], b[3]);
        }
      }
      // scale, mask, running max
      const bool full = j0 + BN - 1 <= lim_first && j0 + BN <= n_keys;
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int t = 0; t < NTILE; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 8 * t + 2 * quad + e;
          float f = sl2;
          if constexpr (kQuant) f *= sm.ks[st][jj];
          float sa = s[t][e] * f, sb = s[t][2 + e] * f;
          if (!full) {
            const int j = j0 + jj;
            if (j > lim_a || j >= n_keys) sa = -CUDART_INF_F;
            if (j > lim_b || j >= n_keys) sb = -CUDART_INF_F;
          }
          s[t][e] = sa;
          s[t][2 + e] = sb;
          mx_a = fmaxf(mx_a, sa);
          mx_b = fmaxf(mx_b, sb);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float alpha_a = mma::fexp2(m_a - mx_a), alpha_b = mma::fexp2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int t = 0; t < NTILE; ++t) {
        s[t][0] = mma::fexp2(s[t][0] - mx_a);
        s[t][1] = mma::fexp2(s[t][1] - mx_a);
        s[t][2] = mma::fexp2(s[t][2] - mx_b);
        s[t][3] = mma::fexp2(s[t][3] - mx_b);
        sum_a += s[t][0] + s[t][1];
        sum_b += s[t][2] + s[t][3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        o[t][0] *= alpha_a;
        o[t][1] *= alpha_a;
        o[t][2] *= alpha_b;
        o[t][3] *= alpha_b;
      }
      // O += P V, P rounded to bf16 in registers
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const float(&p0)[4] = s[2 * kc];
        const float(&p1)[4] = s[2 * kc + 1];
        const uint32_t a[4] = {mma::pack_bf16(p0[0], p0[1]),
                               mma::pack_bf16(p0[2], p0[3]),
                               mma::pack_bf16(p1[0], p1[1]),
                               mma::pack_bf16(p1[2], p1[3])};
#pragma unroll
        for (int tp = 0; tp < DT / 2; ++tp) {
          uint32_t b[4];
          mma::ldmatrix_x4_trans(
              b, &sm.v[kvs][16 * kc + (lane % 8) + ((lane / 8) % 2) * 8]
                      [16 * tp + (lane / 16) * 8]);
          mma::mma_bf16(o[2 * tp], a, b[0], b[1]);
          mma::mma_bf16(o[2 * tp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  mma::cp_async_wait<0>();

  // ---- out = O / l, rows < n_rows
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const int ia = wr0 + grp, ib = ia + 8;
  if constexpr (kSplit) {
    if (ia < n_rows) {
      float* dst = part + rows.offset(ia) + 2 * quad;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        *reinterpret_cast<float2*>(dst + 8 * t) =
            make_float2(o[t][0] * inv_a, o[t][1] * inv_a);
      }
      if (quad == 0) lse[rows.index(ia)] = m_a + log2f(l_a);
    }
    if (ib < n_rows) {
      float* dst = part + rows.offset(ib) + 2 * quad;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        *reinterpret_cast<float2*>(dst + 8 * t) =
            make_float2(o[t][2] * inv_b, o[t][3] * inv_b);
      }
      if (quad == 0) lse[rows.index(ib)] = m_b + log2f(l_b);
    }
  } else {
    if (ia < n_rows) {
      __nv_bfloat16* dst = out + rows.offset(ia) + 2 * quad;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        *reinterpret_cast<uint32_t*>(dst + 8 * t) =
            mma::pack_bf16(o[t][0] * inv_a, o[t][1] * inv_a);
      }
    }
    if (ib < n_rows) {
      __nv_bfloat16* dst = out + rows.offset(ib) + 2 * quad;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        *reinterpret_cast<uint32_t*>(dst + 8 * t) =
            mma::pack_bf16(o[t][2] * inv_b, o[t][3] * inv_b);
      }
    }
  }
}

constexpr int kGqaWarps = 4;               // warps of a packed-row block
constexpr int kGqaRows = 16 * kGqaWarps;   // packed rows of a block

// One block of causal attention, the body of the flash, contiguous chunk
// and paged chunk kernels: the kGqaRows packed rows r = t * G + g of KV
// head blockIdx.x, batch row blockIdx.y, row tile gridDim.z - 1 -
// blockIdx.z (later tokens first), of q / out [B, T, Hq, D].  Token t sits
// at position start + t and sees keys [0, start + t], at most S of them
// (a row past the S-th key sees all S).  kbase / vbase point at the K/V
// base of (batch row, KV head) that `keys` addresses from: ContiguousKeys
// (each key `stride` elements after the one before) or PagedKeys (the
// row's block table); ks / vs at the f32 scales `keys.scale` addresses
// from (int8; else null).
template <int D, typename KV, typename Keys>
__device__ __forceinline__ void attend_gqa_block(
    MmaSmem<D, kGqaWarps, KV>& sm, const __nv_bfloat16* __restrict__ q,
    __nv_bfloat16* __restrict__ out, const KV* __restrict__ kbase,
    const KV* __restrict__ vbase, const Keys& keys,
    const float* __restrict__ ks, const float* __restrict__ vs, int T,
    int Hq, int Hk, int S, int start, float scale) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int G = Hq / Hk;
  const int r0 = tile * kGqaRows;
  const int n_rows = min(kGqaRows, T * G - r0);
  // the block's last row sits at token (r0 + n_rows - 1) / G
  const int n_keys = min(S, max(0, start + (r0 + n_rows - 1) / G + 1));
  const long long qbase =
      (static_cast<long long>(b) * T * Hq + static_cast<long long>(hk) * G) * D;
  attend_mma<D, kGqaWarps, KV>(sm, GqaRows{r0, G, Hq, D}, n_rows, q + qbase,
                               out + qbase, kbase, vbase, keys, ks, vs,
                               n_keys, start, r0, G, scale);
}

// Launch `kern` (a kernel whose blocks run attend_gqa_block) over Hk x B x
// ceil(T * G / kGqaRows) blocks with its dynamic shared memory.
template <int D, typename KV, typename... Params, typename... Args>
int launch_gqa(void (*kern)(Params...), int B, int T, int Hq, int Hk,
               cudaStream_t st, Args... args) {
  constexpr int smem = sizeof(MmaSmem<D, kGqaWarps, KV>);
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tiles = (T * (Hq / Hk) + kGqaRows - 1) / kGqaRows;
  kern<<<dim3(Hk, B, tiles), 32 * kGqaWarps, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMergeThreads = 128;  // decode_merge

namespace {

// The merge of a split attention (the split decodes of decode_attention.cu
// and paged_attention.cu): out [rows, D] bf16 from the f32 partials part
// [splits, rows, D] weighted by 2^(lse - max lse) over lse [splits, rows],
// added in split order, divided by the weights' sum and rounded once; 0
// where every split of the row is empty (lse -inf).  Each thread 4
// adjacent columns.  No atomics: two calls are bit-identical.
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
      make_uint2(mma::pack_bf16(acc[0], acc[1]),
                 mma::pack_bf16(acc[2], acc[3]));
}

// decode_merge of `rows` rows on stream st.
template <int D>
cudaError_t launch_merge(const float* part, const float* lse,
                         __nv_bfloat16* out, int rows, int splits,
                         cudaStream_t st) {
  const int threads = rows * (D / 4);
  decode_merge<D><<<(threads + kMergeThreads - 1) / kMergeThreads,
                    kMergeThreads, 0, st>>>(part, lse, out, rows, splits);
  return cudaGetLastError();
}

}  // namespace

}  // namespace qie
