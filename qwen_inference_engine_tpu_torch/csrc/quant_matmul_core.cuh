// Shared core of the port's quantized matmuls: y = x @ Wq, bf16 out.
//
// The tensor-core body (qmm_mma_kernel, at the end of this file) runs the
// dense W8A8, W4A8, W8A16 and W4A16 matmuls (quant_matmul.cu) and both
// passes of the fused MLP (fused_step.cu).  The older tiles below, one
// output tile per call, run the grouped MoE kernels (grouped_matmul.cu:
// called in a loop over the row tiles of the block's expert, with x, out
// and the row count taken at that expert's rows) and the fused attention
// launches of fused_step.cu (the wmma tile).
//
// A tile reads rows [m0, m0 + BM) of x [M, K] (rows at or past M are never
// written and read as zeros or as row M - 1) and columns [n0, n0 + BN) of
// one weight slab: INT4 plane pairs q [Kp/2, N] int8 (byte = 16*hi + (lo+8);
// packed rows p*gs..(p+1)*gs hold group 2p in the low nibble, group 2p+1 in
// the high nibble) with scales [Kp/gs, N] f32, or INT8 q [K, N] with scales
// [G, N] (a scale per group of gs = K/G rows, or one per column: per_col).
// Every tile computes what the TPU kernels do: the sum over groups of
// (x . q) x scale in f32 (x the row scale sx for int8 activations), then
// rounded to bf16.
//
// The tiles (tile_4a8 is described in grouped_matmul.cu):
//   tile_4a8<TM>            int8 x INT4, __dp4a, 256 threads, BM = 8 TM x 128
//   tile_w16_small<I4, MT>  bf16 x INT4/INT8, f32 FMAs, 256 threads, MT x 64
//   tile_w16_wmma<I4>       bf16 x INT4/INT8, wmma bf16, 128 threads, 64 x 64
// tile_w16_small streams the weights once with f32 FMAs on the CUDA cores
// (a few rows: bound by bytes): 16 threads x 4 columns, K split over 16
// thread groups in chunks of 32 weight rows (one scale group each); a
// thread issues its chunk's 32 weight loads before it computes, and the
// 16 partial sums of a column are added in a fixed order through shared
// memory.  tile_w16_wmma feeds nvcuda::wmma 16x16x16 fragments with an
// f32 accumulator (4 warps, 2 x 2 fragments a warp); per k-step it
// dequantizes 64 logical rows into bf16 in shared memory, q * scale.
// A tile's shared memory is static and reused by the next call of the same
// block: a caller that loops over tiles puts a __syncthreads() between
// calls.
//
// The two bf16-activation tiles also come as *_ep versions that hand each
// finished f32 output y[m, n] to an epilogue functor instead of rounding
// it to bf16 (StoreBf16 is the rounding one): fused_attn_mlp
// (fused_step.cu) keeps gate and up in f32 and combines them there.  The
// wmma tile's *_ep version takes its shared memory (WmmaSmem) from the
// caller, so a kernel can overlay it with another block kind's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "attention_mma.cuh"

namespace qie {

constexpr int kThreads = 256;
constexpr int kBN = 128;   // W4A8 tile: output columns (32 threads x 4)
constexpr int kBKP = 32;   // W4A8 tile: weight rows per k-step

// The rounding epilogue: y[m, n] -> bf16 out[m * N + n].
struct StoreBf16 {
  __nv_bfloat16* out;
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    out[static_cast<size_t>(m) * N + n] = __float2bfloat16(v);
  }
};

// Signed high nibble of each byte of w, as four int8 lanes.
__device__ __forceinline__ int high_nibbles(unsigned w) {
  const unsigned u = (w >> 4) & 0x0F0F0F0Fu;          // 0..15 per byte
  return static_cast<int>(__vsub4(u ^ 0x08080808u, 0x08080808u));
}

// 4x4 byte transpose of four weight rows (r0..r3, 4 columns each):
// colw[j] = the 4 rows of column j, in k order.
__device__ __forceinline__ void transpose4x4(unsigned r0, unsigned r1,
                                             unsigned r2, unsigned r3,
                                             unsigned colw[4]) {
  const unsigned t01a = __byte_perm(r0, r1, 0x5140);
  const unsigned t23a = __byte_perm(r2, r3, 0x5140);
  const unsigned t01b = __byte_perm(r0, r1, 0x7362);
  const unsigned t23b = __byte_perm(r2, r3, 0x7362);
  colw[0] = __byte_perm(t01a, t23a, 0x5410);
  colw[1] = __byte_perm(t01a, t23a, 0x7632);
  colw[2] = __byte_perm(t01b, t23b, 0x5410);
  colw[3] = __byte_perm(t01b, t23b, 0x7632);
}

// ---------------------------------------------------------------------
// W4A8: int8 activations x INT4 plane pairs
// ---------------------------------------------------------------------

// __dp4a (s8 x s8 -> s32): a block computes a BM x 128 output tile with
// 256 threads; each thread owns TM rows x 4 adjacent columns.  Per k-step
// the block stages 32 weight rows (4 KB, 16-byte coalesced loads) and the
// matching activation columns in shared memory.  A thread reads 4 rows of
// its 4 columns as four 32-bit words and transposes them (transpose4x4),
// so each word holds 4 consecutive k of one column.  It unpacks the
// nibbles four at a time (lo+8 = w & 0x0F0F0F0F, hi by high_nibbles),
// accumulates each plane-pair's two products in int32, corrects the lo
// plane's excess-8 by 8 * rowsum(x_even), and scales the int32 partials
// into f32.  The row scale is applied in the epilogue.
template <int TM>
__device__ __forceinline__ void tile_4a8(
    const int8_t* __restrict__ x, const float* __restrict__ sx,
    const int8_t* __restrict__ q, const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, int M, int Kp, int N, int gs, int m0,
    int n0) {
  constexpr int BM = 8 * TM;  // 8 warps along M
  __shared__ __align__(16) int8_t xs_e[BM][kBKP];
  __shared__ __align__(16) int8_t xs_o[BM][kBKP];
  __shared__ __align__(16) int8_t ws[kBKP][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 32;   // columns n0 + 4*tx .. +3
  const int ty = tid / 32;   // rows m0 + ty*TM .. +TM-1
  const int pairs = Kp / (2 * gs);

  float accf[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accf[i][j] = 0.f;

  for (int p = 0; p < pairs; ++p) {
    int acc_lo[TM][4], acc_hi[TM][4], rsum[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      rsum[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_lo[i][j] = acc_hi[i][j] = 0;
    }
    for (int c = 0; c < gs; c += kBKP) {
      {  // 32 packed rows x 128 columns = 256 threads x 16 bytes
        const int r = tid / 8, col = (tid % 8) * 16;
        const int4* src = reinterpret_cast<const int4*>(
            q + static_cast<size_t>(p * gs + c + r) * N + n0 + col);
        *reinterpret_cast<int4*>(&ws[r][col]) = __ldg(src);
      }
      // even plane: logical k = p*2gs + c + [0,32); odd plane: + gs
      for (int i = tid; i < 4 * BM; i += kThreads) {
        const int plane = i / (2 * BM);
        const int j = i % (2 * BM);
        const int r = j / 2, col = (j % 2) * 16;
        const int m = m0 + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (m < M) {
          v = __ldg(reinterpret_cast<const int4*>(
              x + static_cast<size_t>(m) * Kp + p * 2 * gs + plane * gs + c +
              col));
        }
        *reinterpret_cast<int4*>(plane ? &xs_o[r][col] : &xs_e[r][col]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBKP; kk += 4) {
        unsigned colw[4];
        transpose4x4(*reinterpret_cast<const unsigned*>(&ws[kk + 0][4 * tx]),
                     *reinterpret_cast<const unsigned*>(&ws[kk + 1][4 * tx]),
                     *reinterpret_cast<const unsigned*>(&ws[kk + 2][4 * tx]),
                     *reinterpret_cast<const unsigned*>(&ws[kk + 3][4 * tx]),
                     colw);
        int lo8[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo8[j] = static_cast<int>(colw[j] & 0x0F0F0F0Fu);  // lo + 8
          hi[j] = high_nibbles(colw[j]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int xe = *reinterpret_cast<const int*>(&xs_e[ty * TM + i][kk]);
          const int xo = *reinterpret_cast<const int*>(&xs_o[ty * TM + i][kk]);
          rsum[i] = __dp4a(xe, 0x01010101, rsum[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_lo[i][j] = __dp4a(xe, lo8[j], acc_lo[i][j]);
            acc_hi[i][j] = __dp4a(xo, hi[j], acc_hi[i][j]);
          }
        }
      }
      __syncthreads();
    }
    // group scales of this plane-pair: lo plane = group 2p, hi = group 2p+1
    const float4 slo = __ldg(reinterpret_cast<const float4*>(
        scales + static_cast<size_t>(2 * p) * N + n0 + 4 * tx));
    const float4 shi = __ldg(reinterpret_cast<const float4*>(
        scales + static_cast<size_t>(2 * p + 1) * N + n0 + 4 * tx));
    const float sl[4] = {slo.x, slo.y, slo.z, slo.w};
    const float sh[4] = {shi.x, shi.y, shi.z, shi.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        accf[i][j] += static_cast<float>(acc_lo[i][j] - 8 * rsum[i]) * sl[j] +
                      static_cast<float>(acc_hi[i][j]) * sh[j];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m < M) {
      const float s = sx[m];
      __nv_bfloat16* o = out + static_cast<size_t>(m) * N + n0 + 4 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = __float2bfloat16(accf[i][j] * s);
    }
  }
}

// ---------------------------------------------------------------------
// W4A16 / W8A16, few rows: CUDA cores, weights streamed once
// ---------------------------------------------------------------------

constexpr int kSmallCols = 64;     // columns per tile: 16 threads x 4
constexpr int kSmallGroups = 16;   // thread groups splitting K
constexpr int kChunk = 32;         // weight rows per chunk

// The 4 bf16 at p (8-byte aligned) as floats.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float f[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// kInt4: K is the logical (padded) K, the weight has K/2 packed rows and
// gs is the INT4 group size; else K rows and gs = K / G.
template <bool kInt4, int MT, typename Ep>
__device__ __forceinline__ void tile_w16_small_ep(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scales, const Ep& ep, int M, int K, int N,
    int gs, bool per_col, int m0, int n0) {
  __shared__ float red[kSmallGroups][MT][kSmallCols];
  const int tid = threadIdx.x;
  const int cx = tid % 16;           // columns n0 + 4*cx .. +3
  const int kg = tid / 16;           // chunks kg, kg + 16, ...
  const int n = n0 + 4 * cx;
  const int chunks = (kInt4 ? K / 2 : K) / kChunk;

  // rows past M read row M-1 (in bounds) and are never written
  const __nv_bfloat16* xrow[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    xrow[m] = x + static_cast<size_t>(min(m0 + m, M - 1)) * K;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int c = kg; c < chunks; c += kSmallGroups) {
    const int r0 = c * kChunk;
    int klo, g_lo;
    if (kInt4) {  // packed row r0 = pair p, row r: k = 2p*gs + r and + gs
      const int p = r0 / gs;
      klo = 2 * p * gs + (r0 - p * gs);
      g_lo = 2 * p;
    } else {
      klo = r0;
      g_lo = r0 / gs;
    }
    unsigned w[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      w[i] = __ldg(reinterpret_cast<const unsigned*>(
          q + static_cast<size_t>(r0 + i) * N + n));
    float a_lo[MT][4], a_hi[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) a_lo[m][j] = a_hi[m][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; i += 4) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xl[4], xh[4];
        load4(xrow[m] + klo + i, xl);
        if (kInt4) load4(xrow[m] + klo + gs + i, xh);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int b = static_cast<int8_t>((w[i + t] >> (8 * j)) & 0xFF);
            if (kInt4) {
              a_lo[m][j] = fmaf(xl[t], static_cast<float>((b & 0xF) - 8), a_lo[m][j]);
              a_hi[m][j] = fmaf(xh[t], static_cast<float>(b >> 4), a_hi[m][j]);
            } else {
              a_lo[m][j] = fmaf(xl[t], static_cast<float>(b), a_lo[m][j]);
            }
          }
        }
      }
    }
    if (kInt4) {
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(
          scales + static_cast<size_t>(g_lo) * N + n));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(
          scales + static_cast<size_t>(g_lo + 1) * N + n));
      const float sl[4] = {s0.x, s0.y, s0.z, s0.w};
      const float sh[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][j] += a_lo[m][j] * sl[j] + a_hi[m][j] * sh[j];
    } else if (per_col) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += a_lo[m][j];
    } else {
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(
          scales + static_cast<size_t>(g_lo) * N + n));
      const float s[4] = {s0.x, s0.y, s0.z, s0.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += a_lo[m][j] * s[j];
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[kg][m][4 * cx + j] = acc[m][j];
  __syncthreads();
  for (int o = tid; o < MT * kSmallCols; o += kThreads) {
    const int m = o / kSmallCols, col = o % kSmallCols;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kSmallGroups; ++g) s += red[g][m][col];
    if (per_col) s *= scales[n0 + col];
    if (m0 + m < M) ep(m0 + m, n0 + col, s);
  }
}

template <bool kInt4, int MT>
__device__ __forceinline__ void tile_w16_small(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ out, int M,
    int K, int N, int gs, bool per_col, int m0, int n0) {
  tile_w16_small_ep<kInt4, MT>(x, q, scales, StoreBf16{out, N}, M, K, N, gs,
                               per_col, m0, n0);
}

// ---------------------------------------------------------------------
// W4A16 / W8A16, many rows: bf16 tensor cores (wmma), dequantized tiles
// ---------------------------------------------------------------------

constexpr int kWBM = 64, kWBN = 64;  // output tile
constexpr int kWKS = 32;             // weight rows per k-step
constexpr int kWThreads = 128;       // 4 warps, 2 x 2, 32 x 32 each

template <bool kInt4>
struct WmmaSmem {
  static constexpr int BK = kInt4 ? 2 * kWKS : kWKS;  // logical rows a k-step
  static constexpr int LDA = BK + 8, LDB = kWBN + 8, LDC = kWBN + 4;
  __align__(32) __nv_bfloat16 As[kWBM][LDA];
  __align__(32) __nv_bfloat16 Bs[BK][LDB];
  __align__(32) float Cs[kWBM][LDC];
};

template <bool kInt4, typename Ep>
__device__ __forceinline__ void tile_w16_wmma_ep(
    WmmaSmem<kInt4>& sm, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ scales,
    const Ep& ep, int M, int K, int N, int gs, bool per_col, int m0, int n0) {
  using namespace nvcuda;
  using Smem = WmmaSmem<kInt4>;
  constexpr int BK = Smem::BK;
  constexpr int LDA = Smem::LDA, LDB = Smem::LDB, LDC = Smem::LDC;
  auto& As = sm.As;
  auto& Bs = sm.Bs;
  auto& Cs = sm.Cs;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int steps = (kInt4 ? K / 2 : K) / kWKS;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int s = 0; s < steps; ++s) {
    const int r0 = s * kWKS;
    int klo, g_lo;
    if (kInt4) {
      const int p = r0 / gs;
      klo = 2 * p * gs + (r0 - p * gs);
      g_lo = 2 * p;
    } else {
      klo = r0;
      g_lo = r0 / gs;
    }
    // A: x columns klo..klo+31 (INT4: and klo+gs..+31) of rows m0..m0+63
    for (int idx = tid; idx < kWBM * 4 * (kInt4 ? 2 : 1); idx += kWThreads) {
      const int seg = idx / (kWBM * 4);
      const int j = idx % (kWBM * 4);
      const int i = j / 4, c = (j % 4) * 8;
      const int m = m0 + i;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M) {
        v = __ldg(reinterpret_cast<const int4*>(
            x + static_cast<size_t>(m) * K + klo + seg * gs + c));
      }
      *reinterpret_cast<int4*>(&As[i][seg * kWKS + c]) = v;
    }
    {  // B: 32 weight rows x 64 columns, one 16-byte load a thread
      const int rr = tid / 4, cc = (tid % 4) * 16;
      const int4 raw = __ldg(reinterpret_cast<const int4*>(
          q + static_cast<size_t>(r0 + rr) * N + n0 + cc));
      const unsigned words[4] = {static_cast<unsigned>(raw.x),
                                 static_cast<unsigned>(raw.y),
                                 static_cast<unsigned>(raw.z),
                                 static_cast<unsigned>(raw.w)};
      float s_lo[16], s_hi[16];
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        if (kInt4 || !per_col) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(
              scales + static_cast<size_t>(g_lo) * N + n0 + cc + j));
          s_lo[j] = a.x; s_lo[j + 1] = a.y; s_lo[j + 2] = a.z; s_lo[j + 3] = a.w;
        } else {
          s_lo[j] = s_lo[j + 1] = s_lo[j + 2] = s_lo[j + 3] = 1.f;
        }
        if (kInt4) {
          const float4 h = __ldg(reinterpret_cast<const float4*>(
              scales + static_cast<size_t>(g_lo + 1) * N + n0 + cc + j));
          s_hi[j] = h.x; s_hi[j + 1] = h.y; s_hi[j + 2] = h.z; s_hi[j + 3] = h.w;
        }
      }
      // two bf16 a 32-bit word, the lower column in the low half
      unsigned lo[8], hi[8];
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const int v0 = static_cast<int8_t>((words[j / 4] >> (8 * (j % 4))) & 0xFF);
        const int v1 = static_cast<int8_t>((words[j / 4] >> (8 * (j % 4) + 8)) & 0xFF);
        __nv_bfloat162 l, h;
        if (kInt4) {
          l = __floats2bfloat162_rn(static_cast<float>((v0 & 0xF) - 8) * s_lo[j],
                                    static_cast<float>((v1 & 0xF) - 8) * s_lo[j + 1]);
          h = __floats2bfloat162_rn(static_cast<float>(v0 >> 4) * s_hi[j],
                                    static_cast<float>(v1 >> 4) * s_hi[j + 1]);
        } else {
          l = __floats2bfloat162_rn(static_cast<float>(v0) * s_lo[j],
                                    static_cast<float>(v1) * s_lo[j + 1]);
          h = l;
        }
        lo[j / 2] = *reinterpret_cast<const unsigned*>(&l);
        hi[j / 2] = *reinterpret_cast<const unsigned*>(&h);
      }
      uint4* dst = reinterpret_cast<uint4*>(&Bs[rr][cc]);
      dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      if (kInt4) {
        uint4* dh = reinterpret_cast<uint4*>(&Bs[kWKS + rr][cc]);
        dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm + 16 * i][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk][wn + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kWBM * kWBN; idx += kWThreads) {
    const int i = idx / kWBN, c = idx % kWBN;
    const int m = m0 + i;
    if (m < M) {
      float v = Cs[i][c];
      if (!kInt4 && per_col) v *= scales[n0 + c];
      ep(m, n0 + c, v);
    }
  }
}

template <bool kInt4>
__device__ __forceinline__ void tile_w16_wmma(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ out, int M,
    int K, int N, int gs, bool per_col, int m0, int n0) {
  __shared__ WmmaSmem<kInt4> sm;
  tile_w16_wmma_ep<kInt4>(sm, x, q, scales, StoreBf16{out, N}, M, K, N, gs,
                          per_col, m0, n0);
}


// ---------------------------------------------------------------------
// The tensor-core body: W8A8, W4A8, W8A16 and W4A16 (quant_matmul.cu,
// where the design is described) and the fused MLP's passes
// (fused_step.cu).  Its kernels have internal linkage, so each source that
// includes this header launches (and sets the shared-memory limit of) its
// own copy.
// ---------------------------------------------------------------------

// qmm_mma_kernel's kinds: activations x weight
enum QmmKind : int { kW8A8, kW4A8, kW8A16, kW4A16 };

constexpr int kMmaCols = 128;  // columns a block: 4 warps x 32
constexpr int kMmaRows = 64;   // weight rows a stage
constexpr int kStages = 4;     // cp.async ring

// bytes of activation one weight row meets: W8A8 an int8, W4A8 two (a
// packed row holds a k of each group of its pair), W8A16 a bf16, W4A16 two
template <int kKind>
__host__ __device__ constexpr int x_row_bytes() {
  return kKind == kW8A8 ? 1 : kKind == kW4A16 ? 4 : 2;
}

// bytes of one activation row a stage holds.  Rows are padded by 16
// bytes, so the 8 row addresses of an ldmatrix phase fall on distinct
// banks.
template <int kKind>
__host__ __device__ constexpr int x_bytes() {
  return kMmaRows * x_row_bytes<kKind>();
}

template <int kKind, int MT, int WM>
constexpr int qmm_smem() {
  return kStages * (16 * MT * WM * (x_bytes<kKind>() + 16) +
                    kMmaRows * kMmaCols);
}

// The 16-byte chunk of weight row r that holds chunk ch: a stage's rows are
// swizzled so the B reads hit 32 distinct banks (int8 activations: rows
// 4 quad + i, one word per lane; bf16: rows 2 quad + {0, 1, 8, 9}).
template <int kKind>
__device__ __forceinline__ int w_chunk(int r, int ch) {
  constexpr int kShift = kKind == kW8A16 || kKind == kW4A16 ? 1 : 2;
  return ch ^ (((r >> kShift) & 3) << 1);
}

// Bytes 0, 1 and 2, 3 of w (signed int8) as two registers of two bf16, the
// first byte in the low half: exact, by way of the f32 2^23 + (v + 128).
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
        8388736.f);
  }
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// a - b of two bf16 pairs held in 32-bit registers
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 va, vb;
  memcpy(&va, &a, 4);
  memcpy(&vb, &b, 4);
  const __nv_bfloat162 d = __hsub2(va, vb);
  uint32_t r;
  memcpy(&r, &d, 4);
  return r;
}

// The nibbles of plane P of w's bytes (4 packed INT4 rows of one column)
// as bf16 pairs, exactly, the first byte in the low half: b[0] bytes 0, 1
// and b[1] bytes 2, 3; plane 0 the low nibble less 8, plane 1 the signed
// high nibble.  A nibble n ORed into the bf16 pattern of 128 gives
// 128 + n (0x4300 | n); 136 is then subtracted.  The high nibble u is
// XORed with 8 first, so (u ^ 8) - 8 is its two's-complement value.
template <int P>
__device__ __forceinline__ void s4x4_to_bf16(uint32_t w, uint32_t (&b)[2]) {
  constexpr uint32_t k136 = 0x43084308u;  // bf16 136, twice
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // bytes 2i and 2i + 1 of w in the low byte of each 16-bit half
    const uint32_t t = __byte_perm(w, 0u, 0x4140 + 0x0202 * i);
    b[i] = bf16x2_sub(P == 0 ? (t & 0x000F000Fu) | 0x43004300u
                             : ((t >> 4) & 0x000F000Fu) ^ 0x43084308u,
                      k136);
  }
}

// The 8 f32 at p (16-byte aligned), or zeros.
__device__ __forceinline__ void load8(const float* p, bool ok, float (&v)[8]) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (ok) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The 8 f32 at p of each of P rows `stride` apart, or zeros.
template <int P>
__device__ __forceinline__ void load_rows8(const float* p, size_t stride,
                                           bool ok, float (&v)[P][8]) {
#pragma unroll
  for (int r = 0; r < P; ++r) load8(p + r * stride, ok, v[r]);
}

// One call of qmm_mma_kernel: x [M, .] times K weight rows of N columns
// (W4A8 / W4A16: packed rows, Kp / 2) whose sums fold every gs rows (a
// group; INT4 a pair's gs packed rows), K split into slices of `slice`
// rows.  q[1] and scales[1] are null but for the fused MLP's gate / up
// pass (kDual), which multiplies x by two weights of N columns side by
// side, and whose output rows hold 2 N columns.  ws null: writes bf16 out
// (one slice); else writes each slice's partials (int32 for W8A8 per
// column, else f32) to ws [splits, M, N or 2 N].
struct QmmArgs {
  const void* x;
  const float* sx;  // W8A8 / W4A8 row scales, else null
  const int8_t* q[2];
  const float* scales[2];
  __nv_bfloat16* out;
  void* ws;
  int M, K, N, gs, slice;
};

namespace {

// Block (blockIdx.x, blockIdx.y, blockIdx.z): rows [BM x, BM x + BM),
// column tile y (of the second weight past the first's tiles), weight rows
// [slice z, min(K, slice (z + 1))); the row tiles of one column tile run
// side by side, so a prefill wave reads its weight columns from memory
// once and the rest from L2.
template <int kKind, int MT, int WM, bool kPerCol, bool kDual>
__global__ void __launch_bounds__(128 * WM, WM == 2 && kPerCol ? 2 : 1)
qmm_mma_kernel(const QmmArgs args) {
  constexpr bool kInt = kKind == kW8A8 || kKind == kW4A8;  // int32 sums
  constexpr int kPlanes = kKind == kW4A8 || kKind == kW4A16 ? 2 : 1;
  constexpr int kStepRows = kInt ? 32 : 16;  // weight rows an mma k-step
  constexpr int kSteps = kMmaRows / kStepRows;
  constexpr int XR = x_bytes<kKind>() + 16;
  constexpr int BM = 16 * MT * WM;
  constexpr int NT = 128 * WM;
  constexpr int XS = BM * XR;                // activation bytes a stage
  constexpr int WS = kMmaRows * kMmaCols;    // weight bytes a stage
  using Acc = std::conditional_t<kInt, int, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* xs = smem_raw;
  int8_t* wsm = reinterpret_cast<int8_t*>(smem_raw + kStages * XS);
  const unsigned char* x = static_cast<const unsigned char*>(args.x);
  const int M = args.M, K = args.K, N = args.N, gs = args.gs;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wn = warp % 4, wm = warp / 4;
  const int grp = lane / 4, quad = lane % 4;
  const int m0 = blockIdx.x * BM;
  // kDual (q[1] not null): blocks past the first weight's column tiles
  // take the second weight, whose output columns follow the first's
  const int ty = blockIdx.y;
  const int wsel = kDual ? ty / ((N + kMmaCols - 1) / kMmaCols) : 0;
  const int8_t* q = wsel ? args.q[1] : args.q[0];
  const float* scales = wsel ? args.scales[1] : args.scales[0];
  const int n0 = (ty - wsel * ((N + kMmaCols - 1) / kMmaCols)) * kMmaCols;
  const int ldo = kDual ? 2 * N : N;  // the output's row length
  const int kb = blockIdx.z * args.slice;
  const int ke = min(K, kb + args.slice);
  const int n_steps = (ke - kb) / kStepRows;  // k-steps of the slice
  const int n_stages = (ke - kb + kMmaRows - 1) / kMmaRows;
  const size_t x_ld = static_cast<size_t>(K) * x_row_bytes<kKind>();

  // weight rows past the slice's end, columns past N (a 64-column edge)
  // and activation rows past M are zero-filled (read nothing)
  auto stage = [&](int s, int buf) {
    const int k0 = kb + s * kMmaRows;
    int8_t* wdst = wsm + buf * WS;
    for (int c = tid; c < kMmaRows * 8; c += NT) {
      const int r = c / 8, ch = c % 8;
      const bool ok = k0 + r < ke && n0 + 16 * ch < N;
      qie::mma::cp_async16(
          wdst + r * kMmaCols + 16 * w_chunk<kKind>(r, ch),
          ok ? q + static_cast<size_t>(k0 + r) * N + n0 + 16 * ch : q,
          ok ? 16 : 0);
    }
    unsigned char* xdst = xs + buf * XS;
    constexpr int kChunks = x_bytes<kKind>() / 16;
    for (int c = tid; c < BM * kChunks; c += NT) {
      const int r = c / kChunks, ch = c % kChunks;
      const int m = m0 + r;
      bool ok;
      int kx;  // byte offset in the activation row
      if constexpr (kPlanes == 2) {
        // k-step ch / 4 (packed rows r0..r0+kStepRows-1 of pair r0 / gs),
        // plane (ch / 2) % 2, 16-byte half ch % 2: each plane's 32 bytes
        // of a k-step side by side
        const int r0 = k0 + kStepRows * (ch / 4);
        ok = r0 < ke;
        kx = ((r0 / gs) * 2 * gs + r0 % gs + ((ch / 2) % 2) * gs) *
                 (x_row_bytes<kKind>() / 2) +
             16 * (ch % 2);
      } else {
        ok = k0 + 16 / x_row_bytes<kKind>() * ch < ke;
        kx = x_row_bytes<kKind>() * k0 + 16 * ch;
      }
      ok = ok && m < M;
      qie::mma::cp_async16(xdst + r * XR + 16 * ch,
                           ok ? x + static_cast<size_t>(m) * x_ld + kx : x,
                           ok ? 16 : 0);
    }
  };

  Acc acc[kPlanes][MT][4][4];
  float accf[kPerCol ? 1 : MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) acc[p][i][j][e] = 0;
        if constexpr (!kPerCol) accf[i][j][e] = 0.f;
      }
  // this lane's 8 adjacent output columns (tile j, element e: 4 e + j)
  const int col = n0 + 32 * wn + 8 * quad;
  const bool col_ok = n0 + 32 * wn < N;  // a warp's 32 columns: all or none
  const int word = 8 * wn + grp;  // the B operand's 4-column word of a row
  // the A operand's row and 16-byte half of this lane's ldmatrix address
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_half = (lane / 16) * 16;
  // the next fold: after weight row fold_at, of group g (INT4: pair g, its
  // scale rows 2 g and 2 g + 1), whose scales are loaded a group ahead
  int fold_at = kb + gs, g = kb / gs;
  float sg[kPerCol ? 1 : kPlanes][8];
  if constexpr (!kPerCol) {
    if (fold_at <= ke) {
      load_rows8(scales + static_cast<size_t>(kPlanes * g) * N + col, N,
                 col_ok, sg);
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) stage(s, s);
    qie::mma::cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s % kStages;
    qie::mma::cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();  // ... for every thread; stage s - 1 is free
    if (s + kStages - 1 < n_stages) {
      stage(s + kStages - 1, (s + kStages - 1) % kStages);
    }
    qie::mma::cp_async_commit();
    const unsigned char* xt = xs + buf * XS;
    const int8_t* wt = wsm + buf * WS;
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      if (kSteps * s + h >= n_steps) break;
      auto w_word = [&](int row) {
        return *reinterpret_cast<const unsigned*>(
            wt + row * kMmaCols + 16 * w_chunk<kKind>(row, word / 4) +
            4 * (word % 4));
      };
      // the A operand of plane p's k-step h, m16 tile i
      auto a_addr = [&](int i, int p) {
        return xt + (16 * (MT * wm + i) + a_row) * XR + 32 * kPlanes * h +
               32 * p + a_half;
      };
      if constexpr (kInt) {
        unsigned b[2][4];  // k 0..15 / 16..31 of column tiles 0..3
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = 32 * h + 16 * hi + 4 * quad;
          transpose4x4(w_word(row), w_word(row + 1), w_word(row + 2),
                       w_word(row + 3), b[hi]);
        }
        unsigned bp[kPlanes][2][4];  // each plane's B registers
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (kKind == kW4A8) {
              bp[0][hi][j] = __vsub4(b[hi][j] & 0x0F0F0F0Fu, 0x08080808u);
              bp[kPlanes - 1][hi][j] =
                  static_cast<unsigned>(high_nibbles(b[hi][j]));
            } else {
              bp[0][hi][j] = b[hi][j];
            }
          }
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            qie::mma::ldmatrix_x4(a[i], a_addr(i, p));
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              qie::mma::mma_s8(acc[p][i][j], a[i], bp[p][0][j], bp[p][1][j]);
            }
        }
      } else {
        const int row = 16 * h + 2 * quad;
        unsigned colw[4];  // INT4: both planes' B registers, one transpose
        transpose4x4(w_word(row), w_word(row + 1), w_word(row + 8),
                     w_word(row + 9), colw);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          uint32_t b[4][2];  // column tile j: k (2q, 2q+1), (2q+8, 2q+9)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (kKind == kW4A16) {
              if (p == 0) {
                s4x4_to_bf16<0>(colw[j], b[j]);
              } else {
                s4x4_to_bf16<1>(colw[j], b[j]);
              }
            } else {
              s8x4_to_bf16(colw[j], b[j][0], b[j][1]);
            }
          }
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            qie::mma::ldmatrix_x4(a[i], a_addr(i, p));
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              qie::mma::mma_bf16(acc[p][i][j], a[i], b[j][0], b[j][1]);
            }
        }
      }
      if constexpr (!kPerCol) {
        if (kb + kStepRows * (kSteps * s + h + 1) == fold_at) {
          // a group's (INT4: a pair's) sum is done
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 4 * (e % 2) + j;
                if constexpr (kPlanes == 2) {  // acc + (a s_lo + b s_hi)
                  accf[i][j][e] = __fadd_rn(
                      accf[i][j][e],
                      __fadd_rn(
                          __fmul_rn(static_cast<float>(acc[0][i][j][e]),
                                    sg[0][c]),
                          __fmul_rn(static_cast<float>(
                                        acc[kPlanes - 1][i][j][e]),
                                    sg[kPlanes - 1][c])));
                  acc[kPlanes - 1][i][j][e] = 0;
                } else {
                  accf[i][j][e] +=
                      static_cast<float>(acc[0][i][j][e]) * sg[0][c];
                }
                acc[0][i][j][e] = 0;
              }
          ++g;
          fold_at += gs;
          if (fold_at <= ke) {
            load_rows8(scales + static_cast<size_t>(kPlanes * g) * N + col,
                       N, col_ok, sg);
          }
        }
      }
    }
  }
  qie::mma::cp_async_wait<0>();

  float sc[8];
  if constexpr (kPerCol) load8(scales + col, col_ok, sc);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows grp, grp + 8
      const int m = m0 + 16 * (MT * wm + i) + grp + 8 * half;
      if (m >= M || !col_ok) continue;
      const size_t at = static_cast<size_t>(m) * ldo + wsel * N + col;
      if (args.ws != nullptr) {  // this slice's partials
        uint32_t v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = c % 4, e = 2 * half + c / 4;
          if constexpr (!kPerCol) {
            v[c] = __float_as_uint(accf[i][j][e]);
          } else if constexpr (kInt) {
            v[c] = static_cast<uint32_t>(acc[0][i][j][e]);
          } else {
            v[c] = __float_as_uint(acc[0][i][j][e]);
          }
        }
        uint32_t* dst = static_cast<uint32_t*>(args.ws) +
                        static_cast<size_t>(blockIdx.z) * M * ldo + at;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(dst + 4) = make_uint4(v[4], v[5], v[6], v[7]);
      } else {
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = c % 4, e = 2 * half + c / 4;
          if constexpr (!kPerCol) {
            if constexpr (kInt) {
              y[c] = accf[i][j][e] * args.sx[m];
            } else {
              y[c] = accf[i][j][e];
            }
          } else if constexpr (kInt) {
            y[c] = static_cast<float>(acc[0][i][j][e]) * sc[c] * args.sx[m];
          } else {
            y[c] = acc[0][i][j][e] * sc[c];
          }
        }
        *reinterpret_cast<uint4*>(args.out + at) =
            make_uint4(qie::mma::pack_bf16(y[0], y[1]),
                       qie::mma::pack_bf16(y[2], y[3]),
                       qie::mma::pack_bf16(y[4], y[5]),
                       qie::mma::pack_bf16(y[6], y[7]));
      }
    }
  }
}

// out [M, N] = the sum of ws [splits, M, N] over its splits, in split order
// (int32 for W8A8 per column, else f32), x the column scale (scales not
// null) x sx (not null), rounded once; each thread 8 adjacent columns.
template <bool kIntSum>
__global__ void __launch_bounds__(kThreads)
qmm_reduce(const void* __restrict__ ws, const float* __restrict__ sx,
           const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
           int M, int N, int splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(M) * N / 8) return;
  const int m = static_cast<int>(idx / (N / 8));
  const int col = static_cast<int>(idx % (N / 8)) * 8;
  const size_t plane = static_cast<size_t>(M) * N;
  const uint4* src = reinterpret_cast<const uint4*>(
      static_cast<const uint32_t*>(ws) + static_cast<size_t>(m) * N + col);
  int isum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float fsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const uint4 lo = src[s * plane / 4], hi = src[s * plane / 4 + 1];
    const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if constexpr (kIntSum) {
        isum[c] += static_cast<int>(v[c]);
      } else {
        fsum[c] += __uint_as_float(v[c]);
      }
    }
  }
  float y[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    y[c] = kIntSum ? static_cast<float>(isum[c]) : fsum[c];
    if (scales != nullptr) y[c] *= scales[col + c];
    if (sx != nullptr) y[c] *= sx[m];
  }
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + col) =
      make_uint4(qie::mma::pack_bf16(y[0], y[1]),
                 qie::mma::pack_bf16(y[2], y[3]),
                 qie::mma::pack_bf16(y[4], y[5]),
                 qie::mma::pack_bf16(y[6], y[7]));
}

// qmm_mma_kernel over `splits` slices (args.ws as given: a caller that
// wants bf16 out from one slice passes null).
template <int kKind, int MT, int WM, bool kPerCol, bool kDual>
cudaError_t launch_mma(const QmmArgs& args, int splits, cudaStream_t st) {
  const auto kern = qmm_mma_kernel<kKind, MT, WM, kPerCol, kDual>;
  constexpr int smem = qmm_smem<kKind, MT, WM>();
  if (smem > 48 * 1024) {  // past the default limit
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  const int bm = 16 * MT * WM;
  const int tiles = (args.N + kMmaCols - 1) / kMmaCols * (kDual ? 2 : 1);
  kern<<<dim3((args.M + bm - 1) / bm, tiles, splits), 128 * WM, smem, st>>>(
      args);
  return cudaGetLastError();
}

// mt 1 or 4: the decode stream's m16 tiles a warp (one warp row); 0: the
// prefill tiles (MT 4, WM 2: 128 x 128, 8 warps).  kDual: args holds two
// weights (the fused MLP's gate / up).
template <int kKind, bool kPerCol, bool kDual = false>
cudaError_t launch_mma_mt(int mt, const QmmArgs& args, int splits,
                          cudaStream_t st) {
  switch (mt) {
    case 1:
      return launch_mma<kKind, 1, 1, kPerCol, kDual>(args, splits, st);
    case 4:
      return launch_mma<kKind, 4, 1, kPerCol, kDual>(args, splits, st);
    default:
      return launch_mma<kKind, 4, 2, kPerCol, kDual>(args, splits, st);
  }
}

// A matmul on the tensor-core body: one slice writes bf16 out directly;
// more write their partials to args.ws, which qmm_reduce adds in split
// order, with the column scale (per column) and sx (int8 activations).
template <int kKind, bool kPerCol>
cudaError_t run_mma(int mt, QmmArgs args, int splits, cudaStream_t st) {
  void* ws = args.ws;
  if (splits == 1) args.ws = nullptr;
  cudaError_t rc = launch_mma_mt<kKind, kPerCol>(mt, args, splits, st);
  if (rc != cudaSuccess || splits == 1) return rc;
  const size_t threads = static_cast<size_t>(args.M) * args.N / 8;
  constexpr bool kInt = kKind == kW8A8 || kKind == kW4A8;
  qmm_reduce<kKind == kW8A8 && kPerCol>
      <<<(threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          ws, kInt ? args.sx : nullptr, kPerCol ? args.scales[0] : nullptr,
          args.out, args.M, args.N, splits);
  return cudaGetLastError();
}

}  // namespace

// A tensor-core call's plan over `rows` weight rows: mt 1 or 4 (the
// decode stream's tiles: 16 mt rows a block) or 0 (the prefill tiles,
// 128 rows a block), with `splits` slices of `slice` rows
// (multiples of 32 and of `unit`, the last may be shorter; ws not null when
// splits > 1).  cp.async copies 16-byte chunks of x and q, and the scales
// and partials move in 16-byte words.
inline bool mma_call_ok(int M, int rows, int unit, int mt, int splits,
                        int slice, const void* ws, const void* x,
                        const void* q, const void* scales) {
  const bool plan_ok =
      (mt == 0 || mt == 1 || mt == 4) && M > 0 && splits >= 1 &&
      slice > 0 && slice % 32 == 0 && slice % unit == 0 &&
      static_cast<long long>(splits - 1) * slice < rows &&
      static_cast<long long>(splits) * slice >= rows &&
      (splits == 1 || ws != nullptr);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(scales) |
       reinterpret_cast<uintptr_t>(ws)) % 16 == 0;
  return plan_ok && aligned;
}

}  // namespace qie
