// Shared core of the port's quantized matmuls: y = x @ Wq, bf16 out, one
// output tile per call.  The dense W4A16 kernels (quant_matmul.cu) call
// each tile once per block, at the block's (row, column) tile; the grouped
// MoE kernels (grouped_matmul.cu) call it in a loop over the row tiles of
// the block's expert, with x, out and the row count taken at that
// expert's rows; the fused MLP (fused_step.cu) calls the w16 tiles.  The
// dense W4A8, W8A16 and W8A8 matmuls run on quant_matmul.cu's tensor-core
// kernel instead, which shares only transpose4x4 and high_nibbles.
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
// The tiles (the w16 designs are described in quant_matmul.cu; tile_4a8
// in grouped_matmul.cu):
//   tile_4a8<TM>            int8 x INT4, __dp4a, 256 threads, BM = 8 TM x 128
//   tile_w16_small<I4, MT>  bf16 x INT4/INT8, f32 FMAs, 256 threads, MT x 64
//   tile_w16_wmma<I4>       bf16 x INT4/INT8, wmma bf16, 128 threads, 64 x 64
// A tile's shared memory is static and reused by the next call of the same
// block: a caller that loops over tiles puts a __syncthreads() between
// calls.
//
// The two bf16-activation tiles also come as *_ep versions that hand each
// finished f32 output y[m, n] to an epilogue functor instead of rounding
// it to bf16 (StoreBf16 is the rounding one): the fused MLP
// (fused_step.cu) keeps gate and up in f32 and combines them there.  The
// wmma tile's *_ep version takes its shared memory (WmmaSmem) from the
// caller, so a kernel can overlay it with another block kind's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

}  // namespace qie
