// Quantized matmuls for Hopper (sm_90a): y[M,N] = x @ Wq[layer], bf16 out.
//
// Four kernels, each the port of one Pallas kernel of
// qwen_inference_engine_tpu/ops/quant_matmul.py:
//
//   qmm4_a8_kernel   <- _quant_matmul4_a8 (_qmm4_a8_kernel): W4A8
//   qmm_w16_small / qmm_w16_wmma <INT4>  <- _quant_matmul4 (_qmm4_kernel): W4A16
//   qmm_w16_small / qmm_w16_wmma <INT8>  <- _quant_matmul8 (_qmm8_kernel): W8A16
//   qmm8_a8_kernel   <- _quant_matmul8_a8 (_qmm8_a8_kernel): W8A8
//
// Weights are layer-stacked; the host offsets q and scales to the layer's
// slab (in size_t: a 28-layer INT8 stack is 6.5 GB), so the stacked
// weights are never copied.  INT4 is the plane-pair layout q [L, Kp/2, N]
// int8 (byte = 16*hi + (lo+8); packed rows p*gs..(p+1)*gs hold group 2p in
// the low nibble, group 2p+1 in the high nibble) with scales
// [L, Kp/gs, N] f32.  INT8 is q [L, K, N] with scales [L, G, N]: a scale
// per group of gs = K/G rows, or one per column (G = 1).  The a8 variants
// take per-token int8 activations with f32 row scales sx [M], quantized
// outside the kernel as in the JAX package.  Every kernel computes what the
// TPU kernel does: the sum over groups of (x . q) x scale in f32 (x sx),
// then rounded to bf16.
//
// What bounds them on the H100: at decode (M = batch, a few rows) each
// weight byte is read once for 2*M operations: bound by bytes (the weight
// bytes at 3.35 TB/s).  At prefill (M = 512 * batch) they are bound by
// operations (989 TFLOP/s bf16, 1979 TOP/s int8 on the tensor cores).
//
// Designs, the simple and right versions first:
//
// * W4A8 (__dp4a, s8 x s8 -> s32): a block computes a BM x 128 output
//   tile with 256 threads; each thread owns TM rows x 4 adjacent columns.
//   Per k-step the block stages 32 weight rows (4 KB, 16-byte coalesced
//   loads) and the matching activation columns in shared memory.  A
//   thread reads 4 rows of its 4 columns as four 32-bit words and
//   transposes them with __byte_perm, so each word holds 4 consecutive k
//   of one column.  It unpacks the nibbles four at a time (lo+8 = w &
//   0x0F0F0F0F, hi by a per-byte signed shift with __vsub4), accumulates
//   each plane-pair's two products in int32, corrects the lo plane's
//   excess-8 by 8 * rowsum(x_even), and scales the int32 partials into f32.
//   The row scale is applied in the epilogue.
// * W8A8 (qmm8_a8_kernel, the int8 tensor cores: mma.sync m16n8k32
//   s8 x s8 -> s32).  Each warp owns 16 * MT rows x 32 columns; a block is
//   WM x 4 warps, 128 columns wide.  The weight tile (64 k-rows x 128
//   columns a stage) and the activation tile are staged by cp.async into a
//   ring of kStages, so three tiles are in flight while one is multiplied.
//   The activations feed the A operand with ldmatrix.  The weight is
//   [K, N] with N contiguous (the JAX package's bytes, never repacked)
//   while the B operand wants 4 consecutive k of one column in a register:
//   a thread reads 4 k-rows of one 4-column word from shared memory and
//   transposes them with __byte_perm (transpose4x4), which gives its B
//   registers for 4 column tiles at once; the tiles' columns are permuted
//   (tile j, column g -> 4 g + j), so a thread's accumulators cover 8
//   adjacent output columns and store as one 16-byte word.  The weight
//   rows are XOR-swizzled by 16-byte chunk so those reads hit 32 distinct
//   banks.  A group's int32 sum is exact and is scaled into f32 at the
//   group's end (one scale per column: in the epilogue).
//   - Decode (M <= 64, MT = 1 or 4, one warp row): bound by the weight
//     bytes, and N / 128 blocks would leave most of the 132 SMs idle, so K
//     is split into slices that end on group boundaries
//     (ops/quant_matmul.py plans them: about 4 blocks an SM).  Each slice
//     writes its partial sums (int32 for one scale per column, else f32)
//     to a workspace the wrapper allocates, and qmm8_a8_reduce adds them in
//     split order, applies the column scale and sx, and rounds once: no
//     float atomics, two calls bit-identical, and one scale per column
//     exact (float(sum) * scale * sx, whatever the split count).
//   - Prefill (M > 64): MT = 4, WM = 2 (128 x 128 tiles, 8 warps), no
//     split; the bf16 output is written directly.
// * W4A16 and W8A16 at M <= 16 (qmm_w16_small): bound by bytes, so the
//   weights are streamed once with f32 FMAs on the CUDA cores.  A block
//   owns 64 columns (16 threads x 4) and splits K over 16 thread groups in
//   chunks of 32 weight rows (one scale group each); a thread issues its
//   chunk's 32 weight loads before it computes, to keep bytes in flight.
//   Each chunk's sums are scaled into f32 (G = 1: in the epilogue); the 16
//   partial sums of a column are added in a fixed order through shared
//   memory, so the result does not depend on scheduling.
// * W4A16 and W8A16 at M > 16 (qmm_w16_wmma): bound by operations, so the
//   bf16 tensor cores through nvcuda::wmma 16x16x16 fragments with an f32
//   accumulator (4 warps, a 64 x 64 tile, 2 x 2 fragments a warp).  Per
//   k-step the block dequantizes 32 weight rows (64 logical rows for INT4:
//   both planes of a plane-pair) into bf16 in shared memory, q * scale
//   (G = 1: q alone, exact in bf16, the column scale in the epilogue).
// A tensor-core W4A8 kernel, a pipelined (TMA) weight stream for the w16
// kernels and split-K for W4A8 / W4A16 decode are left to later work.
//
// The W4A8 and w16 tile bodies live in quant_matmul_core.cuh, shared with
// the grouped MoE kernels (grouped_matmul.cu); each kernel here is one tile
// per block.  The W8A8 kernel uses the PTX wrappers of attention_mma.cuh
// (qie::mma: cp.async, ldmatrix, mma.sync).

#include "attention_mma.cuh"
#include "quant_matmul_core.cuh"

namespace {

using qie::kBN;
using qie::kBKP;
using qie::kChunk;
using qie::kSmallCols;
using qie::kThreads;
using qie::kWBM;
using qie::kWBN;
using qie::kWThreads;

template <int TM>
__global__ void __launch_bounds__(kThreads)
qmm4_a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, int M, int Kp, int N, int gs) {
  qie::tile_4a8<TM>(x, sx, q, scales, out, M, Kp, N, gs, blockIdx.y * 8 * TM,
                    blockIdx.x * kBN);
}

// ---- W8A8 on the int8 tensor cores
constexpr int k8Cols = 128;          // columns a block: 4 warps x 32
constexpr int k8Rows = 64;           // k-rows a stage
constexpr int k8XRow = k8Rows + 16;  // staged activation row, padded (bytes)
constexpr int kStages = 4;           // cp.async ring

template <int MT, int WM>
constexpr int qmm8_a8_smem() {
  return kStages * (16 * MT * WM * k8XRow + k8Rows * k8Cols);
}

// The 16-byte chunk of weight row r that holds chunk ch: a stage's rows are
// swizzled so the B reads (rows 4 quad + i, one word per lane) hit 32
// distinct banks.
__device__ __forceinline__ int w_chunk(int r, int ch) {
  return ch ^ (((r >> 2) & 3) << 1);
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): rows [BM x, BM x + BM),
// columns [128 y, 128 y + 128), k-rows [slice z, min(K, slice (z + 1)));
// the row tiles of one column tile run side by side, so a prefill wave
// reads its weight columns from memory once and the rest from L2.  ws
// null: writes bf16 out (one slice over K); else writes the slice's
// partials (int32 per column, else f32) to ws [splits, M, N].
template <int MT, int WM, bool kPerCol>
__global__ void __launch_bounds__(128 * WM, WM == 2 && kPerCol ? 2 : 1)
qmm8_a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, void* __restrict__ ws, int M,
               int K, int N, int gs, int slice) {
  constexpr int BM = 16 * MT * WM;
  constexpr int NT = 128 * WM;
  constexpr int XS = BM * k8XRow;       // activation bytes a stage
  constexpr int WS = k8Rows * k8Cols;   // weight bytes a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* wsm = xs + kStages * XS;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wn = warp % 4, wm = warp / 4;
  const int grp = lane / 4, quad = lane % 4;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * k8Cols;
  const int kb = blockIdx.z * slice;
  const int ke = min(K, kb + slice);
  const int n_steps = (ke - kb) / 32;  // k32 steps of the slice
  const int n_stages = (ke - kb + k8Rows - 1) / k8Rows;

  // rows past the slice's end or M are zero-filled (read nothing)
  auto stage = [&](int s, int buf) {
    const int k0 = kb + s * k8Rows;
    int8_t* wdst = wsm + buf * WS;
    for (int c = tid; c < k8Rows * 8; c += NT) {
      const int r = c / 8, ch = c % 8;
      const bool ok = k0 + r < ke;
      qie::mma::cp_async16(
          wdst + r * k8Cols + 16 * w_chunk(r, ch),
          ok ? q + static_cast<size_t>(k0 + r) * N + n0 + 16 * ch : q,
          ok ? 16 : 0);
    }
    int8_t* xdst = xs + buf * XS;
    for (int c = tid; c < BM * 4; c += NT) {
      const int r = c / 4, ch = c % 4;
      const int m = m0 + r, k = k0 + 16 * ch;
      const bool ok = m < M && k < ke;
      qie::mma::cp_async16(xdst + r * k8XRow + 16 * ch,
                           ok ? x + static_cast<size_t>(m) * K + k : x,
                           ok ? 16 : 0);
    }
  };

  int acc[MT][4][4];
  float accf[kPerCol ? 1 : MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if constexpr (!kPerCol) accf[i][j][e] = 0.f;
      }
  // this thread's 8 adjacent output columns (tile j, element e: 4 e + j)
  const int col = n0 + 32 * wn + 8 * quad;
  const int word = 8 * wn + grp;  // the B operand's 4-column word of a row

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
    const int8_t* xt = xs + buf * XS;
    const int8_t* wt = wsm + buf * WS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (2 * s + h >= n_steps) break;
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        qie::mma::ldmatrix_x4(
            a[i], xt + (16 * (MT * wm + i) + lane % 8 + ((lane / 8) % 2) * 8) *
                           k8XRow + 32 * h + (lane / 16) * 16);
      }
      unsigned b[2][4];  // k 0..15 / 16..31 of column tiles 0..3
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        unsigned r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 32 * h + 16 * hi + 4 * quad + i;
          r[i] = *reinterpret_cast<const unsigned*>(
              wt + row * k8Cols + 16 * w_chunk(row, word / 4) + 4 * (word % 4));
        }
        qie::transpose4x4(r[0], r[1], r[2], r[3], b[hi]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qie::mma::mma_s8(acc[i][j], a[i], b[0][j], b[1][j]);
        }
      if constexpr (!kPerCol) {
        const int kend = kb + 32 * (2 * s + h + 1);
        if (kend % gs == 0) {  // a group's exact sum is done
          const float* sg =
              scales + static_cast<size_t>(kend / gs - 1) * N + col;
          const float4 s0 = __ldg(reinterpret_cast<const float4*>(sg));
          const float4 s1 = __ldg(reinterpret_cast<const float4*>(sg + 4));
          const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                accf[i][j][e] +=
                    static_cast<float>(acc[i][j][e]) * sc[4 * (e % 2) + j];
                acc[i][j][e] = 0;
              }
        }
      }
    }
  }
  qie::mma::cp_async_wait<0>();

  float sc[8];
  if constexpr (kPerCol) {
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(scales + col));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(scales + col + 4));
    sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
    sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows grp, grp + 8
      const int m = m0 + 16 * (MT * wm + i) + grp + 8 * half;
      if (m >= M) continue;
      if (ws != nullptr) {  // this slice's partials
        uint32_t v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = c % 4, e = 2 * half + c / 4;
          if constexpr (kPerCol) {
            v[c] = static_cast<uint32_t>(acc[i][j][e]);
          } else {
            v[c] = __float_as_uint(accf[i][j][e]);
          }
        }
        uint32_t* dst = static_cast<uint32_t*>(ws) +
                        (static_cast<size_t>(blockIdx.z) * M + m) * N + col;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(dst + 4) = make_uint4(v[4], v[5], v[6], v[7]);
      } else {
        const float r = sx[m];
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = c % 4, e = 2 * half + c / 4;
          if constexpr (kPerCol) {
            y[c] = static_cast<float>(acc[i][j][e]) * sc[c] * r;
          } else {
            y[c] = accf[i][j][e] * r;
          }
        }
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + col) =
            make_uint4(qie::mma::pack_bf16(y[0], y[1]),
                       qie::mma::pack_bf16(y[2], y[3]),
                       qie::mma::pack_bf16(y[4], y[5]),
                       qie::mma::pack_bf16(y[6], y[7]));
      }
    }
  }
}

// out [M, N] = the sum of ws [splits, M, N] over its splits, in split order
// (int32 per column, then x the column scale; else f32), x sx, rounded
// once; each thread 8 adjacent columns.
template <bool kPerCol>
__global__ void __launch_bounds__(kThreads)
qmm8_a8_reduce(const void* __restrict__ ws, const float* __restrict__ sx,
               const float* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
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
      if constexpr (kPerCol) {
        isum[c] += static_cast<int>(v[c]);
      } else {
        fsum[c] += __uint_as_float(v[c]);
      }
    }
  }
  float y[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    y[c] = kPerCol ? static_cast<float>(isum[c]) * scales[col + c] * sx[m]
                   : fsum[c] * sx[m];
  }
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + col) =
      make_uint4(qie::mma::pack_bf16(y[0], y[1]),
                 qie::mma::pack_bf16(y[2], y[3]),
                 qie::mma::pack_bf16(y[4], y[5]),
                 qie::mma::pack_bf16(y[6], y[7]));
}

template <int MT, int WM, bool kPerCol>
cudaError_t launch_8a8(const int8_t* x, const float* sx, const int8_t* q,
                       const float* s, __nv_bfloat16* out, void* ws, int M,
                       int K, int N, int gs, int splits, int slice,
                       cudaStream_t st) {
  const auto kern = qmm8_a8_kernel<MT, WM, kPerCol>;
  constexpr int smem = qmm8_a8_smem<MT, WM>();
  cudaError_t rc;
  if (smem > 48 * 1024) {  // past the default limit (M > 32)
    rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  const int bm = 16 * MT * WM;
  kern<<<dim3((M + bm - 1) / bm, N / k8Cols, splits), 128 * WM, smem, st>>>(
      x, sx, q, s, out, splits > 1 ? ws : nullptr, M, K, N, gs, slice);
  if (splits > 1) {
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    const size_t threads = static_cast<size_t>(M) * N / 8;
    qmm8_a8_reduce<kPerCol><<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                              st>>>(ws, sx, s, out, M, N, splits);
  }
  return cudaGetLastError();
}

template <bool kPerCol>
cudaError_t launch_8a8_mt(int mt, const int8_t* x, const float* sx,
                          const int8_t* q, const float* s,
                          __nv_bfloat16* out, void* ws, int M, int K, int N,
                          int gs, int splits, int slice, cudaStream_t st) {
  switch (mt) {
    case 1:
      return launch_8a8<1, 1, kPerCol>(x, sx, q, s, out, ws, M, K, N, gs,
                                       splits, slice, st);
    case 4:
      return launch_8a8<4, 1, kPerCol>(x, sx, q, s, out, ws, M, K, N, gs,
                                       splits, slice, st);
    default:  // prefill
      return launch_8a8<4, 2, kPerCol>(x, sx, q, s, out, ws, M, K, N, gs, 1,
                                       K, st);
  }
}

template <bool kInt4, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_w16_small_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     __nv_bfloat16* __restrict__ out, int M, int K, int N,
                     int gs, bool per_col) {
  qie::tile_w16_small<kInt4, MT>(x, q, scales, out, M, K, N, gs, per_col,
                                 blockIdx.y * MT, blockIdx.x * kSmallCols);
}

template <bool kInt4>
__global__ void __launch_bounds__(kWThreads)
qmm_w16_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int gs, bool per_col) {
  qie::tile_w16_wmma<kInt4>(x, q, scales, out, M, K, N, gs, per_col,
                            blockIdx.y * kWBM, blockIdx.x * kWBN);
}

// The bf16-activation kernels for both weight types: CUDA cores at
// M <= 16, tensor cores above.
template <bool kInt4>
cudaError_t launch_w16(const void* x, const int8_t* q, const float* s,
                       void* out, int M, int K, int N, int gs, bool per_col,
                       cudaStream_t st) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (M <= 4) {
    qmm_w16_small_kernel<kInt4, 4><<<dim3(N / kSmallCols, 1), kThreads, 0, st>>>(
        xb, q, s, o, M, K, N, gs, per_col);
  } else if (M <= 16) {
    qmm_w16_small_kernel<kInt4, 8><<<dim3(N / kSmallCols, (M + 7) / 8), kThreads,
                                     0, st>>>(xb, q, s, o, M, K, N, gs, per_col);
  } else {
    qmm_w16_wmma_kernel<kInt4><<<dim3(N / kWBN, (M + kWBM - 1) / kWBM),
                                 kWThreads, 0, st>>>(xb, q, s, o, M, K, N, gs,
                                                     per_col);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int qie_quant_matmul4_a8(const void* x, const void* sx,
                                    const void* q, const void* scales,
                                    void* out, int M, int Kp, int N, int gs,
                                    int layer, int L, void* stream) {
  if (M <= 0 || N % kBN || gs <= 0 || gs % kBKP || Kp % (2 * gs) ||
      layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * (Kp / 2) * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * (Kp / gs) * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    dim3 grid(N / kBN, (M + 15) / 16);
    qmm4_a8_kernel<2><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const float*>(sx), ql, sl,
        static_cast<__nv_bfloat16*>(out), M, Kp, N, gs);
  } else {
    dim3 grid(N / kBN, (M + 63) / 64);
    qmm4_a8_kernel<8><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const float*>(sx), ql, sl,
        static_cast<__nv_bfloat16*>(out), M, Kp, N, gs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qie_quant_matmul4(const void* x, const void* q,
                                 const void* scales, void* out, int M, int Kp,
                                 int N, int gs, int layer, int L,
                                 void* stream) {
  if (M <= 0 || N % kSmallCols || gs <= 0 || gs % kChunk || Kp % (2 * gs) ||
      layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * (Kp / 2) * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * (Kp / gs) * N;
  return static_cast<int>(launch_w16<true>(x, ql, sl, out, M, Kp, N, gs,
                                           false,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int qie_quant_matmul8(const void* x, const void* q,
                                 const void* scales, void* out, int M, int K,
                                 int N, int G, int layer, int L,
                                 void* stream) {
  if (M <= 0 || N % kSmallCols || K % kChunk || G <= 0 || K % G ||
      (G > 1 && (K / G) % kChunk) || layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * K * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * G * N;
  return static_cast<int>(launch_w16<false>(x, ql, sl, out, M, K, N, K / G,
                                            G == 1,
                                            static_cast<cudaStream_t>(stream)));
}

// mt: the decode stream's m16 tiles a warp (1 or 4; M <= 16 mt), with K
// split into `splits` slices of `slice` rows (a multiple of 32 and of the
// group size; the last may be shorter; ws [splits, M, N] of 4-byte
// partials when splits > 1); or mt 0, the prefill tiles (splits 1).
extern "C" int qie_quant_matmul8_a8(const void* x, const void* sx,
                                    const void* q, const void* scales,
                                    void* ws, void* out, int M, int K, int N,
                                    int G, int mt, int splits, int slice,
                                    int layer, int L, void* stream) {
  const int gs = G > 0 ? K / G : 0;
  const bool plan_ok =
      mt == 0 ? splits == 1
              : ((mt == 1 || mt == 4) && M <= 16 * mt &&
                 splits >= 1 && slice > 0 && slice % 32 == 0 &&
                 (G == 1 || slice % gs == 0) &&
                 static_cast<long long>(splits - 1) * slice < K &&
                 static_cast<long long>(splits) * slice >= K &&
                 (splits == 1 || ws != nullptr));
  // cp.async copies 16-byte chunks of x and q
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(q)) % 16 == 0;
  if (M <= 0 || N % k8Cols || K % 32 || G <= 0 || K % G ||
      (G > 1 && gs % 32) || layer < 0 || layer >= L || !plan_ok ||
      !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * K * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * G * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const float* sxf = static_cast<const float*>(sx);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  return static_cast<int>(
      G == 1 ? launch_8a8_mt<true>(mt, xq, sxf, ql, sl, o, ws, M, K, N, gs,
                                   splits, slice, st)
             : launch_8a8_mt<false>(mt, xq, sxf, ql, sl, o, ws, M, K, N, gs,
                                    splits, slice, st));
}
