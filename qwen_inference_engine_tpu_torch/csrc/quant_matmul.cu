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
// * W4A8 and W8A8 (__dp4a, s8 x s8 -> s32): a block computes a BM x 128
//   output tile with 256 threads; each thread owns TM rows x 4 adjacent
//   columns.  Per k-step the block stages 32 weight rows (4 KB, 16-byte
//   coalesced loads) and the matching activation columns in shared memory.
//   A thread reads 4 rows of its 4 columns as four 32-bit words and
//   transposes them with __byte_perm, so each word holds 4 consecutive k
//   of one column.  W4A8 unpacks the nibbles four at a time (lo+8 = w &
//   0x0F0F0F0F, hi by a per-byte signed shift with __vsub4), accumulates
//   each plane-pair's two products in int32, corrects the lo plane's
//   excess-8 by 8 * rowsum(x_even), and scales the int32 partials into f32.
//   W8A8 accumulates each group exactly in int32 and scales it into f32 at
//   the group's end (G = 1: in the epilogue).  The row scale is applied in
//   the epilogue.
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
// Tensor-core a8 kernels (mma.sync / wgmma on s8), a pipelined (TMA)
// weight stream and split-K for decode are left to later work.
//
// The tile bodies live in quant_matmul_core.cuh, shared with the grouped
// MoE kernels (grouped_matmul.cu); each kernel here is one tile per block.

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

template <int TM>
__global__ void __launch_bounds__(kThreads)
qmm8_a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, int M, int K, int N, int gs,
               bool per_col) {
  qie::tile_8a8<TM>(x, sx, q, scales, out, M, K, N, gs, per_col,
                    blockIdx.y * 8 * TM, blockIdx.x * kBN);
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

extern "C" int qie_quant_matmul8_a8(const void* x, const void* sx,
                                    const void* q, const void* scales,
                                    void* out, int M, int K, int N, int G,
                                    int layer, int L, void* stream) {
  if (M <= 0 || N % kBN || K % kBKP || G <= 0 || K % G ||
      (G > 1 && (K / G) % kBKP) || layer < 0 || layer >= L) {
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
  if (M <= 16) {
    qmm8_a8_kernel<2><<<dim3(N / kBN, (M + 15) / 16), kThreads, 0, st>>>(
        xq, sxf, ql, sl, o, M, K, N, K / G, G == 1);
  } else {
    qmm8_a8_kernel<8><<<dim3(N / kBN, (M + 63) / 64), kThreads, 0, st>>>(
        xq, sxf, ql, sl, o, M, K, N, K / G, G == 1);
  }
  return static_cast<int>(cudaGetLastError());
}
