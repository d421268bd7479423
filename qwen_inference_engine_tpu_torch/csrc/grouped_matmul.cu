// Grouped (MoE expert) quantized matmuls for Hopper (sm_90a):
// y[M, N] = x[M, K] @ Wq[layer, e] over rows sorted by expert, where rows
// [offset_e, offset_e + group_sizes[e]) belong to expert e, bf16 out.
//
// Three kernels, each the port of one Pallas kernel of
// qwen_inference_engine_tpu/ops/grouped_matmul.py:
//
//   gmm4_a8_kernel                    <- _grouped_matmul4_a8 (_gmm4_a8_kernel):
//                                        int8 activations x INT4 experts
//   gmm_w16_small / gmm_w16_wmma <I4> <- _grouped_matmul4 (_gmm4_kernel):
//                                        bf16 activations x INT4 experts
//   gmm_w16_small / gmm_w16_wmma <I8> <- _grouped_matmul8 (_gmm8_kernel):
//                                        bf16 activations x INT8 experts
//
// The expert stacks are q [L, E, Kp/2, N] INT4 plane pairs with scales
// [L, E, Kp/gs, N], or q [L, E, K, N] INT8 with scales [L, E, G, N] (a
// scale per group of K/G rows, or G = 1: one per column); the host offsets
// them to the layer's slab (in size_t: a 48-layer INT4 stack of
// Qwen3-30B-A3B is 4.8 GB a projection), so the stack is never copied.
// group_sizes [E] int32 stays on the device: each block reads the offsets
// itself, so the host never waits for the routing.  The a8 kernel takes
// per-token int8 activations with f32 row scales sx [M], quantized outside
// the kernel as in the JAX package.  Every kernel computes what the TPU
// kernel does: per expert, the sum over groups of (x . q) x scale in f32
// (x sx), then rounded to bf16.
//
// What bounds them on the H100: at decode (batch 32 x top-8 = 256 rows
// over ~112 touched experts of 128, about 2 rows each) every touched
// expert's weight tile is read once for 2 to 4 operations a byte: bound by
// bytes (the touched experts' weights and scales at 3.35 TB/s).  A
// 512-token prefill piece gives ~32 rows an expert (4096 rows) and a batch
// of 32 such prompts ~1000, where the operations bound them (989 TFLOP/s
// bf16, 1979 TOP/s int8).
//
// Design (not the TPU schedule: its static (row tile, expert) work list,
// _build_worklist, exists because a Pallas grid must be static):
// * one block per (N tile, expert); the block finds its expert's first row
//   as the sum of group_sizes[0..e) (one warp, a shuffle reduction) and
//   exits at once for an empty expert;
// * the block walks its expert's rows in tiles of a tile body's height,
//   calling that tile (quant_matmul_core.cuh) with x and out offset to the
//   expert's rows, so each expert's weight columns
//   are streamed from HBM once per row tile (once at decode) and every
//   output row is written once, by its own expert: no read-modify-write of
//   a tile that straddles two experts, and no zeroing of other experts'
//   rows;
// * the tile height is chosen on the host from the mean rows per expert
//   (M / E): at most 4 (decode) the CUDA-core tiles of 4 rows for bf16
//   activations and of 16 rows for int8, at most 16 the 8- and 16-row
//   ones, above that the 64-row tiles (wmma tensor cores for bf16,
//   __dp4a for int8);
// * rows of a group_sizes that sum past M are dropped (a block never reads
//   or writes past row M).
// wgmma, TMA and split-K over experts' K are left to later work.

#include "quant_matmul_core.cuh"

namespace {

using qie::kBN;
using qie::kSmallCols;
using qie::kThreads;
using qie::kWBN;
using qie::kWThreads;

// The rows [start, start + n) of expert e, from the device's group sizes.
struct ExpertRows {
  int start;
  int n;
};

__device__ __forceinline__ ExpertRows expert_rows(const int* group_sizes,
                                                  int e, int M) {
  __shared__ int s_rows[2];
  if (threadIdx.x < 32) {
    int acc = 0;
    for (int i = threadIdx.x; i < e; i += 32) acc += group_sizes[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (threadIdx.x == 0) {
      s_rows[0] = acc;
      s_rows[1] = group_sizes[e];
    }
  }
  __syncthreads();
  const int start = min(max(s_rows[0], 0), M);
  return {start, max(0, min(s_rows[1], M - start))};
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
gmm4_a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ scales,
               const int* __restrict__ group_sizes,
               __nv_bfloat16* __restrict__ out, int M, int Kp, int N,
               int gs) {
  const int e = blockIdx.y;
  const ExpertRows r = expert_rows(group_sizes, e, M);
  if (r.n == 0) return;
  const int8_t* qe = q + static_cast<size_t>(e) * (Kp / 2) * N;
  const float* se = scales + static_cast<size_t>(e) * (Kp / gs) * N;
  const int8_t* xe = x + static_cast<size_t>(r.start) * Kp;
  __nv_bfloat16* oe = out + static_cast<size_t>(r.start) * N;
  for (int m0 = 0; m0 < r.n; m0 += 8 * TM) {
    qie::tile_4a8<TM>(xe, sx + r.start, qe, se, oe, r.n, Kp, N, gs, m0,
                      blockIdx.x * kBN);
    __syncthreads();
  }
}

// kInt4: the weight has K/2 packed rows and gs is the INT4 group size;
// else K rows, G scale rows (gs = K / G; per_col when G = 1).
template <bool kInt4, int MT>
__global__ void __launch_bounds__(kThreads)
gmm_w16_small_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     const int* __restrict__ group_sizes,
                     __nv_bfloat16* __restrict__ out, int M, int K, int N,
                     int gs, int G, bool per_col) {
  const int e = blockIdx.y;
  const ExpertRows r = expert_rows(group_sizes, e, M);
  if (r.n == 0) return;
  const int8_t* qe = q + static_cast<size_t>(e) * (kInt4 ? K / 2 : K) * N;
  const float* se = scales + static_cast<size_t>(e) * G * N;
  const __nv_bfloat16* xe = x + static_cast<size_t>(r.start) * K;
  __nv_bfloat16* oe = out + static_cast<size_t>(r.start) * N;
  for (int m0 = 0; m0 < r.n; m0 += MT) {
    qie::tile_w16_small<kInt4, MT>(xe, qe, se, oe, r.n, K, N, gs, per_col, m0,
                                   blockIdx.x * kSmallCols);
    __syncthreads();
  }
}

template <bool kInt4>
__global__ void __launch_bounds__(kWThreads)
gmm_w16_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    const int* __restrict__ group_sizes,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int gs, int G, bool per_col) {
  const int e = blockIdx.y;
  const ExpertRows r = expert_rows(group_sizes, e, M);
  if (r.n == 0) return;
  const int8_t* qe = q + static_cast<size_t>(e) * (kInt4 ? K / 2 : K) * N;
  const float* se = scales + static_cast<size_t>(e) * G * N;
  const __nv_bfloat16* xe = x + static_cast<size_t>(r.start) * K;
  __nv_bfloat16* oe = out + static_cast<size_t>(r.start) * N;
  for (int m0 = 0; m0 < r.n; m0 += qie::kWBM) {
    qie::tile_w16_wmma<kInt4>(xe, qe, se, oe, r.n, K, N, gs, per_col, m0,
                              blockIdx.x * kWBN);
    __syncthreads();
  }
}

// The bf16-activation kernels for both weight types, by mean rows per
// expert.  q / s already at the layer's slab.
template <bool kInt4>
cudaError_t launch_w16(const void* x, const int8_t* q, const float* s,
                       const int* group_sizes, void* out, int M, int K, int N,
                       int gs, int G, int E, cudaStream_t st) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const bool per_col = !kInt4 && G == 1;
  const int mean_rows = (M + E - 1) / E;
  if (mean_rows <= 4) {
    gmm_w16_small_kernel<kInt4, 4><<<dim3(N / kSmallCols, E), kThreads, 0, st>>>(
        xb, q, s, group_sizes, o, M, K, N, gs, G, per_col);
  } else if (mean_rows <= 16) {
    gmm_w16_small_kernel<kInt4, 8><<<dim3(N / kSmallCols, E), kThreads, 0, st>>>(
        xb, q, s, group_sizes, o, M, K, N, gs, G, per_col);
  } else {
    gmm_w16_wmma_kernel<kInt4><<<dim3(N / kWBN, E), kWThreads, 0, st>>>(
        xb, q, s, group_sizes, o, M, K, N, gs, G, per_col);
  }
  return cudaGetLastError();
}

bool bad_common(int M, int E, int layer, int L) {
  return M <= 0 || E <= 0 || E > 65535 || layer < 0 || layer >= L;
}

}  // namespace

extern "C" int qie_grouped_matmul4_a8(const void* x, const void* sx,
                                      const void* q, const void* scales,
                                      const void* group_sizes, void* out,
                                      int M, int Kp, int N, int gs, int E,
                                      int layer, int L, void* stream) {
  if (bad_common(M, E, layer, L) || N % kBN || gs <= 0 || gs % qie::kBKP ||
      Kp % (2 * gs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slab = static_cast<size_t>(layer) * E;
  const int8_t* ql = static_cast<const int8_t*>(q) + slab * (Kp / 2) * N;
  const float* sl = static_cast<const float*>(scales) + slab * (Kp / gs) * N;
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* sxf = static_cast<const float*>(sx);
  const auto* gsz = static_cast<const int*>(group_sizes);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((M + E - 1) / E <= 16) {
    gmm4_a8_kernel<2><<<dim3(N / kBN, E), kThreads, 0, st>>>(
        xq, sxf, ql, sl, gsz, o, M, Kp, N, gs);
  } else {
    gmm4_a8_kernel<8><<<dim3(N / kBN, E), kThreads, 0, st>>>(
        xq, sxf, ql, sl, gsz, o, M, Kp, N, gs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qie_grouped_matmul4(const void* x, const void* q,
                                   const void* scales, const void* group_sizes,
                                   void* out, int M, int Kp, int N, int gs,
                                   int E, int layer, int L, void* stream) {
  if (bad_common(M, E, layer, L) || N % kSmallCols || gs <= 0 ||
      gs % qie::kChunk || Kp % (2 * gs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slab = static_cast<size_t>(layer) * E;
  const int8_t* ql = static_cast<const int8_t*>(q) + slab * (Kp / 2) * N;
  const float* sl = static_cast<const float*>(scales) + slab * (Kp / gs) * N;
  return static_cast<int>(launch_w16<true>(
      x, ql, sl, static_cast<const int*>(group_sizes), out, M, Kp, N, gs,
      Kp / gs, E, static_cast<cudaStream_t>(stream)));
}

extern "C" int qie_grouped_matmul8(const void* x, const void* q,
                                   const void* scales, const void* group_sizes,
                                   void* out, int M, int K, int N, int G,
                                   int E, int layer, int L, void* stream) {
  if (bad_common(M, E, layer, L) || N % kSmallCols || K % qie::kChunk ||
      G <= 0 || K % G || (G > 1 && (K / G) % qie::kChunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slab = static_cast<size_t>(layer) * E;
  const int8_t* ql = static_cast<const int8_t*>(q) + slab * K * N;
  const float* sl = static_cast<const float*>(scales) + slab * G * N;
  return static_cast<int>(launch_w16<false>(
      x, ql, sl, static_cast<const int*>(group_sizes), out, M, K, N, K / G, G,
      E, static_cast<cudaStream_t>(stream)));
}
