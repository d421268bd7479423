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
//   gmm8_mma_kernel                   <- _grouped_matmul8 (_gmm8_kernel):
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
//   expert's rows and the row count taken as the expert's, so each
//   expert's weight columns are streamed from HBM once per row tile (once
//   at decode) and every output row is written once, by its own expert: no
//   read-modify-write of a tile that straddles two experts, no zeroing of
//   other experts' rows, and no read of the next expert's rows;
// * rows of a group_sizes that sum past M are dropped (a block never reads
//   or writes past row M).
// The tiles:
// * W8A16 (gmm8_mma_kernel): the dense matmuls' tensor-core body,
//   qmm_mma_body<kW8A16> (bf16 mma.sync m16n8k16, the int8 weight widened
//   exactly in registers, a 4-stage cp.async ring; quant_matmul.cu
//   describes it), one K slice writing bf16 itself, 128 columns a block, N
//   a multiple of 64 (a last tile's 64 columns past N never loaded or
//   stored).  The host picks its rows a tile, 16 mt
//   (ops/grouped_matmul.plan_grouped_matmul8): 16 where the mean rows per
//   expert (M / E) is at most 16, which holds at every decode step (the
//   gate and up then run 6 x 128 = 768 blocks, the down 16 x 128), 64
//   above.  No split K: the experts' columns alone fill the card.
// * W4A16 and W4A8: the older tiles, their height chosen on the host from
//   the mean rows per expert: at most 4 (decode) the CUDA-core tiles of 4
//   rows for bf16 activations and of 16 rows for int8, at most 16 the 8-
//   and 16-row ones, above that the 64-row tiles (wmma tensor cores for
//   bf16, __dp4a for int8).
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
// else K rows, G scale rows (gs = K / G; per_col when G = 1).  Only the
// INT4 forms run (grouped_matmul4); INT8 experts run gmm8_mma_kernel.
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

// Block (column tile blockIdx.x, expert blockIdx.y) of the W8A16 kernel:
// the expert's rows in tiles of 16 MT on the tensor-core body, with x, out
// and M taken at its rows and q / scales at its slab (layer and expert);
// one K slice, bf16 out.  The body reuses its shared ring, so row tiles
// are separated by a barrier.
template <int MT, bool kPerCol>
__global__ void __launch_bounds__(128)
gmm8_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q,
                const float* __restrict__ scales,
                const int* __restrict__ group_sizes,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.y;
  const ExpertRows r = expert_rows(group_sizes, e, M);
  if (r.n == 0) return;
  const qie::QmmArgs a{x + static_cast<size_t>(r.start) * K,
                       nullptr,
                       {q + static_cast<size_t>(e) * K * N, nullptr},
                       {scales + static_cast<size_t>(e) * G * N, nullptr},
                       out + static_cast<size_t>(r.start) * N,
                       nullptr,
                       r.n, K, N, K / G, K};
  for (int t = 0; 16 * MT * t < r.n; ++t) {
    qie::qmm_mma_body<qie::kW8A16, MT, 1, kPerCol, false>(a, t, blockIdx.x,
                                                          0, smem_raw);
    __syncthreads();
  }
}

template <int MT, bool kPerCol>
cudaError_t launch_gmm8(const __nv_bfloat16* x, const int8_t* q,
                        const float* s, const int* group_sizes,
                        __nv_bfloat16* out, int M, int K, int N, int G, int E,
                        cudaStream_t st) {
  const auto kern = gmm8_mma_kernel<MT, kPerCol>;
  constexpr int smem = qie::qmm_smem<qie::kW8A16, MT, 1>();
  if (smem > 48 * 1024) {  // past the default limit
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  kern<<<dim3((N + qie::kMmaCols - 1) / qie::kMmaCols, E), 128, smem, st>>>(
      x, q, s, group_sizes, out, M, K, N, G);
  return cudaGetLastError();
}

// The INT4 bf16-activation kernels, by mean rows per expert.  q / s
// already at the layer's slab.
cudaError_t launch_w4(const void* x, const int8_t* q, const float* s,
                      const int* group_sizes, void* out, int M, int Kp, int N,
                      int gs, int E, cudaStream_t st) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const int G = Kp / gs;
  const int mean_rows = (M + E - 1) / E;
  if (mean_rows <= 4) {
    gmm_w16_small_kernel<true, 4><<<dim3(N / kSmallCols, E), kThreads, 0, st>>>(
        xb, q, s, group_sizes, o, M, Kp, N, gs, G, false);
  } else if (mean_rows <= 16) {
    gmm_w16_small_kernel<true, 8><<<dim3(N / kSmallCols, E), kThreads, 0, st>>>(
        xb, q, s, group_sizes, o, M, Kp, N, gs, G, false);
  } else {
    gmm_w16_wmma_kernel<true><<<dim3(N / kWBN, E), kWThreads, 0, st>>>(
        xb, q, s, group_sizes, o, M, Kp, N, gs, G, false);
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
  return static_cast<int>(launch_w4(
      x, ql, sl, static_cast<const int*>(group_sizes), out, M, Kp, N, gs, E,
      static_cast<cudaStream_t>(stream)));
}

// mt: the tensor-core body's m16 tiles a warp (1 or 4: 16 or 64 rows a
// tile), from ops/grouped_matmul.plan_grouped_matmul8.  cp.async copies
// 16-byte chunks of x and q, the scales and the output move in 16-byte
// words: the expert and row offsets keep that alignment (K % 32, N % 64)
// when the bases have it.
extern "C" int qie_grouped_matmul8(const void* x, const void* q,
                                   const void* scales, const void* group_sizes,
                                   void* out, int M, int K, int N, int G,
                                   int E, int mt, int layer, int L,
                                   void* stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(scales) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (bad_common(M, E, layer, L) || N % 64 || K % 32 || G <= 0 || K % G ||
      (G > 1 && (K / G) % 32) || (mt != 1 && mt != 4) || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slab = static_cast<size_t>(layer) * E;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* ql = static_cast<const int8_t*>(q) + slab * K * N;
  const float* sl = static_cast<const float*>(scales) + slab * G * N;
  const auto* gsz = static_cast<const int*>(group_sizes);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (mt == 1) {
    rc = G == 1 ? launch_gmm8<1, true>(xb, ql, sl, gsz, o, M, K, N, G, E, st)
                : launch_gmm8<1, false>(xb, ql, sl, gsz, o, M, K, N, G, E, st);
  } else {
    rc = G == 1 ? launch_gmm8<4, true>(xb, ql, sl, gsz, o, M, K, N, G, E, st)
                : launch_gmm8<4, false>(xb, ql, sl, gsz, o, M, K, N, G, E, st);
  }
  return static_cast<int>(rc);
}
