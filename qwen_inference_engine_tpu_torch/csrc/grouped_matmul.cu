// Grouped (MoE expert) quantized matmuls for Hopper (sm_90a):
// y[M, N] = x[M, K] @ Wq[layer, e] over rows sorted by expert, where rows
// [offset_e, offset_e + group_sizes[e]) belong to expert e, bf16 out.
//
// Three kernels, each the port of one Pallas kernel of
// qwen_inference_engine_tpu/ops/grouped_matmul.py:
//
//   gmm4_mma_kernel<kW4A8>   <- _grouped_matmul4_a8 (_gmm4_a8_kernel):
//                               int8 activations x INT4 experts
//   gmm4_mma_kernel<kW4A16>  <- _grouped_matmul4 (_gmm4_kernel):
//                               bf16 activations x INT4 experts
//   gmm8_mma_kernel          <- _grouped_matmul8 (_gmm8_kernel):
//                               bf16 activations x INT8 experts
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
// (INT4: over plane pairs, (x . q_lo) s_lo + (x . q_hi) s_hi; int8
// activations: int32 dot sums, x sx at the end), then rounded to bf16.
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
// _build_worklist, and its bf16 re-add of tiles that straddle two experts
// exist because a Pallas grid must be static):
// * one block per (128-column tile, expert), 128 threads; the block finds
//   its expert's first row as the sum of group_sizes[0..e) (one warp, a
//   shuffle reduction) and exits at once for an empty expert;
// * the block walks its expert's rows in tiles of 16 mt rows, running the
//   dense matmuls' tensor-core body (qmm_mma_body of quant_matmul_core.cuh;
//   quant_matmul.cu describes it: int8 mma.sync m16n8k32 for W4A8, bf16
//   m16n8k16 for W4A16 and W8A16 with the weight widened exactly in
//   registers, a 4-stage cp.async ring) with x, sx, out and M taken at the
//   expert's rows and q / scales at its slab: one K slice writing bf16
//   itself, so no workspace and no reduce launch.  The body's row guard
//   (never read or write at or past M) keeps every tile inside the expert,
//   so each expert's weight columns are streamed from HBM once per row
//   tile (once at decode) and every output row is written once, by its
//   own expert: no read-modify-write of a tile that straddles two experts,
//   no zeroing of other experts' rows, no read of the next expert's rows;
// * rows of a group_sizes that sum past M are dropped (a block never reads
//   or writes past row M);
// * the host picks mt (ops/grouped_matmul.plan_grouped_matmul, one plan for
//   the three kernels) from the mean rows per expert, M / E: 1 (16-row
//   tiles) where it is at most 16, which holds at every decode step (the
//   gate and up then run 6 x 128 = 768 blocks, the down 16 x 128), 4
//   (64-row tiles) above.  No split K: the experts' columns alone fill the
//   card.
// The INT4 kernels run with the dense W4A8 / W4A16 kernels' K order and
// fold, so a grouped call over one expert holding every row equals the
// dense kernel's over that expert's slab bit for bit wherever the dense
// kernel runs one K slice (M > 64).  W4A8 takes N a
// multiple of 128, the bf16 kinds N a multiple of 64 (a last tile's 64
// columns past N never loaded or stored).
// Two templates walk the rows: gmm4_mma_kernel takes the group size from
// the host (derived on the device as 2 K / G it costs the W4A16 64-row
// instance a 4-byte spill at its 255 registers); gmm8_mma_kernel derives
// K / G itself (one template for the three gives its instances other
// register counts, 107-210 against 80-218).
// wgmma, TMA and split-K over experts' K are left to later work.

#include "quant_matmul_core.cuh"

namespace {

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

// Block (column tile blockIdx.x, expert blockIdx.y) of an INT4 kernel
// (kKind kW4A8 or kW4A16): the expert's rows in tiles of 16 MT on the
// tensor-core body, with x, sx (W4A8; W4A16 null), out and M taken at its
// rows and q / scales at its slab: K packed rows (Kp / 2), a pair's sums
// folded every gs packed rows, G = Kp / gs scale rows an expert; one K
// slice, bf16 out.  The body reuses its shared ring, so row tiles are
// separated by a barrier.
template <int kKind, int MT>
__global__ void __launch_bounds__(128)
gmm4_mma_kernel(const unsigned char* __restrict__ x,
                const float* __restrict__ sx, const int8_t* __restrict__ q,
                const float* __restrict__ scales,
                const int* __restrict__ group_sizes,
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int gs,
                int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.y;
  const ExpertRows r = expert_rows(group_sizes, e, M);
  if (r.n == 0) return;
  const qie::QmmArgs a{
      x + static_cast<size_t>(r.start) * K * qie::x_row_bytes<kKind>(),
      sx == nullptr ? nullptr : sx + r.start,
      {q + static_cast<size_t>(e) * K * N, nullptr},
      {scales + static_cast<size_t>(e) * G * N, nullptr},
      out + static_cast<size_t>(r.start) * N,
      nullptr,
      r.n, K, N, gs, K};
  for (int t = 0; 16 * MT * t < r.n; ++t) {
    qie::qmm_mma_body<kKind, MT, 1, false, false>(a, t, blockIdx.x, 0,
                                                  smem_raw);
    __syncthreads();
  }
}

// The same walk for the W8A16 kernel: K rows of int8 weight, a scale per
// group of K / G rows or (kPerCol, G = 1) one per column.
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

// Launch one instance over the (column tile, expert) grid with its dynamic
// shared memory (the body's ring: past the default 48 KB for most).
template <int kKind, int MT, typename Kern, typename... Args>
cudaError_t launch_gmm(Kern kern, int N, int E, cudaStream_t st,
                       Args... args) {
  constexpr int smem = qie::qmm_smem<kKind, MT, 1>();
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  kern<<<dim3((N + qie::kMmaCols - 1) / qie::kMmaCols, E), 128, smem, st>>>(
      args...);
  return cudaGetLastError();
}

// An INT4 kernel at mt (1 or 4; the caller checked it).  q / s already at
// the layer's slab.
template <int kKind>
cudaError_t launch_gmm4(int mt, const void* x, const float* sx,
                        const int8_t* q, const float* s, const int* gsz,
                        __nv_bfloat16* out, int M, int Kp, int N, int gs,
                        int E, cudaStream_t st) {
  const auto* xb = static_cast<const unsigned char*>(x);
  const int K = Kp / 2, G = Kp / gs;
  return mt == 1
             ? launch_gmm<kKind, 1>(gmm4_mma_kernel<kKind, 1>, N, E, st, xb,
                                    sx, q, s, gsz, out, M, K, N, gs, G)
             : launch_gmm<kKind, 4>(gmm4_mma_kernel<kKind, 4>, N, E, st, xb,
                                    sx, q, s, gsz, out, M, K, N, gs, G);
}

// cp.async copies 16-byte chunks of x and q, the scales and the output
// move in 16-byte words: the expert and row offsets keep that alignment
// (K % 32, N % 64) when the bases have it.  sx is read a float at a time.
bool aligned16(const void* x, const void* q, const void* scales,
               const void* out) {
  return (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
          reinterpret_cast<uintptr_t>(scales) |
          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
}

bool bad_common(int M, int E, int layer, int L) {
  return M <= 0 || E <= 0 || E > 65535 || layer < 0 || layer >= L;
}

}  // namespace

// mt: the tensor-core body's m16 tiles a warp (1 or 4: 16 or 64 rows a
// tile), from ops/grouped_matmul.plan_grouped_matmul.  The INT4 kernels
// take Kp (the logical, padded K: Kp / 2 packed rows) and the group size
// gs, with whole plane pairs (Kp % (2 gs)) of whole 32-row k-steps
// (gs % 32).
extern "C" int qie_grouped_matmul4_a8(const void* x, const void* sx,
                                      const void* q, const void* scales,
                                      const void* group_sizes, void* out,
                                      int M, int Kp, int N, int gs, int E,
                                      int mt, int layer, int L, void* stream) {
  if (bad_common(M, E, layer, L) || N % qie::kMmaCols || gs <= 0 ||
      gs % 32 || Kp % (2 * gs) || (mt != 1 && mt != 4) ||
      !aligned16(x, q, scales, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slab = static_cast<size_t>(layer) * E;
  return static_cast<int>(launch_gmm4<qie::kW4A8>(
      mt, x, static_cast<const float*>(sx),
      static_cast<const int8_t*>(q) + slab * (Kp / 2) * N,
      static_cast<const float*>(scales) + slab * (Kp / gs) * N,
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out),
      M, Kp, N, gs, E, static_cast<cudaStream_t>(stream)));
}

extern "C" int qie_grouped_matmul4(const void* x, const void* q,
                                   const void* scales, const void* group_sizes,
                                   void* out, int M, int Kp, int N, int gs,
                                   int E, int mt, int layer, int L,
                                   void* stream) {
  if (bad_common(M, E, layer, L) || N % 64 || gs <= 0 || gs % 32 ||
      Kp % (2 * gs) || (mt != 1 && mt != 4) ||
      !aligned16(x, q, scales, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slab = static_cast<size_t>(layer) * E;
  return static_cast<int>(launch_gmm4<qie::kW4A16>(
      mt, x, nullptr, static_cast<const int8_t*>(q) + slab * (Kp / 2) * N,
      static_cast<const float*>(scales) + slab * (Kp / gs) * N,
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out),
      M, Kp, N, gs, E, static_cast<cudaStream_t>(stream)));
}

// K rows of INT8 weight, G scale rows (a group of K / G rows, a multiple
// of 32; or one per column, G = 1).
extern "C" int qie_grouped_matmul8(const void* x, const void* q,
                                   const void* scales, const void* group_sizes,
                                   void* out, int M, int K, int N, int G,
                                   int E, int mt, int layer, int L,
                                   void* stream) {
  if (bad_common(M, E, layer, L) || N % 64 || K % 32 || G <= 0 || K % G ||
      (G > 1 && (K / G) % 32) || (mt != 1 && mt != 4) ||
      !aligned16(x, q, scales, out)) {
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
    rc = G == 1 ? launch_gmm<qie::kW8A16, 1>(gmm8_mma_kernel<1, true>, N, E,
                                             st, xb, ql, sl, gsz, o, M, K, N,
                                             G)
                : launch_gmm<qie::kW8A16, 1>(gmm8_mma_kernel<1, false>, N, E,
                                             st, xb, ql, sl, gsz, o, M, K, N,
                                             G);
  } else {
    rc = G == 1 ? launch_gmm<qie::kW8A16, 4>(gmm8_mma_kernel<4, true>, N, E,
                                             st, xb, ql, sl, gsz, o, M, K, N,
                                             G)
                : launch_gmm<qie::kW8A16, 4>(gmm8_mma_kernel<4, false>, N, E,
                                             st, xb, ql, sl, gsz, o, M, K, N,
                                             G);
  }
  return static_cast<int>(rc);
}
