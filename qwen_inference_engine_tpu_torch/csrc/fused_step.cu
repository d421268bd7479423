// Fused decode kernels for Hopper (sm_90a): the single-pass INT4 SwiGLU MLP,
// one batch half's decode attention beside the other half's MLP, and the
// first prototype: decode attention beside one INT4 matmul.
//
// Replaces three kernels of qwen_inference_engine_tpu/ops/fused_step.py:
//   * fused_mlp (body _fused_mlp_kernel): y = down(silu(x Wg) * (x Wu)) of
//     one layer, pad-free INT4 weights, x [M <= 256, K] bf16;
//   * fused_attn_mlp (body _fused_attn_mlp_kernel): decode attention of the
//     cache rows [row0, row0 + Ba) at layer layer_a, and fused_mlp of layer
//     layer_m on an independent x (the double-pumped decode's two halves);
//   * fused_attn_matmul (body _fused_attn_matmul_kernel): decode attention
//     of the cache rows [row0, row0 + Ba) beside y = x @ W4[layer] for an
//     independent x [Mb, K], at the same layer (the overlap probe's
//     kernel; no entry point dispatches it).
//
// Weights (the stacked plane-pair INT4 layout of quant_matmul.cu): gate /
// up q [L, K/2, F] int8 with scales [L, K/gs_gate, F] f32, down q
// [L, F/2, K] with scales [L, F/gs_down, K]; the host offsets each to its
// layer's slab.  Numerics are the TPU kernel's: g and u are f32 sums of
// bf16 x times the INT4 weights (group scales in f32), h = silu(g) * u is
// rounded to bf16 once, and the down sum is f32, rounded to bf16 at the end.
//
// What bounds them on the H100: at decode (M a few rows, or a half batch
// of 96) each weight byte is read once for 2 * M operations, so the bytes
// bound them: gate, up and down of a Qwen2.5-7B layer are 3 * 3584 * 18944
// / 2 bytes = 102 MB plus 4 MB of scales, 0.032 ms at 3.35 TB/s.  At
// M = 256 the 6 * M * K * F = 104 GFLOP take 0.105 ms at 989 TFLOP/s bf16.
// The attention half reads 2 * len * Hk * D bf16 values a row, 7 operations
// a byte at G = 7: bytes again.  fused_attn_matmul at the probe's shapes
// (56 rows of 1017 keys; the 7B gate projection, K 3584, N 18944, INT4):
// 117 MB of KV and 34 MB of weights and scales, 0.045 ms at 3.35 TB/s,
// against 7.6 GFLOP of matmul (0.008 ms at 989 TFLOP/s): bytes.
//
// Design (simple and right first).  The TPU kernel walks the F tiles in
// order and carries the down projection's sum in scratch from one grid
// step to the next.  Blocks on the card run in no order, and a sum across
// blocks in floating-point atomics would change greedy tokens from run to
// run, so both kernels take two passes (two launches):
//   1. gate / up / h: one block per 64 columns of F (and 64 rows of M at
//      M > 16) computes the g tile and then the u tile from the same x rows
//      with the W4A16 tiles of quant_matmul_core.cuh: the f32 CUDA-core
//      tile at M <= 16, the wmma tile above.  The tiles' epilogue (FusedEp)
//      writes g in f32 to a workspace [M, F], then reads it back beside u
//      (the same thread writes and reads each element) and writes
//      h = bf16(silu(g) * u) to a bf16 workspace [M, F]: 0.3 MB at M = 8,
//      9.7 MB at M = 256, within the 50 MB L2;
//   2. down: y = h @ Wd with the same W4A16 tiles, rounded to bf16.
// Every output element is written by one thread in a fixed order, so two
// calls give bit-identical results.  fused_attn_mlp's first launch holds
// both block kinds in one grid: blocks [0, Ba * Hk) are attention, one
// per (row, KV head), with the decode core of attention_common.cuh (the
// G real query heads, no padding to 8; keys past lens[b] never loaded),
// and the rest are pass 1 of the MLP, always on the wmma tile (128
// threads, the attention block's size; a half batch is > 64 rows).  The
// two kinds share the static shared memory through a union.  The
// hardware runs them side by side on the 132 SMs: that is the overlap the
// TPU kernel builds by hand with its ring of KV copies.
// fused_attn_matmul is that first launch with one matmul tile (the W4A16
// wmma tile with the rounding StoreBf16 epilogue) in place of gate / up: a
// single matmul carries no sum across blocks (each block walks its own K
// loop), so it is one launch with no second pass and no atomics.  wgmma /
// TMA tiles, and splitting the down pass's K loop, are left to later work.

#include "attention_common.cuh"
#include "quant_matmul_core.cuh"

namespace {

using qie::kChunk;
using qie::kSmallCols;
using qie::kThreads;
using qie::kWBM;
using qie::kWBN;
using qie::kWThreads;

constexpr int kD = 128;     // head dimension of fused_attn_mlp's attention
constexpr int kRows = 8;    // query heads per KV head (G <= 8)
constexpr int kKeys = 64;   // keys per tile

// Pass 1's epilogue.  With h == nullptr it stores g (f32); else it reads
// g back and stores h = bf16(silu(g) * u).
struct FusedEp {
  float* g;
  __nv_bfloat16* h;
  int F;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const size_t i = static_cast<size_t>(m) * F + n;
    if (h == nullptr) {
      g[i] = v;
    } else {
      const float gv = g[i];
      h[i] = __float2bfloat16(gv / (1.f + expf(-gv)) * v);
    }
  }
};

// The gate and up tiles of one block (tile index t over F / 64 x row tiles).
template <int MT>
__device__ __forceinline__ void gate_up_small(
    const __nv_bfloat16* x, const int8_t* wg, const float* sg,
    const int8_t* wu, const float* su, float* g_ws, __nv_bfloat16* h_ws,
    int M, int K, int F, int gs, int m0, int n0) {
  qie::tile_w16_small_ep<true, MT>(x, wg, sg, FusedEp{g_ws, nullptr, F}, M,
                                   K, F, gs, false, m0, n0);
  __syncthreads();
  qie::tile_w16_small_ep<true, MT>(x, wu, su, FusedEp{g_ws, h_ws, F}, M, K,
                                   F, gs, false, m0, n0);
}

__device__ __forceinline__ void gate_up_wmma(
    qie::WmmaSmem<true>& sm, const __nv_bfloat16* x, const int8_t* wg,
    const float* sg, const int8_t* wu, const float* su, float* g_ws,
    __nv_bfloat16* h_ws, int M, int K, int F, int gs, int m0, int n0) {
  qie::tile_w16_wmma_ep<true>(sm, x, wg, sg, FusedEp{g_ws, nullptr, F}, M,
                              K, F, gs, false, m0, n0);
  __syncthreads();
  qie::tile_w16_wmma_ep<true>(sm, x, wu, su, FusedEp{g_ws, h_ws, F}, M, K,
                              F, gs, false, m0, n0);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
gate_up_small_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ wg,
                     const float* __restrict__ sg,
                     const int8_t* __restrict__ wu,
                     const float* __restrict__ su, float* __restrict__ g_ws,
                     __nv_bfloat16* __restrict__ h_ws, int M, int K, int F,
                     int gs) {
  gate_up_small<MT>(x, wg, sg, wu, su, g_ws, h_ws, M, K, F, gs,
                    blockIdx.y * MT, blockIdx.x * kSmallCols);
}

__global__ void __launch_bounds__(kWThreads)
gate_up_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ wg,
                    const float* __restrict__ sg,
                    const int8_t* __restrict__ wu,
                    const float* __restrict__ su, float* __restrict__ g_ws,
                    __nv_bfloat16* __restrict__ h_ws, int M, int K, int F,
                    int gs) {
  __shared__ qie::WmmaSmem<true> sm;
  gate_up_wmma(sm, x, wg, sg, wu, su, g_ws, h_ws, M, K, F, gs,
               blockIdx.y * kWBM, blockIdx.x * kWBN);
}

// Pass 2: y [M, K] = h [M, F] @ Wd (one output tile a block).
template <int MT>
__global__ void __launch_bounds__(kThreads)
down_small_kernel(const __nv_bfloat16* __restrict__ h,
                  const int8_t* __restrict__ wd, const float* __restrict__ sd,
                  __nv_bfloat16* __restrict__ y, int M, int F, int K, int gs) {
  qie::tile_w16_small<true, MT>(h, wd, sd, y, M, F, K, gs, false,
                                blockIdx.y * MT, blockIdx.x * kSmallCols);
}

__global__ void __launch_bounds__(kWThreads)
down_wmma_kernel(const __nv_bfloat16* __restrict__ h,
                 const int8_t* __restrict__ wd, const float* __restrict__ sd,
                 __nv_bfloat16* __restrict__ y, int M, int F, int K, int gs) {
  qie::tile_w16_wmma<true>(h, wd, sd, y, M, F, K, gs, false,
                           blockIdx.y * kWBM, blockIdx.x * kWBN);
}

cudaError_t launch_down(const __nv_bfloat16* h, const int8_t* wd,
                        const float* sd, __nv_bfloat16* y, int M, int F, int K,
                        int gs, cudaStream_t st) {
  if (M <= 4) {
    down_small_kernel<4><<<dim3(K / kSmallCols, 1), kThreads, 0, st>>>(
        h, wd, sd, y, M, F, K, gs);
  } else if (M <= 16) {
    down_small_kernel<8><<<dim3(K / kSmallCols, (M + 7) / 8), kThreads, 0,
                           st>>>(h, wd, sd, y, M, F, K, gs);
  } else {
    down_wmma_kernel<<<dim3(K / kWBN, (M + kWBM - 1) / kWBM), kWThreads, 0,
                       st>>>(h, wd, sd, y, M, F, K, gs);
  }
  return cudaGetLastError();
}

// One attention block of the fused launches: query heads of KV head hk of
// row b over the first lens[b] keys of cache row row0 + b at `layer`.
__device__ __forceinline__ void attn_block(
    qie::AttnSmem<kD, kRows, kKeys, __nv_bfloat16>& sm,
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ attn, int Bc, int Hq, int Hk, int S,
    int layer, int row0, float scale, int b, int hk) {
  const int tid = threadIdx.x;
  const int G = Hq / Hk;
  const int len = max(0, min(lens[b], S));
  for (int c = tid; c < kRows * kD; c += kD) {
    const int i = c / kD, d = c % kD;
    float val = 0.f;
    if (i < G) {
      val = __bfloat162float(
          q[(static_cast<long long>(b) * Hq + hk * G + i) * kD + d]) * scale;
    }
    sm.q[i][d] = val;
  }
  const long long row =
      (static_cast<long long>(layer) * Bc + row0 + b) * Hk + hk;
  const long long base = row * S * kD;
  float acc[kRows];
  qie::attend<kD, kRows, kKeys, __nv_bfloat16>(
      sm, acc, G, k_cache + base, v_cache + base, qie::ContiguousKeys{kD},
      nullptr, nullptr, len, len - 1, 0, nullptr, nullptr, -1);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i < G) {
      const float denom = fmaxf(sm.l[i], 1e-30f);
      attn[(static_cast<long long>(b) * Hq + hk * G + i) * kD + tid] =
          __float2bfloat16(acc[i] / denom);
    }
  }
}

// The two block kinds share the static shared memory (40 and 36 KB).
union AttnMmSmem {
  qie::AttnSmem<kD, kRows, kKeys, __nv_bfloat16> attn;
  qie::WmmaSmem<true> mm;
};

// fused_attn_mlp's first launch: attention blocks, then MLP pass-1 blocks.
__global__ void __launch_bounds__(kWThreads)
attn_gate_up_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_cache,
                    const __nv_bfloat16* __restrict__ v_cache,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ attn, int Bc, int Ba, int Hq,
                    int Hk, int S, int layer_a, int row0, float scale,
                    const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ wg,
                    const float* __restrict__ sg,
                    const int8_t* __restrict__ wu,
                    const float* __restrict__ su, float* __restrict__ g_ws,
                    __nv_bfloat16* __restrict__ h_ws, int M, int K, int F,
                    int gs) {
  static_assert(kWThreads == kD, "one thread per head dimension");
  __shared__ AttnMmSmem sm;
  const int n_attn = Ba * Hk;
  const int blk = blockIdx.x;
  if (blk >= n_attn) {
    const int t = blk - n_attn;
    const int n_tiles = F / kWBN;
    gate_up_wmma(sm.mm, x, wg, sg, wu, su, g_ws, h_ws, M, K, F, gs,
                 (t / n_tiles) * kWBM, (t % n_tiles) * kWBN);
    return;
  }
  attn_block(sm.attn, q, k_cache, v_cache, lens, attn, Bc, Hq, Hk, S, layer_a,
             row0, scale, blk / Hk, blk % Hk);
}

// fused_attn_matmul: attention blocks, then the matmul's output tiles.
__global__ void __launch_bounds__(kWThreads)
attn_matmul_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_cache,
                   const __nv_bfloat16* __restrict__ v_cache,
                   const int* __restrict__ lens,
                   __nv_bfloat16* __restrict__ attn, int Bc, int Ba, int Hq,
                   int Hk, int S, int layer, int row0, float scale,
                   const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N,
                   int gs) {
  static_assert(kWThreads == kD, "one thread per head dimension");
  __shared__ AttnMmSmem sm;
  const int n_attn = Ba * Hk;
  const int blk = blockIdx.x;
  if (blk >= n_attn) {
    const int t = blk - n_attn;
    const int n_tiles = N / kWBN;
    qie::tile_w16_wmma_ep<true>(sm.mm, x, w, ws, qie::StoreBf16{y, N}, M, K,
                                N, gs, false, (t / n_tiles) * kWBM,
                                (t % n_tiles) * kWBN);
    return;
  }
  attn_block(sm.attn, q, k_cache, v_cache, lens, attn, Bc, Hq, Hk, S, layer,
             row0, scale, blk / Hk, blk % Hk);
}

// The MLP operands' common checks (the wrappers check first; these keep a
// direct call from running off its arrays).
bool bad_mlp(int M, int K, int F, int gs_gate, int gs_down, int layer,
             int L) {
  return M <= 0 || M > 256 || K <= 0 || F <= 0 || K % kSmallCols ||
         F % kSmallCols || gs_gate <= 0 || gs_gate % kChunk ||
         K % (2 * gs_gate) || gs_down <= 0 || gs_down % kChunk ||
         F % (2 * gs_down) || layer < 0 || layer >= L;
}

}  // namespace

extern "C" int qie_fused_mlp(const void* x, const void* wg, const void* sg,
                             const void* wu, const void* su, const void* wd,
                             const void* sd, void* g_ws, void* h_ws, void* y,
                             int M, int K, int F, int gs_gate, int gs_down,
                             int layer, int L, void* stream) {
  if (bad_mlp(M, K, F, gs_gate, gs_down, layer, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t wl = static_cast<size_t>(layer) * (K / 2) * F;
  const int8_t* wgl = static_cast<const int8_t*>(wg) + wl;
  const int8_t* wul = static_cast<const int8_t*>(wu) + wl;
  const float* sgl = static_cast<const float*>(sg) +
                     static_cast<size_t>(layer) * (K / gs_gate) * F;
  const float* sul = static_cast<const float*>(su) +
                     static_cast<size_t>(layer) * (K / gs_gate) * F;
  const int8_t* wdl = static_cast<const int8_t*>(wd) +
                      static_cast<size_t>(layer) * (F / 2) * K;
  const float* sdl = static_cast<const float*>(sd) +
                     static_cast<size_t>(layer) * (F / gs_down) * K;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* g = static_cast<float*>(g_ws);
  auto* h = static_cast<__nv_bfloat16*>(h_ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) {
    gate_up_small_kernel<4><<<dim3(F / kSmallCols, 1), kThreads, 0, st>>>(
        xb, wgl, sgl, wul, sul, g, h, M, K, F, gs_gate);
  } else if (M <= 16) {
    gate_up_small_kernel<8><<<dim3(F / kSmallCols, (M + 7) / 8), kThreads, 0,
                              st>>>(xb, wgl, sgl, wul, sul, g, h, M, K, F,
                                    gs_gate);
  } else {
    gate_up_wmma_kernel<<<dim3(F / kWBN, (M + kWBM - 1) / kWBM), kWThreads, 0,
                          st>>>(xb, wgl, sgl, wul, sul, g, h, M, K, F,
                                gs_gate);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_down(h, wdl, sdl,
                                      static_cast<__nv_bfloat16*>(y), M, F, K,
                                      gs_down, st));
}

extern "C" int qie_fused_attn_mlp(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lens, void* attn, const void* x, const void* wg,
    const void* sg, const void* wu, const void* su, const void* wd,
    const void* sd, void* g_ws, void* h_ws, void* y, int Lc, int Bc, int Ba,
    int Hq, int Hk, int S, int layer_a, int row0, int M, int K, int F,
    int gs_gate, int gs_down, int layer_m, int L, float scale, void* stream) {
  if (bad_mlp(M, K, F, gs_gate, gs_down, layer_m, L) || Ba <= 0 || Hk <= 0 ||
      Hq % Hk || Hq / Hk > kRows || S <= 0 || row0 < 0 || row0 + Ba > Bc ||
      layer_a < 0 || layer_a >= Lc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t wl = static_cast<size_t>(layer_m) * (K / 2) * F;
  const int8_t* wgl = static_cast<const int8_t*>(wg) + wl;
  const int8_t* wul = static_cast<const int8_t*>(wu) + wl;
  const float* sgl = static_cast<const float*>(sg) +
                     static_cast<size_t>(layer_m) * (K / gs_gate) * F;
  const float* sul = static_cast<const float*>(su) +
                     static_cast<size_t>(layer_m) * (K / gs_gate) * F;
  const int8_t* wdl = static_cast<const int8_t*>(wd) +
                      static_cast<size_t>(layer_m) * (F / 2) * K;
  const float* sdl = static_cast<const float*>(sd) +
                     static_cast<size_t>(layer_m) * (F / gs_down) * K;
  auto* h = static_cast<__nv_bfloat16*>(h_ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_attn = Ba * Hk;
  const int n_mlp = (F / kWBN) * ((M + kWBM - 1) / kWBM);
  attn_gate_up_kernel<<<n_attn + n_mlp, kWThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(attn), Bc,
      Ba, Hq, Hk, S, layer_a, row0, scale,
      static_cast<const __nv_bfloat16*>(x), wgl, sgl, wul, sul,
      static_cast<float*>(g_ws), h, M, K, F, gs_gate);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_down(h, wdl, sdl,
                                      static_cast<__nv_bfloat16*>(y), M, F, K,
                                      gs_down, st));
}

extern "C" int qie_fused_attn_matmul(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lens, void* attn, const void* x, const void* w,
    const void* ws, void* y, int Lc, int Bc, int Ba, int Hq, int Hk, int S,
    int row0, int M, int K, int N, int gs, int layer, int L, float scale,
    void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % kWBN || gs <= 0 || gs % kChunk ||
      K % (2 * gs) || layer < 0 || layer >= L || layer >= Lc || Ba <= 0 ||
      Hk <= 0 || Hq % Hk || Hq / Hk > kRows || S <= 0 || row0 < 0 ||
      row0 + Ba > Bc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* wl = static_cast<const int8_t*>(w) +
                     static_cast<size_t>(layer) * (K / 2) * N;
  const float* sl = static_cast<const float*>(ws) +
                    static_cast<size_t>(layer) * (K / gs) * N;
  const int n_attn = Ba * Hk;
  const int n_mm = (N / kWBN) * ((M + kWBM - 1) / kWBM);
  attn_matmul_kernel<<<n_attn + n_mm, kWThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(attn), Bc,
      Ba, Hq, Hk, S, layer, row0, scale,
      static_cast<const __nv_bfloat16*>(x), wl, sl,
      static_cast<__nv_bfloat16*>(y), M, K, N, gs);
  return static_cast<int>(cudaGetLastError());
}
