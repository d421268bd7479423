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
// Design.  The TPU kernel walks the F tiles in order and carries the down
// projection's sum in scratch from one grid step to the next.  Blocks on
// the card run in no order, and a sum across blocks in floating-point
// atomics would change greedy tokens from run to run, so the MLP takes two
// passes, each a sum that a reduce kernel adds in a fixed order.
// fused_mlp runs both on the tensor-core body of quant_matmul_core.cuh
// (qmm_mma_kernel<kW4A16>: the INT4 nibbles widened exactly to bf16 in
// registers, bf16 mma.sync, two f32 plane sums folded per pair in the TPU's
// order), four launches inside one C call:
//   1. gate / up: one launch over both weights side by side (grid.y: the
//      gate's F / 128 column tiles, then the up's), K split into slices at
//      M <= 64 (the decode stream; ops/fused_step.plan_fused_mlp).  Above
//      64 rows both passes take the decode stream's 64-row tiles (two
//      blocks an SM): 128-row tiles would leave half of one empty at
//      M = 192.  Every slice writes its f32 partial g and u to part
//      [splits, M, 2 F] (g in columns [0, F), u in [F, 2 F));
//   2. swiglu_reduce adds each column's partials in split order and writes
//      h = bf16(silu(g) * u) [M, F]: g and u stay in f32 until h;
//   3. down: y = h @ Wd on the same body, K = F split at every M (N = K
//      gives few column tiles: 28 for 7B, 84 blocks at M = 192, so slices
//      fill the 132 SMs), the partials in part (free again);
//   4. qmm_reduce adds them in split order and rounds y to bf16 once.
//   The workspace (part, then h) is one allocation of the wrapper's.
// fused_attn_mlp is fused_mlp with the attention beside its first launch:
// one grid of 128-thread blocks, blocks [0, Ba * Hk) attention, one per
// (row, KV head), on the tensor-core core of attention_mma.cuh (the G real
// query heads as the rows of one m16 tile, no padding to 8; keys past
// lens[b] never loaded), and the rest the gate / up pass's blocks,
// qmm_mma_body<kW4A16> at the plan's mt (1 or 4: 4 warps, the attention
// block's size).  Both kinds take the one dynamic shared buffer (the
// larger of the attention's 87 KB and the body's 49 / 100 KB).  The
// hardware runs them side by side on the 132 SMs: that is the overlap the
// TPU kernel builds by hand with its ring of KV copies.  Then fused_mlp's
// last three launches: swiglu_reduce, the down pass, qmm_reduce.
// fused_attn_matmul is the same first launch over one weight: the same
// attention blocks (bit for bit fused_attn_mlp's for the same rows, layer
// and lens) beside the output tiles of quant_matmul4's body, planned as
// quant_matmul4 plans M <= 64 rows (ops/fused_step.plan_fused_attn_matmul:
// mt 1 or 4, K split so that about 4 blocks run on each SM; above 64 rows
// mt 4 over all of K, as the fused MLP's gate / up pass).  One slice
// writes bf16 y directly; more write f32 partials [splits, M, N] to the
// wrapper's workspace, which qmm_reduce adds in split order and rounds
// once, as quant_matmul4 does: y is quant_matmul4's bits at M <= 64.
// Every output element is written by one thread in a fixed order, so two
// calls give bit-identical results.

#include "quant_matmul_core.cuh"

namespace {

using qie::kChunk;
using qie::kSmallCols;
using qie::kThreads;
using qie::kW4A16;
using qie::launch_mma_mt;
using qie::launch_qmm_reduce;
using qie::mma_call_ok;
using qie::QmmArgs;
using qie::run_mma;

constexpr int kD = 128;             // head dimension of the fused attention
constexpr int kRows = 8;            // query heads per KV head (G <= 8)
constexpr int kBlockThreads = 128;  // both block kinds: 4 warps

// The fused launches' attention block on the tensor cores: the G query
// heads of KV head hk of row b as the rows of one m16 tile (attend_mma,
// GqaRows at T = 1) over the first lens[b] keys of cache row row0 + b at
// `layer`.
using MmaSmemD = qie::MmaSmem<kD, 4, __nv_bfloat16>;
__device__ __forceinline__ void attn_block_mma(
    MmaSmemD& sm, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ attn, int Bc, int Hq, int Hk, int S,
    int layer, int row0, float scale, int b, int hk) {
  const int G = Hq / Hk;
  const int len = max(0, min(lens[b], S));
  const long long row =
      (static_cast<long long>(layer) * Bc + row0 + b) * Hk + hk;
  const long long head = static_cast<long long>(b) * Hq + hk * G;
  qie::attend_mma<kD, 4, __nv_bfloat16>(
      sm, qie::GqaRows{0, G, Hq, kD}, G, q + head * kD, attn + head * kD,
      k_cache + row * S * kD, v_cache + row * S * kD,
      qie::ContiguousKeys{kD}, nullptr, nullptr, len, len - 1, 0, G, scale);
}

// The attention operands of a fused launch.
struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_cache;
  const __nv_bfloat16* v_cache;
  const int* lens;
  __nv_bfloat16* attn;
  int Bc, Ba, Hq, Hk, S, layer, row0;
  float scale;
};

// A fused first launch: blocks [0, Ba * Hk) are attention (one per (row,
// KV head)); block Ba * Hk + t is block (t % tx, (t / tx) % ty, t / (tx
// ty)) of the matmul (qmm_mma_body<kW4A16, MT, 1, false, kDual>, tx row
// tiles, ty column tiles): fused_attn_mlp's gate / up pass (kDual: both
// weights side by side) or fused_attn_matmul's one weight.  Both kinds
// take their shared memory from the one dynamic buffer.
template <int MT, bool kDual>
__global__ void __launch_bounds__(kBlockThreads)
attn_qmm_kernel(const AttnArgs a, const QmmArgs mm, int tx, int ty) {
  static_assert(kBlockThreads == kD, "the attention block's 4 warps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_attn = a.Ba * a.Hk;
  const int blk = blockIdx.x;
  if (blk >= n_attn) {
    const int t = blk - n_attn;
    qie::qmm_mma_body<kW4A16, MT, 1, false, kDual>(
        mm, t % tx, (t / tx) % ty, t / (tx * ty), smem_raw);
    return;
  }
  attn_block_mma(*reinterpret_cast<MmaSmemD*>(smem_raw), a.q, a.k_cache,
                 a.v_cache, a.lens, a.attn, a.Bc, a.Hq, a.Hk, a.S, a.layer,
                 a.row0, a.scale, blk / a.Hk, blk % a.Hk);
}

// The first launch at plan mt (1 or 4) over `splits` slices: the dynamic
// shared memory is the larger of the two kinds'.
template <int MT, bool kDual>
cudaError_t launch_attn_qmm(const AttnArgs& a, const QmmArgs& mm,
                            int splits, cudaStream_t st) {
  constexpr int body = qie::qmm_smem<kW4A16, MT, 1>();
  constexpr int at = static_cast<int>(sizeof(MmaSmemD));
  constexpr int smem = body > at ? body : at;
  const auto kern = attn_qmm_kernel<MT, kDual>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  const int tx = (mm.M + 16 * MT - 1) / (16 * MT);
  const int ty = (kDual ? 2 : 1) * ((mm.N + qie::kMmaCols - 1) / qie::kMmaCols);
  kern<<<a.Ba * a.Hk + tx * ty * splits, kBlockThreads, smem, st>>>(a, mm, tx,
                                                                     ty);
  return cudaGetLastError();
}

template <bool kDual>
cudaError_t launch_attn_qmm_mt(int mt, const AttnArgs& a, const QmmArgs& mm,
                               int splits, cudaStream_t st) {
  return mt == 1 ? launch_attn_qmm<1, kDual>(a, mm, splits, st)
                 : launch_attn_qmm<4, kDual>(a, mm, splits, st);
}

// The attention operands' checks of both fused launches.
bool bad_attn(int Lc, int Bc, int Ba, int Hq, int Hk, int S, int layer,
              int row0) {
  return Ba <= 0 || Hk <= 0 || Hq % Hk || Hq / Hk > kRows || S <= 0 ||
         row0 < 0 || row0 + Ba > Bc || layer < 0 || layer >= Lc;
}

// fused_mlp's pass 2: h [M, F] = bf16(silu(g) * u), g and u the sums of
// the gate / up pass's f32 partials part [splits, M, 2 F] (g in columns
// [0, F), u in [F, 2 F)) in split order; each thread 8 adjacent columns.
__global__ void __launch_bounds__(kThreads)
swiglu_reduce(const float* __restrict__ part, __nv_bfloat16* __restrict__ h,
              int M, int F, int splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(M) * F / 8) return;
  const int m = static_cast<int>(idx / (F / 8));
  const int col = static_cast<int>(idx % (F / 8)) * 8;
  const size_t plane = static_cast<size_t>(M) * 2 * F;
  const float* src = part + static_cast<size_t>(m) * 2 * F + col;
  float g[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float u[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float* p = src + s * plane;
#pragma unroll
    for (int c = 0; c < 8; c += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(p + c);
      const float4 uv = *reinterpret_cast<const float4*>(p + F + c);
      g[c] += gv.x; g[c + 1] += gv.y; g[c + 2] += gv.z; g[c + 3] += gv.w;
      u[c] += uv.x; u[c + 1] += uv.y; u[c + 2] += uv.z; u[c + 3] += uv.w;
    }
  }
  float y[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) y[c] = g[c] / (1.f + expf(-g[c])) * u[c];
  *reinterpret_cast<uint4*>(h + static_cast<size_t>(m) * F + col) =
      make_uint4(qie::mma::pack_bf16(y[0], y[1]),
                 qie::mma::pack_bf16(y[2], y[3]),
                 qie::mma::pack_bf16(y[4], y[5]),
                 qie::mma::pack_bf16(y[6], y[7]));
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

// (mt1, splits1, slice1): the gate / up pass's plan over K / 2 packed rows
// (pairs of gs_gate), (mt2, splits2, slice2) the down pass's over F / 2
// (pairs of gs_down), as for qie_quant_matmul4 (any mt at any M).  ws:
// the f32 partials, M x max(splits1 * 2 F, splits2 * K) values (the gate /
// up pass's [splits1, M, 2 F], then the down pass's [splits2, M, K]), then
// h bf16 [M, F].
extern "C" int qie_fused_mlp(const void* x, const void* wg, const void* sg,
                             const void* wu, const void* su, const void* wd,
                             const void* sd, void* ws, void* y, int M, int K,
                             int F, int gs_gate, int gs_down, int mt1,
                             int splits1, int slice1, int mt2, int splits2,
                             int slice2, int layer, int L, void* stream) {
  if (bad_mlp(M, K, F, gs_gate, gs_down, layer, L) || ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t part = static_cast<size_t>(M) *
                      (splits1 * 2 * F > splits2 * K ? splits1 * 2 * F
                                                     : splits2 * K);
  auto* h = reinterpret_cast<__nv_bfloat16*>(static_cast<float*>(ws) + part);
  if (!mma_call_ok(M, K / 2, gs_gate, mt1, splits1, slice1, ws, x, wg, sg) ||
      !mma_call_ok(M, K / 2, gs_gate, mt1, splits1, slice1, ws, x, wu, su) ||
      !mma_call_ok(M, F / 2, gs_down, mt2, splits2, slice2, ws, h, wd, sd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t wl = static_cast<size_t>(layer) * (K / 2) * F;
  const size_t sl = static_cast<size_t>(layer) * (K / gs_gate) * F;
  const size_t dl = static_cast<size_t>(layer) * (F / 2) * K;
  const size_t dsl = static_cast<size_t>(layer) * (F / gs_down) * K;
  auto q8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QmmArgs gate_up{x,
                        nullptr,
                        {q8(wg) + wl, q8(wu) + wl},
                        {f32(sg) + sl, f32(su) + sl},
                        nullptr,
                        ws,
                        M, K / 2, F, gs_gate, slice1};
  cudaError_t rc =
      launch_mma_mt<kW4A16, false, true>(mt1, gate_up, splits1, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const size_t threads = static_cast<size_t>(M) * F / 8;
  swiglu_reduce<<<(threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      f32(ws), h, M, F, splits1);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const QmmArgs down{h,
                     nullptr,
                     {q8(wd) + dl, nullptr},
                     {f32(sd) + dsl, nullptr},
                     static_cast<__nv_bfloat16*>(y),
                     ws,
                     M, F / 2, K, gs_down, slice2};
  return static_cast<int>(run_mma<kW4A16, false>(mt2, down, splits2, st));
}

// The attention of rows [row0, row0 + Ba) at layer_a, then fused_mlp of
// layer_m on x [M, K]: the gate / up pass's plan (mt1 1 or 4: its blocks
// run the attention block's 128 threads, splits1, slice1) and the down
// pass's, ws (ws_bytes long) as for qie_fused_mlp.
extern "C" int qie_fused_attn_mlp(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lens, void* attn, const void* x, const void* wg,
    const void* sg, const void* wu, const void* su, const void* wd,
    const void* sd, void* ws, long long ws_bytes, void* y, int Lc, int Bc,
    int Ba, int Hq, int Hk, int S, int layer_a, int row0, int M, int K,
    int F, int gs_gate, int gs_down, int mt1, int splits1, int slice1,
    int mt2, int splits2, int slice2, int layer_m, int L, float scale,
    void* stream) {
  if (bad_mlp(M, K, F, gs_gate, gs_down, layer_m, L) ||
      bad_attn(Lc, Bc, Ba, Hq, Hk, S, layer_a, row0) ||
      (mt1 != 1 && mt1 != 4) || ws == nullptr || splits1 < 1 ||
      splits2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t part = static_cast<size_t>(M) *
                      (splits1 * 2 * F > splits2 * K ? splits1 * 2 * F
                                                     : splits2 * K);
  if (ws_bytes < static_cast<long long>(4 * part + 2ull * M * F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* h = reinterpret_cast<__nv_bfloat16*>(static_cast<float*>(ws) + part);
  if (!mma_call_ok(M, K / 2, gs_gate, mt1, splits1, slice1, ws, x, wg, sg) ||
      !mma_call_ok(M, K / 2, gs_gate, mt1, splits1, slice1, ws, x, wu, su) ||
      !mma_call_ok(M, F / 2, gs_down, mt2, splits2, slice2, ws, h, wd, sd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t wl = static_cast<size_t>(layer_m) * (K / 2) * F;
  const size_t sl = static_cast<size_t>(layer_m) * (K / gs_gate) * F;
  const size_t dl = static_cast<size_t>(layer_m) * (F / 2) * K;
  const size_t dsl = static_cast<size_t>(layer_m) * (F / gs_down) * K;
  auto q8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QmmArgs gate_up{x,
                        nullptr,
                        {q8(wg) + wl, q8(wu) + wl},
                        {f32(sg) + sl, f32(su) + sl},
                        nullptr,
                        ws,
                        M, K / 2, F, gs_gate, slice1};
  const AttnArgs at{bf(q),     bf(k_cache), bf(v_cache),
                    static_cast<const int*>(lens),
                    static_cast<__nv_bfloat16*>(attn),
                    Bc, Ba, Hq, Hk, S, layer_a, row0, scale};
  cudaError_t rc = launch_attn_qmm_mt<true>(mt1, at, gate_up, splits1, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const size_t threads = static_cast<size_t>(M) * F / 8;
  swiglu_reduce<<<(threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      f32(ws), h, M, F, splits1);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const QmmArgs down{h,
                     nullptr,
                     {q8(wd) + dl, nullptr},
                     {f32(sd) + dsl, nullptr},
                     static_cast<__nv_bfloat16*>(y),
                     ws,
                     M, F / 2, K, gs_down, slice2};
  return static_cast<int>(run_mma<kW4A16, false>(mt2, down, splits2, st));
}

// The attention of rows [row0, row0 + Ba) at `layer`, beside y [M, N] =
// x [M, K] @ W4[layer] (plane pairs of gs packed rows) on the plan (mt 1
// or 4: its blocks run beside the attention blocks at 128 threads,
// splits, slice) over K / 2 packed rows, as for qie_quant_matmul4: one
// slice writes y; more write their f32 partials to ws ([splits, M, N],
// ws_bytes long), which qmm_reduce adds.
extern "C" int qie_fused_attn_matmul(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lens, void* attn, const void* x, const void* w,
    const void* scales, void* ws, long long ws_bytes, void* y, int Lc,
    int Bc, int Ba, int Hq, int Hk, int S, int row0, int M, int K, int N,
    int gs, int mt, int splits, int slice, int layer, int L, float scale,
    void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % kSmallCols || gs <= 0 ||
      gs % kChunk || K % (2 * gs) || layer < 0 || layer >= L ||
      bad_attn(Lc, Bc, Ba, Hq, Hk, S, layer, row0) ||
      (mt != 1 && mt != 4) ||
      !mma_call_ok(M, K / 2, gs, mt, splits, slice, ws, x, w, scales) ||
      (splits > 1 &&
       ws_bytes < 4ll * splits * static_cast<long long>(M) * N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* wl = static_cast<const int8_t*>(w) +
                     static_cast<size_t>(layer) * (K / 2) * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * (K / gs) * N;
  auto* out = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnArgs at{static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(k_cache),
                    static_cast<const __nv_bfloat16*>(v_cache),
                    static_cast<const int*>(lens),
                    static_cast<__nv_bfloat16*>(attn),
                    Bc, Ba, Hq, Hk, S, layer, row0, scale};
  const QmmArgs mm{x,   nullptr, {wl, nullptr}, {sl, nullptr},
                   out, splits == 1 ? nullptr : ws,
                   M,   K / 2,   N, gs, slice};
  cudaError_t rc = launch_attn_qmm_mt<false>(mt, at, mm, splits, st);
  if (rc != cudaSuccess || splits == 1) return static_cast<int>(rc);
  return static_cast<int>(launch_qmm_reduce<kW4A16, false>(mm, splits, st));
}
