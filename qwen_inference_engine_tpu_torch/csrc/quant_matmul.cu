// Quantized matmuls for Hopper (sm_90a): y[M,N] = x @ Wq[layer], bf16 out.
//
// Four entry points, each the port of one Pallas kernel of
// qwen_inference_engine_tpu/ops/quant_matmul.py:
//
//   qmm_mma_kernel<kW4A8>   <- _quant_matmul4_a8 (_qmm4_a8_kernel): W4A8
//   qmm_mma_kernel<kW4A16>  <- _quant_matmul4 (_qmm4_kernel): W4A16
//   qmm_mma_kernel<kW8A16>  <- _quant_matmul8 (_qmm8_kernel): W8A16
//   qmm_mma_kernel<kW8A8>   <- _quant_matmul8_a8 (_qmm8_a8_kernel): W8A8
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
// * All four run on one tensor-core kernel, qmm_mma_kernel (in
//   quant_matmul_core.cuh, which the fused MLP of fused_step.cu shares):
//   mma.sync m16n8k32 s8 x s8 -> s32 for int8 activations, m16n8k16
//   bf16 x bf16 -> f32 for bf16 ones.  Each warp owns 16 * MT rows x 32
//   columns; a block is WM x 4 warps, 128 columns wide.  The weight tile
//   (64 weight rows x 128 columns a stage) and the activation tile are
//   staged by cp.async into a ring of kStages, so three tiles are in
//   flight while one is multiplied.  The activations feed the A operand
//   with ldmatrix.  The weight is [K, N] with N contiguous (the JAX
//   package's bytes, never repacked) while the B operand wants k-runs of
//   one column in a register: a lane reads 4 k-rows of one 4-column word
//   from shared memory and transposes them with __byte_perm
//   (transpose4x4), which gives its B registers for 4 column tiles at
//   once; the tiles' columns are permuted (tile j, column g -> 4 g + j),
//   so a lane's accumulators cover 8 adjacent output columns and store as
//   one 16-byte word.  The weight rows are XOR-swizzled by 16-byte chunk
//   so those reads hit 32 distinct banks.
//   - W8A8: B is the transposed word itself (rows 4 quad + 0..3).  A
//     group's int32 sum is exact and is scaled into f32 at the group's end
//     (one scale per column: in the epilogue).
//   - W4A8: one transposed word of 4 packed rows feeds two mma calls, the
//     even plane (lo = (w & 0x0F0F0F0F) - 8 per byte, signed and exact, so
//     the TPU's excess-8 row-sum correction is not needed: x.(lo+8) - 8 Sx
//     = x.lo) against the activation columns of group 2p, and the odd
//     plane (the signed high nibbles) against those of group 2p + 1.  x
//     stays in logical order: a stage holds, per k-step, the 32 columns of
//     each plane side by side.  Two int32 accumulator sets are folded into
//     f32 at each pair's end in the TPU's order, acc + (a s_lo + b s_hi).
//   - W8A16: B's m16n8k16 register holds k pairs (2q, 2q+1) and (2q+8,
//     2q+9), so a lane transposes rows 2q, 2q+1, 2q+8 and 2q+9 (a swizzle
//     of its own keeps those reads on 32 banks) and widens each int8 to
//     bf16 in registers, exactly (|q| <= 127 fits bf16's mantissa), by
//     way of the f32 2^23 + (q + 128).  The weight is never dequantized
//     into shared memory, so the ring holds int8.  A group's f32 sum is
//     scaled at the group's end; one scale per column in the epilogue.  N
//     needs only be a multiple of 64: a block's last 64 columns past N are
//     never loaded or stored.
//   - W4A16: W4A8's weight stage and plane pairs with W8A16's B register:
//     the lane transposes packed rows 2q, 2q+1, 2q+8 and 2q+9 (W8A16's
//     swizzle), and the one transposed word gives the B registers of both
//     planes, each nibble widened exactly to bf16 (0x4300 | n is 128 + n;
//     136 subtracted; the high nibble XORed with 8 first, so (u ^ 8) - 8
//     is its signed value).  A stage row holds both planes' 16 bf16 of
//     each k-step side by side (256 bytes).  Two f32 plane sums fold in
//     the TPU's order, acc + (a s_lo + b s_hi), so no q * scale is
//     rounded to bf16.  N a multiple of 64, as W8A16.
//   - Decode (M <= 64, MT = 1 or 4, one warp row): bound by the weight
//     bytes, and N / 128 blocks would leave most of the 132 SMs idle, so K
//     is split into slices that end on fold boundaries (a group, an INT4
//     pair, or per column a 64-row stage; ops/quant_matmul.py plans them:
//     about 4 blocks an SM).  Each slice writes its partial sums (int32
//     for W8A8 per column, else f32) to a workspace the wrapper allocates,
//     and qmm_reduce adds them in split order, applies the column scale
//     and sx where there are any, and rounds once: no float atomics, two
//     calls bit-identical, and W8A8 per column exact (float(sum) * scale *
//     sx, whatever the split count).
//   - Prefill (M > 64): MT = 4, WM = 2 (128 x 128 tiles, 8 warps), no
//     split, the row tiles of a column tile side by side for L2 reuse; the
//     bf16 output is written directly.

#include "quant_matmul_core.cuh"

using qie::kMmaCols;
using qie::kW4A16;
using qie::kW4A8;
using qie::kW8A16;
using qie::kW8A8;
using qie::mma_call_ok;
using qie::QmmArgs;
using qie::run_mma;

// mt: the decode stream's m16 tiles a warp (1 or 4; M <= 16 mt), with the
// Kp / 2 packed rows split into `splits` slices of `slice` rows (multiples
// of gs: whole plane pairs; ws [splits, M, N] f32 when splits > 1); or mt
// 0, the prefill tiles (splits 1).
extern "C" int qie_quant_matmul4_a8(const void* x, const void* sx,
                                    const void* q, const void* scales,
                                    void* ws, void* out, int M, int Kp, int N,
                                    int gs, int mt, int splits, int slice,
                                    int layer, int L, void* stream) {
  if (M <= 0 || N % kMmaCols || gs <= 0 || gs % 32 || Kp % (2 * gs) ||
      layer < 0 || layer >= L ||
      !mma_call_ok(M, Kp / 2, gs, mt, splits, slice, ws, x, q, scales)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * (Kp / 2) * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * (Kp / gs) * N;
  const QmmArgs a{x, static_cast<const float*>(sx), {ql, nullptr},
                  {sl, nullptr}, static_cast<__nv_bfloat16*>(out), ws,
                  M, Kp / 2, N, gs, slice};
  return static_cast<int>(
      run_mma<kW4A8, false>(mt, a, splits, static_cast<cudaStream_t>(stream)));
}

// The plan as for W4A8; N a multiple of 64 (a last column tile may leave
// 64 columns empty).
extern "C" int qie_quant_matmul4(const void* x, const void* q,
                                 const void* scales, void* ws, void* out,
                                 int M, int Kp, int N, int gs, int mt,
                                 int splits, int slice, int layer, int L,
                                 void* stream) {
  if (M <= 0 || N % 64 || gs <= 0 || gs % 32 || Kp % (2 * gs) ||
      layer < 0 || layer >= L ||
      !mma_call_ok(M, Kp / 2, gs, mt, splits, slice, ws, x, q, scales)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * (Kp / 2) * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * (Kp / gs) * N;
  const QmmArgs a{x, nullptr, {ql, nullptr}, {sl, nullptr},
                  static_cast<__nv_bfloat16*>(out), ws, M, Kp / 2, N, gs,
                  slice};
  return static_cast<int>(
      run_mma<kW4A16, false>(mt, a, splits, static_cast<cudaStream_t>(stream)));
}

// The plan as for W4A8 over K rows, slices of a multiple of the group size
// (per column: of 32); ws [splits, M, N] f32.  N may leave 64 columns of
// the last column tile empty.
extern "C" int qie_quant_matmul8(const void* x, const void* q,
                                 const void* scales, void* ws, void* out,
                                 int M, int K, int N, int G, int mt,
                                 int splits, int slice, int layer, int L,
                                 void* stream) {
  const int gs = G > 0 ? K / G : 0;
  if (M <= 0 || N % 64 || K % 32 || G <= 0 || K % G ||
      (G > 1 && gs % 32) || layer < 0 || layer >= L ||
      !mma_call_ok(M, K, G == 1 ? 32 : gs, mt, splits, slice, ws, x, q,
                   scales)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * K * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * G * N;
  const QmmArgs a{x, nullptr, {ql, nullptr}, {sl, nullptr},
                  static_cast<__nv_bfloat16*>(out), ws, M, K, N, gs, slice};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(G == 1 ? run_mma<kW8A16, true>(mt, a, splits, st)
                                 : run_mma<kW8A16, false>(mt, a, splits, st));
}

// The plan as for W8A16; ws [splits, M, N] of 4-byte partials (int32 per
// column, else f32).
extern "C" int qie_quant_matmul8_a8(const void* x, const void* sx,
                                    const void* q, const void* scales,
                                    void* ws, void* out, int M, int K, int N,
                                    int G, int mt, int splits, int slice,
                                    int layer, int L, void* stream) {
  const int gs = G > 0 ? K / G : 0;
  if (M <= 0 || N % kMmaCols || K % 32 || G <= 0 || K % G ||
      (G > 1 && gs % 32) || layer < 0 || layer >= L ||
      !mma_call_ok(M, K, G == 1 ? 32 : gs, mt, splits, slice, ws, x, q,
                   scales)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * K * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * G * N;
  const QmmArgs a{x, static_cast<const float*>(sx), {ql, nullptr},
                  {sl, nullptr}, static_cast<__nv_bfloat16*>(out), ws, M, K,
                  N, gs, slice};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(G == 1 ? run_mma<kW8A8, true>(mt, a, splits, st)
                                 : run_mma<kW8A8, false>(mt, a, splits, st));
}
