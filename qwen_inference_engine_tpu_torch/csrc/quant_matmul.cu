// Quantized matmuls for Hopper (sm_90a): y[M,N] = x @ Wq[layer], bf16 out.
//
// Four entry points, each the port of one Pallas kernel of
// qwen_inference_engine_tpu/ops/quant_matmul.py:
//
//   qmm_mma_kernel<kW4A8>   <- _quant_matmul4_a8 (_qmm4_a8_kernel): W4A8
//   qmm_w16_small / qmm_w16_wmma <- _quant_matmul4 (_qmm4_kernel): W4A16
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
// * W8A8, W4A8 and W8A16 share one tensor-core kernel, qmm_mma_kernel:
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
// * W4A16 at M <= 16 (qmm_w16_small): bound by bytes, so the weights are
//   streamed once with f32 FMAs on the CUDA cores.  A block owns 64
//   columns (16 threads x 4) and splits K over 16 thread groups in chunks
//   of 32 weight rows (one scale group each); a thread issues its chunk's
//   32 weight loads before it computes, to keep bytes in flight.  The 16
//   partial sums of a column are added in a fixed order through shared
//   memory, so the result does not depend on scheduling.
// * W4A16 at M > 16 (qmm_w16_wmma): the bf16 tensor cores through
//   nvcuda::wmma 16x16x16 fragments with an f32 accumulator (4 warps, a
//   64 x 64 tile, 2 x 2 fragments a warp).  Per k-step the block
//   dequantizes 64 logical rows (both planes of 32 packed rows) into bf16
//   in shared memory, q * scale.
// The W4A16 tile bodies live in quant_matmul_core.cuh, shared with the
// grouped MoE kernels (grouped_matmul.cu) and the fused MLP
// (fused_step.cu).  The tensor-core kernel uses the PTX wrappers of
// attention_mma.cuh (qie::mma: cp.async, ldmatrix, mma.sync).

#include <type_traits>

#include "attention_mma.cuh"
#include "quant_matmul_core.cuh"

namespace {

using qie::kChunk;
using qie::kSmallCols;
using qie::kThreads;
using qie::kWBM;
using qie::kWBN;
using qie::kWThreads;

// ---- W8A8, W4A8, W8A16 on the tensor cores
enum QmmKind : int { kW8A8, kW4A8, kW8A16 };

constexpr int kMmaCols = 128;  // columns a block: 4 warps x 32
constexpr int kMmaRows = 64;   // weight rows a stage
constexpr int kStages = 4;     // cp.async ring

// bytes of one activation row a stage holds: W8A8 64 int8; W4A8 the 64
// int8 of each plane; W8A16 64 bf16.  Rows are padded by 16 bytes, so the
// 8 row addresses of an ldmatrix phase fall on distinct banks.
template <int kKind>
__host__ __device__ constexpr int x_bytes() {
  return kKind == kW8A8 ? 64 : 128;
}

template <int kKind, int MT, int WM>
constexpr int qmm_smem() {
  return kStages * (16 * MT * WM * (x_bytes<kKind>() + 16) +
                    kMmaRows * kMmaCols);
}

// The 16-byte chunk of weight row r that holds chunk ch: a stage's rows are
// swizzled so the B reads hit 32 distinct banks (int8 activations: rows
// 4 quad + i, one word per lane; W8A16: rows 2 quad + {0, 1, 8, 9}).
template <int kKind>
__device__ __forceinline__ int w_chunk(int r, int ch) {
  constexpr int kShift = kKind == kW8A16 ? 1 : 2;
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

// Block (blockIdx.x, blockIdx.y, blockIdx.z): rows [BM x, BM x + BM),
// columns [128 y, 128 y + 128), weight rows [slice z, min(K, slice (z +
// 1))); the row tiles of one column tile run side by side, so a prefill
// wave reads its weight columns from memory once and the rest from L2.  K
// counts weight rows (W4A8: packed rows, Kp / 2) and gs is the fold unit
// in weight rows (a group; W4A8 a pair's gs packed rows).  ws null: writes
// bf16 out (one slice over K); else writes the slice's partials (int32 for
// W8A8 per column, else f32) to ws [splits, M, N].
template <int kKind, int MT, int WM, bool kPerCol>
__global__ void __launch_bounds__(128 * WM, WM == 2 && kPerCol ? 2 : 1)
qmm_mma_kernel(const void* __restrict__ xv, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, void* __restrict__ ws, int M,
               int K, int N, int gs, int slice) {
  constexpr bool kInt = kKind != kW8A16;  // int8 activations, int32 sums
  constexpr int kPlanes = kKind == kW4A8 ? 2 : 1;
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
  const unsigned char* x = static_cast<const unsigned char*>(xv);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wn = warp % 4, wm = warp / 4;
  const int grp = lane / 4, quad = lane % 4;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kMmaCols;
  const int kb = blockIdx.z * slice;
  const int ke = min(K, kb + slice);
  const int n_steps = (ke - kb) / kStepRows;  // k-steps of the slice
  const int n_stages = (ke - kb + kMmaRows - 1) / kMmaRows;
  // an activation row in bytes: W4A8 holds 2 logical k a packed row, W8A16
  // 2 bytes an element
  const size_t x_ld = static_cast<size_t>(K) * (kKind == kW8A8 ? 1 : 2);

  // weight rows past the slice's end, columns past N (W8A16's 64-column
  // edge) and activation rows past M are zero-filled (read nothing)
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
      if constexpr (kKind == kW4A8) {
        // k-step ch / 4 (packed rows r0..r0+31 of pair r0 / gs), plane
        // (ch / 2) % 2, 16-byte half ch % 2
        const int r0 = k0 + 32 * (ch / 4);
        ok = r0 < ke;
        kx = (r0 / gs) * 2 * gs + r0 % gs + ((ch / 2) % 2) * gs +
             16 * (ch % 2);
      } else if constexpr (kKind == kW8A16) {
        ok = k0 + 8 * ch < ke;
        kx = 2 * k0 + 16 * ch;
      } else {
        ok = k0 + 16 * ch < ke;
        kx = k0 + 16 * ch;
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
  // the next fold: after weight row fold_at, of group g (W4A8: pair g, its
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
      if constexpr (kInt) {
        unsigned b[2][4];  // k 0..15 / 16..31 of column tiles 0..3
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = 32 * h + 16 * hi + 4 * quad;
          qie::transpose4x4(w_word(row), w_word(row + 1), w_word(row + 2),
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
                  static_cast<unsigned>(qie::high_nibbles(b[hi][j]));
            } else {
              bp[0][hi][j] = b[hi][j];
            }
          }
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            qie::mma::ldmatrix_x4(
                a[i], xt + (16 * (MT * wm + i) + a_row) * XR +
                          32 * kPlanes * h + 32 * p + a_half);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              qie::mma::mma_s8(acc[p][i][j], a[i], bp[p][0][j], bp[p][1][j]);
            }
        }
      } else {
        uint32_t b[4][2];  // column tile j: k (2q, 2q+1), (2q+8, 2q+9)
        {
          const int row = 16 * h + 2 * quad;
          unsigned colw[4];
          qie::transpose4x4(w_word(row), w_word(row + 1), w_word(row + 8),
                            w_word(row + 9), colw);
#pragma unroll
          for (int j = 0; j < 4; ++j) s8x4_to_bf16(colw[j], b[j][0], b[j][1]);
        }
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          qie::mma::ldmatrix_x4(
              a[i], xt + (16 * (MT * wm + i) + a_row) * XR + 32 * h + a_half);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qie::mma::mma_bf16(acc[0][i][j], a[i], b[j][0], b[j][1]);
          }
      }
      if constexpr (!kPerCol) {
        if (kb + kStepRows * (kSteps * s + h + 1) == fold_at) {
          // a group's (W4A8: a pair's) sum is done
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 4 * (e % 2) + j;
                if constexpr (kKind == kW4A8) {  // acc + (a s_lo + b s_hi)
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
      if (ws != nullptr) {  // this slice's partials
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
        uint32_t* dst = static_cast<uint32_t*>(ws) +
                        (static_cast<size_t>(blockIdx.z) * M + m) * N + col;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(dst + 4) = make_uint4(v[4], v[5], v[6], v[7]);
      } else {
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = c % 4, e = 2 * half + c / 4;
          if constexpr (!kPerCol) {
            if constexpr (kInt) {
              y[c] = accf[i][j][e] * sx[m];
            } else {
              y[c] = accf[i][j][e];
            }
          } else if constexpr (kInt) {
            y[c] = static_cast<float>(acc[0][i][j][e]) * sc[c] * sx[m];
          } else {
            y[c] = acc[0][i][j][e] * sc[c];
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

template <int kKind, int MT, int WM, bool kPerCol>
cudaError_t launch_mma(const void* x, const float* sx, const int8_t* q,
                       const float* s, __nv_bfloat16* out, void* ws, int M,
                       int K, int N, int gs, int splits, int slice,
                       cudaStream_t st) {
  const auto kern = qmm_mma_kernel<kKind, MT, WM, kPerCol>;
  constexpr int smem = qmm_smem<kKind, MT, WM>();
  cudaError_t rc;
  if (smem > 48 * 1024) {  // past the default limit
    rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  const int bm = 16 * MT * WM;
  kern<<<dim3((M + bm - 1) / bm, (N + kMmaCols - 1) / kMmaCols, splits),
         128 * WM, smem, st>>>(x, sx, q, s, out, splits > 1 ? ws : nullptr,
                               M, K, N, gs, slice);
  if (splits > 1) {
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    const size_t threads = static_cast<size_t>(M) * N / 8;
    qmm_reduce<kKind == kW8A8 && kPerCol>
        <<<(threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
            ws, kKind == kW8A16 ? nullptr : sx, kPerCol ? s : nullptr, out, M,
            N, splits);
  }
  return cudaGetLastError();
}

template <int kKind, bool kPerCol>
cudaError_t launch_mma_mt(int mt, const void* x, const float* sx,
                          const int8_t* q, const float* s, void* out,
                          void* ws, int M, int K, int N, int gs, int splits,
                          int slice, cudaStream_t st) {
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (mt) {
    case 1:
      return launch_mma<kKind, 1, 1, kPerCol>(x, sx, q, s, o, ws, M, K, N, gs,
                                              splits, slice, st);
    case 4:
      return launch_mma<kKind, 4, 1, kPerCol>(x, sx, q, s, o, ws, M, K, N, gs,
                                              splits, slice, st);
    default:  // prefill
      return launch_mma<kKind, 4, 2, kPerCol>(x, sx, q, s, o, ws, M, K, N, gs,
                                              1, K, st);
  }
}

// A tensor-core call's plan over `rows` weight rows: mt 1 or 4 (M <= 16 mt)
// with `splits` slices of `slice` rows (multiples of 32 and of `unit`, the
// last may be shorter; ws not null when splits > 1), or mt 0 (prefill) and
// one slice.  cp.async copies 16-byte chunks of x and q.
bool mma_call_ok(int M, int rows, int unit, int mt, int splits, int slice,
                 const void* ws, const void* x, const void* q) {
  const bool plan_ok =
      mt == 0 ? splits == 1
              : ((mt == 1 || mt == 4) && M <= 16 * mt && splits >= 1 &&
                 slice > 0 && slice % 32 == 0 && slice % unit == 0 &&
                 static_cast<long long>(splits - 1) * slice < rows &&
                 static_cast<long long>(splits) * slice >= rows &&
                 (splits == 1 || ws != nullptr));
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(q)) % 16 == 0;
  return plan_ok && aligned;
}

// ---- W4A16: CUDA cores at M <= 16, wmma tiles above
template <int MT>
__global__ void __launch_bounds__(kThreads)
qmm_w16_small_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     __nv_bfloat16* __restrict__ out, int M, int K, int N,
                     int gs) {
  qie::tile_w16_small<true, MT>(x, q, scales, out, M, K, N, gs, false,
                                blockIdx.y * MT, blockIdx.x * kSmallCols);
}

__global__ void __launch_bounds__(kWThreads)
qmm_w16_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int gs) {
  qie::tile_w16_wmma<true>(x, q, scales, out, M, K, N, gs, false,
                           blockIdx.y * kWBM, blockIdx.x * kWBN);
}

cudaError_t launch_w4a16(const void* x, const int8_t* q, const float* s,
                         void* out, int M, int K, int N, int gs,
                         cudaStream_t st) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (M <= 4) {
    qmm_w16_small_kernel<4><<<dim3(N / kSmallCols, 1), kThreads, 0, st>>>(
        xb, q, s, o, M, K, N, gs);
  } else if (M <= 16) {
    qmm_w16_small_kernel<8><<<dim3(N / kSmallCols, (M + 7) / 8), kThreads, 0,
                              st>>>(xb, q, s, o, M, K, N, gs);
  } else {
    qmm_w16_wmma_kernel<<<dim3(N / kWBN, (M + kWBM - 1) / kWBM), kWThreads, 0,
                           st>>>(xb, q, s, o, M, K, N, gs);
  }
  return cudaGetLastError();
}

}  // namespace

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
      !mma_call_ok(M, Kp / 2, gs, mt, splits, slice, ws, x, q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * (Kp / 2) * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * (Kp / gs) * N;
  return static_cast<int>(launch_mma_mt<kW4A8, false>(
      mt, x, static_cast<const float*>(sx), ql, sl, out, ws, M, Kp / 2, N, gs,
      splits, slice, static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(launch_w4a16(x, ql, sl, out, M, Kp, N, gs,
                                       static_cast<cudaStream_t>(stream)));
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
      !mma_call_ok(M, K, G == 1 ? 32 : gs, mt, splits, slice, ws, x, q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * K * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * G * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      G == 1 ? launch_mma_mt<kW8A16, true>(mt, x, nullptr, ql, sl, out, ws, M,
                                           K, N, gs, splits, slice, st)
             : launch_mma_mt<kW8A16, false>(mt, x, nullptr, ql, sl, out, ws,
                                            M, K, N, gs, splits, slice, st));
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
      !mma_call_ok(M, K, G == 1 ? 32 : gs, mt, splits, slice, ws, x, q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) +
                     static_cast<size_t>(layer) * K * N;
  const float* sl = static_cast<const float*>(scales) +
                    static_cast<size_t>(layer) * G * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  return static_cast<int>(
      G == 1 ? launch_mma_mt<kW8A8, true>(mt, x, sxf, ql, sl, out, ws, M, K,
                                          N, gs, splits, slice, st)
             : launch_mma_mt<kW8A8, false>(mt, x, sxf, ql, sl, out, ws, M, K,
                                           N, gs, splits, slice, st));
}
