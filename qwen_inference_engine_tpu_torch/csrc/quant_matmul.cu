// W4A8 quantized matmul for Hopper (sm_90a): y[M,N] = (x_q @ W4[layer]) * sx.
//
// Replaces: qwen_inference_engine_tpu/ops/quant_matmul.py::_quant_matmul4_a8
// (kernel body _qmm4_a8_kernel), the projection kernel of every W4A8
// transformer block.
//
// Inputs: per-token int8 activations x [M, Kp] with f32 row scales sx [M]
// (quantized outside the kernel, as in the JAX package); the layer-stacked
// INT4 plane-pair weights q [L, Kp/2, N] int8 (byte = 16*hi + (lo+8); packed
// rows p*gs..(p+1)*gs hold group 2p in the low nibble, group 2p+1 in the
// high nibble) and group scales [L, Kp/gs, N] f32.  The host offsets q and
// scales to the layer's slab, so the stacked weights are never copied.
//
// What bounds it on the H100: at decode (M = batch, a few rows) it reads
// every weight byte once for 2*M operations per byte, far below the ~590
// int8 operations per byte where the tensor cores would take over: it is
// bound by bytes (Kp*N/2 weight bytes at 3.35 TB/s).  At prefill
// (M = 512 * batch) it is bound by operations.
//
// Design: the simple and right version first.  A block computes a BM x 128
// output tile with 256 threads; each thread owns TM rows x 4 adjacent
// columns.  Per k-step the block stages 32 packed weight rows (4 KB,
// 16-byte coalesced loads) and the matching 32 even-plane and 32 odd-plane
// activation columns in shared memory.  A thread reads 4 packed rows of
// its 4 columns as four 32-bit words and transposes them with __byte_perm,
// so each word holds 4 consecutive k of one column; the nibbles are
// unpacked four at a time (lo+8 = w & 0x0F0F0F0F, hi by a per-byte signed
// shift with __vsub4) and fed to __dp4a, s8 x s8 -> s32.  Each plane-pair
// accumulates its two products in int32; the lo plane's excess-8 is
// corrected by 8 * rowsum(x_even) in int32, then the two group scales
// multiply the int32 partials into an f32 accumulator, and the row scale
// is applied in the epilogue.  The tensor cores (mma.sync / wgmma on s8)
// and a pipelined weight stream for decode are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;   // output columns per block: 32 threads x 4
constexpr int kBKP = 32;   // packed weight rows per k-step

// Signed high nibble of each byte of w, as four int8 lanes.
__device__ __forceinline__ int high_nibbles(unsigned w) {
  const unsigned u = (w >> 4) & 0x0F0F0F0Fu;          // 0..15 per byte
  return static_cast<int>(__vsub4(u ^ 0x08080808u, 0x08080808u));
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
qmm4_a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const int8_t* __restrict__ q, const float* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, int M, int Kp, int N, int gs) {
  constexpr int BM = 8 * TM;  // 8 warps along M
  __shared__ __align__(16) int8_t xs_e[BM][kBKP];
  __shared__ __align__(16) int8_t xs_o[BM][kBKP];
  __shared__ __align__(16) int8_t ws[kBKP][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 32;   // columns n0 + 4*tx .. +3
  const int ty = tid / 32;   // rows m0 + ty*TM .. +TM-1
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
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
        const unsigned r0 = *reinterpret_cast<const unsigned*>(&ws[kk + 0][4 * tx]);
        const unsigned r1 = *reinterpret_cast<const unsigned*>(&ws[kk + 1][4 * tx]);
        const unsigned r2 = *reinterpret_cast<const unsigned*>(&ws[kk + 2][4 * tx]);
        const unsigned r3 = *reinterpret_cast<const unsigned*>(&ws[kk + 3][4 * tx]);
        // 4x4 byte transpose: colw[j] = rows kk..kk+3 of column 4*tx + j
        const unsigned t01a = __byte_perm(r0, r1, 0x5140);
        const unsigned t23a = __byte_perm(r2, r3, 0x5140);
        const unsigned t01b = __byte_perm(r0, r1, 0x7362);
        const unsigned t23b = __byte_perm(r2, r3, 0x7362);
        unsigned colw[4];
        colw[0] = __byte_perm(t01a, t23a, 0x5410);
        colw[1] = __byte_perm(t01a, t23a, 0x7632);
        colw[2] = __byte_perm(t01b, t23b, 0x5410);
        colw[3] = __byte_perm(t01b, t23b, 0x7632);
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

}  // namespace

extern "C" int qie_quant_matmul4_a8(const void* x, const void* sx,
                                    const void* q, const void* scales,
                                    void* out, int M, int Kp, int N, int gs,
                                    int layer, int L, void* stream) {
  if (M <= 0 || N % kBN || gs % kBKP || Kp % (2 * gs) || layer < 0 ||
      layer >= L) {
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
