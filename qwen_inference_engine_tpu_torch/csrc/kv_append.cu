// INT8-KV decode append into the stacked contiguous cache, Hopper.
//
// Replaces: qwen_inference_engine_tpu/ops/kv_append.py::kv_append_uniform_q8
// (body _uniform_append_q8_kernel).
//
// In place: int8 k_new / v_new [B, Hk, D] and f32 ks_new / vs_new [B, Hk]
// into cache[layer, b, hk, position] of the int8 caches [L, Bc, Hk, S, D]
// and the scales [L, Bc, Hk, S], for rows b < B.  Every row shares the one
// position, a 1-element int32 tensor read on the device, so the host never
// waits for it; a position outside [0, S) writes nothing.
//
// What bounds it on the H100: it moves 2 * B * Hk * (D + 4) bytes in and as
// many out (4.2 KB at B=4 for Qwen2.5-7B): a few nanoseconds at 3.35 TB/s,
// so the launch itself (a few microseconds) bounds it in practice.
//
// Design: one block per (KV head, row), one thread per byte of the head
// vector; thread 0 also writes the two scales.  The TPU kernel read and
// wrote back a 32-row band and a 128-lane scale tile because its memory
// moves in (32, 128) tiles; that is tiling, not semantics: here only the
// one row and its two scales are written, bit for bit, and nothing else of
// the cache is touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void kv_append_q8_kernel(
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int8_t* __restrict__ k_new, const int8_t* __restrict__ v_new,
    const float* __restrict__ ks_new, const float* __restrict__ vs_new,
    const int* __restrict__ position_ptr, int Bc, int Hk, int S, int D,
    int layer) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int position = *position_ptr;
  if (position < 0 || position >= S) return;
  const long long row = (static_cast<long long>(layer) * Bc + b) * Hk + hk;
  const long long src = static_cast<long long>(b) * Hk + hk;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    k_cache[(row * S + position) * D + d] = k_new[src * D + d];
    v_cache[(row * S + position) * D + d] = v_new[src * D + d];
  }
  if (threadIdx.x == 0) {
    k_scale[row * S + position] = ks_new[src];
    v_scale[row * S + position] = vs_new[src];
  }
}

}  // namespace

extern "C" int qie_kv_append_q8(void* k_cache, void* v_cache, void* k_scale,
                                void* v_scale, const void* k_new,
                                const void* v_new, const void* ks_new,
                                const void* vs_new, const void* position,
                                int L, int Bc, int B, int Hk, int S, int D,
                                int layer, void* stream) {
  if (B <= 0 || B > Bc || Hk <= 0 || D <= 0 || D > 1024 || S <= 0 ||
      layer < 0 || layer >= L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(Hk, B);
  kv_append_q8_kernel<<<grid, D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int8_t*>(k_new), static_cast<const int8_t*>(v_new),
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      static_cast<const int*>(position), Bc, Hk, S, D, layer);
  return static_cast<int>(cudaGetLastError());
}
