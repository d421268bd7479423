// Key policies of the tensor-core attention core (attention_mma.cuh):
// where key j of one (batch row, KV head) lives, and where its int8 scale
// lives, resolved for each 16-byte chunk as a tile is staged.
// `ContiguousKeys` puts key j at j * stride elements from key 0 (a
// contiguous cache slab, fresh K/V); `PagedKeys` follows a block table,
// page tables[t / page], row t % page, so a 64-key tile may span any
// number of pages (a page only has to be a multiple of 8 tokens); an int8
// pool's scales [L, P, Hk, page] follow the same table.  kNegInf is the
// score of a masked key.

#pragma once

#include <cuda_runtime.h>

namespace qie {

constexpr float kNegInf = -1e30f;

// Key j at j * stride elements from key 0; its scale at j.
struct ContiguousKeys {
  long long stride;
  __device__ __forceinline__ long long offset(int j) const {
    return j * stride;
  }
  __device__ __forceinline__ long long scale(int j) const { return j; }
};

// Key j of one (layer, KV head) in the stacked page pool [L, P, Hk, page,
// D], counted from the row's key `first` (0 unless a caller splits the
// keys across blocks): the base pointers point at page 0 of that layer
// and head, so key j is sequence key t = first + j, at tables[t / page] *
// page_stride + (t % page) * D elements, and its scale (an int8 pool's
// [L, P, Hk, page]) at tables[t / page] * scale_stride + t % page.  A
// split's first key need not start a page.
struct PagedKeys {
  const int* table;        // this row's block table
  int page;                // tokens per page
  int D;
  long long page_stride;   // elements from one page to the next: Hk*page*D
  long long scale_stride;  // scales from one page to the next: Hk*page
  int first = 0;           // sequence key of key 0
  __device__ __forceinline__ long long offset(int j) const {
    const int t = first + j;
    return static_cast<long long>(table[t / page]) * page_stride +
           static_cast<long long>(t % page) * D;
  }
  __device__ __forceinline__ long long scale(int j) const {
    const int t = first + j;
    return static_cast<long long>(table[t / page]) * scale_stride + t % page;
  }
};

}  // namespace qie
