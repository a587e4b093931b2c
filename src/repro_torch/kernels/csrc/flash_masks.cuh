// The masks and the tile loads that flash attention's training kernels
// share, fp32 (flash_attention_train.cu, flash_attention_bwd.cu) and bf16
// (flash_attention_train_bf16.cu, flash_attention_bwd_bf16.cu): which keys
// a query sees (causal, a sliding window), whether a tile is hidden from
// all of a range of queries, which queries see a range of keys, and (for
// the fp32 kernels, whose tiles are not TMA's) the copy of a tile of rows
// into shared memory with zeros past its edges. Include it after
// mma_tf32.cuh, whose cp_async16 load_rows calls, or hopper_bf16.cuh.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// no query position of [q0, q1] sees any key of [k0, k1]: the masks hide a
// whole tile, whose product is zero and skipped
__device__ __forceinline__ bool hidden(int q0, int q1, int k0, int k1, int causal, int window) {
  return (causal && k0 > q1) || (window > 0 && k1 <= q0 - window);
}

// [lo, hi): the query positions that see any key of [j0, j0 + nj)
__host__ __device__ __forceinline__ void query_range(int j0, int nj, int sq, int causal,
                                                     int window, int& lo, int& hi) {
  lo = causal ? j0 : 0;
  hi = window > 0 ? min(sq, j0 + nj - 1 + window) : sq;
}

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }

// n rows of a (rows, heads, hd) layout from element offset `first` with
// row stride `stride`, into rows of ld values (zeros past hd, up to width,
// and past n, up to `rows`), by kN threads: 16-byte cp.async (4 floats or
// 8 bf16 a copy) when the rows are aligned, else plain loads.
template <int kN, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long first,
                                          long long stride, int hd, int width, int n, int rows,
                                          int ld, bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  const int nv = width / kPer;
  if (vec) {
    for (int i = threadIdx.x; i < rows * nv; i += kN) {
      const int r = i / nv, c = (i - r * nv) * kPer;
      const bool ok = r < n && c < hd;
      cp_async16(dst + r * ld + c, ok ? src + first + r * stride + c : src, ok ? 16 : 0);
    }
  } else {
    const T zero = zero_value<T>();
    for (int i = threadIdx.x; i < rows * width; i += kN) {
      const int r = i / width, c = i - r * width;
      dst[r * ld + c] = r < n && c < hd ? src[first + r * stride + c] : zero;
    }
  }
}

}  // namespace
