// Character cleaning for Hopper (sm_90a): lowercase, <...> span, letters only.
//
// Replaces the TPU kernel src/repro/kernels/text_clean/text_clean.py:_clean_kernel
// (pl.pallas_call at :64), the character half of the on-accelerator cleaning
// engine (DeviceCleaner). Byte for byte, per row:
//   * A-Z -> a-z;
//   * with strip_html, depth is the row-local running sum of (<) - (>); a
//     byte is kept only where depth == 0 and it is not '>'. The test is
//     == 0, not the scan pass's <= 0: after a stray '>' the depth stays
//     negative and nothing is kept until a '<' brings it back to 0;
//   * every byte that is not a kept a-z byte becomes a space (32), NUL and
//     bytes above 127 included.
//
// The TPU kernel takes a (rows, width) matrix padded with spaces. Here a row
// is bytes [offsets[r], offsets[r + 1]) of a flat buffer, so a column of
// strings is cleaned without padding; with offsets == nullptr row r is bytes
// [r * width, (r + 1) * width), the matrix case. Row boundaries never come
// from the bytes: a NUL inside a row is a byte like any other.
//
// What bounds it: each byte is read once and written once (4 MB for a
// 4096 x 512 matrix, ~100 MB for a 64 MB corpus's abstract column), so the
// bound is memory; at these sizes launch latency and the walk along a row
// come first.
//
// Design: one block of 256 threads per row walks the row in tiles of 1024
// bytes (4 consecutive bytes per thread). In each tile one block-wide
// inclusive prefix sum (cub::BlockScan) of the <,> deltas plus the carry of
// earlier tiles gives the depth. Bytes past the row end add 0 to the sum.

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
text_clean_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  const int64_t* __restrict__ offsets, int64_t width, int strip_html) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scratch;
  const int64_t row = blockIdx.x;
  const int64_t begin = offsets ? offsets[row] : row * width;
  const int64_t end = offsets ? offsets[row + 1] : begin + width;
  int carry = 0;
  for (int64_t base = begin; base < end; base += kTile) {
    int v[kItems];
    int d[kItems];
    bool keep[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t pos = base + threadIdx.x * kItems + i;
      int byte = pos < end ? in[pos] : 0;
      if (byte >= 'A' && byte <= 'Z') byte += 32;
      v[i] = byte;
      d[i] = (byte == '<') - (byte == '>');
      keep[i] = true;
    }
    if (strip_html) {  // uniform across the block: every thread reaches the scan
      int total;
      Scan(scratch).InclusiveSum(d, d, total);
#pragma unroll
      for (int i = 0; i < kItems; ++i) keep[i] = carry + d[i] == 0 && v[i] != '>';
      carry += total;
      __syncthreads();  // scratch is reused by the next tile's scan
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t pos = base + threadIdx.x * kItems + i;
      if (pos < end)
        out[pos] = keep[i] && v[i] >= 'a' && v[i] <= 'z' ? static_cast<uint8_t>(v[i]) : ' ';
    }
  }
}

}  // namespace

// offsets: int64 (n_rows + 1) row bounds, or null for rows of `width` bytes.
extern "C" int text_clean(const void* in, void* out, const void* offsets, int n_rows,
                          long long width, int strip_html, void* stream) {
  text_clean_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(offsets), static_cast<int64_t>(width), strip_html);
  return static_cast<int>(cudaGetLastError());
}
