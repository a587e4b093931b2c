// Cleaning scan pass for Hopper (sm_90a): lowercase + <...> span + (...) span.
//
// Replaces the TPU kernel src/repro/kernels/text_clean/text_clean.py:_scan_kernel
// (pl.pallas_call at :121). Byte for byte, per row:
//   * optional A-Z -> a-z;
//   * <...> span: depth is the row-local running sum of (<) - (>); a byte
//     survives if depth <= 0, and every '>' dies;
//   * (...) span: the same with ( and ), counting only bytes the HTML span
//     left alive; every live ')' dies;
//   * removed bytes become 0.
//
// The TPU kernel works on a (rows, width) matrix padded to 128 lanes. Here
// the input is the flat buffer itself and rows are given by offsets
// (row r is bytes [offsets[r], offsets[r + 1])), so there is no padding
// traffic and no row is ever declined.
//
// What bounds it: it reads and writes each byte once (about 2 x 64 x 1.2 KB
// for one served batch of abstracts), far under a microsecond of memory
// time on an H100, so it is bound by launch latency and by the serial walk
// along a row.
//
// Design: one block of 256 threads per row walks the row in tiles of 1024
// bytes (4 consecutive bytes per thread). In each tile a block-wide
// inclusive prefix sum (cub::BlockScan) of the <,> deltas plus the running
// carry of earlier tiles gives the HTML depth; a second prefix sum of the
// (,) deltas of HTML-alive bytes gives the paren depth. Zero bytes past the
// row end add nothing to either sum.

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
text_scan_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 const int64_t* __restrict__ offsets, int lower, int strip_html,
                 int strip_parens) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scratch;
  const int64_t begin = offsets[blockIdx.x];
  const int64_t end = offsets[blockIdx.x + 1];
  int html_carry = 0;
  int paren_carry = 0;
  for (int64_t base = begin; base < end; base += kTile) {
    int v[kItems];
    bool alive[kItems];
    int d[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t pos = base + threadIdx.x * kItems + i;
      int byte = pos < end ? in[pos] : 0;
      if (lower && byte >= 'A' && byte <= 'Z') byte += 32;
      v[i] = byte;
      alive[i] = true;
    }
    if (strip_html) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) d[i] = (v[i] == '<') - (v[i] == '>');
      int total;
      Scan(scratch).InclusiveSum(d, d, total);
#pragma unroll
      for (int i = 0; i < kItems; ++i) alive[i] = (html_carry + d[i] <= 0) && v[i] != '>';
      html_carry += total;
      __syncthreads();  // scratch is reused by the next scan
    }
    if (strip_parens) {
      bool close[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        close[i] = alive[i] && v[i] == ')';
        d[i] = (alive[i] && v[i] == '(') - close[i];
      }
      int total;
      Scan(scratch).InclusiveSum(d, d, total);
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        alive[i] = alive[i] && (paren_carry + d[i] <= 0) && !close[i];
      paren_carry += total;
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t pos = base + threadIdx.x * kItems + i;
      if (pos < end) out[pos] = alive[i] ? static_cast<uint8_t>(v[i]) : 0;
    }
  }
}

}  // namespace

extern "C" int text_scan(const void* in, void* out, const void* offsets, int n_rows,
                         int lower, int strip_html, int strip_parens, void* stream) {
  text_scan_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(offsets), lower, strip_html, strip_parens);
  return static_cast<int>(cudaGetLastError());
}
