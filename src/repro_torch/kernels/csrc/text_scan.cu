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
// What bounds it: it reads and writes each byte once (about 2 x 64 x 1 KB
// for one served batch of abstracts), far under a microsecond of memory
// time on an H100, so it is bound by launch latency and the chain of
// dependent steps inside a launch: the split's search, the loads, and two
// block scans.
//
// Design (byte_scan.cuh): blocks split the buffer by bytes at row starts
// (a served batch of 64 rows: 64 blocks, one 4,096-byte tile each, the
// split found in one round), 16 bytes a thread in one 16-byte access.
// Per tile: the '<'/'>' lanes by one masked test, the running depth inside
// each word by one multiply, a segmented block scan for the depth before
// each thread's bytes and the alive lanes; then the '('/')' lanes of alive
// bytes and a second scan; removed lanes masked to 0.

#include "byte_scan.cuh"

namespace {

using namespace byte_scan;

constexpr int kVecs = 1;  // 16-byte words a thread holds in a tile
constexpr int kWords = 4 * kVecs;

// The alive lanes after one span: delimiters `delim` (openers and closers,
// closers in `closer`) counted where alive; a byte survives where the
// running depth is <= 0, and every closer dies.
__device__ __forceinline__ void span(const uint32_t (&delim)[kWords],
                                     const uint32_t (&closer)[kWords],
                                     uint64_t starts, int* warp_total,
                                     int& carry, uint32_t (&alive)[kWords]) {
  uint32_t v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) v[k] = lane_sums(delim[k], closer[k]);
  int total;
  int depth = depth_from(seg_exclusive(thread_pair(v, starts), warp_total, total), carry);
  carry = depth_from(total, carry);
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    alive[k] &= lanes_depth<false>(v[k], word_bits(starts, k), depth) & ~closer[k];
}

template <bool kHtml, bool kParens>
struct ScanTile {
  int* warp_total;  // 2 x kWarps: one half for each span
  int lower;
  int html_carry = 0, paren_carry = 0;  // the depths at the end of the previous tile

  // A thread with no byte in the range works on zeros: they hold no delimiter.
  __device__ void operator()(uint32_t (&w)[kWords], uint64_t starts, bool) {
    uint32_t alive[kWords], delim[kWords], closer[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if (lower) w[k] = lower4(w[k]);
      alive[k] = kHigh;
    }
    if (kHtml) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        delim[k] = lanes_pair(w[k], 0x7d, 0x3c);  // '<' or '>'
        closer[k] = delim[k] & (w[k] << 6);        // bit 1: '>'
      }
      span(delim, closer, starts, warp_total, html_carry, alive);
    }
    if (kParens) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        delim[k] = lanes_pair(w[k], 0x7e, 0x28) & alive[k];  // live '(' or ')'
        closer[k] = delim[k] & (w[k] << 7);                   // bit 0: ')'
      }
      span(delim, closer, starts, warp_total + kWarps, paren_carry, alive);
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] &= widen(alive[k]);
  }
};

template <bool kAligned, bool kHtml, bool kParens>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
text_scan_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 const int64_t* __restrict__ offsets, int64_t n_rows, int lower, Div div) {
  __shared__ int warp_total[2 * kWarps];
  ScanTile<kHtml, kParens> tile{warp_total, lower};
  walk<kVecs, kAligned, kHtml || kParens>(in, out, offsets, n_rows, 0, div, tile);
}

template <bool kAligned, bool kHtml, bool kParens>
void launch(const void* in, void* out, const void* offsets, int n_rows, int lower,
            cudaStream_t stream) {
  const int blocks = grid_blocks(n_rows);
  text_scan_kernel<kAligned, kHtml, kParens><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(offsets), n_rows, lower, reciprocals(blocks, 0));
}

template <bool kAligned>
void launch_spans(const void* in, void* out, const void* offsets, int n_rows, int lower,
                  int strip_html, int strip_parens, cudaStream_t stream) {
  if (strip_html && strip_parens) launch<kAligned, true, true>(in, out, offsets, n_rows, lower, stream);
  else if (strip_html) launch<kAligned, true, false>(in, out, offsets, n_rows, lower, stream);
  else if (strip_parens) launch<kAligned, false, true>(in, out, offsets, n_rows, lower, stream);
  else launch<kAligned, false, false>(in, out, offsets, n_rows, lower, stream);
}

}  // namespace

extern "C" int text_scan(const void* in, void* out, const void* offsets, int n_rows,
                         int lower, int strip_html, int strip_parens, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned16(in, out))
    launch_spans<true>(in, out, offsets, n_rows, lower, strip_html, strip_parens, s);
  else
    launch_spans<false>(in, out, offsets, n_rows, lower, strip_html, strip_parens, s);
  return static_cast<int>(cudaGetLastError());
}
