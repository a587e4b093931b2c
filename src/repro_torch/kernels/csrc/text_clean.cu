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
// [r * width, (r + 1) * width), the matrix case.
//
// What bounds it: each byte is read once and written once (4 MB for a
// 4096 x 512 matrix, ~88 MB for a 64 MB corpus's abstract column), so the
// bound is memory: 26 us for the abstract column on an H100. At that rate
// the SMs' integer units leave about ten operations a byte.
//
// Design (byte_scan.cuh): blocks split the buffer by bytes at row starts
// and walk their share in tiles of 8,192 bytes, 32 a thread in two
// 16-byte accesses. Per word of four bytes, by lane arithmetic: '<' and
// '>' are one masked test and the running depth inside the word one
// multiply; w | 0x20 lowers A-Z and leaves bit 5 set in every byte, so a
// letter test on it finds a-z and A-Z at once and a space is what remains
// of a non-letter after an and. One segmented block scan a tile carries
// the depth across threads, rows and tiles. Without strip_html there is
// no scan.

#include "byte_scan.cuh"

namespace {

using namespace byte_scan;

constexpr int kVecs = 2;  // 16-byte words a thread holds in a tile
constexpr int kWords = 4 * kVecs;

template <bool kHtml>
struct CleanTile {
  int* warp_total;
  int carry = 0;  // the depth at the end of the previous tile

  __device__ void operator()(uint32_t (&w)[kWords], uint64_t starts, bool active) {
    uint32_t v[kWords];
    int depth = 0;
    if (kHtml) {
      int pair = 0;
      if (active) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {  // on the raw bytes: 0x1c | 0x20 would pass for '<'
          const uint32_t angle = lanes_pair(w[k], 0x7d, 0x3c);
          v[k] = lane_sums(angle, angle & (w[k] << 6));  // bit 1 tells '>' from '<'
        }
        pair = thread_pair(v, starts);
      }
      int total;
      depth = depth_from(seg_exclusive(pair, warp_total, total), carry);
      carry = depth_from(total, carry);
    }
    if (!active) return;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t y = w[k] | 0x20202020u;
      uint32_t keep = lanes_in(y, 'a', 'z');
      // a letter is neither '<' nor '>', so its depth is the depth before it
      if (kHtml) keep &= lanes_depth<true>(v[k], word_bits(starts, k), depth);
      w[k] = y & ((keep >> 7) * 0xdfu | 0x20202020u);
    }
  }
};

template <bool kAligned, bool kHtml>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
text_clean_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  const int64_t* __restrict__ offsets, int64_t n_rows, int64_t width, Div div) {
  __shared__ int warp_total[kWarps];
  CleanTile<kHtml> tile{warp_total};
  walk<kVecs, kAligned, kHtml>(in, out, offsets, n_rows, width, div, tile);
}

template <bool kAligned, bool kHtml>
void launch(const void* in, void* out, const void* offsets, int n_rows, int64_t width,
            cudaStream_t stream) {
  const int blocks = grid_blocks(n_rows);
  text_clean_kernel<kAligned, kHtml><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(offsets), n_rows, width, reciprocals(blocks, width));
}

}  // namespace

// offsets: int64 (n_rows + 1) row bounds, or null for rows of `width` bytes.
extern "C" int text_clean(const void* in, void* out, const void* offsets, int n_rows,
                          long long width, int strip_html, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(in, out);
  if (aligned && strip_html) launch<true, true>(in, out, offsets, n_rows, width, s);
  else if (aligned) launch<true, false>(in, out, offsets, n_rows, width, s);
  else if (strip_html) launch<false, true>(in, out, offsets, n_rows, width, s);
  else launch<false, false>(in, out, offsets, n_rows, width, s);
  return static_cast<int>(cudaGetLastError());
}
