// Tiled, row-aligned byte scans for Hopper (sm_90a): the machinery that
// text_clean.cu and text_scan.cu share.
//
// The input is a flat byte buffer of N bytes whose row r is bytes
// [offsets[r], offsets[r + 1]), or, with offsets == nullptr, rows of
// `width` bytes. Each kernel keeps a running sum per row (the depth of a
// <...> or (...) span), which restarts at every row start and never comes
// from the bytes: a NUL inside a row is a byte like any other.
//
// Work split: by bytes, not by rows. Block b of G takes the rows that
// start in [b * N / G, (b + 1) * N / G), so every block begins at a row
// start, no sum crosses a block, and a launch needs no look-back, no
// workspace and no second pass. A row longer than N / G falls to one block,
// which walks it tile by tile with a carry. The split is found on the
// card: the block's 256 threads test 256 candidate offsets at once, so a
// search over 41,459 rows takes two rounds of one load each (both bounds
// of the block at once). Divisions by G and by the row width are
// multiplications by reciprocals that the host computes (Div).
//
// Each block walks its range in tiles of 256 threads x 16 * kVecs bytes,
// a thread's bytes consecutive and read and written as kVecs 16-byte words
// where a word lies wholly inside the block's range (byte by byte at the
// range's two ends, so no thread ever writes another block's bytes; byte
// by byte throughout in the instance for buffers that are not 16-byte
// aligned). The row starts that fall in a tile are marked in a
// shared-memory byte map from a window of 256 offsets, one a thread; a
// segmented block scan of (row start seen, sum) pairs, warp shuffles and
// one barrier, gives each thread the depth before its bytes; the thread
// keeps its row starts as a bit mask. The next tile is copied into shared
// memory by cp.async while this one is worked. Byte tests run four bytes
// a 32-bit word with carry-free lane arithmetic on 7-bit values; the
// running sum inside a word is one multiply by 0x01010101. No atomics:
// two launches give identical bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace byte_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr uint32_t kOnes = 0x01010101u;
constexpr uint32_t kHigh = 0x80808080u;

// Blocks of a launch over n_rows rows: kBlocksPerSm a multiprocessor, at
// most one a row.
inline int grid_blocks(int n_rows) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n_rows < kBlocksPerSm * sms ? n_rows : kBlocksPerSm * sms;
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// Reciprocals of the launch's divisors: floor((2^64 - 1) / d), 0 for d 0.
struct Div {
  uint64_t blocks, width;
};

inline Div reciprocals(int blocks, int64_t width) {
  return {~0ull / static_cast<uint64_t>(blocks),
          width > 0 ? ~0ull / static_cast<uint64_t>(width) : 0ull};
}

// ---- lane arithmetic: four bytes of a word, a result in bit 7 of each lane

// Lanes whose byte lies in [lo, hi] (1 <= lo <= hi <= 0x7f); never a byte >= 0x80.
__device__ __forceinline__ uint32_t lanes_in(uint32_t w, uint32_t lo, uint32_t hi) {
  const uint32_t y = w & 0x7f7f7f7fu;
  const uint32_t ge = y + (0x80u - lo) * kOnes;  // bit 7 set iff y >= lo
  const uint32_t gt = y + (0x7fu - hi) * kOnes;  // bit 7 set iff y > hi
  return ge & ~gt & ~w & kHigh;
}

// Lanes whose byte is one of a pair of delimiters that differ in one bit:
// byte & mask == c (c < 0x80, mask < 0x80), so never a byte >= 0x80.
// '<' and '>': mask 0x7d, c 0x3c; '(' and ')': mask 0x7e, c 0x28.
__device__ __forceinline__ uint32_t lanes_pair(uint32_t w, uint32_t mask, uint32_t c) {
  const uint32_t z = (w & (mask * kOnes)) ^ (c * kOnes);
  return ~(z + 0x7f7f7f7fu) & ~w & kHigh;
}

// Lanes with a <= b, and with a == b, for lanes of 0..0x7f.
__device__ __forceinline__ uint32_t lanes_le(uint32_t a, uint32_t b) {
  return ((b | kHigh) - a) & kHigh;
}
__device__ __forceinline__ uint32_t lanes_eq(uint32_t a, uint32_t b) {
  return ~((a ^ b) + 0x7f7f7f7fu) & kHigh;
}

// A-Z -> a-z.
__device__ __forceinline__ uint32_t lower4(uint32_t w) {
  return w | (lanes_in(w, 'A', 'Z') >> 2);
}

// 0xff in every byte whose lane has bit 7 set, 0 elsewhere.
__device__ __forceinline__ uint32_t widen(uint32_t lanes) { return (lanes >> 7) * 0xffu; }

// ---- the depth: a running sum of +1 at openers and -1 at closers

// The word's running sums: `delim` has the openers' and closers' lanes,
// `close` the closers'. Lane k of the result is 5 + k + (the sum over
// lanes 0..k), 4..12; the word's sum is (v >> 24) - 8.
__device__ __forceinline__ uint32_t lane_sums(uint32_t delim, uint32_t close) {
  const uint32_t e = kOnes + (delim >> 7) - (close >> 6);  // 2 opener, 0 closer, else 1
  return e * kOnes + 0x04040404u;
}

__device__ __forceinline__ int word_sum(uint32_t v) { return static_cast<int>(v >> 24) - 8; }

// Lanes where the running sum, from `depth` before the word, is == 0
// (kEq) or <= 0; `depth` leaves as the sum after the word. Bit j of
// `starts` marks a row start at lane j, where the sum restarts.
template <bool kEq>
__device__ __forceinline__ uint32_t lanes_depth(uint32_t v, uint32_t starts, int& depth) {
  if (starts) {  // a row starts inside the word: lane by lane
    const uint32_t e = v - (v << 8) - 4u;  // the lanes' 1 + delta
    uint32_t r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((starts >> j) & 1) depth = 0;
      depth += static_cast<int>((e >> (8 * j)) & 0xff) - 1;
      if (kEq ? depth == 0 : depth <= 0) r |= 0x80u << (8 * j);
    }
    return r;
  }
  // lane k holds depth + sum iff v_k == 5 + k - depth; |depth| >= 5 never
  // reaches 0 inside a word, so it is clamped to +-5
  const int c = min(max(depth, -5), 5);
  const uint32_t t = 0x0d0c0b0au - static_cast<uint32_t>(c + 5) * kOnes;
  depth += word_sum(v);
  return kEq ? lanes_eq(v, t) : lanes_le(v, t);
}

// ---- the segmented block scan of (row start seen, sum) pairs, packed as
// 2 * sum + seen; the operator is associative and 0 is its identity.

__device__ __forceinline__ int seg_combine(int a, int b) { return (b & 1) ? b : a + b; }

// A thread's pair from its words' running sums: the sum of the words, or,
// where a row starts among them (bit 4k + j of `starts`: word k, lane j),
// the sum from the last row start on.
template <int kWords>
__device__ __forceinline__ int thread_pair(const uint32_t (&v)[kWords], uint64_t starts) {
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) sum += word_sum(v[k]);
  if (!starts) return 2 * sum;
  const int last = 63 - __clzll(starts), at = last >> 2, j = last & 3;
  int after = 0;
  uint32_t v_at = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (k > at) after += word_sum(v[k]);
    if (k == at) v_at = v[k];
  }
  const int before = j ? static_cast<int>((v_at >> (8 * j - 8)) & 0xff) - 4 - j : 0;
  return 2 * (after + word_sum(v_at) - before) + 1;
}

// The sum before the thread's bytes (from its exclusive pair and the carry
// of earlier tiles); the same of the tile's total gives the next carry.
__device__ __forceinline__ int depth_from(int pair, int carry) {
  return (pair & 1) ? (pair >> 1) : carry + (pair >> 1);
}

// Exclusive scan of the threads' pairs over the block -> this thread's
// pair before its bytes; `total` gets the tile's pair. One barrier;
// `warp_total` (kWarps ints) must not be written again before the next.
__device__ __forceinline__ int seg_exclusive(int pair, int* warp_total, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = seg_combine(up, inc);
  }
  if (lane == 31) warp_total[warp] = inc;
  int ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i == warp) before = total;
    total = seg_combine(total, warp_total[i]);
  }
  return seg_combine(before, ex);
}

// ---- the split

// a / b for 0 <= a < 2^63, b > 0, from inv = floor((2^64 - 1) / b): the
// high half of a * inv is at most two below the quotient, never above.
__device__ __forceinline__ int64_t quot(int64_t a, int64_t b, uint64_t inv) {
  int64_t q = static_cast<int64_t>(__umul64hi(static_cast<uint64_t>(a), inv));
  while ((q + 1) * b <= a) ++q;
  return q;
}

__device__ __forceinline__ int64_t row_start(const int64_t* offsets, int64_t width, int64_t r) {
  return offsets ? __ldg(offsets + r) : r * width;
}

struct Range {
  int64_t begin, end;    // bytes [begin, end) of the buffer
  int64_t row, row_end;  // the rows that start there
};

// This block's rows: those that start in [b * N / G, (b + 1) * N / G).
// For each bound t, the first row r in [0, n_rows] with start >= t, by a
// 256-ary search over the offsets. Ends in a barrier. `found` holds 2 x
// kThreads offsets.
__device__ inline Range block_range(const int64_t* offsets, int64_t n_rows, int64_t width,
                                    const Div& div, int64_t* found) {
  const int64_t blocks = gridDim.x, b = blockIdx.x;
  if (!offsets) {
    const int64_t n = n_rows * width;
    const int64_t r0 = quot(quot(b * n, blocks, div.blocks) + width - 1, width, div.width);
    const int64_t r1 = quot(quot((b + 1) * n, blocks, div.blocks) + width - 1, width, div.width);
    __syncthreads();
    return {r0 * width, r1 * width, r0, r1};
  }
  const int64_t n = __ldg(offsets + n_rows);
  const int64_t t[2] = {quot(b * n, blocks, div.blocks), quot((b + 1) * n, blocks, div.blocks)};
  // the answer lies in (lo, hi]; start(hi) >= t, start(lo) < t or lo == -1
  int64_t lo[2] = {-1, -1}, hi[2] = {n_rows, n_rows}, at_hi[2] = {n, n};
  while (hi[0] - lo[0] > 1 || hi[1] - lo[1] > 1) {  // uniform across the block
    int64_t step[2], v[2];
    bool ok[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // both bounds' loads in flight at once
      step[s] = (hi[s] - lo[s] - 1 + kThreads - 1) / kThreads;
      const int64_t p = lo[s] + 1 + threadIdx.x * step[s];
      ok[s] = p < hi[s];
      v[s] = ok[s] ? __ldg(offsets + p) : 0;
    }
    int c[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (ok[s]) found[s * kThreads + threadIdx.x] = v[s];
      c[s] = __syncthreads_count(ok[s] && v[s] < t[s]);  // a prefix of the threads
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (step[s] == 0) continue;  // this bound is found
      const int64_t p_c = lo[s] + 1 + c[s] * step[s];
      if (p_c < hi[s]) {
        hi[s] = p_c;
        at_hi[s] = found[s * kThreads + c[s]];
      }
      if (c[s] > 0) lo[s] += 1 + (c[s] - 1) * step[s];
    }
  }
  return {at_hi[0], at_hi[1], hi[0], hi[1]};
}

// The row starts of the block, 256 at a time, one a thread.
template <int kTile>
struct RowStarts {
  const int64_t* offsets;
  int64_t width, next, row_end, mine;

  __device__ RowStarts(const int64_t* offsets_, int64_t width_, const Range& r)
      : offsets(offsets_), width(width_), next(r.row), row_end(r.row_end) {
    load();
  }

  __device__ void load() {
    const int64_t r = next + threadIdx.x;
    mine = r < row_end ? row_start(offsets, width, r) : INT64_MAX;
  }

  // Sets map[p - base] = 1 for each row start p in [base, base + kTile).
  // Ends in a barrier, after which the map is complete.
  __device__ void mark(int64_t base, uint8_t* map) {
    for (;;) {
      if (mine >= base && mine < base + kTile) map[mine - base] = 1;
      if (!__syncthreads_and(mine < base + kTile)) return;
      next += kThreads;
      load();
    }
  }
};

// ---- the thread's bytes: kVecs 16-byte words at pos

// The 16 bytes at p0 one by one, 0 outside the range: no delimiter, no letter.
__device__ __forceinline__ void bytes16(uint32_t* w, const uint8_t* in, int64_t p0,
                                        const Range& r) {
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = 0;
  if (p0 >= r.end || p0 + 16 <= r.begin) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int64_t p = p0 + j;
    if (p >= r.begin && p < r.end) w[j / 4] |= static_cast<uint32_t>(in[p]) << (8 * (j % 4));
  }
}

template <int kVecs>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[4 * kVecs], const uint8_t* in,
                                           int64_t pos, const Range& r) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) bytes16(w + 4 * i, in, pos + 16 * i, r);
}

template <bool kAligned, int kVecs>
__device__ __forceinline__ void store_bytes(uint8_t* out, int64_t pos,
                                            const uint32_t (&w)[4 * kVecs], const Range& r) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int64_t p0 = pos + 16 * i;
    if (kAligned && p0 >= r.begin && p0 + 16 <= r.end) {
      *reinterpret_cast<uint4*>(out + p0) =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
      continue;
    }
    if (p0 >= r.end || p0 + 16 <= r.begin) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int64_t p = p0 + j;
      if (p >= r.begin && p < r.end) out[p] = static_cast<uint8_t>(w[4 * i + j / 4] >> (8 * (j % 4)));
    }
  }
}

// ---- the next tile, staged in shared memory by cp.async

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until every group but the newest has landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies the thread's 16-byte words at pos that lie wholly inside the
// range into its stage slots (16-byte aligned buffer).
template <int kVecs>
__device__ __forceinline__ void stage_fetch(uint4* slot, const uint8_t* in, int64_t pos,
                                            const Range& r) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int64_t p0 = pos + 16 * i;
    if (p0 >= r.begin && p0 + 16 <= r.end) cp_async16(slot + i, in + p0);
  }
}

// The thread's words at pos: staged words from the slots, the range's
// edge words byte by byte, 0 outside the range.
template <int kVecs>
__device__ __forceinline__ void stage_take(uint32_t (&w)[4 * kVecs], const uint4* slot,
                                           const uint8_t* in, int64_t pos, const Range& r) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int64_t p0 = pos + 16 * i;
    if (p0 >= r.begin && p0 + 16 <= r.end) {
      const uint4 q = slot[i];
      w[4 * i] = q.x, w[4 * i + 1] = q.y, w[4 * i + 2] = q.z, w[4 * i + 3] = q.w;
    } else {
      bytes16(w + 4 * i, in, p0, r);
    }
  }
}

// ---- the walk

// Bit 4k + j set where byte j of word k is 1: the thread's row starts from
// its bytes of the map (0 or 1 each).
template <int kWords>
__device__ __forceinline__ uint64_t start_bits(const uint32_t (&bytes)[kWords]) {
  uint64_t bits = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    bits |= static_cast<uint64_t>((bytes[k] * 0x01020408u) >> 24) << (4 * k);
  return bits;
}

// The 4 bits of word k.
__device__ __forceinline__ uint32_t word_bits(uint64_t bits, int k) {
  return static_cast<uint32_t>(bits >> (4 * k)) & 0xf;
}

// Walks this block's range in tiles of kThreads x 16 * kVecs bytes. For
// each tile, `tile(w, starts, active)` turns the thread's 4 * kVecs words
// into output in place (every thread calls it, so it may run block scans);
// `starts` has bit 4k + j set where a row starts at byte j of word k (0
// unless kStarts), and `active` is false for a thread with no byte in the
// range. The next tile's words are on their way (cp.async into shared
// memory; the unaligned instance loads byte by byte) while this one is
// worked.
template <int kVecs, bool kAligned, bool kStarts, class Tile>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                     const int64_t* __restrict__ offsets, int64_t n_rows,
                                     int64_t width, const Div& div, Tile& tile) {
  constexpr int kWords = 4 * kVecs, kBytes = 16 * kVecs, kTile = kThreads * kBytes;
  static_assert(kWords <= 16, "4 bits a word in a 64-bit mask");
  __shared__ __align__(16) uint8_t map[kTile];
  __shared__ int64_t found[2 * kThreads];
  __shared__ uint4 stage[kAligned ? 2 * kThreads * kVecs : 1];  // two tiles: this, the next
  uint4* const my_map = reinterpret_cast<uint4*>(map) + threadIdx.x * kVecs;
  uint4* const my_stage = stage + threadIdx.x * kVecs;
  if (kStarts) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) my_map[i] = make_uint4(0, 0, 0, 0);
  }
  const Range r = block_range(offsets, n_rows, width, div, found);
  if (r.begin >= r.end) return;  // uniform: no row starts in this block's share
  RowStarts<kTile> starts(offsets, width, r);
  const int64_t first = r.begin & ~static_cast<int64_t>(15);
  int64_t pos = first + threadIdx.x * kBytes;
  constexpr int kHalf = kThreads * kVecs;  // uint4s of one tile in the stage
  int half = 0;                            // this tile's half of the stage
  if (kAligned) stage_fetch<kVecs>(my_stage, in, pos, r);
  cp_async_commit();
  for (int64_t base = first; base < r.end; base += kTile, pos += kTile, half ^= 1) {
    if (kAligned && base + kTile < r.end)
      stage_fetch<kVecs>(my_stage + (half ^ 1) * kHalf, in, pos + kTile, r);
    cp_async_commit();
    uint64_t bits = 0;
    if (kStarts) {
      starts.mark(base, map);
      uint32_t s[kWords];
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {  // read before the tile's scan barrier, cleared for
        const uint4 f = my_map[i];        // the next tile, whose marks come after it
        s[4 * i] = f.x, s[4 * i + 1] = f.y, s[4 * i + 2] = f.z, s[4 * i + 3] = f.w;
        my_map[i] = make_uint4(0, 0, 0, 0);
      }
      bits = start_bits(s);
    }
    uint32_t w[kWords];
    cp_async_wait_prior();  // this tile's words have landed
    if (kAligned) stage_take<kVecs>(w, my_stage + half * kHalf, in, pos, r);
    else load_bytes<kVecs>(w, in, pos, r);
    tile(w, bits, pos < r.end && pos + kBytes > r.begin);
    store_bytes<kAligned, kVecs>(out, pos, w, r);
  }
}

}  // namespace byte_scan
