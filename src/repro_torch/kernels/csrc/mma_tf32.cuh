// fp32 products on Hopper's tensor cores (mma.sync m16n8k8, TF32) with the
// error-compensated split, and the 16-byte cp.async copies that feed them.
// Shared by flash_attention_bwd.cu, flash_attention_train.cu and
// mlstm_chunk_train.cu.
//
// Each fp32 operand a is hi = tf32(a) and lo = tf32(a - hi), and
// a b = hi hi' + hi lo' + lo hi' in fp32 (the dropped lo lo' is about 2^-22
// of the product). Each k-step's three products go into a fresh tile,
// added to the running sum in a rounded fp32 add: the tensor cores truncate
// their own fp32 sums, which biases a long chain of mma's toward zero. So
// the products keep fp32's 2e-5 parity with the plain versions
// (kernels/tf32.py emulates the split on the CPU).
//
// The inline assembly lives in small named helpers (cp_async16,
// cp_async_commit, cp_async_wait_one, cp_async_wait_all, mma_tf32), so a
// host build can stand in for each by name.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x rounded to TF32's 10-bit mantissa, to nearest with ties away from zero,
// in two integer operations on the bits: the same bits as cvt.rna.tf32.f32
// for every finite input (whose conversion costs more on this card)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a b for one m16n8k8 TF32 tile, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 8, row m, column k) and B fragment (8 x 8, row k, column
// n), each split into its TF32 high part and the TF32 rounding of the rest.
// Lane l holds A at (l/4, l%4), (l/4 + 8, l%4), (l/4, l%4 + 4), (l/4 + 8,
// l%4 + 4) and B at (l%4, l/4), (l%4 + 4, l/4); C at (l/4, 2 (l%4)), (l/4,
// 2 (l%4) + 1), (l/4 + 8, 2 (l%4)), (l/4 + 8, 2 (l%4) + 1).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A from a row-major array: element (m, k) at p[m * ld + k]
__device__ __forceinline__ FragA frag_a(const float* p, int ld, int g, int t) {
  FragA f;
  split(p[g * ld + t], f.hi[0], f.lo[0]);
  split(p[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split(p[g * ld + t + 4], f.hi[2], f.lo[2]);
  split(p[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  return f;
}
// A from a column-major array: element (m, k) at p[k * ld + m]
__device__ __forceinline__ FragA frag_a_t(const float* p, int ld, int g, int t) {
  FragA f;
  split(p[t * ld + g], f.hi[0], f.lo[0]);
  split(p[t * ld + g + 8], f.hi[1], f.lo[1]);
  split(p[(t + 4) * ld + g], f.hi[2], f.lo[2]);
  split(p[(t + 4) * ld + g + 8], f.hi[3], f.lo[3]);
  return f;
}
// B with element (k, n) at p[n * ld + k] (B = X^T of a row-major X)
__device__ __forceinline__ FragB frag_b_t(const float* p, int ld, int g, int t) {
  FragB f;
  split(p[g * ld + t], f.hi[0], f.lo[0]);
  split(p[g * ld + t + 4], f.hi[1], f.lo[1]);
  return f;
}
// B with element (k, n) at p[k * ld + n] (a row-major B)
__device__ __forceinline__ FragB frag_b(const float* p, int ld, int g, int t) {
  FragB f;
  split(p[t * ld + g], f.hi[0], f.lo[0]);
  split(p[(t + 4) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// The k index of a tile taken in pairs: lane l's k = l%4 and l%4 + 4 stand
// for columns 2 (l%4) and 2 (l%4) + 1 of the 8. A product sums over k, so
// the order is free as long as A and B agree; in this order an
// accumulator's columns (the C layout above) are an A fragment as they lie
// in the lane's registers, and a lane reads two neighbouring columns.
//
// A from the C layout of an accumulator tile: c[0..3] at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ FragA frag_a_acc(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}
// B with element (k, n) at p[k * ld + n], k taken in pairs
__device__ __forceinline__ FragB frag_b_pairs(const float* p, int ld, int g, int t) {
  FragB f;
  split(p[2 * t * ld + g], f.hi[0], f.lo[0]);
  split(p[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
  return f;
}

// d += a b in 3xTF32, the small terms first, into a fresh tile that is
// added to d in a rounded fp32 add (at hd 256 with 16 query heads on one
// kv head, a chain summed by the tensor cores themselves missed flash's
// plain dK by 1.1e-4 of values near 10).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, a.lo, b.hi);
  mma_tf32(t, a.hi, b.lo);
  mma_tf32(t, a.hi, b.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// d[i] += a b[i] for the first N tiles of d, which share A, in 3xTF32 as
// mma3: the three products of every tile issued in turn, so the tiles'
// chains overlap on the tensor cores instead of each waiting out its own
// latency.
template <int N, int M>
__device__ __forceinline__ void mma3_n(float (&d)[M][4], const FragA& a, const FragB (&b)[N]) {
  static_assert(N <= M, "more B tiles than accumulators");
  float t[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) t[i][e] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], a.hi, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] += t[i][e];
  }
}

// d[i] += a[i] b for M tiles that share B, in 3xTF32 as mma3_n
template <int M>
__device__ __forceinline__ void mma3_m(float (&d)[M][4], const FragA (&a)[M], const FragB& b) {
  float t[M][4];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) t[i][e] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) mma_tf32(t[i], a[i].lo, b.hi);
#pragma unroll
  for (int i = 0; i < M; ++i) mma_tf32(t[i], a[i].hi, b.lo);
#pragma unroll
  for (int i = 0; i < M; ++i) mma_tf32(t[i], a[i].hi, b.hi);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] += t[i][e];
  }
}

// A from a row-major array, k taken in pairs: (m, 2t) and (m, 2t + 1) at
// p[m * ld + 2t], read as one float2 (p 8-byte aligned, ld even)
__device__ __forceinline__ FragA frag_a_pairs(const float* p, int ld, int g, int t) {
  const float2 x = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 y = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  FragA f;
  split(x.x, f.hi[0], f.lo[0]);
  split(y.x, f.hi[1], f.lo[1]);
  split(x.y, f.hi[2], f.lo[2]);
  split(y.y, f.hi[3], f.lo[3]);
  return f;
}

}  // namespace
