// bf16 products on Hopper's tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 accumulation), the ldmatrix loads that feed them from shared memory,
// and the 16-byte cp.async copies that fill it. Shared by
// flash_attention_train_bf16.cu and flash_attention_bwd_bf16.cu.
//
// A bf16 operand is exact on this path: one product per 16-deep step, each
// product of two bf16 values exact in fp32, summed in fp32.
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16), lane l, g = l / 4, t = l % 4;
// each 32-bit register holds two bf16, the lower index in the low half:
//   A (16 x 16, row m, column k): a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..),
//     a[2] (g, 2t + 8..), a[3] (g + 8, 2t + 8..);
//   B (16 x 8, row k, column n): b[0] (2t..2t+1, g), b[1] (2t + 8.., g);
//   C (16 x 8, fp32): c[0], c[1] (g, 2t), (g, 2t + 1); c[2], c[3] (g + 8, ...).
// ldmatrix.x4 loads four 8 x 8 bf16 matrices, lanes 8i..8i+7 giving the
// addresses of matrix i's rows; register i of lane l is matrix i's row g,
// columns 2t and 2t + 1 (with .trans: rows 2t and 2t + 1 of column g).
//
// The inline assembly lives in small named helpers (cp_async16,
// cp_async_commit, cp_async_wait_one, cp_async_wait_all, ldsm_x4,
// ldsm_x4_t, ldsm_x2, ldsm_x2_t, mma_bf16, pack_bf16), so a host build can
// stand in for each by name.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
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

// four 8 x 8 matrices; `row` is this lane's row address in shared memory
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// two matrices: lanes 0..15 give the addresses (the others' are read but
// not used, and must still lie in shared memory)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// d += a b for one m16n8k16 tile, bf16 operands, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// lo and hi rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x rounded to bf16 (to nearest even) and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The A fragment of a 16 x 16 tile whose columns k are the 16 columns of
// two neighbouring accumulator tiles, lo (columns 0..7) and hi (8..15),
// rounded to bf16: the accumulator's C layout is A's, register for
// register (FlashAttention-2's reuse of S's registers as P).
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[4], const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Row addresses for the x4 loads, from a tile's first element p of a
// row-major array with row stride ld (elements), lane l:
// A of a row-major (m, k) tile, 16 x 16, or the B pair {r0, r1}, {r2, r3}
// of a row-major (k, n) tile read .trans (16 k x 16 n: n-tiles 0 and 1)
__device__ __forceinline__ const bf16* x4_rows_a(const bf16* p, int ld, int lane) {
  return p + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4);
}
// the B pair of an (n, k) array (B = X^T of a row-major X, 16 n x 16 k):
// {r0, r1} n-tile 0, {r2, r3} n-tile 1; or A of a column-major (m, k)
// tile (element (m, k) at p[k * ld + m]) read .trans
__device__ __forceinline__ const bf16* x4_rows_bt(const bf16* p, int ld, int lane) {
  return p + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1);
}
// the x2 loads: B of an (n, k) array, 8 n x 16 k; or B of a row-major
// (k, n) array read .trans, 16 k x 8 n
__device__ __forceinline__ const bf16* x2_rows_bt(const bf16* p, int ld, int lane) {
  return p + (lane & 7) * ld + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ const bf16* x2_rows_b(const bf16* p, int ld, int lane) {
  return p + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld;
}

// S += A B^T for a warp's 16 rows of A (row-major, from qa) and its first N
// 8-row tiles of B (row-major, from kb; N even), over kK 16-wide steps:
// the score tiles of Q K^T, or of dO V^T
template <int N, int kNS, int kK>
__device__ __forceinline__ void score_tiles(float (&s)[kNS][4], const bf16* qa, const bf16* kb,
                                            int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    uint32_t aq[4];
    ldsm_x4(aq, x4_rows_a(qa + kk * 16, ld, lane));
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      uint32_t bk[4];
      ldsm_x4(bk, x4_rows_bt(kb + i * 8 * ld + kk * 16, ld, lane));
      const uint32_t b0[2] = {bk[0], bk[1]}, b1[2] = {bk[2], bk[3]};
      mma_bf16(s[i], aq, b0);
      mma_bf16(s[i + 1], aq, b1);
    }
  }
}

}  // namespace
