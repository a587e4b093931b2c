// The backward of flash attention for Hopper (sm_90a), fp32, over a full
// sequence (query i at position i): causal and sliding-window masks,
// grouped and multi-query heads (query head h reads kv head h / (nq / nkv)),
// any sequence length, hd up to 256.
//
// No TPU kernel: the JAX package differentiates its jnp attention
// (src/repro/models/attention.py:97 sdpa) with XLA. This is the backward of
// flash_attention_train_f32 (flash_attention.cu), which saves each row's
// log-sum-exp, so the probabilities are recomputed and never stored:
//   P = exp(S * scale - lse) (0 where masked), D = rowsum(dO o O),
//   dV = sum P^T dO,  dS = P o (dO V^T - D),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over the query heads of each kv group. The plain version
// is kernels/flash_attention/ref.py:flash_attention_bwd_ref; its
// split_tf32=True form computes the products as this kernel does.
//
// Layout: q, out, dout, dq (b, sq, nq, hd) and k, v, dk, dv (b, skv, nkv,
// hd), all contiguous; lse and D (b, nq, sq).
//
// What bounds it: at the training shape (StableLM-3B, batch 8, seq 64, 32
// heads of 80, causal) it must read q, k, v, O and dO and write dq, dk, dv,
// 41.9 MB, 0.0125 ms at 3.35 TB/s; its five products over the causal half
// are 0.42 GFLOP, 0.0063 ms at 67 TFLOP/s fp32. So memory.
//
// Design: one block owns kBc keys of one (batch, kv head), keeps their dK
// and dV in registers, and walks, head by head of the group, the query rows
// that see any of its keys in chunks of kBr = 32 rows. Per chunk:
// - Q and dO of the chunk (and its lse, D) arrive by 16-byte cp.async,
//   double-buffered: the next chunk's copies fly while this one computes;
// - S = Q K^T and dP = dO V^T, then P and dS, computed once, kept in
//   shared memory transposed (an mma tile the masks hide whole is skipped
//   here and in the three products below);
// - dV += P^T dO and dK += dS^T Q into the registers;
// - this key tile's share of dQ, dS K, goes out from registers.
// All five products run on the tensor cores (mma.sync m16n8k8, TF32) in
// the error-compensated split of mma_tf32.cuh, which keeps fp32's 2e-5
// parity.
// dQ without atomics: with one key tile per (batch, kv head) (every
// sequence up to kBc keys) the block owns its rows' dQ and writes it, and
// computes D itself from O and dO (it sees each query row once). Past one
// tile each tile writes its partial dQ to scratch, and a second kernel adds
// the partials in tile order (in rounds of as many tiles as the scratch
// holds); D is then a pass of its own before. Every sum runs in a fixed
// order: two launches give the same bits.
// Head split: b x nkv x (a round's tiles) blocks leave most of the card idle
// under multi-query heads at a small batch (RecurrentGemma-9B's 16 heads on
// one kv head, batch 2: 4 blocks at 64 positions). Then hsplit blocks share
// a (key tile, kv head), each walking group / hsplit of its query heads;
// they write dK, dV partials, which a last kernel adds in split order. The
// host picks hsplit (flash_attention/ops.py bwd_head_split).
//
// Tiles: hd <= 128 takes kBc = 64 keys, hd <= 256 kBc = 32. Shared memory:
// K, V, two buffers of Q and dO (rows of hd rounded up to 8, plus 4 floats:
// a quarter-warp reading 8 rows of one fragment column hits 8 bank groups),
// P^T and dS^T: at hd 80 105 KB (two blocks an SM), hd 128 154 KB, hd 256
// 209 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "flash_masks.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBr = 32;        // query rows of a chunk
constexpr int kLdP = kBr + 4;  // row stride of P^T and dS^T

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* dout;
  const float* lse;
  float* delta;    // (b, nq, sq), written by the D pass when it runs
  float* dq_part;  // partial dQ of a round's tiles, or null
  float* dkv_part;  // (2, hsplit, b, skv, nkv, hd): partial dK then dV, or null
  float* dq;
  float* dk;
  float* dv;
  int b, sq, skv, nq, nkv, hd, causal, window;
  int hsplit;  // blocks that share a (key tile, kv head), each group / hsplit heads
  int tile0;   // the round's first key tile
  int direct;  // one key tile in all: dQ and D in the block
  int vec;     // rows 16-byte aligned: cp.async
  float scale;
};

__host__ __device__ constexpr int round8(int hd) { return (hd + 7) / 8 * 8; }
__host__ __device__ constexpr int row_ld(int hd) { return round8(hd) + 4; }

__host__ __device__ constexpr int smem_floats(int bc, int hd) {
  return (2 * bc + 4 * kBr) * row_ld(hd) + 2 * bc * kLdP + 4 * kBr;
}

// sum_d x[d] y[d] over one warp: lanes stride the row, then a fixed xor
// tree; x in shared or global memory, y in global memory
__device__ __forceinline__ float warp_dot(const float* x, const float* y, int hd) {
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(x[d], y[d], acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  return acc;
}

// D[b, h, s] = sum_d dout[b, s, h, d] * out[b, s, h, d], a warp a row
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(const BwdParams p) {
  const long long rows = static_cast<long long>(p.b) * p.sq * p.nq;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const float sum = warp_dot(p.dout + row * p.hd, p.out + row * p.hd, p.hd);
  if (threadIdx.x % 32 == 0) {
    const long long h = row % p.nq, s = row / p.nq % p.sq, bi = row / p.nq / p.sq;
    p.delta[(bi * p.nq + h) * p.sq + s] = sum;
  }
}

// One (batch, kv head) x kBc keys: their dK and dV, and their share of the
// dQ of every query row that sees them.
template <int kBc, int kHDP>
__global__ void __launch_bounds__(kThreads, kHDP <= 96 ? 2 : 1)
flash_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kMT = kBc / 16;          // 16-key m-tiles of dK, dV
  constexpr int kNT = kHDP / 8 / (8 / kMT);  // hd n-tiles a warp owns in dK, dV
  constexpr int kNS = kBc / 32;          // key n-tiles a warp owns in S, dP
  constexpr int kNQ = kHDP / 32;         // hd n-tiles a warp owns in dQ
  const int hd = p.hd, ld = row_ld(hd), n8 = round8(hd) / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  float* ks = smem;
  float* vs = ks + kBc * ld;
  float* qs = vs + kBc * ld;   // two buffers of kBr rows
  float* dos = qs + 2 * kBr * ld;
  float* pt = dos + 2 * kBr * ld;  // P^T, kBc x kLdP
  float* dst = pt + kBc * kLdP;    // dS^T
  float* lse_s = dst + kBc * kLdP;  // two buffers of kBr
  float* del_s = lse_s + 2 * kBr;

  const int hs = blockIdx.x % p.hsplit, bk = blockIdx.x / p.hsplit;
  const int bi = bk / p.nkv, kvh = bk % p.nkv;
  const int heads = p.nq / p.nkv / p.hsplit;  // the block's query heads
  const int head0 = (kvh * p.hsplit + hs) * heads;
  const int tile = p.tile0 + blockIdx.y;
  const int j0 = tile * kBc, nj = min(kBc, p.skv - j0);
  int pos_lo, pos_hi;
  query_range(j0, nj, p.sq, p.causal, p.window, pos_lo, pos_hi);
  const int n_rc = pos_hi > pos_lo ? (pos_hi - pos_lo + kBr - 1) / kBr : 0;
  const int n_chunks = heads * n_rc;
  const long long q_stride = static_cast<long long>(p.nq) * hd;
  const long long kv_stride = static_cast<long long>(p.nkv) * hd;
  const bool vec = p.vec != 0;

  auto load_chunk = [&](int c, int buf) {
    const int h = head0 + c / n_rc, r0 = pos_lo + (c % n_rc) * kBr;
    const int nr = min(kBr, pos_hi - r0);
    const long long first = ((static_cast<long long>(bi) * p.sq + r0) * p.nq + h) * hd;
    load_rows<kThreads>(qs + buf * kBr * ld, p.q, first, q_stride, hd, round8(hd), nr, kBr,
                        ld, vec);
    load_rows<kThreads>(dos + buf * kBr * ld, p.dout, first, q_stride, hd, round8(hd), nr, kBr,
                        ld, vec);
    if (tid < kBr) {
      const long long at = (static_cast<long long>(bi) * p.nq + h) * p.sq + r0 + tid;
      lse_s[buf * kBr + tid] = tid < nr ? p.lse[at] : 0.0f;
      if (!p.direct) del_s[buf * kBr + tid] = tid < nr ? p.delta[at] : 0.0f;
    }
  };

  const long long key0 = ((static_cast<long long>(bi) * p.skv + j0) * p.nkv + kvh) * hd;
  load_rows<kThreads>(ks, p.k, key0, kv_stride, hd, round8(hd), nj, kBc, ld, vec);
  load_rows<kThreads>(vs, p.v, key0, kv_stride, hd, round8(hd), nj, kBc, ld, vec);
  if (n_chunks > 0) load_chunk(0, 0);
  cp_async_commit();

  // dK, dV: warp owns key m-tile warp % kMT and hd n-tiles warp / kMT + (8 / kMT) i
  const int mk = warp % kMT, nk0 = warp / kMT;
  float dk_acc[kNT][4], dv_acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) load_chunk(c + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int h = head0 + c / n_rc, r0 = pos_lo + (c % n_rc) * kBr;
    const int nr = min(kBr, pos_hi - r0);
    const float* qb = qs + buf * kBr * ld;
    const float* dob = dos + buf * kBr * ld;
    const float* lse_b = lse_s + buf * kBr;
    float* del_b = del_s + buf * kBr;
    if (p.direct) {  // D of the chunk's rows, a warp 4 rows at once (warp_dot's order)
      constexpr int kRowsW = kBr / (kThreads / 32);
      float d[kRowsW];
      const float* o = p.out + ((static_cast<long long>(bi) * p.sq + r0) * p.nq + h) * hd;
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) d[i] = 0.0f;
      for (int col = lane; col < hd; col += 32) {
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) {
          const int r = warp + i * (kThreads / 32);
          if (r < nr) d[i] = fmaf(dob[r * ld + col], o[r * q_stride + col], d[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) d[i] += __shfl_xor_sync(0xffffffffu, d[i], m);
        if (lane == 0) del_b[warp + i * (kThreads / 32)] = d[i];
      }
      __syncthreads();
    }

    // S and dP: warp owns row m-tile warp % 2 and key n-tiles warp / 2 + 4 i
    {
      const int ms = warp % 2;
      float s_acc[kNS][4], dp_acc[kNS][4];
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[i][e] = dp_acc[i][e] = 0.0f;
      }
      bool live[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int k0 = j0 + (warp / 2 + 4 * i) * 8;
        live[i] = !hidden(r0 + ms * 16, r0 + ms * 16 + 15, k0, k0 + 7, p.causal, p.window);
      }
      for (int kk = 0; kk < n8; ++kk) {
        const FragA aq = frag_a(qb + ms * 16 * ld + kk * 8, ld, g, t4);
        const FragA ado = frag_a(dob + ms * 16 * ld + kk * 8, ld, g, t4);
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int nt = warp / 2 + 4 * i;
          if (live[i]) {
            mma3(s_acc[i], aq, frag_b_t(ks + nt * 8 * ld + kk * 8, ld, g, t4));
            mma3(dp_acc[i], ado, frag_b_t(vs + nt * 8 * ld + kk * 8, ld, g, t4));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int nt = warp / 2 + 4 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ms * 16 + g + (e >= 2 ? 8 : 0), key = nt * 8 + 2 * t4 + (e & 1);
          float pv = 0.0f, dsv = 0.0f;
          if (row < nr && key < nj && visible(r0 + row, j0 + key, p.causal, p.window)) {
            pv = expf(s_acc[i][e] * p.scale - lse_b[row]);
            dsv = pv * (dp_acc[i][e] - del_b[row]);
          }
          pt[key * kLdP + row] = pv;
          dst[key * kLdP + row] = dsv;
        }
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the chunk's rows
#pragma unroll
    for (int kk = 0; kk < kBr / 8; ++kk) {
      if (hidden(r0 + kk * 8, r0 + kk * 8 + 7, j0 + mk * 16, j0 + mk * 16 + 15, p.causal,
                 p.window)) {
        continue;
      }
      const FragA ap = frag_a(pt + mk * 16 * kLdP + kk * 8, kLdP, g, t4);
      const FragA ads = frag_a(dst + mk * 16 * kLdP + kk * 8, kLdP, g, t4);
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int nt = nk0 + (8 / kMT) * i;
        if (nt < n8) {
          mma3(dv_acc[i], ap, frag_b(dob + kk * 8 * ld + nt * 8, ld, g, t4));
          mma3(dk_acc[i], ads, frag_b(qb + kk * 8 * ld + nt * 8, ld, g, t4));
        }
      }
    }

    // this tile's share of the chunk's dQ: dS K, warp owns row m-tile
    // warp % 2 and hd n-tiles warp / 2 + 4 i
    {
      const int mq = warp % 2;
      float dq_acc[kNQ][4];
#pragma unroll
      for (int i = 0; i < kNQ; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kBc / 8; ++kk) {
        if (hidden(r0 + mq * 16, r0 + mq * 16 + 15, j0 + kk * 8, j0 + kk * 8 + 7, p.causal,
                   p.window)) {
          continue;
        }
        const FragA ads = frag_a_t(dst + kk * 8 * kLdP + mq * 16, kLdP, g, t4);
#pragma unroll
        for (int i = 0; i < kNQ; ++i) {
          const int nt = warp / 2 + 4 * i;
          if (nt < n8) mma3(dq_acc[i], ads, frag_b(ks + kk * 8 * ld + nt * 8, ld, g, t4));
        }
      }
      float* out = p.direct ? p.dq
                            : p.dq_part + static_cast<long long>(blockIdx.y) * p.b * p.sq * q_stride;
#pragma unroll
      for (int i = 0; i < kNQ; ++i) {
        const int nt = warp / 2 + 4 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mq * 16 + g + (e >= 2 ? 8 : 0), col = nt * 8 + 2 * t4 + (e & 1);
          if (nt < n8 && row < nr && col < hd) {
            out[((static_cast<long long>(bi) * p.sq + r0 + row) * p.nq + h) * hd + col] =
                dq_acc[i][e] * p.scale;
          }
        }
      }
    }
    __syncthreads();  // the buffers and P, dS are free for the next chunk
  }
  cp_async_wait_all();  // a tile that no row sees left its copies in flight

  // dK, dV of the tile, or this split's part of them
  const long long kv_total = static_cast<long long>(p.b) * p.skv * kv_stride;
  float* dk_out = p.hsplit == 1 ? p.dk : p.dkv_part + hs * kv_total;
  float* dv_out = p.hsplit == 1 ? p.dv : p.dkv_part + (p.hsplit + hs) * kv_total;
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int nt = nk0 + (8 / kMT) * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = mk * 16 + g + (e >= 2 ? 8 : 0), col = nt * 8 + 2 * t4 + (e & 1);
      if (nt < n8 && key < nj && col < hd) {
        const long long at = key0 + key * kv_stride + col;
        dk_out[at] = dk_acc[i][e] * p.scale;
        dv_out[at] = dv_acc[i][e];
      }
    }
  }
  // one tile in all: the rows that see none of its keys get a zero dQ
  if (p.direct) {
    const int unseen = p.sq - pos_hi;
    for (int i = tid; i < heads * unseen * hd; i += kThreads) {
      const int gh = i / (unseen * hd), rest = i - gh * unseen * hd;
      const int r = rest / hd, col = rest - r * hd;
      p.dq[((static_cast<long long>(bi) * p.sq + pos_hi + r) * p.nq + head0 + gh) * hd +
           col] = 0.0f;
    }
  }
}

// dq = (dq, or 0 in the first round) + the partials of the round's tiles
// [tile0, tile0 + n) that a row sees, in tile order
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_sum_kernel(const BwdParams p, int bc,
                                                                    int n, int first) {
  const long long total = static_cast<long long>(p.b) * p.sq * p.nq * p.hd;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int row = static_cast<int>(e / (static_cast<long long>(p.nq) * p.hd) % p.sq);
  float acc = first ? 0.0f : p.dq[e];
  for (int i = 0; i < n; ++i) {
    const int j0 = (p.tile0 + i) * bc;
    int lo, hi;
    query_range(j0, min(bc, p.skv - j0), p.sq, p.causal, p.window, lo, hi);
    if (row >= lo && row < hi) acc += p.dq_part[i * total + e];
  }
  p.dq[e] = acc;
}

// dk, dv = the head splits' partials, added in split order
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_sum_kernel(const BwdParams p) {
  const long long total = static_cast<long long>(p.b) * p.skv * p.nkv * p.hd;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  float dk = 0.0f, dv = 0.0f;
  for (int i = 0; i < p.hsplit; ++i) {
    dk += p.dkv_part[i * total + e];
    dv += p.dkv_part[(p.hsplit + i) * total + e];
  }
  p.dk[e] = dk;
  p.dv[e] = dv;
}

template <int kBc, int kHDP>
int launch_as(BwdParams p, int part_tiles, cudaStream_t stream) {
  const int smem = smem_floats(kBc, p.hd) * 4;
  // Raised once per instantiation, to what its widest head needs.
  static const cudaError_t raised = cudaFuncSetAttribute(
      flash_bwd_kernel<kBc, kHDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(kBc, kHDP) * 4);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int tiles = (p.skv + kBc - 1) / kBc;
  p.direct = tiles == 1;
  if (!p.direct) {
    if (part_tiles < 1 || p.dq_part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = static_cast<long long>(p.b) * p.sq * p.nq;
    flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
                             kThreads, 0, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long total = static_cast<long long>(p.b) * p.sq * p.nq * p.hd;
  for (int t0 = 0; t0 < tiles; t0 += p.direct ? tiles : part_tiles) {
    const int n = p.direct ? 1 : min(part_tiles, tiles - t0);
    p.tile0 = t0;
    flash_bwd_kernel<kBc, kHDP><<<dim3(p.b * p.nkv * p.hsplit, n), kThreads, smem, stream>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!p.direct) {
      flash_bwd_dq_sum_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                                kThreads, 0, stream>>>(p, kBc, n, t0 == 0);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  if (p.hsplit > 1) {
    const long long kv_total = static_cast<long long>(p.b) * p.skv * p.nkv * p.hd;
    flash_bwd_dkv_sum_kernel<<<static_cast<unsigned>((kv_total + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// q, k, v, out, dout, lse; delta (scratch, (b, nq, sq) fp32); dq_part
// (scratch, part_tiles x (b, sq, nq, hd) fp32, or null when skv fits one
// key tile); dkv_part (scratch, 2 x hsplit x (b, skv, nkv, hd) fp32, or null
// when hsplit is 1); dq, dk, dv; b, sq, skv, nq, nkv, hd; causal, window;
// part_tiles; hsplit, which divides nq / nkv; scale; stream. All fp32 and
// contiguous in the layouts above.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       void* delta, void* dq_part, void* dkv_part, void* dq,
                                       void* dk, void* dv, int b, int sq, int skv, int nq, int nkv,
                                       int hd, int causal, int window, int part_tiles, int hsplit,
                                       float scale, void* stream) {
  if (b < 0 || sq < 0 || skv < 0 || hd < 1 || hd > 256 || nkv < 1 || nq < 1 || nq % nkv != 0 ||
      hsplit < 1 || (nq / nkv) % hsplit != 0 || (hsplit > 1 && dkv_part == nullptr) ||
      (skv + 31) / 32 > 65535 || static_cast<long long>(b) * nkv * hsplit > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0 || skv == 0) return static_cast<int>(cudaSuccess);
  const bool vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  BwdParams p{static_cast<const float*>(q),    static_cast<const float*>(k),
              static_cast<const float*>(v),    static_cast<const float*>(out),
              static_cast<const float*>(dout), static_cast<const float*>(lse),
              static_cast<float*>(delta),      static_cast<float*>(dq_part),
              static_cast<float*>(dkv_part),   static_cast<float*>(dq),
              static_cast<float*>(dk),         static_cast<float*>(dv),
              b, sq, skv, nq, nkv, hd, causal, window, hsplit, 0, 0, vec ? 1 : 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_as<64, 64>(p, part_tiles, st);
  if (hd <= 96) return launch_as<64, 96>(p, part_tiles, st);
  if (hd <= 128) return launch_as<64, 128>(p, part_tiles, st);
  return launch_as<32, 256>(p, part_tiles, st);
}
