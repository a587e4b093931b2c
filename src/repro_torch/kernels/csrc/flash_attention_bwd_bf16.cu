// The backward of flash attention for Hopper (sm_90a), bf16, over a full
// sequence (query i at position i): causal and sliding-window masks,
// grouped and multi-query heads (query head h reads kv head h / (nq / nkv)),
// any sequence length, hd up to 256.
//
// No TPU kernel: the JAX package differentiates its jnp attention
// (src/repro/models/attention.py:97 sdpa, :132 chunked_sdpa) with XLA.
// This is the backward of flash_attention_train_bf16
// (flash_attention_train_bf16.cu), which saves each row's log-sum-exp, so
// the probabilities are recomputed and never stored:
//   P = exp(bf16(S) * scale - lse) (0 where masked), dP = bf16(dO V^T),
//   D = sum_j P dP,  dV = sum bf16(P)^T dO,  dS' = bf16(P o (dP - D) * scale),
//   dQ = dS' K,  dK = dS'^T Q,
// dK and dV summed over the query heads of each kv group. S is rounded to
// bf16 as the forward rounds it (the reference's einsum returns bf16
// scores, src/repro/models/attention.py:113), P to
// bf16 where the reference rounds its probabilities (probs.astype(q.dtype),
// src/repro/models/attention.py:127), dP where its einsum of dO and V
// returns bf16, dS * scale where the transpose of its scores'
// .astype(jnp.float32) (:114) rounds their gradient. D is the softmax's own
// sum of P dP, as the reference's VJP takes it, not rowsum(dO o O): O is
// bf16 here, and its rounding would leave each row of dS a sum of about
// 2^-9 |dO| |O| where the reference's sums to 0 (a bias of k, whose true
// gradient is 0, then showed three times the reference's noise). The
// softmax, lse, D and every sum stay in fp32. It is the bf16 twin of
// flash_attention_bwd.cu (fp32), with its structure. The plain version is
// kernels/flash_attention/ref.py:flash_attention_bwd_ref with bf16 inputs.
//
// Layout: q, dout, dq (b, sq, nq, hd) and k, v, dk, dv (b, skv, nkv, hd),
// all contiguous bf16; lse and D (b, nq, sq) fp32. O is not read.
//
// What bounds it: at StableLM-3B's train_4k microbatch (batch 8, seq 4096,
// 32 heads of 80, causal) its five products over the causal half are
// 1.7e12 FLOP, 1.74 ms at 989 TFLOP/s bf16; reading q, k, v and dO and
// writing dq, dk, dv is 1.2 GB, 0.35 ms at 3.35 TB/s. So the tensor cores.
// (The D pass recomputes S and dP, two products more; the partial dQ below
// moves 2 x 64 x 0.34 GB of fp32 at that shape, and that traffic, not the
// bound, sets its time: ROADMAP.md Queue 2.)
//
// Design: first the D pass (flash_bwd_bf16_delta_kernel, below), then one
// block owns kBc keys of one (batch, kv head), keeps their dK
// and dV in fp32 registers, and walks, head by head of the group, the query
// rows that see any of its keys in chunks of kBr = 32 rows. Per chunk:
// - Q and dO of the chunk (and its lse, D) arrive by 16-byte cp.async,
//   double-buffered; rows padded to the instance's head width plus 8
//   values (ldmatrix's 8 rows then hit 8 bank groups);
// - S = Q K^T and dP = dO V^T on mma.sync m16n8k16 (bf16 in, fp32 sums),
//   then P and dS' in fp32 registers, kept in shared memory transposed as
//   bf16 (an mma tile the masks hide whole is skipped here and in the
//   three products below);
// - dV += P^T dO and dK += dS'^T Q into the registers (A by ldmatrix.x4
//   from P^T and dS'^T, B by ldmatrix.x2.trans from dO and Q);
// - this key tile's share of dQ, dS' K (A by ldmatrix.x4.trans from dS'^T,
//   B by ldmatrix.x2.trans from K), goes out from registers.
// dQ without atomics: with one key tile per (batch, kv head) (every
// sequence up to kBc keys) the block owns its rows' dQ and writes it in
// bf16. Past one tile each tile writes its partial dQ in fp32 to scratch,
// and a second kernel adds the partials in tile order into an fp32 sum (in
// rounds of as many tiles as the scratch holds), rounding to bf16 at the
// last round. The head split is the fp32 kernel's: hsplit blocks share
// a (key tile, kv head), writing fp32 dK, dV partials that a last kernel
// adds in split order and rounds. Every sum runs in a fixed order: two
// launches give the same bits.
//
// Tiles: hd <= 128 takes kBc = 64 keys, hd 256 kBc = 32. Shared memory:
// K, V, two buffers of Q and dO, P^T and dS'^T in bf16, lse and D in fp32:
// at hd 80 56 KB (two blocks an SM), hd 128 80 KB, hd 256 107 KB. The D
// pass: 64 rows of Q and dO and two buffers of K and V, hd 80 68 KB, hd 256
// 135 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "flash_masks.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBr = 32;        // query rows of a chunk
constexpr int kLdP = kBr + 8;  // row stride of P^T and dS'^T

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  float* delta;     // (b, nq, sq), written by the D pass when it runs
  float* dq_part;   // partial dQ of a round's tiles, or null
  float* dkv_part;  // (2, hsplit, b, skv, nkv, hd): partial dK then dV, or null
  float* dq_acc;    // dQ's fp32 sum over the rounds, or null
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int b, sq, skv, nq, nkv, hd, causal, window;
  int hsplit;  // blocks that share a (key tile, kv head), each group / hsplit heads
  int tile0;   // the round's first key tile
  int direct;  // one key tile in all: dQ in the block
  int vec;     // rows 16-byte aligned: cp.async
  float scale;
};

__host__ __device__ constexpr int row_ld(int width) { return width + 8; }

__host__ __device__ constexpr int smem_bytes(int bc, int width) {
  return ((2 * bc + 4 * kBr) * row_ld(width) + 2 * bc * kLdP) * 2 + 4 * kBr * 4;
}

// D[b, h, i] = sum_j P_ij dP_ij in fp32 over the keys row i sees, with
// P = exp(bf16(S_ij) * scale - lse_i) and dP = bf16(dO_i . v_j): the sum
// the softmax's backward takes in the reference, whose dP is its bf16
// einsum of dO and V (src/repro/models/attention.py:127). One block of 4
// warps owns kDr query rows of one (batch, head), each warp 16 of them, and
// walks the key tiles they see as the training forward does: S = Q K^T and
// dP = dO V^T on the tensor cores, each lane's sums in order, then the
// rows' sums over their 4 lanes by two shuffles.
constexpr int kDr = 64;
constexpr int kDThreads = 128;

__host__ __device__ constexpr int delta_smem_bytes(int bc, int stages, int width) {
  return (2 * kDr + 2 * stages * bc) * row_ld(width) * 2;
}

template <int kHDP, int kBc>
__global__ void __launch_bounds__(kDThreads) flash_bwd_bf16_delta_kernel(const BwdParams p,
                                                                         int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNS = kBc / 8, ld = row_ld(kHDP), kK = kHDP / 16;
  const int hd = p.hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kDr * ld;
  bf16* ks = dos + kDr * ld;
  bf16* vs = ks + stages * kBc * ld;

  const int bi = blockIdx.y / p.nq, h = blockIdx.y % p.nq, kvh = h / (p.nq / p.nkv);
  const int r0 = blockIdx.x * kDr, nr = min(kDr, p.sq - r0);
  const int lo = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv, r0 + nr) : p.skv;
  const int tile_lo = lo / kBc, tile_hi = hi > lo ? (hi + kBc - 1) / kBc : tile_lo;
  const long long q_stride = static_cast<long long>(p.nq) * hd;
  const long long kv_stride = static_cast<long long>(p.nkv) * hd;
  const long long q0 = ((static_cast<long long>(bi) * p.sq + r0) * p.nq + h) * hd;
  const long long kv0 = (static_cast<long long>(bi) * p.skv * p.nkv + kvh) * hd;
  const bool vec = p.vec != 0;

  auto load_tile = [&](int tile, int buf) {
    const int j0 = tile * kBc, nj = min(kBc, p.skv - j0);
    const long long first = kv0 + j0 * kv_stride;
    load_rows<kDThreads>(ks + buf * kBc * ld, p.k, first, kv_stride, hd, kHDP, nj, kBc, ld, vec);
    load_rows<kDThreads>(vs + buf * kBc * ld, p.v, first, kv_stride, hd, kHDP, nj, kBc, ld, vec);
  };
  load_rows<kDThreads>(qs, p.q, q0, q_stride, hd, kHDP, nr, kDr, ld, vec);
  load_rows<kDThreads>(dos, p.dout, q0, q_stride, hd, kHDP, nr, kDr, ld, vec);
  if (tile_lo < tile_hi) load_tile(tile_lo, 0);
  cp_async_commit();

  const int row0 = r0 + warp * 16;
  const int pos[2] = {row0 + g, row0 + g + 8};
  float lse[2], acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = pos[r] < p.sq ? p.lse[(static_cast<long long>(bi) * p.nq + h) * p.sq + pos[r]] : 0.0f;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int buf = (tile - tile_lo) % stages;
    if (stages > 1 && tile + 1 < tile_hi) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* kb = ks + buf * kBc * ld;
    const bf16* vb = vs + buf * kBc * ld;
    const int j0 = tile * kBc;
    float s[kNS][4], dp[kNS][4];
    bool live[kNS], low = false, high = false;
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int k0 = j0 + 8 * i;
      live[i] = k0 < p.skv && !hidden(row0, row0 + 15, k0, k0 + 7, p.causal, p.window);
      if (i < kNS / 2) {
        low = low || live[i];
      } else {
        high = high || live[i];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
    }
    if (high) {
      score_tiles<kNS, kNS, kK>(s, qs + warp * 16 * ld, kb, ld, lane);
      score_tiles<kNS, kNS, kK>(dp, dos + warp * 16 * ld, vb, ld, lane);
    } else if (low) {
      score_tiles<kNS / 2, kNS, kK>(s, qs + warp * 16 * ld, kb, ld, lane);
      score_tiles<kNS / 2, kNS, kK>(dp, dos + warp * 16 * ld, vb, ld, lane);
    }
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * i + 2 * t4 + (e & 1);
        if (live[i] && key < p.skv && visible(pos[e / 2], key, p.causal, p.window)) {
          acc[e / 2] += expf(round_bf16(s[i][e]) * p.scale - lse[e / 2]) * round_bf16(dp[i][e]);
        }
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
  }
  cp_async_wait_all();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float d = acc[r];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (t4 == 0 && pos[r] - r0 < nr) {
      p.delta[(static_cast<long long>(bi) * p.nq + h) * p.sq + pos[r]] = d;
    }
  }
}

// One (batch, kv head) x kBc keys: their dK and dV, and their share of the
// dQ of every query row that sees them. The head is padded with zeros to
// kHDP in shared memory.
template <int kBc, int kHDP>
__global__ void __launch_bounds__(kThreads, kHDP <= 96 ? 2 : 1)
flash_bwd_bf16_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kN8 = kHDP / 8;            // 8-column tiles of the head
  constexpr int kMT = kBc / 16;            // 16-key m-tiles of dK, dV
  constexpr int kWM = 8 / kMT;             // warps that share a key m-tile
  constexpr int kNT = (kN8 + kWM - 1) / kWM;  // head n-tiles a warp owns in dK, dV
  constexpr int kNS = kBc / 32;            // key n-tiles a warp owns in S, dP
  constexpr int kNQ = (kN8 + 3) / 4;       // head n-tiles a warp owns in dQ
  constexpr int kK = kHDP / 16;            // 16-wide steps of the head
  constexpr int ld = row_ld(kHDP);
  static_assert(kHDP % 16 == 0 && kBc % 32 == 0, "tile shapes");
  const int hd = p.hd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBc * ld;
  bf16* qs = vs + kBc * ld;  // two buffers of kBr rows
  bf16* dos = qs + 2 * kBr * ld;
  bf16* pt = dos + 2 * kBr * ld;  // P^T, kBc x kLdP
  bf16* dst = pt + kBc * kLdP;    // dS'^T
  float* lse_s = reinterpret_cast<float*>(dst + kBc * kLdP);  // two buffers of kBr
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
    load_rows<kThreads>(qs + buf * kBr * ld, p.q, first, q_stride, hd, kHDP, nr, kBr, ld, vec);
    load_rows<kThreads>(dos + buf * kBr * ld, p.dout, first, q_stride, hd, kHDP, nr, kBr, ld, vec);
    if (tid < kBr) {
      const long long at = (static_cast<long long>(bi) * p.nq + h) * p.sq + r0 + tid;
      lse_s[buf * kBr + tid] = tid < nr ? p.lse[at] : 0.0f;
      del_s[buf * kBr + tid] = tid < nr ? p.delta[at] : 0.0f;
    }
  };

  const long long key0 = ((static_cast<long long>(bi) * p.skv + j0) * p.nkv + kvh) * hd;
  load_rows<kThreads>(ks, p.k, key0, kv_stride, hd, kHDP, nj, kBc, ld, vec);
  load_rows<kThreads>(vs, p.v, key0, kv_stride, hd, kHDP, nj, kBc, ld, vec);
  if (n_chunks > 0) load_chunk(0, 0);
  cp_async_commit();

  // dK, dV: warp owns key m-tile warp % kMT and head n-tiles warp / kMT + kWM i
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
    const bf16* qb = qs + buf * kBr * ld;
    const bf16* dob = dos + buf * kBr * ld;
    const float* lse_b = lse_s + buf * kBr;
    const float* del_b = del_s + buf * kBr;
    // S and dP: warp owns row m-tile warp % 2 and key n-tiles warp / 2 + 4 i
    {
      const int ms = warp % 2;
      float s_acc[kNS][4], dp_acc[kNS][4];
      bool live[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[i][e] = dp_acc[i][e] = 0.0f;
        const int k0 = j0 + (warp / 2 + 4 * i) * 8;
        live[i] = !hidden(r0 + ms * 16, r0 + ms * 16 + 15, k0, k0 + 7, p.causal, p.window);
      }
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t aq[4], ado[4];
        ldsm_x4(aq, x4_rows_a(qb + ms * 16 * ld + kk * 16, ld, lane));
        ldsm_x4(ado, x4_rows_a(dob + ms * 16 * ld + kk * 16, ld, lane));
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          const int nt = warp / 2 + 4 * i;
          if (live[i]) {
            uint32_t bk[2], bv[2];
            ldsm_x2(bk, x2_rows_bt(ks + nt * 8 * ld + kk * 16, ld, lane));
            ldsm_x2(bv, x2_rows_bt(vs + nt * 8 * ld + kk * 16, ld, lane));
            mma_bf16(s_acc[i], aq, bk);
            mma_bf16(dp_acc[i], ado, bv);
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
            pv = expf(round_bf16(s_acc[i][e]) * p.scale - lse_b[row]);
            dsv = pv * (round_bf16(dp_acc[i][e]) - del_b[row]) * p.scale;
          }
          pt[key * kLdP + row] = __float2bfloat16(pv);
          dst[key * kLdP + row] = __float2bfloat16(dsv);
        }
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS'^T Q over the chunk's rows, 16 at a step
#pragma unroll
    for (int kk = 0; kk < kBr / 16; ++kk) {
      if (hidden(r0 + kk * 16, r0 + kk * 16 + 15, j0 + mk * 16, j0 + mk * 16 + 15, p.causal,
                 p.window)) {
        continue;
      }
      uint32_t ap[4], ads[4];
      ldsm_x4(ap, x4_rows_a(pt + mk * 16 * kLdP + kk * 16, kLdP, lane));
      ldsm_x4(ads, x4_rows_a(dst + mk * 16 * kLdP + kk * 16, kLdP, lane));
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int nt = nk0 + kWM * i;
        if (nt < kN8) {
          uint32_t bdo[2], bq[2];
          ldsm_x2_t(bdo, x2_rows_b(dob + kk * 16 * ld + nt * 8, ld, lane));
          ldsm_x2_t(bq, x2_rows_b(qb + kk * 16 * ld + nt * 8, ld, lane));
          mma_bf16(dv_acc[i], ap, bdo);
          mma_bf16(dk_acc[i], ads, bq);
        }
      }
    }

    // this tile's share of the chunk's dQ: dS' K, warp owns row m-tile
    // warp % 2 and head n-tiles warp / 2 + 4 i
    {
      const int mq = warp % 2;
      float dq_acc[kNQ][4];
#pragma unroll
      for (int i = 0; i < kNQ; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        if (hidden(r0 + mq * 16, r0 + mq * 16 + 15, j0 + kk * 16, j0 + kk * 16 + 15, p.causal,
                   p.window)) {
          continue;
        }
        uint32_t ads[4];
        ldsm_x4_t(ads, x4_rows_bt(dst + kk * 16 * kLdP + mq * 16, kLdP, lane));
#pragma unroll
        for (int i = 0; i < kNQ; ++i) {
          const int nt = warp / 2 + 4 * i;
          if (nt < kN8) {
            uint32_t bk[2];
            ldsm_x2_t(bk, x2_rows_b(ks + kk * 16 * ld + nt * 8, ld, lane));
            mma_bf16(dq_acc[i], ads, bk);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kNQ; ++i) {
        const int nt = warp / 2 + 4 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mq * 16 + g + (e >= 2 ? 8 : 0), col = nt * 8 + 2 * t4 + (e & 1);
          if (nt < kN8 && row < nr && col < hd) {
            const long long at = ((static_cast<long long>(bi) * p.sq + r0 + row) * p.nq + h) * hd
                                 + col;
            if (p.direct) {
              p.dq[at] = __float2bfloat16(dq_acc[i][e]);
            } else {
              p.dq_part[static_cast<long long>(blockIdx.y) * p.b * p.sq * q_stride + at] =
                  dq_acc[i][e];
            }
          }
        }
      }
    }
    __syncthreads();  // the buffers and P, dS' are free for the next chunk
  }
  cp_async_wait_all();  // a tile that no row sees left its copies in flight

  // dK, dV of the tile, or this split's part of them
  const long long kv_total = static_cast<long long>(p.b) * p.skv * kv_stride;
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int nt = nk0 + kWM * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = mk * 16 + g + (e >= 2 ? 8 : 0), col = nt * 8 + 2 * t4 + (e & 1);
      if (nt < kN8 && key < nj && col < hd) {
        const long long at = key0 + key * kv_stride + col;
        if (p.hsplit == 1) {
          p.dk[at] = __float2bfloat16(dk_acc[i][e]);
          p.dv[at] = __float2bfloat16(dv_acc[i][e]);
        } else {
          p.dkv_part[hs * kv_total + at] = dk_acc[i][e];
          p.dkv_part[(p.hsplit + hs) * kv_total + at] = dv_acc[i][e];
        }
      }
    }
  }
  // one tile in all: the rows that see none of its keys get a zero dQ
  if (p.direct) {
    const int unseen = p.sq - pos_hi;
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = tid; i < heads * unseen * hd; i += kThreads) {
      const int gh = i / (unseen * hd), rest = i - gh * unseen * hd;
      const int r = rest / hd, col = rest - r * hd;
      p.dq[((static_cast<long long>(bi) * p.sq + pos_hi + r) * p.nq + head0 + gh) * hd + col] =
          zero;
    }
  }
}

// dq_acc = (dq_acc, or 0 in the first round) + the partials of the round's
// tiles [tile0, tile0 + n) that a row sees, in tile order; the last round
// writes the sum to dq in bf16 instead
__global__ void __launch_bounds__(kThreads) flash_bwd_bf16_dq_sum_kernel(const BwdParams p,
                                                                         int bc, int n, int first,
                                                                         int last) {
  const long long total = static_cast<long long>(p.b) * p.sq * p.nq * p.hd;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int row = static_cast<int>(e / (static_cast<long long>(p.nq) * p.hd) % p.sq);
  float acc = first ? 0.0f : p.dq_acc[e];
  for (int i = 0; i < n; ++i) {
    const int j0 = (p.tile0 + i) * bc;
    int lo, hi;
    query_range(j0, min(bc, p.skv - j0), p.sq, p.causal, p.window, lo, hi);
    if (row >= lo && row < hi) acc += p.dq_part[i * total + e];
  }
  if (last) {
    p.dq[e] = __float2bfloat16(acc);
  } else {
    p.dq_acc[e] = acc;
  }
}

// dk, dv = the head splits' partials, added in split order and rounded
__global__ void __launch_bounds__(kThreads) flash_bwd_bf16_dkv_sum_kernel(const BwdParams p) {
  const long long total = static_cast<long long>(p.b) * p.skv * p.nkv * p.hd;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  float dk = 0.0f, dv = 0.0f;
  for (int i = 0; i < p.hsplit; ++i) {
    dk += p.dkv_part[i * total + e];
    dv += p.dkv_part[(p.hsplit + i) * total + e];
  }
  p.dk[e] = __float2bfloat16(dk);
  p.dv[e] = __float2bfloat16(dv);
}

template <int kBc, int kHDP>
int launch_as(BwdParams p, int part_tiles, cudaStream_t stream) {
  constexpr int smem = smem_bytes(kBc, kHDP);
  // Raised once per instantiation.
  static const cudaError_t raised = cudaFuncSetAttribute(
      flash_bwd_bf16_kernel<kBc, kHDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  static const cudaError_t raised_d = cudaFuncSetAttribute(
      flash_bwd_bf16_delta_kernel<kHDP, kBc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      delta_smem_bytes(kBc, 2, kHDP));
  if (raised_d != cudaSuccess) return static_cast<int>(raised_d);
  const int tiles = (p.skv + kBc - 1) / kBc;
  p.direct = tiles == 1;
  if (!p.direct && (part_tiles < 1 || p.dq_part == nullptr || p.dq_acc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  {
    const int stages = p.skv > kBc ? 2 : 1;
    flash_bwd_bf16_delta_kernel<kHDP, kBc>
        <<<dim3((p.sq + kDr - 1) / kDr, p.b * p.nq), kDThreads,
           delta_smem_bytes(kBc, stages, kHDP), stream>>>(p, stages);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long total = static_cast<long long>(p.b) * p.sq * p.nq * p.hd;
  for (int t0 = 0; t0 < tiles; t0 += p.direct ? tiles : part_tiles) {
    const int n = p.direct ? 1 : min(part_tiles, tiles - t0);
    p.tile0 = t0;
    flash_bwd_bf16_kernel<kBc, kHDP><<<dim3(p.b * p.nkv * p.hsplit, n), kThreads, smem,
                                       stream>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!p.direct) {
      flash_bwd_bf16_dq_sum_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                                     kThreads, 0, stream>>>(p, kBc, n, t0 == 0,
                                                            t0 + n >= tiles);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  if (p.hsplit > 1) {
    const long long kv_total = static_cast<long long>(p.b) * p.skv * p.nkv * p.hd;
    flash_bwd_bf16_dkv_sum_kernel<<<static_cast<unsigned>((kv_total + kThreads - 1) / kThreads),
                                    kThreads, 0, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// q, k, v, dout (bf16), lse (fp32); delta (scratch, (b, nq, sq) fp32);
// dq_part (scratch, part_tiles x (b, sq, nq, hd) fp32, or null when skv
// fits one key tile); dkv_part (scratch, 2 x hsplit x (b, skv, nkv, hd)
// fp32, or null when hsplit is 1); dq_acc (scratch, (b, sq, nq, hd) fp32,
// null with dq_part); dq, dk, dv (bf16); b, sq, skv, nq, nkv, hd; causal,
// window; part_tiles; hsplit, which divides nq / nkv; scale; stream. All
// contiguous in the layouts above.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq_part, void* dkv_part, void* dq_acc,
                                        void* dq, void* dk, void* dv, int b, int sq, int skv,
                                        int nq, int nkv, int hd, int causal, int window,
                                        int part_tiles, int hsplit, float scale, void* stream) {
  if (b < 0 || sq < 0 || skv < 0 || hd < 1 || hd > 256 || nkv < 1 || nq < 1 || nq % nkv != 0 ||
      hsplit < 1 || (nq / nkv) % hsplit != 0 || (hsplit > 1 && dkv_part == nullptr) ||
      (skv + 31) / 32 > 65535 || static_cast<long long>(b) * nkv * hsplit > 0x7fffffffLL ||
      static_cast<long long>(b) * nq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0 || skv == 0) return static_cast<int>(cudaSuccess);
  const bool vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout);
  BwdParams p{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),    static_cast<const bf16*>(dout),
              static_cast<const float*>(lse),
              static_cast<float*>(delta),     static_cast<float*>(dq_part),
              static_cast<float*>(dkv_part),  static_cast<float*>(dq_acc),
              static_cast<bf16*>(dq),         static_cast<bf16*>(dk),
              static_cast<bf16*>(dv),
              b, sq, skv, nq, nkv, hd, causal, window, hsplit, 0, 0, vec ? 1 : 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_as<64, 64>(p, part_tiles, st);
  if (hd <= 80) return launch_as<64, 80>(p, part_tiles, st);
  if (hd <= 96) return launch_as<64, 96>(p, part_tiles, st);
  if (hd <= 128) return launch_as<64, 128>(p, part_tiles, st);
  return launch_as<32, 256>(p, part_tiles, st);
}
