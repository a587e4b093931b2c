// The backward of flash attention for Hopper (sm_90a), bf16, over a full
// sequence (query i at position i): causal and sliding-window masks,
// grouped and multi-query heads (query head h reads kv head h / (nq / nkv)),
// any sequence length, hd a multiple of 8 up to 256 (flash_attention/ops.py
// pads any other hd with zeros).
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
// softmax, lse, D and every sum stay in fp32. The plain version is
// kernels/flash_attention/ref.py:flash_attention_bwd_ref with bf16 inputs.
//
// Layout: q, dout, dq (b, sq, nq, hd) and k, v, dk, dv (b, skv, nkv, hd),
// all contiguous bf16 from 16-byte-aligned bases; lse (b, nq, sq) fp32.
// O is not read.
//
// What bounds it: at StableLM-3B's train_4k microbatch (batch 8, seq 4096,
// 32 heads of 80, causal) the five products of the algebra above over the
// causal half are 1.7e12 FLOP, 1.74 ms at 989 TFLOP/s bf16; reading q, k,
// v and dO and writing dq, dk, dv is 1.2 GB, 0.35 ms at 3.35 TB/s. So the
// tensor cores. This design does nine products where the algebra has
// five (S and dP twice in the query-tile kernel, then dQ; S, dP, dV and dK
// in the key-tile kernel), so its own floor is 9/5 of that, 3.1 ms.
//
// Design: two kernels (hopper_bf16.cuh has the instructions, the
// shared-memory layout and the register split), each a block of consumer
// warpgroups and one producer warpgroup whose one thread brings tiles by
// TMA into a ring of up to four shared-memory stages, each with a full and
// an empty mbarrier; every product on wgmma; tiles the masks hide from a
// whole block are never loaded, and a warpgroup passes those they hide
// from its own rows.
// (a) flash_bwd_bf16_query_kernel: one block owns 64 kWG query rows of one
//   (batch, head) (three warpgroups up to hd 96, two at hd 128, one at hd
//   256), Q and dO loaded once. Sweep 1 over the visible key tiles of K and
//   V (64 keys, 32 at hd 256): S = Q K^T and dP = dO V^T, and D = sum P
//   bf16(dP) in fp32 registers, each lane's terms in key order, then over
//   the row's 4 lanes; D and a copy of lse (in log2 units) go to a (2, b,
//   nq, sq rounded up to 4) fp32 scratch for (b). Sweep 2 over the same
//   tiles: S and dP again, dS' in registers, and dQ += dS' K with dS' the A
//   operand straight from the accumulator's registers and K read MN-major
//   from the same tile. dQ is rounded to bf16 once and written once: no
//   partial dQ, no atomics. Where the ring holds every tile of the block
//   (4 or fewer), sweep 2 reads them where sweep 1 left them.
// (b) flash_bwd_bf16_key_kernel: one block owns 64 kWG keys of one (batch,
//   kv head) (three warpgroups up to hd 80, two at hd 96 and 128), K and V
//   loaded once, and walks, head by head of the group, the query rows that
//   see them (query_range) in chunks of 32 rows; Q, dO, lse and D of a
//   chunk arrive by TMA into the ring. S^T = K Q^T and dP^T = V dO^T, then
//   P^T and dS'^T leave their accumulators as register A operands of
//   dV += P^T dO and dK += dS'^T Q (dO and Q MN-major). dK and dV stay in
//   fp32 registers, each thread's sums in chunk order, and are written once
//   in bf16; where bwd_head_split's hsplit > 1 blocks share a (key tile,
//   kv head), each writes its fp32 part to scratch and
//   flash_bwd_bf16_dkv_sum_kernel adds the parts in split order.
// Sequences of up to 64 rows and keys take blocks of one consumer
// warpgroup, two an SM (8 x 32 heads then fill the card in one wave). A
// call is 2 launches, or 3 with a head split, at every sequence length.
// Every sum runs in a fixed order: two launches give the same bits.
// Three warpgroups of 160 registers ran faster than two of 240 (their
// products wait on one another less); wgmma issued behind a branch the
// compiler cannot prove uniform, or with too few registers, is serialized,
// hence the uniform warpgroup index and the barrier waits written as one
// PTX loop (hopper_bf16.cuh).
//
// hd 80 (StableLM-3B, HuBERT): the 32-byte swizzle's 16-value column blocks
// take it unpadded, 5 of them; 80 is a legal wgmma width for dQ, dK, dV.
// hd 256 (RecurrentGemma-9B): dK and dV of 64 keys are 128 KB of fp32,
// more than one warpgroup's registers, so in (b) both warpgroups own all
// 64 keys and each half of dK's and dV's columns (128 each), and each
// recomputes S^T and dP^T (2 of the 4 products doubled at that width);
// (a) takes 64 rows in one warpgroup of 255 registers and 32-key tiles.
// Shared memory: (a) hd 80 141 KB, hd 128 and 256 193 KB; (b) hd 80 102
// KB, hd 128 130 KB, hd 256 194 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper_bf16.cuh"
#include "flash_masks.cuh"

namespace {

struct BwdParams {
  CUtensorMap qa_map, doa_map;  // (a): boxes of (kSw / 2, 1, kRows, 1)
  CUtensorMap ka_map, va_map;   // (a): boxes of (kSw / 2, 1, kBc, 1)
  CUtensorMap qb_map, dob_map;  // (b): boxes of (kSw / 2, 1, kBr, 1)
  CUtensorMap kb_map, vb_map;   // (b): boxes of (kSw / 2, 1, kKeys, 1)
  CUtensorMap rows_map;         // (b): the scratch's lse and D, boxes of (kBr, 1)
  const float* lse;
  float* rows;      // (2, b, nq, sq_pad): lse in log2 units (lse log2 e), then D
  float* dkv_part;  // (2, hsplit, b, skv, nkv, hd): partial dK then dV, or null
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int b, sq, skv, nq, nkv, hd, causal, window;
  int hsplit;  // blocks that share a (key tile, kv head), each group / hsplit heads
  int sq_pad;  // sq rounded up to 4: the scratch's row length
  float scale;
};

// ---- (a) the query-tile kernel: D, then dQ ----

// stages of K and V that fit beside Q and dO, at most 4
template <int kHDP, int kSw, int kBc, int kWG>
__host__ __device__ constexpr int query_stages() {
  constexpr int fit = (kSmemMax / blocks_per_sm<kWG, kHDP>() - 2048 -
                       2 * SwTile<kSw, 64 * kWG, kHDP>::kBytes) /
                      (2 * SwTile<kSw, kBc, kHDP>::kBytes);
  return fit < 4 ? fit : 4;
}

template <int kHDP, int kSw, int kBc, int kWG>
__host__ __device__ constexpr int query_smem_bytes() {
  constexpr int stages = query_stages<kHDP, kSw, kBc, kWG>();
  return 1024 + 2 * SwTile<kSw, 64 * kWG, kHDP>::kBytes +
         2 * stages * SwTile<kSw, kBc, kHDP>::kBytes + (1 + 2 * stages) * 8;
}

template <int kHDP, int kSw, int kBc, int kWG>
__global__ void __launch_bounds__(128 * kWG + 128, (blocks_per_sm<kWG, kHDP>()))
flash_bwd_bf16_query_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kConsumers = 128 * kWG, kRows = 64 * kWG;
  using QT = SwTile<kSw, kRows, kHDP>;
  using KT = SwTile<kSw, kBc, kHDP>;
  constexpr int kStagesA = query_stages<kHDP, kSw, kBc, kWG>();
  constexpr int kW = kHDP > 128 ? 128 : kHDP;  // width of one dQ product
  constexpr int kNO = kHDP / kW;
  unsigned char* base = align_1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* dos = qs + QT::kElems;
  bf16* ks = dos + QT::kElems;
  bf16* vs = ks + kStagesA * KT::kElems;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStagesA * KT::kElems);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStagesA;

  const int bh = blockIdx.y, bi = bh / p.nq, h = bh % p.nq, kvh = h / (p.nq / p.nkv);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows, nr = min(kRows, p.sq - r0);
  const int lo = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv, r0 + nr) : p.skv;
  const int tile_lo = lo / kBc, tile_hi = hi > lo ? (hi + kBc - 1) / kBc : tile_lo;
  const int n_tiles = tile_hi - tile_lo;
  // tiles the ring holds at once are loaded once, for both sweeps
  const bool resident = n_tiles <= kStagesA;
  const int loads = resident ? n_tiles : 2 * n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesA; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: Q and dO, then the tiles twice
    producer_regs<kWG, kHDP>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&p.ka_map);
      tma_prefetch(&p.va_map);
      mbar_expect_tx(q_full, 2 * QT::kBytes);
      QT::load(qs, &p.qa_map, q_full, h, r0, bi);
      QT::load(dos, &p.doa_map, q_full, h, r0, bi);
      for (int i = 0; i < loads; ++i) {
        const int st = i % kStagesA, use = i / kStagesA;
        const int j0 = (tile_lo + i % n_tiles) * kBc;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        mbar_expect_tx(&full[st], 2 * KT::kBytes);
        KT::load(ks + st * KT::kElems, &p.ka_map, &full[st], kvh, j0, bi);
        KT::load(vs + st * KT::kElems, &p.va_map, &full[st], kvh, j0, bi);
      }
    }
    return;
  }

  // a consumer; P = exp(s scale - lse) as 2^(s scale log2 e - lse log2 e)
  consumer_regs<kWG, kHDP>();
  const int wg = warpgroup_index(), warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr0 = r0 + wg * 64;
  const int pos[2] = {wr0 + warp * 16 + g, wr0 + warp * 16 + g + 8};
  const long long row_at = static_cast<long long>(bh) * p.sq;
  const float scale2 = p.scale * kLog2e;
  float lse[2], dsum[2] = {0.0f, 0.0f};  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) lse[r] = pos[r] < p.sq ? p.lse[row_at + pos[r]] * kLog2e : 0.0f;
  // [live_lo, live_hi): the warpgroup's tiles, one run of the block's n_tiles
  // (offsets from tile_lo); the others pass through the ring untouched
  int live_lo = n_tiles, live_hi = n_tiles;
  for (int t = 0; t < n_tiles && wr0 < p.sq; ++t) {
    if (!hidden(wr0, wr0 + 63, (tile_lo + t) * kBc, (tile_lo + t) * kBc + kBc - 1, p.causal,
                p.window)) {
      live_lo = min(live_lo, t);
      live_hi = t + 1;
    }
  }
  // the ring's items: sweep 1 takes tile t as item t, sweep 2 as item
  // n_tiles + t, or as item t again where the tiles stay resident
  auto item = [&](int sweep, int t) { return sweep == 0 || resident ? t : n_tiles + t; };
  auto take = [&](int sweep, int t) {
    if (sweep == 0 || !resident) {
      const int it = item(sweep, t);
      mbar_wait(&full[it % kStagesA], (it / kStagesA) & 1);
    }
  };
  auto give = [&](int sweep, int t) {
    if (!resident) mbar_arrive(&empty[item(sweep, t) % kStagesA]);
  };
  auto pass = [&](int sweep, int t0, int t1) {
    for (int t = t0; t < t1; ++t) {
      take(sweep, t);
      give(sweep, t);
    }
  };
  // S = Q K^T and dP = dO V^T of tile t, issued as one group
  auto issue = [&](int sweep, int t, float (&s)[kBc / 2], float (&dp)[kBc / 2]) {
    const int st = item(sweep, t) % kStagesA;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kHDP / 16; ++kk) {
      wgmma_ss<kBc>(s, QT::k_desc(qs, wg * 64, kk), KT::k_desc(ks + st * KT::kElems, 0, kk),
                    kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kHDP / 16; ++kk) {
      wgmma_ss<kBc>(dp, QT::k_desc(dos, wg * 64, kk), KT::k_desc(vs + st * KT::kElems, 0, kk),
                    kk > 0);
    }
    wg_commit();
  };
  // every key of tile t visible to every row of the warpgroup
  auto whole = [&](int t) {
    const int j0 = (tile_lo + t) * kBc;
    return j0 + kBc <= p.skv && (!p.causal || j0 + kBc - 1 <= wr0) &&
           (p.window <= 0 || j0 > wr0 + 63 - p.window);
  };
  auto visible_at = [&](int t, int e) {
    const int key = (tile_lo + t) * kBc + 8 * (e / 4) + 2 * t4 + e % 2;
    return key < p.skv && visible(pos[(e / 2) % 2], key, p.causal, p.window);
  };
  float s[kBc / 2], dp[kBc / 2];

  // sweep 1: D = sum_j P bf16(dP), each lane's terms in key order
  mbar_wait(q_full, 0);
  pass(0, 0, live_lo);
  for (int t = live_lo; t < live_hi; ++t) {
    take(0, t);
    issue(0, t, s, dp);
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);
    give(0, t);
    const bool all = whole(t);
#pragma unroll
    for (int e = 0; e < kBc / 2; ++e) {
      const int r = (e / 2) % 2;
      const float term = exp2f(round_bf16(s[e]) * scale2 - lse[r]) * round_bf16(dp[e]);
      dsum[r] += all || visible_at(t, e) ? term : 0.0f;
    }
  }
  pass(0, live_hi, n_tiles);
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float d = dsum[r];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    delta[r] = d;
    if (t4 == 0 && pos[r] < p.sq) {
      const long long at = static_cast<long long>(bh) * p.sq_pad + pos[r];
      p.rows[at] = lse[r];
      p.rows[static_cast<long long>(p.b) * p.nq * p.sq_pad + at] = d;
    }
  }

  // sweep 2: dQ += dS' K, dS' = bf16(P (bf16(dP) - D) scale) from registers
  float dq[kNO][kW / 2];
#pragma unroll
  for (int c = 0; c < kNO; ++c) {
#pragma unroll
    for (int e = 0; e < kW / 2; ++e) dq[c][e] = 0.0f;
  }
  pass(1, 0, live_lo);
  for (int t = live_lo; t < live_hi; ++t) {
    take(1, t);
    issue(1, t, s, dp);
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool all = whole(t);
#pragma unroll
    for (int e = 0; e < kBc / 2; ++e) {
      const int r = (e / 2) % 2;
      const float pv = exp2f(round_bf16(s[e]) * scale2 - lse[r]);
      s[e] = all || visible_at(t, e) ? pv * (round_bf16(dp[e]) - delta[r]) * p.scale : 0.0f;
    }
    uint32_t da[kBc / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) frag_a(da[kk], s, kk);
    const bf16* kb = ks + item(1, t) % kStagesA * KT::kElems;
#pragma unroll
    for (int c = 0; c < kNO; ++c) fence_regs(dq[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < kNO; ++c) {
        wgmma_rs<kW>(dq[c], da[kk], KT::mn_desc(kb, kk, c * kW), 1);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < kNO; ++c) fence_regs(dq[c]);
    give(1, t);
  }
  pass(1, live_hi, n_tiles);

  const long long q_stride = static_cast<long long>(p.nq) * p.hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] >= p.sq) continue;
    bf16* row = p.dq + (static_cast<long long>(bi) * p.sq + pos[r]) * q_stride +
                static_cast<long long>(h) * p.hd;
#pragma unroll
    for (int c = 0; c < kNO; ++c) {
#pragma unroll
      for (int e = 2 * r; e < kW / 2; e += 4) {
        const int col = c * kW + 8 * (e / 4) + 2 * t4;
        if (col < p.hd) *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(dq[c][e], dq[c][e + 1]);
      }
    }
  }
}

// ---- (b) the key-tile kernel: dK and dV ----

// keys a block of the key-tile kernel owns: 64 a consumer warpgroup, or 64
// in all where its two warpgroups split the columns
__host__ __device__ constexpr int key_rows(int wg, bool split_cols) {
  return split_cols ? 64 : 64 * wg;
}

// stages of Q, dO, lse and D that fit beside K and V, at most 4
template <int kHDP, int kSw, int kBr, int kWG, bool kSplitCols>
__host__ __device__ constexpr int key_stages() {
  constexpr int fit = (kSmemMax / blocks_per_sm<kWG, kHDP>() - 2048 -
                       2 * SwTile<kSw, key_rows(kWG, kSplitCols), kHDP>::kBytes) /
      (2 * SwTile<kSw, kBr, kHDP>::kBytes + 2 * kBr * 4);
  return fit < 4 ? fit : 4;
}

template <int kHDP, int kSw, int kBr, int kWG, bool kSplitCols>
__host__ __device__ constexpr int key_smem_bytes() {
  constexpr int stages = key_stages<kHDP, kSw, kBr, kWG, kSplitCols>();
  return 1024 + 2 * SwTile<kSw, key_rows(kWG, kSplitCols), kHDP>::kBytes +
         2 * stages * SwTile<kSw, kBr, kHDP>::kBytes + 2 * stages * kBr * 4 + 2 * stages * 8 + 8;
}

template <int kHDP, int kSw, int kBr, int kWG, bool kSplitCols>
__global__ void __launch_bounds__(128 * kWG + 128, (blocks_per_sm<kWG, kHDP>()))
flash_bwd_bf16_key_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  static_assert(!kSplitCols || kWG == 2, "the columns split over two warpgroups");
  constexpr int kConsumers = 128 * kWG;
  constexpr int kKeys = key_rows(kWG, kSplitCols);  // keys a block
  constexpr int kCols = kSplitCols ? 128 : kHDP;      // dK, dV columns a warpgroup
  using KT = SwTile<kSw, kKeys, kHDP>;
  using CT = SwTile<kSw, kBr, kHDP>;  // a chunk's Q or dO
  constexpr int kStagesB = key_stages<kHDP, kSw, kBr, kWG, kSplitCols>();
  unsigned char* base = align_1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(base);
  bf16* vs = ks + KT::kElems;
  bf16* qs = vs + KT::kElems;  // kStagesB chunks
  bf16* dos = qs + kStagesB * CT::kElems;
  float* lse_s = reinterpret_cast<float*>(dos + kStagesB * CT::kElems);  // kStagesB x kBr
  float* del_s = lse_s + kStagesB * kBr;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(del_s + kStagesB * kBr);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStagesB;

  const int hs = blockIdx.x % p.hsplit, bk = blockIdx.x / p.hsplit;
  const int bi = bk / p.nkv, kvh = bk % p.nkv;
  const int heads = p.nq / p.nkv / p.hsplit;  // the block's query heads
  const int head0 = (kvh * p.hsplit + hs) * heads;
  const int j0 = blockIdx.y * kKeys, nj = min(kKeys, p.skv - j0);
  int pos_lo, pos_hi;
  query_range(j0, nj, p.sq, p.causal, p.window, pos_lo, pos_hi);
  const int n_rc = pos_hi > pos_lo ? (pos_hi - pos_lo + kBr - 1) / kBr : 0;
  const int n_chunks = heads * n_rc;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: K and V, then the chunks
    producer_regs<kWG, kHDP>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&p.qb_map);
      tma_prefetch(&p.dob_map);
      tma_prefetch(&p.rows_map);
      mbar_expect_tx(kv_full, 2 * KT::kBytes);
      KT::load(ks, &p.kb_map, kv_full, kvh, j0, bi);
      KT::load(vs, &p.vb_map, kv_full, kvh, j0, bi);
      for (int c = 0; c < n_chunks; ++c) {
        const int st = c % kStagesB, use = c / kStagesB;
        const int h = head0 + c / n_rc, r0 = pos_lo + (c % n_rc) * kBr;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        mbar_expect_tx(&full[st], 2 * CT::kBytes + 2 * kBr * 4);
        CT::load(qs + st * CT::kElems, &p.qb_map, &full[st], h, r0, bi);
        CT::load(dos + st * CT::kElems, &p.dob_map, &full[st], h, r0, bi);
        const int row = bi * p.nq + h;
        tma_load_2d(lse_s + st * kBr, &p.rows_map, &full[st], r0, row);
        tma_load_2d(del_s + st * kBr, &p.rows_map, &full[st], r0, p.b * p.nq + row);
      }
    }
    return;
  }

  consumer_regs<kWG, kHDP>();
  const float scale2 = p.scale * kLog2e;
  const int wg = warpgroup_index(), warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int kw = kSplitCols ? 0 : wg * 64;   // the warpgroup's first key in the block
  const int col0 = kSplitCols ? wg * 128 : 0;  // and its first column of dK, dV
  const int wj0 = j0 + kw;
  const int key[2] = {wj0 + warp * 16 + g, wj0 + warp * 16 + g + 8};
  float dk[kCols / 2], dv[kCols / 2];
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) dk[e] = dv[e] = 0.0f;
  mbar_wait(kv_full, 0);

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStagesB, r0 = pos_lo + (c % n_rc) * kBr;
    mbar_wait(&full[st], (c / kStagesB) & 1);
    if (wj0 < p.skv && !hidden(r0, r0 + kBr - 1, wj0, wj0 + 63, p.causal, p.window)) {
      const bf16* qb = qs + st * CT::kElems;
      const bf16* dob = dos + st * CT::kElems;
      const float* lse_b = lse_s + st * kBr;
      const float* del_b = del_s + st * kBr;
      float s[kBr / 2], dp[kBr / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHDP / 16; ++kk) {
        wgmma_ss<kBr>(s, KT::k_desc(ks, kw, kk), CT::k_desc(qb, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kHDP / 16; ++kk) {
        wgmma_ss<kBr>(dp, KT::k_desc(vs, kw, kk), CT::k_desc(dob, 0, kk), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P^T in s, dS'^T in dp: element e is key key[(e / 2) % 2], query
      // row r0 + 8 (e / 4) + 2 t4 + e % 2
      const bool all = r0 + kBr <= p.sq && wj0 + 64 <= p.skv &&
                       (!p.causal || wj0 + 63 <= r0) &&
                       (p.window <= 0 || wj0 > r0 + kBr - 1 - p.window);
#pragma unroll
      for (int e = 0; e < kBr / 2; ++e) {
        const int i = 8 * (e / 4) + 2 * t4 + e % 2, kpos = key[(e / 2) % 2];
        const bool ok = all || (r0 + i < p.sq && kpos < p.skv &&
                                visible(r0 + i, kpos, p.causal, p.window));
        const float pv = ok ? exp2f(round_bf16(s[e]) * scale2 - lse_b[i]) : 0.0f;
        s[e] = pv;
        dp[e] = ok ? pv * (round_bf16(dp[e]) - del_b[i]) * p.scale : 0.0f;
      }
      uint32_t pa[kBr / 16][4], da[kBr / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBr / 16; ++kk) {
        frag_a(pa[kk], s, kk);
        frag_a(da[kk], dp, kk);
      }
      fence_regs(dv);
      fence_regs(dk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBr / 16; ++kk) {
        wgmma_rs<kCols>(dv, pa[kk], CT::mn_desc(dob, kk, col0), 1);
        wgmma_rs<kCols>(dk, da[kk], CT::mn_desc(qb, kk, col0), 1);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(&empty[st]);
  }

  // dK, dV of the block's keys, or this split's part of them
  const long long kv_stride = static_cast<long long>(p.nkv) * p.hd;
  const long long kv_total = static_cast<long long>(p.b) * p.skv * kv_stride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.skv) continue;
    const long long at0 = (static_cast<long long>(bi) * p.skv + key[r]) * kv_stride +
                          static_cast<long long>(kvh) * p.hd;
#pragma unroll
    for (int e = 2 * r; e < kCols / 2; e += 4) {
      const int col = col0 + 8 * (e / 4) + 2 * t4;
      if (col >= p.hd) continue;
      const long long at = at0 + col;
      if (p.hsplit == 1) {
        *reinterpret_cast<uint32_t*>(p.dk + at) = pack_bf16(dk[e], dk[e + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + at) = pack_bf16(dv[e], dv[e + 1]);
      } else {
        *reinterpret_cast<float2*>(p.dkv_part + hs * kv_total + at) = make_float2(dk[e], dk[e + 1]);
        *reinterpret_cast<float2*>(p.dkv_part + (p.hsplit + hs) * kv_total + at) =
            make_float2(dv[e], dv[e + 1]);
      }
    }
  }
}

// dk, dv = the head splits' partials, added in split order and rounded
__global__ void __launch_bounds__(256)
flash_bwd_bf16_dkv_sum_kernel(const __grid_constant__ BwdParams p) {
  const long long total = static_cast<long long>(p.b) * p.skv * p.nkv * p.hd;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  float dk = 0.0f, dv = 0.0f;
  for (int i = 0; i < p.hsplit; ++i) {
    dk += p.dkv_part[i * total + e];
    dv += p.dkv_part[(p.hsplit + i) * total + e];
  }
  p.dk[e] = __float2bfloat16(dk);
  p.dv[e] = __float2bfloat16(dv);
}

// kernels the entry below has launched in this process: its callers read
// it around a call to count the call's kernels (chip_smoke.py)
std::atomic<long long> launched{0};

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// kHDP: the head (hd rounded up to 16), kSw the tiles' swizzle; (a) kBc-key
// tiles over kWG warpgroups of 64 rows; (b) chunks of kBr rows, kSplitCols
// at hd 256
template <int kHDP, int kSw, int kBc, int kWG, int kBr, int kWGB, bool kSplitCols>
int launch_as(const void* q, const void* k, const void* v, const void* dout, BwdParams& p,
              cudaStream_t stream) {
  constexpr int smem_a = query_smem_bytes<kHDP, kSw, kBc, kWG>();
  constexpr int smem_b = key_smem_bytes<kHDP, kSw, kBr, kWGB, kSplitCols>();
  constexpr int kRows = 64 * kWG, kKeys = key_rows(kWGB, kSplitCols);
  // Raised once per instantiation.
  static const cudaError_t raised_a =
      raise_smem(flash_bwd_bf16_query_kernel<kHDP, kSw, kBc, kWG>, smem_a);
  static const cudaError_t raised_b =
      raise_smem(flash_bwd_bf16_key_kernel<kHDP, kSw, kBr, kWGB, kSplitCols>, smem_b);
  if (raised_a != cudaSuccess) return static_cast<int>(raised_a);
  if (raised_b != cudaSuccess) return static_cast<int>(raised_b);
  if (!head_map(&p.qa_map, q, p.b, p.sq, p.nq, p.hd, kRows, kSw) ||
      !head_map(&p.doa_map, dout, p.b, p.sq, p.nq, p.hd, kRows, kSw) ||
      !head_map(&p.ka_map, k, p.b, p.skv, p.nkv, p.hd, kBc, kSw) ||
      !head_map(&p.va_map, v, p.b, p.skv, p.nkv, p.hd, kBc, kSw) ||
      !head_map(&p.qb_map, q, p.b, p.sq, p.nq, p.hd, kBr, kSw) ||
      !head_map(&p.dob_map, dout, p.b, p.sq, p.nq, p.hd, kBr, kSw) ||
      !head_map(&p.kb_map, k, p.b, p.skv, p.nkv, p.hd, kKeys, kSw) ||
      !head_map(&p.vb_map, v, p.b, p.skv, p.nkv, p.hd, kKeys, kSw) ||
      !row_map(&p.rows_map, p.rows, 2 * p.b * p.nq, p.sq, p.sq_pad, kBr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_bwd_bf16_query_kernel<kHDP, kSw, kBc, kWG>
      <<<dim3((p.sq + kRows - 1) / kRows, p.b * p.nq), 128 * kWG + 128, smem_a, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++launched;
  flash_bwd_bf16_key_kernel<kHDP, kSw, kBr, kWGB, kSplitCols>
      <<<dim3(p.b * p.nkv * p.hsplit, (p.skv + kKeys - 1) / kKeys), 128 * kWGB + 128, smem_b,
         stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++launched;
  if (p.hsplit > 1) {
    const long long kv_total = static_cast<long long>(p.b) * p.skv * p.nkv * p.hd;
    flash_bwd_bf16_dkv_sum_kernel<<<static_cast<unsigned>((kv_total + 255) / 256), 256, 0,
                                    stream>>>(p);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++launched;
  }
  return static_cast<int>(e);
}

}  // namespace

// The kernels flash_attention_bwd_bf16 has launched in this process.
extern "C" long long flash_attention_bwd_bf16_kernels() { return launched; }

// q, k, v, dout (bf16), lse (fp32); rows (scratch, (2, b, nq, sq_pad) fp32,
// sq_pad = sq rounded up to 4); dkv_part (scratch, 2 x hsplit x (b, skv,
// nkv, hd) fp32, or null when hsplit is 1); dq, dk, dv (bf16); b, sq, skv,
// nq, nkv, hd; causal, window; hsplit, which divides nq / nkv; scale;
// stream. All contiguous in the layouts above, hd a multiple of 8, bases
// 16-byte aligned (flash_attention/ops.py pads and copies to meet it).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, void* rows,
                                        void* dkv_part, void* dq, void* dk, void* dv, int b,
                                        int sq, int skv, int nq, int nkv, int hd, int causal,
                                        int window, int hsplit, float scale, void* stream) {
  if (b < 0 || sq < 0 || skv < 0 || hd < 8 || hd > 256 || hd % 8 != 0 || nkv < 1 || nq < 1 ||
      nq % nkv != 0 || hsplit < 1 || (nq / nkv) % hsplit != 0 ||
      (hsplit > 1 && dkv_part == nullptr) || (skv + 63) / 64 > 65535 ||
      static_cast<long long>(b) * nkv * hsplit > 0x7fffffffLL ||
      static_cast<long long>(b) * nq > 65535 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(rows) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0 || skv == 0) return static_cast<int>(cudaSuccess);
  BwdParams p{};
  p.lse = static_cast<const float*>(lse);
  p.rows = static_cast<float*>(rows);
  p.dkv_part = static_cast<float*>(dkv_part);
  p.dq = static_cast<bf16*>(dq), p.dk = static_cast<bf16*>(dk), p.dv = static_cast<bf16*>(dv);
  p.b = b, p.sq = sq, p.skv = skv, p.nq = nq, p.nkv = nkv, p.hd = hd;
  p.causal = causal, p.window = window, p.hsplit = hsplit, p.sq_pad = (sq + 3) / 4 * 4;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // up to 64 rows and keys: blocks of one consumer warpgroup, two an SM,
  // fill the card (flash_attention/ops.py's bwd_bf16_plan mirrors this)
  const bool small = sq <= 64 && skv <= 64;
  if (hd <= 64) {
    return small ? launch_as<64, 128, 64, 1, 32, 1, false>(q, k, v, dout, p, st)
                 : launch_as<64, 128, 64, 3, 32, 3, false>(q, k, v, dout, p, st);
  }
  if (hd <= 80) {
    return small ? launch_as<80, 32, 64, 1, 32, 1, false>(q, k, v, dout, p, st)
                 : launch_as<80, 32, 64, 3, 32, 3, false>(q, k, v, dout, p, st);
  }
  if (hd <= 96) {
    return small ? launch_as<96, 64, 64, 1, 32, 1, false>(q, k, v, dout, p, st)
                 : launch_as<96, 64, 64, 3, 32, 2, false>(q, k, v, dout, p, st);
  }
  if (hd <= 128) {
    return small ? launch_as<128, 128, 64, 1, 32, 1, false>(q, k, v, dout, p, st)
                 : launch_as<128, 128, 64, 2, 32, 2, false>(q, k, v, dout, p, st);
  }
  return launch_as<256, 128, 32, 1, 32, 2, true>(q, k, v, dout, p, st);
}
