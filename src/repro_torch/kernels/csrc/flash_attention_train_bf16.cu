// Flash attention's training forward for Hopper (sm_90a), bf16, over a
// full sequence (query i at position i, key j at position j): causal and
// sliding-window masks, grouped and multi-query heads (query head h reads
// kv head h / (nq / nkv)), any sequence length, hd a multiple of 8 up to
// 256 (flash_attention/ops.py pads any other hd with zeros). It writes
// out = acc / max(l, 1e-30) in bf16 and each row's log-sum-exp of its
// scaled scores in fp32, lse = M + log(L), which flash_attention_bwd_bf16.cu
// reads to recompute the probabilities as exp(score * scale - lse).
//
// No TPU kernel: the JAX package trains through its jnp attention
// (src/repro/models/attention.py:97 sdpa, :132 chunked_sdpa), which XLA runs
// and differentiates; flash_attention.cu replaces the Pallas forward
// (src/repro/kernels/flash_attention/flash_attention.py:111) for serving.
// This is the bf16 twin of flash_attention_train.cu (fp32). The plain
// version is kernels/flash_attention/ref.py: flash_attention_train_ref with
// bf16 inputs.
//
// Layout: q and out (b, sq, nq, hd), k and v (b, skv, nkv, hd), all
// contiguous bf16 from 16-byte-aligned bases; lse (b, nq, sq) fp32.
//
// What bounds it: at StableLM-3B's train_4k microbatch (batch 8, seq 4096,
// 32 heads of 80, causal) its two products over the causal half are
// 6.9e11 FLOP, 0.70 ms at 989 TFLOP/s bf16; q, k, v and out are 0.67 GB,
// 0.20 ms at 3.35 TB/s. So the tensor cores, which only wgmma reaches. The
// design's own floor adds the masked half of each diagonal 64 x 64 tile of
// a warpgroup, under 2% more at 4,096 keys.
//
// Design, FlashAttention-3's shape without fp8 (hopper_bf16.cuh has the
// instructions, the shared-memory layout and the register split):
// - One block owns 64 kWG query rows of one (batch, head): kWG consumer
//   warpgroups of 64 rows each (three up to hd 128, two at hd 256) and one
//   producer warpgroup, whose registers go to the consumers by setmaxnreg.
//   Sequences of up to 64 rows take blocks of one consumer, two an SM, so
//   that 8 x 32 heads fill the card in one wave. Blocks of the last rows,
//   which see the most keys, start first.
// - The producer's one thread brings Q once and then the visible key tiles
//   of K and V (64 keys) by TMA into a ring of up to four stages (as many
//   as shared memory holds), each with a full and an empty mbarrier; tiles
//   the masks hide from all of the block's rows are never loaded, and a
//   warpgroup passes the tiles they hide from its own rows.
// - Each consumer warpgroup, per tile: S = Q K^T on wgmma (both operands in
//   shared memory), each score rounded to bf16 (the reference's einsum
//   returns bf16 scores, src/repro/models/attention.py:113), then the
//   online softmax in fp32 registers: masks on the tiles that need them,
//   the rows' max over their 4 lanes, P = exp(s - m) (as 2^(s log2 e -
//   m log2 e), one FFMA and ex2 a score). P is rounded to bf16 in registers
//   (where the reference rounds its probabilities) and is the A operand of
//   O += P V on wgmma, V read MN-major from the same tile. FlashAttention-3's
//   overlap: S of the next tile and P V of this one are in flight while the
//   softmax of the next runs; O is rescaled once P V is done.
// - The end: each row's sum over its 4 lanes, out = O / max(l, 1e-30)
//   rounded to bf16, lse = m + log(l) in fp32.
// No atomics and sums in a fixed order: two launches give the same bits.
//
// hd 80 (StableLM-3B, HuBERT): the 32-byte swizzle's 16-value column blocks
// take it unpadded, 5 of them (the 64- and 128-byte swizzles pad it to 96
// and 128 in shared memory and ran no faster, PERF.md). hd 256
// (RecurrentGemma-9B): O is 128 fp32 registers a thread, its product two
// wgmma of width 128, two warpgroups of 240 registers. Three warpgroups of
// 160 registers ran faster than two of 240 at hd 80 (PERF.md). Shared
// memory: hd 80 111 KB, hd 128 177 KB, hd 256 193 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"
#include "flash_masks.cuh"

namespace {

struct TrainParams {
  CUtensorMap q_map;  // boxes of (kSw / 2, 1, kBr, 1)
  CUtensorMap k_map;  // boxes of (kSw / 2, 1, kBc, 1)
  CUtensorMap v_map;
  bf16* out;
  float* lse;
  int b, sq, skv, nq, nkv, hd, causal, window;
  float scale;
};

// stages of K and V that fit beside Q in a block's shared memory, at most 4
template <int kHDP, int kSw, int kBc, int kWG>
__host__ __device__ constexpr int train_stages() {
  constexpr int fit = (kSmemMax / blocks_per_sm<kWG, kHDP>() - 2048 -
                       SwTile<kSw, 64 * kWG, kHDP>::kBytes) /
                      (2 * SwTile<kSw, kBc, kHDP>::kBytes);
  return fit < 4 ? fit : 4;
}

template <int kHDP, int kSw, int kBc, int kWG>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int stages = train_stages<kHDP, kSw, kBc, kWG>();
  return 1024 + SwTile<kSw, 64 * kWG, kHDP>::kBytes +
         2 * stages * SwTile<kSw, kBc, kHDP>::kBytes + (1 + 2 * stages) * 8;
}

// One (batch, head) x kBr query rows: their out and lse. kHDP is the
// instance's head (hd rounded up to 16; TMA's zeros past hd), kSw its
// tiles' swizzle, kBc the keys of a tile, kWG the consumer warpgroups.
template <int kHDP, int kSw, int kBc, int kWG>
__global__ void __launch_bounds__(128 * kWG + 128, (blocks_per_sm<kWG, kHDP>()))
flash_train_bf16_kernel(const __grid_constant__ TrainParams p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kBr = 64 * kWG, kConsumers = 128 * kWG;  // query rows, consumer threads
  using QT = SwTile<kSw, kBr, kHDP>;
  using KT = SwTile<kSw, kBc, kHDP>;
  constexpr int kStages = train_stages<kHDP, kSw, kBc, kWG>();
  constexpr int kW = kHDP > 128 ? 128 : kHDP;  // width of one P V product
  constexpr int kNO = kHDP / kW;                 // P V products a step
  unsigned char* base = align_1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = qs + QT::kElems;
  bf16* vs = ks + kStages * KT::kElems;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * KT::kElems);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bi = blockIdx.y / p.nq, h = blockIdx.y % p.nq, kvh = h / (p.nq / p.nkv);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBr, nr = min(kBr, p.sq - r0);
  // [lo, hi): the keys any row of the block sees, in whole key tiles
  const int lo = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv, r0 + nr) : p.skv;
  const int tile_lo = lo / kBc, tile_hi = hi > lo ? (hi + kBc - 1) / kBc : tile_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer
    producer_regs<kWG, kHDP>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&p.k_map);
      tma_prefetch(&p.v_map);
      mbar_expect_tx(q_full, QT::kBytes);
      QT::load(qs, &p.q_map, q_full, h, r0, bi);
      for (int tile = tile_lo, i = 0; tile < tile_hi; ++tile, ++i) {
        const int st = i % kStages, use = i / kStages;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        mbar_expect_tx(&full[st], 2 * KT::kBytes);
        KT::load(ks + st * KT::kElems, &p.k_map, &full[st], kvh, tile * kBc, bi);
        KT::load(vs + st * KT::kElems, &p.v_map, &full[st], kvh, tile * kBc, bi);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows wr0..wr0 + 63, its warp 16 of them,
  // this thread rows pos[0] and pos[1]; scores, the max and P in log2 units
  consumer_regs<kWG, kHDP>();
  const float scale2 = p.scale * kLog2e;
  const int wg = warpgroup_index(), warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr0 = r0 + wg * 64;
  const int pos[2] = {wr0 + warp * 16 + g, wr0 + warp * 16 + g + 8};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float o[kNO][kW / 2];
#pragma unroll
  for (int c = 0; c < kNO; ++c) {
#pragma unroll
    for (int e = 0; e < kW / 2; ++e) o[c][e] = 0.0f;
  }
  // [live_lo, live_hi): the tiles the masks leave to the warpgroup's rows,
  // one run of the block's; the others pass through the ring untouched
  int live_lo = tile_hi, live_hi = tile_hi;
  for (int tile = tile_lo; tile < tile_hi && wr0 < p.sq; ++tile) {
    if (!hidden(wr0, wr0 + 63, tile * kBc, tile * kBc + kBc - 1, p.causal, p.window)) {
      live_lo = min(live_lo, tile);
      live_hi = tile + 1;
    }
  }
  if (live_lo == tile_hi) live_hi = tile_hi;
  int i = 0;  // tiles taken from the ring
  auto pass = [&](int n) {
    for (; n > 0; --n, ++i) {
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      mbar_arrive(&empty[i % kStages]);
    }
  };
  // S = Q K^T of the stage's tile, issued
  auto scores = [&](float (&s)[kBc / 2], int st) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kHDP / 16; ++kk) {
      wgmma_ss<kBc>(s, QT::k_desc(qs, wg * 64, kk), KT::k_desc(ks + st * KT::kElems, 0, kk),
                    kk > 0);
    }
    wg_commit();
  };
  // O += P V of the stage's tile, issued; P from registers
  auto pv = [&](const uint32_t (&pa)[kBc / 16][4], int st) {
#pragma unroll
    for (int c = 0; c < kNO; ++c) fence_regs(o[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < kNO; ++c) {
        wgmma_rs<kW>(o[c], pa[kk], KT::mn_desc(vs + st * KT::kElems, kk, c * kW), 1);
      }
    }
    wg_commit();
  };
  // the online softmax of tile j0's scores: round to bf16 (the reference's
  // bf16 scores), scale, mask where the tile needs it, the rows' new max
  // over their 4 lanes, l rescaled and summed, P = exp in s; corr, the
  // factor O is to be rescaled by
  auto softmax = [&](float (&s)[kBc / 2], int j0, float (&corr)[2]) {
    const bool whole = j0 + kBc <= p.skv && (!p.causal || j0 + kBc - 1 <= wr0) &&
                       (p.window <= 0 || j0 > wr0 + 63 - p.window);
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int e = 0; e < kBc / 2; ++e) {
      const int r = (e / 2) % 2, key = j0 + 8 * (e / 4) + 2 * t4 + e % 2;
      const bool ok = whole || (key < p.skv && visible(pos[r], key, p.causal, p.window));
      s[e] = ok ? round_bf16(s[e]) * scale2 : -INFINITY;
      m_new[r] = fmaxf(m_new[r], s[e]);
    }
    float base_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      corr[r] = m_run[r] == -INFINITY ? 0.0f : exp2f(m_run[r] - m_new[r]);
      base_m[r] = m_new[r] == -INFINITY ? 0.0f : m_new[r];
      l_run[r] *= corr[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int e = 0; e < kBc / 2; ++e) {
      const int r = (e / 2) % 2;
      s[e] = exp2f(s[e] - base_m[r]);
      l_run[r] += s[e];
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int c = 0; c < kNO; ++c) {
#pragma unroll
      for (int e = 0; e < kW / 2; ++e) o[c][e] *= corr[(e / 2) % 2];
    }
  };
  // tile t of the run after its first, FlashAttention-3's overlap: S of t
  // is issued, then P V of the tile before (P in pa); the softmax of t runs
  // while P V does; then, P V done, its stage is released, O rescaled and
  // P of t rounded into pa
  float s[kBc / 2], corr[2];
  uint32_t pa[kBc / 16][4];
  mbar_wait(q_full, 0);
  pass(live_lo - tile_lo);
  if (live_lo < live_hi) {
    int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    scores(s, st);
    wg_wait_all();
    fence_regs(s);
    softmax(s, live_lo * kBc, corr);  // O is 0: nothing to rescale
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) frag_a(pa[kk], s, kk);
    ++i;
    for (int tile = live_lo + 1; tile < live_hi; ++tile, ++i) {
      const int prev = st;
      st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      scores(s, st);
      pv(pa, prev);
      wg_wait_one();
      fence_regs(s);
      softmax(s, tile * kBc, corr);
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < kNO; ++c) fence_regs(o[c]);
      mbar_arrive(&empty[prev]);
      rescale(corr);
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) frag_a(pa[kk], s, kk);
    }
    pv(pa, st);
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < kNO; ++c) fence_regs(o[c]);
    mbar_arrive(&empty[st]);
  }
  pass(tile_hi - live_hi);

  const long long q_stride = static_cast<long long>(p.nq) * p.hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (pos[r] >= p.sq) continue;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    bf16* orow = p.out + (static_cast<long long>(bi) * p.sq + pos[r]) * q_stride +
                 static_cast<long long>(h) * p.hd;
#pragma unroll
    for (int c = 0; c < kNO; ++c) {
#pragma unroll
      for (int e = 2 * r; e < kW / 2; e += 4) {
        const int col = c * kW + 8 * (e / 4) + 2 * t4;
        if (col < p.hd) {
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(o[c][e] * inv, o[c][e + 1] * inv);
        }
      }
    }
    if (t4 == 0) {
      p.lse[(static_cast<long long>(bi) * p.nq + h) * p.sq + pos[r]] = m_run[r] * kLn2 + logf(l);
    }
  }
}

template <int kHDP, int kSw, int kBc, int kWG>
int launch_as(const void* q, const void* k, const void* v, TrainParams& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<kHDP, kSw, kBc, kWG>();
  constexpr int kBr = 64 * kWG;
  // Raised once per instantiation.
  static const cudaError_t raised = cudaFuncSetAttribute(
      flash_train_bf16_kernel<kHDP, kSw, kBc, kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  if (!head_map(&p.q_map, q, p.b, p.sq, p.nq, p.hd, kBr, kSw) ||
      !head_map(&p.k_map, k, p.b, p.skv, p.nkv, p.hd, kBc, kSw) ||
      !head_map(&p.v_map, v, p.b, p.skv, p.nkv, p.hd, kBc, kSw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((p.sq + kBr - 1) / kBr, p.b * p.nq);
  flash_train_bf16_kernel<kHDP, kSw, kBc, kWG><<<grid, 128 * kWG + 128, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out (bf16), lse (fp32); b, sq, skv, nq, nkv, hd; causal, window;
// scale; stream. Contiguous in the layouts above, hd a multiple of 8, bases
// 16-byte aligned (flash_attention/ops.py pads and copies to meet it);
// every query row must see a key (ops.py checks it).
extern "C" int flash_attention_train_bf16(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int b, int sq, int skv, int nq, int nkv,
                                          int hd, int causal, int window, float scale,
                                          void* stream) {
  if (b < 0 || sq < 0 || skv < 0 || hd < 8 || hd > 256 || hd % 8 != 0 || nkv < 1 || nq < 1 ||
      nq % nkv != 0 || static_cast<long long>(b) * nq > 65535 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  TrainParams p{};
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.b = b, p.sq = sq, p.skv = skv, p.nq = nq, p.nkv = nkv, p.hd = hd;
  p.causal = causal, p.window = window, p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // up to 64 rows: 64-row blocks, two an SM, fill the card
  const bool small = sq <= 64;
  if (hd <= 64) {
    return small ? launch_as<64, 128, 64, 1>(q, k, v, p, st)
                 : launch_as<64, 128, 64, 3>(q, k, v, p, st);
  }
  if (hd <= 80) {
    return small ? launch_as<80, 32, 64, 1>(q, k, v, p, st)
                 : launch_as<80, 32, 64, 3>(q, k, v, p, st);
  }
  if (hd <= 96) {
    return small ? launch_as<96, 64, 64, 1>(q, k, v, p, st)
                 : launch_as<96, 64, 64, 3>(q, k, v, p, st);
  }
  if (hd <= 128) {
    return small ? launch_as<128, 128, 64, 1>(q, k, v, p, st)
                 : launch_as<128, 128, 64, 3>(q, k, v, p, st);
  }
  return launch_as<256, 128, 64, 2>(q, k, v, p, st);
}
