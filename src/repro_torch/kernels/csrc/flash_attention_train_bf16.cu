// Flash attention's training forward for Hopper (sm_90a), bf16, over a
// full sequence (query i at position i, key j at position j): causal and
// sliding-window masks, grouped and multi-query heads (query head h reads
// kv head h / (nq / nkv)), any sequence length, hd up to 256. It writes
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
// contiguous bf16; lse (b, nq, sq) fp32.
//
// What bounds it: at StableLM-3B's train_4k microbatch (batch 8, seq 4096,
// 32 heads of 80, causal) its two products over the causal half are
// 6.9e11 FLOP, 0.70 ms at 989 TFLOP/s bf16; q, k, v and out are 0.67 GB,
// 0.20 ms at 3.35 TB/s. So the tensor cores.
//
// Design, flash_attention_train.cu's on bf16 operands: one block of 4 warps
// owns kBr query rows of one (batch, head), 64 rows (32 at hd 256) in a
// grid of (row tiles, b * nq), and walks the key tiles of kBc keys that
// any of its rows sees, skipping those the masks hide.
// - Q arrives once, K and V tile by tile, by 16-byte cp.async (8 bf16 a
//   copy; plain loads when a row is not 16-byte aligned), rows padded with
//   zeros to the instance's head width (64, 80, 96, 128 or 256) and then
//   by 8 more values, so ldmatrix's 8 row addresses fall in 8 different
//   16-byte bank groups; past one key tile into a double buffer.
// - Each warp owns 16 query rows (at hd 256 two warps share them, each
//   owning half of O's columns). S = Q K^T on mma.sync m16n8k16 (bf16 in,
//   fp32 sums), its fragments from ldmatrix.x4; each score rounded to
//   bf16, as the reference's einsum returns it (src/repro/models/
//   attention.py:113), then the online softmax in fp32 registers as the
//   fp32 kernel's.
// - O += P V with P rounded to bf16 straight from S's registers (two
//   8-key accumulator tiles make one 16-key A fragment, cvt.rn.bf16x2) and
//   V's fragments from ldmatrix.x4.trans. This is where the reference
//   rounds its probabilities to the input dtype.
// - The end: each row's sum over its 4 lanes, out = O / max(l, 1e-30)
//   rounded to bf16, lse = m + log(l) in fp32.
// No atomics and sums in a fixed order: two launches give the same bits.
//
// Tiles: hd <= 128 takes kBr = 64 rows and kBc = 64 keys, hd 256 kBr = 32
// and kBc = 32. Shared memory, bf16: Q and one or two buffers of K and V,
// rows of the instance's width plus 8: at hd 80 with two key tiles 56 KB,
// hd 128 87 KB, hd 256 84 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "flash_masks.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps

struct TrainParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;
  int b, sq, skv, nq, nkv, hd, causal, window;
  int vec;  // rows 16-byte aligned: cp.async
  float scale;
};

// a row of Q, K or V in shared memory: the instance's head width (zeros
// past hd) and 8 values, so ldmatrix's 8 rows hit 8 bank groups
__host__ __device__ constexpr int row_ld(int width) { return width + 8; }

// Q, then `stages` buffers of K and of V, in bf16 values
__host__ __device__ constexpr int smem_elems(int br, int bc, int stages, int width) {
  return (br + 2 * stages * bc) * row_ld(width);
}

// One (batch, head) x kBr query rows: their out and lse. kWC warps share
// a row tile of 16, each owning kHDP / kWC of O's columns; the head is
// padded with zeros to kHDP in shared memory.
template <int kHDP, int kBr, int kBc>
__global__ void __launch_bounds__(kThreads) flash_train_bf16_kernel(const TrainParams p,
                                                                    int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kWC = kThreads / 32 / (kBr / 16);  // warps a row tile
  constexpr int kNT = kHDP / 8 / kWC;              // O's 8-column tiles a warp owns
  constexpr int kNS = kBc / 8;                     // 8-key tiles of S
  constexpr int ld = row_ld(kHDP), kK = kHDP / 16;
  static_assert(kNT % 2 == 0 && kNS % 4 == 0 && kHDP % 16 == 0, "tile shapes");
  const int hd = p.hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int rw = warp / kWC, cw = warp % kWC;
  bf16* qs = smem;
  bf16* ks = qs + kBr * ld;
  bf16* vs = ks + stages * kBc * ld;

  const int bi = blockIdx.y / p.nq, h = blockIdx.y % p.nq, kvh = h / (p.nq / p.nkv);
  const int r0 = blockIdx.x * kBr, nr = min(kBr, p.sq - r0);
  // [lo, hi): the keys any row of the block sees, in whole key tiles
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
    load_rows<kThreads>(ks + buf * kBc * ld, p.k, first, kv_stride, hd, kHDP, nj, kBc, ld, vec);
    load_rows<kThreads>(vs + buf * kBc * ld, p.v, first, kv_stride, hd, kHDP, nj, kBc, ld, vec);
  };
  load_rows<kThreads>(qs, p.q, q0, q_stride, hd, kHDP, nr, kBr, ld, vec);
  if (tile_lo < tile_hi) load_tile(tile_lo, 0);
  cp_async_commit();

  // the warp's rows g and g + 8 of its 16: running max, the lane's partial sum
  const int row0 = r0 + rw * 16;
  const int pos[2] = {row0 + g, row0 + g + 8};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float o[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
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

    // S for the warp's 16 rows: the first half of the tile's keys alone
    // where the masks hide the rest from these rows (the causal diagonal),
    // else all of them (the masks below clear what they hide)
    float s[kNS][4];
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
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
    }
    const bf16* qa = qs + rw * 16 * ld;
    if (high) {
      score_tiles<kNS, kNS, kK>(s, qa, kb, ld, lane);
    } else if (low) {
      score_tiles<kNS / 2, kNS, kK>(s, qa, kb, ld, lane);
    }

    // online softmax: round to bf16 (the reference's bf16 scores), scale,
    // mask, the rows' new max over their 4 lanes
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * i + 2 * t4 + (e & 1);
        const bool ok = live[i] && key < p.skv && visible(pos[e / 2], key, p.causal, p.window);
        s[i][e] = ok ? round_bf16(s[i][e]) * p.scale : -INFINITY;
        m_new[e / 2] = fmaxf(m_new[e / 2], s[i][e]);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      const float corr = m_run[r] == -INFINITY ? 0.0f : expf(m_run[r] - m_new[r]);
      base[r] = m_new[r] == -INFINITY ? 0.0f : m_new[r];
      l_run[r] *= corr;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        o[i][2 * r] *= corr;
        o[i][2 * r + 1] *= corr;
      }
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = expf(s[i][e] - base[e / 2]);
        l_run[e / 2] += s[i][e];
      }
    }

    // O += P V over 16-key steps, P in bf16 from the registers of S
#pragma unroll
    for (int kk = 0; kk < kNS / 2; ++kk) {
      if (!live[2 * kk] && !live[2 * kk + 1]) continue;
      uint32_t ap[4];
      frag_a_acc(ap, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < kNT; i += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, x4_rows_a(vb + kk * 16 * ld + (cw * kNT + i) * 8, ld, lane));
        const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
        mma_bf16(o[i], ap, b0);
        mma_bf16(o[i + 1], ap, b1);
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
  }
  cp_async_wait_all();

  bf16* ob = p.out + q0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = rw * 16 + g + 8 * r;
    if (row >= nr) continue;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int col = (cw * kNT + i) * 8 + 2 * t4;
      if (col < hd) ob[row * q_stride + col] = __float2bfloat16(o[i][2 * r] * inv);
      if (col + 1 < hd) ob[row * q_stride + col + 1] = __float2bfloat16(o[i][2 * r + 1] * inv);
    }
    if (cw == 0 && t4 == 0) {
      p.lse[(static_cast<long long>(bi) * p.nq + h) * p.sq + r0 + row] = m_run[r] + logf(l);
    }
  }
}

template <int kHDP, int kBr, int kBc>
int launch_as(const TrainParams& p, cudaStream_t stream) {
  // Raised once per instantiation, to what its widest head needs.
  static const cudaError_t raised =
      cudaFuncSetAttribute(flash_train_bf16_kernel<kHDP, kBr, kBc>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_elems(kBr, kBc, 2, kHDP) * 2);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int stages = p.skv > kBc ? 2 : 1;
  const dim3 grid((p.sq + kBr - 1) / kBr, p.b * p.nq);
  flash_train_bf16_kernel<kHDP, kBr, kBc>
      <<<grid, kThreads, smem_elems(kBr, kBc, stages, kHDP) * 2, stream>>>(p, stages);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// q, k, v, out (bf16), lse (fp32); b, sq, skv, nq, nkv, hd; causal, window;
// scale; stream. Contiguous in the layouts above; every query row must see
// a key (flash_attention/ops.py checks it).
extern "C" int flash_attention_train_bf16(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int b, int sq, int skv, int nq, int nkv,
                                          int hd, int causal, int window, float scale,
                                          void* stream) {
  if (b < 0 || sq < 0 || skv < 0 || hd < 1 || hd > 256 || nkv < 1 || nq < 1 || nq % nkv != 0 ||
      static_cast<long long>(b) * nq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  const bool vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const TrainParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(out),
                      static_cast<float*>(lse), b, sq, skv, nq, nkv, hd, causal, window,
                      vec ? 1 : 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_as<64, 64, 64>(p, st);
  if (hd <= 80) return launch_as<80, 64, 64>(p, st);
  if (hd <= 96) return launch_as<96, 64, 64>(p, st);
  if (hd <= 128) return launch_as<128, 64, 64>(p, st);
  return launch_as<256, 32, 32>(p, st);
}
