// Flash attention's training forward for Hopper (sm_90a), fp32, over a
// full sequence (query i at position i, key j at position j): causal and
// sliding-window masks, grouped and multi-query heads (query head h reads
// kv head h / (nq / nkv)), any sequence length, hd up to 256. It writes
// out = acc / max(l, 1e-30) and each row's log-sum-exp of its scaled
// scores, lse = M + log(L), which flash_attention_bwd.cu reads to recompute
// the probabilities as exp(score * scale - lse).
//
// No TPU kernel: the JAX package trains through its jnp attention
// (src/repro/models/attention.py:97 sdpa), which XLA runs and
// differentiates; flash_attention.cu replaces the Pallas forward
// (src/repro/kernels/flash_attention/flash_attention.py:111) for serving.
// The plain version is kernels/flash_attention/ref.py:
// flash_attention_train_ref; its split_tf32=True form computes the two
// products as this kernel does.
//
// Layout: q and out (b, sq, nq, hd), k and v (b, skv, nkv, hd), all
// contiguous fp32; lse (b, nq, sq) fp32.
//
// What bounds it: at StableLM-3B's training shape (batch 8, seq 64, 32
// heads of 80, causal) it must read q, k, v and write out and lse, 21 MB,
// 0.0063 ms at 3.35 TB/s; its two products over the causal half are
// 0.17 GFLOP, 0.0025 ms at 67 TFLOP/s fp32. So memory.
//
// Design, FlashAttention-2's on mma.sync: one block of 4 warps owns kBr
// query rows of one (batch, head), 64 rows (32 at hd 256, where shared
// memory binds) in a grid of (row tiles, b * nq), and walks the key tiles
// of kBc keys that any of its rows sees, skipping those the masks hide.
// - Q arrives once, K and V tile by tile, by 16-byte cp.async (plain loads
//   when a row is not 16-byte aligned), rows padded with zeros to the
//   instance's head width (64, 80, 96, 128 or 256), so every loop over the
//   head has a fixed count; past one key tile into a double buffer, so the
//   next tile's copies fly while this one computes.
// - Each warp owns 16 query rows (at hd 256 two warps share them, each
//   owning half of O's columns and both computing the same scores). S = Q
//   K^T for its rows runs on the tensor cores, with no branch between the
//   8-key tiles' products (on the causal diagonal, the half the masks hide
//   from all 16 rows is skipped); the online softmax stays in registers: a row's
//   max over its 4 lanes by two shuffles, the correction exp(m_old - m_new)
//   applied to O and to the lane's partial sum of p.
// - O += P V on the tensor cores with P straight from S's registers (the
//   k index taken in pairs, mma_tf32.cuh's frag_a_acc), never through
//   shared memory.
// - The end: each row's sum over its 4 lanes, out = O * 1 / max(l,
//   1e-30), lse = m + log(l).
// Both products in mma_tf32.cuh's 3xTF32, which keeps fp32's 2e-5 parity
// with the plain version. No atomics and sums in a fixed order: two
// launches give the same bits.
//
// Tiles: hd <= 128 takes kBr = 64 rows and kBc = 64 keys, hd <= 256 kBr =
// 32 and kBc = 32. Shared memory: Q and one or two buffers of K and V,
// rows of the instance's width plus 4 floats (the fragments' loads then
// hit 32 banks): one key tile at hd 80, 63 KB (three blocks an SM); two at
// hd 128, 165 KB; at hd 256, 163 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps

struct TrainParams {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
  int b, sq, skv, nq, nkv, hd, causal, window;
  int vec;  // rows 16-byte aligned: cp.async
  float scale;
};

// a row of Q, K or V in shared memory: the instance's head width (zeros past
// hd) and 4 floats, so a fragment's loads hit 32 banks
__host__ __device__ constexpr int row_ld(int width) { return width + 4; }

// Q, then `stages` buffers of K and of V
__host__ __device__ constexpr int smem_floats(int br, int bc, int stages, int width) {
  return (br + 2 * stages * bc) * row_ld(width);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// no query position of [q0, q1] sees any key of [k0, k1]
__device__ __forceinline__ bool hidden(int q0, int q1, int k0, int k1, int causal, int window) {
  return (causal && k0 > q1) || (window > 0 && k1 <= q0 - window);
}

// n rows of a (rows, heads, hd) layout from element offset `first` with
// row stride `stride`, into rows of ld floats (zeros past hd, up to width,
// and past n, up to `rows`): 16-byte cp.async when the rows are aligned,
// else plain loads.
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long first,
                                          long long stride, int hd, int width, int n, int rows,
                                          int ld, bool vec) {
  const int n4 = width / 4;
  if (vec) {
    for (int i = threadIdx.x; i < rows * n4; i += kThreads) {
      const int r = i / n4, c = (i - r * n4) * 4;
      const bool ok = r < n && c < hd;
      cp_async16(dst + r * ld + c, ok ? src + first + r * stride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n4 * 4; i += kThreads) {
      const int r = i / (n4 * 4), c = i - r * n4 * 4;
      dst[r * ld + c] = r < n && c < hd ? src[first + r * stride + c] : 0.0f;
    }
  }
}

// S += Q K^T for the warp's 16 rows and its first N 8-key tiles, over kK
// 8-wide steps of the head
template <int N, int kNS, int kK>
__device__ __forceinline__ void score_tiles(float (&s)[kNS][4], const float* qa, const float* kb,
                                            int ld, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const FragA aq = frag_a(qa + kk * 8, ld, g, t4);
    FragB bk[N];
#pragma unroll
    for (int i = 0; i < N; ++i) bk[i] = frag_b_t(kb + i * 8 * ld + kk * 8, ld, g, t4);
    mma3_n(s, aq, bk);
  }
}

// One (batch, head) x kBr query rows: their out and lse. kWC warps share
// a row tile of 16, each owning kHDP / kWC of O's columns; the head is
// padded with zeros to kHDP in shared memory.
template <int kHDP, int kBr, int kBc>
__global__ void __launch_bounds__(kThreads) flash_train_kernel(const TrainParams p, int stages) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWC = kThreads / 32 / (kBr / 16);  // warps a row tile
  constexpr int kNT = kHDP / 8 / kWC;              // O's 8-column tiles a warp owns
  constexpr int kNS = kBc / 8;                     // 8-key tiles of S
  constexpr int ld = row_ld(kHDP), kK = kHDP / 8;
  const int hd = p.hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int rw = warp / kWC, cw = warp % kWC;
  float* qs = smem;
  float* ks = qs + kBr * ld;
  float* vs = ks + stages * kBc * ld;

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
    load_rows(ks + buf * kBc * ld, p.k, first, kv_stride, hd, kHDP, nj, kBc, ld, vec);
    load_rows(vs + buf * kBc * ld, p.v, first, kv_stride, hd, kHDP, nj, kBc, ld, vec);
  };
  load_rows(qs, p.q, q0, q_stride, hd, kHDP, nr, kBr, ld, vec);
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
    const float* kb = ks + buf * kBc * ld;
    const float* vb = vs + buf * kBc * ld;
    const int j0 = tile * kBc;

    // S for the warp's 16 rows: no branch between the tiles' products, the
    // first half of the tile's keys alone where the masks hide the rest
    // from these rows (the causal diagonal), else all of them (the masks
    // below clear what they hide)
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
    const float* qa = qs + rw * 16 * ld;
    if (high) {
      score_tiles<kNS, kNS, kK>(s, qa, kb, ld, g, t4);
    } else if (low) {
      score_tiles<kNS / 2, kNS, kK>(s, qa, kb, ld, g, t4);
    }

    // online softmax: scale, mask, the rows' new max over their 4 lanes
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * i + 2 * t4 + (e & 1);
        const bool ok = live[i] && key < p.skv && visible(pos[e / 2], key, p.causal, p.window);
        s[i][e] = ok ? s[i][e] * p.scale : -INFINITY;
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

    // O += P V, P from the registers of S
#pragma unroll
    for (int kk = 0; kk < kNS; ++kk) {
      if (!live[kk]) continue;
      const FragA ap = frag_a_acc(s[kk]);
      FragB bv[kNT];
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        bv[i] = frag_b_pairs(vb + kk * 8 * ld + (cw * kNT + i) * 8, ld, g, t4);
      }
      mma3_n(o, ap, bv);
    }
    __syncthreads();  // the buffer is free for the tile after next
  }
  cp_async_wait_all();

  float* ob = p.out + q0;
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
      if (col < hd) ob[row * q_stride + col] = o[i][2 * r] * inv;
      if (col + 1 < hd) ob[row * q_stride + col + 1] = o[i][2 * r + 1] * inv;
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
      cudaFuncSetAttribute(flash_train_kernel<kHDP, kBr, kBc>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_floats(kBr, kBc, 2, kHDP) * 4);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int stages = p.skv > kBc ? 2 : 1;
  const dim3 grid((p.sq + kBr - 1) / kBr, p.b * p.nq);
  flash_train_kernel<kHDP, kBr, kBc>
      <<<grid, kThreads, smem_floats(kBr, kBc, stages, kHDP) * 4, stream>>>(p, stages);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// q, k, v, out, lse; b, sq, skv, nq, nkv, hd; causal, window; scale;
// stream. All fp32 and contiguous in the layouts above; every query row
// must see a key (flash_attention/ops.py checks it).
extern "C" int flash_attention_train_f32(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int b, int sq, int skv, int nq, int nkv,
                                         int hd, int causal, int window, float scale,
                                         void* stream) {
  if (b < 0 || sq < 0 || skv < 0 || hd < 1 || hd > 256 || nkv < 1 || nq < 1 || nq % nkv != 0 ||
      static_cast<long long>(b) * nq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0) return static_cast<int>(cudaSuccess);
  const bool vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const TrainParams p{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(out),
                      static_cast<float*>(lse), b, sq, skv, nq, nkv, hd, causal, window,
                      vec ? 1 : 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_as<64, 64, 64>(p, st);
  if (hd <= 80) return launch_as<80, 64, 64>(p, st);
  if (hd <= 96) return launch_as<96, 64, 64>(p, st);
  if (hd <= 128) return launch_as<128, 64, 64>(p, st);
  return launch_as<256, 32, 32>(p, st);
}
