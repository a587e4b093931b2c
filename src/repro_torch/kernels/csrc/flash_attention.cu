// Flash attention for Hopper (sm_90a), shaped for decode and short
// prefill: fp32 or bf16 in, fp32 math.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel
// (pl.pallas_call at :111) and computes what it computes: causal and
// sliding-window masks, query head h reading kv head h / (nq / nkv), keys at
// or past kv_len masked, scores = (q . k) * (1 / sqrt(hd)), a softmax in
// fp32 with p cast to the input dtype before p . v, and
// out = acc / max(l, 1e-30). Two runtime arguments go beyond the Pallas
// kernel, whose kv_len is static and whose queries start at position 0:
// query row i sits at position q_offset + i, and kv_len says how many keys
// of the cache are real. With both, one kernel serves a full sequence, a
// block prefill into the KV cache, and a one-token decode step whose query
// sits at pos over a cache holding pos + 1 real keys out of max_seq. The
// block reads both once, at its start.
//
// Layout: q (b, sq, nq, hd), k and v (b, skv, nkv, hd), each read through
// its (batch, seq, head) strides with a contiguous head_dim, so the KV cache
// is read where it lies; out is a fresh contiguous (b, sq, nq, hd).
//
// What bounds it: at the served shapes (StableLM-3B: nq = nkv = 32,
// hd = 80, a 128-long cache) a decode step reads 2 * kv_len * 32 * 80 * 4
// bytes of keys and values, 20 KB per cached token, and does about
// 4 * kv_len * 32 * 80 operations: well under a microsecond of either on an
// H100. RecurrentGemma-9B's local attention (16 query heads of 256 over one
// kv head) reads 2 KB per cached token. So a launch is bound by its serial
// latency: one round trip to memory, the scoring chain, the combine.
//
// Design.
// - One block owns one (batch, kv head) and a tile of kR query rows that
//   read it: a row is one query position and one of the G = nq / nkv heads
//   of the group, rows ordered position-major, so RecurrentGemma-9B's 16
//   heads of one decode step are one tile and K and V are read once per kv
//   head. Tiles hold 1, 2, 4, 8 or 16 rows (kR): a call of up to 16 rows
//   takes the largest that divides them, so its tiles are full and a
//   decode step of StableLM-3B scores one row, not sixteen; a longer call
//   takes 16, and its last tile's row loops stop at the real rows.
// - The block's keys, [lo, hi) = the union of what its rows can see, are
//   split over a thread-block cluster of `split` blocks when long, and each
//   block's share over its 4 warps, in contiguous ranges. A warp walks its
//   range in rounds of kKeys = 4 keys: lanes 8j .. 8j + 7 score key j
//   against every row, each over every eighth 4-wide chunk of the head,
//   and sum with three shuffles. The scores go through shared memory to
//   lane r, which runs row r's online softmax (its running max and sum live
//   in lane r) and leaves the row's p and correction there; every lane then
//   accumulates p . v of every row for its own chunks of the head (lane,
//   lane + 32) in registers. Where every tile of the launch is full (kFull),
//   the row loops have constant bounds and the rows' chains interleave.
// - Loads in flight: the q rows are loaded first, into registers; then
//   each warp fills a ring of kStages rounds of K and V in shared memory by
//   16-byte cp.async copies (a row that is not 16-byte aligned, or a head
//   dim that does not fill 16-byte copies, takes plain loads into the same
//   layout), so the next rounds' keys are on their way while a round is
//   scored. At hd = 256 and 16 rows the block takes 149 KB of dynamic
//   shared memory, which the launch raises with cudaFuncSetAttribute.
// - Combine: every warp leaves a partial (m, l, acc) for every row in its
//   shared memory. A row's partial from a range that was empty, or fully
//   masked for that row, has m = -inf, l = 0, acc = 0 (masked scores never
//   enter a sum, unlike the Pallas kernel's -1e30 that a later visible key
//   wipes out). Block `rank` of the cluster finishes rows rank, rank +
//   split, ..: lane s of a warp takes partial s (blocks, then warps) and
//   shuffle trees give M = max of the partials' m, the weights exp(m_s - M)
//   (0 for m_s = -inf) and L = sum w l; out = (sum w acc) * (1 / max(L,
//   1e-30)), the sum over the partials in order, read through distributed
//   shared memory from the other blocks. No atomics: two launches give the
//   same bits.
// No tensor cores and no TF32: at these shapes a launch is bound by its
// latency, not by its products. The training forward, which writes each
// row's log-sum-exp, is flash_attention_train.cu.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kParts = 8;                     // lanes that share one key's dot product
constexpr int kKeys = 32 / kParts;            // keys a warp scores in one round
constexpr int kStages = 4;                    // rounds of K and V in flight per warp
constexpr int kMaxSplit = 8;                  // blocks of a cluster (the portable limit)
static_assert(kWarps * kMaxSplit <= 32, "a row's partials are one a lane");
constexpr unsigned kAll = 0xffffffffu;  // every lane of a warp
static_assert(kKeys == 4, "a round's scores of a row are one float4");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, nq, nkv, hd, hd4;  // hd4: hd rounded up to 4, the row length in shared memory
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window, q_offset, n_keys;
  int split;  // blocks of a cluster over one tile's keys
  int vec;    // K and V rows take 16-byte cp.async copies
  int qvec;   // q rows take 4-element loads
  float scale;
};

// Byte offsets of the block's dynamic shared memory.
struct Layout {
  int q_off, warp_off, warp_bytes, scores_off, total;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
// A warp's scores of a round (rows x kKeys, later its p) and each row's
// correction, a multiple of 4 floats so that every warp's rows stay
// 16-byte aligned.
__host__ __device__ constexpr int score_floats(int rows) { return rows * kKeys + (rows + 3) / 4 * 4; }

__host__ __device__ inline Layout layout(int rows, int hd4, int itemsize) {
  Layout L{};
  L.q_off = align16(rows * 8);  // each row's visible keys [lo, hi) first
  L.warp_off = L.q_off + align16(rows * hd4 * 4);
  const int stages = kStages * 2 * kKeys * hd4 * itemsize;  // K and V of kStages rounds
  const int partial = (rows * hd4 + 2 * rows) * 4;          // acc, m, l after the walk
  L.warp_bytes = align16(stages > partial ? stages : partial);
  L.scores_off = L.warp_off + kWarps * L.warp_bytes;
  L.total = L.scores_off + kWarps * score_floats(rows) * 4;
  return L;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// p.astype(v.dtype) of the Pallas kernel, kept in fp32 registers.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Four consecutive elements of shared memory as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// a * x + y, elementwise
__device__ __forceinline__ float4 fma4(float a, const float4& x, const float4& y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The cluster's barrier: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kR query rows per block; kC 4-wide chunks of the head per lane in p . v
// (hd <= 128 * kC); kFull: every tile of the launch holds kR rows, so the
// row loops have no bounds to test.
template <typename T, int kR, int kC, bool kFull>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRW = (kR + kWarps - 1) / kWarps;  // rows a warp stages and finishes
  const int hd = p.hd, hd4 = p.hd4, n4 = hd4 / 4;
  const Layout lay = layout(kR, hd4, sizeof(T));
  int2* bounds = reinterpret_cast<int2*>(smem);  // row r sees keys [x, y)
  float* qs = reinterpret_cast<float*>(smem + lay.q_off);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned char* region = smem + lay.warp_off + warp * lay.warp_bytes;
  // the warp's scores of a round (kR x kKeys), overwritten by its p, then
  // each row's correction of the running sums
  float* sc = reinterpret_cast<float*>(smem + lay.scores_off) + warp * score_floats(kR);
  float* corr_s = sc + kR * kKeys;

  // Which rows and keys: the positions are read once, here.
  const int q_offset = p.q_offset, n_keys = p.n_keys, window = p.window, causal = p.causal;
  const int group = p.nq / p.nkv, split = p.split;
  const int rank = blockIdx.x % split;
  const int bk = blockIdx.x / split;
  const int bi = bk / p.nkv, kvh = bk - bi * p.nkv;
  const int tile0 = blockIdx.y * kR;
  const int nrows = kFull ? kR : min(kR, p.sq * group - tile0);
  // The tile's keys: the first row's window start to the last row's causal
  // limit; then this block's share of them, then this warp's (specified,
  // for the CPU tests, by flash_attention/ops.py:tile_keys and split_keys).
  const int pos_first = q_offset + tile0 / group;
  const int pos_last = q_offset + (tile0 + nrows - 1) / group;
  const int t_lo = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int t_hi = causal ? min(n_keys, pos_last + 1) : n_keys;
  const int per_block = (max(t_hi - t_lo, 0) + split - 1) / split;
  const int b_lo = min(t_hi, t_lo + rank * per_block), b_hi = min(t_hi, b_lo + per_block);
  const int per_warp = (b_hi - b_lo + kWarps - 1) / kWarps;
  const int w_lo = min(b_hi, b_lo + warp * per_warp), w_hi = min(b_hi, w_lo + per_warp);
  const int rounds = (w_hi - w_lo + kKeys - 1) / kKeys;

  // The q rows first: warp w loads rows w, w + 4, .., lane l chunks
  // l, l + 32 of each, all in flight while the K and V copies are issued.
  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb;
  float4 qv[kRW][kC];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int r = warp + rr * kWarps, row = tile0 + r, qi = row / group;
    const T* src = qb + qi * p.q_ss + (kvh * group + row - qi * group) * p.q_sh;
#pragma unroll
    for (int c4 = 0; c4 < kC; ++c4) {
      const int c = lane + 32 * c4;
      qv[rr][c4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < nrows && c < n4) {
        if (p.qvec) {
          qv[rr][c4] = load4(src + 4 * c);
        } else {
          float e[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) e[x] = 4 * c + x < hd ? to_f32(src[4 * c + x]) : 0.0f;
          qv[rr][c4] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
    }
  }

  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  // Round rnd's keys w_lo + kKeys * rnd .. into ring slot rnd % kStages:
  // K rows, then V rows, hd4 elements each.
  auto load_round = [&](int rnd) {
    T* ks = reinterpret_cast<T*>(region) + (rnd % kStages) * 2 * kKeys * hd4;
    T* vs = ks + kKeys * hd4;
    const int key0 = w_lo + rnd * kKeys, n = min(kKeys, w_hi - key0);
    for (int j = 0; j < n; ++j) {
      const T* ksrc = kb + (key0 + j) * p.k_ss;
      const T* vsrc = vb + (key0 + j) * p.v_ss;
      if (p.vec) {
        constexpr int kE = 16 / sizeof(T);  // elements of one copy
        for (int c = lane; c < hd / kE; c += 32) {
          cp_async16(ks + j * hd4 + c * kE, ksrc + c * kE);
          cp_async16(vs + j * hd4 + c * kE, vsrc + c * kE);
        }
      } else {
        for (int d = lane; d < hd4; d += 32) {
          ks[j * hd4 + d] = d < hd ? ksrc[d] : from_f32<T>(0.0f);
          vs[j * hd4 + d] = d < hd ? vsrc[d] : from_f32<T>(0.0f);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < rounds) load_round(s);
    cp_async_commit();
  }

  // While the first rounds land: the q rows into shared memory as fp32
  // (zero past hd), and every row's visible keys.
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int r = warp + rr * kWarps;
#pragma unroll
    for (int c4 = 0; c4 < kC; ++c4) {
      const int c = lane + 32 * c4;
      if (r < nrows && c < n4) *reinterpret_cast<float4*>(qs + r * hd4 + 4 * c) = qv[rr][c4];
    }
  }
  for (int r = tid; r < nrows; r += kThreads) {
    const int pos = q_offset + (tile0 + r) / group;
    bounds[r] = make_int2(window > 0 ? max(0, pos - window + 1) : 0,
                          causal ? min(n_keys, pos + 1) : n_keys);
  }
  __syncthreads();

  // Lane r keeps row r's running max and sum; every lane keeps p . v of
  // every row for its chunks lane + 32 c of the head.
  float m_run = -INFINITY, l_run = 0.0f;
  float4 acc[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int kj = lane / kParts, part = lane % kParts;  // the key and the chunks a lane scores

  for (int rnd = 0; rnd < rounds; ++rnd) {
    if (rnd + kStages - 1 < rounds) load_round(rnd + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies (or stores) of this round are in
    const T* ks = reinterpret_cast<const T*>(region) + (rnd % kStages) * 2 * kKeys * hd4;
    const T* vs = ks + kKeys * hd4;
    const int key0 = w_lo + rnd * kKeys, nvalid = min(kKeys, w_hi - key0);

    float s[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = 0.0f;
    if (kj < nvalid) {
      for (int c = part; c < n4; c += kParts) {
        const float4 kk = load4(ks + kj * hd4 + 4 * c);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < nrows) {
            const float4 qq = load4(qs + r * hd4 + 4 * c);
            s[r] = fmaf(qq.x, kk.x, s[r]);
            s[r] = fmaf(qq.y, kk.y, s[r]);
            s[r] = fmaf(qq.z, kk.z, s[r]);
            s[r] = fmaf(qq.w, kk.w, s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < nrows) {
        float t = s[r];
        t += __shfl_xor_sync(kAll, t, 1);
        t += __shfl_xor_sync(kAll, t, 2);
        t += __shfl_xor_sync(kAll, t, 4);
        if (part == 0) sc[r * kKeys + kj] = t;
      }
    }
    float4 vv[kKeys][kC];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int cc = lane + 32 * c;
        vv[j][c] = j < nvalid && cc < n4 ? load4(vs + j * hd4 + 4 * cc)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    __syncwarp();  // the round's scores are in sc

    // Lane r runs row r's online softmax over the round's keys (masked
    // keys never enter it; a round with none visible leaves the row as it
    // was) and leaves the row's p, in v's dtype, and its correction.
    if (lane < nrows) {
      float4* row_p = reinterpret_cast<float4*>(sc + lane * kKeys);
      const float4 s4 = *row_p;
      const int2 seen = bounds[lane];
      float x[kKeys], tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = key0 + j;
        const bool visible = j < nvalid && key >= seen.x && key < seen.y;
        x[j] = visible ? at(s4, j) * p.scale : -INFINITY;
        tile_max = fmaxf(tile_max, x[j]);
      }
      const bool hit = tile_max != -INFINITY;
      const float m_new = hit ? fmaxf(m_run, tile_max) : m_run;
      const float corr = hit ? expf(m_run - m_new) : 1.0f;  // 0 while the row has seen nothing
      float p_sum = 0.0f, pc[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pj = hit ? expf(x[j] - m_new) : 0.0f;  // 0 for a masked key
        p_sum += pj;
        pc[j] = round_to<T>(pj);
      }
      m_run = m_new;
      l_run = l_run * corr + p_sum;
      *row_p = make_float4(pc[0], pc[1], pc[2], pc[3]);
      corr_s[lane] = corr;
    }
    __syncwarp();  // every row's p and correction are in

#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < nrows) {
        const float4 pr = *reinterpret_cast<const float4*>(sc + r * kKeys);
        const float corr = corr_s[r];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          float4 a = make_float4(acc[r][c].x * corr, acc[r][c].y * corr, acc[r][c].z * corr,
                                 acc[r][c].w * corr);
          a = fma4(pr.x, vv[0][c], a);
          a = fma4(pr.y, vv[1][c], a);
          a = fma4(pr.z, vv[2][c], a);
          a = fma4(pr.w, vv[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();  // the ring slot and sc are consumed before they are refilled
  }
  cp_async_wait<0>();
  __syncwarp();

  // The warp's partial over the ring's bytes: acc (kR x hd4), m, l.
  float* pacc = reinterpret_cast<float*>(region);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= nrows) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int cc = lane + 32 * c;
      if (cc < n4) *reinterpret_cast<float4*>(pacc + r * hd4 + 4 * cc) = acc[r][c];
    }
  }
  if (lane < nrows) {
    pacc[kR * hd4 + lane] = m_run;
    pacc[kR * hd4 + kR + lane] = l_run;
  }
  if (split > 1) {
    cluster_sync();  // every block's partials are written
  } else {
    __syncthreads();
  }

  // Rows rank, rank + split, .. of the tile; warp w finishes the block's
  // rows w, w + 4, .., all of them side by side. Lane s holds partial s
  // (blocks, then warps, in order; split * kWarps <= 32 of them): the
  // partials' max m by a shuffle tree, the weights, the sum of w l by a
  // shuffle tree; then lane l sums the head's chunks l, l + 32 partial by
  // partial.
  const int n_src = split * kWarps;
  const int mine = nrows > rank ? (nrows - rank + split - 1) / split : 0;
  auto source = [&](int s) -> const float* {
    const int c = s / kWarps, w = s - c * kWarps;
    float* local = reinterpret_cast<float*>(smem + lay.warp_off + w * lay.warp_bytes);
    if (split == 1) return local;
    return cg::this_cluster().map_shared_rank(local, c);
  };
  float m_s[kRW], l_s[kRW];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int i = warp + rr * kWarps;
    m_s[rr] = -INFINITY;
    l_s[rr] = 0.0f;
    if (i < mine && lane < n_src) {
      const float* src = source(lane);
      m_s[rr] = src[kR * hd4 + rank + i * split];
      l_s[rr] = src[kR * hd4 + kR + rank + i * split];
    }
  }
  // The trees span lanes 0 .. the power of two at or above n_src (the
  // lanes past n_src hold m = -inf and l = 0), and lane 0's sum goes to
  // every lane. A row's output is its sum times 1 / max(l, 1e-30): one
  // division a row.
  float w[kRW], inv[kRW];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    float m_max = m_s[rr];
    for (int off = 1; off < n_src; off <<= 1) m_max = fmaxf(m_max, __shfl_xor_sync(kAll, m_max, off));
    w[rr] = m_s[rr] == -INFINITY ? 0.0f : expf(m_s[rr] - m_max);
    float l_sum = w[rr] * l_s[rr];
    for (int off = 1; off < n_src; off <<= 1) l_sum += __shfl_xor_sync(kAll, l_sum, off);
    const float total = __shfl_sync(kAll, l_sum, 0);
    inv[rr] = 1.0f / fmaxf(total, 1e-30f);
  }
  float4 o[kRW][kC];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
#pragma unroll
    for (int c4 = 0; c4 < kC; ++c4) o[rr][c4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int s = 0; s < n_src; ++s) {
    const float* src = source(s);
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr) {
      const int i = warp + rr * kWarps;
      const float ws = __shfl_sync(kAll, w[rr], s);
#pragma unroll
      for (int c4 = 0; c4 < kC; ++c4) {
        const int c = lane + 32 * c4;
        if (i < mine && c < n4) {
          o[rr][c4] = fma4(ws, load4(src + (rank + i * split) * hd4 + 4 * c), o[rr][c4]);
        }
      }
    }
  }
  T* ob = static_cast<T*>(p.out);
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int i = warp + rr * kWarps;
    if (i >= mine) break;
    const int qrow = tile0 + rank + i * split, qi = qrow / group;
    const int head = kvh * group + qrow - qi * group;
    T* dst = ob + ((static_cast<long long>(bi) * p.sq + qi) * p.nq + head) * hd;
#pragma unroll
    for (int c4 = 0; c4 < kC; ++c4) {
      const int c = lane + 32 * c4;
      if (c >= n4) break;
      const float4 v = o[rr][c4];
      const float ov[4] = {v.x * inv[rr], v.y * inv[rr], v.z * inv[rr], v.w * inv[rr]};
      if (hd % 4 == 0) {
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(ov[0], ov[1], ov[2], ov[3]);
        } else {
          uint2 raw;
          T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
          for (int x = 0; x < 4; ++x) e[x] = from_f32<T>(ov[x]);
          *reinterpret_cast<uint2*>(dst + 4 * c) = raw;
        }
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (4 * c + x < hd) dst[4 * c + x] = from_f32<T>(ov[x]);
        }
      }
    }
  }
  if (split > 1) cluster_sync();  // no block leaves while its partials are read
}

template <typename T, int kR, int kC, bool kFull>
int launch_as(const Params& p, int b, int tiles, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, kR, kC, kFull>;
  // Raised once per instantiation, to what its widest head needs.
  static const cudaError_t raised = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, layout(kR, 128 * kC, sizeof(T)).total);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * p.nkv * p.split, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = layout(kR, p.hd4, sizeof(T)).total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kC>
int launch_rows(const Params& p, int b, int rows, int tiles, cudaStream_t stream) {
  const bool full = static_cast<long long>(p.sq) * (p.nq / p.nkv) % rows == 0;
  // A call of at most 16 rows comes in full tiles (ops.py:plan); only
  // 16-row tiles of a longer call may end in a partial one.
  if (rows < 16 && !full) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 1: return launch_as<T, 1, kC, true>(p, b, tiles, stream);
    case 2: return launch_as<T, 2, kC, true>(p, b, tiles, stream);
    case 4: return launch_as<T, 4, kC, true>(p, b, tiles, stream);
    case 8: return launch_as<T, 8, kC, true>(p, b, tiles, stream);
    case 16:
      return full ? launch_as<T, 16, kC, true>(p, b, tiles, stream)
                  : launch_as<T, 16, kC, false>(p, b, tiles, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

#define FLASH_ARGS                                                                        \
  const void *q, const void *k, const void *v, void *out, int b, int sq, int skv, int nq, \
      int nkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,    \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,     \
      int causal, int window, int q_offset, int kv_len, int rows, int split, float scale, \
      void *stream
#define FLASH_PASS                                                                       \
  q, k, v, out, b, sq, skv, nq, nkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, \
      v_sh, causal, window, q_offset, kv_len, rows, split, scale, stream

namespace {

template <typename T>
int launch(FLASH_ARGS) {
  if (hd < 1 || hd > 256 || nkv < 1 || nq % nkv != 0 || split < 1 || split > kMaxSplit ||
      kv_len < 0 || kv_len > skv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0 || nq == 0) return static_cast<int>(cudaSuccess);
  const long long tiles = (static_cast<long long>(sq) * (nq / nkv) + rows - 1) / rows;
  if (rows < 1 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kE = 16 / sizeof(T);
  const long long e16 = kE;
  const bool vec = hd % kE == 0 && aligned16(k) && aligned16(v) && k_sb % e16 == 0 &&
                   k_ss % e16 == 0 && k_sh % e16 == 0 && v_sb % e16 == 0 && v_ss % e16 == 0 &&
                   v_sh % e16 == 0;
  const bool qvec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % (4 * sizeof(T)) == 0 &&
                    q_sb % 4 == 0 && q_ss % 4 == 0 && q_sh % 4 == 0;
  const Params p{q, k, v, out, sq, nq, nkv, hd, (hd + 3) / 4 * 4,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 causal, window, q_offset, kv_len, split, vec ? 1 : 0, qvec ? 1 : 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 128 ? launch_rows<T, 1>(p, b, rows, static_cast<int>(tiles), st)
                   : launch_rows<T, 2>(p, b, rows, static_cast<int>(tiles), st);
}

}  // namespace

// q, k, v, out; b, sq, skv, nq, nkv, hd; (batch, seq, head) strides of q, k
// and v in elements; causal, window, q_offset, kv_len (<= skv); rows a block
// owns (1, 2, 4, 8 or 16) and blocks of a cluster over a tile's keys (1-8), as
// flash_attention/ops.py:plan gives them; scale; stream
extern "C" int flash_attention_f32(FLASH_ARGS) { return launch<float>(FLASH_PASS); }

extern "C" int flash_attention_bf16(FLASH_ARGS) { return launch<__nv_bfloat16>(FLASH_PASS); }
