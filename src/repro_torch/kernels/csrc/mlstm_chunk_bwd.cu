// The backward of the chunkwise mLSTM for Hopper (sm_90a), fp32: the
// gradient of what mlstm_chunk_train.cu's forward computes, given the
// gradient of every h_t and of the returned state (C, n, m).
//
// No TPU kernel: the JAX package differentiates its recurrence with XLA
// (src/repro/models/xlstm.py:130 _mlstm_chunked, and the per-step scan
// below 128 tokens), and the Pallas kernel
// src/repro/kernels/mlstm_chunk/mlstm_chunk.py:32 _mlstm_chunk_kernel has
// no backward. The plain version is
// kernels/mlstm_chunk/ref.py:mlstm_chunk_bwd_ref, whose split_tf32=True
// form computes the products as these kernels do; the notation is its.
//
// Per chunk of L <= 64 steps from the input state (C_in, n_in, m_in), which
// the forward's training entry saved: b_t the cumulative log-sigmoid forget
// gate, x_j = i_j - b_j, r_t = max_{j<=t} x_j, m_t = max(b_t + m_in,
// r_t + b_t), inter_t = e^{b_t + m_in - m_t}, D_tj = e^{b_t - m_t + x_j}
// (j <= t), W = D * (Q K^T), den_t = inter_t q_t . n_in + sum_j W_tj,
// g_t = max(|den_t|, 1), h_t = (inter_t C_in q_t + sum_j W_tj v_j) / g_t,
// and C_out = s_out C_in + sum_j w_j v_j k_j^T (n_out likewise), with
// s_out = e^{b_L + m_in - m_out}, w_j = e^{b_L + x_j - m_out}. Backward:
//   dnum_t = dh_t / g_t, dden_t = -(dh_t . h_t) / g_t sign(den_t) [|den_t| >= 1]
//   dW = dnum V^T + dden (j <= t), dS = dW * D, P = dW * W
//   dC_in = s_out dC_out + sum_t (inter_t dnum_t) q_t^T      (a reverse recurrence)
//   dn_in = s_out dn_out + sum_t (inter_t dden_t) q_t
//   dq_t = C_in^T (inter_t dnum_t) + inter_t dden_t n_in + sum_j dS_tj k_j
//   dk_j = sum_t dS_tj q_t + w_j (dC_out^T v_j + dn_out)
//   dv_j = sum_t W_tj dnum_t + w_j dC_out k_j
// and the gates through the exponents and the maxima (a max's gradient
// split at a tie, the running max's to its latest index, as autograd does).
//
// Layout: q, k, v, h, dh, dq, dk, dv (b, s, H, dh) fp32 contiguous; gates
// and their gradients (b, s, H); the chunks' input states C_in (nC, b, H,
// dh, dh), n_in (nC, b, H, dh), m_in (nC, b, H); the incoming dC (b, H, dh,
// dh), dn (b, H, dh), dm (b, H), each may be null (zero); out dC, dn, dm of
// the first chunk's input state. A workspace (mlstm_chunk_bwd_workspace
// bytes) holds what one pass hands the next.
//
// What bounds it: per chunk and head, five products of L x dh x dh (q C,
// dC_in, dq, dk, dv) and four of L x L x dh, about 10 L dh^2 operations:
// at batch 8, seq 64 and xLSTM-1.3B's 4 heads of 512 about 5.5 GFLOP, 0.08
// ms at 67 TFLOP/s, against about 0.1 GB read and written. So the products,
// which run here on the tensor cores. On mma.sync every warp splits the
// fragments it reads into TF32 pairs, so the products pay in issue slots
// and shared-memory reads per mma: the products' blocks are 64 x 128 tiles
// of 32 x 32 a warp, two A and four B fragments feeding eight tiles.
//
// Five kernels, one launch of the entry; every product of L x dh x dh and
// L x L x dh on the tensor cores in mma_tf32.cuh's 3xTF32 (each k-step's
// three products issued for all of a warp's tiles with no branch between
// them, each added to the running sum in a rounded fp32 add), the operand
// tiles by 16-byte cp.async (plain loads where dh % 4 != 0), zeros past the
// chunk, past dh and above the diagonal:
// 1. slices: a block per (chunk, head, 64 columns of dh): its share of the
//    L x L scores Q K^T and dh V^T (a warp a 16-step row tile and four
//    8-step key tiles, none where all four lie above the diagonal; Q K^T
//    while dh and v land), of q . n_in and of dh . h (a warp's lanes across
//    the columns, a fixed xor tree), to the workspace.
// 2. gates: a block per (chunk, head) adds the slices' shares in slice
//    order, takes each step's log sigmoid(f_t) on a thread of its own, scans
//    the gates on one thread (fp64 sums, as the forward), then the
//    exponentials on a thread a step again; it writes W / g, dS, P's row
//    and column sums and the per-step scalars.
// 3. state: a block per (head, 64 x 64 tile of dC) keeps the tile as mma
//    accumulators and walks the chunks in reverse, each chunk's dh and q
//    landing in a double buffer while the one before is multiplied: it
//    writes each chunk's dC_out (the last chunk's is the incoming dC, read
//    where it lies) and adds (a o dh)^T Q over the chunk's steps; the tiles
//    of the first row also carry dn.
// 4. products: a block per (chunk, head, 128 columns, product): an L x 128
//    tile of q C_in^T (for d inter), dq, dv (with dC_out k, for dw) or dk:
//    a product over dh through a double buffer of 32-wide stages, then one
//    over the chunk's steps from the record's W / g or dS (a warp skips the
//    k-steps where its rows of W / g or dS lie above the diagonal); per-tile
//    partial sums for the scalars. A zero dC_out (the last chunk's, with no
//    dC in) skips its products.
// 5. scalars: a block per head, the chunks in reverse carrying dm: the
//    record's vectors, dn_out and n_in in shared memory, dn_out . k_j by
//    four threads a step, the partial sums added in order, each step's own
//    terms on a thread a step and the sums over steps on one thread, in
//    step order.
// fp64 for the gates' sums and the exponentials of the state's weights as
// in the forward. No atomics: every sum runs in one order, so two launches
// give the same bits.
//
// Shared memory: slices 68 KB (q, k, dh, v of 64 steps x 64 columns);
// gates 37 KB; state 75 KB (two chunks' dh and q); products 55 KB (two
// stages, or the chunk product's two tiles); scalars 13 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // time steps per chunk, as the forward
constexpr int kTile = 64;   // output tile: 64 rows x 64 columns; the slices' width
constexpr int kKS = 32;     // contraction elements a stage of the products' ring
constexpr int kLdK = kKS + 4;     // row stride of a [row][k] stage (frag_a, frag_b_t)
constexpr int kLdM = kTile + 4;   // row stride of a [row][k] 64-wide tile (frag_a, frag_b_t)
constexpr int kLdN = kTile + 8;   // row stride of a [k][column] 64-wide tile (frag_b, frag_a_t)
constexpr int kMat = kChunk * kChunk;

// Per-chunk scalars, kChunk floats each, in a record of the workspace.
enum Vec { kInter, kW, kShare, kRidx, kRowP, kColP, kDinter, kA, kE, kInvG, kNumVec };

struct Layout {  // offsets in floats into the workspace
  long long recs, tiles, wtiles;  // (chunk, head) records; 64-wide slices of dh; 128-wide tiles
  long long wg, ds;              // per record: W / g and dS (64 x 64)
  long long s_part, g_part;      // per record and slice: its share of Q K^T and dh V^T
  long long dco;                 // per record but the last chunk's: dC_out (dh x dh)
  long long vecs, scal;          // per record: the vectors; s_out and the share of m_out's max
  long long qn_part, hh_part;    // per record and slice: its share of q . n_in and dh . h
  long long p_inter, p_w, p_s;   // per record and tile: partial sums
  long long dno;                 // per record: dn_out (dh)
  long long total;
};

__host__ __device__ Layout layout(int b, int s, int H, int dh) {
  Layout l;
  const long long n_chunks = (s + kChunk - 1) / kChunk, bH = static_cast<long long>(b) * H;
  l.recs = n_chunks * bH;
  l.tiles = (dh + kTile - 1) / kTile;
  l.wtiles = (l.tiles + 1) / 2;
  l.wg = 0;
  l.ds = l.wg + l.recs * kMat;
  l.s_part = l.ds + l.recs * kMat;
  l.g_part = l.s_part + l.recs * l.tiles * kMat;
  l.dco = l.g_part + l.recs * l.tiles * kMat;
  l.vecs = l.dco + (n_chunks - 1) * bH * dh * dh;
  l.scal = l.vecs + l.recs * kNumVec * kChunk;
  l.qn_part = l.scal + l.recs * 2;
  l.hh_part = l.qn_part + l.recs * l.tiles * kChunk;
  l.p_inter = l.hh_part + l.recs * l.tiles * kChunk;
  l.p_w = l.p_inter + l.recs * l.wtiles * kChunk;
  l.p_s = l.p_w + l.recs * l.wtiles * kChunk;
  l.dno = l.p_s + l.recs * l.wtiles;
  l.total = l.dno + l.recs * dh;
  return l;
}

struct Args {
  // gh is the gradient of h
  const float *q, *k, *v, *ig, *fg, *c_in, *n_in, *m_in, *h, *gh, *dc, *dn, *dm;
  float *dq, *dk, *dv, *di, *df, *dc0, *dn0, *dm0;
  float* work;
  int b, s, H, dh;
  int vec;  // dh % 4 == 0 and the matrices 16-byte aligned: cp.async
};

__device__ __forceinline__ double log_sigmoid(double x) {
  return fmin(x, 0.0) - log1p(exp(-fabs(x)));
}

// Share of max(a, b)'s gradient that goes to a.
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// Where chunk c of head bh starts: the offset of its first step in the
// (b, s, H, dh) tensors (time stride H * dh) and in the gates (stride H).
struct Chunk {
  long long x0, g0, t_stride;
  int L;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a, int c, int bh) {
  const int bi = bh / a.H, hh = bh - bi * a.H;
  Chunk ch;
  ch.t_stride = static_cast<long long>(a.H) * a.dh;
  ch.x0 = (static_cast<long long>(bi) * a.s + static_cast<long long>(c) * kChunk) * ch.t_stride +
          static_cast<long long>(hh) * a.dh;
  ch.g0 = (static_cast<long long>(bi) * a.s + static_cast<long long>(c) * kChunk) * a.H + hh;
  ch.L = min(kChunk, a.s - c * kChunk);
  return ch;
}

// dC_out of chunk c of head bh: the incoming dC for the last chunk (null:
// zero), else the state pass's record
__device__ __forceinline__ const float* dc_out(const Args& a, const Layout& lay, int c, int bh) {
  const long long d2 = static_cast<long long>(a.dh) * a.dh;
  if (c == (a.s + kChunk - 1) / kChunk - 1) return a.dc != nullptr ? a.dc + bh * d2 : nullptr;
  return a.work + lay.dco + (static_cast<long long>(c) * a.b * a.H + bh) * d2;
}

// A matrix in device memory: element (r, c) at p[r * ld + c], zero past
// rows x cols
struct Mat {
  const float* p;
  long long ld;
  int rows, cols;
};

// Rows [r0, r0 + kR) and columns [c0, c0 + kC) of m into dst (row stride
// ld), zeros past m's edge: 16-byte cp.async when vec (m's rows are then
// 16-byte aligned and its columns a multiple of 4), else plain loads.
template <int kR, int kC>
__device__ __forceinline__ void stage(float* dst, int ld, const Mat& m, int r0, int c0, bool vec) {
  for (int i = threadIdx.x; i < kR * (kC / 4); i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4, gr = r0 + r, gc = c0 + c;
    float* to = dst + r * ld + c;
    if (vec) {
      const bool ok = gr < m.rows && gc < m.cols;
      cp_async16(to, ok ? m.p + gr * m.ld + gc : m.p, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        to[x] = gr < m.rows && gc + x < m.cols ? m.p[gr * m.ld + gc + x] : 0.0f;
      }
    }
  }
}

// A from a row-major array with its rows scaled: element (m, k) =
// s(m) p[m * ld + k], s0 for row g and s8 for row g + 8
__device__ __forceinline__ FragA frag_a_rows(const float* p, int ld, int g, int t, float s0,
                                             float s8) {
  FragA f;
  split(s0 * p[g * ld + t], f.hi[0], f.lo[0]);
  split(s8 * p[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split(s0 * p[g * ld + t + 4], f.hi[2], f.lo[2]);
  split(s8 * p[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// A from a column-major array with its columns scaled: element (m, k) =
// s(k) p[k * ld + m], st for column t and st4 for column t + 4
__device__ __forceinline__ FragA frag_a_t_cols(const float* p, int ld, int g, int t, float st,
                                               float st4) {
  FragA f;
  split(st * p[t * ld + g], f.hi[0], f.lo[0]);
  split(st * p[t * ld + g + 8], f.hi[1], f.lo[1]);
  split(st4 * p[(t + 4) * ld + g], f.hi[2], f.lo[2]);
  split(st4 * p[(t + 4) * ld + g + 8], f.hi[3], f.lo[3]);
  return f;
}

// Wait until at most N of the thread's cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }
}

// A 64 x 64 output tile over 8 warps: warp w owns the 16 rows from 16 (w % 4)
// and the four 8-column tiles from 4 (w / 4); its lane holds, of tile i,
// element e at row 16 (w % 4) + g + 8 (e / 2) and column 8 (4 (w / 4) + i) +
// 2 t + (e & 1) (g = lane / 4, t = lane % 4).
struct Lane {
  int g, t, mt, nb;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    g = lane / 4, t = lane % 4, mt = warp % 4, nb = warp / 4;
  }
  __device__ __forceinline__ int row(int e) const { return 16 * mt + g + 8 * (e / 2); }
  __device__ __forceinline__ int col(int i, int e) const { return 8 * (4 * nb + i) + 2 * t + (e & 1); }
};

// 1. slices: a (chunk, head, 64 columns)'s share of Q K^T, dh V^T, q . n_in
// and dh . h.
size_t slices_smem_bytes() { return sizeof(float) * 4 * kChunk * kLdM; }

__global__ void __launch_bounds__(kThreads) mlstm_bwd_slices_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // 64 steps x 64 columns each, row stride kLdM
  float* ks = qs + kChunk * kLdM;
  float* hs = ks + kChunk * kLdM;
  float* vs = hs + kChunk * kLdM;
  __shared__ float ns[kTile];
  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int rec = blockIdx.x, si = blockIdx.y, bH = a.b * a.H, d = a.dh;
  const int c = rec / bH, bh = rec - c * bH, col0 = si * kTile;
  const Chunk ch = chunk_of(a, c, bh);
  const int L = ch.L, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long T = ch.t_stride;
  const bool vec = a.vec != 0;
  // q and k, then dh and v, in two groups: Q K^T runs while dh and v land
  stage<kChunk, kTile>(qs, kLdM, Mat{a.q + ch.x0 + col0, T, L, d - col0}, 0, 0, vec);
  stage<kChunk, kTile>(ks, kLdM, Mat{a.k + ch.x0 + col0, T, L, d - col0}, 0, 0, vec);
  cp_async_commit();
  stage<kChunk, kTile>(hs, kLdM, Mat{a.gh + ch.x0 + col0, T, L, d - col0}, 0, 0, vec);
  stage<kChunk, kTile>(vs, kLdM, Mat{a.v + ch.x0 + col0, T, L, d - col0}, 0, 0, vec);
  cp_async_commit();
  if (tid < kTile) ns[tid] = col0 + tid < d ? a.n_in[static_cast<long long>(rec) * d + col0 + tid] : 0.0f;

  // the scores' shares: a warp's 16 steps x 32 keys of each, zeros where all
  // four key tiles lie above the diagonal or past the chunk
  {
    const Lane ln;
    const int nt0 = 4 * ln.nb;
    const bool live = 8 * nt0 < L && 8 * nt0 <= 16 * ln.mt + 15 && 16 * ln.mt < L;
    float sa[4][4], ga[4][4];
    zero(sa);
    zero(ga);
    // x += A B^T over the slice's 64 columns for the warp's tiles
    auto scores = [&](float (&x)[4][4], const float* A, const float* B) {
#pragma unroll
      for (int kk = 0; kk < kTile / 8; ++kk) {
        FragB b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = frag_b_t(B + 8 * (nt0 + i) * kLdM + 8 * kk, kLdM, ln.g, ln.t);
        mma3_n(x, frag_a(A + 16 * ln.mt * kLdM + 8 * kk, kLdM, ln.g, ln.t), b);
      }
    };
    cp_async_wait_one();
    __syncthreads();  // q and k are in
    if (live) scores(sa, qs, ks);
    cp_async_wait_all();
    __syncthreads();  // dh and v are in
    if (live) scores(ga, hs, vs);
    const long long part = (static_cast<long long>(rec) * lay.tiles + si) * kMat;
    float* S = a.work + lay.s_part + part;
    float* G = a.work + lay.g_part + part;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[ln.row(e) * kChunk + ln.col(i, e)] = sa[i][e];
        G[ln.row(e) * kChunk + ln.col(i, e)] = ga[i][e];
      }
    }
  }
  // the shares of q_t . n_in and dh_t . h_t: a warp eight steps, lanes
  // across the columns, then a fixed xor tree
  const long long vpart = (static_cast<long long>(rec) * lay.tiles + si) * kChunk;
#pragma unroll
  for (int r = 0; r < kChunk / kWarps; ++r) {
    const int t = warp + kWarps * r;
    float x = fmaf(qs[t * kLdM + lane + 32], ns[lane + 32], qs[t * kLdM + lane] * ns[lane]);
    const float* ht = a.h + ch.x0 + t * T + col0;
    const float h0 = t < L && col0 + lane < d ? ht[lane] : 0.0f;
    const float h1 = t < L && col0 + lane + 32 < d ? ht[lane + 32] : 0.0f;
    float y = fmaf(hs[t * kLdM + lane + 32], h1, hs[t * kLdM + lane] * h0);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, m);
      y += __shfl_xor_sync(0xffffffffu, y, m);
    }
    if (lane == 0) {
      a.work[lay.qn_part + vpart + t] = x;
      a.work[lay.hh_part + vpart + t] = y;
    }
  }
}

// 2. gates: the chunk's scores from the slices' shares, the gates, W / g,
// dS, P's sums and the per-step scalars.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_gates_kernel(Args a) {
  __shared__ float Sm[kChunk][kChunk + 1];  // Q K^T, then W
  __shared__ float Gm[kChunk][kChunk + 1];  // dh V^T, then P
  __shared__ float qn[kChunk], dhh[kChunk], invg[kChunk];
  __shared__ float bc[kChunk], xs[kChunk], mt[kChunk], inter[kChunk], dden[kChunk];
  __shared__ double ls[kChunk], b64[kChunk];  // log sigmoid(f_t); b_t
  __shared__ float its[kChunk], run_t[kChunk];  // i_t; the running max r_t
  __shared__ int ridx_t[kChunk];
  __shared__ double b_last64;
  __shared__ float m_out;

  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int rec = blockIdx.x, bH = a.b * a.H;
  const int c = rec / bH, bh = rec - c * bH;
  const Chunk ch = chunk_of(a, c, bh);
  const int L = ch.L, tid = threadIdx.x, tiles = static_cast<int>(lay.tiles);

  // the slices' shares, added in slice order, 4 floats a thread at a time
  {
    const float4* sp = reinterpret_cast<const float4*>(
        a.work + lay.s_part + static_cast<long long>(rec) * tiles * kMat);
    const float4* gp = reinterpret_cast<const float4*>(
        a.work + lay.g_part + static_cast<long long>(rec) * tiles * kMat);
    auto add = [](float4& x, const float4& y) { x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w; };
    for (int i = tid; i < kMat / 4; i += kThreads) {
      float4 s = sp[i], g = gp[i];
#pragma unroll 4
      for (int si = 1; si < tiles; ++si) {
        add(s, sp[si * (kMat / 4) + i]);
        add(g, gp[si * (kMat / 4) + i]);
      }
      const int t = 4 * i / kChunk, j = 4 * i % kChunk;
      Sm[t][j] = s.x, Sm[t][j + 1] = s.y, Sm[t][j + 2] = s.z, Sm[t][j + 3] = s.w;
      Gm[t][j] = g.x, Gm[t][j + 1] = g.y, Gm[t][j + 2] = g.z, Gm[t][j + 3] = g.w;
    }
    if (tid < kChunk) {
      const float* qp = a.work + lay.qn_part + static_cast<long long>(rec) * tiles * kChunk + tid;
      const float* hp = a.work + lay.hh_part + static_cast<long long>(rec) * tiles * kChunk + tid;
      float x = qp[0], y = hp[0];
      for (int si = 1; si < tiles; ++si) {
        x += qp[si * kChunk];
        y += hp[si * kChunk];
      }
      qn[tid] = x;
      dhh[tid] = y;
    }
  }

  // The gates: each step's log sigmoid(f_t) in fp64 on its own thread, then
  // one thread's scan in step order (the sums in fp64, as the forward), then
  // the exponentials on a thread a step again.
  float* vec = a.work + lay.vecs + static_cast<long long>(rec) * kNumVec * kChunk;
  float* scal = a.work + lay.scal + static_cast<long long>(rec) * 2;
  const float m0 = a.m_in[rec];
  if (tid < kChunk) {
    const long long g = ch.g0 + static_cast<long long>(tid) * a.H;
    ls[tid] = tid < L ? log_sigmoid(static_cast<double>(a.fg[g])) : 0.0;
    its[tid] = tid < L ? a.ig[g] : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    double sum = 0.0;
    float run = -INFINITY;
    int ridx = 0;
    for (int t = 0; t < L; ++t) {
      sum += ls[t];
      b64[t] = sum;
      const float cum = static_cast<float>(sum), x = its[t] - cum;
      if (x >= run) run = x, ridx = t;  // the latest index at a tie, as torch.cummax
      bc[t] = cum, xs[t] = x, mt[t] = fmaxf(cum + m0, run + cum);
      run_t[t] = run, ridx_t[t] = ridx;
    }
    const float b_last = static_cast<float>(sum);
    const float oa = b_last + m0, ob = run + b_last;
    b_last64 = sum;
    m_out = fmaxf(oa, ob);
    scal[0] = static_cast<float>(exp(sum + m0 - static_cast<double>(m_out)));
    scal[1] = max_share(oa, ob);
  }
  __syncthreads();
  if (tid < kChunk) {
    const int t = tid;
    if (t < L) {
      inter[t] = expf(bc[t] + m0 - mt[t]);
      vec[kShare * kChunk + t] = max_share(bc[t] + m0, run_t[t] + bc[t]);
      vec[kRidx * kChunk + t] = static_cast<float>(ridx_t[t]);
      vec[kW * kChunk + t] =
          static_cast<float>(exp(b_last64 - b64[t] + its[t] - static_cast<double>(m_out)));
    } else {
      inter[t] = 0.0f;
      vec[kW * kChunk + t] = 0.0f;
    }
    vec[kInter * kChunk + t] = inter[t];
  }
  __syncthreads();

  // W = D * S (j <= t, zero elsewhere), then each step's denominator and
  // scalars
  for (int i = tid; i < kMat; i += kThreads) {
    const int t = i / kChunk, j = i - t * kChunk;
    Sm[t][j] *= t < L && j <= t ? expf(bc[t] - mt[t] + xs[j]) : 0.0f;
  }
  __syncthreads();
  if (tid < kChunk) {
    const int t = tid;
    float dn_ = 0.0f, inv = 1.0f, e = 0.0f, a_t = 0.0f, dinter = 0.0f;
    if (t < L) {
      float d = inter[t] * qn[t];
      for (int j = 0; j <= t; ++j) d += Sm[t][j];
      const float g = fmaxf(fabsf(d), 1.0f);
      const float dg = -dhh[t] / g;
      inv = 1.0f / g;
      dn_ = fabsf(d) >= 1.0f ? (d > 0.0f ? dg : (d < 0.0f ? -dg : 0.0f)) : 0.0f;
      a_t = inter[t] / g;
      e = inter[t] * dn_;
      dinter = dn_ * qn[t];
    }
    dden[t] = dn_;
    invg[t] = inv;
    vec[kInvG * kChunk + t] = inv;
    vec[kA * kChunk + t] = a_t;
    vec[kE * kChunk + t] = e;
    vec[kDinter * kChunk + t] = dinter;
  }
  __syncthreads();
  // dW_tj = (dh_t . v_j) / g_t + dden_t (Gm holds dh_t . v_j); dS = dW * D;
  // P = dW * W, which replaces dh V^T; W / g for dv's product
  float* wg = a.work + lay.wg + static_cast<long long>(rec) * kMat;
  float* ds = a.work + lay.ds + static_cast<long long>(rec) * kMat;
  for (int i = tid; i < kMat; i += kThreads) {
    const int t = i / kChunk, j = i - t * kChunk;
    const bool on = t < L && j <= t;
    const float D = on ? expf(bc[t] - mt[t] + xs[j]) : 0.0f;
    const float dW = on ? Gm[t][j] * invg[t] + dden[t] : 0.0f;
    const float W = Sm[t][j];
    wg[i] = W * invg[t];
    ds[i] = dW * D;
    Gm[t][j] = dW * W;
  }
  __syncthreads();
  if (tid < kChunk) {  // P's row and column sums
    float r = 0.0f, cl = 0.0f;
    for (int j = 0; j < kChunk; ++j) r += Gm[tid][j];
    for (int t = 0; t < kChunk; ++t) cl += Gm[t][tid];
    vec[kRowP * kChunk + tid] = r;
    vec[kColP * kChunk + tid] = cl;
  }
}

// 3. state: dC_out of every chunk, by 64 x 64 tiles (rows v, columns k), the
// chunks in reverse, the tile as mma accumulators. Each chunk's operands (its
// dh over the tile's rows, its q over the tile's columns, a_t and e_t) arrive
// through a double buffer while the chunk before them is multiplied.
constexpr int kStateDepth = 2;
constexpr int kStateStage = 2 * kChunk * kLdN + 2 * kChunk;  // dh, q, a_t, e_t
size_t state_smem_bytes() { return sizeof(float) * kStateDepth * kStateStage; }

__global__ void __launch_bounds__(kThreads) mlstm_bwd_state_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int bh = blockIdx.x, bH = a.b * a.H, d = a.dh;
  const int v0 = blockIdx.y * kTile, k0 = blockIdx.z * kTile;
  const int tid = threadIdx.x;
  const int n_chunks = (a.s + kChunk - 1) / kChunk;
  const long long d2 = static_cast<long long>(d) * d, dc_head = static_cast<long long>(bh) * d2;
  const bool vec = a.vec != 0;
  const Lane ln;
  // step u: chunk n_chunks - 1 - u
  auto load = [&](int u) {
    if (u < n_chunks) {
      float* st = smem + (u % kStateDepth) * kStateStage;
      const int c = n_chunks - 1 - u;
      const Chunk ch = chunk_of(a, c, bh);
      stage<kChunk, kTile>(st, kLdN, Mat{a.gh + ch.x0 + v0, ch.t_stride, ch.L, d - v0}, 0, 0, vec);
      stage<kChunk, kTile>(st + kChunk * kLdN, kLdN,
                           Mat{a.q + ch.x0 + k0, ch.t_stride, ch.L, d - k0}, 0, 0, vec);
      if (tid < 2 * kChunk) {  // a_t, then e_t
        const float* vecs = a.work + lay.vecs + (static_cast<long long>(c) * bH + bh) * kNumVec * kChunk;
        st[2 * kChunk * kLdN + tid] = vecs[kA * kChunk + tid];
      }
    }
    cp_async_commit();
  };
  static_assert(kE == kA + 1, "a_t and e_t lie side by side in a record");
  load(0);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vr = v0 + ln.row(e), kc = k0 + ln.col(i, e);
      acc[i][e] = a.dc != nullptr && vr < d && kc < d ? a.dc[dc_head + vr * d + kc] : 0.0f;
    }
  }
  const bool carries_n = blockIdx.y == 0 && tid < kTile && k0 + tid < d;
  float dn = carries_n && a.dn != nullptr ? a.dn[static_cast<long long>(bh) * d + k0 + tid] : 0.0f;

  for (int u = 0; u < n_chunks; ++u) {
    const int c = n_chunks - 1 - u;
    const long long rec = static_cast<long long>(c) * bH + bh;
    const float s_out = a.work[lay.scal + rec * 2];
    if (c < n_chunks - 1) {  // the last chunk's dC_out is the incoming dC
      float* dco = a.work + lay.dco + rec * d2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int vr = v0 + ln.row(e), kc = k0 + ln.col(i, e);
          if (vr < d && kc < d) dco[vr * d + kc] = acc[i][e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= s_out;
    }
    if (carries_n) {
      a.work[lay.dno + rec * d + k0 + tid] = dn;
      dn *= s_out;
    }
    cp_async_wait_pending<0>();
    __syncthreads();  // chunk u's stage is in; every thread is done with u - 1's
    load(u + 1);
    const float* hs = smem + (u % kStateDepth) * kStateStage;
    const float* qs = hs + kChunk * kLdN;
    const float* as = qs + kChunk * kLdN;
    const float* es = as + kChunk;
    // acc(v, k) += sum_t a_t dh_t[v] q_t[k]
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      FragB b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = frag_b(qs + 8 * kk * kLdN + 8 * (4 * ln.nb + i), kLdN, ln.g, ln.t);
      mma3_n(acc, frag_a_t_cols(hs + 8 * kk * kLdN + 16 * ln.mt, kLdN, ln.g, ln.t,
                                 as[8 * kk + ln.t], as[8 * kk + ln.t + 4]), b);
    }
    if (carries_n) {
      const int L = min(kChunk, a.s - c * kChunk);
      for (int t = 0; t < L; ++t) dn = fmaf(es[t], qs[t * kLdN + tid], dn);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vr = v0 + ln.row(e), kc = k0 + ln.col(i, e);
      if (vr < d && kc < d) a.dc0[dc_head + vr * d + kc] = acc[i][e];
    }
  }
  if (carries_n) a.dn0[static_cast<long long>(bh) * d + k0 + tid] = dn;
}

// The products' block tile: 64 rows x kWide columns over 8 warps, warp w
// the 32 rows from 32 (w % 2) (two 16-row tiles) and the 32 columns from
// 32 (w / 2) (four 8-column tiles); its lane holds, of row tile m and
// column tile i, element e at row 32 (w % 2) + 16 m + g + 8 (e / 2) and
// column 32 (w / 2) + 8 i + 2 t + (e & 1) (g = lane / 4, t = lane % 4).
// Each k-step's two A and four B fragments feed 8 tiles' products.
constexpr int kWide = 2 * kTile;
constexpr int kLdW = kWide + 8;  // row stride of a [k][column] kWide-wide tile (frag_b)
constexpr int kStageW = kChunk * kLdK + kWide * kLdK;  // A (64 x kLdK), then B
static_assert(kKS * kLdW <= kWide * kLdK, "both layouts of B fit a stage");
constexpr int kDepthW = 2;  // stages of the products' ring, kDepthW - 1 in flight
constexpr int kRingW = kDepthW * kStageW;
static_assert(kChunk * kLdN + kChunk * kLdW <= kRingW, "the chunk product's tiles fit the ring");

struct WLane {
  int g, t, mh, nq;
  __device__ __forceinline__ WLane() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    g = lane / 4, t = lane % 4, mh = warp % 2, nq = warp / 2;
  }
  __device__ __forceinline__ int row(int m, int e) const { return 32 * mh + 16 * m + g + 8 * (e / 2); }
  __device__ __forceinline__ int col(int i, int e) const { return 32 * nq + 8 * i + 2 * t + (e & 1); }
};

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
  zero(acc[0]);
  zero(acc[1]);
}

// acc += (diag(s) A) B over the contraction index e < n for the block's
// 64 x kWide tile, A(row, e) from a, B through kKS-wide stages of a ring of
// kDepthW (kDepthW - 1 in flight while one is multiplied). kBRows: B's
// element (e, col) is b(e, col), else b(col, e). scale (shared memory,
// null: 1) scales A's rows.
template <bool kBRows>
__device__ __forceinline__ void dh_product(float (&acc)[2][4][4], const Mat& A, const float* scale,
                                           const Mat& B, int n, float* ring, bool vec) {
  const WLane ln;
  const int steps = (n + kKS - 1) / kKS;
  auto load = [&](int u) {
    if (u < steps) {
      float* st = ring + (u % kDepthW) * kStageW;
      stage<kChunk, kKS>(st, kLdK, A, 0, u * kKS, vec);
      if (kBRows) {
        stage<kKS, kWide>(st + kChunk * kLdK, kLdW, B, u * kKS, 0, vec);
      } else {
        stage<kWide, kKS>(st + kChunk * kLdK, kLdK, B, 0, u * kKS, vec);
      }
    }
    cp_async_commit();
  };
  float s[2][2];  // the lane's rows' scales: row tile m, rows g and g + 8
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    s[m][0] = scale != nullptr ? scale[ln.row(m, 0)] : 1.0f;
    s[m][1] = scale != nullptr ? scale[ln.row(m, 2)] : 1.0f;
  }
  for (int u = 0; u < kDepthW - 1; ++u) load(u);
  for (int u = 0; u < steps; ++u) {
    cp_async_wait_pending<kDepthW - 2>();
    __syncthreads();  // stage u is in, and every thread is done with stage u - 1
    load(u + kDepthW - 1);  // into stage u - 1's buffer
    const float* as = ring + (u % kDepthW) * kStageW;
    const float* bs = as + kChunk * kLdK;
#pragma unroll
    for (int kk = 0; kk < kKS / 8; ++kk) {
      FragB b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i] = kBRows ? frag_b(bs + 8 * kk * kLdW + 32 * ln.nq + 8 * i, kLdW, ln.g, ln.t)
                      : frag_b_t(bs + (32 * ln.nq + 8 * i) * kLdK + 8 * kk, kLdK, ln.g, ln.t);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma3_n(acc[m], frag_a_rows(as + (32 * ln.mh + 16 * m) * kLdK + 8 * kk, kLdK, ln.g, ln.t,
                                    s[m][0], s[m][1]), b);
      }
    }
  }
  __syncthreads();  // the ring is free (the scales were read before the first barrier)
}

// acc += A B over the chunk's steps: A from the record's 64 x 64 matrix M
// (kATrans: A(row, j) = M[j][row], else M[row][j]), B(j, col) from b. M is
// zero above its diagonal (W / g and dS: step j <= t), so a warp skips the
// k-steps where a row tile of A is all zero.
template <bool kATrans>
__device__ __forceinline__ void step_product(float (&acc)[2][4][4], const float* M, const Mat& B,
                                             float* ring, bool vec) {
  const WLane ln;
  float* ms = ring;
  float* bs = ring + kChunk * kLdN;
  stage<kChunk, kChunk>(ms, kATrans ? kLdN : kLdM, Mat{M, kChunk, kChunk, kChunk}, 0, 0, true);
  stage<kChunk, kWide>(bs, kLdW, B, 0, 0, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    // row tile m holds steps t (M[t][j], nonzero for j <= t: k-steps up to
    // its last step) or keys j (M[t][j] as A(j, t): k-steps from its first
    // key); the same on every lane of the warp
    const int mt0 = 2 * ln.mh;
    const bool live0 = kATrans ? kk >= 2 * mt0 : kk < 2 * mt0 + 2;
    const bool live1 = kATrans ? kk >= 2 * mt0 + 2 : kk < 2 * mt0 + 4;
    if (!live0 && !live1) continue;
    FragB b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = frag_b(bs + 8 * kk * kLdW + 32 * ln.nq + 8 * i, kLdW, ln.g, ln.t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 0 ? !live0 : !live1) continue;
      const int r = 32 * ln.mh + 16 * m;
      mma3_n(acc[m], kATrans ? frag_a_t(ms + 8 * kk * kLdN + r, kLdN, ln.g, ln.t)
                              : frag_a(ms + r * kLdM + 8 * kk, kLdM, ln.g, ln.t), b);
    }
  }
  __syncthreads();
}

// out[row] = the sum over the block's kWide columns of each row's partials:
// a lane's own (p[m][h], row tile m, rows g and g + 8) in column order, then
// over the quad's lanes by a fixed xor tree, then the four column quarters
// in order.
__device__ __forceinline__ void row_sums(float (&p)[2][2], float* red, float* out) {
  const WLane ln;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = p[m][h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (ln.t == 0) red[ln.nq * kChunk + ln.row(m, 2 * h)] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x < kChunk) {
    const int r = threadIdx.x;
    out[r] = ((red[r] + red[kChunk + r]) + red[2 * kChunk + r]) + red[3 * kChunk + r];
  }
  __syncthreads();
}

enum Product { kQC, kDQ, kDV, kDK };

// 4. products: an L x kWide tile of one product of one chunk of one head.
size_t products_smem_bytes() { return sizeof(float) * kRingW; }

__global__ void __launch_bounds__(kThreads, 2) mlstm_bwd_products_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;  // kRingW floats
  __shared__ float red[4 * kChunk];
  __shared__ float rs[kChunk];  // the scale of A's rows: a_t (dq), w_j (dk)
  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int rec = blockIdx.x, bH = a.b * a.H, d = a.dh;
  const int c = rec / bH, bh = rec - c * bH;
  const int tile = blockIdx.y, col0 = tile * kWide;
  const Chunk ch = chunk_of(a, c, bh);
  const int L = ch.L, cols = min(kWide, d - col0), tid = threadIdx.x;
  const bool vec = a.vec != 0;
  const WLane ln;
  const long long T = ch.t_stride;
  const float* vecs = a.work + lay.vecs + static_cast<long long>(rec) * kNumVec * kChunk;
  const float* wg = a.work + lay.wg + static_cast<long long>(rec) * kMat;
  const float* ds = a.work + lay.ds + static_cast<long long>(rec) * kMat;
  const float* C = a.c_in + static_cast<long long>(rec) * d * d;
  const float* dco = dc_out(a, lay, c, bh);  // null: zero
  const float* dno = a.work + lay.dno + static_cast<long long>(rec) * d;
  const float* n_in = a.n_in + static_cast<long long>(rec) * d;
  const long long part = static_cast<long long>(rec) * lay.wtiles + tile;
  auto rows_of = [&](const float* x) { return Mat{x + ch.x0, T, L, d}; };       // (step, e)
  auto cols_of = [&](const float* x) { return Mat{x + ch.x0 + col0, T, L, cols}; };  // (step, col)
  auto vec_at = [&](int kind, int t) { return t < L ? vecs[kind * kChunk + t] : 0.0f; };
  // the tile's element (row, col) of the (b, s, H, dh) tensor x
  auto at = [&](int row, int col) { return ch.x0 + row * T + col0 + col; };
  // f(row, col, element) for each of the lane's elements inside the chunk and dh
  auto each = [&](auto f) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ln.row(m, e), col = ln.col(i, e);
          if (row < L && col < cols) f(row, col, m, i, e);
        }
      }
    }
  };

  if (tid < kChunk) rs[tid] = vec_at(blockIdx.z == kDQ ? kA : kW, tid);
  __syncthreads();
  float acc[2][4][4];
  zero(acc);
  switch (blockIdx.z) {
    case kQC: {  // q_t . C_in[v] for the tile's v; partial d inter_t and ds
      dh_product<false>(acc, rows_of(a.q), nullptr,
                        Mat{C + static_cast<long long>(col0) * d, d, cols, d}, d, ring, vec);
      float p[2][2] = {};
      each([&](int row, int col, int m, int i, int e) {
        const float dnum = a.gh[at(row, col)] * vecs[kInvG * kChunk + row];
        p[m][e / 2] = fmaf(dnum, acc[m][i][e], p[m][e / 2]);
      });
      row_sums(p, red, a.work + lay.p_inter + part * kChunk);
      // ds: the sum over the tile's rows v of dC_out[v] . C_in[v]
      float s = 0.0f;
      if (dco != nullptr) {
        for (long long i = tid; i < static_cast<long long>(cols) * d; i += kThreads) {
          const long long x = static_cast<long long>(col0) * d + i;
          s = fmaf(dco[x], C[x], s);
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (tid % 32 == 0) red[tid / 32] = s;
      __syncthreads();
      if (tid == 0) {
        float r = 0.0f;
        for (int w = 0; w < kWarps; ++w) r += red[w];
        a.work[lay.p_s + part] = r;
      }
      return;
    }
    case kDQ: {  // dq_t = C_in^T (a_t dh_t) + sum_j dS_tj k_j + e_t n_in
      dh_product<true>(acc, rows_of(a.gh), rs, Mat{C + col0, d, d, cols}, d, ring, vec);
      step_product<false>(acc, ds, cols_of(a.k), ring, vec);
      each([&](int row, int col, int m, int i, int e) {
        a.dq[at(row, col)] = fmaf(vecs[kE * kChunk + row], n_in[col0 + col], acc[m][i][e]);
      });
      return;
    }
    case kDV: {  // dC_out k_j, its partial dw_j, then dv_j = w_j dC_out k_j + sum_t W_tj dnum_t
      if (dco != nullptr) {
        dh_product<false>(acc, rows_of(a.k), nullptr,
                          Mat{dco + static_cast<long long>(col0) * d, d, cols, d}, d, ring,
                          vec);
      }
      float p[2][2] = {};
      each([&](int row, int col, int m, int i, int e) {
        p[m][e / 2] = fmaf(a.v[at(row, col)], acc[m][i][e], p[m][e / 2]);
      });
      row_sums(p, red, a.work + lay.p_w + part * kChunk);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][i][e] *= rs[ln.row(m, e)];
        }
      }
      step_product<true>(acc, wg, cols_of(a.gh), ring, vec);
      each([&](int row, int col, int m, int i, int e) { a.dv[at(row, col)] = acc[m][i][e]; });
      return;
    }
    default: {  // dk_j = w_j (dC_out^T v_j + dn_out) + sum_t dS_tj q_t
      if (dco != nullptr) {
        dh_product<true>(acc, rows_of(a.v), rs, Mat{dco + col0, d, d, cols}, d, ring, vec);
      }
      step_product<true>(acc, ds, cols_of(a.q), ring, vec);
      each([&](int row, int col, int m, int i, int e) {
        a.dk[at(row, col)] = fmaf(vecs[kW * kChunk + row], dno[col0 + col], acc[m][i][e]);
      });
      return;
    }
  }
}

// 5. scalars: the gates' gradients and dm, the chunks in reverse. Per chunk
// the record's vectors, dn_out and n_in come into shared memory; a thread a step
// computes what needs no other step, one thread the sums in step order.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_scalars_kernel(Args a) {
  __shared__ float vs[kNumVec * kChunk];  // the record's vectors
  __shared__ float dnk[kChunk], dinter[kChunk], dw[kChunk];
  __shared__ float Qs[kChunk], Pws[kChunk], dmt[kChunk], db[kChunk], dx[kChunk], dr[kChunk];
  __shared__ float dnn, ds, dr_last;
  __shared__ float dns[1024], nns[1024];  // dn_out, n_in
  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int bh = blockIdx.x, bH = a.b * a.H, d = a.dh, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_chunks = (a.s + kChunk - 1) / kChunk;
  float dM = a.dm != nullptr ? a.dm[bh] : 0.0f;  // thread 0's carry
  for (int c = n_chunks - 1; c >= 0; --c) {
    const long long rec = static_cast<long long>(c) * bH + bh;
    const Chunk ch = chunk_of(a, c, bh);
    const int L = ch.L;
    const float* vec = a.work + lay.vecs + rec * kNumVec * kChunk;
    const float* dno = a.work + lay.dno + rec * d;
    const float* n_in = a.n_in + rec * d;
    for (int i = tid; i < kNumVec * kChunk; i += kThreads) vs[i] = vec[i];
    // dn_out . k_j for every step: four threads a step, each every fourth 4
    // floats of dh (every fourth float where dh % 4 != 0), then a fixed xor
    // tree; dn_out . n_in: warp 0 after its steps, lanes across dh; zeros
    // where dn_out is (the last chunk's, with no dn in)
    const bool dn_zero = c == n_chunks - 1 && a.dn == nullptr;
    for (int i = tid; i < d; i += kThreads) dns[i] = dno[i], nns[i] = n_in[i];
    __syncthreads();
    {
      const int t = tid / 4, part = tid % 4;
      float sum = 0.0f;
      if (t < L && !dn_zero) {
        const float* kt = a.k + ch.x0 + t * ch.t_stride;
        if (a.vec != 0) {
#pragma unroll 8
          for (int e = 4 * part; e < d; e += 16) {
            const float4 x = *reinterpret_cast<const float4*>(kt + e);
            sum = fmaf(dns[e], x.x, sum);
            sum = fmaf(dns[e + 1], x.y, sum);
            sum = fmaf(dns[e + 2], x.z, sum);
            sum = fmaf(dns[e + 3], x.w, sum);
          }
        } else {
#pragma unroll 8
          for (int e = part; e < d; e += 4) sum = fmaf(dns[e], kt[e], sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) dnk[t] = sum;
      if (warp == 0) {
        float x = 0.0f;
        if (!dn_zero) {
          for (int e = lane; e < d; e += 32) x = fmaf(dns[e], nns[e], x);
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
        if (lane == 0) dnn = x;
      }
    }
    // the tiles' partial sums, in tile order
    if (tid < kChunk) {
      float pi = vec[kDinter * kChunk + tid], pw = 0.0f;
#pragma unroll 4
      for (long long t = 0; t < lay.wtiles; ++t) {
        const long long part = rec * lay.wtiles + t;
        pi += a.work[lay.p_inter + part * kChunk + tid];
        pw += a.work[lay.p_w + part * kChunk + tid];
      }
      dinter[tid] = pi;
      dw[tid] = pw;
    } else if (tid == kChunk) {
      float sum = 0.0f;
      for (long long t = 0; t < lay.wtiles; ++t) sum += a.work[lay.p_s + rec * lay.wtiles + t];
      ds = sum;
    }
    __syncthreads();
    auto V = [&](int kind, int t) { return vs[kind * kChunk + t]; };
    if (tid < L) {  // what each step needs of its own
      const int t = tid;
      const float Q = dinter[t] * V(kInter, t);
      const float Pw = (dw[t] + dnk[t]) * V(kW, t);
      Qs[t] = Q, Pws[t] = Pw;
      db[t] = V(kRowP, t) + Q;
      dx[t] = V(kColP, t) + Pw;
      dmt[t] = -(V(kRowP, t) + dinter[t] * V(kInter, t));
    }
    __syncthreads();
    if (tid == 0) {  // the sums over the chunk's steps, in step order
      const float s_out = a.work[lay.scal + rec * 2], share_out = a.work[lay.scal + rec * 2 + 1];
      const float R = (ds + dnn) * s_out;
      float sum_q = 0.0f, sum_pw = 0.0f;
      for (int t = 0; t < L; ++t) {
        sum_q += Qs[t];
        sum_pw += Pws[t];
      }
      const float dmo = dM - R - sum_pw;
      db[L - 1] += R + sum_pw + dmo;
      float dm_in = sum_q + R + share_out * dmo;
      dr_last = (1.0f - share_out) * dmo;
      for (int t = 0; t < L; ++t) dm_in += V(kShare, t) * dmt[t];
      dM = dm_in;
    }
    __syncthreads();
    if (tid < L) {
      const int t = tid;
      db[t] += dmt[t];
      dr[t] = (t == L - 1 ? dr_last : 0.0f) + (1.0f - V(kShare, t)) * dmt[t];
    }
    __syncthreads();
    if (tid < L) {  // the running max's share to its latest index, in step order
      float x = dx[tid];
      for (int t = 0; t < L; ++t) {
        if (static_cast<int>(V(kRidx, t)) == tid) x += dr[t];
      }
      dx[tid] = x;
    }
    __syncthreads();
    if (tid == 0) {  // d log sigmoid(f_t) = sum over t' >= t of db - dx, in reverse
      float dlf = 0.0f;
      for (int t = L - 1; t >= 0; --t) {
        dlf += db[t] - dx[t];
        db[t] = dlf;
      }
    }
    __syncthreads();
    if (tid < L) {
      const long long g = ch.g0 + static_cast<long long>(tid) * a.H;
      a.di[g] = dx[tid];
      a.df[g] = db[tid] / (1.0f + expf(a.fg[g]));  // d log sigmoid(f) / df = sigmoid(-f)
    }
    __syncthreads();
  }
  if (tid == 0) a.dm0[bh] = dM;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Workspace bytes the backward needs at this shape.
extern "C" long long mlstm_chunk_bwd_workspace(int b, int s, int H, int dh) {
  if (b < 1 || s < 1 || H < 1 || dh < 1) return 0;
  return layout(b, s, H, dh).total * static_cast<long long>(sizeof(float));
}

// q, k, v, i, f, C_in, n_in, m_in (the chunks' input states), h, dh, dC, dn,
// dm (each of the last three or null); dq, dk, dv, di, df, dC0, dn0, dm0;
// workspace; b, s, H, dh; stream
extern "C" int mlstm_chunk_bwd_f32(const void* q, const void* k, const void* v, const void* ig,
                                   const void* fg, const void* c_in, const void* n_in,
                                   const void* m_in, const void* h, const void* dh,
                                   const void* dc, const void* dn, const void* dm, void* dq,
                                   void* dk, void* dv, void* di, void* df, void* dc0, void* dn0,
                                   void* dm0, void* work, int b, int s, int H, int d,
                                   void* stream) {
  if (b < 1 || s < 1 || H < 1 || d < 1 || d > 1024 || dh == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dh) &&
                  aligned16(c_in) && (dc == nullptr || aligned16(dc)) && aligned16(work) ? 1 : 0;
  const Args a{f(q), f(k), f(v), f(ig), f(fg), f(c_in), f(n_in), f(m_in), f(h), f(dh), f(dc),
               f(dn), f(dm), w(dq), w(dk), w(dv), w(di), w(df), w(dc0), w(dn0), w(dm0),
               w(work), b, s, H, d, vec};
  const Layout lay = layout(b, s, H, d);
  const int tiles = static_cast<int>(lay.tiles), bH = b * H;
  if (lay.recs > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned recs = static_cast<unsigned>(lay.recs);
  static const cudaError_t raised[3] = {
      cudaFuncSetAttribute(mlstm_bwd_slices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(slices_smem_bytes())),
      cudaFuncSetAttribute(mlstm_bwd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(state_smem_bytes())),
      cudaFuncSetAttribute(mlstm_bwd_products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(products_smem_bytes()))};
  for (const cudaError_t r : raised) {
    if (r != cudaSuccess) return static_cast<int>(r);
  }
  mlstm_bwd_slices_kernel<<<dim3(recs, tiles), kThreads, slices_smem_bytes(), st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mlstm_bwd_gates_kernel<<<recs, kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mlstm_bwd_state_kernel<<<dim3(bH, tiles, tiles), kThreads, state_smem_bytes(), st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mlstm_bwd_products_kernel<<<dim3(recs, static_cast<unsigned>(lay.wtiles), 4), kThreads,
                              products_smem_bytes(), st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mlstm_bwd_scalars_kernel<<<bH, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
