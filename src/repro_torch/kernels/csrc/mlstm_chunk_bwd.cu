// The backward of the chunkwise mLSTM for Hopper (sm_90a), fp32: the
// gradient of what mlstm_chunk.cu's chunked pass computes, given the
// gradient of every h_t and of the returned state (C, n, m).
//
// No TPU kernel: the JAX package differentiates its recurrence with XLA
// (src/repro/models/xlstm.py:130 _mlstm_chunked, and the per-step scan
// below 128 tokens), and the Pallas kernel
// src/repro/kernels/mlstm_chunk/mlstm_chunk.py:32 _mlstm_chunk_kernel has
// no backward. The plain version is
// kernels/mlstm_chunk/ref.py:mlstm_chunk_bwd_ref; the notation is its.
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
// Four kernels, one launch of the entry:
// 1. gates: one block per (chunk, head). The L x L scores Q K^T and
//    dh V^T, q . n_in and dh . h over 32-wide slices of dh in shared
//    memory; a thread's serial scan of the gates (the cumulative sum in
//    fp64, as the forward); then W, dS, P and the per-step scalars.
// 2. state: one block per (head, 64 x 64 tile of dC), walking the chunks in
//    reverse with the tile in registers: it writes each chunk's dC_out
//    and updates it; the tiles of the first row also carry dn.
// 3. products: one block per (chunk, head, 64 columns, product), an
//    L x 64 tile of q C_in^T (for d inter), dq, dv (with dC_out k, for dw)
//    or dk, each a product over dh then one over the chunk's steps,
//    staged 16 at a time in shared memory; per-tile partial sums for the
//    scalars.
// 4. scalars: one block per head, the chunks in reverse carrying dm: the
//    partial sums added in order, the gates' gradients by one thread.
// fp32 throughout, fp64 for the gates' sums and the exponentials of the
// state's weights as in the forward. No tensor cores, no TF32 and no
// atomics: every sum runs in one order, so two launches give the same bits.
//
// What bounds it: per chunk and head, five products of L x dh x dh (q C,
// dC_in, dq, dk, dv) and four of L x L x dh, about 10 L dh^2 operations:
// at batch 8, seq 64 and xLSTM-1.3B's 4 heads of 512 about 5.5 GFLOP, 0.08
// ms at 67 TFLOP/s, against about 0.1 GB read and written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // time steps per chunk, as the forward
constexpr int kTile = 64;   // output tile: 64 rows (steps) x 64 columns
constexpr int kSlice = 16;  // contraction elements staged a pass
constexpr int kDot = 32;    // dh elements a pass of the gates' scores

// Per-chunk scalars, kChunk floats each, in a record of the workspace.
enum Vec { kInter, kW, kShare, kRidx, kRowP, kColP, kDinter, kA, kE, kInvG, kNumVec };

struct Layout {  // offsets in floats into the workspace
  long long recs, tiles;            // (chunk, head) records; column tiles of dh
  long long w_mat, ds_mat, vecs;    // per record: W and dS (64 x 64), the vectors
  long long scal;                   // per record: s_out, the share of m_out's max
  long long p_inter, p_w, p_s;      // per record and tile: partial sums
  long long dco, dno;               // per record: dC_out (dh x dh), dn_out (dh)
  long long total;
};

__host__ __device__ Layout layout(int b, int s, int H, int dh) {
  Layout l;
  const long long n_chunks = (s + kChunk - 1) / kChunk;
  l.recs = n_chunks * b * H;
  l.tiles = (dh + kTile - 1) / kTile;
  l.w_mat = 0;
  l.ds_mat = l.w_mat + l.recs * kChunk * kChunk;
  l.vecs = l.ds_mat + l.recs * kChunk * kChunk;
  l.scal = l.vecs + l.recs * kNumVec * kChunk;
  l.p_inter = l.scal + l.recs * 2;
  l.p_w = l.p_inter + l.recs * l.tiles * kChunk;
  l.p_s = l.p_w + l.recs * l.tiles * kChunk;
  l.dco = l.p_s + l.recs * l.tiles;
  l.dno = l.dco + l.recs * dh * dh;
  l.total = l.dno + l.recs * dh;
  return l;
}

struct Args {
  // gh is the gradient of h
  const float *q, *k, *v, *ig, *fg, *c_in, *n_in, *m_in, *h, *gh, *dc, *dn, *dm;
  float *dq, *dk, *dv, *di, *df, *dc0, *dn0, *dm0;
  float* work;
  int b, s, H, dh;
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

// 1. gates: the chunk's scores, gates, W, dS, P and per-step scalars.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_gates_kernel(Args a) {
  // 32-wide slices of q, k, dh and v while the scores accumulate, then D
  // (later P) and W in the same memory
  __shared__ float big[4 * kDot][kChunk + 1];
  static_assert(4 * kDot == 2 * kChunk, "the slices and the two L x L matrices share memory");
  float(*qs)[kChunk + 1] = big;
  float(*ks)[kChunk + 1] = big + kDot;
  float(*hs)[kChunk + 1] = big + 2 * kDot;
  float(*vs)[kChunk + 1] = big + 3 * kDot;
  float(*Dm)[kChunk + 1] = big;
  float(*Sm)[kChunk + 1] = big + kChunk;
  __shared__ float ns[kDot];
  __shared__ float qn[kChunk], dhh[kChunk];
  __shared__ float bc[kChunk], xs[kChunk], mt[kChunk], inter[kChunk], dden[kChunk];

  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int rec = blockIdx.x, bH = a.b * a.H;
  const int c = rec / bH, bh = rec - c * bH;
  const Chunk ch = chunk_of(a, c, bh);
  const int L = ch.L, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* n_in = a.n_in + static_cast<long long>(rec) * a.dh;

  // Q K^T and dh V^T (t x j, a thread's 4 x 4 of each in registers) and
  // q . n_in, by slices of dh; then dh . h.
  float S[4][4] = {}, G[4][4] = {};
  float acc_qn = 0.0f;
  for (int e0 = 0; e0 < a.dh; e0 += kDot) {
    for (int i = tid; i < kDot * kChunk; i += kThreads) {
      const int e = i % kDot, t = i / kDot;
      const bool ok = t < L && e0 + e < a.dh;
      const long long at = ch.x0 + t * ch.t_stride + e0 + e;
      qs[e][t] = ok ? a.q[at] : 0.0f;
      ks[e][t] = ok ? a.k[at] : 0.0f;
      hs[e][t] = ok ? a.gh[at] : 0.0f;
      vs[e][t] = ok ? a.v[at] : 0.0f;
    }
    if (tid < kDot) ns[tid] = e0 + tid < a.dh ? n_in[e0 + tid] : 0.0f;
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < kDot; ++e) {
      float rq[4], rk[4], rh[4], rv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        rq[x] = qs[e][ty * 4 + x], rh[x] = hs[e][ty * 4 + x];
        rk[x] = ks[e][tx * 4 + x], rv[x] = vs[e][tx * 4 + x];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          S[x][y] = fmaf(rq[x], rk[y], S[x][y]);
          G[x][y] = fmaf(rh[x], rv[y], G[x][y]);
        }
      }
    }
    if (tid < kChunk) {
      for (int e = 0; e < kDot; ++e) acc_qn = fmaf(qs[e][tid], ns[e], acc_qn);
    }
    __syncthreads();
  }
  if (tid < kChunk) {
    qn[tid] = acc_qn;
  } else if (tid < 2 * kChunk) {  // dh_t . h_t, one thread a step
    const int t = tid - kChunk;
    float acc = 0.0f;
    if (t < L) {
      const long long at = ch.x0 + t * ch.t_stride;
      for (int e = 0; e < a.dh; ++e) acc = fmaf(a.gh[at + e], a.h[at + e], acc);
    }
    dhh[t] = acc;
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) Sm[ty * 4 + x][tx * 4 + y] = S[x][y];
  }

  // The gates: one thread, in step order, the sums in fp64 as the forward.
  float* vec = a.work + lay.vecs + static_cast<long long>(rec) * kNumVec * kChunk;
  float* scal = a.work + lay.scal + static_cast<long long>(rec) * 2;
  if (tid == 0) {
    const float m0 = a.m_in[rec];
    double b64[kChunk];
    double sum = 0.0;
    float run = -INFINITY;
    int ridx = 0;
    for (int t = 0; t < L; ++t) {
      const float it = a.ig[ch.g0 + static_cast<long long>(t) * a.H];
      sum += log_sigmoid(static_cast<double>(a.fg[ch.g0 + static_cast<long long>(t) * a.H]));
      b64[t] = sum;
      const float cum = static_cast<float>(sum), x = it - cum;
      if (x >= run) run = x, ridx = t;  // the latest index at a tie, as torch.cummax
      const float ma = cum + m0, mb = run + cum, m = fmaxf(ma, mb);
      bc[t] = cum, xs[t] = x, mt[t] = m;
      inter[t] = expf(cum + m0 - m);
      vec[kInter * kChunk + t] = inter[t];
      vec[kShare * kChunk + t] = max_share(ma, mb);
      vec[kRidx * kChunk + t] = static_cast<float>(ridx);
    }
    const double b_last64 = b64[L - 1];
    const float b_last = static_cast<float>(b_last64);
    const float oa = b_last + m0, ob = run + b_last, m_out = fmaxf(oa, ob);
    scal[0] = static_cast<float>(exp(b_last64 + m0 - static_cast<double>(m_out)));
    scal[1] = max_share(oa, ob);
    for (int j = 0; j < L; ++j) {
      const float it = a.ig[ch.g0 + static_cast<long long>(j) * a.H];
      vec[kW * kChunk + j] =
          static_cast<float>(exp(b_last64 - b64[j] + it - static_cast<double>(m_out)));
    }
  }
  __syncthreads();

  // D and W = D * S (j <= t), then each step's denominator and scalars.
  for (int i = tid; i < kChunk * kChunk; i += kThreads) {
    const int t = i / kChunk, j = i - t * kChunk;
    const float d = t < L && j <= t ? expf(bc[t] - mt[t] + xs[j]) : 0.0f;
    Dm[t][j] = d;
    Sm[t][j] *= d;
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
    vec[kInvG * kChunk + t] = inv;
    vec[kA * kChunk + t] = a_t;
    vec[kE * kChunk + t] = e;
    vec[kDinter * kChunk + t] = dinter;
  }
  __syncthreads();
  // dW_tj = (dh_t . v_j) / g_t + dden_t (G holds dh_t . v_j); dS = dW * D;
  // P = dW * W, which replaces D.
  float* w_mat = a.work + lay.w_mat + static_cast<long long>(rec) * kChunk * kChunk;
  float* ds_mat = a.work + lay.ds_mat + static_cast<long long>(rec) * kChunk * kChunk;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int t = ty * 4 + x, j = tx * 4 + y;
      const float dW = t < L && j <= t ? G[x][y] * vec[kInvG * kChunk + t] + dden[t] : 0.0f;
      const float W = Sm[t][j];
      w_mat[t * kChunk + j] = W;
      ds_mat[t * kChunk + j] = dW * Dm[t][j];
      Dm[t][j] = dW * W;  // each thread reads and writes only its own elements
    }
  }
  __syncthreads();
  if (tid < kChunk) {  // P's row and column sums
    float r = 0.0f, cl = 0.0f;
    for (int j = 0; j < kChunk; ++j) r += Dm[tid][j];
    for (int t = 0; t < kChunk; ++t) cl += Dm[t][tid];
    vec[kRowP * kChunk + tid] = r;
    vec[kColP * kChunk + tid] = cl;
  }
}

// 2. state: dC_out of every chunk, by 64 x 64 tiles, the chunks in reverse.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_state_kernel(Args a) {
  __shared__ float As[kSlice][kTile], Qs[kSlice][kTile];
  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int bh = blockIdx.x, bH = a.b * a.H, d = a.dh;
  const int v0 = blockIdx.y * kTile, k0 = blockIdx.z * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_chunks = (a.s + kChunk - 1) / kChunk;
  const long long dc_head = static_cast<long long>(bh) * d * d;

  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int vr = v0 + ty * 4 + x, kc = k0 + tx * 4 + y;
      acc[x][y] = a.dc != nullptr && vr < d && kc < d ? a.dc[dc_head + vr * d + kc] : 0.0f;
    }
  }
  const bool carries_n = blockIdx.y == 0 && tid < kTile && k0 + tid < d;
  float dn = carries_n && a.dn != nullptr ? a.dn[static_cast<long long>(bh) * d + k0 + tid] : 0.0f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const long long rec = static_cast<long long>(c) * bH + bh;
    const Chunk ch = chunk_of(a, c, bh);
    const float* vec = a.work + lay.vecs + rec * kNumVec * kChunk;
    const float s_out = a.work[lay.scal + rec * 2];
    float* dco = a.work + lay.dco + rec * d * d;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int vr = v0 + ty * 4 + x, kc = k0 + tx * 4 + y;
        if (vr < d && kc < d) dco[vr * d + kc] = acc[x][y];
        acc[x][y] *= s_out;
      }
    }
    if (carries_n) {
      a.work[lay.dno + rec * d + k0 + tid] = dn;
      dn *= s_out;
    }
    for (int t0 = 0; t0 < ch.L; t0 += kSlice) {
      __syncthreads();
      for (int i = tid; i < kSlice * kTile; i += kThreads) {
        const int col = i % kTile, tt = i / kTile, t = t0 + tt;
        const bool ok = t < ch.L;
        const long long at = ch.x0 + t * ch.t_stride;
        As[tt][col] = ok && v0 + col < d ? vec[kA * kChunk + t] * a.gh[at + v0 + col] : 0.0f;
        Qs[tt][col] = ok && k0 + col < d ? a.q[at + k0 + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int tt = 0; tt < kSlice; ++tt) {
        float ra[4], rq[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) ra[x] = As[tt][ty * 4 + x], rq[x] = Qs[tt][tx * 4 + x];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(ra[x], rq[y], acc[x][y]);
        }
      }
      if (carries_n) {
        for (int tt = 0; tt < kSlice && t0 + tt < ch.L; ++tt) {
          dn = fmaf(vec[kE * kChunk + t0 + tt], Qs[tt][tid], dn);
        }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int vr = v0 + ty * 4 + x, kc = k0 + tx * 4 + y;
      if (vr < d && kc < d) a.dc0[dc_head + vr * d + kc] = acc[x][y];
    }
  }
  if (carries_n) a.dn0[static_cast<long long>(bh) * d + k0 + tid] = dn;
}

// acc[x][y] += sum_kk A(row, kk) B(kk, col) over kk < n, for the block's
// 64 x 64 tile (rows ty * 4 + x, columns tx * 4 + y), staged kSlice at a
// time. kBRows: B is read along its rows (B(kk, col) at col fastest),
// else along kk.
template <bool kBRows, class FA, class FB>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], int n, int rows, int cols,
                                             FA A, FB B, float (&As)[kSlice][kTile + 1],
                                             float (&Bs)[kSlice][kTile + 1]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < n; k0 += kSlice) {
    __syncthreads();
    for (int i = tid; i < kSlice * kTile; i += kThreads) {
      const int kk = i % kSlice, r = i / kSlice;
      As[kk][r] = r < rows && k0 + kk < n ? A(r, k0 + kk) : 0.0f;
      const int kb = kBRows ? i / kTile : kk, cb = kBRows ? i % kTile : r;
      Bs[kb][cb] = cb < cols && k0 + kb < n ? B(k0 + kb, cb) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      float ra[4], rb[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) ra[x] = As[kk][ty * 4 + x], rb[x] = Bs[kk][tx * 4 + x];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(ra[x], rb[y], acc[x][y]);
      }
    }
  }
  __syncthreads();
}

// Sum over the 16 column groups of each row's partials (in order) -> out[row].
__device__ __forceinline__ void row_sums(const float (&part)[4], float (&red)[16][kTile + 1],
                                         float* out) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int x = 0; x < 4; ++x) red[tx][ty * 4 + x] = part[x];
  __syncthreads();
  if (tid < kTile) {
    float r = 0.0f;
    for (int g = 0; g < 16; ++g) r += red[g][tid];
    out[tid] = r;
  }
  __syncthreads();
}

enum Product { kQC, kDQ, kDV, kDK };

// 3. products: an L x 64 tile of one product of one chunk of one head.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_products_kernel(Args a) {
  __shared__ float As[kSlice][kTile + 1], Bs[kSlice][kTile + 1];
  __shared__ float red[16][kTile + 1];
  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int rec = blockIdx.x, bH = a.b * a.H, d = a.dh;
  const int c = rec / bH, bh = rec - c * bH;
  const int tile = blockIdx.y, col0 = tile * kTile;
  const Chunk ch = chunk_of(a, c, bh);
  const int L = ch.L, cols = min(kTile, d - col0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* vec = a.work + lay.vecs + static_cast<long long>(rec) * kNumVec * kChunk;
  const float* w_mat = a.work + lay.w_mat + static_cast<long long>(rec) * kChunk * kChunk;
  const float* ds_mat = a.work + lay.ds_mat + static_cast<long long>(rec) * kChunk * kChunk;
  const float* C = a.c_in + static_cast<long long>(rec) * d * d;
  const float* dco = a.work + lay.dco + static_cast<long long>(rec) * d * d;
  const float* dno = a.work + lay.dno + static_cast<long long>(rec) * d;
  const float* n_in = a.n_in + static_cast<long long>(rec) * d;
  const float *q = a.q + ch.x0, *k = a.k + ch.x0, *v = a.v + ch.x0, *dh = a.gh + ch.x0;
  const long long T = ch.t_stride;
  const long long part = static_cast<long long>(rec) * lay.tiles + tile;

  float acc[4][4] = {};
  switch (blockIdx.z) {
    case kQC: {  // q_t . C_in[v] for the tile's v; partial d inter_t and ds
      tile_product<false>(acc, d, L, cols, [&](int t, int e) { return q[t * T + e]; },
                          [&](int e, int col) { return C[static_cast<long long>(col0 + col) * d + e]; },
                          As, Bs);
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = ty * 4 + x;
        p[x] = 0.0f;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int col = tx * 4 + y;
          if (t < L && col < cols) p[x] = fmaf(dh[t * T + col0 + col] * vec[kInvG * kChunk + t], acc[x][y], p[x]);
        }
      }
      row_sums(p, red, a.work + lay.p_inter + part * kChunk);
      // ds: sum over the tile's rows v of dC_out[v] . C_in[v]
      float s = 0.0f;
      for (long long i = tid; i < static_cast<long long>(cols) * d; i += kThreads) {
        const long long at = static_cast<long long>(col0) * d + i;
        s = fmaf(dco[at], C[at], s);
      }
      red[tid / kTile][tid % kTile] = s;
      __syncthreads();
      if (tid == 0) {
        float r = 0.0f;
        for (int i = 0; i < kThreads; ++i) r += red[i / kTile][i % kTile];
        a.work[lay.p_s + part] = r;
      }
      return;
    }
    case kDQ: {  // dq_t = C_in^T (a_t dh_t) + sum_j dS_tj k_j + e_t n_in
      tile_product<true>(acc, d, L, cols, [&](int t, int e) { return vec[kA * kChunk + t] * dh[t * T + e]; },
                         [&](int e, int col) { return C[static_cast<long long>(e) * d + col0 + col]; },
                         As, Bs);
      tile_product<true>(acc, L, L, cols, [&](int t, int j) { return ds_mat[t * kChunk + j]; },
                         [&](int j, int col) { return k[j * T + col0 + col]; }, As, Bs);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int t = ty * 4 + x, col = tx * 4 + y;
          if (t < L && col < cols) {
            a.dq[ch.x0 + t * T + col0 + col] = fmaf(vec[kE * kChunk + t], n_in[col0 + col], acc[x][y]);
          }
        }
      }
      return;
    }
    case kDV: {  // dC_out k_j, its partial dw_j, then dv_j = w_j dC_out k_j + sum_t W_tj dnum_t
      tile_product<false>(acc, d, L, cols, [&](int j, int e) { return k[j * T + e]; },
                          [&](int e, int col) { return dco[static_cast<long long>(col0 + col) * d + e]; },
                          As, Bs);
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = ty * 4 + x;
        p[x] = 0.0f;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int col = tx * 4 + y;
          if (j < L && col < cols) p[x] = fmaf(v[j * T + col0 + col], acc[x][y], p[x]);
          acc[x][y] *= j < L ? vec[kW * kChunk + j] : 0.0f;
        }
      }
      row_sums(p, red, a.work + lay.p_w + part * kChunk);
      tile_product<true>(acc, L, L, cols,
                         [&](int j, int t) { return w_mat[t * kChunk + j] * vec[kInvG * kChunk + t]; },
                         [&](int t, int col) { return dh[t * T + col0 + col]; }, As, Bs);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int j = ty * 4 + x, col = tx * 4 + y;
          if (j < L && col < cols) a.dv[ch.x0 + j * T + col0 + col] = acc[x][y];
        }
      }
      return;
    }
    default: {  // dk_j = w_j (dC_out^T v_j + dn_out) + sum_t dS_tj q_t
      tile_product<true>(acc, d, L, cols, [&](int j, int e) { return vec[kW * kChunk + j] * v[j * T + e]; },
                         [&](int e, int col) { return dco[static_cast<long long>(e) * d + col0 + col]; },
                         As, Bs);
      tile_product<true>(acc, L, L, cols, [&](int j, int t) { return ds_mat[t * kChunk + j]; },
                         [&](int t, int col) { return q[t * T + col0 + col]; }, As, Bs);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int j = ty * 4 + x, col = tx * 4 + y;
          if (j < L && col < cols) {
            a.dk[ch.x0 + j * T + col0 + col] = fmaf(vec[kW * kChunk + j], dno[col0 + col], acc[x][y]);
          }
        }
      }
      return;
    }
  }
}

// 4. scalars: the gates' gradients and dm, the chunks in reverse.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_scalars_kernel(Args a) {
  __shared__ float dnk[kChunk], dinter[kChunk], dw[kChunk];
  __shared__ float dnn;
  const Layout lay = layout(a.b, a.s, a.H, a.dh);
  const int bh = blockIdx.x, bH = a.b * a.H, d = a.dh, tid = threadIdx.x;
  const int n_chunks = (a.s + kChunk - 1) / kChunk;
  float dM = a.dm != nullptr ? a.dm[bh] : 0.0f;  // thread 0's carry
  for (int c = n_chunks - 1; c >= 0; --c) {
    const long long rec = static_cast<long long>(c) * bH + bh;
    const Chunk ch = chunk_of(a, c, bh);
    const int L = ch.L;
    const float* vec = a.work + lay.vecs + rec * kNumVec * kChunk;
    const float* dno = a.work + lay.dno + rec * d;
    const float* n_in = a.n_in + rec * d;
    // dn_out . k_j for every step, and dn_out . n_in
    if (tid <= kChunk) {
      float s = 0.0f;
      if (tid < L) {
        const float* kj = a.k + ch.x0 + tid * ch.t_stride;
        for (int e = 0; e < d; ++e) s = fmaf(dno[e], kj[e], s);
      } else if (tid == kChunk) {
        for (int e = 0; e < d; ++e) s = fmaf(dno[e], n_in[e], s);
      }
      if (tid < kChunk) dnk[tid] = s;
      else dnn = s;
    }
    // the tiles' partial sums, in tile order
    if (tid < kChunk) {
      float pi = vec[kDinter * kChunk + tid], pw = 0.0f;
      for (long long t = 0; t < lay.tiles; ++t) {
        const long long part = rec * lay.tiles + t;
        pi += a.work[lay.p_inter + part * kChunk + tid];
        pw += a.work[lay.p_w + part * kChunk + tid];
      }
      dinter[tid] = pi;
      dw[tid] = pw;
    }
    __syncthreads();
    if (tid == 0) {
      float ds = 0.0f;
      for (long long t = 0; t < lay.tiles; ++t) ds += a.work[lay.p_s + rec * lay.tiles + t];
      ds += dnn;
      const float s_out = a.work[lay.scal + rec * 2], share_out = a.work[lay.scal + rec * 2 + 1];
      float db[kChunk], dx[kChunk], dr[kChunk];
      const float R = ds * s_out;
      float sum_q = 0.0f, sum_pw = 0.0f;
      for (int t = 0; t < L; ++t) {
        const float Q = dinter[t] * vec[kInter * kChunk + t];
        const float Pw = (dw[t] + dnk[t]) * vec[kW * kChunk + t];
        const float rows = vec[kRowP * kChunk + t] + Q;
        sum_q += Q;
        sum_pw += Pw;
        db[t] = rows;
        dx[t] = vec[kColP * kChunk + t] + Pw;
        dr[t] = 0.0f;
      }
      const float dmo = dM - R - sum_pw;
      db[L - 1] += R + sum_pw + dmo;
      float dm_in = sum_q + R + share_out * dmo;
      dr[L - 1] = (1.0f - share_out) * dmo;
      for (int t = 0; t < L; ++t) {
        const float dm_t = -(vec[kRowP * kChunk + t] + dinter[t] * vec[kInter * kChunk + t]);
        const float share = vec[kShare * kChunk + t];
        db[t] += dm_t;
        dm_in += share * dm_t;
        dr[t] += (1.0f - share) * dm_t;
      }
      for (int t = 0; t < L; ++t) dx[static_cast<int>(vec[kRidx * kChunk + t])] += dr[t];
      float dlf = 0.0f;
      for (int t = L - 1; t >= 0; --t) {
        dlf += db[t] - dx[t];
        const long long g = ch.g0 + static_cast<long long>(t) * a.H;
        a.di[g] = dx[t];
        a.df[g] = dlf / (1.0f + expf(a.fg[g]));  // d log sigmoid(f) / df = sigmoid(-f)
      }
      dM = dm_in;
    }
    __syncthreads();
  }
  if (tid == 0) a.dm0[bh] = dM;
}

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
  const Args a{f(q), f(k), f(v), f(ig), f(fg), f(c_in), f(n_in), f(m_in), f(h), f(dh), f(dc),
               f(dn), f(dm), w(dq), w(dk), w(dv), w(di), w(df), w(dc0), w(dn0), w(dm0),
               w(work), b, s, H, d};
  const Layout lay = layout(b, s, H, d);
  const int tiles = static_cast<int>(lay.tiles), bH = b * H;
  if (lay.recs > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  mlstm_bwd_gates_kernel<<<static_cast<unsigned>(lay.recs), kThreads, 0, st>>>(a);
  mlstm_bwd_state_kernel<<<dim3(bH, tiles, tiles), kThreads, 0, st>>>(a);
  mlstm_bwd_products_kernel<<<dim3(static_cast<unsigned>(lay.recs), tiles, 4), kThreads, 0, st>>>(a);
  mlstm_bwd_scalars_kernel<<<bH, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
