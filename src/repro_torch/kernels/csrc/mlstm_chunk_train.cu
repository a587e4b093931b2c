// The forward of a chunkwise mLSTM training step for Hopper (sm_90a), fp32:
// h for every step, the new state (C, n, m) into fresh buffers, and the
// state each chunk starts from, which mlstm_chunk_bwd.cu reads instead of
// running the forward again. No input is written.
//
// No TPU kernel: the JAX package trains through its recurrence
// (src/repro/models/xlstm.py:130 _mlstm_chunked, and a per-step scan below
// 128 tokens), which XLA runs and differentiates; mlstm_chunk.cu replaces
// the Pallas kernel (src/repro/kernels/mlstm_chunk/mlstm_chunk.py:112) for
// serving. It computes that kernel's chunkwise algebra (mlstm_chunk.cu's
// note has it) from a carried state, with the last chunk partial and the
// masked tail decaying nothing. The plain version is
// kernels/mlstm_chunk/ref.py:mlstm_chunk_train_ref; its split_tf32=True
// form computes the four products as these kernels do.
//
// Layout: q, k, v and out (b, s, H, dh), gates i and f (b, s, H), all
// contiguous fp32; C (b, H, dh, dh) with C[v][k], n (b, H, dh), m (b, H);
// the chunks' input states (nC, b, H, dh, dh), (nC, b, H, dh), (nC, b, H).
//
// What bounds it: at the launcher's training step (batch 8, seq 64,
// xLSTM-1.3B's 4 heads of 512) it must read C and q, k, v and write C, the
// chunk's input C, and h: 117 MB, 0.035 ms at 3.35 TB/s; its products
// (q C_in, C's update, the scores and W V) are 2.3 GFLOP, 0.034 ms at 67
// TFLOP/s fp32. So memory, with the products close behind.
//
// Design: the gates and the L x L scores of a (chunk, head) once, not once
// per 16 rows of C, and all four products on the tensor cores, in three
// kernels on one stream (one call of the entry):
// 1. slices: a block per (head, 64 columns of dh) walks the chunks in
//    order with its slice of n in shared memory. Per chunk: the chunk's 64
//    steps of q and k for its columns arrive by 16-byte cp.async while warp
//    0 scans the gates (fp64 sums; the m chain from chunk to chunk); its
//    share of S = Q K^T on the tensor cores (each warp a 16-step row tile
//    and four 8-step key tiles, none where all four lie above the
//    diagonal) and of q_t . n_in, both to the workspace; n's update over
//    its columns in fp64, rounded once. It writes n and m of each chunk's
//    input state.
// 2. scores: a block per (chunk, head) scans the chunk's gates again from
//    the m the first pass recorded (the same code, so the same bits), adds
//    the slices' shares of S and of q . n_in in slice order, and writes a
//    record to the workspace: W = D * S with D_tj = e^{b_t - m_t + x_j}, and
//    inter_t, den_t = max(|inter_t q_t . n_in + sum_j W_tj|, 1), w_j and
//    s_out (17 KB).
// 3. rows: a block per (head, 32 value rows of C) keeps its rows of C in
//    shared memory from the first chunk to the last (zeros past dh), two
//    blocks an SM. Per chunk, reading the record from L2, with the chunk's
//    q, then its k, streamed through a double buffer of 32-column slices:
//    - the chunk's input C rows go out to the chunk states;
//    - q C_in^T, then h = (W V + inter * q C_in^T) / den, each warp two
//      16 x 8 tiles of (step, row), q and C with the k index in pairs;
//    - C = s_out C + (w o V)^T K, each warp 8-column tiles of all 32 rows:
//      w_j v_j in fp64 rounded once, the product on the tensor cores, then
//      s_out C added in fp64, rounded once.
// The products in mma_tf32.cuh's 3xTF32, no branch between the tiles of a
// step (tiles past the chunk are zeros); the gates' sums, s_out and w in
// fp64 as mlstm_chunk.cu needs them (its mlstm_grid_l65_dh512_bh8 pin). No
// atomics and sums in a fixed order: two launches give the same bits.
//
// Shared memory: slices 38 KB; scores 19 KB; rows 107 KB at dh 512 (two
// blocks an SM), 173 KB at dh 1,024: C's rows, the slices' double buffer,
// and the rows' v and w v.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;         // time steps per chunk
constexpr int kSlice = 64;         // columns of dh a block of the slices pass owns
constexpr int kLdS = kSlice + 4;   // its row stride of q and k (frag_a, frag_b_t)
constexpr int kLdW = kChunk + 4;   // row stride of S and W in shared memory
constexpr int kRows = 32;          // value rows of C a block of the rows pass owns
constexpr int kRing = 2;           // its double buffer of slices (one in flight)
constexpr int kRSlice = 32;        // columns of dh a slice of its stream
constexpr int kLdR = kRSlice + 8;  // their row stride (float2 pairs, frag_b)
constexpr int kParts = kThreads / kSlice;  // threads that share a column of n's update

// The workspace: a record per (chunk, head), in floats: W (kChunk x kChunk,
// zero past the chunk and above the diagonal), then inter_t, den_t, w_j
// (kChunk doubles) and s_out (a double); 16-byte aligned. After the
// records, each (chunk, head, slice)'s share of S (kChunk x kChunk), then
// of q . n_in (kChunk).
constexpr int kRecInter = kChunk * kChunk;
constexpr int kRecDen = kRecInter + kChunk;
constexpr int kRecWj = kRecDen + kChunk;
constexpr int kRecSo = kRecWj + 2 * kChunk;
constexpr int kRecFloats = kRecSo + 4;

__device__ __forceinline__ double log_sigmoid(double x) {
  return fmin(x, 0.0) - log1p(exp(-fabs(x)));
}

// The gates of a chunk of L steps from the state's m0, on warp 0 (every
// lane): a cumulative sum and a running max over the chunk's real steps,
// lane l holding steps l and l + 32 (as mlstm_chunk.cu's chunked pass).
// Writes b_t, x_t, m_t and inter_t for t < L, w_j (0 past the chunk), s_out
// and the chunk's output m (lane 0).
__device__ __forceinline__ void chunk_gates(const float* __restrict__ ig,
                                            const float* __restrict__ fg, long long g0, int H,
                                            int c0, int L, float m0, float* bc, float* xs,
                                            float* mt, float* inter, double* wj, double* s_out,
                                            float* m_next) {
  const int lane = threadIdx.x % 32;
  float it[2], cum[2], run[2];
  double sum[2];  // b_t in fp64: the state's weights take it as it is, the rest its fp32 rounding
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = lane + 32 * half;
    const long long gi = g0 + static_cast<long long>(c0 + t) * H;
    it[half] = t < L ? ig[gi] : 0.0f;
    sum[half] = t < L ? log_sigmoid(static_cast<double>(fg[gi])) : 0.0;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    for (int d = 1; d < 32; d *= 2) {
      const double up = __shfl_up_sync(0xffffffffu, sum[half], d);
      if (lane >= d) sum[half] += up;
    }
  }
  sum[1] += __shfl_sync(0xffffffffu, sum[0], 31);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = lane + 32 * half;
    cum[half] = static_cast<float>(sum[half]);
    run[half] = t < L ? it[half] - cum[half] : -INFINITY;
    for (int d = 1; d < 32; d *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, run[half], d);
      if (lane >= d) run[half] = fmaxf(run[half], up);
    }
  }
  run[1] = fmaxf(run[1], __shfl_sync(0xffffffffu, run[0], 31));
  const int last = L - 1;  // the chunk's last real step
  const double b_last64 = __shfl_sync(0xffffffffu, last < 32 ? sum[0] : sum[1], last % 32);
  const float b_last = static_cast<float>(b_last64);
  const float run_last = __shfl_sync(0xffffffffu, last < 32 ? run[0] : run[1], last % 32);
  const float m_new = fmaxf(b_last + m0, run_last + b_last);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = lane + 32 * half;
    if (t < L) {
      const float m = fmaxf(cum[half] + m0, run[half] + cum[half]);
      bc[t] = cum[half];
      xs[t] = it[half] - cum[half];
      mt[t] = m;
      inter[t] = expf(cum[half] + m0 - m);
      wj[t] = exp(b_last64 - sum[half] + it[half] - static_cast<double>(m_new));
    } else {
      wj[t] = 0.0;  // past the chunk: sums over every step of a slice add nothing
    }
  }
  if (lane == 0) {
    *s_out = exp(b_last64 + m0 - static_cast<double>(m_new));
    *m_next = m_new;
  }
}

// The chunk's kChunk steps of q or k (step t at src + t * t_stride), columns
// [col0, col0 + kW) of dh, into rows of ld floats: zeros past the chunk's
// L steps and past dh; 16-byte cp.async when dh % 4 == 0 (the rows are then
// aligned), else plain loads.
template <int kW>
__device__ __forceinline__ void load_slice(float* dst, int ld, const float* src,
                                           long long t_stride, int L, int col0, int dh,
                                           bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kChunk * (kW / 4); i += kThreads) {
      const int r = i / (kW / 4), c = (i % (kW / 4)) * 4;
      const bool ok = r < L && col0 + c < dh;
      cp_async16(dst + r * ld + c, ok ? src + r * t_stride + col0 + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kW; i += kThreads) {
      const int r = i / kW, c = i % kW;
      dst[r * ld + c] = r < L && col0 + c < dh ? src[r * t_stride + col0 + c] : 0.0f;
    }
  }
}

struct Work {  // the workspace's parts
  float* rec;  // the records
  float* S;    // the slices' shares of S
  float* qn;   // and of q . n_in
};

__host__ __device__ inline Work work_parts(float* base, int n_chunks, int bH, int n_slices) {
  const long long recs = static_cast<long long>(n_chunks) * bH;
  return {base, base + recs * kRecFloats, base + recs * (kRecFloats + n_slices * kChunk * kChunk)};
}

size_t slices_smem_bytes() {
  return sizeof(double) * (kChunk + 2 + kParts * kSlice) +
         sizeof(float) * (4 * kChunk + 4 + kSlice + 2 * kChunk * kLdS);
}

// Pass 1: one head x 64 columns of dh per block, the chunks in order.
__global__ void __launch_bounds__(kThreads)
mlstm_train_slices_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ ig, const float* __restrict__ fg,
                          const float* __restrict__ n_in, const float* __restrict__ m_in,
                          float* __restrict__ n_out, float* __restrict__ m_out,
                          float* __restrict__ n_st, float* __restrict__ m_st, float* work,
                          int s, int H, int dh, int vec) {
  extern __shared__ __align__(16) double smem[];
  double* wj = smem;                // kChunk: the state's weights, fp64
  double* s_out = wj + kChunk;      // the state's decay, fp64 (then a double of padding)
  double* np = s_out + 2;           // kParts x kSlice: partial sums of n's update
  float* bc = reinterpret_cast<float*>(np + kParts * kSlice);  // kChunk each: the gates
  float* xs = bc + kChunk;
  float* mt = xs + kChunk;
  float* inter = mt + kChunk;
  float* m_sh = inter + kChunk;     // running m (then 3 floats of padding)
  float* ns = m_sh + 4;             // kSlice: n over the block's columns
  float* qsl = ns + kSlice;         // kChunk x kLdS: q over the block's columns
  float* ksl = qsl + kChunk * kLdS;  // kChunk x kLdS: k

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, si = blockIdx.y, bi = bh / H, hh = bh - bi * H;
  const int col0 = si * kSlice, ncols = min(kSlice, dh - col0);
  const int n_slices = gridDim.y;
  const long long t_stride = static_cast<long long>(H) * dh;  // one step of q, k
  const long long qkv0 = static_cast<long long>(bi) * s * t_stride + static_cast<long long>(hh) * dh;
  const long long g0 = static_cast<long long>(bi) * s * H + hh;
  const Work w = work_parts(work, (s + kChunk - 1) / kChunk, gridDim.x, n_slices);
  if (tid < kSlice) ns[tid] = tid < ncols ? n_in[static_cast<long long>(bh) * dh + col0 + tid] : 0.0f;
  if (tid == 0) *m_sh = m_in[bh];
  __syncthreads();

  const int mtile = warp % 4, nt0 = (warp / 4) * 4;  // the warp's tiles of S
  for (int c0 = 0; c0 < s; c0 += kChunk) {
    const int L = min(kChunk, s - c0);
    const long long rec = static_cast<long long>(c0 / kChunk) * gridDim.x + bh;
    load_slice<kSlice>(qsl, kLdS, q + qkv0 + c0 * t_stride, t_stride, L, col0, dh, vec != 0);
    load_slice<kSlice>(ksl, kLdS, k + qkv0 + c0 * t_stride, t_stride, L, col0, dh, vec != 0);
    cp_async_commit();
    if (tid < ncols) n_st[rec * dh + col0 + tid] = ns[tid];
    if (si == 0 && tid == 0) m_st[rec] = *m_sh;
    if (warp == 0) {  // while the slice lands
      chunk_gates(ig, fg, g0, H, c0, L, *m_sh, bc, xs, mt, inter, wj, s_out, m_sh);
    }
    cp_async_wait_all();
    __syncthreads();

    // this slice's share of S = Q K^T (zeros where a warp's four key tiles
    // all lie above the diagonal or past the chunk)
    {
      const bool live = 8 * nt0 < L && 8 * nt0 <= 16 * mtile + 15 && 16 * mtile < L;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      }
      if (live) {
#pragma unroll
        for (int kk = 0; kk < kSlice / 8; ++kk) {
          const FragA a = frag_a(qsl + 16 * mtile * kLdS + 8 * kk, kLdS, g, t4);
          FragB b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) b[i] = frag_b_t(ksl + 8 * (nt0 + i) * kLdS + 8 * kk, kLdS, g, t4);
          mma3_n(acc, a, b);
        }
      }
      float* S = w.S + (rec * n_slices + si) * (kChunk * kChunk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          S[(16 * mtile + g + 8 * (e / 2)) * kChunk + 8 * (nt0 + i) + 2 * t4 + (e & 1)] = acc[i][e];
        }
      }
    }
    // its share of q_t . n_in: a warp eight steps, lanes across the columns,
    // then a fixed xor tree
#pragma unroll
    for (int r = 0; r < kChunk / kWarps; ++r) {
      const int t = warp + kWarps * r;
      float a = fmaf(qsl[t * kLdS + lane + 32], ns[lane + 32], qsl[t * kLdS + lane] * ns[lane]);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) a += __shfl_xor_sync(0xffffffffu, a, m);
      if (lane == 0) w.qn[(rec * n_slices + si) * kChunk + t] = a;
    }
    // n = s_out n + sum_j w_j k_j over its columns in fp64: kParts threads
    // a column, then their sums in order, rounded once
    {
      const int c = tid % kSlice, part = tid / kSlice;
      double a = 0.0;
#pragma unroll
      for (int jj = 0; jj < kChunk / kParts; ++jj) {
        const int j = part * (kChunk / kParts) + jj;
        a = fma(wj[j], static_cast<double>(ksl[j * kLdS + c]), a);
      }
      np[part * kSlice + c] = a;
    }
    __syncthreads();  // the partial sums are in; q . n_in has read n
    if (tid < kSlice) {
      double a = *s_out * ns[tid];
#pragma unroll
      for (int part = 0; part < kParts; ++part) a += np[part * kSlice + tid];
      ns[tid] = tid < ncols ? static_cast<float>(a) : 0.0f;
    }
    __syncthreads();  // the next chunk's copies and gates overwrite the slices and w
  }
  if (tid < ncols) n_out[static_cast<long long>(bh) * dh + col0 + tid] = ns[tid];
  if (si == 0 && tid == 0) m_out[bh] = *m_sh;
}

size_t scores_smem_bytes() {
  return sizeof(double) * (kChunk + 2) + sizeof(float) * (kChunk * kLdW + 6 * kChunk + 4);
}

// Pass 2: one (chunk, head) per block: the gates again, S and q . n_in from
// the slices' shares, W, the denominators, the record.
__global__ void __launch_bounds__(kThreads)
mlstm_train_scores_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                          const float* __restrict__ m_st, float* work, int s, int H, int bH,
                          int n_slices) {
  extern __shared__ __align__(16) double smem[];
  double* wj = smem;                 // kChunk: e^{b_L - b_j + i_j - m_out}, fp64
  double* s_out = wj + kChunk;       // e^{b_L + m_in - m_out}, fp64 (then a double of padding)
  float* S = reinterpret_cast<float*>(s_out + 2);  // kChunk x kLdW: scores, then W
  float* bc = S + kChunk * kLdW;     // kChunk each: cumulative log forget gate b_t,
  float* xs = bc + kChunk;           //   x_t = i_t - b_t,
  float* mt = xs + kChunk;           //   the stabiliser m_t,
  float* inter = mt + kChunk;        //   e^{b_t + m_in - m_t},
  float* qn = inter + kChunk;        //   q_t . n_in,
  float* den = qn + kChunk;          //   max(|den_t|, 1)
  float* m_next = den + kChunk;      // the chunk's output m (unused here)

  const int tid = threadIdx.x;
  const long long rec = blockIdx.x;
  const int c0 = static_cast<int>(rec / bH) * kChunk, bh = static_cast<int>(rec % bH);
  const int L = min(kChunk, s - c0), bi = bh / H, hh = bh - bi * H;
  const long long g0 = static_cast<long long>(bi) * s * H + hh;
  const Work w = work_parts(work, (s + kChunk - 1) / kChunk, bH, n_slices);
  if (tid < 32) {
    chunk_gates(ig, fg, g0, H, c0, L, m_st[rec], bc, xs, mt, inter, wj, s_out, m_next);
  } else {  // meanwhile the other warps add the slices' shares in slice order, 4 floats a thread
    const float4* part = reinterpret_cast<const float4*>(w.S + rec * n_slices * (kChunk * kChunk));
    for (int i = tid - 32; i < kChunk * kChunk / 4; i += kThreads - 32) {
      float4 a = part[i];
      for (int si = 1; si < n_slices; ++si) {
        const float4 b = part[si * (kChunk * kChunk / 4) + i];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      *reinterpret_cast<float4*>(S + (4 * i / kChunk) * kLdW + 4 * i % kChunk) = a;
    }
    if (tid - 32 < kChunk) {
      const float* qp = w.qn + rec * n_slices * kChunk + tid - 32;
      float a = qp[0];
      for (int si = 1; si < n_slices; ++si) a += qp[si * kChunk];
      qn[tid - 32] = a;
    }
  }
  __syncthreads();
  // W = D * S on the chunk's lower triangle, zero elsewhere
  for (int i = tid; i < kChunk * kChunk; i += kThreads) {
    const int t = i / kChunk, j = i - t * kChunk;
    float* x = S + t * kLdW + j;
    *x = t < L && j <= t ? expf(bc[t] - mt[t] + xs[j]) * *x : 0.0f;
  }
  __syncthreads();
  float* rec_f = w.rec + rec * kRecFloats;
  for (int t = tid; t < kChunk; t += kThreads) {
    float d = 1.0f;
    if (t < L) {
      d = inter[t] * qn[t];
      for (int j = 0; j <= t; ++j) d += S[t * kLdW + j];
      d = fmaxf(fabsf(d), 1.0f);
    }
    rec_f[kRecInter + t] = t < L ? inter[t] : 0.0f;
    rec_f[kRecDen + t] = d;
    reinterpret_cast<double*>(rec_f + kRecWj)[t] = wj[t];
  }
  if (tid == 0) *reinterpret_cast<double*>(rec_f + kRecSo) = *s_out;
  for (int i = tid; i < kChunk * kChunk; i += kThreads) {
    rec_f[i] = S[(i / kChunk) * kLdW + i % kChunk];
  }
}

// A row of C in the rows kernel's shared memory: dh rounded up to 64 and 8
// floats, so a half-warp's float2 pairs hit distinct banks
__host__ __device__ constexpr int c_ld(int width) { return width + 8; }
constexpr int kLdV = kRows + 8;  // row stride of the rows' v and w v

size_t rows_smem_bytes(int width) {
  return sizeof(float) * (kRows * c_ld(width) + kRing * kChunk * kLdR + 2 * kChunk * kLdV);
}

// B with element (k, n) at p[n * ld + k] (B = X^T of a row-major X), k taken
// in pairs: (2t, n) and (2t + 1, n) as one float2
__device__ __forceinline__ FragB frag_b_pairs_t(const float* p, int ld, int g, int t) {
  const float2 x = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  FragB f;
  split(x.x, f.hi[0], f.lo[0]);
  split(x.y, f.hi[1], f.lo[1]);
  return f;
}

// Pass 3: one head x 32 value rows of C per block, the chunks in order. C's
// rows stay in shared memory from the first chunk to the last; the chunk's
// q, then its k, stream through a double buffer of 32-column slices. Each
// warp owns output tiles: of q C_in^T and h, steps 16 (w / 2) .. + 15 and
// rows 16 (w % 2) .. + 15; of C's update, in each slice, columns 8 (w % 4)
// .. + 7 of rows 16 (w / 4) .. + 15.
__global__ void __launch_bounds__(kThreads, 2)
mlstm_train_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ C_in,
                        float* __restrict__ C_out, float* __restrict__ out,
                        float* __restrict__ c_st, const float* __restrict__ work, int s, int H,
                        int dh, int vec) {
  constexpr int kR = kRows;
  constexpr int kNR = kR / 16;  // 8-row tiles of a warp's half of the rows in q C_in^T and h
  constexpr int kMC = kR / 32;  // 16-row tiles of its half of the rows in C's update
  extern __shared__ __align__(16) double smem[];     // the other kernels' declaration
  const int width = (dh + kSlice - 1) / kSlice * kSlice, ldc = c_ld(width);
  const int n_rs = (dh + kRSlice - 1) / kRSlice;      // slices of the stream, of q then of k
  float* Cs = reinterpret_cast<float*>(smem);         // kR x ldc: C's rows, zeros past dh
  float* sl = Cs + kR * ldc;                          // kRing buffers of kChunk x kLdR
  float* vs = sl + kRing * kChunk * kLdR;             // kChunk x kLdV: v_j of the rows
  float* vw = vs + kChunk * kLdV;                     // kChunk x kLdV: w_j v_j

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, bi = bh / H, hh = bh - bi * H;
  const int v0 = blockIdx.y * kR, nrows = min(kR, dh - v0);
  const long long t_stride = static_cast<long long>(H) * dh;
  const long long qkv0 = static_cast<long long>(bi) * s * t_stride + static_cast<long long>(hh) * dh;
  const long long dh2 = static_cast<long long>(dh) * dh;
  const long long rows0 = static_cast<long long>(bh) * dh2 + static_cast<long long>(v0) * dh;
  const int tt = warp / 2, r0 = (warp % 2) * (kR / 2);    // the warp's tiles of q C_in^T and h
  const int nc = warp % 4, rc = (warp / 4) * (kR / 2);    // its tiles of C's update in a slice

  // C's rows in, zeros past dh, by 16-byte copies where dh % 4 == 0
  if (vec) {
    for (int i = tid; i < kR * (width / 4); i += kThreads) {
      const int r = i / (width / 4), c = (i % (width / 4)) * 4;
      const bool ok = r < nrows && c < dh;
      cp_async16(Cs + r * ldc + c, ok ? C_in + rows0 + static_cast<long long>(r) * dh + c : C_in,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait_all();
  } else {
    for (int i = tid; i < kR * width; i += kThreads) {
      const int r = i / width, c = i % width;
      Cs[r * ldc + c] = r < nrows && c < dh ? C_in[rows0 + static_cast<long long>(r) * dh + c] : 0.0f;
    }
  }
  // C's rows out (to the chunk states, then to C_out), coalesced
  auto store_rows = [&](float* dst) {
    if (vec) {
      for (int i = tid; i < nrows * (dh / 4); i += kThreads) {
        const int r = i / (dh / 4), c = (i % (dh / 4)) * 4;
        *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * dh + c) =
            *reinterpret_cast<const float4*>(Cs + r * ldc + c);
      }
    } else {
      for (int i = tid; i < nrows * dh; i += kThreads) {
        const int r = i / dh, c = i % dh;
        dst[static_cast<long long>(r) * dh + c] = Cs[r * ldc + c];
      }
    }
  };
  __syncthreads();

  for (int c0 = 0; c0 < s; c0 += kChunk) {
    const int L = min(kChunk, s - c0);
    const long long rec = static_cast<long long>(c0 / kChunk) * gridDim.x + bh;
    const float* rec_f = work + rec * kRecFloats;
    const double* rec_w = reinterpret_cast<const double*>(rec_f + kRecWj);
    const double so = *reinterpret_cast<const double*>(rec_f + kRecSo);
    const float* qc = q + qkv0 + c0 * t_stride;
    const float* kc = k + qkv0 + c0 * t_stride;
    const float* vc = v + qkv0 + c0 * t_stride;
    // slice u of the stream: q's columns 32 u, then (u >= n_rs) k's
    auto load = [&](int u) {
      if (u < 2 * n_rs) {
        load_slice<kRSlice>(sl + (u % kRing) * kChunk * kLdR, kLdR, u < n_rs ? qc : kc, t_stride,
                            L, kRSlice * (u < n_rs ? u : u - n_rs), dh, vec != 0);
      }
      cp_async_commit();
    };
    for (int u = 0; u < kRing - 1; ++u) load(u);

    store_rows(c_st + rec * dh2 + static_cast<long long>(v0) * dh);  // the state this chunk starts from
    for (int i = tid; i < kChunk * kR; i += kThreads) {  // the rows' v and w v, rounded once
      const int j = i / kR, r = i - j * kR;
      const float x = j < L && r < nrows ? vc[j * t_stride + v0 + r] : 0.0f;
      vs[j * kLdV + r] = x;
      vw[j * kLdV + r] = static_cast<float>(rec_w[j] * static_cast<double>(x));
    }

    float qa[kNR][4];
#pragma unroll
    for (int n = 0; n < kNR; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[n][e] = 0.0f;
    }
    for (int u = 0; u < 2 * n_rs; ++u) {
      load(u + kRing - 1);
      cp_async_wait_one();  // kRing - 1 = 1 slice stays in flight
      __syncthreads();  // the slice (and, at the first, the rows' v) is in
      const float* slb = sl + (u % kRing) * kChunk * kLdR;
      if (u < n_rs) {
        // q C_in^T over the slice's columns: A = q, B(k, r) = C[r][k], k in pairs
#pragma unroll
        for (int kk = 0; kk < kRSlice / 8; ++kk) {
          const int col = kRSlice * u + 8 * kk;
          FragB b[kNR];
#pragma unroll
          for (int n = 0; n < kNR; ++n) b[n] = frag_b_pairs_t(Cs + (r0 + 8 * n) * ldc + col, ldc, g, t4);
          mma3_n(qa, frag_a_pairs(slb + 16 * tt * kLdR + 8 * kk, kLdR, g, t4), b);
        }
        if (u == n_rs - 1 && 16 * tt < L) {
          // h = (W V + inter q C_in^T) / den for the same tiles, W from the
          // record (zero past the chunk and above the diagonal)
          float wv[kNR][4];
#pragma unroll
          for (int n = 0; n < kNR; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) wv[n][e] = 0.0f;
          }
#pragma unroll
          for (int kk = 0; kk < kChunk / 8; ++kk) {
            FragB b[kNR];
#pragma unroll
            for (int n = 0; n < kNR; ++n) b[n] = frag_b(vs + 8 * kk * kLdV + r0 + 8 * n, kLdV, g, t4);
            mma3_n(wv, frag_a(rec_f + 16 * tt * kChunk + 8 * kk, kChunk, g, t4), b);
          }
#pragma unroll
          for (int n = 0; n < kNR; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = 16 * tt + g + 8 * (e / 2), r = r0 + 8 * n + 2 * t4 + (e & 1);
              if (t < L && r < nrows) {
                out[qkv0 + (c0 + t) * t_stride + v0 + r] =
                    (wv[n][e] + rec_f[kRecInter + t] * qa[n][e]) / rec_f[kRecDen + t];
              }
            }
          }
        }
      } else {
        // C = s_out C + (w o V)^T K over the slice's columns: the product on
        // the tensor cores, then s_out C in fp64, rounded once
        float d[kMC][4];
#pragma unroll
        for (int m = 0; m < kMC; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[m][e] = 0.0f;
        }
#pragma unroll
        for (int kk = 0; kk < kChunk / 8; ++kk) {
          FragA a[kMC];
#pragma unroll
          for (int m = 0; m < kMC; ++m) a[m] = frag_a_t(vw + 8 * kk * kLdV + rc + 16 * m, kLdV, g, t4);
          mma3_m(d, a, frag_b(slb + 8 * kk * kLdR + 8 * nc, kLdR, g, t4));
        }
#pragma unroll
        for (int m = 0; m < kMC; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* x = Cs + (rc + 16 * m + g + 8 * (e / 2)) * ldc + kRSlice * (u - n_rs) + 8 * nc +
                       2 * t4 + (e & 1);
            *x = static_cast<float>(fma(so, static_cast<double>(*x), static_cast<double>(d[m][e])));
          }
        }
      }
      __syncthreads();  // the buffer is free for the slice kRing - 1 on
    }
  }
  store_rows(C_out + rows0);
}

struct Args {
  const float *q, *k, *v, *ig, *fg, *C_in, *n_in, *m_in;
  float *C_out, *n_out, *m_out, *out, *c_st, *n_st, *m_st, *work;
};

long long workspace_bytes(int b, int s, int H, int dh) {
  const long long recs = static_cast<long long>((s + kChunk - 1) / kChunk) * b * H;
  const int n_slices = (dh + kSlice - 1) / kSlice;
  return recs * (kRecFloats + n_slices * kChunk * (kChunk + 1)) * sizeof(float);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Bytes of the workspace mlstm_chunk_train_f32 takes: a record per (chunk,
// head) and the slices' shares of S and q . n_in.
extern "C" long long mlstm_chunk_train_workspace(int b, int s, int H, int dh) {
  return workspace_bytes(b, s, H, dh);
}

// q, k, v, i, f, C_in, n_in, m_in, C_out, n_out, m_out, out, and the chunks'
// input states C (nC, b, H, dh, dh), n (nC, b, H, dh), m (nC, b, H); the
// workspace (mlstm_chunk_train_workspace bytes); b, s, H, dh; stream. No
// input is written.
extern "C" int mlstm_chunk_train_f32(const void* q, const void* k, const void* v,
                                     const void* ig, const void* fg, const void* C_in,
                                     const void* n_in, const void* m_in, void* C_out,
                                     void* n_out, void* m_out, void* out, void* c_st,
                                     void* n_st, void* m_st, void* work, int b, int s, int H,
                                     int dh, void* stream) {
  if (b < 0 || s < 1 || H < 0 || dh < 1 || dh > 1024 || static_cast<long long>(b) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(ig),
               static_cast<const float*>(fg),   static_cast<const float*>(C_in),
               static_cast<const float*>(n_in), static_cast<const float*>(m_in),
               static_cast<float*>(C_out),      static_cast<float*>(n_out),
               static_cast<float*>(m_out),      static_cast<float*>(out),
               static_cast<float*>(c_st),       static_cast<float*>(n_st),
               static_cast<float*>(m_st),       static_cast<float*>(work)};
  const int vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(C_in) &&
                  aligned16(C_out) && aligned16(c_st) ? 1 : 0;
  const int bH = b * H, n_slices = (dh + kSlice - 1) / kSlice;
  const int n_chunks = (s + kChunk - 1) / kChunk;
  mlstm_train_slices_kernel<<<dim3(bH, n_slices), kThreads, slices_smem_bytes(), st>>>(
      a.q, a.k, a.ig, a.fg, a.n_in, a.m_in, a.n_out, a.m_out, a.n_st, a.m_st, a.work, s, H, dh,
      vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mlstm_train_scores_kernel<<<n_chunks * bH, kThreads, scores_smem_bytes(), st>>>(
      a.ig, a.fg, a.m_st, a.work, s, H, bH, n_slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  static const cudaError_t raised = cudaFuncSetAttribute(
      mlstm_train_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rows_smem_bytes(1024)));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  mlstm_train_rows_kernel<<<dim3(bH, (dh + kRows - 1) / kRows), kThreads,
                            rows_smem_bytes(n_slices * kSlice), st>>>(
      a.q, a.k, a.v, a.C_in, a.C_out, a.out, a.c_st, a.work, s, H, dh, vec);
  return static_cast<int>(cudaGetLastError());
}
