// Chunkwise mLSTM for Hopper (sm_90a): stabilised exponential gating,
// fp32 throughout, with the state (C, n, m) read in and written out.
//
// Replaces the TPU kernel
// src/repro/kernels/mlstm_chunk/mlstm_chunk.py:_mlstm_chunk_kernel
// (pl.pallas_call at :112) and computes its chunkwise algebra (the same as
// repro/models/xlstm.py:157-185). Per chunk of L <= 64 steps, with
// b_t = cumulative log-sigmoid forget gate and x_j = i_j - b_j:
//   m_t   = max(b_t + m_in, max_{j<=t} x_j + b_t)
//   num_t = e^{b_t + m_in - m_t} C_in q_t + sum_{j<=t} e^{b_t - m_t + x_j} (q_t . k_j) v_j
//   den_t = the same with n_in and 1 for C_in and v_j;  h_t = num_t / max(|den_t|, 1)
//   C_out = e^{b_L + m_in - m_out} C_in + sum_j e^{b_L - b_j + i_j - m_out} v_j k_j^T
// (n_out likewise with k_j), m_out = max(b_L + m_in, max_j x_j + b_L).
//
// Three things the Pallas kernel lacks, which serving needs:
// - State in and out. It starts from the carried (C, n, m), not from zero
//   and -1e30, and writes the new state: C in place (each block owns its
//   rows, so no block reads another's), n and m into fresh buffers (every
//   block reads all of n_in, so none may overwrite it).
// - Any length. The last chunk is partial: a prompt of 4-15 tokens is one
//   chunk of that length, a decode step one of length 1.
// - A masked tail. Positions past the sequence take no part at all, so
//   they cannot decay the returned state (the JAX wrapper zero-pads, and a
//   padded forget gate of 0 is log sigmoid(0) = -ln 2 per step); b_L and the
//   max over x_j run over real positions only.
//
// Layout: q, k, v and out (b, s, H, dh), gates i and f (b, s, H), all
// contiguous fp32; C (b, H, dh, dh) with C[v][k] as the reference keeps it,
// n (b, H, dh), m (b, H).
//
// This is the serving entry, mlstm_chunk_f32: C in place. The forward of a
// training step, which writes C fresh and each chunk's input state, is
// mlstm_chunk_train.cu.
//
// Two paths, one launch each.
//
// Decode (s = 1, every step after a prompt): a rank-1 update that reads C
// once and writes it once, so it is bound by the card's memory. Each warp
// owns 2 value rows of C; a lane reads its share of a row with 16-byte loads
// into registers (all of the warp's rows in flight at once) and in the same
// pass computes C_in[r] . q and writes C_out[r] = s * C_in[r] + w v[r] k.
// The scalars (the gates, q . k and q . n_in) come from L2: every warp
// computes them itself with shuffles, so the block never synchronises.
// Blocks of 16 rows: xLSTM-1.3B's 4 heads of 512 rows are 128 blocks.
// Each warp also writes its rows' entries of n_out; a head's first block
// writes m_out. C and n are rounded as the plain version's three operations.
//
// Chunked pass (s > 1: a prompt, or any longer call): the grid is
// (b * H) x (dh / 16), and half-warp r of a block owns value row r of the
// block's 16 rows of C in registers (dh / 16 floats a lane) from the first
// chunk to the last, so C is read once and written once and 128 blocks
// cover xLSTM-1.3B's 4 heads of 512. Per chunk of L <= 64 steps:
// - the gate recurrences (a cumulative sum and a running max) are a scan
//   across warp 0, two steps a lane, the sum in fp64;
// - q_t . C_in[r] for every t is the half-warp's registers against q_t;
//   the scores q_t . k_j (j <= t) and q_t . n_in are spread over all the
//   half-warps; each dot product is 16 lanes and a shuffle sum, with q and
//   k read from L2 and L1, never staged;
// - the outputs of the block's 16 rows, then C[r] updated in registers
//   and n in shared memory: weights, decay and sums in fp64, rounded once.
// Every block recomputes the chunk's gates and L x L scores; those are
// cheap next to its rows of C. No tensor cores and no TF32: the checks hold
// it to fp32 tolerances.
//
// What bounds it: at decode (one step, dh = 512) the state dominates: C
// read and written, 2 MB per head, about 0.0025 ms for xLSTM-1.3B's 4 heads
// at 3.35 TB/s, against about 2 * dh^2 operations per head. A long prefill
// does about 4 * s * 64 * dh operations per head for the scores, repeated in
// each of the dh / 16 blocks, and 4 * s * dh^2 for C: bound by arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // time steps per chunk
constexpr int kTV = 16;     // chunked pass: value rows of C per block, one a half-warp
constexpr int kSS = kChunk + 1;  // odd row stride of the scores

constexpr int kRowsPerWarp = 2;                            // decode: value rows per warp
constexpr int kDecodeRows = kThreads / 32 * kRowsPerWarp;  // decode: value rows per block

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ double log_sigmoid(double x) {
  return fmin(x, 0.0) - log1p(exp(-fabs(x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// V consecutive floats of global memory (16-byte loads when V = 4), or
// zeros. C goes through plain loads, since the kernel writes it.
template <int V>
__device__ __forceinline__ void load_vec(float (&dst)[V], const float* src, bool ok) {
  if constexpr (V == 4) {
    const float4 t = ok ? *reinterpret_cast<const float4*>(src) : make_float4(0, 0, 0, 0);
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = ok ? src[i] : 0.0f;
  }
}

// One decode step (s = 1) of head bh = blockIdx.x for value rows
// blockIdx.y * kDecodeRows ..: lane l of a warp holds elements
// (c * 32 + l) * V .. + V - 1 of a row, c < NC, so NC * 32 * V >= dh.
template <int V, int NC>
__global__ void __launch_bounds__(kThreads)
mlstm_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ ig,
                    const float* __restrict__ fg, float* __restrict__ C,
                    const float* __restrict__ n_in, const float* __restrict__ m_in,
                    float* __restrict__ n_out, float* __restrict__ m_out,
                    float* __restrict__ out, int dh) {
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * kDecodeRows + (threadIdx.x >> 5) * kRowsPerWarp;
  const size_t base = static_cast<size_t>(bh) * dh;  // q, k, v, out and n of the head
  float* Cb = C + base * dh;

  // The warp's rows of C first, all in flight at once; then q, k and n.
  float cv[kRowsPerWarp][NC][V], qv[NC][V], kv[NC][V];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = (c * 32 + lane) * V;
      load_vec<V>(cv[rr][c], Cb + static_cast<size_t>(r0 + rr) * dh + e, r0 + rr < dh && e < dh);
    }
  }
  float qk = 0.0f, qn = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e = (c * 32 + lane) * V;
    float nv[V];
    load_vec<V>(qv[c], q + base + e, e < dh);
    load_vec<V>(kv[c], k + base + e, e < dh);
    load_vec<V>(nv, n_in + base + e, e < dh);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      qk += qv[c][i] * kv[c][i];
      qn += qv[c][i] * nv[i];
    }
  }
  qk = warp_sum(qk);
  qn = warp_sum(qn);

  // The chunk algebra at L = 1: b_1 = log sigmoid(f), x_1 = i - b_1.
  const float it = ig[bh], m0 = m_in[bh];
  const float b1 = log_sigmoid(fg[bh]);
  const float x1 = it - b1;
  const float m_new = fmaxf(b1 + m0, x1 + b1);
  const float decay = expf(b1 + m0 - m_new);   // e^{b_1 + m_in - m_1}, the state's too
  const float w = expf(it - m_new);            // the step's weight in the new state
  const float W = expf(b1 - m_new + x1) * qk;  // D_11 (q . k)
  const float den = fmaxf(fabsf(decay * qn + W), 1.0f);

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = r0 + rr;
    if (r >= dh) break;  // the same for the whole warp
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < V; ++i) dot += cv[rr][c][i] * qv[c][i];
    }
    dot = warp_sum(dot);
    const float vr = v[base + r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = (c * 32 + lane) * V;
      if (e >= dh) continue;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {  // rounded as the plain version's three operations
        o[i] = __fadd_rn(__fmul_rn(decay, cv[rr][c][i]), __fmul_rn(vr, __fmul_rn(w, kv[c][i])));
      }
      float* dst = Cb + static_cast<size_t>(r) * dh + e;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dst[i] = o[i];
      }
    }
    if (lane == 0) {
      out[base + r] = (decay * dot + W * vr) / den;
      n_out[base + r] = __fadd_rn(__fmul_rn(decay, n_in[base + r]), __fmul_rn(w, k[base + r]));
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) m_out[bh] = m_new;
}

size_t smem_bytes(int dh) {
  return sizeof(double) * (kChunk + 2)     // the state's weights in fp64, first: 16-byte aligned
         + sizeof(float) * (dh             // n, so also 16-byte aligned
                            + kChunk * kSS        // scores, then W
                            + 2 * kChunk * kTV    // q . C and the block's v rows
                            + 7 * kChunk          // per-step gate values
                            + 1);                 // m
}

// Steps unrolled in the chunked pass's loop over t for q . C: 4 while a
// lane's row of C (NC * V floats) leaves the registers for it, else 1.
template <int kRowFloats> constexpr int kUnrollSteps = kRowFloats <= 32 ? 4 : 1;

// Sum over the 16 lanes of a half-warp (fixed tree), every lane gets it.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int d = 8; d > 0; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// A chunked pass over s steps (s > 1). Half-warp r of the block owns value
// row blockIdx.y * kTV + r of C in registers: lane l of it holds elements
// (i * 16 + l) * V .. + V - 1, i < NC, so NC * 16 * V >= dh.
template <int V, int NC>
__global__ void __launch_bounds__(kThreads)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, const float* C_in, float* C_out,
                   const float* __restrict__ n_in, const float* __restrict__ m_in,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   float* __restrict__ out, int s, int H, int dh) {
  extern __shared__ __align__(16) double smem[];
  double* wj = smem;                 // kChunk: e^{b_L - b_j + i_j - m_out}, fp64
  double* s_out = wj + kChunk;       // e^{b_L + m_in - m_out}, fp64 (then a double of padding)
  float* ns = reinterpret_cast<float*>(s_out + 2);  // dh: n, updated chunk by chunk
  float* S = ns + dh;                // kChunk x kSS: scores q_t . k_j, then W
  float* qC = S + kChunk * kSS;      // kChunk x kTV: q_t . C_in rows
  float* vs = qC + kChunk * kTV;     // kChunk x kTV: the block's v rows
  float* ig_s = vs + kChunk * kTV;   // kChunk each:
  float* bc = ig_s + kChunk;         //   cumulative log forget gate b_t
  float* xs = bc + kChunk;           //   x_t = i_t - b_t
  float* mt = xs + kChunk;           //   stabiliser m_t
  float* inter = mt + kChunk;        //   e^{b_t + m_in - m_t}
  float* qn = inter + kChunk;        //   q_t . n_in
  float* den = qn + kChunk;          //   max(|den_t|, 1)
  float* m_sh = den + kChunk;        // running m

  const int tid = threadIdx.x, warp = tid / 32, side = (tid / 16) & 1;
  const int r = tid / 16, ks = tid % 16;  // this half-warp's row of the block, lane in it
  const int bh = blockIdx.x;
  const int bi = bh / H, hh = bh - bi * H;
  const int v0 = blockIdx.y * kTV, row = v0 + r;
  const long long t_stride = static_cast<long long>(H) * dh;  // one step of q, k, v, out
  const long long qkv0 = static_cast<long long>(bi) * s * t_stride + static_cast<long long>(hh) * dh;
  const long long g0 = static_cast<long long>(bi) * s * H + hh;
  const long long head = static_cast<long long>(bh) * dh * dh;
  const float* Cb = C_in + head;

  float cr[NC][V];  // C[row] in registers from the first chunk to the last
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int e = (i * 16 + ks) * V;
    load_vec<V>(cr[i], Cb + static_cast<long long>(row) * dh + e, row < dh && e < dh);
  }
  for (int i = tid; i < dh; i += kThreads) ns[i] = n_in[static_cast<long long>(bh) * dh + i];
  if (tid == 0) *m_sh = m_in[bh];
  __syncthreads();

  for (int c0 = 0; c0 < s; c0 += kChunk) {
    const int L = min(kChunk, s - c0);

    // Gates: a cumulative sum and a running max over the chunk's real steps,
    // scanned across warp 0, which holds steps lane and lane + 32.
    if (tid < 32) {
      const float m0 = *m_sh;
      float it[2], cum[2], run[2];
      // b_t in fp64: the state's weights take it as it is, the outputs its
      // fp32 rounding
      double sum[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = tid + 32 * half;
        const long long g = g0 + static_cast<long long>(c0 + t) * H;
        it[half] = t < L ? ig[g] : 0.0f;
        sum[half] = t < L ? log_sigmoid(static_cast<double>(fg[g])) : 0.0;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        for (int d = 1; d < 32; d *= 2) {
          const double up = __shfl_up_sync(0xffffffffu, sum[half], d);
          if (tid >= d) sum[half] += up;
        }
      }
      sum[1] += __shfl_sync(0xffffffffu, sum[0], 31);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = tid + 32 * half;
        cum[half] = static_cast<float>(sum[half]);
        run[half] = t < L ? it[half] - cum[half] : -INFINITY;
        for (int d = 1; d < 32; d *= 2) {
          const float up = __shfl_up_sync(0xffffffffu, run[half], d);
          if (tid >= d) run[half] = fmaxf(run[half], up);
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
        const int t = tid + 32 * half;
        if (t < L) {
          const float m = fmaxf(cum[half] + m0, run[half] + cum[half]);
          ig_s[t] = it[half];
          bc[t] = cum[half];
          xs[t] = it[half] - cum[half];
          mt[t] = m;
          inter[t] = expf(cum[half] + m0 - m);
          wj[t] = exp(b_last64 - sum[half] + it[half] - static_cast<double>(m_new));
        }
      }
      __syncwarp();
      if (tid == 0) {
        *s_out = exp(b_last64 + m0 - static_cast<double>(m_new));
        *m_sh = m_new;
      }
    }
    const float* qc = q + qkv0 + c0 * t_stride;  // step t of the chunk at + t * t_stride
    const float* kc = k + qkv0 + c0 * t_stride;
    __syncthreads();  // the gates are written

    // q_t . C_in[row] for every step: the half-warp's registers against q_t.
#pragma unroll(kUnrollSteps<NC * V>)
    for (int t = 0; t < L; ++t) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e = (i * 16 + ks) * V;
        float qv[V];
        load_vec<V>(qv, qc + t * t_stride + e, e < dh);
#pragma unroll
        for (int x = 0; x < V; ++x) acc += cr[i][x] * qv[x];
      }
      acc = half_sum(acc);
      if (ks == 0) qC[t * kTV + r] = acc;
    }
    // Scores q_t . k_j (j <= t), then q_t . n: one item per half-warp, the
    // two halves of a warp side by side so that both run every shuffle.
    const int n_pairs = L * (L + 1) / 2, n_items = n_pairs + L;
    for (int base = 2 * warp; base < n_items; base += kThreads / 16) {
      const int item = base + side;
      int t = item - n_pairs, j = -1;  // an item past the pairs: q_t . n
      if (item < n_pairs) {
        t = static_cast<int>((sqrtf(8.0f * item + 1.0f) - 1.0f) * 0.5f);
        while (t * (t + 1) / 2 > item) --t;
        while ((t + 1) * (t + 2) / 2 <= item) ++t;
        j = item - t * (t + 1) / 2;
      }
      const bool live = item < n_items;
      const float* other = j >= 0 ? kc + j * t_stride : ns;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e = (i * 16 + ks) * V;
        float qv[V], ov[V];
        load_vec<V>(qv, qc + t * t_stride + e, live && e < dh);
        load_vec<V>(ov, other + e, live && e < dh);
#pragma unroll
        for (int x = 0; x < V; ++x) acc += qv[x] * ov[x];
      }
      acc = half_sum(acc);
      if (live && ks == 0) {
        if (j >= 0) {
          S[t * kSS + j] = acc;
        } else {
          qn[t] = acc;
        }
      }
    }
    __syncthreads();

    // W = D * scores; the block's v rows; the denominators; the outputs.
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i - t * L;
      S[t * kSS + j] = j <= t ? expf(bc[t] - mt[t] + xs[j]) * S[t * kSS + j] : 0.0f;
    }
    for (int i = tid; i < L * kTV; i += kThreads) {
      const int j = i / kTV, rr = i - j * kTV;
      vs[i] = v0 + rr < dh ? v[qkv0 + (c0 + j) * t_stride + v0 + rr] : 0.0f;
    }
    __syncthreads();
    for (int t = tid; t < L; t += kThreads) {
      float d = inter[t] * qn[t];
      for (int j = 0; j <= t; ++j) d += S[t * kSS + j];
      den[t] = fmaxf(fabsf(d), 1.0f);
    }
    __syncthreads();
    for (int i = tid; i < L * kTV; i += kThreads) {
      const int t = i / kTV, rr = i - t * kTV;
      if (v0 + rr >= dh) continue;
      float acc = 0.0f;
      for (int j = 0; j <= t; ++j) acc += S[t * kSS + j] * vs[j * kTV + rr];
      acc += inter[t] * qC[t * kTV + rr];
      out[qkv0 + (c0 + t) * t_stride + v0 + rr] = acc / den[t];
    }

    // State update: C[row] in registers, n in shared memory. An element of
    // C can be a near cancellation of its decayed self and the chunk's sum.
    // Taken in fp32 (the decay and the weights as fp32 exponentials of
    // rounded gate sums, then an L-long fp32 sum) it missed the state's
    // atol (1e-6) against the fp64 algebra where the plain version met it.
    // So the gates' log-sigmoid sums, the decay and the weights are fp64,
    // and C's and n's updates are taken in fp64, in step order, and rounded
    // once. A pass holds at most 32 fp64 sums a lane, all of a step's loads
    // in flight together.
    const double so = *s_out;
    constexpr int kG = NC * V <= 32 ? NC : 32 / V;  // row chunks summed in one pass
#pragma unroll
    for (int i0 = 0; i0 < NC; i0 += kG) {
      double acc[kG][V];
#pragma unroll
      for (int i = 0; i < kG; ++i) {
#pragma unroll
        for (int x = 0; x < V; ++x) acc[i][x] = so * cr[i0 + i][x];
      }
#pragma unroll 2
      for (int j = 0; j < L; ++j) {
        const double vw = vs[j * kTV + r] * wj[j];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const int e = ((i0 + i) * 16 + ks) * V;
          float kv[V];
          load_vec<V>(kv, kc + j * t_stride + e, e < dh);
#pragma unroll
          for (int x = 0; x < V; ++x) acc[i][x] = fma(vw, static_cast<double>(kv[x]), acc[i][x]);
        }
      }
#pragma unroll
      for (int i = 0; i < kG; ++i) {
#pragma unroll
        for (int x = 0; x < V; ++x) cr[i0 + i][x] = static_cast<float>(acc[i][x]);
      }
    }
    for (int e = tid; e < dh; e += kThreads) {
      double a = so * ns[e];
#pragma unroll 8
      for (int j = 0; j < L; ++j) a = fma(wj[j], static_cast<double>(kc[j * t_stride + e]), a);
      ns[e] = static_cast<float>(a);
    }
    __syncthreads();  // the next chunk's gates overwrite s_out, wj and friends
  }

#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int e = (i * 16 + ks) * V;
    if (row >= dh || e >= dh) continue;
    float* dst = C_out + head + static_cast<long long>(row) * dh + e;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(cr[i][0], cr[i][1], cr[i][2], cr[i][3]);
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x) dst[x] = cr[i][x];
    }
  }
  if (blockIdx.y == 0) {
    for (int i = tid; i < dh; i += kThreads) n_out[static_cast<long long>(bh) * dh + i] = ns[i];
    if (tid == 0) m_out[bh] = *m_sh;
  }
}

struct Args {
  const float *q, *k, *v, *ig, *fg;
  const float* C_in;
  float* C_out;  // C_in itself: C is written in place
  const float *n_in, *m_in;
  float *n_out, *m_out, *out;
};

template <int V, int NC>
int chunked_as(const Args& a, int b, int s, int H, int dh, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);  // under 48 KB for dh <= 1024
  const dim3 grid(b * H, (dh + kTV - 1) / kTV);
  mlstm_chunk_kernel<V, NC><<<grid, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.ig, a.fg, a.C_in, a.C_out, a.n_in, a.m_in, a.n_out, a.m_out, a.out, s, H,
      dh);
  return static_cast<int>(cudaGetLastError());
}

// The chunked kernel instantiated for the fewest registers that hold a row.
template <int V>
int chunked(const Args& a, int b, int s, int H, int dh, cudaStream_t stream) {
  const int n = (dh + 16 * V - 1) / (16 * V);
  if constexpr (V == 4) {
    if (n <= 4) return chunked_as<V, 4>(a, b, s, H, dh, stream);
    if (n <= 8) return chunked_as<V, 8>(a, b, s, H, dh, stream);
    if (n <= 16) return chunked_as<V, 16>(a, b, s, H, dh, stream);
  } else {
    if (n <= 16) return chunked_as<V, 16>(a, b, s, H, dh, stream);
    if (n <= 64) return chunked_as<V, 64>(a, b, s, H, dh, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int V, int NC>
int decode_as(const Args& a, int bH, int dh, cudaStream_t stream) {
  const dim3 grid(bH, (dh + kDecodeRows - 1) / kDecodeRows);
  mlstm_decode_kernel<V, NC><<<grid, kThreads, 0, stream>>>(
      a.q, a.k, a.v, a.ig, a.fg, a.C_out, a.n_in, a.m_in, a.n_out, a.m_out, a.out, dh);
  return static_cast<int>(cudaGetLastError());
}

// The decode kernel instantiated for the fewest loads a lane that cover dh.
template <int V>
int decode(const Args& a, int bH, int dh, cudaStream_t stream) {
  const int n = (dh + 32 * V - 1) / (32 * V);
  if (n <= 1) return decode_as<V, 1>(a, bH, dh, stream);
  if (n <= 2) return decode_as<V, 2>(a, bH, dh, stream);
  if (n <= 4) return decode_as<V, 4>(a, bH, dh, stream);
  if (n <= 8) return decode_as<V, 8>(a, bH, dh, stream);
  if constexpr (V == 1) {
    if (n <= 16) return decode_as<V, 16>(a, bH, dh, stream);
    if (n <= 32) return decode_as<V, 32>(a, bH, dh, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, i, f, C (in place), n_in, m_in, n_out, m_out, out; b, s, H, dh; stream
extern "C" int mlstm_chunk_f32(const void* q, const void* k, const void* v, const void* ig,
                               const void* fg, void* C, const void* n_in, const void* m_in,
                               void* n_out, void* m_out, void* out, int b, int s, int H,
                               int dh, void* stream) {
  if (b < 0 || s < 1 || H < 0 || dh < 1 || dh > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(ig),
               static_cast<const float*>(fg), static_cast<const float*>(C),
               static_cast<float*>(C), static_cast<const float*>(n_in),
               static_cast<const float*>(m_in), static_cast<float*>(n_out),
               static_cast<float*>(m_out), static_cast<float*>(out)};
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(C) &&
                   aligned16(n_in);
  if (s == 1) return vec ? decode<4>(a, b * H, dh, st) : decode<1>(a, b * H, dh, st);
  return vec ? chunked<4>(a, b, s, H, dh, st) : chunked<1>(a, b, s, H, dh, st);
}
