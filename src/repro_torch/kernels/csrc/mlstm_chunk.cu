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
// Design (right before fast). C is dh x dh fp32 per (batch, head): 1 MB at
// xLSTM-1.3B's dh = 512, far more than the 227 KB of shared memory a block
// may hold (the TPU kernel keeps the whole C in VMEM). So the grid is
// (b * H) x (dh / 32): each block owns 32 value rows of C (64 KB at
// dh = 512, kept in shared memory from the first chunk to the last), walks
// the chunks in order, and recomputes the chunk's gates, the L x L scores
// q_t . k_j and q_t . n_in itself; those are cheap next to its slice of C.
// q and k are staged in tiles of 64 key columns. The gate recurrences (a
// cumulative sum and a running max over <= 64 steps) run on one thread.
// No tensor cores and no TF32: the checks hold it to fp32 tolerances.
//
// What bounds it: at decode (one step, dh = 512) the state dominates: C
// read and written, 2 MB per head, about 0.0025 ms for xLSTM-1.3B's 4 heads
// at 3.35 TB/s, against about 2 * dh^2 operations per head. A long prefill
// does about 4 * s * 64 * dh operations per head for the scores, repeated in
// each of the dh / 32 blocks, and 4 * s * dh^2 for C: bound by arithmetic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // time steps per chunk
constexpr int kTV = 32;     // value rows of C per block
constexpr int kTK = 64;     // key columns per staged q / k tile
constexpr int kTS = kTK + 1;  // odd row stride of the staged tiles

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

size_t smem_floats(int dh) {
  return static_cast<size_t>(kTV) * (dh + 1)  // C slice
         + dh                                 // n
         + 2 * kChunk * kTS                   // q and k tiles
         + kChunk * kTV                       // v tile
         + kChunk * kChunk                    // scores, then W
         + kChunk * kTV                       // q . C
         + 8 * kChunk                         // per-step gate values
         + 2;                                 // m, s_out
}

__global__ void __launch_bounds__(kThreads)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, float* __restrict__ C,
                   const float* __restrict__ n_in, const float* __restrict__ m_in,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   float* __restrict__ out, int s, int H, int dh) {
  extern __shared__ float smem[];
  const int cs = dh + 1;  // odd row stride of the C slice
  float* Cs = smem;                  // kTV x cs
  float* ns = Cs + kTV * cs;         // dh
  float* qs = ns + dh;               // kChunk x kTS
  float* ks = qs + kChunk * kTS;     // kChunk x kTS (k, then w_j * k in the update)
  float* vs = ks + kChunk * kTS;     // kChunk x kTV
  float* S = vs + kChunk * kTV;      // kChunk x kChunk
  float* qC = S + kChunk * kChunk;   // kChunk x kTV
  float* ig_s = qC + kChunk * kTV;   // kChunk each:
  float* bc = ig_s + kChunk;         //   cumulative log forget gate b_t
  float* xs = bc + kChunk;           //   x_t = i_t - b_t
  float* mt = xs + kChunk;           //   stabiliser m_t
  float* inter = mt + kChunk;        //   e^{b_t + m_in - m_t}
  float* wj = inter + kChunk;        //   e^{b_L - b_j + i_j - m_out}
  float* qn = wj + kChunk;           //   q_t . n_in
  float* den = qn + kChunk;          //   max(|den_t|, 1)
  float* m_sh = den + kChunk;        // running m
  float* s_out = m_sh + 1;           // e^{b_L + m_in - m_out}

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / H, hh = bh - bi * H;
  const int v0 = blockIdx.y * kTV;
  const int nv = min(kTV, dh - v0);
  const long long t_stride = static_cast<long long>(H) * dh;  // one step of q, k, v, out
  const long long qkv0 = static_cast<long long>(bi) * s * t_stride + static_cast<long long>(hh) * dh;
  const long long g0 = static_cast<long long>(bi) * s * H + hh;
  float* Cb = C + static_cast<long long>(bh) * dh * dh;

  for (int i = tid; i < nv * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    Cs[r * cs + c] = Cb[static_cast<long long>(v0 + r) * dh + c];
  }
  for (int i = tid; i < dh; i += kThreads) ns[i] = n_in[static_cast<long long>(bh) * dh + i];
  if (tid == 0) *m_sh = m_in[bh];
  __syncthreads();

  for (int c0 = 0; c0 < s; c0 += kChunk) {
    const int L = min(kChunk, s - c0);

    // Gates: a cumulative sum and a running max over the chunk's real steps.
    if (tid == 0) {
      const float m0 = *m_sh;
      float cum = 0.0f, run = 0.0f;
      for (int t = 0; t < L; ++t) {
        const long long g = g0 + static_cast<long long>(c0 + t) * H;
        const float it = ig[g];
        cum += log_sigmoid(fg[g]);
        const float x = it - cum;
        run = t == 0 ? x : fmaxf(run, x);
        const float m = fmaxf(cum + m0, run + cum);
        ig_s[t] = it;
        bc[t] = cum;
        xs[t] = x;
        mt[t] = m;
        inter[t] = expf(cum + m0 - m);
      }
      const float m_new = fmaxf(cum + m0, run + cum);
      *s_out = expf(cum + m0 - m_new);
      for (int j = 0; j < L; ++j) wj[j] = expf(cum - bc[j] + ig_s[j] - m_new);
      *m_sh = m_new;
    }
    for (int i = tid; i < L * L; i += kThreads) S[i] = 0.0f;
    for (int i = tid; i < L * kTV; i += kThreads) qC[i] = 0.0f;
    for (int i = tid; i < L; i += kThreads) qn[i] = 0.0f;

    // Scores q_t . k_j (j <= t), q_t . C_in rows and q_t . n_in, by key tiles.
    for (int k0 = 0; k0 < dh; k0 += kTK) {
      const int nk = min(kTK, dh - k0);
      __syncthreads();  // the previous tile consumed; accumulators zeroed
      for (int i = tid; i < L * nk; i += kThreads) {
        const int t = i / nk, c = i - t * nk;
        const long long g = qkv0 + static_cast<long long>(c0 + t) * t_stride + k0 + c;
        qs[t * kTS + c] = q[g];
        ks[t * kTS + c] = k[g];
      }
      __syncthreads();
      for (int i = tid; i < L * L; i += kThreads) {
        const int t = i / L, j = i - t * L;
        if (j > t) continue;
        float acc = S[i];
        for (int c = 0; c < nk; ++c) acc += qs[t * kTS + c] * ks[j * kTS + c];
        S[i] = acc;
      }
      for (int i = tid; i < L * nv; i += kThreads) {
        const int t = i / nv, r = i - t * nv;
        float acc = qC[t * kTV + r];
        const float* crow = Cs + r * cs + k0;
        for (int c = 0; c < nk; ++c) acc += qs[t * kTS + c] * crow[c];
        qC[t * kTV + r] = acc;
      }
      for (int t = tid; t < L; t += kThreads) {
        float acc = qn[t];
        for (int c = 0; c < nk; ++c) acc += qs[t * kTS + c] * ns[k0 + c];
        qn[t] = acc;
      }
    }
    __syncthreads();

    // W = D * scores; the denominators; the chunk's v rows of this block.
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i - t * L;
      S[i] = j <= t ? expf(bc[t] - mt[t] + xs[j]) * S[i] : 0.0f;
    }
    for (int i = tid; i < L * nv; i += kThreads) {
      const int j = i / nv, r = i - j * nv;
      vs[j * kTV + r] = v[qkv0 + static_cast<long long>(c0 + j) * t_stride + v0 + r];
    }
    __syncthreads();
    for (int t = tid; t < L; t += kThreads) {
      float d = inter[t] * qn[t];
      for (int j = 0; j <= t; ++j) d += S[t * L + j];
      den[t] = fmaxf(fabsf(d), 1.0f);
    }
    __syncthreads();
    for (int i = tid; i < L * nv; i += kThreads) {
      const int t = i / nv, r = i - t * nv;
      float acc = 0.0f;
      for (int j = 0; j <= t; ++j) acc += S[t * L + j] * vs[j * kTV + r];
      acc += inter[t] * qC[t * kTV + r];
      out[qkv0 + static_cast<long long>(c0 + t) * t_stride + v0 + r] = acc / den[t];
    }

    // State update: C rows and n, by key tiles.
    const float so = *s_out;
    for (int k0 = 0; k0 < dh; k0 += kTK) {
      const int nk = min(kTK, dh - k0);
      __syncthreads();  // ks free again
      for (int i = tid; i < L * nk; i += kThreads) {
        const int j = i / nk, c = i - j * nk;
        ks[j * kTS + c] = wj[j] * k[qkv0 + static_cast<long long>(c0 + j) * t_stride + k0 + c];
      }
      __syncthreads();
      for (int i = tid; i < nv * nk; i += kThreads) {
        const int r = i / nk, c = i - r * nk;
        float acc = 0.0f;
        for (int j = 0; j < L; ++j) acc += vs[j * kTV + r] * ks[j * kTS + c];
        float* cell = Cs + r * cs + k0 + c;
        *cell = so * *cell + acc;
      }
      for (int c = tid; c < nk; c += kThreads) {
        float acc = 0.0f;
        for (int j = 0; j < L; ++j) acc += ks[j * kTS + c];
        ns[k0 + c] = so * ns[k0 + c] + acc;
      }
    }
    __syncthreads();  // the next chunk's gates overwrite s_out, wj and friends
  }

  for (int i = tid; i < nv * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    Cb[static_cast<long long>(v0 + r) * dh + c] = Cs[r * cs + c];
  }
  if (blockIdx.y == 0) {
    for (int i = tid; i < dh; i += kThreads) n_out[static_cast<long long>(bh) * dh + i] = ns[i];
    if (tid == 0) m_out[bh] = *m_sh;
  }
}

}  // namespace

// q, k, v, i, f, C (in place), n_in, m_in, n_out, m_out, out; b, s, H, dh; stream
extern "C" int mlstm_chunk_f32(const void* q, const void* k, const void* v, const void* ig,
                               const void* fg, void* C, const void* n_in, const void* m_in,
                               void* n_out, void* m_out, void* out, int b, int s, int H,
                               int dh, void* stream) {
  if (b < 0 || s < 1 || H < 0 || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * smem_floats(dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b * H, (dh + kTV - 1) / kTV);
  mlstm_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(ig), static_cast<const float*>(fg), static_cast<float*>(C),
      static_cast<const float*>(n_in), static_cast<const float*>(m_in),
      static_cast<float*>(n_out), static_cast<float*>(m_out), static_cast<float*>(out), s, H,
      dh);
  return static_cast<int>(cudaGetLastError());
}
