// The backward of flash attention for Hopper (sm_90a), fp32, over a full
// sequence (query i at position i): causal and sliding-window masks,
// grouped and multi-query heads (query head h reads kv head h / (nq / nkv)),
// any sequence length, hd up to 256.
//
// No TPU kernel: the JAX package differentiates its jnp attention
// (src/repro/models/attention.py:97 sdpa) with XLA. This is the backward of
// flash_attention_train_f32 (flash_attention.cu), which saves each row's
// log-sum-exp, so the probabilities are recomputed and never stored:
//   P = exp(S * scale - lse) (0 where masked), D = rowsum(dO o O),
//   dV = sum P^T dO,  dS = P o (dO V^T - D),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over the query heads of each kv group. The plain version
// is kernels/flash_attention/ref.py:flash_attention_bwd_ref.
//
// Layout: q, out, dout, dq (b, sq, nq, hd) and k, v, dk, dv (b, skv, nkv,
// hd), all contiguous; lse and the D pass's delta (b, nq, sq).
//
// What bounds it: at the training shape (StableLM-3B, batch 8, seq 64, 32
// heads of 80, causal) it must read q, k, v, O and dO and write dq, dk, dv,
// 41.9 MB, 0.0125 ms at 3.35 TB/s; its five products over the causal half
// are 0.42 GFLOP, 0.0063 ms at 67 TFLOP/s. So memory, at the bound; this
// kernel recomputes S in both passes and runs its products from shared
// memory in fp32 on the CUDA cores (no tensor cores, no TF32: parity with
// the plain version at 2e-5), so it sits above it.
//
// Design: three kernels, one launch each, on one stream.
// - D pass: 8 rows a block, 32 threads a row sum strided products; thread
//   r then adds row r's 32 partials in order.
// - dK/dV: a block owns kBc keys of one (batch, kv head) and accumulates
//   their dK and dV in registers (each thread a fixed set of (key, 4-dim
//   chunk) entries). It walks, head by head of the group, the query rows
//   that see any of its keys ([first key, last key + window) under the
//   masks) in chunks of kBr: Q, dO, lse and D of the chunk into shared
//   memory, then P and dS of the chunk x keys, then the two sums over the
//   chunk's rows.
// - dQ: a block owns kBr query rows of one (batch, head) and accumulates
//   their dQ in registers, walking the keys its rows see in tiles of kBc
//   (K and V into shared memory, dS, then the sum over the tile's keys).
// Every sum runs in a fixed order and every output element has one owner:
// no atomics, so two launches give the same bits.
//
// What the tiles are shaped for: the products run from shared memory on
// the CUDA cores, so shared-memory traffic sets the pace. Rows are stored
// as 16-byte chunks (hd rounded up to 4, zeros past hd) with a stride of an
// odd number of chunks, so a quarter-warp reading one chunk of 8 different
// rows hits 8 different bank groups. For S and dP each thread scores 2 rows
// against kBc / 16 keys, reading each chunk of q, dO, k and v once for all
// of them; for the sums each thread owns whole 4-dim chunks, so a row's p
// or dS (a broadcast) serves four products.
//
// Shared memory sets the tiles: K and V (kBc rows each), Q and dO (kBr rows
// each), P and dS (kBr x kBc), lse and D. With kBr = 32: hd <= 128 takes
// kBc = 64 (at hd 80 79.3 KB, at hd 128 115.3 KB); hd <= 256 takes kBc =
// 32 (at hd 256 138.3 KB). A 64-key tile at hd 256 would need 195 KB for
// K, V and the chunk alone, 211 KB in all, and its dK and dV registers
// would double. The launch raises the limit with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBr = 32;  // query rows of a chunk (dK/dV) or of a block (dQ)
constexpr int kRowsA = 2;  // rows a thread scores in S and dP
static_assert(kThreads / 16 * kRowsA == kBr, "16 threads a row pair cover the chunk");
// blocks an SM holds at hd <= 128 (two tiles' shared memory fit) and above:
// registers are capped to match
template <int kHD> constexpr int kBlocksPerSM = kHD <= 128 ? 2 : 1;

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* dout;
  const float* lse;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int b, sq, skv, nq, nkv, hd, causal, window;
  float scale;
};

// 4-dim chunks of a row and the odd chunk stride of a row in shared memory
__host__ __device__ constexpr int chunks(int hd) { return (hd + 3) / 4; }
__host__ __device__ constexpr int stride4(int hd) { return chunks(hd) | 1; }

__host__ __device__ constexpr int smem_bytes(int bc, int hd) {
  return (2 * bc + 2 * kBr) * stride4(hd) * 16 + (2 * kBr * bc + 2 * kBr) * 4;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float a, const float4& x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// rows [row0, row0 + n) of a (rows, heads, hd) layout at head h, stride
// `heads`, into n4-chunk rows of dst (zeros past hd and past n, up to rows)
__device__ __forceinline__ void load_rows(float4* dst, const float* src, long long first,
                                          int heads, int hd, int n, int rows, int ld4) {
  float* d = reinterpret_cast<float*>(dst);
  const int n4 = chunks(hd);
  for (int idx = threadIdx.x; idx < rows * n4 * 4; idx += kThreads) {
    const int r = idx / (n4 * 4), e = idx - r * n4 * 4;
    d[r * ld4 * 4 + e] = r < n && e < hd ? src[(first + static_cast<long long>(r) * heads) * hd + e]
                                         : 0.0f;
  }
}

// delta[b, h, s] = sum_d dout[b, s, h, d] * out[b, s, h, d]
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const BwdParams p) {
  __shared__ float part[kThreads / 32][33];
  const int tid = threadIdx.x, g = tid / 32, lane = tid % 32;
  const long long rows = static_cast<long long>(p.b) * p.sq * p.nq;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + g;
  float acc = 0.0f;
  if (row < rows) {
    const float* o = p.out + row * p.hd;
    const float* d = p.dout + row * p.hd;
    for (int c = lane; c < p.hd; c += 32) acc = fmaf(o[c], d[c], acc);
  }
  part[g][lane] = acc;
  __syncthreads();
  if (tid < kThreads / 32) {
    const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) + tid;
    if (r < rows) {
      float sum = 0.0f;
      for (int l = 0; l < 32; ++l) sum += part[tid][l];
      const long long h = r % p.nq, s = r / p.nq % p.sq, bi = r / p.nq / p.sq;
      p.delta[(bi * p.nq + h) * p.sq + s] = sum;
    }
  }
}

// S and dP of kBr rows (qs, dos) x kBc keys (ks, vs) -> P (when ps is
// given) and dS, 0 where a row or key is past its count or masked. Thread
// t scores rows 2 (t / 16) + {0, 1} against keys t % 16 + 16 i.
template <int kBc>
__device__ __forceinline__ void scores(const BwdParams& p, const float4* qs, const float4* dos,
                                       const float4* ks, const float4* vs, const float* lse_s,
                                       const float* del_s, float* ps, float* dss, int r0, int nr,
                                       int j0, int nj, int ld4) {
  constexpr int kKeysA = kBc / 16;
  const int n4 = chunks(p.hd);
  const int ra = threadIdx.x / 16 * kRowsA, ka = threadIdx.x % 16;
  float s[kRowsA][kKeysA], dp[kRowsA][kKeysA];
#pragma unroll
  for (int r = 0; r < kRowsA; ++r) {
#pragma unroll
    for (int i = 0; i < kKeysA; ++i) s[r][i] = dp[r][i] = 0.0f;
  }
  for (int c = 0; c < n4; ++c) {
    float4 qv[kRowsA], ov[kRowsA];
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      qv[r] = qs[(ra + r) * ld4 + c];
      ov[r] = dos[(ra + r) * ld4 + c];
    }
#pragma unroll
    for (int i = 0; i < kKeysA; ++i) {
      const float4 kv = ks[(ka + 16 * i) * ld4 + c];
      const float4 vv = vs[(ka + 16 * i) * ld4 + c];
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) {
        s[r][i] = dot4(qv[r], kv, s[r][i]);
        dp[r][i] = dot4(ov[r], vv, dp[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsA; ++r) {
#pragma unroll
    for (int i = 0; i < kKeysA; ++i) {
      const int row = ra + r, key = ka + 16 * i;
      float pv = 0.0f, dsv = 0.0f;
      if (row < nr && key < nj && visible(r0 + row, j0 + key, p.causal, p.window)) {
        pv = expf(s[r][i] * p.scale - lse_s[row]);
        dsv = pv * (dp[r][i] - del_s[row]);
      }
      if (ps != nullptr) ps[row * kBc + key] = pv;
      dss[row * kBc + key] = dsv;
    }
  }
}

// One (batch, kv head) x kBc keys: dK and dV of those keys.
template <int kBc, int kHD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<kHD>)
flash_bwd_dkdv_kernel(const BwdParams p) {
  extern __shared__ float4 smem4[];
  constexpr int kE = kBc * (kHD / 4) / kThreads;  // (key, chunk) entries a thread owns
  const int hd = p.hd, n4 = chunks(hd), ld4 = stride4(hd), tid = threadIdx.x;
  float4* ks = smem4;
  float4* vs = ks + kBc * ld4;
  float4* qs = vs + kBc * ld4;
  float4* dos = qs + kBr * ld4;
  float* ps = reinterpret_cast<float*>(dos + kBr * ld4);
  float* dss = ps + kBr * kBc;
  float* lse_s = dss + kBr * kBc;
  float* del_s = lse_s + kBr;

  const int bi = blockIdx.x / p.nkv, kvh = blockIdx.x % p.nkv;
  const int group = p.nq / p.nkv;
  const int j0 = blockIdx.y * kBc, nj = min(kBc, p.skv - j0);
  const long long key0 = (static_cast<long long>(bi) * p.skv + j0) * p.nkv + kvh;
  load_rows(ks, p.k, key0, p.nkv, hd, nj, kBc, ld4);
  load_rows(vs, p.v, key0, p.nkv, hd, nj, kBc, ld4);
  // the query positions that see any key of [j0, j0 + nj)
  const int pos_lo = p.causal ? j0 : 0;
  const int pos_hi = p.window > 0 ? min(p.sq, j0 + nj - 1 + p.window) : p.sq;

  float4 dk_acc[kE], dv_acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) dk_acc[e] = dv_acc[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int r0 = pos_lo; r0 < pos_hi; r0 += kBr) {
      const int nr = min(kBr, pos_hi - r0);
      __syncthreads();  // the previous chunk is consumed (and K, V are in)
      const long long row0 = (static_cast<long long>(bi) * p.sq + r0) * p.nq + h;
      load_rows(qs, p.q, row0, p.nq, hd, nr, kBr, ld4);
      load_rows(dos, p.dout, row0, p.nq, hd, nr, kBr, ld4);
      if (tid < kBr) {
        const long long at = (static_cast<long long>(bi) * p.nq + h) * p.sq + r0 + tid;
        lse_s[tid] = tid < nr ? p.lse[at] : 0.0f;
        del_s[tid] = tid < nr ? p.delta[at] : 0.0f;
      }
      __syncthreads();
      scores<kBc>(p, qs, dos, ks, vs, lse_s, del_s, ps, dss, r0, nr, j0, nj, ld4);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int idx = tid + e * kThreads, j = idx / n4, c = idx - j * n4;
        if (j < nj) {
          float4 dv_e = dv_acc[e], dk_e = dk_acc[e];
          for (int r = 0; r < nr; ++r) {
            dv_e = axpy4(ps[r * kBc + j], dos[r * ld4 + c], dv_e);
            dk_e = axpy4(dss[r * kBc + j], qs[r * ld4 + c], dk_e);
          }
          dv_acc[e] = dv_e;
          dk_acc[e] = dk_e;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int idx = tid + e * kThreads, j = idx / n4, c = idx - j * n4;
    if (j < nj) {
      float* dk = p.dk + (key0 + static_cast<long long>(j) * p.nkv) * hd;
      float* dv = p.dv + (key0 + static_cast<long long>(j) * p.nkv) * hd;
      const float kx[4] = {dk_acc[e].x, dk_acc[e].y, dk_acc[e].z, dk_acc[e].w};
      const float vx[4] = {dv_acc[e].x, dv_acc[e].y, dv_acc[e].z, dv_acc[e].w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (4 * c + x < hd) {
          dk[4 * c + x] = kx[x] * p.scale;
          dv[4 * c + x] = vx[x];
        }
      }
    }
  }
}

// One (batch, query head) x kBr query rows: their dQ.
template <int kBc, int kHD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<kHD>)
flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ float4 smem4[];
  constexpr int kE = kBr * (kHD / 4) / kThreads;  // (row, chunk) entries a thread owns
  const int hd = p.hd, n4 = chunks(hd), ld4 = stride4(hd), tid = threadIdx.x;
  float4* ks = smem4;
  float4* vs = ks + kBc * ld4;
  float4* qs = vs + kBc * ld4;
  float4* dos = qs + kBr * ld4;
  // the dK/dV kernel's layout; P is not kept
  float* dss = reinterpret_cast<float*>(dos + kBr * ld4) + kBr * kBc;
  float* lse_s = dss + kBr * kBc;
  float* del_s = lse_s + kBr;

  const int bi = blockIdx.x / p.nq, h = blockIdx.x % p.nq;
  const int kvh = h / (p.nq / p.nkv);
  const int r0 = blockIdx.y * kBr, nr = min(kBr, p.sq - r0);
  const long long row0 = (static_cast<long long>(bi) * p.sq + r0) * p.nq + h;
  load_rows(qs, p.q, row0, p.nq, hd, nr, kBr, ld4);
  load_rows(dos, p.dout, row0, p.nq, hd, nr, kBr, ld4);
  if (tid < kBr) {
    const long long at = (static_cast<long long>(bi) * p.nq + h) * p.sq + r0 + tid;
    lse_s[tid] = tid < nr ? p.lse[at] : 0.0f;
    del_s[tid] = tid < nr ? p.delta[at] : 0.0f;
  }
  // the keys any of the rows sees
  const int key_lo = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  const int key_hi = p.causal ? min(p.skv, r0 + nr) : p.skv;

  float4 dq_acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) dq_acc[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int j0 = key_lo; j0 < key_hi; j0 += kBc) {
    const int nj = min(kBc, key_hi - j0);
    __syncthreads();  // the previous tile is consumed (and the rows are in)
    const long long key0 = (static_cast<long long>(bi) * p.skv + j0) * p.nkv + kvh;
    load_rows(ks, p.k, key0, p.nkv, hd, nj, kBc, ld4);
    load_rows(vs, p.v, key0, p.nkv, hd, nj, kBc, ld4);
    __syncthreads();
    scores<kBc>(p, qs, dos, ks, vs, lse_s, del_s, nullptr, dss, r0, nr, j0, nj, ld4);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int idx = tid + e * kThreads, r = idx / n4, c = idx - r * n4;
      if (r < nr) {
        float4 dq_e = dq_acc[e];
        for (int j = 0; j < nj; ++j) dq_e = axpy4(dss[r * kBc + j], ks[j * ld4 + c], dq_e);
        dq_acc[e] = dq_e;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int idx = tid + e * kThreads, r = idx / n4, c = idx - r * n4;
    if (r < nr) {
      float* dq = p.dq + (row0 + static_cast<long long>(r) * p.nq) * hd;
      const float qx[4] = {dq_acc[e].x, dq_acc[e].y, dq_acc[e].z, dq_acc[e].w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (4 * c + x < hd) dq[4 * c + x] = qx[x] * p.scale;
      }
    }
  }
}

template <int kBc, int kHD>
int launch_as(const BwdParams& p, cudaStream_t stream) {
  const int smem = smem_bytes(kBc, p.hd);
  // Raised once per instantiation, to what its widest head needs.
  static const cudaError_t raised = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<kBc, kHD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(kBc, kHD));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dq_kernel<kBc, kHD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes(kBc, kHD));
  }();
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const long long rows = static_cast<long long>(p.b) * p.sq * p.nq;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
                           kThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_kernel<kBc, kHD>
      <<<dim3(p.b * p.nkv, (p.skv + kBc - 1) / kBc), kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<kBc, kHD>
      <<<dim3(p.b * p.nq, (p.sq + kBr - 1) / kBr), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout, lse; delta (scratch, (b, nq, sq) fp32); dq, dk, dv;
// b, sq, skv, nq, nkv, hd; causal, window; scale; stream. All fp32 and
// contiguous in the layouts above.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int b, int sq,
                                       int skv, int nq, int nkv, int hd, int causal, int window,
                                       float scale, void* stream) {
  if (b < 0 || sq < 0 || skv < 0 || hd < 1 || hd > 256 || nkv < 1 || nq < 1 || nq % nkv != 0 ||
      (sq + kBr - 1) / kBr > 65535 || (skv + kBr - 1) / kBr > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0 || skv == 0) return static_cast<int>(cudaSuccess);
  const BwdParams p{static_cast<const float*>(q),    static_cast<const float*>(k),
                    static_cast<const float*>(v),    static_cast<const float*>(out),
                    static_cast<const float*>(dout), static_cast<const float*>(lse),
                    static_cast<float*>(delta),      static_cast<float*>(dq),
                    static_cast<float*>(dk),         static_cast<float*>(dv),
                    b, sq, skv, nq, nkv, hd, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 128 ? launch_as<64, 128>(p, st) : launch_as<32, 256>(p, st);
}
