// Flash attention for Hopper (sm_90a): online softmax over key tiles,
// fp32 or bf16 in, fp32 math.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel
// (pl.pallas_call at :111) and computes what it computes: causal and
// sliding-window masks, query head h reading kv head h / (nq / nkv), keys at
// or past kv_len masked, scores = (q . k) * (1 / sqrt(hd)), masked scores set
// to -1e30, running max m, sum l and accumulator acc in fp32, p cast to the
// input dtype before p . v, and out = acc / max(l, 1e-30). Two runtime
// arguments go beyond the Pallas kernel, whose kv_len is static and whose
// queries start at position 0: query row i sits at position q_offset + i,
// and kv_len says how many keys of the cache are real. With both, one
// kernel serves a full sequence, a block prefill into the KV cache, and a
// one-token decode step whose query sits at pos over a cache holding pos + 1
// real keys out of max_seq.
//
// Layout: q (b, sq, nq, hd), k and v (b, skv, nkv, hd), each read through
// its (batch, seq, head) strides with a contiguous head_dim, so the KV cache
// is read where it lies; out is a fresh contiguous (b, sq, nq, hd).
//
// What bounds it: at the served shapes (StableLM-3B: nq = nkv = 32,
// hd = 80, a 128-long cache) a decode step reads 2 * kv_len * 32 * 80 * 4
// bytes of keys and values, 20 KB per cached token, and does about
// 4 * kv_len * 32 * 80 operations: well under a microsecond of either on an
// H100. So one launch is bound by launch latency and by how few blocks
// (b * nq = 32) there are, not by the card's memory or arithmetic rate; a
// long cache makes it bound by the bytes of K and V. RecurrentGemma-9B's
// local attention (16 query heads of 256 over one kv head) is the same:
// a decode step reads 2 KB of keys and values per cached token.
//
// Design (right before fast): one block of 4 warps per (batch * q head,
// tile of 16 query rows). The block computes the range of keys any of its
// rows can see (kv_len, the causal limit of its last row, the window start
// of its first row) and walks only that range in tiles of 32 keys staged in
// shared memory as fp32, so a decode step reads pos + 1 keys and never the
// empty tail of the cache. Each warp owns 4 query rows; lane j scores key j
// of the tile against them (the key tile's rows are padded to an odd
// stride, so the 32 lanes hit 32 banks), the warp reduces max and sum with
// shuffles, and then each lane accumulates p . v for head dims lane,
// lane + 32, ... with p broadcast by shuffle. The number of register slots
// per row is a template parameter: four for hd <= 128 (StableLM-3B's 80),
// eight for hd <= 256 (RecurrentGemma-9B's 256), so a narrow head does not
// pay for the wide one's registers. At hd = 256 the block's tiles take
// 82 KB of dynamic shared memory, above the 48 KB default, which the launch
// raises with cudaFuncSetAttribute. Masking follows the Pallas kernel
// exactly, -1e30 and not -inf: a tile fully masked for a row before its
// first visible key adds p = 1 garbage that the next visible key wipes out
// with corr = exp(-1e30 - m) = 0; with 16 rows per block and 32 keys per tile
// every row's first visible key lies in the block's first tile. No tensor
// cores and no TF32: fp32 parity with the plain version rules them out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kRows = 16;  // query rows per block
constexpr int kKeys = 32;  // keys per shared-memory tile, one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// kSlots head dims per lane: hd <= 32 * kSlots.
template <typename T, int kSlots>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int sq, int skv, int nq, int nkv, int hd,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       int causal, int window, int q_offset, int kv_len, float scale) {
  extern __shared__ float smem[];
  const int ks = hd | 1;         // odd row stride of the key tile: no bank conflicts
  float* qs = smem;              // kRows x hd
  float* kt = qs + kRows * hd;   // kKeys x ks
  float* vt = kt + kKeys * ks;   // kKeys x hd

  const int bh = blockIdx.x;
  const int b = bh / nq, h = bh - b * nq;
  const int kvh = h / (nq / nkv);
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kRows * hd; i += kWarps * 32) {
    const int r = i / hd, d = i - r * hd, row = q0 + r;
    qs[i] = row < sq ? to_f32(qb[row * q_ss + d]) : 0.0f;
  }

  // The keys any row of this block can see: [lo, hi).
  const int n_keys = min(skv, kv_len);
  int hi = n_keys;
  if (causal) hi = min(hi, q_offset + min(q0 + kRows, sq));
  const int lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const bool active = q0 + warp < sq;  // the warp owns at least one real row

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kSlots];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[i][s] = 0.0f;
  }

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    __syncthreads();  // q tile written; the previous key tile consumed
    for (int i = tid; i < kKeys * hd; i += kWarps * 32) {
      const int j = i / hd, d = i - j * hd, t = t0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (t < hi) {
        kv = to_f32(kb[t * k_ss + d]);
        vv = to_f32(vb[t * v_ss + d]);
      }
      kt[j * ks + d] = kv;
      vt[j * hd + d] = vv;
    }
    __syncthreads();
    if (!active) continue;

    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    const float* krow = kt + lane * ks;
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] += qs[(warp + kWarps * i) * hd + d] * kd;
    }

    const int key = t0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int q_pos = q_offset + q0 + warp + kWarps * i;
      bool visible = key < n_keys;
      if (causal) visible = visible && key <= q_pos;
      if (window > 0) visible = visible && key > q_pos - window;
      const float si = visible ? s[i] * scale : kMasked;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float p = expf(si - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      const float pc = round_to<T>(p);
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) acc[i][sl] *= corr;
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(kFull, pc, j);
        const float* vrow = vt + j * hd;
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int d = lane + 32 * sl;
          if (d < hd) acc[i][sl] += pj * vrow[d];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp + kWarps * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * sq + row) * nq + h) * hd;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int d = lane + 32 * sl;
      if (d < hd) o[d] = from_f32<T>(acc[i][sl] / denom);
    }
  }
}

template <typename T, int kSlots>
int launch_slots(const void* q, const void* k, const void* v, void* out, int b, int sq,
                 int skv, int nq, int nkv, int hd, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, int causal, int window,
                 int q_offset, int kv_len, float scale, void* stream) {
  const size_t smem = sizeof(float) * (kRows * hd + kKeys * (hd | 1) + kKeys * hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, kSlots>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b * nq, (sq + kRows - 1) / kRows);
  flash_attention_kernel<T, kSlots>
      <<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, nq, nkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, causal, window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_ARGS                                                                        \
  const void *q, const void *k, const void *v, void *out, int b, int sq, int skv, int nq, \
      int nkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,    \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,     \
      int causal, int window, int q_offset, int kv_len, float scale, void *stream
#define FLASH_PASS                                                                       \
  q, k, v, out, b, sq, skv, nq, nkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, \
      v_sh, causal, window, q_offset, kv_len, scale, stream

namespace {

template <typename T>
int launch(FLASH_ARGS) {
  if (hd < 1 || hd > 256 || nkv < 1 || nq % nkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0 || nq == 0) return static_cast<int>(cudaSuccess);
  return hd <= 128 ? launch_slots<T, 4>(FLASH_PASS) : launch_slots<T, 8>(FLASH_PASS);
}

}  // namespace

extern "C" int flash_attention_f32(FLASH_ARGS) { return launch<float>(FLASH_PASS); }

extern "C" int flash_attention_bf16(FLASH_ARGS) { return launch<__nv_bfloat16>(FLASH_PASS); }
