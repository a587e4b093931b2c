// The backward of the RG-LRU recurrence for Hopper (sm_90a), fp32: for
// h_t = a_t * h_{t-1} + b_t from h0 (or 0), given the gradients dh of every
// h_t and d(last) of the last one, a reverse linear scan
//   g_T = dh_T + d(last),  g_t = dh_t + a_{t+1} * g_{t+1},
//   da_t = g_t * h_{t-1},  db_t = g_t,  dh0 = a_1 * g_1.
//
// No TPU kernel: the JAX package differentiates its associative scan
// (src/repro/models/rglru.py:82 rglru_scan) with XLA. This is the backward
// of rg_lru.cu's forward; its plain version is
// kernels/rg_lru/ref.py:rg_lru_bwd_ref.
//
// Layout: a, h (the forward's every h_t), dh, da, db contiguous (batch, seq,
// d) fp32; h0, d(last), dh0 (batch, d) fp32. dh, d(last) and h0 may each be
// null (a zero gradient, a zero state); dh0 is written when h0 is given.
//
// What bounds it: a, h and dh read, da and db written, 20 bytes a step per
// channel against 3 operations: the card's memory. At RecurrentGemma-9B's
// training shape (d 4096, batch 8, seq 64) that is 42 MB, 0.0125 ms at
// 3.35 TB/s.
//
// Design: the forward's. One thread owns four neighbouring channels of one
// batch row and walks the sequence backwards in registers, so the blocks
// split only the parallel (batch, channel) dimensions and no state crosses
// them; neighbouring threads read neighbouring channels, 16 bytes each where
// d is a multiple of 4 and the pointers are aligned (else four scalar
// accesses). The steps go in chunks of kSteps: a chunk's a_{t+1}, dh_t and
// h_{t-1} are loaded before its dependent FMAs, so its loads are in flight
// together. Every thread's sums run in one order: two launches give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kVec = 4;    // channels a thread
constexpr int kSteps = 8;  // time steps loaded ahead of their FMAs

template <bool kVecIO>
__device__ __forceinline__ float4 load4(const float* src, int n) {
  if constexpr (kVecIO) {
    return *reinterpret_cast<const float4*>(src);
  } else {
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = i < n ? src[i] : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kVecIO>
__device__ __forceinline__ void store4(float* dst, float4 x, int n) {
  if constexpr (kVecIO) {
    *reinterpret_cast<float4*>(dst) = x;
  } else {
    const float v[kVec] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < n) dst[i] = v[i];
    }
  }
}

__device__ __forceinline__ float4 fma4(float4 a, float4 x, float4 y) {
  return make_float4(fmaf(a.x, x.x, y.x), fmaf(a.y, x.y, y.y), fmaf(a.z, x.z, y.z),
                     fmaf(a.w, x.w, y.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 x) {
  return make_float4(a.x * x.x, a.y * x.y, a.z * x.z, a.w * x.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 x) {
  return make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
}

template <bool kVecIO>
__global__ void __launch_bounds__(kThreads)
rg_lru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                  const float* __restrict__ h0, const float* __restrict__ dh,
                  const float* __restrict__ dlast, float* __restrict__ da,
                  float* __restrict__ db, float* __restrict__ dh0, int seq, int d) {
  const int ch = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  const int bi = blockIdx.y;
  if (ch >= d) return;
  const int n = min(kVec, d - ch);  // channels of this thread: 4, or fewer at the row's end
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long long row = static_cast<long long>(bi) * d + ch;
  const long long base = static_cast<long long>(bi) * seq * d + ch;
  // g carries a_{t+1} * g_{t+1} into step t (d(last) into the last step)
  float4 g = dlast != nullptr ? load4<kVecIO>(dlast + row, n) : zero;
  for (int t1 = seq - 1; t1 >= 0; t1 -= kSteps) {
    float4 dhv[kSteps], prev[kSteps], anext[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t1 - i;
      if (t >= 0) {
        const long long at = base + static_cast<long long>(t) * d;
        dhv[i] = dh != nullptr ? load4<kVecIO>(dh + at, n) : zero;
        prev[i] = t > 0 ? load4<kVecIO>(h + at - d, n)
                        : (h0 != nullptr ? load4<kVecIO>(h0 + row, n) : zero);
        anext[i] = load4<kVecIO>(a + at, n);  // a_t, which carries g_t into step t - 1
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t1 - i;
      if (t >= 0) {
        const long long at = base + static_cast<long long>(t) * d;
        g = add4(g, dhv[i]);
        store4<kVecIO>(db + at, g, n);
        store4<kVecIO>(da + at, mul4(g, prev[i]), n);
        g = mul4(anext[i], g);
      }
    }
  }
  if (dh0 != nullptr) store4<kVecIO>(dh0 + row, g, n);
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// a, h, h0 (or null), dh (or null), d(last) (or null); da, db, dh0 (or
// null); batch, seq, d; stream. All fp32.
extern "C" int rg_lru_bwd_f32(const void* a, const void* h, const void* h0, const void* dh,
                              const void* dlast, void* da, void* db, void* dh0, int batch,
                              int seq, int d, void* stream) {
  if (batch < 0 || seq < 1 || d < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((d + kThreads * kVec - 1) / (kThreads * kVec), batch);
  const bool vec = d % kVec == 0 && aligned(a) && aligned(h) && aligned(h0) && aligned(dh) &&
                   aligned(dlast) && aligned(da) && aligned(db) && aligned(dh0);
  const auto* af = static_cast<const float*>(a);
  const auto* hf = static_cast<const float*>(h);
  const auto* h0f = static_cast<const float*>(h0);
  const auto* dhf = static_cast<const float*>(dh);
  const auto* dlf = static_cast<const float*>(dlast);
  auto* daf = static_cast<float*>(da);
  auto* dbf = static_cast<float*>(db);
  auto* dh0f = static_cast<float*>(dh0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    rg_lru_bwd_kernel<true><<<grid, kThreads, 0, st>>>(af, hf, h0f, dhf, dlf, daf, dbf, dh0f, seq,
                                                       d);
  } else {
    rg_lru_bwd_kernel<false><<<grid, kThreads, 0, st>>>(af, hf, h0f, dhf, dlf, daf, dbf, dh0f,
                                                        seq, d);
  }
  return static_cast<int>(cudaGetLastError());
}
