// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// in fp32, from h0 (or 0), writing every h_t and the last one.
//
// Replaces the TPU kernel src/repro/kernels/rg_lru/rg_lru.py:_rg_lru_kernel
// (pl.pallas_call at :63), which walks the sequence in blocks of blk_s steps
// and carries h across sequence blocks in VMEM. Here one thread owns four
// neighbouring channels of one batch row and walks the whole sequence in
// registers, so no state crosses blocks at all: the CUDA blocks split only
// the parallel (batch, channel) dimensions, which the Pallas grid marked
// "parallel". The last step's h is also written to h_last, the recurrent
// state of the Griffin block (repro/models/rglru.py:95 returns hh[:, -1]).
//
// Layout: a, b and out are contiguous (batch, seq, d) in the input dtype
// (fp32 or bf16: read and written in it here, the recurrence in fp32), h0
// and h_last (batch, d) fp32; h0 may be null (zero state).
//
// What bounds it: 12 bytes a step per channel in fp32 (a and b read, h
// written) against 2 operations: the card's memory, by far. A decode step
// of RecurrentGemma-9B (batch 1, d = 4096, one step) moves 48 KB plus the
// 32 KB of h0 and h_last, about 0.00002 ms at 3.35 TB/s, far below the
// launch's own cost; a prefill's dependent chain of seq FMAs per channel
// waits on its loads unless they are in flight before it.
//
// Design: a thread's four channels move as one 16-byte load or store in
// fp32 (8 bytes in bf16) where d is a multiple of 4 and the pointers are
// aligned, else as four scalar accesses (the tail of a row, or every row
// when d % 4 != 0). The sequence goes in chunks of kSteps: every a_t and
// b_t of a chunk is loaded into registers before the chunk's dependent
// FMAs, so a prompt's loads are in flight together, not one step at a
// time. A decode step (seq = 1) takes an instance with no loop at all: one
// round trip and two stores. bf16 in is one launch too: no cast kernels
// around it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // 16 blocks at d = 4096: a prompt's bytes over 16 SMs
constexpr int kVec = 4;     // channels a thread
constexpr int kSteps = 8;   // time steps loaded ahead of their FMAs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four channels starting at src: one vector load when kVecIO, else four
// scalar loads of the channels below n (zeros past it).
template <typename T, bool kVecIO>
__device__ __forceinline__ float4 load4(const T* src, int n) {
  if constexpr (kVecIO) {
    if constexpr (sizeof(T) == 4) {
      return *reinterpret_cast<const float4*>(src);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      const T* e = reinterpret_cast<const T*>(&raw);
      return make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
    }
  } else {
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = i < n ? to_f32(src[i]) : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T, bool kVecIO>
__device__ __forceinline__ void store4(T* dst, float4 h, int n) {
  if constexpr (kVecIO) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = h;
    } else {
      uint2 raw;
      T* e = reinterpret_cast<T*>(&raw);
      e[0] = from_f32<T>(h.x), e[1] = from_f32<T>(h.y), e[2] = from_f32<T>(h.z);
      e[3] = from_f32<T>(h.w);
      *reinterpret_cast<uint2*>(dst) = raw;
    }
  } else {
    const float v[kVec] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < n) dst[i] = from_f32<T>(v[i]);
    }
  }
}

__device__ __forceinline__ float4 fma4(float4 a, float4 h, float4 b) {
  return make_float4(fmaf(a.x, h.x, b.x), fmaf(a.y, h.y, b.y), fmaf(a.z, h.z, b.z),
                     fmaf(a.w, h.w, b.w));
}

// kOne: a single step (decode), with no loop around it.
template <typename T, bool kVecIO, bool kOne>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ h0, T* __restrict__ out,
              float* __restrict__ h_last, int seq, int d) {
  const int ch = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  const int bi = blockIdx.y;
  if (ch >= d) return;
  const int n = min(kVec, d - ch);  // channels of this thread: 4, or fewer at the row's end
  const long long row = static_cast<long long>(bi) * d + ch;
  float4 h = h0 != nullptr ? load4<float, kVecIO>(h0 + row, n) : make_float4(0, 0, 0, 0);
  if constexpr (kOne) {
    h = fma4(load4<T, kVecIO>(a + row, n), h, load4<T, kVecIO>(b + row, n));
    store4<T, kVecIO>(out + row, h, n);
    store4<float, kVecIO>(h_last + row, h, n);
    return;
  }
  const long long base = static_cast<long long>(bi) * seq * d + ch;
  for (int t0 = 0; t0 < seq; t0 += kSteps) {
    float4 av[kSteps], bv[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (t0 + i < seq) {
        const long long at = base + static_cast<long long>(t0 + i) * d;
        av[i] = load4<T, kVecIO>(a + at, n);
        bv[i] = load4<T, kVecIO>(b + at, n);
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (t0 + i < seq) {
        h = fma4(av[i], h, bv[i]);
        store4<T, kVecIO>(out + base + static_cast<long long>(t0 + i) * d, h, n);
      }
    }
  }
  store4<float, kVecIO>(h_last + row, h, n);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out, void* h_last, int batch,
           int seq, int d, cudaStream_t stream) {
  const dim3 grid((d + kThreads * kVec - 1) / (kThreads * kVec), batch);
  const bool vec = d % kVec == 0 && aligned(a, kVec * sizeof(T)) &&
                   aligned(b, kVec * sizeof(T)) && aligned(out, kVec * sizeof(T)) &&
                   aligned(h0, 16) && aligned(h_last, 16);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const float* h0f = static_cast<const float*>(h0);
  T* ot = static_cast<T*>(out);
  float* hl = static_cast<float*>(h_last);
  if (seq == 1) {
    if (vec) {
      rg_lru_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(at, bt, h0f, ot, hl, seq, d);
    } else {
      rg_lru_kernel<T, false, true><<<grid, kThreads, 0, stream>>>(at, bt, h0f, ot, hl, seq, d);
    }
  } else if (vec) {
    rg_lru_kernel<T, true, false><<<grid, kThreads, 0, stream>>>(at, bt, h0f, ot, hl, seq, d);
  } else {
    rg_lru_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(at, bt, h0f, ot, hl, seq, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b (batch, seq, d) in the dtype named by dtype (0 fp32, 1 bf16),
// h0 (or null) fp32, out in a's dtype, h_last fp32; batch, seq, d; stream
extern "C" int rg_lru(const void* a, const void* b, const void* h0, void* out, void* h_last,
                      int dtype, int batch, int seq, int d, void* stream) {
  if (batch < 0 || seq < 1 || d < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, b, h0, out, h_last, batch, seq, d, st);
    case 1: return launch<__nv_bfloat16>(a, b, h0, out, h_last, batch, seq, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
