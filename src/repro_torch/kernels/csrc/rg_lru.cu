// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// in fp32, from h0 (or 0), writing every h_t and the last one.
//
// Replaces the TPU kernel src/repro/kernels/rg_lru/rg_lru.py:_rg_lru_kernel
// (pl.pallas_call at :63), which walks the sequence in blocks of blk_s steps
// and carries h across sequence blocks in VMEM. Here one thread owns one
// (batch, channel) pair and walks the whole sequence in a register, so no
// state crosses blocks at all: the CUDA blocks split only the parallel
// (batch, channel) dimensions, which the Pallas grid marked "parallel".
// The last step's h is also written to h_last, the recurrent state of the
// Griffin block (repro/models/rglru.py:95 returns hh[:, -1]).
//
// Layout: a, b and out are contiguous (batch, seq, d) fp32, h0 and h_last
// (batch, d) fp32; h0 may be null (zero state). Neighbouring threads take
// neighbouring channels, so every load and store of a time step is
// coalesced.
//
// What bounds it: 12 bytes a step per channel (a and b read, h written)
// against 2 operations: the card's memory, by far. A decode step of
// RecurrentGemma-9B (batch 1, d = 4096, one step) moves 48 KB plus the
// 32 KB of h0 and h_last, about 0.00002 ms at 3.35 TB/s, far below the
// launch's own cost; a long prefill is bound by the dependent chain of
// seq loads per thread unless batch * d fills the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ h0, float* __restrict__ out,
              float* __restrict__ h_last, int seq, int d) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (ch >= d) return;
  float h = h0 != nullptr ? h0[static_cast<long long>(bi) * d + ch] : 0.0f;
  const long long base = static_cast<long long>(bi) * seq * d + ch;
  for (int t = 0; t < seq; ++t) {
    const long long i = base + static_cast<long long>(t) * d;
    h = fmaf(a[i], h, b[i]);
    out[i] = h;
  }
  h_last[static_cast<long long>(bi) * d + ch] = h;
}

}  // namespace

// a, b, h0 (or null), out, h_last; batch, seq, d; stream
extern "C" int rg_lru_f32(const void* a, const void* b, const void* h0, void* out,
                          void* h_last, int batch, int seq, int d, void* stream) {
  if (batch < 0 || seq < 1 || d < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((d + kThreads - 1) / kThreads, batch);
  rg_lru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), static_cast<float*>(h_last),
      seq, d);
  return static_cast<int>(cudaGetLastError());
}
