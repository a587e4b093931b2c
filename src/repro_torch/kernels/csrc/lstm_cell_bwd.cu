// Pointwise backward of the fused LSTM cell for Hopper (sm_90a), fp32.
//
// No TPU kernel to replace: the JAX package differentiates the cell's jnp
// twin (src/repro/models/seq2seq.py:63 lstm_cell) with XLA's autodiff. This
// is the elementwise half of that gradient; the products dx = dz wx^T,
// dh = dz wh^T, dwx = x^T dz, dwh = h^T dz and db = sum(dz) stay matrix
// products outside the kernel, as in the reference.
//
// With the activated gates i, f, g, o that the training forward wrote
// (f = sigmoid(z_f + 1): the +1 forget bias is inside), c and c':
//   dct     = dc' + dh' * o * (1 - tanh(c')^2)
//   dz_i    = dct * g * i * (1 - i)        dz_f = dct * c * f * (1 - f)
//   dz_g    = dct * i * (1 - g^2)          dz_o = dh' * tanh(c') * o * (1 - o)
//   dc_prev = dct * f
// A null dh' or dc' is a zero gradient (the last step's c', or an h' that
// only feeds c').
//
// What bounds it: bytes. At B = 32, H = 256 it reads 2 x 32 KB of incoming
// gradients, 128 KB of gates and 2 x 32 KB of c and c' and writes 128 KB of
// dz and 32 KB of dc_prev: about 0.13 us at 3.35 TB/s, far below a launch.
// Design: one thread per (row, hidden unit), reading its four gates and
// writing four dz values and one dc_prev; consecutive threads take
// consecutive units, so every load and store of a warp is one contiguous
// run. Fixed-order arithmetic and no atomics: two launches give the same
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lstm_cell_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ dc,
                     const float* __restrict__ gates, const float* __restrict__ c,
                     const float* __restrict__ c_new, float* __restrict__ dz,
                     float* __restrict__ dc_prev, int B, int H) {
  const long long n = static_cast<long long>(B) * H;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long row = e / H, j = e - row * H;
  const float* gr = gates + row * 4 * H + j;
  const float gi = gr[0], gf = gr[H], gg = gr[2 * static_cast<long long>(H)],
              go = gr[3 * static_cast<long long>(H)];
  const float tc = tanhf(c_new[e]);
  const float dhv = dh != nullptr ? dh[e] : 0.0f;
  const float dct = (dc != nullptr ? dc[e] : 0.0f) + dhv * go * (1.0f - tc * tc);
  float* zr = dz + row * 4 * H + j;
  zr[0] = dct * gg * gi * (1.0f - gi);
  zr[H] = dct * c[e] * gf * (1.0f - gf);
  zr[2 * static_cast<long long>(H)] = dct * gi * (1.0f - gg * gg);
  zr[3 * static_cast<long long>(H)] = dhv * tc * go * (1.0f - go);
  dc_prev[e] = dct * gf;
}

}  // namespace

// dh, dc (B, H) or null; gates (B, 4H); c, c_new (B, H) -> dz (B, 4H),
// dc_prev (B, H). All fp32, contiguous.
extern "C" int lstm_cell_bwd_f32(const void* dh, const void* dc, const void* gates,
                                 const void* c, const void* c_new, void* dz, void* dc_prev,
                                 int B, int H, void* stream) {
  if (B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * H;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lstm_cell_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dh), static_cast<const float*>(dc),
      static_cast<const float*>(gates), static_cast<const float*>(c),
      static_cast<const float*>(c_new), static_cast<float*>(dz), static_cast<float*>(dc_prev),
      B, H);
  return static_cast<int>(cudaGetLastError());
}
