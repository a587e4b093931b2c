// Fused LSTM cell step for Hopper (sm_90a), fp32 or bf16 in, fp32 math.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell/lstm_cell.py:_lstm_kernel
// (pl.pallas_call at :71). Computes, for gate order i, f, g, o:
//   z  = x @ wx + h @ wh + b                 (fp32 accumulation)
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
// with the model's own layouts: wx (d_in, 4H), wh (H, 4H), b (4H,), columns
// [i | f | g | o] each H wide (the TPU wrapper only reshapes that memory to
// (D, 4, H)). Outputs are fresh buffers in the input dtype.
//
// What bounds it: at the served shapes (B = 64, d_in = 128 or 256, H = 256)
// one step moves 1.5-2 MiB of fp32 weights and does 50-67 MFLOP, under a
// microsecond of either on an H100, so a single launch is bound by launch
// latency and by the serial dependence of 408 steps per batch, not by the
// card's memory or arithmetic rate.
//
// Design (right before fast): the grid is (hidden tiles of 32, batch tiles
// of 8). A block stages its 8 rows of [x | h] in shared memory as fp32; each
// thread owns one (row, j), so a warp is one row and 32 neighbouring j, and
// reads columns j, H+j, 2H+j, 3H+j of each weight row: neighbouring threads
// read neighbouring addresses and the x/h value is a shared-memory broadcast.
// The two products are summed separately and then added, as the plain
// version does. No TF32 and no tensor cores: they would break fp32 parity.
// A persistent kernel over time steps is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTileJ = 32;  // hidden columns per block (one warp)
constexpr int kTileB = 8;   // batch rows per block (one warp each)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

template <typename T>
__device__ __forceinline__ void accumulate(const float* __restrict__ s, const T* __restrict__ w,
                                           int depth, int H, float acc[4]) {
  const size_t stride = 4 * static_cast<size_t>(H);
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float v = s[k];
    const T* row = w + k * stride;
    acc[0] += v * to_f32(row[0]);
    acc[1] += v * to_f32(row[H]);
    acc[2] += v * to_f32(row[2 * H]);
    acc[3] += v * to_f32(row[3 * H]);
  }
}

template <typename T>
__global__ void lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                                 const T* __restrict__ c, const T* __restrict__ wx,
                                 const T* __restrict__ wh, const T* __restrict__ b,
                                 T* __restrict__ h_out, T* __restrict__ c_out,
                                 int B, int d_in, int H) {
  extern __shared__ float rows[];  // kTileB x (d_in + H), fp32
  const int K = d_in + H;
  const int row0 = blockIdx.y * kTileB;
  const int tid = threadIdx.y * kTileJ + threadIdx.x;
  for (int idx = tid; idx < kTileB * K; idx += kTileB * kTileJ) {
    const int r = idx / K, k = idx - r * K, row = row0 + r;
    float v = 0.0f;
    if (row < B) {
      v = k < d_in ? to_f32(x[static_cast<size_t>(row) * d_in + k])
                   : to_f32(h[static_cast<size_t>(row) * H + (k - d_in)]);
    }
    rows[idx] = v;
  }
  __syncthreads();

  const int j = blockIdx.x * kTileJ + threadIdx.x;
  const int row = row0 + threadIdx.y;
  if (j >= H || row >= B) return;
  const float* s = rows + threadIdx.y * K;
  float zx[4] = {0.f, 0.f, 0.f, 0.f};
  float zh[4] = {0.f, 0.f, 0.f, 0.f};
  accumulate(s, wx + j, d_in, H, zx);
  accumulate(s + d_in, wh + j, H, H, zh);
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) z[g] = (zx[g] + zh[g]) + to_f32(b[g * H + j]);

  const size_t o = static_cast<size_t>(row) * H + j;
  const float c_new = sigmoid(z[1] + 1.0f) * to_f32(c[o]) + sigmoid(z[0]) * tanhf(z[2]);
  const float h_new = sigmoid(z[3]) * tanhf(c_new);
  c_out[o] = from_f32<T>(c_new);
  h_out[o] = from_f32<T>(h_new);
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx, const void* wh,
           const void* b, void* h_out, void* c_out, int B, int d_in, int H, void* stream) {
  const size_t smem = sizeof(float) * kTileB * static_cast<size_t>(d_in + H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_cell_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((H + kTileJ - 1) / kTileJ, (B + kTileB - 1) / kTileB);
  const dim3 block(kTileJ, kTileB);
  lstm_cell_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h_out), static_cast<T*>(c_out), B, d_in, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lstm_cell_f32(const void* x, const void* h, const void* c, const void* wx,
                             const void* wh, const void* b, void* h_out, void* c_out,
                             int B, int d_in, int H, void* stream) {
  return launch<float>(x, h, c, wx, wh, b, h_out, c_out, B, d_in, H, stream);
}

extern "C" int lstm_cell_bf16(const void* x, const void* h, const void* c, const void* wx,
                              const void* wh, const void* b, void* h_out, void* c_out,
                              int B, int d_in, int H, void* stream) {
  return launch<__nv_bfloat16>(x, h, c, wx, wh, b, h_out, c_out, B, d_in, H, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
