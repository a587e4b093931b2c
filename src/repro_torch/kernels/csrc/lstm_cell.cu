// Fused LSTM cell step for Hopper (sm_90a), fp32 or bf16 in, fp32 math.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell/lstm_cell.py:_lstm_kernel
// (pl.pallas_call at :71). Computes, for gate order i, f, g, o:
//   z  = x @ wx + h @ wh + b                 (fp32 accumulation)
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
// with the model's own layouts: wx (d_in, 4H), wh (H, 4H), b (4H,), columns
// [i | f | g | o] each H wide (the TPU wrapper only reshapes that memory to
// (D, 4, H)). Outputs are fresh buffers in the input dtype. The training
// entry (fp32 only) also writes the activated gates for the backward,
// gates (B, 4H) fp32 = [sigmoid(i) | sigmoid(f + 1) | tanh(g) | sigmoid(o)];
// serving passes a null pointer there, and h' and c' are the same bits
// either way.
//
// What bounds it: at the served shapes (B = 64, d_in = 128 or 256, H = 256)
// one step reads 1.5-2 MiB of fp32 weights and does 50-67 MFLOP, about a
// microsecond of either on an H100 at 700 W. So a launch is bound by
// latency: how many SMs work, and how long each waits on its loads.
//
// Design. The contraction K = d_in + H is [x | h] against [wx ; wh].
// - A cluster of kSplit = 4 blocks owns kUnits = 8 hidden units (32 weight
//   columns: 8 of each gate) for kRows = 64 batch rows, and its blocks split
//   K into four ranges. At the served shapes that is 32 clusters, 128
//   blocks; every weight is read once per launch (B <= 64).
// - Each block walks its K range in tiles of kKT = 32 steps, kStages tiles
//   in flight: the [x | h] tile (64 x 32) and the weight tile (32 x 32) go
//   to shared memory with 16-byte cp.async copies (a weight row's 8 units
//   of one gate are contiguous). Shapes that are not 16-byte aligned take
//   the same layout through plain loads.
// - The block's 256 threads are 4 groups of 64, each a quarter of every
//   tile's steps; a thread holds 2 rows x 4 units x 4 gates in registers.
// - Sums are taken in a fixed order, no atomics: within a thread in K
//   order, then the 4 groups in order through shared memory. Each block
//   finishes 16 of the 64 rows: every block of the cluster writes its
//   partial sums of those rows into the finishing block's shared memory
//   (distributed shared memory, one cluster barrier), which adds the 4
//   partials in rank order and the bias, and applies the gates. Two
//   launches on the same inputs give the same bits.
// No TF32 and no tensor cores: they would break fp32 parity.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;          // hidden units per cluster
constexpr int kSplit = 4;          // blocks per cluster, each a range of K
constexpr int kCols = 4 * kUnits;  // weight columns per cluster: [i | f | g | o] x kUnits
constexpr int kRows = 64;          // batch rows per cluster
constexpr int kThreads = 256;
// A thread holds 2 rows x 4 units x 4 gates; a group of threads covers the
// cluster's tile once, and the groups split each staged tile's steps.
constexpr int kGroupThreads = kRows / 2 * (kUnits / 4);
constexpr int kGroups = kThreads / kGroupThreads;
constexpr int kKT = 32;  // contraction steps per staged tile
constexpr int kStepsPerGroup = kKT / kGroups;
constexpr int kStages = 4;                // tiles in flight
constexpr int kTile = kRows * kCols;      // one block's partial sums, fp32
constexpr int kOwnRows = kRows / kSplit;  // rows each block of the cluster finishes
constexpr int kPart = kOwnRows * kCols;   // one block's partial sums of one owner's rows
static_assert(kThreads % kGroupThreads == 0 && kStepsPerGroup % 4 == 0, "tiling");
static_assert(kOwnRows * kUnits <= kThreads && kTile % (4 * kThreads) == 0, "reduction");

template <typename T> struct Layout {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kXS = kKT + kVec;       // row stride of the [x | h] tile
  static constexpr int kStageElems = kRows * kXS + kKT * kCols;
  static constexpr size_t kStageBytes = sizeof(T) * kStages * kStageElems;
  // the groups' sums reuse the stages; then the kSplit partials this block receives
  static constexpr size_t kRedBytes = sizeof(float) * kGroups * kTile;
  static constexpr size_t kLanding = kStageBytes > kRedBytes ? kStageBytes : kRedBytes;
  static constexpr size_t kSmem = kLanding + sizeof(float) * kTile;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive elements of shared memory as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// The cluster's barrier in two halves: arrive (release, or relaxed when it
// orders no memory) and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

struct Args {
  int B, d_in, H, K;
  int row0, j0;  // the cluster's first batch row and hidden unit
};

// Stage tile [k0, k0 + kKT) of the block's range (steps >= k_end are zero):
// rows of [x | h] to xs (kRows x kXS), rows of [wx ; wh] restricted to the
// cluster's 32 columns to ws (kKT x kCols).
template <typename T, bool kAsync>
__device__ __forceinline__ void stage_tile(T* xs, T* ws, const T* __restrict__ x,
                                           const T* __restrict__ h, const T* __restrict__ wx,
                                           const T* __restrict__ wh, const Args& a, int k0,
                                           int k_end) {
  const size_t w_stride = 4 * static_cast<size_t>(a.H);
  if constexpr (kAsync) {
    constexpr int V = Layout<T>::kVec;
    constexpr int kXChunks = kRows * (kKT / V), kWChunks = kKT * (kCols / V);
    for (int c = threadIdx.x; c < kXChunks; c += kThreads) {
      const int r = c / (kKT / V), kc = (c % (kKT / V)) * V;
      const int row = a.row0 + r, k = k0 + kc;
      const bool ok = row < a.B && k < k_end;
      const T* src = x;
      if (ok) {
        src = k < a.d_in ? x + static_cast<size_t>(row) * a.d_in + k
                         : h + static_cast<size_t>(row) * a.H + (k - a.d_in);
      }
      cp_async16(xs + r * Layout<T>::kXS + kc, src, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < kWChunks; c += kThreads) {
      const int kr = c / (kCols / V), cc = (c % (kCols / V)) * V;
      const int k = k0 + kr;
      const int col = (cc / kUnits) * a.H + a.j0 + cc % kUnits;
      const bool ok = k < k_end;
      const T* src = wx;
      if (ok) {
        src = k < a.d_in ? wx + k * w_stride + col : wh + (k - a.d_in) * w_stride + col;
      }
      cp_async16(ws + kr * kCols + cc, src, ok ? 16 : 0);
    }
  } else {
    const T zero = from_f32<T>(0.0f);
    for (int i = threadIdx.x; i < kRows * kKT; i += kThreads) {
      const int r = i / kKT, kc = i % kKT;
      const int row = a.row0 + r, k = k0 + kc;
      T v = zero;
      if (row < a.B && k < k_end) {
        v = k < a.d_in ? x[static_cast<size_t>(row) * a.d_in + k]
                       : h[static_cast<size_t>(row) * a.H + (k - a.d_in)];
      }
      xs[r * Layout<T>::kXS + kc] = v;
    }
    for (int i = threadIdx.x; i < kKT * kCols; i += kThreads) {
      const int kr = i / kCols, cc = i % kCols;
      const int k = k0 + kr, u = a.j0 + cc % kUnits;
      const size_t col = (cc / kUnits) * static_cast<size_t>(a.H) + u;
      T v = zero;
      if (k < k_end && u < a.H) {
        v = k < a.d_in ? wx[k * w_stride + col] : wh[(k - a.d_in) * w_stride + col];
      }
      ws[kr * kCols + cc] = v;
    }
  }
}

template <typename T, bool kAsync>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ c,
                 const T* __restrict__ wx, const T* __restrict__ wh, const T* __restrict__ b,
                 T* __restrict__ h_out, T* __restrict__ c_out, float* __restrict__ gates,
                 int B, int d_in, int H) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // the groups' sums, once the stages are consumed
  float* landing = reinterpret_cast<float*>(smem + L::kLanding);

  cluster_arrive_relaxed();  // waited for before the first write to another block
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  Args a{B, d_in, H, d_in + H, static_cast<int>(blockIdx.y) * kRows,
         static_cast<int>(blockIdx.x / kSplit) * kUnits};

  // This block's range of K, in multiples of 8 steps (16-byte copies start
  // on them); the last range ends at K.
  const int per = ((a.K + kSplit - 1) / kSplit + 7) / 8 * 8;
  const int k_begin = min(a.K, rank * per), k_end = min(a.K, k_begin + per);
  const int n_tiles = (k_end - k_begin + kKT - 1) / kKT;

  const int group = threadIdx.x / kGroupThreads, lane = threadIdx.x % kGroupThreads;
  const int uq = lane % (kUnits / 4);  // units 4 * uq .. 4 * uq + 3
  const int rp = lane / (kUnits / 4);  // rows rp and rp + 32
  float acc[2][4][4] = {};

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      T* st = stages + s * L::kStageElems;
      stage_tile<T, kAsync>(st, st + kRows * L::kXS, x, h, wx, wh, a, k_begin + s * kKT, k_end);
    }
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int next = t + kStages - 1;
    if (next < n_tiles) {
      T* st = stages + (next % kStages) * L::kStageElems;
      stage_tile<T, kAsync>(st, st + kRows * L::kXS, x, h, wx, wh, a, k_begin + next * kKT,
                            k_end);
    }
    cp_async_commit();
    cp_async_wait_stages();
    __syncthreads();
    const T* st = stages + (t % kStages) * L::kStageElems;
    const T* xa = st + rp * L::kXS + group * kStepsPerGroup;
    const T* xb = xa + 32 * L::kXS;
    const T* wk = st + kRows * L::kXS + group * kStepsPerGroup * kCols + uq * 4;
#pragma unroll
    for (int k4 = 0; k4 < kStepsPerGroup; k4 += 4) {
      const float4 a4 = load4(xa + k4), b4 = load4(xb + k4);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 w = load4(wk + (k4 + j) * kCols + g * kUnits);
          acc[0][g][0] += av[j] * w.x;
          acc[0][g][1] += av[j] * w.y;
          acc[0][g][2] += av[j] * w.z;
          acc[0][g][3] += av[j] * w.w;
          acc[1][g][0] += bv[j] * w.x;
          acc[1][g][1] += bv[j] * w.y;
          acc[1][g][2] += bv[j] * w.z;
          acc[1][g][3] += bv[j] * w.w;
        }
      }
    }
    __syncthreads();  // the stage is free for the tile kStages ahead
  }

  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // The groups' sums, added in group order into this block's partial tile
  // (row-major kRows x kCols, column g * kUnits + unit), which goes straight
  // to the blocks that finish its rows: rows of owner p to slot rank of p.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      *reinterpret_cast<float4*>(red + group * kTile + (rp + 32 * r) * kCols + g * kUnits +
                                 uq * 4) =
          make_float4(acc[r][g][0], acc[r][g][1], acc[r][g][2], acc[r][g][3]);
    }
  }
  __syncthreads();
  cluster_wait();
  for (int i = 4 * threadIdx.x; i < kTile; i += 4 * kThreads) {
    float4 sum = *reinterpret_cast<const float4*>(red + i);
    for (int gr = 1; gr < kGroups; ++gr) {
      const float4 t = *reinterpret_cast<const float4*>(red + gr * kTile + i);
      sum.x += t.x, sum.y += t.y, sum.z += t.z, sum.w += t.w;
    }
    const int owner = i / kPart;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(landing, owner) + rank * kPart +
                               (i - owner * kPart)) = sum;
  }
  cluster_arrive();
  cluster_wait();  // every partial of this block's rows has landed

  // This block finishes rows kOwnRows * rank .. of the cluster's 64, adding
  // the kSplit partials in rank order, then the bias.
  if (threadIdx.x < kOwnRows * kUnits) {
    const int lr = threadIdx.x / kUnits, u = threadIdx.x % kUnits;
    const int row = a.row0 + rank * kOwnRows + lr, j = a.j0 + u;
    if (row < B && j < H) {
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < kSplit; ++p) {
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] += landing[p * kPart + lr * kCols + g * kUnits + u];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] += to_f32(b[g * static_cast<size_t>(H) + j]);
      const size_t o = static_cast<size_t>(row) * H + j;
      const float gi = sigmoid(z[0]), gf = sigmoid(z[1] + 1.0f), gg = tanhf(z[2]),
                  go = sigmoid(z[3]);
      const float c_new = gf * to_f32(c[o]) + gi * gg;
      const float h_new = go * tanhf(c_new);
      c_out[o] = from_f32<T>(c_new);
      h_out[o] = from_f32<T>(h_new);
      if (gates != nullptr) {
        float* gr = gates + static_cast<size_t>(row) * 4 * H + j;
        gr[0] = gi;
        gr[H] = gf;
        gr[2 * static_cast<size_t>(H)] = gg;
        gr[3 * static_cast<size_t>(H)] = go;
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kAsync>
int launch_as(const void* x, const void* h, const void* c, const void* wx, const void* wh,
              const void* b, void* h_out, void* c_out, void* gates, int B, int d_in, int H,
              void* stream) {
  static unsigned long long attribute_set = 0;  // a bit per device, per instantiation
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !(attribute_set >> device & 1)) {
    e = cudaFuncSetAttribute(lstm_cell_kernel<T, kAsync>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Layout<T>::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) attribute_set |= 1ull << device;
  }
  const dim3 grid(kSplit * ((H + kUnits - 1) / kUnits), (B + kRows - 1) / kRows);
  lstm_cell_kernel<T, kAsync><<<grid, kThreads, Layout<T>::kSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h_out), static_cast<T*>(c_out), static_cast<float*>(gates), B, d_in, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx, const void* wh,
           const void* b, void* h_out, void* c_out, void* gates, int B, int d_in, int H,
           void* stream) {
  if (B < 1 || d_in < 0 || H < 1 || (B + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte copies need every copied run to start on a 16-byte boundary:
  // 8 units of a gate (H % 8 == 0), rows of x and h (d_in % kVec == 0).
  const bool vec = H % kUnits == 0 && d_in % Layout<T>::kVec == 0 && aligned16(x) &&
                   aligned16(h) && aligned16(wx) && aligned16(wh);
  return vec ? launch_as<T, true>(x, h, c, wx, wh, b, h_out, c_out, gates, B, d_in, H, stream)
             : launch_as<T, false>(x, h, c, wx, wh, b, h_out, c_out, gates, B, d_in, H, stream);
}

}  // namespace

extern "C" int lstm_cell_f32(const void* x, const void* h, const void* c, const void* wx,
                             const void* wh, const void* b, void* h_out, void* c_out,
                             int B, int d_in, int H, void* stream) {
  return launch<float>(x, h, c, wx, wh, b, h_out, c_out, nullptr, B, d_in, H, stream);
}

// The forward of a training step: as lstm_cell_f32, and the activated gates
// (B, 4H) fp32 to ``gates``.
extern "C" int lstm_cell_train_f32(const void* x, const void* h, const void* c, const void* wx,
                                   const void* wh, const void* b, void* h_out, void* c_out,
                                   void* gates, int B, int d_in, int H, void* stream) {
  return launch<float>(x, h, c, wx, wh, b, h_out, c_out, gates, B, d_in, H, stream);
}

extern "C" int lstm_cell_bf16(const void* x, const void* h, const void* c, const void* wx,
                              const void* wh, const void* b, void* h_out, void* c_out,
                              int B, int d_in, int H, void* stream) {
  return launch<__nv_bfloat16>(x, h, c, wx, wh, b, h_out, c_out, nullptr, B, d_in, H, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
