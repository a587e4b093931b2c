// One LSTM layer's backward through time for Hopper (sm_90a), fp32, in one
// persistent launch.
//
// No TPU kernel to replace: the JAX package differentiates its layer scan
// (src/repro/models/seq2seq.py:73 lstm_scan over :63 lstm_cell) with XLA's
// autodiff. This is the serial half of that gradient. With the activated
// gates i, f, g, o and the cell states c_0 .. c_T of the training forward,
// it walks t = T-1 .. 0:
//   dh      = dhs[t] (+ dh_last at t = T-1) + dz[t+1] wh^T (not at t = T-1)
//   dc      = dc_last at t = T-1, else the previous step's dc_prev
//   dct     = dc + dh * o * (1 - tanh(c_{t+1})^2)
//   dz[t]   = [dct g i (1-i) | dct c_t f (1-f) | dct i (1-g^2) | dh tanh(c_{t+1}) o (1-o)]
//   dc_prev = dct * f
// and ends with dh0 = dz[0] wh^T, dc0 = the last dc_prev. A null dhs,
// dh_last or dc_last is a zero gradient. The four other products of the
// gradient (dx = dz wx^T, dwx = x^T dz, dwh = h^T dz, db = sum dz) are sums
// over time, one large product each outside this kernel. The plain version
// is kernels/lstm_cell/ref.py:lstm_layer_bwd_ref.
//
// What bounds it: at T 128, B 32, H 256 the serial products are 2.15 GFLOP
// (0.032 ms at 67 TFLOP/s) and the bytes (gates, c, dhs, dz, wh) 43 MB
// (0.013 ms at 3.35 TB/s). But each step needs the last one's dz, so the
// floor is T exchanges between the blocks that hold wh, one cluster barrier
// each.
//
// Design. Batch rows are independent, so they are split over clusters of
// kSplit = 8 blocks, up to kMaxRows rows each (as many clusters as can run
// at once). Within a cluster, block r owns U = ceil(H / 8) hidden units and
// the four gate columns of each, K = 4U columns of wh, which it holds in
// shared memory for the whole launch (wh read once per cluster). Each step:
// - the block forms its partial dz[t+1][:, own cols] wh[:, own cols]^T for
//   every hidden unit of its rows (a thread a unit, sums in column order);
// - it writes each owner's slice of those partials into that owner's shared
//   memory (distributed shared memory; two landings, by step parity) and
//   passes one cluster barrier;
// - each owner adds the 8 partials in rank order, then dhs[t], and applies
//   the pointwise algebra above (as csrc/lstm_cell_bwd.cu) to its units,
//   writing dz[t] to its shared memory for the next step. Its global
//   traffic (dz[t] out, the step after's gates, c and dhs in) goes between
//   the next step's arrive and wait on the barrier, so the barrier's release
//   waits for none of it and its latency hides behind the exchange.
// The exchange is csrc/lstm_cell.cu's. Every sum runs in a fixed order and
// nothing is atomic, so two launches give the same bits, at any split of
// the rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;     // blocks of a cluster
constexpr int kThreads = 256;
constexpr int kMaxRows = 8;   // batch rows a cluster walks
constexpr int kMaxPairs = 2;  // (row, unit) pairs a thread finishes
constexpr int kSmemLimit = 232448;

struct LayerArgs {
  const float* dhs;      // (T, B, H) or null
  const float* dh_last;  // (B, H) or null
  const float* dc_last;  // (B, H) or null
  const float* gates;    // (T, B, 4H)
  const float* cs;       // (T + 1, B, H)
  const float* wh;       // (H, 4H)
  float* dz;             // (T, B, 4H)
  float* dh0;            // (B, H)
  float* dc0;            // (B, H)
  int T, B, H, rows, units;
};

__host__ __device__ constexpr long long smem_floats(int H, int rows) {
  // wh's own columns (K x (H + 1)), dz's own columns (rows x K), two
  // landings of every block's partials (2 x kSplit x rows x U)
  return 4LL * ((H + kSplit - 1) / kSplit) * (H + 1) +
         static_cast<long long>(rows) * 4 * ((H + kSplit - 1) / kSplit) +
         2LL * kSplit * rows * ((H + kSplit - 1) / kSplit);
}

// Whether a block fits hidden width H when its cluster walks kMaxRows rows:
// its shared memory and the (row, unit) pairs its threads finish.
__host__ __device__ constexpr bool takes_hidden(int H) {
  return H >= 1 && smem_floats(H, kMaxRows) * 4 <= kSmemLimit &&
         kMaxRows * ((H + kSplit - 1) / kSplit) <= kMaxPairs * kThreads;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// partial[r][j] = sum over this block's columns k of dzs[r][k] * ws[k][j],
// for every unit j, sent to j's owner: landing slot (buf, rank) of it. Four
// partial sums a row (columns k mod 4), added in a fixed order at the end,
// keep the FMA chains short; kR = the rows a cluster walks, a power of two.
template <int kR>
__device__ __forceinline__ void send_partials_as(const LayerArgs& a, cg::cluster_group& cluster,
                                                 const float* ws, const float* dzs,
                                                 float* landing, int buf, int rank) {
  const int U = a.units, K = 4 * U, H = a.H, ldw = H + 1;
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float acc[4][kR];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[q][r] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      const float w0 = ws[k * ldw + j], w1 = ws[(k + 1) * ldw + j], w2 = ws[(k + 2) * ldw + j],
                  w3 = ws[(k + 3) * ldw + j];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(dzs + r * K + k);
        acc[0][r] = fmaf(d.x, w0, acc[0][r]);
        acc[1][r] = fmaf(d.y, w1, acc[1][r]);
        acc[2][r] = fmaf(d.z, w2, acc[2][r]);
        acc[3][r] = fmaf(d.w, w3, acc[3][r]);
      }
    }
    const int owner = j / U, u = j - owner * U;
    float* dst = cluster.map_shared_rank(landing, owner) + ((buf * kSplit + rank) * kR) * U + u;
#pragma unroll
    for (int r = 0; r < kR; ++r) dst[r * U] = (acc[0][r] + acc[1][r]) + (acc[2][r] + acc[3][r]);
  }
}

__device__ __forceinline__ void send_partials(const LayerArgs& a, cg::cluster_group& cluster,
                                              const float* ws, const float* dzs, float* landing,
                                              int buf, int rank) {
  switch (a.rows) {
    case 1: send_partials_as<1>(a, cluster, ws, dzs, landing, buf, rank); break;
    case 2: send_partials_as<2>(a, cluster, ws, dzs, landing, buf, rank); break;
    case 4: send_partials_as<4>(a, cluster, ws, dzs, landing, buf, rank); break;
    default: send_partials_as<kMaxRows>(a, cluster, ws, dzs, landing, buf, rank); break;
  }
}

// One step's inputs for a thread's (row, unit) pairs: the four gates, c_t,
// c_{t+1} and dh's direct terms (dhs[t], and dh_last at the last step).
struct StepIn {
  float g[kMaxPairs][4], c[kMaxPairs], cn[kMaxPairs], dh[kMaxPairs];
};

__device__ __forceinline__ void load_step(const LayerArgs& a, StepIn& in, int t, int row0,
                                          int n_rows, int j0, int n_units) {
  const int U = a.units, H = a.H;
  const long long BH = static_cast<long long>(a.B) * H;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / U, u = p - r * U;
    if (p < a.rows * U && r < n_rows && u < n_units) {
      const long long e = static_cast<long long>(row0 + r) * H + j0 + u;
      const float* gr = a.gates + t * 4 * BH + (row0 + r) * 4LL * H + j0 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) in.g[i][g] = gr[static_cast<long long>(g) * H];
      in.c[i] = a.cs[t * BH + e];
      in.cn[i] = a.cs[(t + 1) * BH + e];
      in.dh[i] = a.dhs != nullptr ? a.dhs[t * BH + e] : 0.0f;
      if (t == a.T - 1 && a.dh_last != nullptr) in.dh[i] += a.dh_last[e];
    }
  }
}

// dz of the last step, kept in registers, to global memory
__device__ __forceinline__ void store_dz(const LayerArgs& a, const float (&z)[kMaxPairs][4],
                                         int t, int row0, int n_rows, int j0, int n_units) {
  const int U = a.units, H = a.H;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / U, u = p - r * U;
    if (p < a.rows * U && r < n_rows && u < n_units) {
      float* zr = a.dz + (static_cast<long long>(t) * a.B + row0 + r) * 4 * H + j0 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) zr[static_cast<long long>(g) * H] = z[i][g];
    }
  }
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
lstm_layer_bwd_kernel(const LayerArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int U = a.units, K = 4 * U, H = a.H, R = a.rows, ldw = H + 1;
  float* ws = smem;              // [K][H + 1]: ws[g U + u][j] = wh[j][g H + j0 + u]
  float* dzs = ws + K * ldw;     // [R][K]: this block's columns of dz[t + 1]
  float* landing = dzs + R * K;  // [2][kSplit][R][U]

  cluster_arrive_relaxed();  // waited for before the first write to another block
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = rank * U, n_units = max(0, min(U, H - j0));
  const int row0 = static_cast<int>(blockIdx.x / kSplit) * R;
  const int n_rows = min(R, a.B - row0);

  // the block's columns of wh: consecutive threads read consecutive units
  for (int i = threadIdx.x; i < K * H; i += kThreads) {
    const int j = i / K, k = i - j * K;
    const int g = k / U, u = k - g * U;
    ws[k * ldw + j] = u < n_units ? a.wh[static_cast<size_t>(j) * 4 * H + g * H + j0 + u] : 0.0f;
  }
  for (int i = threadIdx.x; i < R * K; i += kThreads) dzs[i] = 0.0f;

  float dc[kMaxPairs], z[kMaxPairs][4];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / U, u = p - r * U;
    dc[i] = 0.0f;
    if (a.dc_last != nullptr && p < R * U && r < n_rows && u < n_units) {
      dc[i] = a.dc_last[static_cast<long long>(row0 + r) * H + j0 + u];
    }
  }
  StepIn cur, nxt;
  load_step(a, cur, a.T - 1, row0, n_rows, j0, n_units);
  __syncthreads();
  cluster_wait();

  int buf = 0;
  for (int t = a.T - 1; t >= 0; --t) {
    const bool product = t < a.T - 1;  // dz[t + 1] exists
    if (product) {
      send_partials(a, cluster, ws, dzs, landing, buf, rank);
      cluster_arrive();
      // global traffic after the arrive, so that its release waits for none
      // of it: the last step's dz out, the next step's inputs in
      store_dz(a, z, t + 1, row0, n_rows, j0, n_units);
      if (t > 0) load_step(a, nxt, t - 1, row0, n_rows, j0, n_units);
      cluster_wait();  // every partial of this block's units has landed
    } else if (t > 0) {
      load_step(a, nxt, t - 1, row0, n_rows, j0, n_units);
    }
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = threadIdx.x + i * kThreads, r = p / U, u = p - r * U;
      if (p < R * U && r < n_rows && u < n_units) {
        float dh = 0.0f;
        if (product) {
          for (int q = 0; q < kSplit; ++q) dh += landing[((buf * kSplit + q) * R + r) * U + u];
        }
        dh += cur.dh[i];
        const float gi = cur.g[i][0], gf = cur.g[i][1], gg = cur.g[i][2], go = cur.g[i][3];
        const float tc = tanhf(cur.cn[i]);
        const float dct = dc[i] + dh * go * (1.0f - tc * tc);
        z[i][0] = dct * gg * gi * (1.0f - gi);
        z[i][1] = dct * cur.c[i] * gf * (1.0f - gf);
        z[i][2] = dct * gi * (1.0f - gg * gg);
        z[i][3] = dh * tc * go * (1.0f - go);
#pragma unroll
        for (int g = 0; g < 4; ++g) dzs[r * K + g * U + u] = z[i][g];
        dc[i] = dct * gf;
      }
    }
    __syncthreads();  // dz[t] is in for the next step's product
    if (product) buf ^= 1;
    cur = nxt;
  }

  // dh0 = dz[0] wh^T; dc0 = the last dc_prev
  send_partials(a, cluster, ws, dzs, landing, buf, rank);
  cluster_arrive();
  store_dz(a, z, 0, row0, n_rows, j0, n_units);
  cluster_wait();
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / U, u = p - r * U;
    if (p < R * U && r < n_rows && u < n_units) {
      float dh = 0.0f;
      for (int q = 0; q < kSplit; ++q) dh += landing[((buf * kSplit + q) * R + r) * U + u];
      const long long e = static_cast<long long>(row0 + r) * H + j0 + u;
      a.dh0[e] = dh;
      a.dc0[e] = dc[i];
    }
  }
}

}  // namespace

// dhs (T, B, H), dh_last, dc_last (B, H), each or null; gates (T, B, 4H); cs
// (T + 1, B, H); wh (H, 4H) -> dz (T, B, 4H), dh0, dc0 (B, H). All fp32,
// contiguous. The rows a cluster walks are chosen here: the fewest powers of
// two that keep every cluster of the launch resident at once (at most
// kMaxRows).
extern "C" int lstm_layer_bwd_f32(const void* dhs, const void* dh_last, const void* dc_last,
                                  const void* gates, const void* cs, const void* wh, void* dz,
                                  void* dh0, void* dc0, int T, int B, int H, void* stream) {
  const int U = (H + kSplit - 1) / kSplit;
  if (T < 1 || B < 1 || !takes_hidden(H)) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long attribute_set = 0;  // a bit per device
  static int resident[64] = {};                 // clusters resident at once, by device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 64 || !(attribute_set >> device & 1)) {
    e = cudaFuncSetAttribute(lstm_layer_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t probe = {};
    probe.gridDim = dim3(kSplit);
    probe.blockDim = dim3(kThreads);
    probe.dynamicSmemBytes = kSmemLimit;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, lstm_layer_bwd_kernel, &probe);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 64) {
      resident[device] = n;
      attribute_set |= 1ull << device;
    }
  }
  const int fit = device < 64 && resident[device] > 0 ? resident[device] : 1;
  int rows = 1;  // a power of two: the product is compiled for 1, 2, 4 and 8 rows
  while (rows < kMaxRows && rows * fit < B) rows *= 2;
  const long long clusters = (B + rows - 1) / rows;
  if (clusters * kSplit > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const LayerArgs a{static_cast<const float*>(dhs), static_cast<const float*>(dh_last),
                    static_cast<const float*>(dc_last), static_cast<const float*>(gates),
                    static_cast<const float*>(cs), static_cast<const float*>(wh),
                    static_cast<float*>(dz), static_cast<float*>(dh0), static_cast<float*>(dc0),
                    T, B, H, rows, U};
  lstm_layer_bwd_kernel<<<static_cast<unsigned>(clusters * kSplit), kThreads,
                          smem_floats(H, rows) * 4, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest hidden the entry takes (it takes every H from 1 up to it).
extern "C" long long lstm_layer_bwd_max_hidden() {
  int H = 0;
  while (takes_hidden(H + 1)) ++H;
  return H;
}
