// Fused LSTM recurrence, forward, float32 or bfloat16 streams: the inference
// (light) variant and the training variant that also saves residuals. One source, two grids:
// both directions of a BiLSTM layer (bilstm_fwd_*), or one direction of an
// LSTM (lstm_fwd_*, with a reverse flag).
//
// Replaces two TPU kernels, both their light pallas_call and their
// save_residuals one: room_slam_tpu/ops/rnn_pallas.py::_bilstm_fwd_kernel
// (:390, pallas_call :531 and :560, launched through _bilstm_fwd_pallas and
// bilstm_recurrence_pallas) with the grid's two directions, and
// _lstm_chunk_kernel (:105, pallas_call :183 and :210, launched through
// _lstm_fwd_pallas and lstm_recurrence_pallas) with a grid of one
// direction. Per direction:
//
//   g_t = xg_t + T(h_{t-1}) @ T(W_hh)    (gate order i, f, g, o; f32 sums)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
//
// with T() the rounding to the stream type, where the Pallas kernels round
// (rnn_pallas.py:126-127, :407): W_hh and h before the dot product; the h
// and c carries stay float32, and the outputs and residuals are stored in
// the stream type.
//
// The training variant (kSave) also stores, per direction, c_t [B, N, H]
// and the activated gates (sigmoid i, sigmoid f, tanh g, sigmoid o)
// [B, N, 4H] of every step: the residuals the backward kernel
// (bilstm_bwd.cu) reads.
//
// The forward direction walks t = 0 .. N-1 over xg_f; the backward
// direction walks t = N-1 .. 0 over xg_b (given in original time order), so
// no flipped copies are made and every output comes back in original time
// order. A single-direction LSTM's reverse walk is that backward direction:
// the same values as the reference, which flips xg, runs forward and flips
// back. Every step of the padded window runs; there is no mask, as in the
// reference.
//
// What bounds it on an H100. At the bench shape (B=32, N=500, H=64) the
// light kernel reads 32.8 MB of xg and writes 8.2 MB of ys (about 12 us at
// 3.35 TB/s) and does about 1.07 GFLOP (about 16 us at 67 TFLOP/s f32); the
// training variant writes 41 MB more residuals (about 12 us more); one
// direction (the single-direction LSTM) is half of each. Neither is the
// real floor: the recurrence is a chain of N dependent steps, each a 64-deep
// dot product per gate column and the cell update, so the time is N times
// the latency of one step.
//
// What held the first design back (now the wide kernel below). One
// block of 4H threads per (4-row tile, direction), thread j owning gate
// column j with W_hh in shared memory: per k one load of W and four scalar
// loads of h for 4 FMAs, about 2,560 warp-level shared loads a step for 8
// warps; two block barriers a step; three of the four rows padding at the
// serving batch of 1. Measured on an H100: 1.74 us a step at B=1, 1.92 us at
// B=20, against cuDNN's 0.90 and 1.04 (input projection included).
//
// What the design does about it (bilstm_fwd_kernel, H <= kMaxRegH = 64).
// Four lanes of one warp own hidden unit u of a tile of R rows (R = 1, 2 or
// 4, a template; the wrapper sizes it to the batch and the card, rnn_cuda
// unit_plans). Lane p holds the W_hh values of all four gate columns of u
// for its quarter of the k sum in registers for the whole walk (64 floats
// at H=64), and reads h_{t-1}, laid out [k][R] in shared memory, as 16-byte
// broadcasts, each feeding 4 k x R rows x 4 gates = 16 FMAs. The four lanes'
// partial sums meet by __shfl_xor_sync (a reduce-scatter: lane p ends with
// the four gate sums of row p % R, xg already added), so the cell update
// and the c carry stay in the lane's registers, and one block barrier a
// step orders the double-buffered h tile. Activations use __expf and a
// fast reciprocal (a few ulp, far inside the 1e-4 bound). xg is loaded
// kAhead = 8 steps ahead into a register ring (the step loop unrolled by
// 8) and the stores are fire-and-forget, off the chain.
//
// What bounds it now. Measured on an H100: 0.45 us a step at B=1 and 0.55
// at B=20 with residuals (cuDNN 0.90 and 1.04). A row's FMA issue is about
// 0.06 us of it (the 2- and 4-row tiles take that much more a row); the
// rest is the step's fixed chain: barrier, two shuffle rounds, the
// activations' MUFU latency and the h broadcast.
//
// H above 64 (no model runs one: the flagship and legacy LSTMs are H=64)
// takes the wide kernel, the first design kept as it was: W_hh [H, 4H] in
// dynamic shared memory (64 KiB at H=64, up to H=118 in f32), thread j owns
// gate column j of a 4-row tile.
//
// Above that, up to H = kMaxClusterH = 256 (an lstm model at d_model 512),
// one direction's W_hh (1 MiB in f32 at H=256) fits no block, so the
// cluster kernel (bilstm_fwd_cluster_kernel) splits it by hidden units
// across a thread-block cluster of C = 1, 2, 4 or 8 blocks, the scheme of
// bigru_fwd.cu's cluster kernel: one cluster per (direction, batch tile of
// R rows); the block of rank q owns the U = ceil(H / C) units q*U ..
// min(H, q*U+U)-1 (the last block's slice may be short: its other threads
// are masked) and holds their four gate columns of W_hh in shared memory as
// float32 (128 KiB at H=256, C=8). Thread (u, g) runs the four gate sums of
// unit u for kRowsPerThread rows, its cell update and the c carries in
// registers; it pushes its T(h_t) into the double-buffered h tile [H, R] of
// every block of the cluster (distributed shared memory) and one
// cluster.sync() a step orders the pushes before the next step's reads.
// Bound like the BiGRU cluster kernel: a serial H-deep chain of shared
// loads a step. The wrapper picks the kernel (rnn_cuda.lstm_fwd_kernel_route,
// and lstm_cluster_plan for the cluster and tile) and may force any of the
// three for an A/B.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;  // wide kernel: batch rows per block, 4H threads

// unit kernel: lanes per hidden unit, k values of the sum held in registers
// (over the four lanes), and the threads of a block at H = kMaxRegH
constexpr int kLanes = 4;
constexpr int kMaxRegH = 64;
constexpr int kKPerLane = kMaxRegH / kLanes;
constexpr int kUnitThreads = kLanes * kMaxRegH;
constexpr int kAhead = 8;  // steps of xg in flight ahead of the chain
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// __expf and a fast reciprocal: a few ulp; exp overflowing to inf gives the
// limits 0 and -1 / +1
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// The four lanes of a unit each hold partial sums v[g][r] of G gates for R
// rows; afterwards lane p holds in out[g] the full sums of row p % R
// (a reduce-scatter over lane bits 0 and 1; an all-reduce where R < 4).
template <int G, int R>
__device__ __forceinline__ void reduce_lanes(const float (&v)[G][R],
                                             float (&out)[G], int lane) {
  const bool b0 = (lane & 1) != 0;
  const bool b1 = (lane & 2) != 0;
  if constexpr (R == 4) {
    float half[G][2];  // rows 2j + b0, summed over lanes p and p ^ 1
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float keep = b0 ? v[g][2 * j + 1] : v[g][2 * j];
        const float send = b0 ? v[g][2 * j] : v[g][2 * j + 1];
        half[g][j] = keep + __shfl_xor_sync(kFullMask, send, 1);
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float keep = b1 ? half[g][1] : half[g][0];
      const float send = b1 ? half[g][0] : half[g][1];
      out[g] = keep + __shfl_xor_sync(kFullMask, send, 2);
    }
  } else if constexpr (R == 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float keep = b0 ? v[g][1] : v[g][0];
      const float send = b0 ? v[g][0] : v[g][1];
      out[g] = keep + __shfl_xor_sync(kFullMask, send, 1);
      out[g] += __shfl_xor_sync(kFullMask, out[g], 2);
    }
  } else {
    static_assert(R == 1, "tiles of 1, 2 or 4 rows");
#pragma unroll
    for (int g = 0; g < G; ++g) {
      out[g] = v[g][0] + __shfl_xor_sync(kFullMask, v[g][0], 1);
      out[g] += __shfl_xor_sync(kFullMask, out[g], 2);
    }
  }
}

// The unit kernel: one block per (tile of R rows, direction), four lanes per
// hidden unit, W_hh in registers (see the notes at the top).
template <typename T, bool kSave, int R>
__global__ void __launch_bounds__(kUnitThreads)
bilstm_fwd_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                  const T* __restrict__ w_f, const T* __restrict__ w_b,
                  T* __restrict__ ys_f, T* __restrict__ ys_b,
                  T* __restrict__ cs_f, T* __restrict__ cs_b,
                  T* __restrict__ gs_f, T* __restrict__ gs_b, int B, int N,
                  int H, int rev) {
  constexpr int KC = 4 / R;                  // k values in one float4 of h
  constexpr int kChunks = kKPerLane / KC;    // float4 loads a lane a step
  // h_{t-1} as [k][R] floats, double buffered; k >= H stays zero
  __shared__ float4 h_s[2][kMaxRegH * R / 4];
  const int G = 4 * H;

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  const int lane = threadIdx.x % kLanes;
  const int u = threadIdx.x / kLanes;  // hidden unit; u >= H pads the warp
  const bool unit_valid = u < H;
  const int row0 = blockIdx.x * R;

  // this lane's W_hh values: chunk c of the lane covers k = (c * kLanes +
  // lane) * KC + e, e < KC, for all four gate columns of unit u
  float wr[4][kKPerLane];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const int k = (c * kLanes + lane) * KC + e;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wr[g][c * KC + e] =
            unit_valid && k < H ? to_f32<T>(w[static_cast<size_t>(k) * G +
                                              g * H + u])
                                : 0.0f;
    }
  float* h_flat = reinterpret_cast<float*>(h_s);
  for (int i = threadIdx.x; i < 2 * kMaxRegH * R; i += blockDim.x)
    h_flat[i] = 0.0f;

  // lane p starts the sums of gate p with xg of its R rows
  const size_t row_stride = static_cast<size_t>(N) * G;
  bool xvalid[R];
  const T* xrow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xvalid[r] = unit_valid && row0 + r < B;
    xrow[r] = xg + static_cast<size_t>(xvalid[r] ? row0 + r : 0) * row_stride +
              lane * H + (unit_valid ? u : 0);
  }
  // the (row, unit) cell this lane updates: row p % R; lanes p < R store it
  const int orow = lane % R;
  const bool owner = lane < R && unit_valid && row0 + orow < B;
  const size_t cell_row = static_cast<size_t>(owner ? row0 + orow : 0);
  T* yrow = (bwd ? ys_b : ys_f) + cell_row * N * H + (unit_valid ? u : 0);
  T* crow = nullptr;
  T* grow = nullptr;
  if (kSave) {
    crow = (bwd ? cs_b : cs_f) + cell_row * N * H + (unit_valid ? u : 0);
    grow = (bwd ? gs_b : gs_f) + cell_row * row_stride + (unit_valid ? u : 0);
  }
  float c = 0.0f;

  // xg of the next kAhead steps as loaded, converted to float only when
  // used: a ring indexed by the step's place in an unrolled group, so each
  // load has kAhead steps to land before the chain needs it
  T xq[kAhead][R];
  auto load_x = [&](T (&dst)[R], int s) {
    const size_t ts = static_cast<size_t>(bwd ? N - 1 - s : s) * G;
#pragma unroll
    for (int r = 0; r < R; ++r)
      dst[r] = xvalid[r] ? xrow[r][ts] : from_f32<T>(0.0f);
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < N) load_x(xq[j], j);
  __syncthreads();

  auto step = [&](int s, T (&xs)[R]) {
    const int t = bwd ? N - 1 - s : s;
    float acc[4][R];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[g][r] = g == lane ? to_f32<T>(xs[r]) : 0.0f;
    if (s + kAhead < N) load_x(xs, s + kAhead);

    const float4* hb = h_s[s & 1];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const float4 hv = hb[ch * kLanes + lane];
      const float hk[4] = {hv.x, hv.y, hv.z, hv.w};  // [e][r]
#pragma unroll
      for (int e = 0; e < KC; ++e)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[g][r] = fmaf(hk[e * R + r], wr[g][ch * KC + e], acc[g][r]);
    }
    float gsum[4];
    reduce_lanes<4, R>(acc, gsum, lane);

    const float ig = fast_sigmoid(gsum[0]);
    const float fg = fast_sigmoid(gsum[1]);
    const float gg = fast_tanh(gsum[2]);
    const float og = fast_sigmoid(gsum[3]);
    c = fg * c + ig * gg;
    const T h_t = from_f32<T>(og * fast_tanh(c));
    if (lane < R && unit_valid)
      reinterpret_cast<float*>(h_s[(s + 1) & 1])[u * R + orow] =
          to_f32<T>(h_t);
    if (owner) {
      yrow[static_cast<size_t>(t) * H] = h_t;
      if (kSave) {
        crow[static_cast<size_t>(t) * H] = from_f32<T>(c);
        T* gt = grow + static_cast<size_t>(t) * G;
        gt[0] = from_f32<T>(ig);
        gt[H] = from_f32<T>(fg);
        gt[2 * H] = from_f32<T>(gg);
        gt[3 * H] = from_f32<T>(og);
      }
    }
    __syncthreads();
  };
  for (int s0 = 0; s0 < N; s0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (s0 + j < N) step(s0 + j, xq[j]);
  }
}

// The wide kernel (H > kMaxRegH): W_hh in dynamic shared memory, thread j
// owns gate column j of a kRows-row tile.
template <typename T, bool kSave>
__global__ void __launch_bounds__(512)
bilstm_fwd_wide_kernel(const T* __restrict__ xg_f,
                       const T* __restrict__ xg_b,
                       const T* __restrict__ w_f,
                       const T* __restrict__ w_b,
                       T* __restrict__ ys_f,
                       T* __restrict__ ys_b,
                       T* __restrict__ cs_f,
                       T* __restrict__ cs_b,
                       T* __restrict__ gs_f,
                       T* __restrict__ gs_b,
                       int B, int N, int H, int rev) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* w_s = smem;            // [H, 4H]  this direction's W_hh
  float* g_s = w_s + H * G;     // [kRows, 4H]  gate pre-activations
  float* h_s = g_s + kRows * G; // [kRows, H]  h, rounded to T for the dot

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  T* ys = bwd ? ys_b : ys_f;
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;  // gate column, 0 .. 4H-1

  for (int idx = j; idx < H * G; idx += G) w_s[idx] = to_f32<T>(w[idx]);
  for (int idx = j; idx < kRows * H; idx += G) h_s[idx] = 0.0f;

  // The (row, unit) cell this thread updates; its c carry is a register.
  const int cb = j / H;
  const int cu = j - cb * H;
  const bool cell_valid = row0 + cb < B;
  const size_t cell_row = static_cast<size_t>(cell_valid ? row0 + cb : 0);
  float c = 0.0f;

  const size_t row_stride = static_cast<size_t>(N) * G;
  bool valid[kRows];
  const T* xrow[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    valid[b] = row0 + b < B;
    xrow[b] = xg + static_cast<size_t>(valid[b] ? row0 + b : 0) * row_stride +
              j;
  }
  T* yrow = ys + cell_row * N * H + cu;
  T* crow = nullptr;
  T* grow = nullptr;
  if (kSave) {
    crow = (bwd ? cs_b : cs_f) + cell_row * N * H + cu;
    grow = (bwd ? gs_b : gs_f) + cell_row * row_stride + cu;
  }

  // the next step's xg as loaded, converted to float only when used, so
  // no conversion waits on a load in flight
  T xnext[kRows];
  {
    const int t0 = bwd ? N - 1 : 0;
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      xnext[b] = valid[b] ? xrow[b][static_cast<size_t>(t0) * G]
                          : from_f32<T>(0.0f);
  }
  __syncthreads();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? N - 1 - s : s;
    float acc[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[b] = to_f32<T>(xnext[b]);
    if (s + 1 < N) {
      const size_t tn = static_cast<size_t>(bwd ? t - 1 : t + 1) * G;
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        xnext[b] = valid[b] ? xrow[b][tn] : from_f32<T>(0.0f);
    }

#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float wk = w_s[k * G + j];
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        acc[b] = fmaf(h_s[b * H + k], wk, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < kRows; ++b) g_s[b * G + j] = acc[b];
    __syncthreads();

    const float* gr = g_s + cb * G;
    const float ig = sigmoid_f(gr[cu]);
    const float fg = sigmoid_f(gr[H + cu]);
    const float gg = tanhf(gr[2 * H + cu]);
    const float og = sigmoid_f(gr[3 * H + cu]);
    c = fg * c + ig * gg;
    const float h = og * tanhf(c);
    const T h_t = from_f32<T>(h);
    h_s[cb * H + cu] = to_f32<T>(h_t);
    if (cell_valid) {
      yrow[static_cast<size_t>(t) * H] = h_t;
      if (kSave) {
        crow[static_cast<size_t>(t) * H] = from_f32<T>(c);
        T* gt = grow + static_cast<size_t>(t) * G;
        gt[0] = from_f32<T>(ig);
        gt[H] = from_f32<T>(fg);
        gt[2 * H] = from_f32<T>(gg);
        gt[3 * H] = from_f32<T>(og);
      }
    }
    __syncthreads();
  }
}

// The cluster kernel: clusters of C blocks, kRowsPerThread rows a thread
constexpr int kRowsPerThread = 4;
constexpr int kClusterThreads = 512;   // __launch_bounds__
constexpr int kMaxClusterH = 256;

__host__ __device__ __forceinline__ size_t pad4(size_t n) {
  return (n + 3) / 4 * 4;
}

// The cluster kernel (H above the wide kernel's, see the notes at the top):
// W_hh split by hidden units across a thread-block cluster.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kClusterThreads)
bilstm_fwd_cluster_kernel(const T* __restrict__ xg_f,
                          const T* __restrict__ xg_b,
                          const T* __restrict__ w_f,
                          const T* __restrict__ w_b, T* __restrict__ ys_f,
                          T* __restrict__ ys_b, T* __restrict__ cs_f,
                          T* __restrict__ cs_b, T* __restrict__ gs_f,
                          T* __restrict__ gs_b, int B, int N, int H, int R,
                          int rev) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = (H + C - 1) / C;   // units a block owns (the last: fewer)
  const int G = 4 * H;
  float* w_s = smem;                                         // [H][4U]
  float* h_s = smem + pad4(static_cast<size_t>(H) * 4 * U);  // [2][H][R]

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  const int u = threadIdx.x % U;
  const int r0 = (threadIdx.x / U) * kRowsPerThread;  // first row in tile
  const int gu = rank * U + u;                        // global hidden unit
  const bool unit_ok = gu < H;                        // else masked
  const int row0 = (blockIdx.x / C) * R + r0;

  // this block's W_hh columns: c = gate * U + unit, for every k; the
  // columns of units past H are zero
  for (int idx = threadIdx.x; idx < H * 4 * U; idx += blockDim.x) {
    const int k = idx / (4 * U);
    const int c = idx - k * 4 * U;
    const int gate = c / U;
    const int unit = rank * U + (c - gate * U);
    w_s[idx] = unit < H ? to_f32<T>(w[static_cast<size_t>(k) * G +
                                      gate * H + unit])
                        : 0.0f;
  }
  for (int idx = threadIdx.x; idx < H * R; idx += blockDim.x) h_s[idx] = 0.0f;

  bool valid[kRowsPerThread];
  size_t xoff[kRowsPerThread];  // xg / gates of (row, t = 0, unit gu)
  size_t yoff[kRowsPerThread];  // ys / cs of (row, t = 0, unit gu)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    valid[i] = unit_ok && row0 + i < B;
    const size_t row = static_cast<size_t>(valid[i] ? row0 + i : 0);
    xoff[i] = row * N * G + (unit_ok ? gu : 0);
    yoff[i] = row * N * H + (unit_ok ? gu : 0);
  }
  T* ys = bwd ? ys_b : ys_f;
  T* cs = bwd ? cs_b : cs_f;
  T* gs = bwd ? gs_b : gs_f;

  // the next step's xg of the thread's rows and four gates, as loaded
  T xnext[kRowsPerThread][4];
  auto load_x = [&](int t) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const T* x = xg + xoff[i] + static_cast<size_t>(t) * G;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xnext[i][g] = valid[i] ? x[g * H] : from_f32<T>(0.0f);
    }
  };
  load_x(bwd ? N - 1 : 0);
  float c[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};

  // every block of the cluster runs and holds its W_hh slice and a zero
  // h_{-1} before any block writes into another's shared memory
  cluster.sync();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? N - 1 - s : s;
    float acc[4][kRowsPerThread];  // [gate][row], started with xg
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][i] = to_f32<T>(xnext[i][g]);
    if (s + 1 < N) load_x(bwd ? t - 1 : t + 1);

    const float* hb = h_s + (s & 1) * H * R + r0;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(hb + k * R);
      const float* wk = w_s + k * 4 * U + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float wv = wk[g * U];
        acc[g][0] = fmaf(hv.x, wv, acc[g][0]);
        acc[g][1] = fmaf(hv.y, wv, acc[g][1]);
        acc[g][2] = fmaf(hv.z, wv, acc[g][2]);
        acc[g][3] = fmaf(hv.w, wv, acc[g][3]);
      }
    }

    float hq[kRowsPerThread];  // h_t rounded to the stream type
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float ig = sigmoid_f(acc[0][i]);
      const float fg = sigmoid_f(acc[1][i]);
      const float gg = tanhf(acc[2][i]);
      const float og = sigmoid_f(acc[3][i]);
      c[i] = fg * c[i] + ig * gg;
      const T h_t = from_f32<T>(og * tanhf(c[i]));
      hq[i] = to_f32<T>(h_t);
      if (valid[i]) {
        ys[yoff[i] + static_cast<size_t>(t) * H] = h_t;
        if (kSave) {
          cs[yoff[i] + static_cast<size_t>(t) * H] = from_f32<T>(c[i]);
          T* gt = gs + xoff[i] + static_cast<size_t>(t) * G;
          gt[0] = from_f32<T>(ig);
          gt[H] = from_f32<T>(fg);
          gt[2 * H] = from_f32<T>(gg);
          gt[3 * H] = from_f32<T>(og);
        }
      }
    }

    // push this thread's h_t into the other buffer of every block
    if (unit_ok) {
      float* slot = h_s + ((s + 1) & 1) * H * R + gu * R + r0;
      const float4 hv = make_float4(hq[0], hq[1], hq[2], hq[3]);
      for (int q = 0; q < C; ++q)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(slot, q)) = hv;
    }
    cluster.sync();
  }
}

// Dynamic shared memory one block of the wide kernel needs at hidden size
// H, in bytes (the wrapper's bilstm_smem_bytes mirrors it to refuse an H
// that cannot fit).
size_t smem_bytes(int H) {
  const size_t G = 4 * static_cast<size_t>(H);
  return (static_cast<size_t>(H) * G + kRows * G +
          kRows * static_cast<size_t>(H)) * sizeof(float);
}

// The unit kernel's static shared memory (the h tile, double buffered) and
// threads: four lanes for each of H units, padded to whole warps (the
// wrapper's unit_smem_bytes and unit_threads mirror them).
constexpr size_t unit_smem_bytes(int R) {
  return 2 * static_cast<size_t>(kMaxRegH) * R * sizeof(float);
}
constexpr int unit_threads(int H) { return kLanes * ((H + 7) / 8 * 8); }

bool valid_unit_plan(int H, int R) {
  return H > 0 && H <= kMaxRegH && (R == 1 || R == 2 || R == 4);
}

// Dynamic shared memory each wide variant is already allowed on each
// device, so the attribute is set once per device (and again only for a
// larger H).
constexpr int kMaxDevices = 64;
template <typename T, bool kSave>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T, bool kSave>
cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices &&
      g_smem_allowed<T, kSave>[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bilstm_fwd_wide_kernel<T, kSave>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<T, kSave>[device].store(smem);
  return err;
}

template <typename T, bool kSave>
const void* unit_kernel(int R) {
  if (R == 1)
    return reinterpret_cast<const void*>(bilstm_fwd_kernel<T, kSave, 1>);
  if (R == 2)
    return reinterpret_cast<const void*>(bilstm_fwd_kernel<T, kSave, 2>);
  return reinterpret_cast<const void*>(bilstm_fwd_kernel<T, kSave, 4>);
}

// R: the unit kernel's batch tile (1, 2 or 4); wide != 0 launches the wide
// kernel instead, whose tile is kRows.
template <typename T, bool kSave>
int launch(const void* xg_f, const void* xg_b, const void* w_f,
           const void* w_b, void* ys_f, void* ys_b, void* cs_f, void* cs_b,
           void* gs_f, void* gs_b, int B, int N, int H, int R, int wide,
           int dirs, int rev, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    if (4 * H > 512 || R != kRows)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(H);
    const cudaError_t err = allow_smem<T, kSave>(static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((B + kRows - 1) / kRows, dirs);
    bilstm_fwd_wide_kernel<T, kSave><<<grid, 4 * H, smem, st>>>(
        in(xg_f), in(xg_b), in(w_f), in(w_b), out(ys_f), out(ys_b),
        out(cs_f), out(cs_b), out(gs_f), out(gs_b), B, N, H, rev);
    return static_cast<int>(cudaGetLastError());
  }
  if (!valid_unit_plan(H, R)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + R - 1) / R, dirs);
  const int threads = unit_threads(H);
  if (R == 1)
    bilstm_fwd_kernel<T, kSave, 1><<<grid, threads, 0, st>>>(
        in(xg_f), in(xg_b), in(w_f), in(w_b), out(ys_f), out(ys_b),
        out(cs_f), out(cs_b), out(gs_f), out(gs_b), B, N, H, rev);
  else if (R == 2)
    bilstm_fwd_kernel<T, kSave, 2><<<grid, threads, 0, st>>>(
        in(xg_f), in(xg_b), in(w_f), in(w_b), out(ys_f), out(ys_b),
        out(cs_f), out(cs_b), out(gs_f), out(gs_b), B, N, H, rev);
  else
    bilstm_fwd_kernel<T, kSave, 4><<<grid, threads, 0, st>>>(
        in(xg_f), in(xg_b), in(w_f), in(w_b), out(ys_f), out(ys_b),
        out(cs_f), out(cs_b), out(gs_f), out(gs_b), B, N, H, rev);
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel's slice, block and shared memory at H, C and R (the
// wrapper's lstm_cluster_smem_bytes("fwd", ...) and _lstm_cluster_rule
// mirror them, held to bilstm_fwd_cluster_smem_bytes when the library
// loads): U = ceil(H / C) units a block, every block owning one at least.
int cluster_units(int H, int C) { return (H + C - 1) / C; }

size_t cluster_smem_bytes(int H, int C, int R) {
  const size_t U = static_cast<size_t>(cluster_units(H, C));
  return (pad4(static_cast<size_t>(H) * 4 * U) +
          2 * static_cast<size_t>(H) * R) * sizeof(float);
}

bool valid_cluster_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || H > kMaxClusterH ||
      (C != 1 && C != 2 && C != 4 && C != 8) || R <= 0 ||
      R % kRowsPerThread != 0)
    return false;
  const int U = cluster_units(H, C);
  return (C - 1) * U < H && U * (R / kRowsPerThread) <= kClusterThreads;
}

template <typename T, bool kSave>
std::atomic<int> g_cluster_smem_allowed[kMaxDevices];

template <typename T, bool kSave>
cudaError_t allow_cluster_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices &&
      g_cluster_smem_allowed<T, kSave>[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bilstm_fwd_cluster_kernel<T, kSave>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_cluster_smem_allowed<T, kSave>[device].store(smem);
  return err;
}

void make_cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                         int B, int H, int C, int R, int dirs, size_t smem,
                         void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(C * ((B + R - 1) / R), dirs, 1);
  cfg->blockDim = dim3(cluster_units(H, C) * (R / kRowsPerThread), 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T, bool kSave>
int launch_cluster(const void* xg_f, const void* xg_b, const void* w_f,
                   const void* w_b, void* ys_f, void* ys_b, void* cs_f,
                   void* cs_b, void* gs_f, void* gs_b, int B, int N, int H,
                   int C, int R, int dirs, int rev, void* stream) {
  if (!valid_cluster_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cluster_smem_bytes(H, C, R);
  cudaError_t err = allow_cluster_smem<T, kSave>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_cluster_config(&cfg, &attr, B, H, C, R, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bilstm_fwd_cluster_kernel<T, kSave>,
                           in(xg_f), in(xg_b), in(w_f), in(w_b), out(ys_f),
                           out(ys_b), out(cs_f), out(cs_b), out(gs_f),
                           out(gs_b), B, N, H, R, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSave>
int cluster_max_active(int H, int C, int R) {
  const size_t smem = cluster_smem_bytes(H, C, R);
  cudaError_t err = allow_cluster_smem<T, kSave>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_cluster_config(&cfg, &attr, R, H, C, R, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, bilstm_fwd_cluster_kernel<T, kSave>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, bool kSave>
int unit_blocks_per_sm(int H, int R) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, unit_kernel<T, kSave>(R), unit_threads(H), 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device. All tensors are contiguous, in the stream type float (_f32) or
// bfloat16 (_bf16): xg_* [B, N, 4H], w_* [H, 4H], ys_* [B, N, H]. R is the
// unit kernel's batch tile (1, 2 or 4, H <= 64); wide != 0 launches the
// wide kernel (R must be 4). Returns a cudaError_t code; 0 means the launch
// was accepted.
#define BILSTM_FWD_ENTRIES(SFX, TYPE)                                         \
  int bilstm_fwd_##SFX(const void* xg_f, const void* xg_b, const void* w_f,  \
                       const void* w_b, void* ys_f, void* ys_b, int B,       \
                       int N, int H, int R, int wide, void* stream) {        \
    return launch<TYPE, false>(xg_f, xg_b, w_f, w_b, ys_f, ys_b, nullptr,    \
                               nullptr, nullptr, nullptr, B, N, H, R, wide,  \
                               2, 0, stream);                                \
  }                                                                          \
  /* as bilstm_fwd, and also the residuals of every step: cs_* [B, N, H]     \
     (c_t) and gs_* [B, N, 4H] (activated i, f, g, o) */                     \
  int bilstm_fwd_train_##SFX(const void* xg_f, const void* xg_b,             \
                             const void* w_f, const void* w_b, void* ys_f,   \
                             void* ys_b, void* cs_f, void* cs_b, void* gs_f, \
                             void* gs_b, int B, int N, int H, int R,         \
                             int wide, void* stream) {                       \
    return launch<TYPE, true>(xg_f, xg_b, w_f, w_b, ys_f, ys_b, cs_f, cs_b,  \
                              gs_f, gs_b, B, N, H, R, wide, 2, 0, stream);   \
  }                                                                          \
  /* one direction of an LSTM: a grid of one direction over xg [B, N, 4H],   \
     w [H, 4H] into ys [B, N, H]; reverse != 0 walks t = N-1 .. 0 */         \
  int lstm_fwd_##SFX(const void* xg, const void* w, void* ys, int B, int N,  \
                     int H, int R, int wide, int reverse, void* stream) {    \
    return launch<TYPE, false>(xg, xg, w, w, ys, ys, nullptr, nullptr,       \
                               nullptr, nullptr, B, N, H, R, wide, 1,        \
                               reverse, stream);                             \
  }                                                                          \
  /* as lstm_fwd, and also cs [B, N, H] and gs [B, N, 4H] */                 \
  int lstm_fwd_train_##SFX(const void* xg, const void* w, void* ys,          \
                           void* cs, void* gs, int B, int N, int H, int R,   \
                           int wide, int reverse, void* stream) {            \
    return launch<TYPE, true>(xg, xg, w, w, ys, ys, cs, cs, gs, gs, B, N, H, \
                              R, wide, 1, reverse, stream);                  \
  }

BILSTM_FWD_ENTRIES(f32, float)
BILSTM_FWD_ENTRIES(bf16, __nv_bfloat16)
#undef BILSTM_FWD_ENTRIES

// The cluster kernel: arguments and outputs as the entries above, with
// clusters of C blocks (1, 2, 4 or 8) over batch tiles of R rows (a
// multiple of 4) in place of the unit tile and the wide flag; H up to 256.
#define BILSTM_FWD_CLUSTER_ENTRIES(SFX, TYPE)                                 \
  int bilstm_fwd_cluster_##SFX(const void* xg_f, const void* xg_b,           \
                               const void* w_f, const void* w_b, void* ys_f, \
                               void* ys_b, int B, int N, int H, int C,       \
                               int R, void* stream) {                        \
    return launch_cluster<TYPE, false>(xg_f, xg_b, w_f, w_b, ys_f, ys_b,     \
                                       nullptr, nullptr, nullptr, nullptr,   \
                                       B, N, H, C, R, 2, 0, stream);         \
  }                                                                          \
  int bilstm_fwd_train_cluster_##SFX(                                        \
      const void* xg_f, const void* xg_b, const void* w_f, const void* w_b,  \
      void* ys_f, void* ys_b, void* cs_f, void* cs_b, void* gs_f,            \
      void* gs_b, int B, int N, int H, int C, int R, void* stream) {         \
    return launch_cluster<TYPE, true>(xg_f, xg_b, w_f, w_b, ys_f, ys_b,      \
                                      cs_f, cs_b, gs_f, gs_b, B, N, H, C, R, \
                                      2, 0, stream);                         \
  }                                                                          \
  int lstm_fwd_cluster_##SFX(const void* xg, const void* w, void* ys, int B, \
                             int N, int H, int C, int R, int reverse,        \
                             void* stream) {                                 \
    return launch_cluster<TYPE, false>(xg, xg, w, w, ys, ys, nullptr,        \
                                       nullptr, nullptr, nullptr, B, N, H,   \
                                       C, R, 1, reverse, stream);            \
  }                                                                          \
  int lstm_fwd_train_cluster_##SFX(const void* xg, const void* w, void* ys,  \
                                   void* cs, void* gs, int B, int N, int H,  \
                                   int C, int R, int reverse,                \
                                   void* stream) {                           \
    return launch_cluster<TYPE, true>(xg, xg, w, w, ys, ys, cs, cs, gs, gs,  \
                                      B, N, H, C, R, 1, reverse, stream);    \
  }

BILSTM_FWD_CLUSTER_ENTRIES(f32, float)
BILSTM_FWD_CLUSTER_ENTRIES(bf16, __nv_bfloat16)
#undef BILSTM_FWD_CLUSTER_ENTRIES

// How many clusters of the cluster kernel (bf16: 0 or 1, save: 0 or 1) at
// H, C and R the current device runs at once; a negative cudaError_t code
// on failure.
int bilstm_fwd_cluster_max_active_clusters(int bf16, int save, int H, int C,
                                           int R) {
  if (!valid_cluster_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? cluster_max_active<__nv_bfloat16, true>(H, C, R)
                : cluster_max_active<__nv_bfloat16, false>(H, C, R);
  return save ? cluster_max_active<float, true>(H, C, R)
              : cluster_max_active<float, false>(H, C, R);
}

// The cluster kernel's dynamic shared memory in bytes at H, C and R, for
// the wrapper's mirror; -1 for a plan it does not take.
int bilstm_fwd_cluster_smem_bytes(int H, int C, int R) {
  if (!valid_cluster_plan(1, 1, H, C, R)) return -1;
  return static_cast<int>(cluster_smem_bytes(H, C, R));
}

// How many blocks of the unit kernel (bf16: 0 or 1, save: 0 or 1) at hidden
// size H and tile R one SM of the current device runs at once; a negative
// cudaError_t code on failure.
int bilstm_fwd_unit_blocks_per_sm(int bf16, int save, int H, int R) {
  if (!valid_unit_plan(H, R)) return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? unit_blocks_per_sm<__nv_bfloat16, true>(H, R)
                : unit_blocks_per_sm<__nv_bfloat16, false>(H, R);
  return save ? unit_blocks_per_sm<float, true>(H, R)
              : unit_blocks_per_sm<float, false>(H, R);
}

// The unit kernel's layout at hidden size H and tile R, for the wrapper's
// mirror: what 0 = static shared memory in bytes, 1 = threads a block, 2 =
// W_hh values a lane holds in registers; -1 for a plan it does not take.
int bilstm_fwd_unit_layout(int what, int H, int R) {
  if (!valid_unit_plan(H, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(unit_smem_bytes(R));
    case 1: return unit_threads(H);
    case 2: return 4 * kKPerLane;
    default: return -1;
  }
}

const char* bilstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
