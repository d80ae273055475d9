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
// Above that, up to H = kMaxClusterH = 256 (an lstm model at d_model 512;
// H=128 is a reference lstm checkpoint at the loader's d_model 256), one
// direction's W_hh (1 MiB in f32 at H=256) fits no block, and a cluster of
// blocks splits it by hidden units: one cluster per (direction, batch tile
// of R rows), the block of rank q owning units q*U .. q*U+U-1 (the last
// block's slice masked past H).
//
// The first cluster design (bilstm_fwd_cluster_kernel, the scheme of
// bigru_fwd.cu's cluster kernel; reached only by a forced plan) holds the
// slice's four gate columns in shared memory as float32 (128 KiB at H=256,
// C=8): thread (u, g) runs the four gate sums of unit u for kRowsPerThread
// rows, pushes its T(h_t) into the double-buffered h tile [H, R] of every
// block by generic distributed-shared-memory stores, and one cluster.sync()
// a step orders the pushes before the next step's reads. What held it back:
// a serial H-deep k loop a step, each k one float4 of h and four scalar
// shared loads of W (about 1,280 dependent shared loads a step at H=256),
// xg loaded one step ahead by scalar loads, scalar stores, and the full
// cluster barrier every step. Measured on an H100: 10.8 us a step at (32,
// 500, 256) f32, 5.6 at the reference request's (1, 3000, 128).
//
// What the register cluster kernel (bilstm_fwd_reg_kernel, the route) does
// about it: the unit kernel's scheme spread over the cluster.
// - W_hh in registers. U = ceil(H / C) units a block, up to a power of two
//   (C up to 16, a non-portable cluster size above 8), L = 8 lanes a unit up
//   to H=128 and 16 above: lane p holds the four gate columns of its unit
//   for the 16 k = (c * L + p) * KC + e, c < 16 / KC, e < KC, as float32
//   rounded from the stream type once (64 registers), for the whole walk.
// - h_{t-1} from a double-buffered [2][TK][R] tile (R = 1, 2 or 4 rows) as
//   16-byte broadcasts, each feeding KC = 4 / R k x R rows x 4 gates FMAs.
//   The L lanes' partial sums meet by __shfl_xor_sync, a reduce-scatter
//   over the rows, then an all-reduce over the rest, so every lane ends
//   with the four gate sums of row p % R and the cell update and c stay in
//   its registers (lanes p < R own the row's outputs).
// - The exchange without a cluster barrier: each warp writes its units'
//   T(h_t) into its own next buffer, sends that region (16 or 8 bytes a
//   piece) into the same buffer of every other block by st.async, whose
//   bytes complete on the receiver's mbarrier, then arrives on its own
//   block's mbarrier. A step waits on that mbarrier only: its own warps'
//   arrivals and the other blocks' bytes. The wait is an acquire at the
//   block's scope; at the cluster's it invalidated L1 every step (a CCTL
//   in the SASS), which the spilled registers then missed.
// - Off the chain, while the bytes travel: xg is loaded two steps ahead by
//   consecutive threads on consecutive units and put into a two-slot ring
//   in shared memory the step before it is used; the outputs (ys, and with
//   kSave c and the four activated gates) go through a three-slot staging
//   area and leave a step later as coalesced stores, issued after the
//   warp's arrival. Every index is a shift and a mask (U is a power of
//   two): these loops run every step, and a division by a runtime U is a
//   few dozen instructions.
// Register budget: 64 W_hh values, 4R accumulators and 4R / L xg values a
// thread; blocks of at most 256 threads (U * L), launch bound two blocks an
// SM, so 128 registers a thread (phase 2 reports the spills, a few dozen
// bytes in some of the tiles). Two blocks an SM: clusters of 16 at one
// block an SM are 7 on an H100, at two 14. An 8-row tile (two 4-row halves
// in turn) spilled up to 200 bytes and took 3.6 us a step at (32, 500,
// 256), against 3.3 for two waves of 4-row tiles (phase 33's sweep): the
// forward takes tiles of 1, 2 or 4 rows.
//
// What bounds it now (chip_smoke.py phase 33 on an H100 at 700 W; PERF.md
// section 6): at (32, 500, 256) f32 the 16 clusters of 4-row tiles make two
// waves at two blocks an SM, each block's step a lane's 256 FMAs, the
// exchange and the fixed chain below (the first design: 10.9 us a step);
// at (1, 3000, 128) about 0.8 us a step (the first design 5.6),
// all of it the step's fixed chain: the wait, a 16-deep FMA chain, three
// shuffle rounds, the activations' MUFU latency, the exchange and the
// arrival. The wrapper picks the kernel (rnn_cuda.lstm_fwd_kernel_route,
// lstm_reg_plan for the cluster and tile) and may force any of the four
// for an A/B.
//
// Above H = 256 (an lstm at d_model 514 to 2048 and beyond, which the JAX
// package runs at any width) no block holds even a 16th of W_hh (4 MiB in
// f32 at H=512). The pipe kernel (bilstm_fwd_pipe.cu, its own source) takes
// those widths up to H = 1816, for #1 / #1t (rnn_pallas.py:390,
// pallas_call :560 / :531) and #3 / #3t (:105, :210 / :183) alike; the
// stream kernel, the first design for them, keeps the widths above and is
// reached below by a forced ("stream", C, R) plan: the first cluster
// kernel with kStream, whose block reads the
// four gate columns of its U = ceil(H / C) units from global memory every
// step instead of holding them in shared memory, so that only the h tile
// [2][H][R] (its rows padded to whole chunks) sits there; clusters of up to
// 16 blocks (non-portable above 8). What bounds it: a block reads its slice,
// 4 H U values, through L2 every step (256 KiB at H=512 in f32, C=16), and
// the grid's blocks together read all of W_hh once per batch tile and
// direction (4 MiB at H=512 in f32, 2 in bf16; the 50 MB L2 keeps it). What
// the design does about it: the loads of the next kStreamK values of k are
// issued a chunk ahead of the FMAs that use them (a step's last chunk loads
// the next step's first), consecutive threads read consecutive units
// (coalesced), the R / 4 row groups of a block read the same addresses
// close together (L1 hits), and the planner (rnn_cuda.stream_plans)
// weighs a block's FMA issue against its and the grid's L2 bytes.
// Measured on an H100 (chip_smoke.py phase 40): 33 us a step at (32, 500,
// 512) f32 on clusters of 16 blocks of 16-row tiles (cuDNN 42), 21 at
// H=320, far above the L2 bytes' time: each chunk's loads wait out the L2
// latency with four warps a block to cover it: the lever the pipe kernel
// took (each block's slice streamed through shared memory by bulk copies,
// the part that fits held, h exchanged by st.async on mbarriers).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

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
// The stream kernel (the cluster kernel with kStream): k values of W_hh a
// thread has in flight ahead of its sums, and clusters of up to 16 blocks
// (a non-portable size above 8)
constexpr int kStreamK = 8;
constexpr int kStreamMaxC = 16;

__host__ __device__ __forceinline__ size_t pad4(size_t n) {
  return (n + 3) / 4 * 4;
}

// n rounded up to a multiple of kStreamK: the rows of the stream kernel's
// exchange tile (the rows past n stay zero, so every chunk is whole)
__host__ __device__ __forceinline__ int pad_stream(int n) {
  return (n + kStreamK - 1) / kStreamK * kStreamK;
}

// The cluster kernel (H above the wide kernel's, see the notes at the top):
// W_hh split by hidden units across a thread-block cluster. kStream: the
// stream kernel, which reads its slice of W_hh from global memory (through
// L2) every step instead of holding it in shared memory.
template <typename T, bool kSave, bool kStream>
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
  const int HT = kStream ? pad_stream(H) : H;   // rows of an h buffer
  float* w_s = smem;                                         // [H][4U]
  // [2][HT][R]; the stream kernel holds no W_hh slice
  float* h_s = kStream ? smem : smem + pad4(static_cast<size_t>(H) * 4 * U);

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
  if constexpr (!kStream)
    for (int idx = threadIdx.x; idx < H * 4 * U; idx += blockDim.x) {
      const int k = idx / (4 * U);
      const int c = idx - k * 4 * U;
      const int gate = c / U;
      const int unit = rank * U + (c - gate * U);
      w_s[idx] = unit < H ? to_f32<T>(w[static_cast<size_t>(k) * G +
                                        gate * H + unit])
                          : 0.0f;
    }
  // h_{-1} = 0; the stream kernel also zeroes both buffers' rows past H
  for (int idx = threadIdx.x; idx < (kStream ? 2 * HT : H) * R;
       idx += blockDim.x)
    h_s[idx] = 0.0f;

  // the stream kernel: the four gate columns of unit gu for the next
  // kStreamK values of k, as loaded (zero past H); a step's last chunk
  // loads the next step's first
  const T* wu = w + (unit_ok ? gu : 0);
  T wn[kStreamK][4];
  auto load_w = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kStreamK; ++e) {
      const int k = k0 + e;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wn[e][g] = k < H ? wu[static_cast<size_t>(k) * G + g * H]
                         : from_f32<T>(0.0f);
    }
  };
  if constexpr (kStream) load_w(0);

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

    const float* hb = h_s + (s & 1) * HT * R + r0;
    if constexpr (kStream) {
      for (int k0 = 0; k0 < H; k0 += kStreamK) {
        float wc[kStreamK][4];
#pragma unroll
        for (int e = 0; e < kStreamK; ++e)
#pragma unroll
          for (int g = 0; g < 4; ++g) wc[e][g] = to_f32<T>(wn[e][g]);
        load_w(k0 + kStreamK < H ? k0 + kStreamK : 0);
#pragma unroll
        for (int e = 0; e < kStreamK; ++e) {
          const float4 hv =
              *reinterpret_cast<const float4*>(hb + (k0 + e) * R);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][0] = fmaf(hv.x, wc[e][g], acc[g][0]);
            acc[g][1] = fmaf(hv.y, wc[e][g], acc[g][1]);
            acc[g][2] = fmaf(hv.z, wc[e][g], acc[g][2]);
            acc[g][3] = fmaf(hv.w, wc[e][g], acc[g][3]);
          }
        }
      }
    } else {
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
      float* slot = h_s + ((s + 1) & 1) * HT * R + gu * R + r0;
      const float4 hv = make_float4(hq[0], hq[1], hq[2], hq[3]);
      for (int q = 0; q < C; ++q)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(slot, q)) = hv;
    }
    cluster.sync();
  }
}

// ---------------------------------------------------------------------------
// The register cluster kernel (bilstm_fwd_reg_kernel; see the notes at the
// top): W_hh split by hidden units across a cluster of C blocks and held in
// registers, h exchanged by st.async on mbarriers.
// ---------------------------------------------------------------------------

constexpr int kRegKPerLane = 16;     // k values of the sum a lane holds
constexpr int kRegMaxThreads = 256;  // __launch_bounds__, two blocks an SM
constexpr int kRegStages = 3;        // output staging slots (steps)
constexpr int kRegMaxC = 16;         // a non-portable cluster of 16 at most
constexpr int kRegStreams = 6;       // staged outputs: ys, then c, i, f, g, o
constexpr int kMaxSmem = 232448;     // dynamic shared memory of one block

// lanes a hidden unit: 8 up to H = 128 (16 k a lane), 16 above
__host__ __device__ __forceinline__ int reg_lanes(int H) {
  return H <= 8 * kRegKPerLane ? 8 : 16;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// units a block owns: ceil(H / C) up to a power of two, at least a warp's
// worth (32 / L); the last block's slice is masked past H
__host__ __device__ __forceinline__ int reg_units(int H, int C) {
  const int u = pow2_at_least((H + C - 1) / C);
  const int w = 32 / reg_lanes(H);
  return u < w ? w : u;
}

// rows of the h tile: every unit of the cluster and every k a lane reads
__host__ __device__ __forceinline__ int reg_tile_k(int H, int C) {
  const int a = C * reg_units(H, C);
  const int b = kRegKPerLane * reg_lanes(H);
  return ((a > b ? a : b) + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int reg_threads(int H, int C) {
  return reg_units(H, C) * reg_lanes(H);
}

// floats of dynamic shared memory: the h tile [2][TK][R], the xg
// ring [2][R][4][U + 1] and the output staging [3][6][R][U + 1]
__host__ __device__ __forceinline__ size_t reg_smem_floats(int H, int C,
                                                           int R) {
  const size_t up = static_cast<size_t>(reg_units(H, C)) + 1;
  return 2 * static_cast<size_t>(R) * reg_tile_k(H, C) +
         (2 * 4 + kRegStages * kRegStreams) * static_cast<size_t>(R) * up;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of shared::cta address `addr` in block `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one warp's arrival on its block's mbarrier (release: the warp's shared
// memory writes before it are seen by every thread the phase releases)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// the same, and `bytes` more to land in the phase from the other blocks
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity`, an acquire at the block's scope: the
// bytes the other blocks sent complete on this block's mbarrier, so no
// cluster-scope acquire (which invalidates L1 every step) is needed. A wait
// that outlasts kWaitTries polls (seconds: a lost exchange, never a slow
// one) traps, so a fault ends the launch with an error instead of hanging
// the card.
constexpr uint32_t kWaitTries = 1u << 24;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kWaitTries) __trap();
  }
}

// 16 or 8 bytes of shared memory at `src` into shared::cluster address
// `dst` of a block of the cluster, completed on that block's mbarrier `bar`
__device__ __forceinline__ void send16(uint32_t dst, uint32_t src,
                                       uint32_t bar) {
  uint32_t a, b, c, d;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
               : "r"(src)
               : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void send8(uint32_t dst, uint32_t src,
                                      uint32_t bar) {
  uint32_t a, b;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(a), "=r"(b)
               : "r"(src)
               : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "r"(a), "r"(b), "r"(bar)
      : "memory");
}

// v rounded to the stream type, as a float (exact for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// The L lanes of a unit each hold partial sums v[g][r] of the four gates
// for the R rows of the tile; afterwards every lane p holds in out[g] the
// full sums of row p % R: a reduce-scatter over the lane bits below R,
// then an all-reduce over the bits from R up to L.
template <int R>
__device__ __forceinline__ void reduce_rows(const float (&v)[4][R],
                                            float (&out)[4], int p, int L) {
  const bool b0 = (p & 1) != 0;
  const bool b1 = (p & 2) != 0;
  if constexpr (R == 4) {
    float half[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float keep = b0 ? v[g][2 * j + 1] : v[g][2 * j];
        const float send = b0 ? v[g][2 * j] : v[g][2 * j + 1];
        half[g][j] = keep + __shfl_xor_sync(kFullMask, send, 1);
      }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float keep = b1 ? half[g][1] : half[g][0];
      const float send = b1 ? half[g][0] : half[g][1];
      out[g] = keep + __shfl_xor_sync(kFullMask, send, 2);
    }
  } else if constexpr (R == 2) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float keep = b0 ? v[g][1] : v[g][0];
      const float send = b0 ? v[g][0] : v[g][1];
      out[g] = keep + __shfl_xor_sync(kFullMask, send, 1);
    }
  } else {
    static_assert(R == 1, "tiles of 1, 2 or 4 rows");
#pragma unroll
    for (int g = 0; g < 4; ++g) out[g] = v[g][0];
  }
  for (int m = R; m < L; m <<= 1)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      out[g] += __shfl_xor_sync(kFullMask, out[g], m);
}

// One cluster per (direction, batch tile of R rows); see the notes at the
// top. Block `rank` owns units rank * U .. rank * U + U - 1, L lanes each.
template <typename T, bool kSave, int R>
__global__ void __launch_bounds__(kRegMaxThreads, 2)
bilstm_fwd_reg_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                      const T* __restrict__ w_f, const T* __restrict__ w_b,
                      T* __restrict__ ys_f, T* __restrict__ ys_b,
                      T* __restrict__ cs_f, T* __restrict__ cs_b,
                      T* __restrict__ gs_f, T* __restrict__ gs_b, int B,
                      int N, int H, int rev) {
  constexpr int KC = 4 / R;               // k values of one float4 read
  constexpr int kChunks = kRegKPerLane / KC;
  constexpr int NX = (4 * R + 7) / 8;     // xg values a thread loads a step
  constexpr int NQ = kSave ? kRegStreams : 1;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 reg_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = reg_lanes(H);
  const int U = reg_units(H, C);
  const int lgU = __ffs(U) - 1;    // U is a power of two: shifts, no divides
  const int UP = U + 1;
  const int TK = reg_tile_k(H, C);
  const int G = 4 * H;
  const int threads = static_cast<int>(blockDim.x);
  float* tile = reinterpret_cast<float*>(reg_smem);   // [2][TK][R]
  float* ring = tile + 2 * R * TK;                    // [2][R][4][UP]
  float* stage = ring + 2 * 4 * R * UP;               // [3][6][R][UP]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = static_cast<int>(threadIdx.x) % L;   // lane of the unit
  const int ul = static_cast<int>(threadIdx.x) / L;  // unit in the block
  const int unit = rank * U + ul;                    // ... in the layer
  const bool unit_ok = unit < H;
  const int row0 = (blockIdx.x / C) * R;

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  T* ys = bwd ? ys_b : ys_f;
  T* cs = bwd ? cs_b : cs_f;
  T* gs = bwd ? gs_b : gs_f;
  auto t_of = [&](int s) { return bwd ? N - 1 - s : s; };

  // this lane's W_hh values: chunk c covers k = (c * L + p) * KC + e, e <
  // KC, for the four gate columns of the unit; zero past H
  float wr[4][kRegKPerLane];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const int k = (c * L + p) * KC + e;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wr[g][c * KC + e] =
            unit_ok && k < H
                ? to_f32<T>(w[static_cast<size_t>(k) * G + g * H + unit])
                : 0.0f;
    }
  for (int i = threadIdx.x; i < 2 * R * TK; i += threads) tile[i] = 0.0f;

  // xg of a step, element e = (r * 4 + g) * U + u of the block's units
  // (consecutive threads on consecutive units): loaded into registers two
  // steps ahead, put into its ring slot the step before it is used
  const int n_in = 4 * R * U;
  T xr[NX];
  auto load_x = [&](int s) {
    const size_t t = static_cast<size_t>(t_of(s));
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int e = static_cast<int>(threadIdx.x) + j * threads;
      if (e < n_in) {
        const int rg = e >> lgU;
        const int row = row0 + rg / 4, gu = rank * U + (e & (U - 1));
        xr[j] = row < B && gu < H
                    ? xg[(static_cast<size_t>(row) * N + t) * G +
                         (rg % 4) * H + gu]
                    : from_f32<T>(0.0f);
      }
    }
  };
  auto store_x = [&](int s) {
    float* slot = ring + (s & 1) * 4 * R * UP;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int e = static_cast<int>(threadIdx.x) + j * threads;
      if (e < n_in) slot[(e >> lgU) * UP + (e & (U - 1))] = to_f32<T>(xr[j]);
    }
  };
  // the staged outputs of a step, element (q * R + r) * U + u, stored with
  // consecutive threads on consecutive units
  // (at most NF a thread: a block has 8U threads at least)
  constexpr int NF = (NQ * R + 7) / 8;
  auto flush = [&](int s, int slot) {
    const size_t t = static_cast<size_t>(t_of(s));
    const float* st = stage + slot * kRegStreams * R * UP;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int e = static_cast<int>(threadIdx.x) + j * threads;
      if (e >= NQ * R * U) break;
      const int u = e & (U - 1), qr = e >> lgU;
      const int q = qr / R, row = row0 + qr % R, gu = rank * U + u;
      if (row < B && gu < H) {
        const T v = from_f32<T>(st[qr * UP + u]);
        const size_t cell = static_cast<size_t>(row) * N + t;
        if (q == 0)
          ys[cell * H + gu] = v;
        else if (q == 1)
          cs[cell * H + gu] = v;
        else
          gs[cell * G + (q - 2) * H + gu] = v;
      }
    }
  };
  load_x(0);
  store_x(0);
  if (N > 1) load_x(1);

  // full[b] completes when every warp of this block has written its units
  // of h into buffer b (one arrival a warp) and the other blocks' bytes of
  // it have landed: step s reads buffer s & 1 (h_{s-1}; zeros at step 0)
  // and waits for the ((s - 1) / 2)-th phase of full[s & 1]
  __shared__ __align__(8) uint64_t full[2];
  const uint32_t bar = smem_addr(full);
  const int nwarps = threads / 32;
  const uint32_t tile_tx = static_cast<uint32_t>((C - 1) * U * R * 4);
  if (threadIdx.x == 0) {
    mbar_init(bar, nwarps);
    mbar_init(bar + 8, nwarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // every block of the cluster holds its zero tiles, its first xg slot and
  // its mbarriers before any block writes into another's shared memory
  cluster.sync();

  // the warp's units of a buffer: upw units x R rows, contiguous, sent in
  // 16-byte pieces (8 where that is all of it)
  const int upw = 32 / L;
  const int piece = upw * R * 4 >= 16 ? 16 : 8;
  const int lgp = __ffs(upw * R * 4 / piece) - 1;   // log2 of the pieces
  const int orow = p % R;         // the row whose cell this lane updates
  const bool owner = p < R;       // lanes p < R store it
  float c = 0.0f;
  int slot = 0;                   // the step's staging slot, s % kRegStages

  for (int s = 0; s < N; ++s) {
    const int buf = s & 1;
    if (s > 0) mbar_wait(bar + buf * 8, ((s - 1) >> 1) & 1);
    // the step's xg of the lane's cell, read before the product
    const float* xs = ring + buf * 4 * R * UP + orow * 4 * UP + ul;
    const float x4[4] = {xs[0], xs[UP], xs[2 * UP], xs[3 * UP]};

    // the four gate sums of row orow: T(h_{t-1}) . T(W_hh[:, gate cols])
    float acc[4][R];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;
    const float4* hrow =
        reinterpret_cast<const float4*>(tile + buf * TK * R) + p;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const float4 hv = hrow[ch * L];
      const float hk[4] = {hv.x, hv.y, hv.z, hv.w};   // [e][r]
#pragma unroll
      for (int e = 0; e < KC; ++e)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[g][r] = fmaf(hk[e * R + r], wr[g][ch * KC + e], acc[g][r]);
    }
    float gsum[4];
    reduce_rows<R>(acc, gsum, p, L);

    const float ig = fast_sigmoid(gsum[0] + x4[0]);
    const float fg = fast_sigmoid(gsum[1] + x4[1]);
    const float gg = fast_tanh(gsum[2] + x4[2]);
    const float og = fast_sigmoid(gsum[3] + x4[3]);
    c = fg * c + ig * gg;
    const float hq = unit_ok ? round_to<T>(og * fast_tanh(c)) : 0.0f;
    const int nb = buf ^ 1;
    if (owner) {
      float* st = stage + slot * kRegStreams * R * UP + orow * UP + ul;
      st[0] = hq;
      if (kSave) {
        st[R * UP] = c;
        st[2 * R * UP] = ig;
        st[3 * R * UP] = fg;
        st[4 * R * UP] = gg;
        st[5 * R * UP] = og;
      }
      if (s + 1 < N) tile[(nb * TK + unit) * R + orow] = hq;
    }
    const uint32_t nbar = bar + nb * 8;
    if (s + 1 < N) {
      // the warp's rows of T(h_t) into that buffer of every other block
      __syncwarp();
      const int total = (C - 1) << lgp;
      const uint32_t region =
          smem_addr(tile + (nb * TK + rank * U + warp * upw) * R);
      for (int i = lane; i < total; i += 32) {
        const int q = i >> lgp;
        const int dst = q < rank ? q : q + 1;
        const uint32_t src = region + (i & ((1 << lgp) - 1)) * piece;
        if (piece == 16)
          send16(cluster_addr(src, dst), src, cluster_addr(nbar, dst));
        else
          send8(cluster_addr(src, dst), src, cluster_addr(nbar, dst));
      }
    }
    // the next step's xg (in registers two steps) into its slot
    if (s + 1 < N) store_x(s + 1);
    if (s + 1 < N) {
      // the warp's arrival on this block's own buffer: its h, xg slot and
      // staging writes and its previous staging reads are done
      __syncwarp();
      if (lane == 0) {
        if (warp == 0)
          mbar_arrive_expect(nbar, tile_tx);
        else
          mbar_arrive(nbar);
      }
    }
    // after the arrival, which would wait for them: the global loads and
    // stores, while the bytes travel. The staging slot of step s - 1 is
    // written again at step s + 2, after every warp's next arrival.
    if (s + 2 < N) load_x(s + 2);
    if (s > 0) flush(s - 1, slot == 0 ? kRegStages - 1 : slot - 1);
    slot = slot == kRegStages - 1 ? 0 : slot + 1;
  }
  __syncthreads();
  flush(N - 1, slot == 0 ? kRegStages - 1 : slot - 1);
  // no block exits while another may still write into it
  cluster.sync();
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

// The stream kernel's shared memory (the h tile alone, its rows padded to
// whole chunks of kStreamK) and plan rule: any H, a cluster of 1 to
// kStreamMaxC blocks each owning a unit at least, R a multiple of
// kRowsPerThread, at most kClusterThreads threads and kMaxSmem bytes a
// block (the wrapper's stream_smem_bytes and _stream_rule mirror them, held
// to bilstm_fwd_stream_smem_bytes when the library loads).
size_t stream_smem_bytes(int H, int R) {
  return 2 * static_cast<size_t>(pad_stream(H)) * R * sizeof(float);
}

bool valid_stream_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || C < 1 || C > kStreamMaxC || R <= 0 ||
      R % kRowsPerThread != 0)
    return false;
  const int U = cluster_units(H, C);
  return (C - 1) * U < H && U * (R / kRowsPerThread) <= kClusterThreads &&
         stream_smem_bytes(H, R) <= static_cast<size_t>(kMaxSmem);
}

template <bool kStream>
bool valid_plan_of(int B, int N, int H, int C, int R) {
  return kStream ? valid_stream_plan(B, N, H, C, R)
                 : valid_cluster_plan(B, N, H, C, R);
}

template <bool kStream>
size_t smem_of(int H, int C, int R) {
  return kStream ? stream_smem_bytes(H, R) : cluster_smem_bytes(H, C, R);
}

template <typename T, bool kSave, bool kStream>
std::atomic<int> g_cluster_smem_allowed[kMaxDevices];

// The dynamic shared memory a variant may use (and, for the stream kernel,
// clusters above 8 blocks), set once per device and again only for more.
template <typename T, bool kSave, bool kStream>
cudaError_t allow_cluster_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices &&
      g_cluster_smem_allowed<T, kSave, kStream>[device].load() >= smem)
    return cudaSuccess;
  if constexpr (kStream) {
    err = cudaFuncSetAttribute(bilstm_fwd_cluster_kernel<T, kSave, kStream>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(bilstm_fwd_cluster_kernel<T, kSave, kStream>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_cluster_smem_allowed<T, kSave, kStream>[device].store(smem);
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

template <typename T, bool kSave, bool kStream>
int launch_cluster(const void* xg_f, const void* xg_b, const void* w_f,
                   const void* w_b, void* ys_f, void* ys_b, void* cs_f,
                   void* cs_b, void* gs_f, void* gs_b, int B, int N, int H,
                   int C, int R, int dirs, int rev, void* stream) {
  if (!valid_plan_of<kStream>(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of<kStream>(H, C, R);
  cudaError_t err =
      allow_cluster_smem<T, kSave, kStream>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_cluster_config(&cfg, &attr, B, H, C, R, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bilstm_fwd_cluster_kernel<T, kSave, kStream>,
                           in(xg_f), in(xg_b), in(w_f), in(w_b), out(ys_f),
                           out(ys_b), out(cs_f), out(cs_b), out(gs_f),
                           out(gs_b), B, N, H, R, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSave, bool kStream>
int cluster_max_active(int H, int C, int R) {
  const size_t smem = smem_of<kStream>(H, C, R);
  cudaError_t err =
      allow_cluster_smem<T, kSave, kStream>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_cluster_config(&cfg, &attr, R, H, C, R, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, bilstm_fwd_cluster_kernel<T, kSave, kStream>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, bool kSave>
int unit_blocks_per_sm(int H, int R) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, unit_kernel<T, kSave>(R), unit_threads(H), 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The register cluster kernel's plan rule (the wrapper's _reg_rule and
// reg_smem_bytes("fwd", ...) mirror it, held to bilstm_fwd_reg_layout when
// the library loads): H up to kMaxClusterH, a cluster of up to kRegMaxC
// blocks each owning a unit at least, tiles of 1, 2 or 4 rows, at most
// kRegMaxThreads threads and kMaxSmem bytes a block.
bool valid_reg_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || H > kMaxClusterH || C < 1 ||
      C > kRegMaxC || (R != 1 && R != 2 && R != 4))
    return false;
  return (C - 1) * reg_units(H, C) < H &&
         reg_threads(H, C) <= kRegMaxThreads &&
         reg_smem_floats(H, C, R) * sizeof(float) <= kMaxSmem;
}

template <typename T, bool kSave, int R>
cudaError_t reg_prepare(int smem) {
  static std::atomic<int> allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bilstm_fwd_reg_kernel<T, kSave, R>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bilstm_fwd_reg_kernel<T, kSave, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices) allowed[device].store(smem);
  return err;
}

void make_reg_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                     int tiles, int H, int C, int dirs, size_t smem,
                     void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(C * tiles, dirs, 1);
  cfg->blockDim = dim3(reg_threads(H, C), 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T, bool kSave, int R>
int launch_reg_as(const void* xg_f, const void* xg_b, const void* w_f,
                  const void* w_b, void* ys_f, void* ys_b, void* cs_f,
                  void* cs_b, void* gs_f, void* gs_b, int B, int N, int H,
                  int C, int dirs, int rev, void* stream) {
  const size_t smem = reg_smem_floats(H, C, R) * sizeof(float);
  cudaError_t err = reg_prepare<T, kSave, R>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, (B + R - 1) / R, H, C, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bilstm_fwd_reg_kernel<T, kSave, R>, in(xg_f),
                           in(xg_b), in(w_f), in(w_b), out(ys_f), out(ys_b),
                           out(cs_f), out(cs_b), out(gs_f), out(gs_b), B, N,
                           H, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSave>
int launch_reg(const void* xg_f, const void* xg_b, const void* w_f,
               const void* w_b, void* ys_f, void* ys_b, void* cs_f,
               void* cs_b, void* gs_f, void* gs_b, int B, int N, int H, int C,
               int R, int dirs, int rev, void* stream) {
  if (!valid_reg_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* fn = R == 1   ? launch_reg_as<T, kSave, 1>
             : R == 2 ? launch_reg_as<T, kSave, 2>
                      : launch_reg_as<T, kSave, 4>;
  return fn(xg_f, xg_b, w_f, w_b, ys_f, ys_b, cs_f, cs_b, gs_f, gs_b, B, N, H,
            C, dirs, rev, stream);
}

template <typename T, bool kSave, int R>
int reg_max_active_as(int H, int C) {
  const size_t smem = reg_smem_floats(H, C, R) * sizeof(float);
  cudaError_t err = reg_prepare<T, kSave, R>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, 1, H, C, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, bilstm_fwd_reg_kernel<T, kSave, R>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, bool kSave>
int reg_max_active(int H, int C, int R) {
  return R == 1   ? reg_max_active_as<T, kSave, 1>(H, C)
         : R == 2 ? reg_max_active_as<T, kSave, 2>(H, C)
                  : reg_max_active_as<T, kSave, 4>(H, C);
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
// The stream kernel (KIND stream): the same, with clusters of 1 to 16
// blocks and any H whose plan fits.
#define BILSTM_FWD_CLUSTER_ENTRIES(SFX, TYPE, KIND, STREAM)                   \
  int bilstm_fwd_##KIND##_##SFX(const void* xg_f, const void* xg_b,          \
                                const void* w_f, const void* w_b,            \
                                void* ys_f, void* ys_b, int B, int N, int H, \
                                int C, int R, void* stream) {                \
    return launch_cluster<TYPE, false, STREAM>(                              \
        xg_f, xg_b, w_f, w_b, ys_f, ys_b, nullptr, nullptr, nullptr,         \
        nullptr, B, N, H, C, R, 2, 0, stream);                               \
  }                                                                          \
  int bilstm_fwd_train_##KIND##_##SFX(                                       \
      const void* xg_f, const void* xg_b, const void* w_f, const void* w_b,  \
      void* ys_f, void* ys_b, void* cs_f, void* cs_b, void* gs_f,            \
      void* gs_b, int B, int N, int H, int C, int R, void* stream) {         \
    return launch_cluster<TYPE, true, STREAM>(xg_f, xg_b, w_f, w_b, ys_f,    \
                                              ys_b, cs_f, cs_b, gs_f, gs_b,  \
                                              B, N, H, C, R, 2, 0, stream);  \
  }                                                                          \
  int lstm_fwd_##KIND##_##SFX(const void* xg, const void* w, void* ys,       \
                              int B, int N, int H, int C, int R,             \
                              int reverse, void* stream) {                   \
    return launch_cluster<TYPE, false, STREAM>(                              \
        xg, xg, w, w, ys, ys, nullptr, nullptr, nullptr, nullptr, B, N, H,   \
        C, R, 1, reverse, stream);                                           \
  }                                                                          \
  int lstm_fwd_train_##KIND##_##SFX(const void* xg, const void* w, void* ys, \
                                    void* cs, void* gs, int B, int N, int H, \
                                    int C, int R, int reverse,               \
                                    void* stream) {                          \
    return launch_cluster<TYPE, true, STREAM>(xg, xg, w, w, ys, ys, cs, cs,  \
                                              gs, gs, B, N, H, C, R, 1,      \
                                              reverse, stream);              \
  }

BILSTM_FWD_CLUSTER_ENTRIES(f32, float, cluster, false)
BILSTM_FWD_CLUSTER_ENTRIES(bf16, __nv_bfloat16, cluster, false)
BILSTM_FWD_CLUSTER_ENTRIES(f32, float, stream, true)
BILSTM_FWD_CLUSTER_ENTRIES(bf16, __nv_bfloat16, stream, true)
#undef BILSTM_FWD_CLUSTER_ENTRIES

// The register cluster kernel: arguments and outputs as the cluster
// entries (clusters of C = 1 .. 16 blocks over batch tiles of R = 1, 2 or 4
// rows); H up to 256.
#define BILSTM_FWD_REG_ENTRIES(SFX, TYPE)                                     \
  int bilstm_fwd_reg_##SFX(const void* xg_f, const void* xg_b,               \
                           const void* w_f, const void* w_b, void* ys_f,     \
                           void* ys_b, int B, int N, int H, int C, int R,    \
                           void* stream) {                                   \
    return launch_reg<TYPE, false>(xg_f, xg_b, w_f, w_b, ys_f, ys_b,         \
                                   nullptr, nullptr, nullptr, nullptr, B, N, \
                                   H, C, R, 2, 0, stream);                   \
  }                                                                          \
  int bilstm_fwd_train_reg_##SFX(                                            \
      const void* xg_f, const void* xg_b, const void* w_f, const void* w_b,  \
      void* ys_f, void* ys_b, void* cs_f, void* cs_b, void* gs_f,            \
      void* gs_b, int B, int N, int H, int C, int R, void* stream) {         \
    return launch_reg<TYPE, true>(xg_f, xg_b, w_f, w_b, ys_f, ys_b, cs_f,    \
                                  cs_b, gs_f, gs_b, B, N, H, C, R, 2, 0,     \
                                  stream);                                   \
  }                                                                          \
  int lstm_fwd_reg_##SFX(const void* xg, const void* w, void* ys, int B,     \
                         int N, int H, int C, int R, int reverse,            \
                         void* stream) {                                     \
    return launch_reg<TYPE, false>(xg, xg, w, w, ys, ys, nullptr, nullptr,   \
                                   nullptr, nullptr, B, N, H, C, R, 1,       \
                                   reverse, stream);                         \
  }                                                                          \
  int lstm_fwd_train_reg_##SFX(const void* xg, const void* w, void* ys,      \
                               void* cs, void* gs, int B, int N, int H,      \
                               int C, int R, int reverse, void* stream) {    \
    return launch_reg<TYPE, true>(xg, xg, w, w, ys, ys, cs, cs, gs, gs, B,   \
                                  N, H, C, R, 1, reverse, stream);           \
  }

BILSTM_FWD_REG_ENTRIES(f32, float)
BILSTM_FWD_REG_ENTRIES(bf16, __nv_bfloat16)
#undef BILSTM_FWD_REG_ENTRIES

// How many clusters of the register cluster kernel (bf16: 0 or 1, save: 0
// or 1) at H, C and R the current device runs at once; a negative
// cudaError_t code on failure.
int bilstm_fwd_reg_max_active_clusters(int bf16, int save, int H, int C,
                                       int R) {
  if (!valid_reg_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? reg_max_active<__nv_bfloat16, true>(H, C, R)
                : reg_max_active<__nv_bfloat16, false>(H, C, R);
  return save ? reg_max_active<float, true>(H, C, R)
              : reg_max_active<float, false>(H, C, R);
}

// The register cluster kernel's layout at H, C and R, for the wrapper's
// mirror: what 0 = dynamic shared memory in bytes, 1 = threads a block, 2 =
// units a block; -1 for a plan it does not take.
int bilstm_fwd_reg_layout(int what, int H, int C, int R) {
  if (!valid_reg_plan(1, 1, H, C, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(reg_smem_floats(H, C, R) * sizeof(float));
    case 1: return reg_threads(H, C);
    case 2: return reg_units(H, C);
    default: return -1;
  }
}

// How many clusters of the cluster kernel (bf16: 0 or 1, save: 0 or 1) at
// H, C and R the current device runs at once; a negative cudaError_t code
// on failure.
int bilstm_fwd_cluster_max_active_clusters(int bf16, int save, int H, int C,
                                           int R) {
  if (!valid_cluster_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? cluster_max_active<__nv_bfloat16, true, false>(H, C, R)
                : cluster_max_active<__nv_bfloat16, false, false>(H, C, R);
  return save ? cluster_max_active<float, true, false>(H, C, R)
              : cluster_max_active<float, false, false>(H, C, R);
}

// The cluster kernel's dynamic shared memory in bytes at H, C and R, for
// the wrapper's mirror; -1 for a plan it does not take.
int bilstm_fwd_cluster_smem_bytes(int H, int C, int R) {
  if (!valid_cluster_plan(1, 1, H, C, R)) return -1;
  return static_cast<int>(cluster_smem_bytes(H, C, R));
}

// The same two queries of the stream kernel.
int bilstm_fwd_stream_max_active_clusters(int bf16, int save, int H, int C,
                                          int R) {
  if (!valid_stream_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? cluster_max_active<__nv_bfloat16, true, true>(H, C, R)
                : cluster_max_active<__nv_bfloat16, false, true>(H, C, R);
  return save ? cluster_max_active<float, true, true>(H, C, R)
              : cluster_max_active<float, false, true>(H, C, R);
}

int bilstm_fwd_stream_smem_bytes(int H, int C, int R) {
  if (!valid_stream_plan(1, 1, H, C, R)) return -1;
  return static_cast<int>(stream_smem_bytes(H, R));
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
