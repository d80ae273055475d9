// Fused LSTM recurrence, backward (BPTT), float32 or bfloat16 streams. One
// source, four kernels (the unit kernel at H <= 64, the wide kernel above
// it, the register cluster kernel above that to H = 256, and the first
// cluster design, also as the stream kernel, kept for the A/Bs; the pipe
// kernel, the route above 256, is bilstm_pipe.cu's) and two grids: both
// directions of a BiLSTM layer (bilstm_bwd_*), or one direction of an LSTM
// (lstm_bwd_*, with a reverse flag).
//
// Replaces two TPU kernels: room_slam_tpu/ops/rnn_pallas.py::
// _bilstm_bwd_kernel (:438, pallas_call :606, launched through
// _bilstm_bwd_pallas from _bilstm_core_bwd) with the grid's two directions,
// and _lstm_bwd_chunk_kernel (:242, pallas_call :315, launched through
// _lstm_bwd_pallas from _lstm_core_bwd) with a grid of one direction. From
// the residuals of the training forward (bilstm_fwd.cu, kSave) it walks each
// direction in reverse of its forward order and emits the gate cotangent
// dg [B, N, 4H] per direction, which is also the cotangent of the gate
// stream xg. dW_hh = sum_t h_{t-1}^T dg_t is one matrix product outside the
// kernel, as in the reference.
//
// Per step, with the linearized coefficients of the reference (:459-473)
// computed from the saved activated gates (i, f, g, o), c_t and c_{t-1}
// (c at the walk's next step, zero after its last), and T() the rounding to
// the stream type where the Pallas kernels round (:464-491, :618-620):
//
//   c_c = T(o * (1 - tanh(c)^2))
//   c4  = T([g * i(1-i), c_prev * f(1-f), i * (1-g^2), tanh(c) * o(1-o)])
//   dh_t = dy_t + dh_carry
//   dc_t = dc_carry + dh_t * c_c
//   dg   = [dc_t, dc_t, dc_t, dh_t] * c4            (stored as T)
//   dh_carry = T(dg) @ T(W_hh)^T  (a 4H-deep f32 dot product per unit)
//   dc_carry = dc_t * f                              (f32 carries)
//
// The forward direction walks t = N-1 .. 0; the backward-in-time direction
// (and a single-direction LSTM run with reverse) walks t = 0 .. N-1 and
// takes c_prev from t + 1. All arrays are in original time order.
//
// What bounds it on an H100. At the flagship training shape (B=20,
// N=1500, H=64) it reads 4H + 2H floats and writes 4H floats per (row, step)
// and direction, 154 MB in all (about 46 us at 3.35 TB/s), and does about
// 2 GFLOP (about 30 us at 67 TFLOP/s f32); at the single-direction shape
// (B=32, N=500, H=64) 41 MB (12 us) and 0.54 GFLOP (8 us). The real floor
// is the serial chain of N dependent steps, each a 4H-deep dot product per
// (row, unit), the carries' update and a barrier.
//
// What held the first design back (now the wide kernel below). One block of
// 4H threads per (4-row tile, direction), thread j owning the (row, unit)
// cell (j / H, j % H), W_hh^T (64 KiB at H=64) in dynamic shared memory:
// each thread ran a 256-deep dot product a step as one chain of shared
// loads (two loads, one of W and one of dg, per FMA), so a step took about
// 2.0 us on an H100 (cuDNN 1.75 at the flagship shape), and three of four
// rows padded a single-row batch.
//
// What the design does about it (bilstm_bwd_unit_kernel, H <= kMaxUnitH =
// 64), the BPTT counterpart of bilstm_fwd.cu's unit kernel and the LSTM
// counterpart of bigru_bwd.cu's gru_bwd_unit_kernel. One block per (tile of
// R = 1, 2 or 4 rows, direction); rnn_cuda unit_plans sizes R to the batch
// and the card. Four lanes of a warp own hidden unit u, and lane p holds in
// registers row u of W_hh for its quarter of each gate block's k (dh_carry[u]
// = sum_j dg[j] W_hh[u, j], j = gate * H + k: 16 k values in each of 4 gate
// blocks, 64 floats at H=64). The step's rounded dg sits in shared memory as
// a double-buffered [4][64][R] tile, read as 16-byte broadcasts, each
// feeding 4 k x R rows FMAs: the lane sums its 64 terms of a row in one
// chain, and the four lanes' partials meet by __shfl_xor_sync, so lane p
// holds row p % R's dh_carry and runs that cell's carries and dg, and lanes
// p < R write it to the next tile. One block barrier a step, no cluster.
// The seven inputs of a step (i, f, g, o, c, c_{t-1}, dy) are loaded kAhead
// = 8 steps ahead into a register ring (the step loop unrolled by 8), and
// the coefficients, which need only those residuals, are computed at the
// top of the step while the tile's loads are in flight, so the chain itself
// is dh_t = dy + dh, dc_t, dg, the tile store, the barrier and the dot
// product. c_{t-1} is read through a second pointer into cs, shifted by one
// step, at the same index as c and dy (the second read of each c hits the
// cache), and only after the direction's first step.
//
// Throwaway variants of this source, timed on an H100 against it, were all
// slower: four 16-deep chains (one per gate block; also 40 more registers),
// the coefficients computed after the dot product, the step's stores shared
// among the cell's lanes, and its dg stores moved after the barrier (by far
// the slowest). So the step is bound by the tile's 16 R 16-byte loads a
// lane, not by the FMA chain's depth: the GRU BPTT unit kernel (12 R loads)
// and the forward unit kernel (4 R) take less a step (PERF.md).
//
// H above 64 (no model runs one: the flagship and legacy LSTMs are H=64)
// takes the wide kernel, the first design kept as it was: W_hh^T and a
// double-buffered [4][4H] dg tile in dynamic shared memory, up to H=116 in
// f32.
//
// Above that, up to H = kMaxClusterH = 256 (an lstm model at d_model 512),
// a cluster of blocks splits W_hh by hidden units: one cluster per
// (direction, batch tile of R rows), the block of rank q owning units q*U
// .. q*U+U-1 (the last block's slice masked past H).
//
// The first cluster design (bilstm_bwd_cluster_kernel, the scheme of
// bigru_bwd.cu's cluster kernel, kind kLinear; reached only by a forced
// plan) holds the slice's rows of W_hh as a [4H, U] float32 slice in shared
// memory (128 KiB at H=256, C=8). Thread (u, g) owns unit u of
// kRowsPerThread rows: it reads that cell's i, f, g, o, c, c_{t-1} and dy,
// runs the coefficients, dg and the f32 carries as the wide kernel does,
// and pushes its rounded dg (four gate values a row) into the
// double-buffered [4H, R] dg tile of every block (distributed shared
// memory); one cluster.sync() a step makes the tile whole, and each thread
// takes its 4H-deep dot product from its own shared memory. What held it
// back: that serial 4H-deep chain of shared loads a step, the 4H-wide dg
// exchanged to every block in the stream type, generic remote stores and
// the full cluster barrier every step. Measured on an H100: 14.5 us a step
// at (32, 500, 256) f32, 6.5 at (1, 3000, 128).
//
// What the register cluster kernel (bilstm_bwd_reg_kernel, the route)
// does about it:
// - The forward's slice in registers. Block q holds W_hh[k, j] for every k
//   and its own 4U gate columns j (U = ceil(H / C) up to a power of two, at
//   least 8): thread t holds k0 = 2 (t / JL) and k0 + 1 for 32 of the
//   columns, JL = U / 8 lanes a pair (64 registers, rounded from the stream
//   type once).
// - A K-split. Each step the block's cells (thread t < U R owns unit t / R,
//   row t % R) write their rounded dg into a [R / RQ][U / 8][32 RQ + 4]
//   tile of the block's own columns (the padding keeps the JL lanes' reads
//   on distinct banks), one block barrier, and each thread forms the
//   partial dh of its k pair for every row from that tile (16-byte
//   broadcasts, KC columns x RQ rows x 2 k FMAs each); the JL lanes'
//   partials meet by __shfl_xor_sync. No dg leaves the block.
// - The exchange: each pair's 2R partials go, as float32 by st.async (16 or
//   8 bytes a piece), into slot q of the next buffer of the block owning
//   k0, completing on its mbarrier (this block's own pairs by a store);
//   each warp then arrives on its own block's mbarrier. (C - 1) / C x H x R
//   float32 values a block a step, against (C - 1) / C x 4H x R stream
//   values for the dg exchange: 4x fewer bytes in f32. The receiver's cell
//   sums the C partials of its unit in rank order, so the result is bit-
//   equal from run to run. A step waits on its own mbarrier only; the wait
//   is an acquire at the block's scope (see bilstm_fwd.cu).
// - Off the chain, as the forward: the seven inputs of a cell loaded two
//   steps ahead by consecutive threads on consecutive units into a
//   two-slot ring, dg through a three-slot staging area out as coalesced
//   stores after the warp's arrival, every index a shift and a mask.
// Register budget: 64 W_hh values, 2R accumulators and kRegLoads input
// values a thread (the plan rule keeps 7 U R <= kRegLoads x threads);
// blocks of at most 256 threads, two blocks an SM, 128 registers a thread:
// the 8-row tiles spill up to about 200 bytes (phase 2 reports them).
//
// What bounds it now (chip_smoke.py phase 33 on an H100 at 700 W; PERF.md
// section 6): at (32, 500, 256) f32 about 4.5 us a step (the first design
// 14.7), at 8 rows the FMA issue of two blocks an SM as in the forward; at
// (1, 3000, 128) about 0.95 (the first design 6.5), the step's chain: the
// wait, the C partials' sum, the coefficients, the block barrier, a
// 32-deep FMA chain, the shuffles, the exchange and the arrival. The
// wrapper picks the kernel (rnn_cuda.lstm_bwd_kernel_route, lstm_reg_plan
// for the cluster and tile) and may force any of them for an A/B.
//
// Above H = 256 no block holds its share of W_hh in registers, and at
// H = 512 in f32 no cluster holds all of W_hh in shared memory (4 MiB a
// direction against 16 x 227 KB), so W_hh comes from L2 every step.
//
// The first design for these widths (the stream kernel, reached only by a
// forced ("stream", C, R) plan since the pipe kernel took the route): the
// first cluster kernel with kStream, each thread walking its unit's column
// of W_hh^T [4H, H] (a transposed copy the wrapper makes) from L2 with
// kStreamK values in flight, the dg tile [2][4H][R] exchanged to every
// block and a cluster.sync() a step; up to H = 1816, where the 4H-row dg
// tile fills a block. What held it back (phase 40 on an H100, 104.3 us a
// step at (32, 500, 512) f32, cuDNN 37.4): 256 dependent L2 round trips a
// thread a step with three warps an SM to hide them, a float4 of dg for
// four FMAs, about 92 KB of dg pushed to every block by generic remote
// stores, and the full cluster barrier.
//
// The second design for these widths, the pipe kernel, is bilstm_pipe.cu's
// (see its notes).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;  // wide kernel: batch rows per block, 4H threads

// unit kernel: lanes per hidden unit, W_hh values of the sum held in
// registers (over the four lanes, for each gate block of W_hh's row), and
// the threads of a block at H = kMaxUnitH
constexpr int kLanes = 4;
constexpr int kMaxUnitH = 64;
constexpr int kKPerLane = kMaxUnitH / kLanes;
constexpr int kUnitThreads = kLanes * kMaxUnitH;
constexpr int kAhead = 8;  // steps of inputs in flight ahead of the chain
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

// v rounded to the stream type, as a float (exact for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// The four lanes of a unit each hold partial sums v[r] for R rows;
// afterwards lane p holds the full sum of row p % R (a reduce-scatter over
// lane bits 0 and 1; an all-reduce where R < 4).
template <int R>
__device__ __forceinline__ float reduce_lanes(const float (&v)[R], int lane) {
  const bool b0 = (lane & 1) != 0;
  const bool b1 = (lane & 2) != 0;
  if constexpr (R == 4) {
    float half[2];  // rows 2j + b0, summed over lanes p and p ^ 1
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float keep = b0 ? v[2 * j + 1] : v[2 * j];
      const float send = b0 ? v[2 * j] : v[2 * j + 1];
      half[j] = keep + __shfl_xor_sync(kFullMask, send, 1);
    }
    const float keep = b1 ? half[1] : half[0];
    const float send = b1 ? half[0] : half[1];
    return keep + __shfl_xor_sync(kFullMask, send, 2);
  } else if constexpr (R == 2) {
    const float keep = b0 ? v[1] : v[0];
    const float send = b0 ? v[0] : v[1];
    const float out = keep + __shfl_xor_sync(kFullMask, send, 1);
    return out + __shfl_xor_sync(kFullMask, out, 2);
  } else {
    static_assert(R == 1, "tiles of 1, 2 or 4 rows");
    const float out = v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
    return out + __shfl_xor_sync(kFullMask, out, 2);
  }
}

// The unit kernel: one block per (tile of R rows, direction), four lanes
// per hidden unit, row u of W_hh in registers (see the notes at the top).
template <typename T, int R>
__global__ void __launch_bounds__(kUnitThreads)
bilstm_bwd_unit_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                       const T* __restrict__ gs_f, const T* __restrict__ cs_f,
                       const T* __restrict__ dy_f, const T* __restrict__ gs_b,
                       const T* __restrict__ cs_b, const T* __restrict__ dy_b,
                       T* __restrict__ dg_f, T* __restrict__ dg_b, int B,
                       int N, int H, int rev) {
  constexpr int KC = 4 / R;                  // k values in one float4 of dg
  constexpr int kChunks = kKPerLane / KC;    // float4 loads a gate a step
  // the step's rounded dg as [gate][k][R] floats (j = gate * H + k), double
  // buffered; k >= H stays 0
  __shared__ float4 dg_s[2][4][kMaxUnitH * R / 4];
  const int G = 4 * H;

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const int lane = threadIdx.x % kLanes;
  const int u = threadIdx.x / kLanes;  // hidden unit; u >= H pads the warp
  const bool unit_valid = u < H;
  const int uu = unit_valid ? u : 0;
  const int row0 = blockIdx.x * R;

  // this lane's values of row u of W_hh: chunk c of the lane covers k =
  // (c * kLanes + lane) * KC + e, e < KC, in each gate block g * H + k
  float wr[4][kKPerLane];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const int k = (c * kLanes + lane) * KC + e;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wr[g][c * KC + e] =
            unit_valid && k < H
                ? to_f32<T>(w[static_cast<size_t>(u) * G + g * H + k])
                : 0.0f;
    }
  float* dg_flat = reinterpret_cast<float*>(dg_s);
  for (int i = threadIdx.x; i < 2 * 4 * kMaxUnitH * R; i += blockDim.x)
    dg_flat[i] = 0.0f;

  // the (row, unit) cell this lane updates: row p % R; lanes p < R store it
  const int orow = lane % R;
  const bool cell_valid = unit_valid && row0 + orow < B;
  const bool owner = lane < R && cell_valid;
  const size_t row = static_cast<size_t>(cell_valid ? row0 + orow : 0);
  const size_t goff = row * N * G + uu;   // gates / dg of (row, t = 0, u)
  const size_t coff = row * N * H + uu;   // c, dy of (row, t = 0, u)
  const T* gs = (bwd ? gs_b : gs_f) + goff;
  const T* cs = (bwd ? cs_b : cs_f) + coff;
  const T* dys = (bwd ? dy_b : dy_f) + coff;
  T* dg = (bwd ? dg_b : dg_f) + goff;
  // c at the direction's previous step (t - 1 forward, t + 1 backward),
  // read only after the direction's first step
  const int first = bwd ? N - 1 : 0;
  const T* cps = cs + (bwd ? H : -H);

  // i, f, g, o, c, c_{t-1} and dy of this lane's cell for the next kAhead
  // steps as loaded, converted when used: a ring indexed by the step's place
  // in an unrolled group, so each load has kAhead steps to land
  T in[kAhead][7];
  auto load = [&](T (&dst)[7], int s) {
    const int t = bwd ? s : N - 1 - s;
    const T zero = from_f32<T>(0.0f);
    const T* gt = gs + static_cast<size_t>(t) * G;
    const size_t tc = static_cast<size_t>(t) * H;
    dst[0] = cell_valid ? gt[0] : zero;
    dst[1] = cell_valid ? gt[H] : zero;
    dst[2] = cell_valid ? gt[2 * H] : zero;
    dst[3] = cell_valid ? gt[3 * H] : zero;
    dst[4] = cell_valid ? cs[tc] : zero;
    dst[5] = cell_valid && t != first ? cps[tc] : zero;
    dst[6] = cell_valid ? dys[tc] : zero;
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < N) load(in[j], j);
  float dc = 0.0f;
  __syncthreads();

  auto step = [&](int s, T (&cur)[7]) {
    const int t = bwd ? s : N - 1 - s;
    float v[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) v[i] = to_f32<T>(cur[i]);
    if (s + kAhead < N) load(cur, s + kAhead);

    // the coefficients: this step's residuals only, off the chain
    const float ig = v[0], fg = v[1], gg = v[2], og = v[3];
    const float tanh_c = tanhf(v[4]);
    const float c_c = round_to<T>(og * (1.0f - tanh_c * tanh_c));
    const float c_i = round_to<T>(gg * ig * (1.0f - ig));
    const float c_f = round_to<T>(v[5] * fg * (1.0f - fg));
    const float c_g = round_to<T>(ig * (1.0f - gg * gg));
    const float c_o = round_to<T>(tanh_c * og * (1.0f - og));

    // the previous step's dg . W_hh[u, :] (zero at the first step): the
    // lane's 64 terms a row in one chain, then the four lanes' partials
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 dv = dg_s[s & 1][g][ch * kLanes + lane];
        const float dk[4] = {dv.x, dv.y, dv.z, dv.w};  // [e][r]
#pragma unroll
        for (int e = 0; e < KC; ++e)
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(dk[e * R + r], wr[g][ch * KC + e], acc[r]);
      }
    const float dh_t = v[6] + reduce_lanes<R>(acc, lane);

    const float dc_t = dc + dh_t * c_c;
    const float d_i = dc_t * c_i;
    const float d_f = dc_t * c_f;
    const float d_g = dc_t * c_g;
    const float d_o = dh_t * c_o;
    dc = dc_t * fg;
    if (lane < R && unit_valid) {
      const float d[4] = {d_i, d_f, d_g, d_o};
#pragma unroll
      for (int g = 0; g < 4; ++g)
        reinterpret_cast<float*>(dg_s[(s + 1) & 1][g])[u * R + orow] =
            round_to<T>(d[g]);
    }
    if (owner) {
      T* o = dg + static_cast<size_t>(t) * G;
      o[0] = from_f32<T>(d_i);
      o[H] = from_f32<T>(d_f);
      o[2 * H] = from_f32<T>(d_g);
      o[3 * H] = from_f32<T>(d_o);
    }
    __syncthreads();
  };
  for (int s0 = 0; s0 < N; s0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (s0 + j < N) step(s0 + j, in[j]);
  }
}

// One step's inputs as loaded, in the stream type. A bf16 step is widened
// at the top of the step that uses it, so no conversion waits on a load in
// flight; a float32 step is copied whole. Both shapes were timed on an H100
// against the alternatives (PERF.md): widening bf16 as it loads, and
// widening float32 through a helper or holding it the bf16 way, were
// slower.
template <typename T>
struct StepIn {
  T i, f, g, o, c, cp, dy;
};

// The wide kernel (H > kMaxUnitH): W_hh^T in dynamic shared memory, thread
// j owns the (row, unit) cell (j / H, j % H) of a kRows-row tile.
template <typename T>
__global__ void __launch_bounds__(512)
bilstm_bwd_wide_kernel(const T* __restrict__ w_f,
                       const T* __restrict__ w_b,
                       const T* __restrict__ gs_f,
                       const T* __restrict__ cs_f,
                       const T* __restrict__ dy_f,
                       const T* __restrict__ gs_b,
                       const T* __restrict__ cs_b,
                       const T* __restrict__ dy_b,
                       T* __restrict__ dg_f,
                       T* __restrict__ dg_b,
                       int B, int N, int H, int rev) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* wt_s = smem;            // [4H, H]  this direction's W_hh^T
  float* dg_s = wt_s + G * H;    // [2][kRows, 4H]  dg, double-buffered

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;

  for (int idx = j; idx < H * G; idx += G) {
    const int k = idx / G;
    wt_s[(idx - k * G) * H + k] = to_f32<T>(w[idx]);
  }

  const int cb = j / H;
  const int cu = j - cb * H;
  const bool valid = row0 + cb < B;
  const size_t row = static_cast<size_t>(valid ? row0 + cb : 0);
  const size_t goff = row * N * G + cu;   // gates / dg of this cell at t = 0
  const size_t coff = row * N * H + cu;   // c, dy of this cell
  const T* gs = (bwd ? gs_b : gs_f) + goff;
  const T* cs = (bwd ? cs_b : cs_f) + coff;
  const T* dy = (bwd ? dy_b : dy_f) + coff;
  T* dg = (bwd ? dg_b : dg_f) + goff;

  // c at the direction's previous step (t - 1 forward, t + 1 backward),
  // read only after the direction's first step
  const int first = bwd ? N - 1 : 0;
  const T* cps = cs + (bwd ? H : -H);
  auto load = [&](int t) {
    StepIn<T> in{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const T* gt = gs + static_cast<size_t>(t) * G;
      const size_t tc = static_cast<size_t>(t) * H;
      in.i = gt[0];
      in.f = gt[H];
      in.g = gt[2 * H];
      in.o = gt[3 * H];
      in.c = cs[tc];
      if (t != first) in.cp = cps[tc];
      in.dy = dy[tc];
    }
    return in;
  };

  float dh = 0.0f;
  float dc = 0.0f;
  StepIn<T> nxt = load(bwd ? 0 : N - 1);
  __syncthreads();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? s : N - 1 - s;
    StepIn<float> cur;
    if constexpr (std::is_same<T, float>::value) {
      cur = nxt;
    } else {
      cur = {to_f32<T>(nxt.i), to_f32<T>(nxt.f), to_f32<T>(nxt.g),
             to_f32<T>(nxt.o), to_f32<T>(nxt.c), to_f32<T>(nxt.cp),
             to_f32<T>(nxt.dy)};
    }
    if (s + 1 < N) nxt = load(bwd ? t + 1 : t - 1);

    const float ci = cur.i, cf = cur.f;
    const float cg = cur.g, co = cur.o;
    const float cc = cur.c, ccp = cur.cp;
    const float tanh_c = tanhf(cc);
    const float dh_t = cur.dy + dh;
    const float dc_t =
        dc + dh_t * round_to<T>(co * (1.0f - tanh_c * tanh_c));
    const float d_i = dc_t * round_to<T>(cg * ci * (1.0f - ci));
    const float d_f = dc_t * round_to<T>(ccp * cf * (1.0f - cf));
    const float d_g = dc_t * round_to<T>(ci * (1.0f - cg * cg));
    const float d_o = dh_t * round_to<T>(tanh_c * co * (1.0f - co));
    dc = dc_t * cf;

    float* buf = dg_s + (s & 1) * (kRows * G) + cb * G;
    buf[cu] = round_to<T>(d_i);
    buf[H + cu] = round_to<T>(d_f);
    buf[2 * H + cu] = round_to<T>(d_g);
    buf[3 * H + cu] = round_to<T>(d_o);
    if (valid) {
      T* out = dg + static_cast<size_t>(t) * G;
      out[0] = from_f32<T>(d_i);
      out[H] = from_f32<T>(d_f);
      out[2 * H] = from_f32<T>(d_g);
      out[3 * H] = from_f32<T>(d_o);
    }
    __syncthreads();

    // dh_carry = dg_row . W_hh^T[:, cu]; four partial sums for ILP
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int q = 0; q < G; q += 4) {
      a0 = fmaf(buf[q], wt_s[q * H + cu], a0);
      a1 = fmaf(buf[q + 1], wt_s[(q + 1) * H + cu], a1);
      a2 = fmaf(buf[q + 2], wt_s[(q + 2) * H + cu], a2);
      a3 = fmaf(buf[q + 3], wt_s[(q + 3) * H + cu], a3);
    }
    dh = (a0 + a1) + (a2 + a3);
  }
}

// The cluster kernel: clusters of C blocks, kRowsPerThread rows a thread
constexpr int kRowsPerThread = 4;
constexpr int kClusterThreads = 512;   // __launch_bounds__
constexpr int kMaxClusterH = 256;
// The stream kernel (the cluster kernel with kStream): j values of W_hh^T a
// thread has in flight ahead of its sums (even: the sums alternate), and
// clusters of up to 16 blocks (a non-portable size above 8)
constexpr int kStreamK = 8;
constexpr int kStreamMaxC = 16;
static_assert(kStreamK % 2 == 0, "two partial sums a row");

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
// stream kernel, which reads its rows of W_hh from global memory (through
// L2) every step instead of holding them in shared memory, from W_hh^T
// [4H, H] (the wrapper's transposed copy) so that consecutive threads read
// consecutive units.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kClusterThreads)
bilstm_bwd_cluster_kernel(const T* __restrict__ w_f,
                          const T* __restrict__ w_b,
                          const T* __restrict__ gs_f,
                          const T* __restrict__ cs_f,
                          const T* __restrict__ dy_f,
                          const T* __restrict__ gs_b,
                          const T* __restrict__ cs_b,
                          const T* __restrict__ dy_b, T* __restrict__ dg_f,
                          T* __restrict__ dg_b, int B, int N, int H, int R,
                          int rev) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = (H + C - 1) / C;   // units a block owns (the last: fewer)
  const int G = 4 * H;
  const int GT = kStream ? pad_stream(G) : G;   // rows of a dg buffer
  float* wt_s = smem;                                     // [4H][U]
  // [2][GT][R]; the stream kernel holds no W_hh slice
  float* dg_s = kStream ? smem : smem + pad4(static_cast<size_t>(G) * U);

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const int u = threadIdx.x % U;
  const int r0 = (threadIdx.x / U) * kRowsPerThread;
  const int gu = rank * U + u;
  const bool unit_ok = gu < H;   // else masked
  const int row0 = (blockIdx.x / C) * R + r0;

  // rows rank*U .. rank*U+U-1 of W_hh, transposed (zero past H):
  // consecutive threads read consecutive columns of one row
  if constexpr (!kStream)
    for (int idx = threadIdx.x; idx < U * G; idx += blockDim.x) {
      const int uu = idx / G;
      const int j = idx - uu * G;
      const int unit = rank * U + uu;
      wt_s[j * U + uu] =
          unit < H ? to_f32<T>(w[static_cast<size_t>(unit) * G + j]) : 0.0f;
    }
  // the stream kernel: both buffers' rows past 4H stay zero
  if constexpr (kStream)
    for (int idx = threadIdx.x; idx < 2 * GT * R; idx += blockDim.x)
      dg_s[idx] = 0.0f;

  // the stream kernel: W_hh[gu, j] (w is W_hh^T) for the next kStreamK
  // values of j, as loaded (zero past 4H); a step's last chunk loads the
  // next step's first
  const T* wu = w + (unit_ok ? gu : 0);
  T wn[kStreamK];
  auto load_w = [&](int j0) {
#pragma unroll
    for (int e = 0; e < kStreamK; ++e)
      wn[e] = j0 + e < G ? wu[static_cast<size_t>(j0 + e) * H]
                         : from_f32<T>(0.0f);
  };
  if constexpr (kStream) load_w(0);

  bool valid[kRowsPerThread];
  size_t goff[kRowsPerThread];  // gates / dg of (row, t = 0, unit gu)
  size_t coff[kRowsPerThread];  // c, dy of (row, t = 0, unit gu)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    valid[i] = unit_ok && row0 + i < B;
    const size_t row = static_cast<size_t>(valid[i] ? row0 + i : 0);
    goff[i] = row * N * G + (unit_ok ? gu : 0);
    coff[i] = row * N * H + (unit_ok ? gu : 0);
  }
  const T* gs = bwd ? gs_b : gs_f;
  const T* cs = bwd ? cs_b : cs_f;
  const T* dys = bwd ? dy_b : dy_f;
  T* dg = bwd ? dg_b : dg_f;
  // c at the direction's previous step (t - 1 forward, t + 1 backward),
  // read only after the direction's first step
  const int first = bwd ? N - 1 : 0;
  const T* cps = cs + (bwd ? H : -H);

  StepIn<T> nxt[kRowsPerThread];
  auto load = [&](int t) {
    const T zero = from_f32<T>(0.0f);
    const size_t tg = static_cast<size_t>(t) * G;
    const size_t tc = static_cast<size_t>(t) * H;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      StepIn<T> in{zero, zero, zero, zero, zero, zero, zero};
      if (valid[i]) {
        const T* gt = gs + goff[i] + tg;
        in.i = gt[0];
        in.f = gt[H];
        in.g = gt[2 * H];
        in.o = gt[3 * H];
        in.c = cs[coff[i] + tc];
        if (t != first) in.cp = cps[coff[i] + tc];
        in.dy = dys[coff[i] + tc];
      }
      nxt[i] = in;
    }
  };
  load(bwd ? 0 : N - 1);
  float dh[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dc[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};

  // every block of the cluster runs and holds its W_hh^T slice before any
  // block writes into another's shared memory
  cluster.sync();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? s : N - 1 - s;
    StepIn<T> cur[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) cur[i] = nxt[i];
    if (s + 1 < N) load(bwd ? t + 1 : t - 1);

    float d4[4][kRowsPerThread];   // the rounded dg of the rows, by gate
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float ci = to_f32<T>(cur[i].i), cf = to_f32<T>(cur[i].f);
      const float cg_ = to_f32<T>(cur[i].g), co = to_f32<T>(cur[i].o);
      const float cc = to_f32<T>(cur[i].c), ccp = to_f32<T>(cur[i].cp);
      const float tanh_c = tanhf(cc);
      const float dh_t = to_f32<T>(cur[i].dy) + dh[i];
      const float dc_t =
          dc[i] + dh_t * round_to<T>(co * (1.0f - tanh_c * tanh_c));
      const float d_i = dc_t * round_to<T>(cg_ * ci * (1.0f - ci));
      const float d_f = dc_t * round_to<T>(ccp * cf * (1.0f - cf));
      const float d_g = dc_t * round_to<T>(ci * (1.0f - cg_ * cg_));
      const float d_o = dh_t * round_to<T>(tanh_c * co * (1.0f - co));
      dc[i] = dc_t * cf;
      if (valid[i]) {
        T* o = dg + goff[i] + static_cast<size_t>(t) * G;
        o[0] = from_f32<T>(d_i);
        o[H] = from_f32<T>(d_f);
        o[2 * H] = from_f32<T>(d_g);
        o[3 * H] = from_f32<T>(d_o);
      }
      d4[0][i] = round_to<T>(d_i);
      d4[1][i] = round_to<T>(d_f);
      d4[2][i] = round_to<T>(d_g);
      d4[3][i] = round_to<T>(d_o);
    }

    // push this thread's dg into every block's tile
    float* slot = dg_s + (s & 1) * GT * R;
    if (unit_ok) {
      float* mine = slot + gu * R + r0;
      for (int q = 0; q < C; ++q) {
        float* dst = cluster.map_shared_rank(mine, q);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<float4*>(dst + g * H * R) =
              make_float4(d4[g][0], d4[g][1], d4[g][2], d4[g][3]);
      }
    }
    cluster.sync();

    // dh_carry = dg . W_hh[unit, :]; two partial sums a row (4H is even)
    const float* dgb = slot + r0;
    float a0[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    float a1[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (kStream) {
      for (int j0 = 0; j0 < G; j0 += kStreamK) {
        float wc[kStreamK];
#pragma unroll
        for (int e = 0; e < kStreamK; ++e) wc[e] = to_f32<T>(wn[e]);
        load_w(j0 + kStreamK < G ? j0 + kStreamK : 0);
#pragma unroll
        for (int e = 0; e < kStreamK; e += 2) {
          const float4 d0 =
              *reinterpret_cast<const float4*>(dgb + (j0 + e) * R);
          const float4 d1 =
              *reinterpret_cast<const float4*>(dgb + (j0 + e + 1) * R);
          a0[0] = fmaf(d0.x, wc[e], a0[0]);
          a0[1] = fmaf(d0.y, wc[e], a0[1]);
          a0[2] = fmaf(d0.z, wc[e], a0[2]);
          a0[3] = fmaf(d0.w, wc[e], a0[3]);
          a1[0] = fmaf(d1.x, wc[e + 1], a1[0]);
          a1[1] = fmaf(d1.y, wc[e + 1], a1[1]);
          a1[2] = fmaf(d1.z, wc[e + 1], a1[2]);
          a1[3] = fmaf(d1.w, wc[e + 1], a1[3]);
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < G; j += 2) {
        const float4 d0 = *reinterpret_cast<const float4*>(dgb + j * R);
        const float4 d1 =
            *reinterpret_cast<const float4*>(dgb + (j + 1) * R);
        const float w0 = wt_s[j * U + u];
        const float w1 = wt_s[(j + 1) * U + u];
        a0[0] = fmaf(d0.x, w0, a0[0]);
        a0[1] = fmaf(d0.y, w0, a0[1]);
        a0[2] = fmaf(d0.z, w0, a0[2]);
        a0[3] = fmaf(d0.w, w0, a0[3]);
        a1[0] = fmaf(d1.x, w1, a1[0]);
        a1[1] = fmaf(d1.y, w1, a1[1]);
        a1[2] = fmaf(d1.z, w1, a1[2]);
        a1[3] = fmaf(d1.w, w1, a1[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) dh[i] = a0[i] + a1[i];
  }
}

// ---------------------------------------------------------------------------
// The register cluster kernel (bilstm_bwd_reg_kernel; see the notes at the
// top): block `rank` holds the four gate columns of its U units of W_hh in
// registers, forms the partial dh_carry of every unit from its own dg (a
// K-split) and sends each block the partials of that block's units.
// ---------------------------------------------------------------------------

constexpr int kRegJPerLane = 32;     // gate columns of the sum a lane holds
constexpr int kRegMaxThreads = 256;  // __launch_bounds__, two blocks an SM
constexpr int kRegLoads = 4;         // input values a thread loads a step
constexpr int kRegStages = 3;        // output staging slots (steps)
constexpr int kRegMaxC = 16;         // a non-portable cluster of 16 at most
constexpr int kRegIn = 7;            // staged inputs: i, f, g, o, c, c_prev, dy
constexpr int kMaxSmem = 232448;     // dynamic shared memory of one block

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// units a block owns: ceil(H / C) up to a power of two, at least 8 (a
// lane's 32 columns); the last block's slice is masked past H
__host__ __device__ __forceinline__ int reg_units(int H, int C) {
  const int u = pow2_at_least((H + C - 1) / C);
  return u < 8 ? 8 : u;
}

// threads: JL = U / 8 lanes for each pair of k (of ceil(H / 2)), whole warps
__host__ __device__ __forceinline__ int reg_threads(int H, int C) {
  return ((H + 1) / 2 * (reg_units(H, C) / 8) + 31) / 32 * 32;
}

// floats of a 32-column group of one quad of the dg tile (4 padding floats
// keep the JL lanes' 16-byte reads on distinct banks)
__host__ __device__ __forceinline__ int reg_group(int RQ) {
  return kRegJPerLane * RQ + 4;
}

// floats of dynamic shared memory: the dg tile [R / RQ][U / 8][group], the
// partials [2][C][U][R], the input ring [2][R][7][U + 1] and the output
// staging [3][4][R][U + 1]
__host__ __device__ __forceinline__ size_t reg_smem_floats(int H, int C,
                                                           int R) {
  const int RQ = R < 4 ? R : 4;
  const size_t U = static_cast<size_t>(reg_units(H, C));
  return (R / RQ) * (U / 8) * reg_group(RQ) + 2 * C * U * R +
         (2 * kRegIn + kRegStages * 4) * R * (U + 1);
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

// four or two floats into shared::cluster address `dst` of another block
// of the cluster, completed on that block's mbarrier `bar`
__device__ __forceinline__ void st_async16(uint32_t dst, float a, float b,
                                           float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async8(uint32_t dst, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(bar)
      : "memory");
}

// One cluster per (direction, batch tile of R rows); see the notes at the
// top. Thread t holds W_hh[k0 + i, column of jl * 32 + jj] (i < 2, jj < 32)
// of the block's 4U gate columns, k0 = 2 * (t / JL), jl = t % JL, JL = U / 8;
// thread t < U * R also owns the cell (unit t / R, row t % R) of the block.
template <typename T, int R>
__global__ void __launch_bounds__(kRegMaxThreads, 2)
bilstm_bwd_reg_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                      const T* __restrict__ gs_f, const T* __restrict__ cs_f,
                      const T* __restrict__ dy_f, const T* __restrict__ gs_b,
                      const T* __restrict__ cs_b, const T* __restrict__ dy_b,
                      T* __restrict__ dg_f, T* __restrict__ dg_b, int B,
                      int N, int H, int rev) {
  constexpr int RQ = R < 4 ? R : 4;       // rows of one float4 read
  constexpr int kQuads = R / RQ;
  constexpr int KC = 4 / RQ;              // columns of one float4 read
  constexpr int kChunks = kRegJPerLane / KC;
  constexpr int GP = kRegJPerLane * RQ + 4;
  constexpr int kPieces = R >= 2 ? R / 2 : 1;   // of 16 (R = 1: 8) bytes
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 reg_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = reg_units(H, C);
  const int lgU = __ffs(U) - 1;    // U is a power of two: shifts, no divides
  const int UP = U + 1;
  const int JL = U / 8;
  const int KG = (H + 1) / 2;                    // pairs of k
  const int G = 4 * H;
  const int threads = static_cast<int>(blockDim.x);
  float* dgt = reinterpret_cast<float*>(reg_smem);   // [kQuads][U / 8][GP]
  float* part = dgt + kQuads * (U / 8) * GP;         // [2][C][U][R]
  float* ring = part + 2 * C * U * R;                // [2][R][7][UP]
  float* stage = ring + 2 * kRegIn * R * UP;         // [3][4][R][UP]
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int jl = tid % JL;
  const int kg = tid / JL;
  const int k0 = 2 * kg;
  const int row0 = (blockIdx.x / C) * R;

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const T* gs = bwd ? gs_b : gs_f;
  const T* cs = bwd ? cs_b : cs_f;
  const T* dys = bwd ? dy_b : dy_f;
  T* dg = bwd ? dg_b : dg_f;
  // the walk: t = N-1 .. 0 for the forward direction; c_prev is c at the
  // direction's previous step (t - 1 forward, t + 1 backward), zero at its
  // first
  auto t_of = [&](int s) { return bwd ? s : N - 1 - s; };
  const int first = bwd ? N - 1 : 0;
  const int dprev = bwd ? 1 : -1;

  // this thread's W_hh values: column jb = jl * 32 + jj of the block, gate
  // jb / U of unit rank * U + jb % U; zero past H
  float wr[2][kRegJPerLane];
#pragma unroll
  for (int jj = 0; jj < kRegJPerLane; ++jj) {
    const int jb = jl * kRegJPerLane + jj;
    const int unit = rank * U + jb % U;
    const int col = (jb / U) * H + unit;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wr[i][jj] = kg < KG && k0 + i < H && unit < H
                      ? to_f32<T>(w[static_cast<size_t>(k0 + i) * G + col])
                      : 0.0f;
  }
  // the tile, and the partials: the slots of units past H are never sent
  for (int i = tid; i < kQuads * (U / 8) * GP + 2 * C * U * R; i += threads)
    dgt[i] = 0.0f;

  // a step's inputs, element e = (r * 7 + q) * U + u of the block's units
  // (consecutive threads on consecutive units): loaded into registers two
  // steps ahead, put into their ring slot the step before they are used
  const int n_in = kRegIn * R * U;
  T xr[kRegLoads];
  auto in_at = [&](int s, int e) -> const T* {   // nullptr: a zero
    const int t = t_of(s);
    const int u = e & (U - 1), rq = e >> lgU;
    const int q = rq % kRegIn, row = row0 + rq / kRegIn;
    const int gu = rank * U + u;
    if (row >= B || gu >= H || (q == 5 && t == first)) return nullptr;
    const size_t cell = static_cast<size_t>(row) * N + t;
    if (q < 4) return gs + cell * G + q * H + gu;
    if (q == 4) return cs + cell * H + gu;
    if (q == 5) return cs + (cell + dprev) * H + gu;
    return dys + cell * H + gu;
  };
  auto load_in = [&](int s) {
#pragma unroll
    for (int j = 0; j < kRegLoads; ++j) {
      const int e = tid + j * threads;
      if (e < n_in) {
        const T* p = in_at(s, e);
        xr[j] = p ? *p : from_f32<T>(0.0f);
      }
    }
  };
  auto store_in = [&](int s) {
    float* slot = ring + (s & 1) * kRegIn * R * UP;
#pragma unroll
    for (int j = 0; j < kRegLoads; ++j) {
      const int e = tid + j * threads;
      if (e < n_in) slot[(e >> lgU) * UP + (e & (U - 1))] = to_f32<T>(xr[j]);
    }
  };
  // the staged dg of a step, element (g * R + r) * U + u, stored with
  // consecutive threads on consecutive units
  // (at most 3 a thread: 7UR <= kRegLoads threads)
  auto flush = [&](int s, int slot) {
    const size_t t = static_cast<size_t>(t_of(s));
    const float* st = stage + slot * 4 * R * UP;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = tid + j * threads;
      if (e >= 4 * R * U) break;
      const int u = e & (U - 1), gr = e >> lgU;
      const int row = row0 + gr % R, gu = rank * U + u;
      if (row < B && gu < H)
        dg[(static_cast<size_t>(row) * N + t) * G + (gr / R) * H + gu] =
            from_f32<T>(st[gr * UP + u]);
    }
  };
  load_in(0);
  store_in(0);
  if (N > 1) load_in(1);

  // full[b] completes when every warp of this block has written its own
  // partials into buffer b of part (one arrival a warp) and the other
  // blocks' partials have landed: step s reads buffer s & 1 (step s-1's
  // partials) and waits for the ((s - 1) / 2)-th phase of full[s & 1]
  __shared__ __align__(8) uint64_t full[2];
  const uint32_t bar = smem_addr(full);
  // the pairs of k of this block's units, each 2R floats from each other
  // block
  const int my_pairs = ((rank * U + U < 2 * KG ? rank * U + U : 2 * KG) -
                        rank * U) / 2;
  const uint32_t part_tx =
      static_cast<uint32_t>((C - 1) * my_pairs * 2 * R * 4);
  if (tid == 0) {
    mbar_init(bar, threads / 32);
    mbar_init(bar + 8, threads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // every block of the cluster holds its zero tile, its first input slot
  // and its mbarriers before any block writes into another's shared memory
  cluster.sync();

  // the block owning the pair k0, k0 + 1, and k0's unit there
  const int owner = k0 >> lgU;
  const int k0_unit = k0 & (U - 1);
  const bool cell = tid < U * R;
  const int cu = tid / R, cr = tid % R;   // the cell's unit and row
  float dc = 0.0f;
  int slot = 0;                   // the step's staging slot, s % kRegStages
  for (int s = 0; s < N; ++s) {
    const int buf = s & 1;
    if (s > 0) mbar_wait(bar + buf * 8, ((s - 1) >> 1) & 1);
    if (cell) {
      const float* in = ring + buf * kRegIn * R * UP + cr * kRegIn * UP + cu;
      const float ig = in[0], fg = in[UP], gg = in[2 * UP], og = in[3 * UP];
      const float tanh_c = tanhf(in[4 * UP]);
      const float c_c = round_to<T>(og * (1.0f - tanh_c * tanh_c));
      const float c_i = round_to<T>(gg * ig * (1.0f - ig));
      const float c_f = round_to<T>(in[5 * UP] * fg * (1.0f - fg));
      const float c_g = round_to<T>(ig * (1.0f - gg * gg));
      const float c_o = round_to<T>(tanh_c * og * (1.0f - og));
      // dh_carry: the C blocks' partials in rank order (none at step 0)
      float dh = 0.0f;
      if (s > 0) {
        const float* pp = part + (buf * C * U + cu) * R + cr;
        for (int q = 0; q < C; ++q) dh += pp[q * U * R];
      }
      const float dh_t = in[6 * UP] + dh;
      const float dc_t = dc + dh_t * c_c;
      const float d[4] = {dc_t * c_i, dc_t * c_f, dc_t * c_g, dh_t * c_o};
      dc = dc_t * fg;
      float* st = stage + slot * 4 * R * UP + cr * UP + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int jb = g * U + cu;
        dgt[(cr / RQ) * (U / 8) * GP + (jb / kRegJPerLane) * GP +
            (jb % kRegJPerLane) * RQ + cr % RQ] = round_to<T>(d[g]);
        st[g * R * UP] = d[g];
      }
    }
    const int prev = slot == 0 ? kRegStages - 1 : slot - 1;
    if (s + 1 == N) {
      if (s > 0) flush(s - 1, prev);
      break;
    }
    __syncthreads();   // the step's dg tile is whole

    // partial dh_carry[k0 + i] of the block's columns: T(dg) . T(W_hh[k0 +
    // i, :]), the lane's 32 columns, then the JL lanes' partials
    float acc[2][R];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] = 0.0f;
#pragma unroll
    for (int qd = 0; qd < kQuads; ++qd) {
      const float4* dq = reinterpret_cast<const float4*>(
          dgt + (qd * (U / 8) + jl) * GP);
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const float4 dv = dq[ch];
        const float dk[4] = {dv.x, dv.y, dv.z, dv.w};   // [e][r]
#pragma unroll
        for (int e = 0; e < KC; ++e)
#pragma unroll
          for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              acc[i][qd * RQ + r] = fmaf(dk[e * RQ + r], wr[i][ch * KC + e],
                                         acc[i][qd * RQ + r]);
      }
    }
    for (int m = 1; m < JL; m <<= 1)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[i][r] += __shfl_xor_sync(kFullMask, acc[i][r], m);

    // the pair's 2R floats (k0 then k0 + 1, R rows each) into slot `rank`
    // of the next buffer of the block owning k0: this block's by a store,
    // another's by st.async on its mbarrier
    const int nb = buf ^ 1;
    if (kg < KG) {
      float* dst = part + ((nb * C + rank) * U + k0_unit) * R;
      // float f of the pair: acc[f / R][f % R]
#define PAIR(f) acc[(f) / R][(f) % R]
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        if ((pc & (JL - 1)) != jl) continue;
        if (owner == rank) {
          if (R == 1) {
            dst[0] = PAIR(0);
            dst[1] = PAIR(1);
          } else {
            *reinterpret_cast<float4*>(dst + 4 * pc) =
                make_float4(PAIR(4 * pc), PAIR(4 * pc + 1), PAIR(4 * pc + 2),
                            PAIR(4 * pc + 3));
          }
        } else {
          const uint32_t a = cluster_addr(smem_addr(dst + 4 * pc), owner);
          const uint32_t b = cluster_addr(bar + nb * 8, owner);
          if (R == 1)
            st_async8(a, PAIR(0), PAIR(1), b);
          else
            st_async16(a, PAIR(4 * pc), PAIR(4 * pc + 1), PAIR(4 * pc + 2),
                       PAIR(4 * pc + 3), b);
        }
      }
#undef PAIR
    }
    // the next step's inputs (in registers two steps) into their slot
    store_in(s + 1);
    // the warp's arrival on this block's own buffer: its partials and input
    // slot writes and its previous staging reads are done
    __syncwarp();
    if (lane == 0) {
      if (warp == 0)
        mbar_arrive_expect(bar + nb * 8, part_tx);
      else
        mbar_arrive(bar + nb * 8);
    }
    // after the arrival, which would wait for them: the global loads and
    // stores, while the bytes travel. The staging slot of step s - 1 is
    // written again at step s + 2, after every warp's next arrival.
    if (s + 2 < N) load_in(s + 2);
    if (s > 0) flush(s - 1, prev);
    slot = slot == kRegStages - 1 ? 0 : slot + 1;
  }
  __syncthreads();
  flush(N - 1, slot);
  // no block exits while another may still write into it
  cluster.sync();
}

// Dynamic shared memory one block of the wide kernel needs at hidden size
// H, in bytes (the wrapper's bilstm_bwd_smem_bytes mirrors it).
size_t smem_bytes(int H) {
  const size_t G = 4 * static_cast<size_t>(H);
  return (G * static_cast<size_t>(H) + 2 * kRows * G) * sizeof(float);
}

// The unit kernel's static shared memory (the dg tile, double buffered) and
// threads: four lanes for each of H units, padded to whole warps (the
// wrapper's unit_smem_bytes(R, 4) and unit_threads mirror them).
constexpr size_t unit_smem_bytes(int R) {
  return 2 * 4 * static_cast<size_t>(kMaxUnitH) * R * sizeof(float);
}
constexpr int unit_threads(int H) { return kLanes * ((H + 7) / 8 * 8); }

bool valid_unit_plan(int B, int N, int H, int R) {
  return B > 0 && N > 0 && H > 0 && H <= kMaxUnitH &&
         (R == 1 || R == 2 || R == 4);
}

constexpr int kMaxDevices = 64;
template <typename T>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T>
cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && g_smem_allowed<T>[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bilstm_bwd_wide_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<T>[device].store(smem);
  return err;
}

template <typename T>
int launch(const void* w_f, const void* w_b, const void* gs_f,
           const void* cs_f, const void* dy_f, const void* gs_b,
           const void* cs_b, const void* dy_b, void* dg_f, void* dg_b, int B,
           int N, int H, int dirs, int rev, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || 4 * H > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H);
  const cudaError_t err = allow_smem<T>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, dirs);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  bilstm_bwd_wide_kernel<T><<<grid, 4 * H, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      in(w_f), in(w_b), in(gs_f), in(cs_f), in(dy_f), in(gs_b), in(cs_b),
      in(dy_b), out(dg_f), out(dg_b), B, N, H, rev);
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel's slice, block and shared memory at H, C and R (the
// wrapper's lstm_cluster_smem_bytes("bwd", ...) and _lstm_cluster_rule
// mirror them, held to bilstm_bwd_cluster_smem_bytes when the library
// loads): U = ceil(H / C) units a block, every block owning one at least.
int cluster_units(int H, int C) { return (H + C - 1) / C; }

size_t cluster_smem_bytes(int H, int C, int R) {
  const size_t G = 4 * static_cast<size_t>(H);
  return (pad4(G * cluster_units(H, C)) + 2 * G * R) * sizeof(float);
}

bool valid_cluster_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || H > kMaxClusterH ||
      (C != 1 && C != 2 && C != 4 && C != 8) || R <= 0 ||
      R % kRowsPerThread != 0)
    return false;
  const int U = cluster_units(H, C);
  return (C - 1) * U < H && U * (R / kRowsPerThread) <= kClusterThreads;
}

// The stream kernel's shared memory (the dg tile alone, its rows padded to
// whole chunks of kStreamK) and plan rule: any H, a cluster of 1 to
// kStreamMaxC blocks each owning a unit at least, R a multiple of
// kRowsPerThread, at most kClusterThreads threads and kMaxSmem bytes a
// block (the wrapper's stream_smem_bytes and _stream_rule mirror them, held
// to bilstm_bwd_stream_smem_bytes when the library loads).
size_t stream_smem_bytes(int H, int R) {
  return 2 * static_cast<size_t>(pad_stream(4 * H)) * R * sizeof(float);
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

template <typename T, bool kStream>
std::atomic<int> g_cluster_smem_allowed[kMaxDevices];

// The dynamic shared memory a variant may use (and, for the stream kernel,
// clusters above 8 blocks), set once per device and again only for more.
template <typename T, bool kStream>
cudaError_t allow_cluster_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices &&
      g_cluster_smem_allowed<T, kStream>[device].load() >= smem)
    return cudaSuccess;
  if constexpr (kStream) {
    err = cudaFuncSetAttribute(bilstm_bwd_cluster_kernel<T, kStream>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(bilstm_bwd_cluster_kernel<T, kStream>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_cluster_smem_allowed<T, kStream>[device].store(smem);
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

template <typename T, bool kStream>
int launch_cluster(const void* w_f, const void* w_b, const void* gs_f,
                   const void* cs_f, const void* dy_f, const void* gs_b,
                   const void* cs_b, const void* dy_b, void* dg_f, void* dg_b,
                   int B, int N, int H, int C, int R, int dirs, int rev,
                   void* stream) {
  if (!valid_plan_of<kStream>(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of<kStream>(H, C, R);
  cudaError_t err = allow_cluster_smem<T, kStream>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_cluster_config(&cfg, &attr, B, H, C, R, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bilstm_bwd_cluster_kernel<T, kStream>,
                           in(w_f), in(w_b), in(gs_f), in(cs_f), in(dy_f),
                           in(gs_b), in(cs_b), in(dy_b), out(dg_f), out(dg_b),
                           B, N, H, R, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kStream>
int cluster_max_active(int H, int C, int R) {
  const size_t smem = smem_of<kStream>(H, C, R);
  cudaError_t err = allow_cluster_smem<T, kStream>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_cluster_config(&cfg, &attr, R, H, C, R, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, bilstm_bwd_cluster_kernel<T, kStream>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
const void* unit_kernel(int R) {
  if (R == 1)
    return reinterpret_cast<const void*>(bilstm_bwd_unit_kernel<T, 1>);
  if (R == 2)
    return reinterpret_cast<const void*>(bilstm_bwd_unit_kernel<T, 2>);
  return reinterpret_cast<const void*>(bilstm_bwd_unit_kernel<T, 4>);
}

template <typename T>
int launch_unit(const void* w_f, const void* w_b, const void* gs_f,
                const void* cs_f, const void* dy_f, const void* gs_b,
                const void* cs_b, const void* dy_b, void* dg_f, void* dg_b,
                int B, int N, int H, int R, int dirs, int rev, void* stream) {
  if (!valid_unit_plan(B, N, H, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + R - 1) / R, dirs);
  const int threads = unit_threads(H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  if (R == 1)
    bilstm_bwd_unit_kernel<T, 1><<<grid, threads, 0, st>>>(
        in(w_f), in(w_b), in(gs_f), in(cs_f), in(dy_f), in(gs_b), in(cs_b),
        in(dy_b), out(dg_f), out(dg_b), B, N, H, rev);
  else if (R == 2)
    bilstm_bwd_unit_kernel<T, 2><<<grid, threads, 0, st>>>(
        in(w_f), in(w_b), in(gs_f), in(cs_f), in(dy_f), in(gs_b), in(cs_b),
        in(dy_b), out(dg_f), out(dg_b), B, N, H, rev);
  else
    bilstm_bwd_unit_kernel<T, 4><<<grid, threads, 0, st>>>(
        in(w_f), in(w_b), in(gs_f), in(cs_f), in(dy_f), in(gs_b), in(cs_b),
        in(dy_b), out(dg_f), out(dg_b), B, N, H, rev);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int unit_blocks_per_sm(int H, int R) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, unit_kernel<T>(R), unit_threads(H), 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The register cluster kernel's plan rule (the wrapper's _reg_rule and
// reg_smem_bytes("bwd", ...) mirror it, held to bilstm_bwd_reg_layout when
// the library loads): H up to kMaxClusterH, a cluster of up to kRegMaxC
// blocks each owning a unit at least, tiles of 1, 2, 4 or 8 rows, at most
// kRegMaxThreads threads and kMaxSmem bytes a block, at most kRegLoads
// input values a thread a step (so a thread for each cell of the block's
// units).
bool valid_reg_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || H > kMaxClusterH || C < 1 ||
      C > kRegMaxC || (R != 1 && R != 2 && R != 4 && R != 8))
    return false;
  const int U = reg_units(H, C);
  return (C - 1) * U < H && reg_threads(H, C) <= kRegMaxThreads &&
         kRegIn * U * R <= kRegLoads * reg_threads(H, C) &&
         reg_smem_floats(H, C, R) * sizeof(float) <= kMaxSmem;
}

// The dynamic shared memory the cluster kernel `fn` (the register
// kernel's) may use and its non-portable cluster size, set once per
// device (`allowed`, one slot each) and again only for more.
template <typename F>
cudaError_t allow_smem_of(F fn, std::atomic<int>* allowed, int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && device < kMaxDevices) allowed[device].store(smem);
  return err;
}

template <typename T, int R>
cudaError_t reg_prepare(int smem) {
  static std::atomic<int> allowed[kMaxDevices];
  return allow_smem_of(bilstm_bwd_reg_kernel<T, R>, allowed, smem);
}

// A launch of `tiles` clusters of C blocks of `threads` over `dirs`
// directions (the register kernel).
void make_reg_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                     int tiles, int threads, int C, int dirs, size_t smem,
                     void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(C * tiles, dirs, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T, int R>
int launch_reg_as(const void* w_f, const void* w_b, const void* gs_f,
                  const void* cs_f, const void* dy_f, const void* gs_b,
                  const void* cs_b, const void* dy_b, void* dg_f, void* dg_b,
                  int B, int N, int H, int C, int dirs, int rev,
                  void* stream) {
  const size_t smem = reg_smem_floats(H, C, R) * sizeof(float);
  cudaError_t err = reg_prepare<T, R>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, (B + R - 1) / R, reg_threads(H, C), C, dirs,
                  smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bilstm_bwd_reg_kernel<T, R>, in(w_f),
                           in(w_b), in(gs_f), in(cs_f), in(dy_f), in(gs_b),
                           in(cs_b), in(dy_b), out(dg_f), out(dg_b), B, N, H,
                           rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reg(const void* w_f, const void* w_b, const void* gs_f,
               const void* cs_f, const void* dy_f, const void* gs_b,
               const void* cs_b, const void* dy_b, void* dg_f, void* dg_b,
               int B, int N, int H, int C, int R, int dirs, int rev,
               void* stream) {
  if (!valid_reg_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* fn = R == 1   ? launch_reg_as<T, 1>
             : R == 2 ? launch_reg_as<T, 2>
             : R == 4 ? launch_reg_as<T, 4>
                      : launch_reg_as<T, 8>;
  return fn(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b, dg_f, dg_b, B, N, H,
            C, dirs, rev, stream);
}

template <typename T, int R>
int reg_max_active_as(int H, int C) {
  const size_t smem = reg_smem_floats(H, C, R) * sizeof(float);
  cudaError_t err = reg_prepare<T, R>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, 1, reg_threads(H, C), C, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bilstm_bwd_reg_kernel<T, R>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int reg_max_active(int H, int C, int R) {
  return R == 1   ? reg_max_active_as<T, 1>(H, C)
         : R == 2 ? reg_max_active_as<T, 2>(H, C)
         : R == 4 ? reg_max_active_as<T, 4>(H, C)
                  : reg_max_active_as<T, 8>(H, C);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device. All tensors are contiguous, in the stream type float (_f32) or
// bfloat16 (_bf16): w_* [H, 4H]; gs_* and dg_* [B, N, 4H]; cs_* and dy_*
// [B, N, H]. Returns a cudaError_t code; 0 means the launch was accepted.
// bilstm_bwd_* and lstm_bwd_* launch the wide kernel (tiles of kRows rows,
// 4H <= 512 threads); bilstm_bwd_unit_* and lstm_bwd_unit_* the unit kernel
// (H <= 64) with batch tiles of R rows (1, 2 or 4).
// lstm_bwd_*: one direction of an LSTM, a grid of one direction over w
// [H, 4H], gs and dg [B, N, 4H], cs and dy [B, N, H]; reverse != 0 for a
// direction whose forward walked t = N-1 .. 0.
#define BILSTM_BWD_ENTRIES(SFX, TYPE)                                         \
  int bilstm_bwd_##SFX(const void* w_f, const void* w_b, const void* gs_f,   \
                       const void* cs_f, const void* dy_f, const void* gs_b, \
                       const void* cs_b, const void* dy_b, void* dg_f,       \
                       void* dg_b, int B, int N, int H, void* stream) {      \
    return launch<TYPE>(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b, dg_f,  \
                        dg_b, B, N, H, 2, 0, stream);                        \
  }                                                                          \
  int lstm_bwd_##SFX(const void* w, const void* gs, const void* cs,          \
                     const void* dy, void* dg, int B, int N, int H,          \
                     int reverse, void* stream) {                            \
    return launch<TYPE>(w, w, gs, cs, dy, gs, cs, dy, dg, dg, B, N, H, 1,    \
                        reverse, stream);                                    \
  }                                                                          \
  int bilstm_bwd_unit_##SFX(const void* w_f, const void* w_b,                \
                            const void* gs_f, const void* cs_f,              \
                            const void* dy_f, const void* gs_b,              \
                            const void* cs_b, const void* dy_b, void* dg_f,  \
                            void* dg_b, int B, int N, int H, int R,          \
                            void* stream) {                                  \
    return launch_unit<TYPE>(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b,   \
                             dg_f, dg_b, B, N, H, R, 2, 0, stream);          \
  }                                                                          \
  int lstm_bwd_unit_##SFX(const void* w, const void* gs, const void* cs,     \
                          const void* dy, void* dg, int B, int N, int H,     \
                          int R, int reverse, void* stream) {                \
    return launch_unit<TYPE>(w, w, gs, cs, dy, gs, cs, dy, dg, dg, B, N, H,  \
                             R, 1, reverse, stream);                         \
  }

BILSTM_BWD_ENTRIES(f32, float)
BILSTM_BWD_ENTRIES(bf16, __nv_bfloat16)
#undef BILSTM_BWD_ENTRIES

// The cluster kernel: arguments and outputs as the entries above, with
// clusters of C blocks (1, 2, 4 or 8) over batch tiles of R rows (a
// multiple of 4); H up to 256. The stream kernel (KIND stream): the same,
// with clusters of 1 to 16 blocks, any H whose plan fits, and w_* as W_hh^T
// [4H, H].
#define BILSTM_BWD_CLUSTER_ENTRIES(SFX, TYPE, KIND, STREAM)                   \
  int bilstm_bwd_##KIND##_##SFX(const void* w_f, const void* w_b,            \
                                const void* gs_f, const void* cs_f,          \
                                const void* dy_f, const void* gs_b,          \
                                const void* cs_b, const void* dy_b,          \
                                void* dg_f, void* dg_b, int B, int N, int H, \
                                int C, int R, void* stream) {                \
    return launch_cluster<TYPE, STREAM>(w_f, w_b, gs_f, cs_f, dy_f, gs_b,    \
                                        cs_b, dy_b, dg_f, dg_b, B, N, H, C,  \
                                        R, 2, 0, stream);                    \
  }                                                                          \
  int lstm_bwd_##KIND##_##SFX(const void* w, const void* gs, const void* cs, \
                              const void* dy, void* dg, int B, int N, int H, \
                              int C, int R, int reverse, void* stream) {     \
    return launch_cluster<TYPE, STREAM>(w, w, gs, cs, dy, gs, cs, dy, dg,    \
                                        dg, B, N, H, C, R, 1, reverse,       \
                                        stream);                             \
  }

BILSTM_BWD_CLUSTER_ENTRIES(f32, float, cluster, false)
BILSTM_BWD_CLUSTER_ENTRIES(bf16, __nv_bfloat16, cluster, false)
BILSTM_BWD_CLUSTER_ENTRIES(f32, float, stream, true)
BILSTM_BWD_CLUSTER_ENTRIES(bf16, __nv_bfloat16, stream, true)
#undef BILSTM_BWD_CLUSTER_ENTRIES

// The register cluster kernel: arguments and outputs as the cluster
// entries (clusters of C = 1 .. 16 blocks over batch tiles of R = 1, 2, 4
// or 8 rows); H up to 256.
#define BILSTM_BWD_REG_ENTRIES(SFX, TYPE)                                     \
  int bilstm_bwd_reg_##SFX(const void* w_f, const void* w_b,                 \
                           const void* gs_f, const void* cs_f,               \
                           const void* dy_f, const void* gs_b,               \
                           const void* cs_b, const void* dy_b, void* dg_f,   \
                           void* dg_b, int B, int N, int H, int C, int R,    \
                           void* stream) {                                   \
    return launch_reg<TYPE>(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b,    \
                            dg_f, dg_b, B, N, H, C, R, 2, 0, stream);        \
  }                                                                          \
  int lstm_bwd_reg_##SFX(const void* w, const void* gs, const void* cs,      \
                         const void* dy, void* dg, int B, int N, int H,      \
                         int C, int R, int reverse, void* stream) {          \
    return launch_reg<TYPE>(w, w, gs, cs, dy, gs, cs, dy, dg, dg, B, N, H,   \
                            C, R, 1, reverse, stream);                       \
  }

BILSTM_BWD_REG_ENTRIES(f32, float)
BILSTM_BWD_REG_ENTRIES(bf16, __nv_bfloat16)
#undef BILSTM_BWD_REG_ENTRIES

// How many clusters of the register cluster kernel (bf16: 0 or 1; `save`
// is taken for the forward source's signature and ignored) at H, C and R
// the current device runs at once; a negative cudaError_t code on failure.
int bilstm_bwd_reg_max_active_clusters(int bf16, int save, int H, int C,
                                       int R) {
  (void)save;
  if (!valid_reg_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? reg_max_active<__nv_bfloat16>(H, C, R)
              : reg_max_active<float>(H, C, R);
}

// The register cluster kernel's layout at H, C and R, for the wrapper's
// mirror: what 0 = dynamic shared memory in bytes, 1 = threads a block, 2 =
// units a block; -1 for a plan it does not take.
int bilstm_bwd_reg_layout(int what, int H, int C, int R) {
  if (!valid_reg_plan(1, 1, H, C, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(reg_smem_floats(H, C, R) * sizeof(float));
    case 1: return reg_threads(H, C);
    case 2: return reg_units(H, C);
    default: return -1;
  }
}

// How many clusters of the cluster kernel (bf16: 0 or 1; `save` is taken
// for the forward source's signature and ignored) at H, C and R the
// current device runs at once; a negative cudaError_t code on failure.
int bilstm_bwd_cluster_max_active_clusters(int bf16, int save, int H, int C,
                                           int R) {
  (void)save;
  if (!valid_cluster_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? cluster_max_active<__nv_bfloat16, false>(H, C, R)
              : cluster_max_active<float, false>(H, C, R);
}

// The cluster kernel's dynamic shared memory in bytes at H, C and R, for
// the wrapper's mirror; -1 for a plan it does not take.
int bilstm_bwd_cluster_smem_bytes(int H, int C, int R) {
  if (!valid_cluster_plan(1, 1, H, C, R)) return -1;
  return static_cast<int>(cluster_smem_bytes(H, C, R));
}

// The same two queries of the stream kernel.
int bilstm_bwd_stream_max_active_clusters(int bf16, int save, int H, int C,
                                          int R) {
  (void)save;
  if (!valid_stream_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? cluster_max_active<__nv_bfloat16, true>(H, C, R)
              : cluster_max_active<float, true>(H, C, R);
}

int bilstm_bwd_stream_smem_bytes(int H, int C, int R) {
  if (!valid_stream_plan(1, 1, H, C, R)) return -1;
  return static_cast<int>(stream_smem_bytes(H, R));
}

// How many blocks of the unit kernel (bf16: 0 or 1) at hidden size H and
// tile R one SM of the current device runs at once; a negative cudaError_t
// code on failure. `save` is taken for the forward sources' signature of
// this query and ignored (the BPTT has one variant).
int bilstm_bwd_unit_blocks_per_sm(int bf16, int save, int H, int R) {
  (void)save;
  if (!valid_unit_plan(1, 1, H, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? unit_blocks_per_sm<__nv_bfloat16>(H, R)
              : unit_blocks_per_sm<float>(H, R);
}

// The unit kernel's layout at hidden size H and tile R, for the wrapper's
// mirror: what 0 = static shared memory in bytes, 1 = threads a block, 2 =
// W_hh values a lane holds in registers; -1 for a plan it does not take.
int bilstm_bwd_unit_layout(int what, int H, int R) {
  if (!valid_unit_plan(1, 1, H, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(unit_smem_bytes(R));
    case 1: return unit_threads(H);
    case 2: return 4 * kKPerLane;
    default: return -1;
  }
}

const char* bilstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
