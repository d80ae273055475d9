// Fused GRU recurrence, forward, float32 or bfloat16 streams: the inference
// (light) variant and the training variant that also saves residuals, with
// W_hh split across the blocks of a thread-block cluster. One source, two
// grids: both directions of a BiGRU layer (bigru_fwd_*), or one direction
// of a GRU (gru_fwd_*, with a reverse flag).
//
// Replaces two TPU kernels, both their save_residuals pallas_call and their
// light one: room_slam_tpu/ops/gru_pallas.py::_bigru_fwd_kernel (:314,
// pallas_call :454 and :483, launched through _bigru_fwd_pallas and
// bigru_recurrence_pallas) with the grid's two directions, and
// _gru_fwd_kernel (:39, pallas_call :155 and :182, launched through
// _gru_fwd_pallas and gru_recurrence_pallas) with a grid of one direction.
// Per direction, with torch nn.GRU numerics (gate order r, z, n):
//
//   hg = T(h_{t-1}) @ T(W_hh) + b_hh     (f32 sums; T = the stream type)
//   r = sigmoid(xg_r + hg_r), z = sigmoid(xg_z + hg_z)
//   n = tanh(xg_n + r * hg_n)
//   h_t = (1 - z) * n + z * h_{t-1}      (f32 carry)
//
// The training variant (kSave) also stores, per direction, the activated
// gates (r, z, n) [B, N, 3H] and hn = hg_n [B, N, H] of every step, in the
// stream type: the residuals the backward kernel (bigru_bwd.cu) reads.
//
// The forward direction walks t = 0 .. N-1 over xg_f; the backward direction
// walks t = N-1 .. 0 over xg_b (given in original time order), so no flipped
// copies are made and every output comes back in original time order. The
// single-direction GRU's reverse walk is that backward direction: the same
// values as the reference, which flips xg, runs forward and flips back.
// Every step of the padded window runs; there is no mask, as in the
// reference.
//
// What bounds it on an H100. At the scale-up shape (B=128, N=5000, H=256,
// bf16) the light kernel moves 3H in and H out per (row, step) and direction,
// 2.6 GB for both directions (0.78 ms at 3.35 TB/s), and does 2 * 3H * H
// multiply-adds per (row, step) and direction, 504 GFLOP for both (0.51 ms
// at 989 TFLOP/s for bf16 operands).
// At the legacy GRU shape (one direction, B=32, N=500, H=64, f32) the light
// kernel moves 16.4 MB (4.9 us) and does 0.39 GFLOP (5.9 us at 67 TFLOP/s
// for f32); the training variant writes 16.4 MB more residuals.
// Neither is the real floor: the recurrence is a chain of 5000 dependent
// steps, each a 256-deep dot product for 768 gate columns of every row, so
// the time is 5000 times the latency of one step (500 steps of a 64-deep
// product at the legacy shape). On CUDA cores with
// float32 FMAs the FMA issue rate alone would allow ~1.6 us a step (2 *
// 128 * 768 * 256 FMAs over 132 SMs of 128 lanes); measured on an H100 the
// step takes 8.9 us. The shared-memory loads look like the bound (no
// profiler runs on that machine): per k, each thread issues three W loads
// and one 128-bit broadcast load of four rows of h; if that load costs four
// wavefronts a warp, 7 wavefronts feed 12 FMAs here and 5 feed 4 in the
// BPTT kernel, which does take 2.1x as long per step, as that count says.
//
// What the design does about it. One direction's W_hh at H=256 is 768 KiB in
// float32 (384 KiB in bf16), over the 227 KB of shared memory one block has.
// So one cluster of C blocks (C = 1, 2, 4 or 8) handles one (direction,
// batch tile of R rows), and its block of rank q owns the U = ceil(H / C)
// hidden units q*U .. min(H, q*U+U)-1 (where C does not divide H the last
// block's slice is short and its other threads are masked; the planner
// takes such a plan only at an H no dividing plan fits): it holds the W_hh columns of the r, z and n gates of
// those units in shared memory (as float32; a bf16 value is exact there),
// so all gate math of a unit is local to one thread. Thread (u, g) computes
// the three gate columns of unit u for kRowsPerThread rows and keeps those
// cells' f32 carries in registers. Each step every block reads the whole
// h_{t-1} tile [H, R] from its own shared memory (float4 broadcasts), and
// after the gate math pushes its slice of h_t, rounded to the stream type,
// into the other half of a double-buffered tile in the shared memory of
// every block of the cluster (distributed shared memory through
// map_shared_rank); one cluster.sync() per step orders the pushes before the
// next step's reads. The wrapper (ops/gru_cuda.py bigru_plan) picks C and R
// so that the W_hh slice fits, every cluster of the grid is resident at once
// (by the card's own count: an H100 holds 15 clusters of 8 such blocks) and
// each block has as few threads as that allows: at B=128, H=256, 14
// clusters of 8 blocks with 20 rows each, spreading a step over 112 SMs.
// The next step's xg is prefetched into registers before the dot products
// and the output stores are fire-and-forget, so global memory sits off the
// chain. More outputs per thread (fewer loads per FMA) and tensor cores
// (mma.sync / wgmma for the h @ W_hh product) are left for later work.
//
// The single-direction GRU at small H (gru_fwd_unit_kernel, H <= 64, the
// legacy model's H=64). What held the cluster kernel back there:
// the planner's step cost ties every small plan, so B=32, H=64 ran 8 blocks
// of 64 threads (2 warps) on 8 of 132 SMs, each thread a 64-deep chain of 3
// shared loads of W and a float4 of h per 12 FMAs, full-precision expf /
// tanhf, then a cluster.sync() and a distributed-shared-memory push even for
// a cluster of one block. Measured on an H100: 2.66 us a step, against
// cuDNN's 0.60. The unit kernel is one block per (tile of R rows), R = 1, 2
// or 4 (rnn_cuda unit_plans sizes it to the batch and the card: 32 blocks
// at B=32): four lanes of one warp own hidden unit u, lane p holds the W_hh
// values of u's r, z and n columns for its quarter of the k sum in
// registers (48 floats at H=64), reads h_{t-1} ([k][R] in shared memory) as
// 16-byte broadcasts, and the four lanes' sums meet by __shfl_xor_sync so
// that lane p ends with row p % R's three sums and runs its gate math and
// f32 carry in registers; one block barrier a step, no cluster, __expf and
// a fast reciprocal in the activations, xg loaded kAhead = 8 steps ahead
// into a register ring (the step loop unrolled by 8). Measured on an H100:
// 0.42 us a step at B=32 (cuDNN 0.60). A row's FMA issue is about 0.06 us
// of it (the 2- and 4-row tiles take that much more a row); the rest is
// the step's fixed chain: barrier, two shuffle rounds, the activations'
// MUFU latency and the h broadcast. The wrapper (ops/gru_cuda.py
// gru_fwd_kernel_route) sends a one-direction launch at H <= 64 here and
// everything else to the cluster kernel.
//
// The tensor-core kernel (bigru_fwd_tc_kernel: both directions, bfloat16
// streams, the scale-up model's launches). What held the cluster kernel
// back at the scale-up shape (9.1 us a step): every thread walks a serial
// 256-deep chain of shared-memory loads and f32 FMAs on CUDA cores, W_hh
// read from shared memory as float on every k, 160 threads a block leave
// the latency uncovered, and each step ends in a full cluster.sync() after
// float4 pushes of f32 h. Here the step's product T(h_{t-1}) [R, H] @
// T(W_hh) [H, 3H] runs as mma.sync m16n8k16 (bf16 operands, f32 sums: the
// MXU's product in the reference). One cluster of C blocks (C = 4 or 8)
// per (direction, batch tile of R = 16 or 32 rows: one or two m16 tiles);
// block `rank` owns the units U = H / C, and each warp 8 of them. For
// those units the warp owns three n8 tiles of the product, the r, z and n
// columns, so the accumulator a lane ends with holds the r, z and n
// pre-activations of the same two rows x two units: the gate math and the
// f32 carry need no exchange inside the block. The warp's [H x 24] slice
// of W_hh is held as B fragments in registers, loaded once (3 x 16 x 2 = 96
// registers). h_{t-1} is a double-buffered bf16 tile [2][R][256 + 8] in
// shared memory (rows padded so that ldmatrix is conflict-free), read as A
// fragments; the 16 k-steps alternate between two accumulators (chains of
// 8 mma), summed in a fixed order. The tile is 256 wide whatever H, its
// columns past H zero and the fragments past H zero: a k-step guarded by H
// compiled to a branch around each ldmatrix and its mma, nothing
// overlapped across k-steps, and the product took 1.1 us a step instead of
// about 0.45.
//
// The exchange: each warp writes its T(h_t) into its own block's other
// buffer and sends its rows of it (16 bytes: 8 units) to the other blocks
// by st.async, whose bytes complete on the receiving block's mbarrier; a
// step waits on its own mbarrier only. A split cluster barrier
// (barrier.cluster.arrive.release / wait.acquire) cost 0.5 us a step more:
// its release is a MEMBAR.ALL.GPU. The streams go through shared memory:
// xg arrives by 16-byte cp.async copies of the block's units, two or three
// steps ahead (a ring), and ys, gates and hn leave as 16-byte stores a step
// later; each lane's own 4-byte loads and stores touched 8 rows per warp
// instruction and cost 0.45 us a step (0.6 with the residuals). One
// __syncthreads() a step orders the block's staging. Padding rows past B
// are computed (finite, independent in the product) and never stored.
// Measured on an H100 at the scale-up shape with (4, 16): 1.42 us a step
// (cluster kernel 9.1), of which the product and gate math about 0.66 and
// the rest the exchange, whose bytes (3/4 of the R x H tile into every
// block a step) bound it. The wrapper (ops/gru_cuda.py
// gru_fwd_kernel_route, bigru_tc_plan) sends bf16 launches of two
// directions above H=64 here where tc_plan_fits holds; float32 streams
// (TF32 would miss the float32 bound), one direction and other shapes
// take the register cluster kernel (bigru_fwd_reg.cu) up to H=256.
//
// Both directions of a BiGRU layer at H <= 64 (the `bigru` model at its
// default d_model 128) run the unit kernel with a grid of two directions
// (bigru_fwd_unit_*: y = 1 walks backward, as in the cluster kernel): the
// cluster kernel took 2.66 us a step at such widths, and with bf16 streams
// the tensor-core kernel lost to the unit kernel 2-2.5x at H=64 (its
// exchange is most of a short step).
//
// From H = 65 to 256 the route takes the register cluster kernel
// (bigru_fwd_reg.cu, its own source: each block's slice of W_hh in
// registers, h exchanged by st.async on mbarriers, no cluster barrier) for
// float32 in both grids, bf16 with one direction and bf16 with two where
// no tensor-core plan fits; at (32, 500, 255) f32 it took a step from 6.6
// us here to about 2.5 (chip_smoke.py phase 41, PERF.md section 6). This cluster kernel stays for the A/B,
// reached by a forced ("cluster", C, R) plan, and as the kStream kernel
// below.
//
// Above H = 256 up to 1024 the pipe kernel (bigru_fwd_pipe.cu, its own
// source) takes the launch, for #5 / #5t and #7 / #7t alike, also at the
// widths where a cluster plan fits (the multiples of 8 to 360: its A/B at
// H=320 against this cluster kernel). Above 1024 (and by a forced
// ("stream", C, R) plan below) the stream kernel, the first design for
// these widths, takes it: the cluster kernel with kStream, whose
// block reads the r, z and n columns of its U = ceil(H / C) units from
// global memory every step, so that only the h tile (rows padded to whole
// chunks) sits in shared memory; clusters of up to 16 blocks. What bounds
// it: a block reads 3 H U values through L2 every step, the grid all of
// W_hh once per batch tile and direction (3 MiB at H=512 in f32); the loads
// of the next kStreamK values of k are issued a chunk ahead of their FMAs,
// and gru_cuda's planner (rnn_cuda.stream_plans) weighs a block's FMA
// issue against its and the grid's L2 bytes. Measured on an H100 (phase
// 40): 29 us a step at (32, 500, 512) f32 (cuDNN 22), latency-bound as the
// LSTM's (bilstm_fwd.cu): the lever the pipe kernel took.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerThread = 4;  // batch rows of one thread (a float4)
static_assert(kRowsPerThread == 4, "rows travel as one float4");
constexpr int kMaxThreads = 512;

// unit kernel: lanes per hidden unit, k values of the sum held in registers
// (over the four lanes), and the threads of a block at H = kMaxUnitH
constexpr int kLanes = 4;
constexpr int kMaxUnitH = 64;
constexpr int kKPerLane = kMaxUnitH / kLanes;
constexpr int kUnitThreads = kLanes * kMaxUnitH;
constexpr int kAhead = 8;  // steps of xg in flight ahead of the chain
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;   // devices whose shared-memory limit is kept

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

__host__ __device__ __forceinline__ size_t pad4(size_t n) {
  return (n + 3) / 4 * 4;
}

// The stream kernel (the cluster kernel with kStream): k values of W_hh a
// thread has in flight ahead of its sums, clusters of up to 16 blocks (a
// non-portable size above 8), and the dynamic shared memory of one block
constexpr int kStreamK = 8;
constexpr int kStreamMaxC = 16;
constexpr int kMaxSmem = 232448;

// n rounded up to a multiple of kStreamK: the rows of the stream kernel's
// exchange tile (the rows past n stay zero, so every chunk is whole)
__host__ __device__ __forceinline__ int pad_stream(int n) {
  return (n + kStreamK - 1) / kStreamK * kStreamK;
}

// The cluster kernel (see the notes at the top). kStream: the stream
// kernel, which reads its slice of W_hh from global memory (through L2)
// every step instead of holding it in shared memory.
template <typename T, bool kSave, bool kStream>
__global__ void __launch_bounds__(kMaxThreads)
bigru_fwd_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                 const T* __restrict__ w_f, const float* __restrict__ b_f,
                 const T* __restrict__ w_b, const float* __restrict__ b_b,
                 T* __restrict__ ys_f, T* __restrict__ ys_b,
                 T* __restrict__ gs_f, T* __restrict__ gs_b,
                 T* __restrict__ hn_f, T* __restrict__ hn_b,
                 int B, int N, int H, int R, int rev) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = (H + C - 1) / C;  // units a block owns (the last: fewer)
  const int G = 3 * H;
  const int HT = kStream ? pad_stream(H) : H;   // rows of an h buffer
  float* w_s = smem;                             // [H][3U] W_hh columns
  // [2][HT][R]; the stream kernel holds no W_hh slice
  float* h_s = kStream ? smem : smem + pad4(static_cast<size_t>(H) * 3 * U);

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  const float* b = bwd ? b_b : b_f;
  const int u = threadIdx.x % U;
  const int r0 = (threadIdx.x / U) * kRowsPerThread;  // first row in tile
  const int gu = rank * U + u;                        // global hidden unit
  const bool unit_ok = gu < H;  // else masked: a slice past H (H % C != 0)
  const int row0 = (blockIdx.x / C) * R + r0;

  // this block's W_hh columns: c = gate * U + unit, for every k; the
  // columns of units past H are zero
  if constexpr (!kStream)
    for (int idx = threadIdx.x; idx < H * 3 * U; idx += blockDim.x) {
      const int k = idx / (3 * U);
      const int c = idx - k * 3 * U;
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

  // the stream kernel: the r, z and n columns of unit gu for the next
  // kStreamK values of k, as loaded (zero past H); a step's last chunk
  // loads the next step's first
  const T* wu = w + (unit_ok ? gu : 0);
  T wq[kStreamK][3];
  auto load_w = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kStreamK; ++e) {
      const int k = k0 + e;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wq[e][g] = k < H ? wu[static_cast<size_t>(k) * G + g * H]
                         : from_f32<T>(0.0f);
    }
  };
  if constexpr (kStream) load_w(0);
  const float br = unit_ok ? b[gu] : 0.0f;
  const float bz = unit_ok ? b[H + gu] : 0.0f;
  const float bn = unit_ok ? b[2 * H + gu] : 0.0f;

  bool valid[kRowsPerThread];
  size_t xoff[kRowsPerThread];  // xg / gates of (row, t = 0, unit gu)
  size_t yoff[kRowsPerThread];  // ys / hn of (row, t = 0, unit gu)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    valid[i] = unit_ok && row0 + i < B;
    const size_t row = static_cast<size_t>(valid[i] ? row0 + i : 0);
    xoff[i] = row * N * G + (unit_ok ? gu : 0);
    yoff[i] = row * N * H + (unit_ok ? gu : 0);
  }
  T* ys = bwd ? ys_b : ys_f;
  T* gs = bwd ? gs_b : gs_f;
  T* hns = bwd ? hn_b : hn_f;

  float xnext[kRowsPerThread][3];
  auto load_x = [&](int t) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const T* x = xg + xoff[i] + static_cast<size_t>(t) * G;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xnext[i][g] = valid[i] ? to_f32<T>(x[g * H]) : 0.0f;
    }
  };
  load_x(bwd ? N - 1 : 0);
  float h[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};

  // every block of the cluster runs and holds its W_hh slice and a zero
  // h_{-1} before any block writes into another's shared memory
  cluster.sync();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? N - 1 - s : s;
    float x[kRowsPerThread][3];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int g = 0; g < 3; ++g) x[i][g] = xnext[i][g];
    if (s + 1 < N) load_x(bwd ? t - 1 : t + 1);

    const float* hb = h_s + (s & 1) * HT * R + r0;
    float ar[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    float az[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    float an[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (kStream) {
      for (int k0 = 0; k0 < H; k0 += kStreamK) {
        float wc[kStreamK][3];
#pragma unroll
        for (int e = 0; e < kStreamK; ++e)
#pragma unroll
          for (int g = 0; g < 3; ++g) wc[e][g] = to_f32<T>(wq[e][g]);
        load_w(k0 + kStreamK < H ? k0 + kStreamK : 0);
#pragma unroll
        for (int e = 0; e < kStreamK; ++e) {
          const float4 hv =
              *reinterpret_cast<const float4*>(hb + (k0 + e) * R);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const float hi = i == 0 ? hv.x : i == 1 ? hv.y : i == 2 ? hv.z
                                                                  : hv.w;
            ar[i] = fmaf(hi, wc[e][0], ar[i]);
            az[i] = fmaf(hi, wc[e][1], az[i]);
            an[i] = fmaf(hi, wc[e][2], an[i]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(hb + k * R);
        const float* wk = w_s + k * 3 * U;
        const float wr = wk[u];
        const float wz = wk[U + u];
        const float wn = wk[2 * U + u];
        ar[0] = fmaf(hv.x, wr, ar[0]);
        ar[1] = fmaf(hv.y, wr, ar[1]);
        ar[2] = fmaf(hv.z, wr, ar[2]);
        ar[3] = fmaf(hv.w, wr, ar[3]);
        az[0] = fmaf(hv.x, wz, az[0]);
        az[1] = fmaf(hv.y, wz, az[1]);
        az[2] = fmaf(hv.z, wz, az[2]);
        az[3] = fmaf(hv.w, wz, az[3]);
        an[0] = fmaf(hv.x, wn, an[0]);
        an[1] = fmaf(hv.y, wn, an[1]);
        an[2] = fmaf(hv.z, wn, an[2]);
        an[3] = fmaf(hv.w, wn, an[3]);
      }
    }

    float hq[kRowsPerThread];  // h_t rounded to the stream type
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float hn = an[i] + bn;
      const float r = sigmoid_f(x[i][0] + (ar[i] + br));
      const float z = sigmoid_f(x[i][1] + (az[i] + bz));
      const float n = tanhf(x[i][2] + r * hn);
      h[i] = (1.0f - z) * n + z * h[i];
      hq[i] = round_to<T>(h[i]);
      if (valid[i]) {
        ys[yoff[i] + static_cast<size_t>(t) * H] = from_f32<T>(h[i]);
        if (kSave) {
          T* gt = gs + xoff[i] + static_cast<size_t>(t) * G;
          gt[0] = from_f32<T>(r);
          gt[H] = from_f32<T>(z);
          gt[2 * H] = from_f32<T>(n);
          hns[yoff[i] + static_cast<size_t>(t) * H] = from_f32<T>(hn);
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

// The four lanes of a unit each hold partial sums v[g][r] of 3 gates for R
// rows; afterwards lane p holds in out[g] the full sums of row p % R (a
// reduce-scatter over lane bits 0 and 1; an all-reduce where R < 4).
template <int R>
__device__ __forceinline__ void reduce_lanes(const float (&v)[3][R],
                                             float (&out)[3], int lane) {
  const bool b0 = (lane & 1) != 0;
  const bool b1 = (lane & 2) != 0;
  if constexpr (R == 4) {
    float half[3][2];  // rows 2j + b0, summed over lanes p and p ^ 1
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float keep = b0 ? v[g][2 * j + 1] : v[g][2 * j];
        const float send = b0 ? v[g][2 * j] : v[g][2 * j + 1];
        half[g][j] = keep + __shfl_xor_sync(kFullMask, send, 1);
      }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float keep = b1 ? half[g][1] : half[g][0];
      const float send = b1 ? half[g][0] : half[g][1];
      out[g] = keep + __shfl_xor_sync(kFullMask, send, 2);
    }
  } else if constexpr (R == 2) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float keep = b0 ? v[g][1] : v[g][0];
      const float send = b0 ? v[g][0] : v[g][1];
      out[g] = keep + __shfl_xor_sync(kFullMask, send, 1);
      out[g] += __shfl_xor_sync(kFullMask, out[g], 2);
    }
  } else {
    static_assert(R == 1, "tiles of 1, 2 or 4 rows");
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      out[g] = v[g][0] + __shfl_xor_sync(kFullMask, v[g][0], 1);
      out[g] += __shfl_xor_sync(kFullMask, out[g], 2);
    }
  }
}

// The unit kernel: one block per (tile of R rows, direction), four lanes
// per hidden unit, W_hh in registers (see the notes at the top). Same
// function, rounding points and outputs as bigru_fwd_kernel.
template <typename T, bool kSave, int R>
__global__ void __launch_bounds__(kUnitThreads)
gru_fwd_unit_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                    const T* __restrict__ w_f, const float* __restrict__ b_f,
                    const T* __restrict__ w_b, const float* __restrict__ b_b,
                    T* __restrict__ ys_f, T* __restrict__ ys_b,
                    T* __restrict__ gs_f, T* __restrict__ gs_b,
                    T* __restrict__ hn_f, T* __restrict__ hn_b, int B, int N,
                    int H, int rev) {
  constexpr int KC = 4 / R;                  // k values in one float4 of h
  constexpr int kChunks = kKPerLane / KC;    // float4 loads a lane a step
  // h_{t-1} rounded to T, as [k][R] floats, double buffered; k >= H stays 0
  __shared__ float4 h_s[2][kMaxUnitH * R / 4];
  const int G = 3 * H;

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  const float* b = bwd ? b_b : b_f;
  const int lane = threadIdx.x % kLanes;
  const int u = threadIdx.x / kLanes;  // hidden unit; u >= H pads the warp
  const bool unit_valid = u < H;
  const int uu = unit_valid ? u : 0;
  const int row0 = blockIdx.x * R;

  // this lane's W_hh values: chunk c of the lane covers k = (c * kLanes +
  // lane) * KC + e, e < KC, for the r, z and n columns of unit u
  float wr[3][kKPerLane];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const int k = (c * kLanes + lane) * KC + e;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wr[g][c * KC + e] =
            unit_valid && k < H ? to_f32<T>(w[static_cast<size_t>(k) * G +
                                              g * H + u])
                                : 0.0f;
    }
  float* h_flat = reinterpret_cast<float*>(h_s);
  for (int i = threadIdx.x; i < 2 * kMaxUnitH * R; i += blockDim.x)
    h_flat[i] = 0.0f;
  const float br = b[uu];
  const float bz = b[H + uu];
  const float bn = b[2 * H + uu];

  // the (row, unit) cell this lane updates: row p % R; lanes p < R store it
  const int orow = lane % R;
  const bool cell_valid = unit_valid && row0 + orow < B;
  const bool owner = lane < R && cell_valid;
  const size_t row = static_cast<size_t>(cell_valid ? row0 + orow : 0);
  const size_t xoff = row * N * G + uu;  // xg / gates of (row, t = 0, u)
  const size_t yoff = row * N * H + uu;  // ys / hn of (row, t = 0, u)
  T* ys = bwd ? ys_b : ys_f;
  T* gs = bwd ? gs_b : gs_f;
  T* hns = bwd ? hn_b : hn_f;

  // xg of this lane's cell for the next kAhead steps as loaded, converted
  // when used: a ring indexed by the step's place in an unrolled group, so
  // each load has kAhead steps to land before the chain needs it
  T xq[kAhead][3];
  auto load_x = [&](T (&dst)[3], int s) {
    const T* x = xg + xoff + static_cast<size_t>(bwd ? N - 1 - s : s) * G;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      dst[g] = cell_valid ? x[g * H] : from_f32<T>(0.0f);
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < N) load_x(xq[j], j);
  float h = 0.0f;
  __syncthreads();

  auto step = [&](int s, T (&xs)[3]) {
    const int t = bwd ? N - 1 - s : s;
    float x[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) x[g] = to_f32<T>(xs[g]);
    if (s + kAhead < N) load_x(xs, s + kAhead);

    float acc[3][R];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;
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
          for (int g = 0; g < 3; ++g)
            acc[g][r] = fmaf(hk[e * R + r], wr[g][ch * KC + e], acc[g][r]);
    }
    float hg[3];
    reduce_lanes<R>(acc, hg, lane);

    const float hn = hg[2] + bn;
    const float r = fast_sigmoid(x[0] + (hg[0] + br));
    const float z = fast_sigmoid(x[1] + (hg[1] + bz));
    const float n = fast_tanh(x[2] + r * hn);
    h = (1.0f - z) * n + z * h;
    if (lane < R && unit_valid)
      reinterpret_cast<float*>(h_s[(s + 1) & 1])[u * R + orow] =
          round_to<T>(h);
    if (owner) {
      ys[yoff + static_cast<size_t>(t) * H] = from_f32<T>(h);
      if (kSave) {
        T* gt = gs + xoff + static_cast<size_t>(t) * G;
        gt[0] = from_f32<T>(r);
        gt[H] = from_f32<T>(z);
        gt[2 * H] = from_f32<T>(n);
        hns[yoff + static_cast<size_t>(t) * H] = from_f32<T>(hn);
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

// ---------------------------------------------------------------------------
// The tensor-core kernel (see the notes at the top)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcMaxH = 256;             // W_hh fragments of H <= 256 a warp holds
constexpr int kTcMaxK = kTcMaxH / 16;    // k16 steps of the product at kTcMaxH
constexpr int kTcMaxThreads = 256;       // 8 warps of up to 255 registers
constexpr int kTcPad = 8;                // bf16 padding of an h tile row
// bf16 values of an h tile row, whatever H: the k-steps past H read zero
// columns against zero fragments, so the product has no branch
constexpr int kTcLd = kTcMaxH + kTcPad;

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

// The exchange: each warp writes its slice of a step's tile into its own
// block's buffer, then sends it in 16-byte rows to the other blocks of the
// cluster by st.async, whose bytes complete on the receiving block's
// mbarrier: a step waits only for its own tile, with no fence and no
// cluster barrier (barrier.cluster.arrive.release put a MEMBAR.ALL.GPU on
// every step), and the remote stores move a warp's 8 units of a row at
// once (4-byte pushes of each lane's two units took twice as long).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this block's arrival on its own mbarrier, expecting `bytes` for the phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n\t"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// v into shared::cluster address addr of a block of the cluster, its 16
// bytes completed on that block's mbarrier bar (a shared::cluster address)
__device__ __forceinline__ void st_async16(uint32_t addr, const uint4& v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b for one 16 x 8 tile over a depth of 16: bf16 operands in the
// m16n8k16 fragment layouts, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 values as one 32-bit word, lo in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ float lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 16 bytes from global src to shared dst, of which the first `bytes` are
// read and the rest zero-filled; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The streams' staging in shared memory, as rows [q][R][U + kTcPad] of a
// block's units for each stream q: the step's inputs arrive as 16-byte
// cp.async copies (a ring of kRing steps, kRing - 1 in flight), its outputs
// leave as 16-byte stores a step later (double buffered). A warp's own
// accesses touch 16 bytes of each of 8 rows; through the staging a row's
// U units travel together.
template <int kMT>
__host__ __device__ constexpr int tc_ring() {
  return kMT == 1 ? 4 : 3;
}
constexpr int kTcInStreams = 3;    // xg: r, z, n
constexpr int kTcOutStreams = 5;   // ys, then (kSave) r, z, n and hn

// Both directions (blockIdx.y = 1 walks backward) with bf16 streams, a
// cluster of C blocks per batch tile of R = 16 * kMT rows, U / 8 warps a
// block. Same function, rounding points and outputs as bigru_fwd_kernel.
template <bool kSave, int kMT>
__global__ void __launch_bounds__(kTcMaxThreads, 1)
bigru_fwd_tc_kernel(const bf16* __restrict__ xg_f, const bf16* __restrict__ xg_b,
                    const bf16* __restrict__ w_f, const float* __restrict__ b_f,
                    const bf16* __restrict__ w_b, const float* __restrict__ b_b,
                    bf16* __restrict__ ys_f, bf16* __restrict__ ys_b,
                    bf16* __restrict__ gs_f, bf16* __restrict__ gs_b,
                    bf16* __restrict__ hn_f, bf16* __restrict__ hn_b, int B,
                    int N, int H) {
  constexpr int R = 16 * kMT;
  constexpr int kRing = tc_ring<kMT>();
  constexpr int kOut = kSave ? kTcOutStreams : 1;   // streams a step stores
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint4 tc_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = H / C;
  const int G = 3 * H;
  constexpr int ld = kTcLd;
  const int ldq = U + kTcPad;          // bf16 values of a staged row
  const int nk = H / 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane >> 2;          // the fragments' row (and B's column)
  const int pair = (lane & 3) * 2;     // the fragments' first column (k or n)
  const int lu = warp * 8 + pair;      // the lane's two units in the block
  const int unit = rank * U + lu;      // ... and in the layer
  const bool bwd = blockIdx.y == 1;
  const bf16* xg = bwd ? xg_b : xg_f;
  const bf16* w = bwd ? w_b : w_f;
  const float* b = bwd ? b_b : b_f;
  bf16* ys = bwd ? ys_b : ys_f;
  bf16* gs = bwd ? gs_b : gs_f;
  bf16* hns = bwd ? hn_b : hn_f;
  const int tile_row0 = (blockIdx.x / C) * R;

  // B fragments of the warp's r, z and n columns: word h8 of k-step ks
  // holds W[k][col], W[k + 1][col] for k = ks * 16 + h8 * 8 + pair, col =
  // gate * H + the warp's unit `quad`
  uint32_t bw[3][kTcMaxK][2];
  const int col = rank * U + warp * 8 + quad;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int ks = 0; ks < kTcMaxK; ++ks)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int k = ks * 16 + h8 * 8 + pair;
        const bf16* p = w + static_cast<size_t>(k) * G + g * H + col;
        bw[g][ks][h8] = ks < nk ? pack_bf16(p[0], p[G]) : 0u;
      }
  float bias[3][2];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[g][e] = b[g * H + unit + e];

  // shared memory: the h tile [2][R][ld], the input ring
  // [kRing][3][R][ldq] and the output staging [2][5][R][ldq]
  bf16* tile = reinterpret_cast<bf16*>(tc_smem);
  bf16* ring = tile + 2 * R * ld;
  bf16* stage = ring + kRing * kTcInStreams * R * ldq;
  for (int i = threadIdx.x; i < R * ld; i += blockDim.x)
    reinterpret_cast<uint32_t*>(tile)[i] = 0u;
  const uint32_t tile_addr = smem_addr(tile);
  const uint32_t buf_bytes = static_cast<uint32_t>(R * ld * 2);
  auto t_of = [&](int s) { return bwd ? N - 1 - s : s; };

  // the block's copies: thread i moves chunk i % (U / 8) of staged rows
  // i / (U / 8) + 32 j (the block's 4U threads cover 32 rows a pass)
  const int cpr = U / 8;
  const int chunk = static_cast<int>(threadIdx.x) % cpr;
  const int row_in_pass = static_cast<int>(threadIdx.x) / cpr;
  auto load = [&](int s) {   // the inputs of step s into its ring slot
    if (s < N) {
      const int t = t_of(s);
      const uint32_t slot =
          smem_addr(ring + (s % kRing) * kTcInStreams * R * ldq);
#pragma unroll
      for (int pass = 0; pass < (kTcInStreams * R + 31) / 32; ++pass) {
        const int qr = pass * 32 + row_in_pass;
        if (qr < kTcInStreams * R) {
          const int q = qr / R, r = qr % R;
          const int row = tile_row0 + r;
          const bf16* src = xg + (static_cast<size_t>(row < B ? row : 0) * N +
                                  t) * G + q * H + rank * U + chunk * 8;
          cp_async16(slot + ((q * R + r) * ldq + chunk * 8) * 2, src,
                     row < B ? 16 : 0);
        }
      }
    }
    cp_async_commit();   // one group a step, empty or not
  };
  auto flush = [&](int s) {   // the outputs of step s from its staging
    const int t = t_of(s);
    const bf16* st = stage + (s & 1) * kTcOutStreams * R * ldq;
#pragma unroll
    for (int pass = 0; pass < (kOut * R + 31) / 32; ++pass) {
      const int qr = pass * 32 + row_in_pass;
      const int q = qr / R, r = qr % R;
      const int row = tile_row0 + r;
      if (qr < kOut * R && row < B) {
        const size_t cell = static_cast<size_t>(row) * N + t;
        bf16* dst = q == 0 ? ys + cell * H
                  : q < 4  ? gs + cell * G + (q - 1) * H
                           : hns + cell * H;
        *reinterpret_cast<uint4*>(dst + rank * U + chunk * 8) =
            *reinterpret_cast<const uint4*>(st + (q * R + r) * ldq +
                                            chunk * 8);
      }
    }
  };
  for (int j = 0; j < kRing - 1; ++j) load(j);

  float h[kMT][2][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) h[mt][hr][0] = h[mt][hr][1] = 0.0f;

  // full[b] counts the bytes of h landing in buffer b: step s reads buffer
  // s & 1 (h_{s-1}; zeros at step 0), and the phase a step s > 0 waits for
  // is the ((s - 1) / 2)-th of full[s & 1]. Armed two steps ahead.
  __shared__ __align__(8) uint64_t full[2];
  const uint32_t bar = smem_addr(full);
  // the bytes the other blocks send into a buffer each step
  const uint32_t tile_tx = static_cast<uint32_t>(R * (H - U) * 2);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_expect(bar + 8, tile_tx);              // h_0, read at step 1
    if (N > 2) mbar_expect(bar, tile_tx);       // h_1, read at step 2
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // every block of the cluster runs and holds a zero h_{-1} and its
  // mbarriers before any block writes into another's shared memory
  cluster.sync();

  for (int s = 0; s < N; ++s) {
    // this step's inputs have landed (this thread's copies, then every
    // thread's), every thread is done with the previous step's ring slot
    // and staging; the previous step's outputs leave, this slot refills
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (s > 0) flush(s - 1);
    load(s + kRing - 1);
    if (s > 0) {   // h_{t-1} of every block has landed
      mbar_wait(bar + (s & 1) * 8, ((s - 1) >> 1) & 1);
      if (threadIdx.x == 0 && s + 2 < N) mbar_expect(bar + (s & 1) * 8, tile_tx);
    }

    // pre-activations T(h_{t-1}) @ T(W_hh[:, r|z|n of the warp's units]):
    // even and odd k-steps in two accumulators
    float acc[2][kMT][3][4];
#pragma unroll
    for (int a2 = 0; a2 < 2; ++a2)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a2][mt][g][e] = 0.0f;
    const uint32_t hb = tile_addr + (s & 1) * buf_bytes;
#pragma unroll
    for (int ks = 0; ks < kTcMaxK; ++ks) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // lane l addresses row l % 16, k half l / 16 of the 16 x 16 tile
        uint32_t a[4];
        ldmatrix_x4(a, hb + ((mt * 16 + (lane & 15)) * ld + ks * 16 +
                             (lane >> 4) * 8) * 2);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          mma_bf16(acc[ks & 1][mt][g], a, bw[g][ks][0], bw[g][ks][1]);
      }
    }

    // element e of an accumulator is (row quad + (e / 2) * 8, unit pair +
    // e % 2): the lane's cells; their inputs from the ring, their outputs
    // into the staging
    const bf16* in = ring + (s % kRing) * kTcInStreams * R * ldq;
    bf16* out = stage + (s & 1) * kTcOutStreams * R * ldq;
    uint32_t hy[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int cell = (mt * 16 + quad + hr * 8) * ldq + lu;
        uint32_t x[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          x[g] = *reinterpret_cast<const uint32_t*>(in + g * R * ldq + cell);
        float vr[2], vz[2], vn[2], vhn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = hr * 2 + e;
          const float pr = acc[0][mt][0][i] + acc[1][mt][0][i];
          const float pz = acc[0][mt][1][i] + acc[1][mt][1][i];
          const float pn = acc[0][mt][2][i] + acc[1][mt][2][i];
          const float xr = e ? hi_f32(x[0]) : lo_f32(x[0]);
          const float xz = e ? hi_f32(x[1]) : lo_f32(x[1]);
          const float xn = e ? hi_f32(x[2]) : lo_f32(x[2]);
          const float hn = pn + bias[2][e];
          const float r = fast_sigmoid(xr + (pr + bias[0][e]));
          const float z = fast_sigmoid(xz + (pz + bias[1][e]));
          const float n = fast_tanh(xn + r * hn);
          h[mt][hr][e] = (1.0f - z) * n + z * h[mt][hr][e];
          vr[e] = r;
          vz[e] = z;
          vn[e] = n;
          vhn[e] = hn;
        }
        hy[mt][hr] = pack_f32(h[mt][hr][0], h[mt][hr][1]);
        const uint32_t words[kTcOutStreams] = {
            hy[mt][hr], pack_f32(vr[0], vr[1]), pack_f32(vz[0], vz[1]),
            pack_f32(vn[0], vn[1]), pack_f32(vhn[0], vhn[1])};
#pragma unroll
        for (int q = 0; q < kOut; ++q)
          *reinterpret_cast<uint32_t*>(out + q * R * ldq + cell) = words[q];
      }

    // T(h_t) into the other buffer of this block (seen by its warps after
    // the next step's __syncthreads), then the warp's rows of it (8 units,
    // 16 bytes) into that buffer of every other block of the cluster; the
    // last step's h_t is read by no step
    const uint32_t nb = tile_addr + ((s + 1) & 1) * buf_bytes;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        st_shared(nb + ((mt * 16 + quad + hr * 8) * ld + unit) * 2,
                  hy[mt][hr]);
    __syncwarp();
    if (s + 1 < N && lane < R) {
      const uint32_t off = nb + (lane * ld + rank * U + warp * 8) * 2;
      const uint4 v = ld_shared16(off);
      const uint32_t nbar = bar + ((s + 1) & 1) * 8;
      for (int q = 0; q < C; ++q)
        if (q != rank) st_async16(cluster_addr(off, q), v, cluster_addr(nbar, q));
    }
  }
  __syncthreads();
  flush(N - 1);
  // no block exits while another may still write into it
  cluster.sync();
}

// The tensor-core kernel's dynamic shared memory (the h tile, double
// buffered, the input ring and the output staging), threads and W_hh
// fragment registers a lane holds (the wrapper's tc_smem_bytes("fwd", ...),
// tc_threads and TC_WEIGHT_REGS mirror them, held to this source by
// bigru_fwd_tc_layout).
size_t tc_smem_bytes(int H, int C, int R) {
  const size_t ldq = static_cast<size_t>(H / C) + kTcPad;
  const size_t ring = R == 16 ? tc_ring<1>() : tc_ring<2>();
  return (2 * static_cast<size_t>(R) * kTcLd +
          (ring * kTcInStreams + 2 * kTcOutStreams) * R * ldq) * sizeof(bf16);
}
constexpr int tc_threads(int H, int C) { return 4 * (H / C); }
constexpr int kTcWeightRegs = 3 * kTcMaxK * 2;

// H a multiple of 16 up to kTcMaxH, the cluster dividing H into a whole
// number of 8-unit warps, at most kTcMaxThreads threads a block, and one
// or two m16 tiles of rows.
bool valid_tc_plan(int B, int N, int H, int C, int R) {
  return B > 0 && N > 0 && H > 0 && H % 16 == 0 && H <= kTcMaxH &&
         (C == 1 || C == 2 || C == 4 || C == 8) && H % C == 0 &&
         (H / C) % 8 == 0 && tc_threads(H, C) <= kTcMaxThreads &&
         (R == 16 || R == 32);
}

template <bool kSave, int kMT>
cudaError_t allow_tc_smem(int smem) {
  static std::atomic<int> allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bigru_fwd_tc_kernel<kSave, kMT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices) allowed[device].store(smem);
  return err;
}

template <bool kSave, int kMT>
int launch_tc_as(const void* xg_f, const void* xg_b, const void* w_f,
                 const float* b_f, const void* w_b, const float* b_b,
                 void* ys_f, void* ys_b, void* gs_f, void* gs_b, void* hn_f,
                 void* hn_b, int B, int N, int H, int C, void* stream) {
  constexpr int R = 16 * kMT;
  const size_t smem = tc_smem_bytes(H, C, R);
  cudaError_t err = allow_tc_smem<kSave, kMT>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(C * ((B + R - 1) / R), 2, 1);
  cfg.blockDim = dim3(tc_threads(H, C), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  err = cudaLaunchKernelEx(&cfg, bigru_fwd_tc_kernel<kSave, kMT>, in(xg_f),
                           in(xg_b), in(w_f), b_f, in(w_b), b_b, out(ys_f),
                           out(ys_b), out(gs_f), out(gs_b), out(hn_f),
                           out(hn_b), B, N, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSave>
int launch_tc(const void* xg_f, const void* xg_b, const void* w_f,
              const float* b_f, const void* w_b, const float* b_b, void* ys_f,
              void* ys_b, void* gs_f, void* gs_b, void* hn_f, void* hn_b,
              int B, int N, int H, int C, int R, void* stream) {
  if (!valid_tc_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  return (R == 16 ? launch_tc_as<kSave, 1> : launch_tc_as<kSave, 2>)(
      xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b, gs_f, gs_b, hn_f, hn_b, B,
      N, H, C, stream);
}

template <bool kSave, int kMT>
int tc_max_active_clusters_as(int H, int C) {
  const size_t smem = tc_smem_bytes(H, C, 16 * kMT);
  cudaError_t err = allow_tc_smem<kSave, kMT>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(tc_threads(H, C), 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bigru_fwd_tc_kernel<kSave, kMT>,
                                       &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The units a block of a cluster of C owns: ceil(H / C), the last block's
// slice masked past H where C does not divide H.
int cluster_units(int H, int C) { return (H + C - 1) / C; }

// Dynamic shared memory one block needs, in bytes (the wrapper's
// bigru_smem_bytes("fwd", ...) mirrors it to pick the cluster size, held
// to bigru_fwd_smem_bytes when the library loads).
size_t smem_bytes(int H, int C, int R) {
  const size_t U = static_cast<size_t>(cluster_units(H, C));
  return (pad4(static_cast<size_t>(H) * 3 * U) +
          2 * static_cast<size_t>(H) * R) * sizeof(float);
}

// C in 1, 2, 4, 8 with every block owning one unit at least (a slice of
// ceil(H / C) units, the last one masked where C does not divide H), R a
// multiple of kRowsPerThread, at most kMaxThreads threads
bool valid_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || (C != 1 && C != 2 && C != 4 && C != 8) ||
      R <= 0 || R % kRowsPerThread != 0)
    return false;
  const int U = cluster_units(H, C);
  return (C - 1) * U < H && U * (R / kRowsPerThread) <= kMaxThreads;
}

// The stream kernel's shared memory (the h tile alone, its rows padded to
// whole chunks of kStreamK) and plan rule: any H, a cluster of 1 to
// kStreamMaxC blocks each owning a unit at least, R a multiple of
// kRowsPerThread, at most kMaxThreads threads and kMaxSmem bytes a block
// (the wrapper's stream_smem_bytes and _stream_rule mirror them, held to
// bigru_fwd_stream_smem_bytes when the library loads).
size_t stream_smem_bytes(int H, int R) {
  return 2 * static_cast<size_t>(pad_stream(H)) * R * sizeof(float);
}

bool valid_stream_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || C < 1 || C > kStreamMaxC || R <= 0 ||
      R % kRowsPerThread != 0)
    return false;
  const int U = cluster_units(H, C);
  return (C - 1) * U < H && U * (R / kRowsPerThread) <= kMaxThreads &&
         stream_smem_bytes(H, R) <= static_cast<size_t>(kMaxSmem);
}

template <bool kStream>
bool valid_plan_of(int B, int N, int H, int C, int R) {
  return kStream ? valid_stream_plan(B, N, H, C, R)
                 : valid_plan(B, N, H, C, R);
}

template <bool kStream>
size_t smem_of(int H, int C, int R) {
  return kStream ? stream_smem_bytes(H, R) : smem_bytes(H, C, R);
}

// Dynamic shared memory each variant is already allowed on each device, so
// the attribute is set once per device (and again only for a larger size);
// the stream kernel also takes clusters above 8 blocks.
template <typename T, bool kSave, bool kStream>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T, bool kSave, bool kStream>
cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices &&
      g_smem_allowed<T, kSave, kStream>[device].load() >= smem)
    return cudaSuccess;
  if constexpr (kStream) {
    err = cudaFuncSetAttribute(bigru_fwd_kernel<T, kSave, kStream>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(bigru_fwd_kernel<T, kSave, kStream>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<T, kSave, kStream>[device].store(smem);
  return err;
}

void make_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B,
                 int H, int C, int R, int dirs, size_t smem, void* stream) {
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

template <typename T, bool kSave, bool kStream = false>
int launch(const void* xg_f, const void* xg_b, const void* w_f,
           const float* b_f, const void* w_b, const float* b_b, void* ys_f,
           void* ys_b, void* gs_f, void* gs_b, void* hn_f, void* hn_b, int B,
           int N, int H, int C, int R, int dirs, int rev, void* stream) {
  if (!valid_plan_of<kStream>(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of<kStream>(H, C, R);
  cudaError_t err = allow_smem<T, kSave, kStream>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, B, H, C, R, dirs, smem, stream);
  err = cudaLaunchKernelEx(
      &cfg, bigru_fwd_kernel<T, kSave, kStream>,
      static_cast<const T*>(xg_f),
      static_cast<const T*>(xg_b), static_cast<const T*>(w_f), b_f,
      static_cast<const T*>(w_b), b_b, static_cast<T*>(ys_f),
      static_cast<T*>(ys_b), static_cast<T*>(gs_f), static_cast<T*>(gs_b),
      static_cast<T*>(hn_f), static_cast<T*>(hn_b), B, N, H, R, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSave, bool kStream = false>
int max_active_clusters(int H, int C, int R) {
  const size_t smem = smem_of<kStream>(H, C, R);
  cudaError_t err = allow_smem<T, kSave, kStream>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, R, H, C, R, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, bigru_fwd_kernel<T, kSave, kStream>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The unit kernel's static shared memory (the h tile, double buffered) and
// threads: four lanes for each of H units, padded to whole warps (the
// wrapper's gru_unit_smem_bytes and unit_threads mirror them).
constexpr size_t unit_smem_bytes(int R) {
  return 2 * static_cast<size_t>(kMaxUnitH) * R * sizeof(float);
}
constexpr int unit_threads(int H) { return kLanes * ((H + 7) / 8 * 8); }

bool valid_unit_plan(int B, int N, int H, int R) {
  return B > 0 && N > 0 && H > 0 && H <= kMaxUnitH &&
         (R == 1 || R == 2 || R == 4);
}

template <typename T, bool kSave>
const void* unit_kernel(int R) {
  if (R == 1) return reinterpret_cast<const void*>(
      gru_fwd_unit_kernel<T, kSave, 1>);
  if (R == 2) return reinterpret_cast<const void*>(
      gru_fwd_unit_kernel<T, kSave, 2>);
  return reinterpret_cast<const void*>(gru_fwd_unit_kernel<T, kSave, 4>);
}

// A grid of `dirs` directions (2: both of a BiGRU layer, y = 1 the
// backward one; 1: the direction rev says).
template <typename T, bool kSave>
int launch_unit(const void* xg_f, const void* xg_b, const void* w_f,
                const float* b_f, const void* w_b, const float* b_b,
                void* ys_f, void* ys_b, void* gs_f, void* gs_b, void* hn_f,
                void* hn_b, int B, int N, int H, int R, int dirs, int rev,
                void* stream) {
  if (!valid_unit_plan(B, N, H, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + R - 1) / R, dirs);
  const int threads = unit_threads(H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  if (R == 1)
    gru_fwd_unit_kernel<T, kSave, 1><<<grid, threads, 0, st>>>(
        in(xg_f), in(xg_b), in(w_f), b_f, in(w_b), b_b, out(ys_f),
        out(ys_b), out(gs_f), out(gs_b), out(hn_f), out(hn_b), B, N, H, rev);
  else if (R == 2)
    gru_fwd_unit_kernel<T, kSave, 2><<<grid, threads, 0, st>>>(
        in(xg_f), in(xg_b), in(w_f), b_f, in(w_b), b_b, out(ys_f),
        out(ys_b), out(gs_f), out(gs_b), out(hn_f), out(hn_b), B, N, H, rev);
  else
    gru_fwd_unit_kernel<T, kSave, 4><<<grid, threads, 0, st>>>(
        in(xg_f), in(xg_b), in(w_f), b_f, in(w_b), b_b, out(ys_f),
        out(ys_b), out(gs_f), out(gs_b), out(hn_f), out(hn_b), B, N, H, rev);
  return static_cast<int>(cudaGetLastError());
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
// device, with clusters of C blocks over batch tiles of R rows (R a
// multiple of 4; each block owns ceil(H / C) units, the last block's slice
// masked past H). Streams are contiguous float (_f32) or bfloat16
// (_bf16): xg_* [B, N, 3H], w_* [H, 3H] already in the stream type, ys_*
// [B, N, H]; b_* [3H] is float. Returns a cudaError_t code; 0 means the
// launch was accepted.
int bigru_fwd_f32(const void* xg_f, const void* xg_b, const void* w_f,
                  const float* b_f, const void* w_b, const float* b_b,
                  void* ys_f, void* ys_b, int B, int N, int H, int C, int R,
                  void* stream) {
  return launch<float, false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b,
                              nullptr, nullptr, nullptr, nullptr, B, N, H, C,
                              R, 2, 0, stream);
}

int bigru_fwd_bf16(const void* xg_f, const void* xg_b, const void* w_f,
                   const float* b_f, const void* w_b, const float* b_b,
                   void* ys_f, void* ys_b, int B, int N, int H, int C, int R,
                   void* stream) {
  return launch<__nv_bfloat16, false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,
                                      ys_b, nullptr, nullptr, nullptr,
                                      nullptr, B, N, H, C, R, 2, 0, stream);
}

// As bigru_fwd_*, and also writes the residuals of every step: gs_*
// [B, N, 3H] (activated r, z, n) and hn_* [B, N, H], in the stream type.
int bigru_fwd_train_f32(const void* xg_f, const void* xg_b, const void* w_f,
                        const float* b_f, const void* w_b, const float* b_b,
                        void* ys_f, void* ys_b, void* gs_f, void* gs_b,
                        void* hn_f, void* hn_b, int B, int N, int H, int C,
                        int R, void* stream) {
  return launch<float, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b,
                             gs_f, gs_b, hn_f, hn_b, B, N, H, C, R, 2, 0,
                             stream);
}

int bigru_fwd_train_bf16(const void* xg_f, const void* xg_b, const void* w_f,
                         const float* b_f, const void* w_b, const float* b_b,
                         void* ys_f, void* ys_b, void* gs_f, void* gs_b,
                         void* hn_f, void* hn_b, int B, int N, int H, int C,
                         int R, void* stream) {
  return launch<__nv_bfloat16, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,
                                     ys_b, gs_f, gs_b, hn_f, hn_b, B, N, H, C,
                                     R, 2, 0, stream);
}

// The tensor-core kernel (bf16 streams, both directions): arguments and
// outputs as bigru_fwd_bf16 / bigru_fwd_train_bf16, with clusters of C
// blocks (C in 1, 2, 4, 8 dividing H into a whole number of 8-unit warps,
// at most 256 threads) over batch tiles of R = 16 or 32 rows; H a multiple
// of 16 up to 256.
int bigru_fwd_tc_bf16(const void* xg_f, const void* xg_b, const void* w_f,
                      const float* b_f, const void* w_b, const float* b_b,
                      void* ys_f, void* ys_b, int B, int N, int H, int C,
                      int R, void* stream) {
  return launch_tc<false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b,
                          nullptr, nullptr, nullptr, nullptr, B, N, H, C, R,
                          stream);
}

int bigru_fwd_train_tc_bf16(const void* xg_f, const void* xg_b,
                            const void* w_f, const float* b_f,
                            const void* w_b, const float* b_b, void* ys_f,
                            void* ys_b, void* gs_f, void* gs_b, void* hn_f,
                            void* hn_b, int B, int N, int H, int C, int R,
                            void* stream) {
  return launch_tc<true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b, gs_f,
                         gs_b, hn_f, hn_b, B, N, H, C, R, stream);
}

// How many clusters of the tensor-core kernel (save: 0 or 1) at hidden size
// H, cluster size C and tile R the current device runs at once; a negative
// cudaError_t code on failure.
int bigru_fwd_tc_max_active_clusters(int save, int H, int C, int R) {
  if (!valid_tc_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (R == 16)
    return save ? tc_max_active_clusters_as<true, 1>(H, C)
                : tc_max_active_clusters_as<false, 1>(H, C);
  return save ? tc_max_active_clusters_as<true, 2>(H, C)
              : tc_max_active_clusters_as<false, 2>(H, C);
}

// The tensor-core kernel's layout at H, C and R, for the wrapper's mirror:
// what 0 = dynamic shared memory in bytes, 1 = threads a block, 2 = W_hh
// fragment registers a lane holds; -1 for a plan it does not take.
int bigru_fwd_tc_layout(int what, int H, int C, int R) {
  if (!valid_tc_plan(1, 1, H, C, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(tc_smem_bytes(H, C, R));
    case 1: return tc_threads(H, C);
    case 2: return kTcWeightRegs;
    default: return -1;
  }
}

// One direction of a GRU: as bigru_fwd_* with a grid of one direction over
// xg [B, N, 3H], w [H, 3H], b [3H] into ys [B, N, H]; reverse != 0 walks
// t = N-1 .. 0. The cluster count of bigru_fwd_max_active_clusters holds.
int gru_fwd_f32(const void* xg, const void* w, const float* b, void* ys,
                int B, int N, int H, int C, int R, int reverse,
                void* stream) {
  return launch<float, false>(xg, xg, w, b, w, b, ys, ys, nullptr, nullptr,
                              nullptr, nullptr, B, N, H, C, R, 1, reverse,
                              stream);
}

int gru_fwd_bf16(const void* xg, const void* w, const float* b, void* ys,
                 int B, int N, int H, int C, int R, int reverse,
                 void* stream) {
  return launch<__nv_bfloat16, false>(xg, xg, w, b, w, b, ys, ys, nullptr,
                                      nullptr, nullptr, nullptr, B, N, H, C,
                                      R, 1, reverse, stream);
}

// As gru_fwd_*, and also writes gs [B, N, 3H] and hn [B, N, H].
int gru_fwd_train_f32(const void* xg, const void* w, const float* b,
                      void* ys, void* gs, void* hn, int B, int N, int H,
                      int C, int R, int reverse, void* stream) {
  return launch<float, true>(xg, xg, w, b, w, b, ys, ys, gs, gs, hn, hn, B,
                             N, H, C, R, 1, reverse, stream);
}

int gru_fwd_train_bf16(const void* xg, const void* w, const float* b,
                       void* ys, void* gs, void* hn, int B, int N, int H,
                       int C, int R, int reverse, void* stream) {
  return launch<__nv_bfloat16, true>(xg, xg, w, b, w, b, ys, ys, gs, gs, hn,
                                     hn, B, N, H, C, R, 1, reverse, stream);
}

// The unit kernel (H <= 64), batch tiles of R rows (1, 2 or 4): both
// directions of a BiGRU layer (bigru_fwd_unit_*, bigru_fwd_unit_train_*:
// arguments and outputs as bigru_fwd_* and bigru_fwd_train_* without the
// cluster size) or one direction of a GRU (gru_fwd_unit_*,
// gru_fwd_unit_train_*: as gru_fwd_* and gru_fwd_train_*).
#define GRU_FWD_UNIT_ENTRIES(SFX, TYPE)                                       \
  int bigru_fwd_unit_##SFX(const void* xg_f, const void* xg_b,               \
                           const void* w_f, const float* b_f,                \
                           const void* w_b, const float* b_b, void* ys_f,    \
                           void* ys_b, int B, int N, int H, int R,           \
                           void* stream) {                                   \
    return launch_unit<TYPE, false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,    \
                                    ys_b, nullptr, nullptr, nullptr,         \
                                    nullptr, B, N, H, R, 2, 0, stream);      \
  }                                                                          \
  int bigru_fwd_unit_train_##SFX(                                            \
      const void* xg_f, const void* xg_b, const void* w_f, const float* b_f, \
      const void* w_b, const float* b_b, void* ys_f, void* ys_b, void* gs_f, \
      void* gs_b, void* hn_f, void* hn_b, int B, int N, int H, int R,        \
      void* stream) {                                                        \
    return launch_unit<TYPE, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,     \
                                   ys_b, gs_f, gs_b, hn_f, hn_b, B, N, H, R, \
                                   2, 0, stream);                            \
  }                                                                          \
  int gru_fwd_unit_##SFX(const void* xg, const void* w, const float* b,      \
                         void* ys, int B, int N, int H, int R, int reverse,  \
                         void* stream) {                                     \
    return launch_unit<TYPE, false>(xg, xg, w, b, w, b, ys, ys, nullptr,     \
                                    nullptr, nullptr, nullptr, B, N, H, R,   \
                                    1, reverse, stream);                     \
  }                                                                          \
  int gru_fwd_unit_train_##SFX(const void* xg, const void* w, const float* b, \
                               void* ys, void* gs, void* hn, int B, int N,   \
                               int H, int R, int reverse, void* stream) {    \
    return launch_unit<TYPE, true>(xg, xg, w, b, w, b, ys, ys, gs, gs, hn,   \
                                   hn, B, N, H, R, 1, reverse, stream);      \
  }

GRU_FWD_UNIT_ENTRIES(f32, float)
GRU_FWD_UNIT_ENTRIES(bf16, __nv_bfloat16)
#undef GRU_FWD_UNIT_ENTRIES

// The stream kernel: arguments and outputs as bigru_fwd_*,
// bigru_fwd_train_*, gru_fwd_* and gru_fwd_train_*, with clusters of C = 1
// .. 16 blocks over batch tiles of R rows (a multiple of 4); any H whose
// plan fits.
#define GRU_FWD_STREAM_ENTRIES(SFX, TYPE)                                     \
  int bigru_fwd_stream_##SFX(const void* xg_f, const void* xg_b,             \
                             const void* w_f, const float* b_f,              \
                             const void* w_b, const float* b_b, void* ys_f,  \
                             void* ys_b, int B, int N, int H, int C, int R,  \
                             void* stream) {                                 \
    return launch<TYPE, false, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,   \
                                     ys_b, nullptr, nullptr, nullptr,        \
                                     nullptr, B, N, H, C, R, 2, 0, stream);  \
  }                                                                          \
  int bigru_fwd_train_stream_##SFX(                                          \
      const void* xg_f, const void* xg_b, const void* w_f, const float* b_f, \
      const void* w_b, const float* b_b, void* ys_f, void* ys_b, void* gs_f, \
      void* gs_b, void* hn_f, void* hn_b, int B, int N, int H, int C, int R, \
      void* stream) {                                                        \
    return launch<TYPE, true, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,    \
                                    ys_b, gs_f, gs_b, hn_f, hn_b, B, N, H,   \
                                    C, R, 2, 0, stream);                     \
  }                                                                          \
  int gru_fwd_stream_##SFX(const void* xg, const void* w, const float* b,    \
                           void* ys, int B, int N, int H, int C, int R,      \
                           int reverse, void* stream) {                      \
    return launch<TYPE, false, true>(xg, xg, w, b, w, b, ys, ys, nullptr,    \
                                     nullptr, nullptr, nullptr, B, N, H, C,  \
                                     R, 1, reverse, stream);                 \
  }                                                                          \
  int gru_fwd_train_stream_##SFX(const void* xg, const void* w,              \
                                 const float* b, void* ys, void* gs,         \
                                 void* hn, int B, int N, int H, int C,       \
                                 int R, int reverse, void* stream) {         \
    return launch<TYPE, true, true>(xg, xg, w, b, w, b, ys, ys, gs, gs, hn,  \
                                    hn, B, N, H, C, R, 1, reverse, stream);  \
  }

GRU_FWD_STREAM_ENTRIES(f32, float)
GRU_FWD_STREAM_ENTRIES(bf16, __nv_bfloat16)
#undef GRU_FWD_STREAM_ENTRIES

// How many clusters of the stream kernel (bf16: 0 or 1, save: 0 or 1) at
// H, C and R the current device runs at once; a negative cudaError_t code
// on failure.
int bigru_fwd_stream_max_active_clusters(int bf16, int save, int H, int C,
                                         int R) {
  if (!valid_stream_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? max_active_clusters<__nv_bfloat16, true, true>(H, C, R)
                : max_active_clusters<__nv_bfloat16, false, true>(H, C, R);
  return save ? max_active_clusters<float, true, true>(H, C, R)
              : max_active_clusters<float, false, true>(H, C, R);
}

// The stream kernel's dynamic shared memory in bytes at H, C and R, for the
// wrapper's mirror; -1 for a plan it does not take.
int bigru_fwd_stream_smem_bytes(int H, int C, int R) {
  if (!valid_stream_plan(1, 1, H, C, R)) return -1;
  return static_cast<int>(stream_smem_bytes(H, R));
}

// How many blocks of the unit kernel (bf16: 0 or 1, save: 0 or 1) at hidden
// size H and tile R one SM of the current device runs at once; a negative
// cudaError_t code on failure.
int gru_fwd_unit_blocks_per_sm(int bf16, int save, int H, int R) {
  if (!valid_unit_plan(1, 1, H, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? unit_blocks_per_sm<__nv_bfloat16, true>(H, R)
                : unit_blocks_per_sm<__nv_bfloat16, false>(H, R);
  return save ? unit_blocks_per_sm<float, true>(H, R)
              : unit_blocks_per_sm<float, false>(H, R);
}

// The unit kernel's layout at hidden size H and tile R, for the wrapper's
// mirror: what 0 = static shared memory in bytes, 1 = threads a block, 2 =
// W_hh values a lane holds in registers; -1 for a plan it does not take.
int gru_fwd_unit_layout(int what, int H, int R) {
  if (!valid_unit_plan(1, 1, H, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(unit_smem_bytes(R));
    case 1: return unit_threads(H);
    case 2: return 3 * kKPerLane;
    default: return -1;
  }
}

// How many clusters of this variant (bf16: 0 or 1, save: 0 or 1) the
// current device runs at once; a negative cudaError_t code on failure.
int bigru_fwd_max_active_clusters(int bf16, int save, int H, int C, int R) {
  if (!valid_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? max_active_clusters<__nv_bfloat16, true>(H, C, R)
                : max_active_clusters<__nv_bfloat16, false>(H, C, R);
  return save ? max_active_clusters<float, true>(H, C, R)
              : max_active_clusters<float, false>(H, C, R);
}

// The cluster kernel's dynamic shared memory in bytes at H, C and R, for
// the wrapper's mirror (bigru_smem_bytes("fwd", ...)); -1 for a plan it
// does not take.
int bigru_fwd_smem_bytes(int H, int C, int R) {
  if (!valid_plan(1, 1, H, C, R)) return -1;
  return static_cast<int>(smem_bytes(H, C, R));
}

const char* bigru_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
