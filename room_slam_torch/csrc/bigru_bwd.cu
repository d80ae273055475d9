// Fused GRU recurrence, backward (BPTT), float32 or bfloat16 streams, with
// W_hh^T split across the blocks of a thread-block cluster. One source,
// three kinds of one kernel (a template switch, one copy of the chain) and
// two grids: both directions of a BiGRU layer (bigru_bwd_*,
// bigru_bwd_split_*, bigru_bwd_fused_*), or one direction of a GRU
// (gru_bwd_*, with a reverse flag).
//
// Replaces four TPU kernels:
// - room_slam_tpu/ops/gru_pallas.py::_bigru_bwd_kernel (:357, pallas_call
//   :527, launched through _bigru_bwd_pallas from _bigru_core_bwd): the
//   linearized kind (kLinear) with the grid's two directions;
// - _gru_bwd_kernel (:71, pallas_call :218, launched through
//   _gru_bwd_pallas from _gru_core_bwd): at H <= 64 the unit kernel
//   (gru_bwd_unit_kernel, below), above it kLinear with a grid of one
//   direction;
// - room_slam_tpu/tools/bench_bigru_bwd.py::_bwd_kernel_split (:127,
//   pallas_call :198, a closure of the micro-benchmark's main()): #6's
//   kernels with the kSplitCoef switch (the tensor-core and unit kernels
//   here, bigru_bwd_reg.cu, bigru_pipe.cu); its first design, the split
//   kind (kSplit) of the cluster kernel, by a forced plan;
// - gru_pallas.py::_bigru_bwd_fused_kernel (:646, pallas_call :784,
//   launched through _bigru_bwd_fused_pallas from _bigru_layer_core_bwd,
//   reached by bigru_layer_pallas): the fused layer VJP (kFused).
//
// From the residuals of the training forward (bigru_fwd.cu, kSave:
// activated gates r, z, n, hn = W_hn h + b_hn, and ys) every kind walks
// each direction in reverse of its forward order and emits, per direction,
// dx [B, N, 3H] (the cotangent of the gate stream xg) and dhn [B, N, H].
// With T() the rounding to the stream type and h_prev the output one step
// earlier in the forward order (zero at its first step):
//
// kLinear and kFused, the linearized coefficients of the reference
// (gru_pallas.py:374-384):
//
//   a   = (1 - z) * (1 - n^2)
//   c   = T([a * hn * r * (1 - r), (h_prev - n) * z * (1 - z), a])
//   dh_t = dy_t + dh_carry
//   dx   = [dh_t, dh_t, dh_t] * c                 (stored as T)
//   dhn  = dx_n * r                               (stored as T)
//   dh_carry = dh_t * z + T([dx_r, dx_z, dhn]) @ T(W_hh)^T   (f32 sums, two
//              interleaved partial sums over the whole 3H)
//
// kSplit (#10), from the gates without pre-rounded coefficients
// (bench_bigru_bwd.py:140-159):
//
//   dn_pre = dh_t (1 - z)(1 - n^2),  dr_pre = dn_pre hn r (1 - r)
//   dz_pre = dh_t (h_prev - n) z (1 - z),  dhn = dn_pre r
//   dx = [dr_pre, dz_pre, dn_pre], dhn         (stored as T)
//   dh_carry = ((dh_t z + T(dr_pre) . T(W_r)^T) + T(dz_pre) . T(W_z)^T)
//              + T(dhn) . T(W_n)^T              (three H-deep f32 sums)
//
// kFused (both directions only) is kLinear's chain, and in the same launch
// the input-side gradients of the layer (gru_pallas.py:704-730), with x the
// layer input [B, N, D] and W_ih [D, 3H] in T:
//
//   dX_t  = T(T(dx_t) @ T(W_ih)^T)                [R, D] per step, stored
//   dW_hh += T(h_prev)^T T([dx_r, dx_z, dhn])     f32 sums
//   dW_ih += T(x_t)^T T(dx_t)                     f32 sums
//   db_ih += sum_rows dx_t,  db_hh += sum_rows [dx_r, dx_z, dhn]
//                                                 (unrounded f32 values)
//
// The forward direction walks t = N-1 .. 0; the backward-in-time direction
// (and a single-direction GRU run with reverse) walks t = 0 .. N-1 and takes
// h_prev from t + 1. All arrays are in original time order.
//
// What bounds it on an H100. At the scale-up shape (B=128, N=5000, H=256,
// bf16) kLinear and kSplit read 3H + H + H + H and write 3H + H values per
// (row, step) and direction, 6.6 GB for both directions (1.96 ms at 3.35
// TB/s), and do 2 * 3H * H multiply-adds per (row, step) and direction for
// dg @ W_hh^T, 504 GFLOP for both (0.51 ms at 989 TFLOP/s for bf16
// operands). kFused also reads x and writes dX (D = 512: 2.6 GB more) and
// does three more products, dX, dW_ih (2 * 3H * D each) and dW_hh
// (2 * 3H * H) per (row, step) and direction: 2.5 TFLOP more, 3.0 in all
// (3.05 ms at the bf16 rate, which the CUDA cores used here do not reach:
// 67 TFLOP/s for f32 FMAs makes it 45 ms). At the legacy GRU shape (one
// direction, B=32, N=500, H=64, f32) kLinear moves 41 MB (12.2 us) and does
// 0.39 GFLOP (5.9 us at 67 TFLOP/s). The real floor of the chain is the
// serial walk of 5000 (500) dependent steps, each a 768-deep (192-deep) dot
// product per (row, unit); measured on an H100 a kLinear step takes 18.5 us,
// by the look of it bound by shared-memory loads: per j, one W load and one
// 128-bit broadcast load of four rows of dg feed four FMAs (see
// bigru_fwd.cu).
//
// What the design does about it. W_hh^T is [3H, H]: 768 KiB in float32 at
// H=256. One cluster of C blocks (1, 2, 4 or 8, planned by the wrapper as
// for bigru_fwd.cu) handles one (direction, batch tile of R rows); its
// block of rank q owns the U = ceil(H / C) units q*U .. min(H, q*U+U)-1
// of dh (kLinear and kSplit: the last block's slice masked past H where C
// does not divide H, a plan the planner takes only at an H no dividing
// plan fits; kFused: C divides H) and holds
// those rows of W_hh (a [3H, U] slice of W_hh^T, as float32) in shared
// memory. Thread (u, g) owns unit u of kRowsPerThread rows: it reads that
// unit's r, z, n, hn, h_prev and dy (all its own), computes the coefficients
// beside the chain, its dx and dhn, and keeps the cells' dh carries in
// registers. Each step it pushes its cells' [dx_r, dx_z, dhn], rounded to the
// stream type, into a double-buffered [3H, R] tile in the shared memory of
// every block of the cluster (distributed shared memory through
// map_shared_rank); one cluster.sync() per step makes the whole dg tile
// visible, and each thread then takes its 768-deep dot product from its own
// shared memory (float4 broadcasts of dg, conflict-free W reads). The next
// step's six inputs are prefetched into registers before this step's
// exchange; h_prev is read through a second pointer into ys shifted by one
// step.
//
// kFused keeps that chain, writes dx and dhn to a scratch stream as kLinear
// writes its outputs, and every kChunk steps stops the walk for the chunk's
// input-side products: after a fence and a cluster.sync() the chunk's dx,
// dhn, x and h_prev are re-read (dx and dhn mostly from L2) and the three
// products run as tiled matrix products, their output tiles dealt
// round-robin to the blocks of the cluster; a second cluster.sync() ends
// the stop. TPU grids run in order, so the TPU kernel sums dW into one
// resident block; clusters here run at once, so each cluster keeps its own
// float32 partials of dW_ih, dW_hh and the biases in global memory, every
// partial tile owned by one block (no atomics), and a second kernel
// (bigru_bwd_reduce_kernel, launched right after on the same stream) sums
// them over the clusters in a fixed order: the gradients are the same from
// run to run.
//
// The products on an H100. First on CUDA cores (float32 FMAs in 4 x 4
// register tiles beside the chain's 5 warps an SM, the kind at 255
// registers and spilling) they ran at about 2.8 TFLOP/s and took ~890 of the
// 983 ms of #9 at the scale-up shape, against 91 ms for the same chain
// without them (kLinear). The JAX kernel fills the MXU with them while the
// chain stalls; the tensor core is Hopper's counterpart. So a kFused block
// has kFusedMaxThreads (8 warps) whatever its chain uses (the plan's
// U * R / 4 threads walk, the rest wait at the step's cluster.sync()), and
// with bfloat16 streams the products run as mma.sync m16n8k16 (bf16
// operands, the T()-rounded values the JAX kernel feeds its dots; f32 sums):
// block tiles of 128 x 128 outputs, 8 warps of 64 x 32, 32-deep slabs
// staged by cp.async into a ring of four buffers, three slabs in flight
// (each staged row gathered through the chunk's sample indices,
// zero-filled past an edge), fragments read by ldmatrix (.trans for the
// operands whose contraction runs over samples: x^T dx and h_prev^T dg),
// each output tile summed over the whole depth in registers and added once
// into the cluster's partial (all of a warp's partial sums read before any
// is written back, so the reads overlap). The staging buffers reuse the
// exchange tile, idle between the two cluster.sync()s (grown where a small
// plan's tile is smaller). float32 streams keep the CUDA-core products
// (block_product): TF32 would miss the float32 bound. Measured on an H100
// at the scale-up shape the kind takes ~123 ms against ~91 ms for kLinear
// at the same plan; the products are bound by L2 traffic (each operand
// re-read by every tile of the other dimension), not by the tensor cores,
// and taking them off the chain's path (warps that run chunk c while the
// chain walks chunk c + 1) is left for later work.
//
// The single-direction GRU at small H (gru_bwd_unit_kernel, H <= 64, the
// legacy model's H=64). kLinear with a grid of one direction tied every
// small plan there: at B=32, H=64 a few blocks of 2 warps on a handful of
// SMs, each thread a 192-deep chain of shared loads, and a cluster.sync()
// plus a distributed-shared-memory push every step even for a cluster of
// one block (4.1 us a step on an H100, cuDNN 2.1). The unit kernel is the
// BPTT counterpart of bigru_fwd.cu's gru_fwd_unit_kernel: one block per
// tile of R = 1, 2 or 4 rows (rnn_cuda unit_plans sizes it), four lanes of
// a warp own hidden unit u and lane p holds in registers row u of W_hh for
// its quarter of the 3H-deep sum (48 floats at H=64: dh_carry[u] = sum_j
// dg[j] W_hh[u, j], the transpose of the forward's layout); the step's
// rounded dg sits in shared memory as a double-buffered [3][64][R] tile read
// as 16-byte broadcasts, the four lanes' sums meet by __shfl_xor_sync so
// that lane p holds row p % R's carry and runs that cell's coefficients,
// dx and dhn; one block barrier a step, no cluster, and the six inputs of
// a step loaded kAhead = 8 steps ahead into a register ring.
//
// The tensor-core BPTT (bigru_bwd_tc_kernel: kLinear, both directions,
// bfloat16 streams, the scale-up model's launches). kLinear's cluster chain
// took 18.4 us a step at the scale-up shape: each thread a serial 768-deep
// chain of shared loads and f32 FMAs on CUDA cores, 160 threads a block and
// a full cluster.sync() after float4 pushes of f32 dg. Here the carry's
// product T(dg) [R, 3H] @ T(W_hh)^T [3H, H] runs as mma.sync m16n8k16 (bf16
// operands, f32 sums: the MXU's product in the reference), laid out as the
// forward's tensor-core kernel (bigru_fwd.cu): a cluster of C = 4 or 8
// blocks per (direction, batch tile of R = 16 or 32 rows), each warp the dh
// of 8 units (one n8 tile), those units' rows of W_hh over all j < 3H held
// as B fragments in registers (48 k-steps x 2 = 96 at H=256). The lane that
// owns a cell of the product's output owns that (row, unit) cell of the
// walk: from its staged r, z, n, hn, h_prev and dy it forms the
// coefficients, dh_t, dx and dhn, stages them for the store, and writes
// T([dx_r, dx_z, dhn]) into its block's dg tile [2][R][768 + 8] (768 wide
// whatever H, so that the product has no branch); each warp then sends its
// rows of it (16 bytes) to the other blocks by st.async on their
// mbarriers, and a step waits on its own (see bigru_fwd.cu for the
// exchange and the staging of the streams). The 48 k-steps sum into one
// accumulator per gate block (r, z, n: chains of 16), added as ((dh_t z +
// acc_r) + acc_z) + acc_n, #10's order. No cross-warp reduction and no
// second barrier. Measured on an H100 at the scale-up shape with (4, 16):
// 2.79 us a step (kLinear 18.4), of which the product and gate math about
// 0.9; the exchange, 3/4 of the R x 3H tile into every block a step, bounds
// the rest.
//
// Both directions of a BiGRU layer at H <= 64 (the `bigru` model at its
// defaults, #6), float32 or bf16, run the unit kernel with a grid of two
// directions (bigru_bwd_unit_*: y = 1 the backward-in-time direction), one
// launch, not kLinear (4.1 us a step at such widths) or, with bf16
// streams, the tensor-core BPTT (2.4x slower at H=64).
//
// From H = 65 to 256 the route takes the register cluster BPTT
// (bigru_bwd_reg.cu, its own source: each block's gate columns of W_hh in
// registers, a K-split whose float32 partials of dh_carry go by st.async
// to their owners, no dg exchange and no cluster barrier) for float32 in
// both grids, bf16 with one direction and bf16 with two where no
// tensor-core plan fits; at (32, 500, 255) f32 it took a step from
// kLinear's 13.6 us to about 3.4 (chip_smoke.py phase 41, PERF.md section
// 6). kLinear stays the body of #9 (kFused), of #10's first design
// (kSplit) and of the stream kernel, and is reached for the A/B by a forced
// ("cluster", C, R) plan.
//
// #10 on #6's route (the second design of kSplit). What held it back: the
// first cluster design, its only kernel until then, 15.0-16.1 us a step at
// the scale-up shape (75.0-80.4 ms; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md
// section 6): each thread a serial 768-deep chain of shared loads and f32
// FMAs in three gate loops, float4 pushes of f32 dg into every block and a
// full cluster.sync() a step, the design #6 left for the tensor-core
// chain. What the design does: #10 is a compile-time switch (kSplitCoef)
// of the coefficient step in each of #6's second-design kernels, whose
// chain, exchange, plan rule and launch it keeps: the tensor-core chain
// (bigru_bwd_split_tc_bf16), the unit kernel (bigru_bwd_split_unit_*),
// the register cluster kernel (bigru_bwd_reg.cu, bigru_bwd_split_reg_*)
// and the pipe kernel (bigru_pipe.cu, bigru_bwd_split_pipe_*). The wrapper
// routes and plans #10 as #6 (gru_bwd_kernel_route, the same planners and
// cluster counts: each instance pair has the same threads and shared
// memory). With the switch on, a cell forms dn_pre, dz_pre, dr_pre and dhn
// from its gates unrounded and sends T(dr_pre), T(dz_pre), T(dhn) as #6
// sends its dg. The carry's sum order is the kernel's own: the tensor-core
// chain sums per gate block, ((dh_t z + acc_r) + acc_z) + acc_n, #10's
// order; the unit kernel adds its lanes' 3H-deep sum (gates interleaved),
// dy + (dh_t z + sum); the register and pipe kernels add the C blocks'
// partials over their own gate columns in rank order, dy + (partials +
// dh_t z). Above H = 1024, where #6 takes the stream kernel, #10 has no
// kernel: it stays on its first design, which no cluster plan fits there,
// so the wrapper raises naming the width. What bounds it now: #6's bounds
// (see each kernel's notes). Measured on an H100 (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py phase 28, PERF.md section 6): 13.5-13.9 ms at
// the scale-up shape (2.7-2.8 us a step) beside #6's 14.0-14.2, 5.4x under
// the first design and 14.5% of the 1.96 ms bound: the tile's exchange
// bounds it as it bounds #6; 0.847 ms at (20, 1500, 64) bf16 on the unit
// kernel (#6 0.849, the first design 7.67).
//
// The stream kernel (kStream), for #6 and #8 alike, the first design above
// the cluster widths: the route above H = 1024 (to 2421), below it reached
// by a forced ("stream", C, R) plan since the pipe kernel (bigru_pipe.cu)
// took H 257-1024. kLinear's chain, each block reading its units' rows
// of W_hh from global memory every step instead of holding them in shared
// memory, so that only the dg tile [2][3H][R] (rows padded to whole chunks)
// sits there; clusters of up to 16 blocks. The wrapper passes W_hh^T [3H,
// H] (a transposed copy) so that consecutive threads read consecutive
// units. What bounds it: a block reads 3 H U values through L2 every step,
// the grid all of W_hh once per batch tile and direction; the loads of the
// next kStreamK values of j are issued a chunk ahead of their FMAs.
// Measured on an H100 (phase 40): 80 us a step at (32, 500, 512) f32
// (cuDNN 54), bound as kLinear by a thread's shared-memory loads of dg (a
// float4 for four FMAs). The simple right kernel for these widths, not a
// fast one.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerThread = 4;  // batch rows of one thread (a float4)
static_assert(kRowsPerThread == 4, "rows travel as one float4");
constexpr int kMaxThreads = 512;

// kStream: kLinear's chain with W_hh^T read from global memory (through
// L2) every step instead of held in shared memory (the stream kernel)
enum Kind : int { kLinear = 0, kSplit = 1, kFused = 2, kStream = 3 };
// The stream kernel: j values of W_hh^T a thread has in flight ahead of its
// sums (even: the sums alternate), clusters of up to 16 blocks (a
// non-portable size above 8), the dynamic shared memory of one block
constexpr int kStreamK = 8;
constexpr int kStreamMaxC = 16;
constexpr int kMaxSmem = 232448;
static_assert(kStreamK % 2 == 0, "two partial sums a row");
// kFused: threads of a block (8 warps for the products; the chain uses the
// plan's U * R / 4 of them)
constexpr int kFusedMaxThreads = 256;
constexpr int kChunk = 96;   // walk steps between kFused's products
constexpr int kSlab = 16;    // depth of one staged slab of a CUDA-core product
constexpr int kTileN = 64;   // output columns of one CUDA-core product tile
// the tensor-core products: a block tile of kTcM x kTcN outputs over
// kTcK-deep slabs, staged rows padded by kTcPad bf16 (conflict-free
// ldmatrix), a ring of kTcStages buffers of the larger layout of A and of B
constexpr int kTcM = 128, kTcN = 128, kTcK = 32, kTcPad = 8, kTcStages = 4;
constexpr int kTcStageA = kTcM * (kTcK + kTcPad);   // >= kTcK * (kTcM + pad)
constexpr int kTcStageB = kTcN * (kTcK + kTcPad);   // >= kTcK * (kTcN + pad)
static_assert(kTcStageA >= kTcK * (kTcM + kTcPad) &&
              kTcStageB >= kTcK * (kTcN + kTcPad), "staged tile sizes");
static_assert(kFusedMaxThreads == 256, "the products take 2 x 4 warps");
// floats of kFused's staging region: the ring of bf16 buffers of A and B,
// which also holds block_product's float tiles
constexpr int kFusedStageFloats = kTcStages * (kTcStageA + kTcStageB) / 2;
static_assert(kFusedStageFloats >=
                  kSlab * (kFusedMaxThreads / 4 + kTileN),
              "block_product's tiles fit the staging region");

// the unit kernel (one direction, H <= kMaxUnitH): lanes per hidden unit,
// W_hh values of the sum held in registers (over the four lanes, for each
// gate block of W_hh's row), threads of a block at H = kMaxUnitH
constexpr int kLanes = 4;
constexpr int kMaxUnitH = 64;
constexpr int kKPerLane = kMaxUnitH / kLanes;
constexpr int kUnitThreads = kLanes * kMaxUnitH;
constexpr int kAhead = 8;  // steps of inputs in flight ahead of the chain
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;   // devices whose shared-memory limit is kept

constexpr int max_threads(int kind) {
  return kind == kFused ? kFusedMaxThreads : kMaxThreads;
}

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

__host__ __device__ __forceinline__ size_t pad4(size_t n) {
  return (n + 3) / 4 * 4;
}

// n rounded up to a multiple of kStreamK: the rows of the stream kernel's
// exchange tile (the rows past n stay zero, so every chunk is whole)
__host__ __device__ __forceinline__ int pad_stream(int n) {
  return (n + kStreamK - 1) / kStreamK * kStreamK;
}

// Floats of kFused's exchange tile, which doubles as the products' staging
// region: [2][3H][R], grown to kFusedStageFloats where smaller.
__host__ __device__ __forceinline__ size_t fused_stage_floats(size_t G,
                                                              size_t R) {
  return 2 * G * R > kFusedStageFloats ? 2 * G * R : kFusedStageFloats;
}

struct StepIn {
  float r, z, n, hn, hp, dy;
};

// What kFused reads and writes besides the chain's streams.
template <typename T>
struct FusedArgs {
  const T* x;       // [B, N, D] layer input, read by both directions
  const T* wih_f;   // [D, 3H]
  const T* wih_b;
  T* dxin_f;        // [B, N, D] dX of each direction
  T* dxin_b;
  float* part;      // per cluster: dW_ih [D, 3H], dW_hh [H, 3H], then
                    // (R / 4) x [db_r, db_z, db_n, db_hn] [4H]; zeroed
  int D;
};

// Floats of one cluster's partials.
__host__ __device__ __forceinline__ size_t part_stride(int D, int H, int R) {
  return static_cast<size_t>(D + H) * 3 * H +
         static_cast<size_t>(R / kRowsPerThread) * 4 * H;
}

// One block's share of C (+)= A B, A [Mc, Kd] and B [Kd, Nc] read through
// a(m, k) and b(k, n): the output tiles of (blockDim / 4) x kTileN numbered
// tile0, tile0 + tile_step, ...; each thread sums a 4 x 4 cell of a tile in
// registers over slabs of kSlab staged in shared memory, then hands every
// element to c(m, n, v). kAK / kBK: consecutive threads load consecutive k
// of A / B (else consecutive m / n), whichever is contiguous in memory.
// A slab's loads are issued together into registers one slab ahead, so
// their latency overlaps the previous slab's FMAs (a block of 128 threads
// or more holds a whole B slab there; fewer load the rest in place). Every
// thread of the block calls it with the same arguments.
template <bool kAK, bool kBK, typename FA, typename FB, typename FC>
__device__ void block_product(int Mc, int Nc, int Kd, int tile0,
                              int tile_step, float* stage, FA a, FB b,
                              FC c) {
  constexpr int kRegB = 8;             // B values a thread holds ahead
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int TM = nt / 4;               // 16 threads per row of cells
  float* As = stage;                   // [kSlab][TM], 4 values a thread
  float* Bs = stage + kSlab * TM;      // [kSlab][kTileN]
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ntm = (Mc + TM - 1) / TM;
  const int ntn = (Nc + kTileN - 1) / kTileN;
  auto a_slot = [&](int idx, int& m, int& k) {
    if (kAK) {
      m = idx / kSlab;
      k = idx - m * kSlab;
    } else {
      k = idx / TM;
      m = idx - k * TM;
    }
  };
  auto b_slot = [&](int idx, int& n, int& k) {
    if (kBK) {
      n = idx / kSlab;
      k = idx - n * kSlab;
    } else {
      k = idx / kTileN;
      n = idx - k * kTileN;
    }
  };
  for (int tile = tile0; tile < ntm * ntn; tile += tile_step) {
    const int m0 = (tile / ntn) * TM;
    const int n0 = (tile % ntn) * kTileN;
    float ra[4], rb[kRegB];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int m, k;
        a_slot(tid + q * nt, m, k);
        ra[q] = (m0 + m < Mc && k0 + k < Kd) ? a(m0 + m, k0 + k) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kRegB; ++q) {
        const int idx = tid + q * nt;
        int n, k;
        b_slot(idx, n, k);
        rb[q] = (idx < kSlab * kTileN && n0 + n < Nc && k0 + k < Kd)
                    ? b(k0 + k, n0 + n) : 0.0f;
      }
    };
    float acc[4][4] = {};
    fetch(0);
    for (int k0 = 0; k0 < Kd; k0 += kSlab) {
      __syncthreads();  // the previous slab is read
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int m, k;
        a_slot(tid + q * nt, m, k);
        As[k * TM + m] = ra[q];
      }
#pragma unroll
      for (int q = 0; q < kRegB; ++q) {
        const int idx = tid + q * nt;
        int n, k;
        b_slot(idx, n, k);
        if (idx < kSlab * kTileN) Bs[k * kTileN + n] = rb[q];
      }
      for (int idx = tid + kRegB * nt; idx < kSlab * kTileN; idx += nt) {
        int n, k;
        b_slot(idx, n, k);
        Bs[k * kTileN + n] =
            (n0 + n < Nc && k0 + k < Kd) ? b(k0 + k, n0 + n) : 0.0f;
      }
      __syncthreads();
      if (k0 + kSlab < Kd) fetch(k0 + kSlab);
#pragma unroll
      for (int k = 0; k < kSlab; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(As + k * TM + ty * 4);
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + k * kTileN + tx * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= Mc) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < Nc) c(m, n, acc[i][j]);
      }
    }
  }
}

// Tensor-core building blocks (sm_80 and later instructions, in PTX).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, of which the first `bytes` are
// read and the rest zero-filled; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d (+)= a b for one 16 x 8 tile over a depth of 16: bf16 operands in the
// m16n8k16 fragment layouts, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Whether rows of `stride` bf16 values from p travel as 16-byte copies.
__device__ __forceinline__ bool rows_vec(const void* p, int stride) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && stride % 8 == 0;
}

// Stage a kRows x kCols tile of bf16 values (rows padded to kCols + kTcPad)
// from global memory: row r, columns c .. c+7 come from src(row0 + r,
// col0 + c), a pointer to that run (nullptr: zeros), valid up to row_lim and
// col_lim (zero past them). With vec, each run of 8 is one cp.async (the
// caller commits and waits); otherwise it is loaded by value.
template <int kRows, int kCols, typename F>
__device__ __forceinline__ void tc_stage(__nv_bfloat16* dst, F src, int row0,
                                         int col0, int row_lim, int col_lim,
                                         bool vec) {
  constexpr int kRuns = kCols / 8;
  constexpr int kLd = kCols + kTcPad;
  for (int idx = threadIdx.x; idx < kRows * kRuns; idx += blockDim.x) {
    const int r = idx / kRuns;
    const int c = (idx - r * kRuns) * 8;
    __nv_bfloat16* d = dst + r * kLd + c;
    const int nv = min(max(col_lim - (col0 + c), 0), 8);
    const __nv_bfloat16* s =
        (row0 + r < row_lim && nv > 0) ? src(row0 + r, col0 + c) : nullptr;
    if (s == nullptr) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      cp_async16(d, s, 2 * nv);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = e < nv ? s[e] : __float2bfloat16_rn(0.0f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// One block's share of C (+)= A B on tensor cores, A [Mc, Kd] and B [Kd, Nc]
// in bf16, f32 sums: the output tiles of kTcM x kTcN numbered tile0,
// tile0 + tile_step, ...; warp w sums the kTcM / 2 x 32 corner (w % 2,
// w / 2) of a tile over the whole depth in registers, slab by slab from a
// ring of kTcStages staged buffers (kTcStages - 1 slabs in flight), then
// stores element (m, n) through out(m, n), a pointer (nullptr: dropped):
// with kAcc a float it adds to (Nc even: pairs (n, n + 1) as one float2,
// 8-byte aligned), else a bf16 it sets. The operands come as runs
// of 8 contiguous values: kAT false, a(m, k) points to A[m, k .. k+7] (k
// contiguous); kAT true, a(k, m) points to A[m .. m+7, k] (m contiguous);
// likewise b(n, k) for kBT false (B[k .. k+7, n]) and b(k, n) for kBT true
// (B[k, n .. n+7]); nullptr for zeros. a_vec / b_vec: the runs are 16-byte
// aligned (rows_vec). Every thread of the block calls it with the same
// arguments.
template <bool kAT, bool kBT, bool kAcc, typename FA, typename FB,
          typename FO>
__device__ void tc_product(int Mc, int Nc, int Kd, int tile0, int tile_step,
                           __nv_bfloat16* stage, FA a, bool a_vec, FB b,
                           bool b_vec, FO out) {
  constexpr int kLdA = (kAT ? kTcM : kTcK) + kTcPad;
  constexpr int kLdB = (kBT ? kTcN : kTcK) + kTcPad;
  constexpr int kMT = kTcM / 32;   // 16-row fragments of a warp's rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp % 2) * (kTcM / 2);
  const int wn = (warp / 2) * 32;
  const int ntm = (Mc + kTcM - 1) / kTcM;
  const int ntn = (Nc + kTcN - 1) / kTcN;
  const int nk = (Kd + kTcK - 1) / kTcK;
  for (int tile = tile0; tile < ntm * ntn; tile += tile_step) {
    const int m0 = (tile / ntn) * kTcM;
    const int n0 = (tile % ntn) * kTcN;
    // stage slab ks (if any) into buffer ks % kTcStages; one commit group
    // a call, empty or not, so that the waits count slabs
    auto fetch = [&](int ks) {
      if (ks < nk) {
        __nv_bfloat16* As =
            stage + (ks % kTcStages) * (kTcStageA + kTcStageB);
        __nv_bfloat16* Bs = As + kTcStageA;
        const int k0 = ks * kTcK;
        if (kAT)
          tc_stage<kTcK, kTcM>(As, a, k0, m0, Kd, Mc, a_vec);
        else
          tc_stage<kTcM, kTcK>(As, a, m0, k0, Mc, Kd, a_vec);
        if (kBT)
          tc_stage<kTcK, kTcN>(Bs, b, k0, n0, Kd, Nc, b_vec);
        else
          tc_stage<kTcN, kTcK>(Bs, b, n0, k0, Nc, Kd, b_vec);
      }
      cp_async_commit();
    };
    float acc[kMT][4][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kTcStages - 1; ++ks) fetch(ks);
    for (int ks = 0; ks < nk; ++ks) {
      cp_async_wait<kTcStages - 2>();   // slab ks has landed
      // slab ks is staged by every thread, and slab ks - 1 read by every
      // warp, so its buffer takes slab ks + kTcStages - 1
      __syncthreads();
      fetch(ks + kTcStages - 1);
      const __nv_bfloat16* As =
          stage + (ks % kTcStages) * (kTcStageA + kTcStageB);
      const __nv_bfloat16* Bs = As + kTcStageA;
#pragma unroll
      for (int kk = 0; kk < kTcK; kk += 16) {
        // lane l addresses row l % 8 of 8 x 8 matrix l / 8 of the fragment
        const int q = lane & 7;
        const int h8 = ((lane >> 3) & 1) * 8;
        const int h16 = (lane >> 4) * 8;
        unsigned af[kMT][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int mb = wm + mt * 16;
          if (kAT)
            ldmatrix_x4_trans(af[mt], As + (kk + q + h16) * kLdA + mb + h8);
          else
            ldmatrix_x4(af[mt], As + (mb + q + h8) * kLdA + kk + h16);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int nb = wn + np * 16;
          unsigned t[4];
          if (kBT)
            ldmatrix_x4_trans(t, Bs + (kk + q + h8) * kLdB + nb + h16);
          else
            ldmatrix_x4(t, Bs + (nb + q + h16) * kLdB + kk + h8);
          bf[2 * np][0] = t[0];
          bf[2 * np][1] = t[1];
          bf[2 * np + 1][0] = t[2];
          bf[2 * np + 1][1] = t[3];
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
    }
    __syncthreads();   // every warp is done with the ring before the next tile
    // element e of acc[mt][nt] is (m, n) = (.. + (e / 2) * 8, .. + e % 2)
    auto at = [&](int mt, int nt, int e) {
      const int m = m0 + wm + mt * 16 + (lane >> 2) + (e >> 1) * 8;
      const int n = n0 + wn + nt * 8 + (lane & 3) * 2 + (e & 1);
      return (m < Mc && n < Nc) ? out(m, n) : nullptr;
    };
    if constexpr (kAcc) {
      // elements e = 2h, 2h + 1 are (n, n + 1), n even: every pair of sums
      // read before any is written back, so the reads overlap
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            if (const float* p = at(mt, nt, e)) {
              const float2 old = *reinterpret_cast<const float2*>(p);
              acc[mt][nt][e] += old.x;
              acc[mt][nt][e + 1] += old.y;
            }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            if (float* p = at(mt, nt, e))
              *reinterpret_cast<float2*>(p) =
                  make_float2(acc[mt][nt][e], acc[mt][nt][e + 1]);
    } else {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (__nv_bfloat16* p = at(mt, nt, e))
              *p = __float2bfloat16_rn(acc[mt][nt][e]);
    }
  }
}

// Output tiles of kTcM x kTcN in an Mc x Nc product.
__device__ __forceinline__ int tc_tiles(int Mc, int Nc) {
  return ((Mc + kTcM - 1) / kTcM) * ((Nc + kTcN - 1) / kTcN);
}

// kFused with bf16 streams: the chunk's three products on tensor cores
// (see fused_products), staged in `stage`; the tiles of each product dealt
// to the blocks of the cluster from where the previous product's ended.
__device__ void fused_products_tc(FusedArgs<__nv_bfloat16> fa, bool bwd,
                                  const __nv_bfloat16* dx,
                                  const __nv_bfloat16* dhn,
                                  const __nv_bfloat16* ys,
                                  __nv_bfloat16* stage, const int* smp,
                                  int Ms, int m_first, int H, int rank,
                                  int C, float* part) {
  using bf16 = __nv_bfloat16;
  const int G = 3 * H;
  const int D = fa.D;
  const bf16* wih = bwd ? fa.wih_b : fa.wih_f;
  bf16* dxin = bwd ? fa.dxin_b : fa.dxin_f;
  const bool dx_vec = rows_vec(dx, G);

  // dX [Ms, D] = T(dx) [Ms, 3H] @ T(W_ih)^T, rounded to T once
  int first = rank;
  tc_product<false, false, false>(
      Ms, D, G, first, C, stage,
      [&](int m, int k) -> const bf16* {
        const int i = smp[m];
        return i < 0 ? nullptr : dx + static_cast<size_t>(i) * G + k;
      },
      dx_vec,
      [&](int n, int k) -> const bf16* {
        return wih + static_cast<size_t>(n) * G + k;
      },
      rows_vec(wih, G),
      [&](int m, int n) -> bf16* {
        const int i = smp[m];
        return i < 0 ? nullptr : dxin + static_cast<size_t>(i) * D + n;
      });
  first = (first + tc_tiles(Ms, D)) % C;

  // dW_ih [D, 3H] += T(x)^T T(dx)
  tc_product<true, true, true>(
      D, G, Ms, first, C, stage,
      [&](int k, int d) -> const bf16* {
        const int i = smp[k];
        return i < 0 ? nullptr : fa.x + static_cast<size_t>(i) * D + d;
      },
      rows_vec(fa.x, D),
      [&](int k, int j) -> const bf16* {
        const int i = smp[k];
        return i < 0 ? nullptr : dx + static_cast<size_t>(i) * G + j;
      },
      dx_vec,
      [&](int d, int j) { return part + static_cast<size_t>(d) * G + j; });
  first = (first + tc_tiles(D, G)) % C;

  // dW_hh [H, 3H] += T(h_prev)^T T([dx_r, dx_z, dhn]); h_prev is zero at
  // the walk's last step (the forward order's first)
  const int shift = bwd ? 1 : -1;
  float* pw = part + static_cast<size_t>(D) * G;
  tc_product<true, true, true>(
      H, G, Ms, first, C, stage,
      [&](int k, int h) -> const bf16* {
        const int i = smp[k];
        return (i < 0 || k >= m_first)
                   ? nullptr
                   : ys + static_cast<size_t>(i + shift) * H + h;
      },
      rows_vec(ys, H),
      [&](int k, int j) -> const bf16* {
        const int i = smp[k];
        if (i < 0) return nullptr;
        return j < 2 * H ? dx + static_cast<size_t>(i) * G + j
                         : dhn + static_cast<size_t>(i) * H + (j - 2 * H);
      },
      dx_vec && rows_vec(dhn, H),
      [&](int h, int j) { return pw + static_cast<size_t>(h) * G + j; });
}

// kFused: the input-side products of walk steps s0 .. s0+ns-1 of this
// cluster's (direction, batch tile). Sample m = (s - s0) * R + r is row
// tile_row0 + r at the step's t; smp[m] is its index row * N + t into the
// [B, N, *] streams, or -1 for a row past B. bf16 streams take the tensor
// cores (fused_products_tc), float32 streams the CUDA cores.
template <typename T>
__device__ void fused_products(FusedArgs<T> fa, bool bwd,
                               const T* __restrict__ dx,
                               const T* __restrict__ dhn,
                               const T* __restrict__ ys, float* stage,
                               int* smp, int s0, int ns, int tile_row0,
                               int B, int N, int H, int R, int rank, int C,
                               float* part) {
  const int G = 3 * H;
  const int D = fa.D;
  const int Ms = ns * R;
  for (int idx = threadIdx.x; idx < Ms; idx += blockDim.x) {
    const int s = s0 + idx / R;
    const int row = tile_row0 + idx % R;
    const int t = bwd ? s : N - 1 - s;
    smp[idx] = row < B ? row * N + t : -1;
  }
  __syncthreads();
  const int m_first = (N - 1 - s0) * R;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    fused_products_tc(fa, bwd, dx, dhn, ys,
                      reinterpret_cast<__nv_bfloat16*>(stage), smp, Ms,
                      m_first, H, rank, C, part);
  } else {
    // dX [Ms, D] = T(dx) [Ms, 3H] @ T(W_ih)^T, rounded to T once
    const T* wih = bwd ? fa.wih_b : fa.wih_f;
    T* dxin = bwd ? fa.dxin_b : fa.dxin_f;
    block_product<true, true>(
        Ms, D, G, rank, C, stage,
        [&](int m, int k) {
          const int i = smp[m];
          return i < 0 ? 0.0f : to_f32<T>(dx[static_cast<size_t>(i) * G + k]);
        },
        [&](int k, int n) {
          return to_f32<T>(wih[static_cast<size_t>(n) * G + k]);
        },
        [&](int m, int n, float v) {
          const int i = smp[m];
          if (i >= 0) dxin[static_cast<size_t>(i) * D + n] = from_f32<T>(v);
        });

    // dW_ih [D, 3H] += T(x)^T T(dx)
    block_product<false, false>(
        D, G, Ms, rank, C, stage,
        [&](int d, int m) {
          const int i = smp[m];
          return i < 0 ? 0.0f : to_f32<T>(fa.x[static_cast<size_t>(i) * D + d]);
        },
        [&](int m, int j) {
          const int i = smp[m];
          return i < 0 ? 0.0f : to_f32<T>(dx[static_cast<size_t>(i) * G + j]);
        },
        [&](int d, int j, float v) {
          part[static_cast<size_t>(d) * G + j] += v;
        });

    // dW_hh [H, 3H] += T(h_prev)^T T([dx_r, dx_z, dhn]); h_prev is zero at
    // the walk's last step (the forward order's first)
    const int shift = bwd ? 1 : -1;
    float* pw = part + static_cast<size_t>(D) * G;
    block_product<false, false>(
        H, G, Ms, rank, C, stage,
        [&](int h, int m) {
          const int i = smp[m];
          return (i < 0 || m >= m_first)
                     ? 0.0f
                     : to_f32<T>(ys[static_cast<size_t>(i + shift) * H + h]);
        },
        [&](int m, int j) {
          const int i = smp[m];
          if (i < 0) return 0.0f;
          return j < 2 * H
                     ? to_f32<T>(dx[static_cast<size_t>(i) * G + j])
                     : to_f32<T>(dhn[static_cast<size_t>(i) * H + j - 2 * H]);
        },
        [&](int h, int j, float v) {
          pw[static_cast<size_t>(h) * G + j] += v;
        });
  }
}

// At least one block an SM, and no more asked: with the thread bound alone
// ptxas held kFused to 128 registers and spilled its products (a kFused
// block at the scale-up plan fills an SM's shared memory anyway).
template <typename T, int kKind>
__global__ void __launch_bounds__(kKind == kFused ? kFusedMaxThreads
                                                     : kMaxThreads,
                                  1)
bigru_bwd_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                 const T* __restrict__ gs_f, const T* __restrict__ hn_f,
                 const T* __restrict__ ys_f, const T* __restrict__ dy_f,
                 const T* __restrict__ gs_b, const T* __restrict__ hn_b,
                 const T* __restrict__ ys_b, const T* __restrict__ dy_b,
                 T* __restrict__ dx_f, T* __restrict__ dhn_f,
                 T* __restrict__ dx_b, T* __restrict__ dhn_b,
                 int B, int N, int H, int R, int rev, FusedArgs<T> fa) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr bool stream = kKind == kStream;
  const int U = (H + C - 1) / C;  // units a block owns (the last: fewer)
  const int G = 3 * H;
  const int GT = stream ? pad_stream(G) : G;   // rows of a dg buffer
  float* wt_s = smem;                       // [3H][U] W_hh[unit, j]
  // [2][GT][R]; the stream kernel holds no W_hh slice
  float* dg_s = stream ? smem : smem + pad4(static_cast<size_t>(G) * U);
  // kFused: the exchange tile is the products' staging region between the
  // chunk's two cluster.sync()s (grown to kFusedStageFloats where smaller),
  // then the chunk's sample indices
  int* smp = reinterpret_cast<int*>(dg_s + fused_stage_floats(G, R));

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const int u = threadIdx.x % U;
  const int r0 = (threadIdx.x / U) * kRowsPerThread;
  const int gu = rank * U + u;
  const bool unit_ok = gu < H;  // else masked: a slice past H (H % C != 0)
  const int tile_row0 = (blockIdx.x / C) * R;
  const int row0 = tile_row0 + r0;
  // kFused blocks have kFusedMaxThreads; those past the plan's U * R / 4
  // take no part in the walk but its barriers
  const bool chain = kKind != kFused ||
                     static_cast<int>(threadIdx.x) < U * (R / kRowsPerThread);

  // rows rank*U .. rank*U+U-1 of W_hh, transposed (zero past H):
  // consecutive threads read consecutive columns of one row
  if constexpr (!stream)
    for (int idx = threadIdx.x; idx < U * G; idx += blockDim.x) {
      const int uu = idx / G;
      const int j = idx - uu * G;
      const int row = rank * U + uu;
      wt_s[j * U + uu] =
          row < H ? to_f32<T>(w[static_cast<size_t>(row) * G + j]) : 0.0f;
    }
  // the stream kernel: both buffers' rows past 3H stay zero
  if constexpr (stream)
    for (int idx = threadIdx.x; idx < 2 * GT * R; idx += blockDim.x)
      dg_s[idx] = 0.0f;

  // the stream kernel: W_hh[gu, j] (w is W_hh^T [3H, H]) for the next
  // kStreamK values of j, as loaded (zero past 3H); a step's last chunk
  // loads the next step's first
  const T* wu = w + (gu < H ? gu : 0);
  T wq[kStreamK];
  auto load_w = [&](int j0) {
#pragma unroll
    for (int e = 0; e < kStreamK; ++e)
      wq[e] = j0 + e < G ? wu[static_cast<size_t>(j0 + e) * H]
                         : from_f32<T>(0.0f);
  };
  if constexpr (stream) load_w(0);

  bool valid[kRowsPerThread];
  size_t goff[kRowsPerThread];  // gates / dx of (row, t = 0, unit gu)
  size_t hoff[kRowsPerThread];  // hn, ys, dy, dhn of (row, t = 0, unit gu)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    valid[i] = chain && unit_ok && row0 + i < B;
    const size_t row = static_cast<size_t>(valid[i] ? row0 + i : 0);
    goff[i] = row * N * G + (unit_ok ? gu : 0);
    hoff[i] = row * N * H + (unit_ok ? gu : 0);
  }
  const T* gs = bwd ? gs_b : gs_f;
  const T* hns = bwd ? hn_b : hn_f;
  const T* dys = bwd ? dy_b : dy_f;
  const T* yss = bwd ? ys_b : ys_f;
  T* dx = bwd ? dx_b : dx_f;
  T* dhn = bwd ? dhn_b : dhn_f;
  // h at the forward order's previous step (t - 1 forward, t + 1
  // backward), read only after that order's first step
  const int first = bwd ? N - 1 : 0;
  const T* hps = yss + (bwd ? H : -H);

  StepIn nxt[kRowsPerThread];
  auto load = [&](int t) {
    const size_t tg = static_cast<size_t>(t) * G;
    const size_t th = static_cast<size_t>(t) * H;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      StepIn in{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (valid[i]) {
        const T* gt = gs + goff[i] + tg;
        in.r = to_f32<T>(gt[0]);
        in.z = to_f32<T>(gt[H]);
        in.n = to_f32<T>(gt[2 * H]);
        in.hn = to_f32<T>(hns[hoff[i] + th]);
        if (t != first) in.hp = to_f32<T>(hps[hoff[i] + th]);
        in.dy = to_f32<T>(dys[hoff[i] + th]);
      }
      nxt[i] = in;
    }
  };
  load(bwd ? 0 : N - 1);
  float dh[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  // kFused: this thread's bias sums over its rows, unrounded
  float db_r = 0.0f, db_z = 0.0f, db_n = 0.0f, db_hn = 0.0f;
  float* part = nullptr;
  if constexpr (kKind == kFused)
    part = fa.part + (static_cast<size_t>(blockIdx.y) * (gridDim.x / C) +
                      blockIdx.x / C) * part_stride(fa.D, H, R);

  // every block of the cluster runs and holds its W_hh^T slice before any
  // block writes into another's shared memory
  cluster.sync();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? s : N - 1 - s;
    StepIn cur[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) cur[i] = nxt[i];
    if (s + 1 < N) load(bwd ? t + 1 : t - 1);

    float dgr[kRowsPerThread], dgz[kRowsPerThread], dgn[kRowsPerThread];
    float dhz[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const StepIn& c = cur[i];
      const float dh_t = c.dy + dh[i];
      float dxr, dxz, dxn, dhn_t;
      if constexpr (kKind == kSplit) {
        dxn = dh_t * (1.0f - c.z) * (1.0f - c.n * c.n);
        dxz = dh_t * (c.hp - c.n) * c.z * (1.0f - c.z);
        dxr = dxn * c.hn * c.r * (1.0f - c.r);
        dhn_t = dxn * c.r;
      } else {
        const float a = (1.0f - c.z) * (1.0f - c.n * c.n);
        const float c_r = round_to<T>(a * c.hn * c.r * (1.0f - c.r));
        const float c_z = round_to<T>((c.hp - c.n) * c.z * (1.0f - c.z));
        const float c_n = round_to<T>(a);
        dxr = dh_t * c_r;
        dxz = dh_t * c_z;
        dxn = dh_t * c_n;
        dhn_t = dxn * c.r;
      }
      if (valid[i]) {
        T* o = dx + goff[i] + static_cast<size_t>(t) * G;
        o[0] = from_f32<T>(dxr);
        o[H] = from_f32<T>(dxz);
        o[2 * H] = from_f32<T>(dxn);
        dhn[hoff[i] + static_cast<size_t>(t) * H] = from_f32<T>(dhn_t);
        if constexpr (kKind == kFused) {
          db_r += dxr;
          db_z += dxz;
          db_n += dxn;
          db_hn += dhn_t;
        }
      }
      dgr[i] = round_to<T>(dxr);
      dgz[i] = round_to<T>(dxz);
      dgn[i] = round_to<T>(dhn_t);
      dhz[i] = dh_t * c.z;
    }

    // push this thread's dg = [dx_r, dx_z, dhn] into every block's tile
    float* slot = dg_s + (s & 1) * GT * R;
    float* mine = slot + gu * R + r0;
    const float4 vr = make_float4(dgr[0], dgr[1], dgr[2], dgr[3]);
    const float4 vz = make_float4(dgz[0], dgz[1], dgz[2], dgz[3]);
    const float4 vn = make_float4(dgn[0], dgn[1], dgn[2], dgn[3]);
    for (int q = 0; chain && unit_ok && q < C; ++q) {
      float* dst = cluster.map_shared_rank(mine, q);
      *reinterpret_cast<float4*>(dst) = vr;
      *reinterpret_cast<float4*>(dst + H * R) = vz;
      *reinterpret_cast<float4*>(dst + 2 * H * R) = vn;
    }
    cluster.sync();

    if (chain) {
      const float* dgb = slot + r0;
      if constexpr (kKind == kSplit) {
        // three H-deep sums, one per gate block of W_hh^T, added in order
        float acc[3][kRowsPerThread] = {};
  #pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
  #pragma unroll 4
          for (int j = gate * H; j < (gate + 1) * H; ++j) {
            const float4 d = *reinterpret_cast<const float4*>(dgb + j * R);
            const float wv = wt_s[j * U + u];
            acc[gate][0] = fmaf(d.x, wv, acc[gate][0]);
            acc[gate][1] = fmaf(d.y, wv, acc[gate][1]);
            acc[gate][2] = fmaf(d.z, wv, acc[gate][2]);
            acc[gate][3] = fmaf(d.w, wv, acc[gate][3]);
          }
        }
  #pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          dh[i] = ((dhz[i] + acc[0][i]) + acc[1][i]) + acc[2][i];
      } else if constexpr (stream) {
        // kLinear's sum, W_hh^T from global memory a chunk ahead
        float a0[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
        float a1[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int j0 = 0; j0 < G; j0 += kStreamK) {
          float wc[kStreamK];
  #pragma unroll
          for (int e = 0; e < kStreamK; ++e) wc[e] = to_f32<T>(wq[e]);
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
  #pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          dh[i] = dhz[i] + (a0[i] + a1[i]);
      } else {
        // dh_carry = dh_t * z + dg . W_hh^T[:, unit]; two partial sums a row
        float a0[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
        float a1[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
        int j = 0;
  #pragma unroll 4
        for (; j + 1 < G; j += 2) {
          const float4 d0 = *reinterpret_cast<const float4*>(dgb + j * R);
          const float4 d1 = *reinterpret_cast<const float4*>(dgb + (j + 1) * R);
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
        if (j < G) {  // odd H
          const float4 d0 = *reinterpret_cast<const float4*>(dgb + j * R);
          const float w0 = wt_s[j * U + u];
          a0[0] = fmaf(d0.x, w0, a0[0]);
          a0[1] = fmaf(d0.y, w0, a0[1]);
          a0[2] = fmaf(d0.z, w0, a0[2]);
          a0[3] = fmaf(d0.w, w0, a0[3]);
        }
  #pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          dh[i] = dhz[i] + (a0[i] + a1[i]);
      }
    }

    if constexpr (kKind == kFused) {
      if ((s + 1) % kChunk == 0 || s + 1 == N) {
        // the chunk's dx and dhn, written by every block of the cluster, are
        // visible to all of them after the fence and the barrier
        __threadfence();
        cluster.sync();
        const int s0 = s / kChunk * kChunk;
        fused_products<T>(fa, bwd, dx, dhn, yss, dg_s, smp, s0, s + 1 - s0,
                          tile_row0, B, N, H, R, rank, C, part);
        // no block pushes the next step's dg into a block still staging
        cluster.sync();
      }
    }
  }

  if (kKind == kFused && chain) {
    float* db = part + static_cast<size_t>(fa.D + H) * G +
                static_cast<size_t>(threadIdx.x / U) * 4 * H;
    db[gu] = db_r;
    db[H + gu] = db_z;
    db[2 * H + gu] = db_n;
    db[3 * H + gu] = db_hn;
  }
}

// kFused, second kernel: each gradient of each direction (blockIdx.y) as
// the sum of the clusters' partials in cluster order, then row-group order
// for the biases. Entries: dW_ih [D, 3H], dW_hh [H, 3H], db_ih [3H], db_hh
// [3H] (db_hh's r and z parts are db_ih's).
__global__ void bigru_bwd_reduce_kernel(const float* __restrict__ part,
                                        int tiles, int D, int H, int R,
                                        float* dwih_f, float* dbih_f,
                                        float* dwhh_f, float* dbhh_f,
                                        float* dwih_b, float* dbih_b,
                                        float* dwhh_b, float* dbhh_b) {
  const int G = 3 * H;
  const size_t nw = static_cast<size_t>(D + H) * G;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= nw + 2 * G) return;
  const bool bwd = blockIdx.y == 1;
  const size_t stride = part_stride(D, H, R);
  const float* p = part + static_cast<size_t>(blockIdx.y) * tiles * stride;
  float sum = 0.0f;
  if (e < nw) {
    for (int c = 0; c < tiles; ++c) sum += p[c * stride + e];
    if (e < static_cast<size_t>(D) * G)
      (bwd ? dwih_b : dwih_f)[e] = sum;
    else
      (bwd ? dwhh_b : dwhh_f)[e - static_cast<size_t>(D) * G] = sum;
    return;
  }
  const int k = static_cast<int>(e - nw);          // 0 .. 6H-1
  const bool hh = k >= G;
  const int j = hh ? k - G : k;
  const int src = (hh && j >= 2 * H) ? j + H : j;  // db_hn after db_n
  for (int c = 0; c < tiles; ++c)
    for (int g = 0; g < R / kRowsPerThread; ++g)
      sum += p[c * stride + nw + static_cast<size_t>(g) * 4 * H + src];
  if (hh)
    (bwd ? dbhh_b : dbhh_f)[j] = sum;
  else
    (bwd ? dbih_b : dbih_f)[j] = sum;
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

// The unit BPTT kernel: one block per tile of R rows of one direction, four
// lanes per hidden unit, row u of W_hh in registers (see the notes at the
// top). Same function, rounding points and outputs as kLinear with a grid
// of one direction: dx [B, N, 3H] and dhn [B, N, H] from the gates gs, hn,
// ys and dy; rev != 0 for a direction whose forward walked t = N-1 .. 0.
// kSplitCoef: #10's coefficient step (kSplit's function); the carry keeps
// this kernel's sum order, dy + (dh_t z + the lanes' 3H-deep sum).
template <typename T, int R, bool kSplitCoef>
__global__ void __launch_bounds__(kUnitThreads)
gru_bwd_unit_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                    const T* __restrict__ gs_f, const T* __restrict__ hn_f,
                    const T* __restrict__ ys_f, const T* __restrict__ dy_f,
                    const T* __restrict__ gs_b, const T* __restrict__ hn_b,
                    const T* __restrict__ ys_b, const T* __restrict__ dy_b,
                    T* __restrict__ dx_f, T* __restrict__ dhn_f,
                    T* __restrict__ dx_b, T* __restrict__ dhn_b, int B, int N,
                    int H, int rev) {
  constexpr int KC = 4 / R;                  // k values in one float4 of dg
  constexpr int kChunks = kKPerLane / KC;    // float4 loads a gate a step
  // the step's rounded dg = [dx_r, dx_z, dhn] as [gate][k][R] floats (j =
  // gate * H + k), double buffered; k >= H stays 0
  __shared__ float4 dg_s[2][3][kMaxUnitH * R / 4];
  const int G = 3 * H;
  // a grid of two directions: y = 1 walks the backward-in-time direction's
  // BPTT; of one: rev says (the direction whose forward walked t = N-1 ..
  // 0)
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const T* gs = bwd ? gs_b : gs_f;
  const T* hns = bwd ? hn_b : hn_f;
  const T* ys = bwd ? ys_b : ys_f;
  const T* dys = bwd ? dy_b : dy_f;
  T* dx = bwd ? dx_b : dx_f;
  T* dhn = bwd ? dhn_b : dhn_f;
  const int lane = threadIdx.x % kLanes;
  const int u = threadIdx.x / kLanes;  // hidden unit; u >= H pads the warp
  const bool unit_valid = u < H;
  const int uu = unit_valid ? u : 0;
  const int row0 = blockIdx.x * R;

  // this lane's values of row u of W_hh: chunk c of the lane covers k =
  // (c * kLanes + lane) * KC + e, e < KC, in each gate block g * H + k
  float wr[3][kKPerLane];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const int k = (c * kLanes + lane) * KC + e;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wr[g][c * KC + e] =
            unit_valid && k < H
                ? to_f32<T>(w[static_cast<size_t>(u) * G + g * H + k])
                : 0.0f;
    }
  float* dg_flat = reinterpret_cast<float*>(dg_s);
  for (int i = threadIdx.x; i < 2 * 3 * kMaxUnitH * R; i += blockDim.x)
    dg_flat[i] = 0.0f;

  // the (row, unit) cell this lane updates: row p % R; lanes p < R store it
  const int orow = lane % R;
  const bool cell_valid = unit_valid && row0 + orow < B;
  const bool owner = lane < R && cell_valid;
  const size_t row = static_cast<size_t>(cell_valid ? row0 + orow : 0);
  const size_t goff = row * N * G + uu;  // gates / dx of (row, t = 0, u)
  const size_t hoff = row * N * H + uu;  // hn, ys, dy, dhn of (row, t = 0, u)
  // h at the forward order's previous step (t - 1 forward, t + 1
  // backward), read only after that order's first step
  const int first = bwd ? N - 1 : 0;
  const T* hps = ys + (bwd ? H : -H);

  // r, z, n, hn, h_prev and dy of this lane's cell for the next kAhead
  // steps as loaded, converted when used: a ring indexed by the step's place
  // in an unrolled group, so each load has kAhead steps to land
  T in[kAhead][6];
  auto load = [&](T (&dst)[6], int s) {
    const int t = bwd ? s : N - 1 - s;
    const T zero = from_f32<T>(0.0f);
    const T* gt = gs + goff + static_cast<size_t>(t) * G;
    const size_t th = hoff + static_cast<size_t>(t) * H;
    dst[0] = cell_valid ? gt[0] : zero;
    dst[1] = cell_valid ? gt[H] : zero;
    dst[2] = cell_valid ? gt[2 * H] : zero;
    dst[3] = cell_valid ? hns[th] : zero;
    dst[4] = cell_valid && t != first ? hps[th] : zero;
    dst[5] = cell_valid ? dys[th] : zero;
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < N) load(in[j], j);
  float dhz = 0.0f;   // dh_t * z of the previous step
  __syncthreads();

  auto step = [&](int s, T (&cur)[6]) {
    const int t = bwd ? s : N - 1 - s;
    float v[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = to_f32<T>(cur[i]);
    if (s + kAhead < N) load(cur, s + kAhead);

    // the previous step's dg . W_hh[u, :] (zero at the first step)
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 dv = dg_s[s & 1][g][ch * kLanes + lane];
        const float dk[4] = {dv.x, dv.y, dv.z, dv.w};  // [e][r]
#pragma unroll
        for (int e = 0; e < KC; ++e)
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(dk[e * R + r], wr[g][ch * KC + e], acc[r]);
      }
    const float dh_t = v[5] + (dhz + reduce_lanes<R>(acc, lane));

    const float r = v[0], z = v[1], n = v[2], hn = v[3], hp = v[4];
    float dxr, dxz, dxn;
    if constexpr (kSplitCoef) {
      dxn = dh_t * (1.0f - z) * (1.0f - n * n);
      dxz = dh_t * (hp - n) * z * (1.0f - z);
      dxr = dxn * hn * r * (1.0f - r);
    } else {
      const float a = (1.0f - z) * (1.0f - n * n);
      const float c_r = round_to<T>(a * hn * r * (1.0f - r));
      const float c_z = round_to<T>((hp - n) * z * (1.0f - z));
      const float c_n = round_to<T>(a);
      dxr = dh_t * c_r;
      dxz = dh_t * c_z;
      dxn = dh_t * c_n;
    }
    const float dhn_t = dxn * r;
    dhz = dh_t * z;
    if (lane < R && unit_valid) {
      const int i = u * R + orow;
      reinterpret_cast<float*>(dg_s[(s + 1) & 1][0])[i] = round_to<T>(dxr);
      reinterpret_cast<float*>(dg_s[(s + 1) & 1][1])[i] = round_to<T>(dxz);
      reinterpret_cast<float*>(dg_s[(s + 1) & 1][2])[i] = round_to<T>(dhn_t);
    }
    if (owner) {
      T* o = dx + goff + static_cast<size_t>(t) * G;
      o[0] = from_f32<T>(dxr);
      o[H] = from_f32<T>(dxz);
      o[2 * H] = from_f32<T>(dxn);
      dhn[hoff + static_cast<size_t>(t) * H] = from_f32<T>(dhn_t);
    }
    __syncthreads();
  };
  for (int s0 = 0; s0 < N; s0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (s0 + j < N) step(s0 + j, in[j]);
  }
}

// The unit kernel's static shared memory (the dg tile, double buffered) and
// threads: four lanes for each of H units, padded to whole warps (the
// wrapper's unit_smem_bytes(R, 3) and unit_threads mirror them).
constexpr size_t unit_smem_bytes(int R) {
  return 2 * 3 * static_cast<size_t>(kMaxUnitH) * R * sizeof(float);
}
constexpr int unit_threads(int H) { return kLanes * ((H + 7) / 8 * 8); }

bool valid_unit_plan(int B, int N, int H, int R) {
  return B > 0 && N > 0 && H > 0 && H <= kMaxUnitH &&
         (R == 1 || R == 2 || R == 4);
}

// kLinear's instances (#10's have the same threads and shared memory)
template <typename T>
const void* unit_kernel(int R) {
  if (R == 1)
    return reinterpret_cast<const void*>(gru_bwd_unit_kernel<T, 1, false>);
  if (R == 2)
    return reinterpret_cast<const void*>(gru_bwd_unit_kernel<T, 2, false>);
  return reinterpret_cast<const void*>(gru_bwd_unit_kernel<T, 4, false>);
}

// A grid of `dirs` directions (2: both of a BiGRU layer, y = 1 the
// backward-in-time one; 1: the direction rev says).
template <typename T, bool kSplitCoef>
int launch_unit(const void* w_f, const void* w_b, const void* gs_f,
                const void* hn_f, const void* ys_f, const void* dy_f,
                const void* gs_b, const void* hn_b, const void* ys_b,
                const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                void* dhn_b, int B, int N, int H, int R, int dirs, int rev,
                void* stream) {
  if (!valid_unit_plan(B, N, H, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + R - 1) / R, dirs);
  const int threads = unit_threads(H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  auto* kernel = R == 1   ? gru_bwd_unit_kernel<T, 1, kSplitCoef>
                 : R == 2 ? gru_bwd_unit_kernel<T, 2, kSplitCoef>
                          : gru_bwd_unit_kernel<T, 4, kSplitCoef>;
  kernel<<<grid, threads, 0, st>>>(
      in(w_f), in(w_b), in(gs_f), in(hn_f), in(ys_f), in(dy_f), in(gs_b),
      in(hn_b), in(ys_b), in(dy_b), out(dx_f), out(dhn_f), out(dx_b),
      out(dhn_b), B, N, H, rev);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int unit_blocks_per_sm(int H, int R) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, unit_kernel<T>(R), unit_threads(H), 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The tensor-core BPTT (see the notes at the top)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcMaxH = 256;             // W_hh fragments of H <= 256 a warp holds
constexpr int kTcMaxKg = kTcMaxH / 16;   // k16 steps of one gate block at kTcMaxH
constexpr int kTcMaxThreads = 256;       // 8 warps of up to 255 registers
constexpr int kTcRowPad = 8;             // bf16 padding of a dg tile row
// bf16 values of a dg tile row, whatever H: the k-steps past a gate
// block's H columns meet zero fragments, so the product has no branch
constexpr int kTcLd = 3 * kTcMaxH + kTcRowPad;

// the shared::cluster address of shared::cta address `addr` in block `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// The exchange (see bigru_fwd.cu): st.async rows into the other blocks'
// tiles, their bytes counted by each receiving block's mbarrier.
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

__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4],
                                               uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// two bf16 values as one 32-bit word, lo in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ float lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ float half_f32(uint32_t v, int e) {
  return e ? hi_f32(v) : lo_f32(v);
}

// The streams' staging in shared memory, as rows [q][R][U + kTcRowPad] of
// a block's units for each stream q (see bigru_fwd.cu): the step's inputs
// arrive as 16-byte cp.async copies (a ring of kRing steps, kRing - 1 in
// flight), its outputs leave as 16-byte stores a step later (double
// buffered).
template <int kMT>
__host__ __device__ constexpr int tc_ring() {
  return kMT == 1 ? 4 : 3;
}
constexpr int kTcInStreams = 6;    // r, z, n, hn, h_prev, dy
constexpr int kTcOutStreams = 4;   // dx_r, dx_z, dx_n, dhn

// kLinear of both directions (blockIdx.y = 1 walks forward in time) with
// bf16 streams on tensor cores: a cluster of C blocks per batch tile of R =
// 16 * kMT rows, U / 8 warps a block, each warp the dh of 8 units. Same
// function, rounding points and outputs as bigru_bwd_kernel<bf16, kLinear>;
// the carry's product is summed per gate block, ((dh_t z + acc_r) + acc_z)
// + acc_n. kSplitCoef: #10's coefficient step (kSplit's function, from the
// gates unrounded), the same chain, exchange and plan.
template <int kMT, bool kSplitCoef>
__global__ void __launch_bounds__(kTcMaxThreads, 1)
bigru_bwd_tc_kernel(const bf16* __restrict__ w_f, const bf16* __restrict__ w_b,
                    const bf16* __restrict__ gs_f, const bf16* __restrict__ hn_f,
                    const bf16* __restrict__ ys_f, const bf16* __restrict__ dy_f,
                    const bf16* __restrict__ gs_b, const bf16* __restrict__ hn_b,
                    const bf16* __restrict__ ys_b, const bf16* __restrict__ dy_b,
                    bf16* __restrict__ dx_f, bf16* __restrict__ dhn_f,
                    bf16* __restrict__ dx_b, bf16* __restrict__ dhn_b, int B,
                    int N, int H) {
  constexpr int R = 16 * kMT;
  constexpr int kRing = tc_ring<kMT>();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint4 tc_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = H / C;
  const int G = 3 * H;
  constexpr int ld = kTcLd;
  const int ldq = U + kTcRowPad;       // bf16 values of a staged row
  const int nk = H / 16;               // k16 steps of a gate block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane >> 2;          // the fragments' row (and B's column)
  const int pair = (lane & 3) * 2;     // the fragments' first column (k or n)
  const int lu = warp * 8 + pair;      // the lane's two units in the block
  const int unit = rank * U + lu;      // ... and in the layer
  const bool bwd = blockIdx.y == 1;
  const bf16* w = bwd ? w_b : w_f;
  const bf16* gs = bwd ? gs_b : gs_f;
  const bf16* hns = bwd ? hn_b : hn_f;
  const bf16* yss = bwd ? ys_b : ys_f;
  const bf16* dys = bwd ? dy_b : dy_f;
  bf16* dx = bwd ? dx_b : dx_f;
  bf16* dhn = bwd ? dhn_b : dhn_f;
  const int tile_row0 = (blockIdx.x / C) * R;
  // h at the forward order's previous step (t - 1 forward, t + 1
  // backward), read only after that order's first step
  const int first = bwd ? N - 1 : 0;
  const int prev = bwd ? 1 : -1;

  // B fragments of W_hh^T restricted to the warp's units: word h8 of
  // k-step kk of gate block g holds W[u][j], W[u][j + 1] for u = the warp's
  // unit `quad`, j = g * H + kk * 16 + h8 * 8 + pair
  uint32_t bw[3][kTcMaxKg][2];
  const bf16* wrow = w + static_cast<size_t>(rank * U + warp * 8 + quad) * G;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int kk = 0; kk < kTcMaxKg; ++kk)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8)
        bw[g][kk][h8] = kk < nk
            ? *reinterpret_cast<const uint32_t*>(
                  wrow + g * H + kk * 16 + h8 * 8 + pair)
            : 0u;

  // shared memory: the dg tile [2][R][ld], the input ring
  // [kRing][6][R][ldq] and the output staging [2][4][R][ldq]
  bf16* tile = reinterpret_cast<bf16*>(tc_smem);
  bf16* ring = tile + 2 * R * ld;
  bf16* stage = ring + kRing * kTcInStreams * R * ldq;
  for (int i = threadIdx.x; i < R * ld; i += blockDim.x)
    reinterpret_cast<uint32_t*>(tile)[i] = 0u;
  const uint32_t tile_addr = smem_addr(tile);
  const uint32_t buf_bytes = static_cast<uint32_t>(R * ld * 2);
  auto t_of = [&](int s) { return bwd ? s : N - 1 - s; };

  // the block's copies: thread i moves chunk i % (U / 8) of staged rows
  // i / (U / 8) + 32 j (the block's 4U threads cover 32 rows a pass)
  const int cpr = U / 8;
  const int chunk = static_cast<int>(threadIdx.x) % cpr;
  const int row_in_pass = static_cast<int>(threadIdx.x) / cpr;
  auto load = [&](int s) {   // the inputs of step s into its ring slot
    if (s < N) {
      const int t = t_of(s);
      bf16* slot = ring + (s % kRing) * kTcInStreams * R * ldq;
#pragma unroll
      for (int pass = 0; pass < kTcInStreams * R / 32; ++pass) {
        const int qr = pass * 32 + row_in_pass;
        const int q = qr / R, r = qr % R;
        const int row = tile_row0 + r;
        const bool ok = row < B && (q != 4 || t != first);
        const size_t cell = static_cast<size_t>(row < B ? row : 0) * N + t;
        const size_t col = static_cast<size_t>(rank * U + chunk * 8);
        const bf16* src = q < 3  ? gs + cell * G + q * H + col
                        : q == 3 ? hns + cell * H + col
                        : q == 4 ? yss + (ok ? (cell + prev) * H + col : col)
                                 : dys + cell * H + col;
        cp_async16(slot + (q * R + r) * ldq + chunk * 8, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();   // one group a step, empty or not
  };
  auto flush = [&](int s) {   // the outputs of step s from its staging
    const int t = t_of(s);
    const bf16* st = stage + (s & 1) * kTcOutStreams * R * ldq;
#pragma unroll
    for (int pass = 0; pass < kTcOutStreams * R / 32; ++pass) {
      const int qr = pass * 32 + row_in_pass;
      const int q = qr / R, r = qr % R;
      const int row = tile_row0 + r;
      if (row < B) {
        const size_t cell = static_cast<size_t>(row) * N + t;
        bf16* dst = q < 3 ? dx + cell * G + q * H : dhn + cell * H;
        *reinterpret_cast<uint4*>(dst + rank * U + chunk * 8) =
            *reinterpret_cast<const uint4*>(st + (q * R + r) * ldq +
                                            chunk * 8);
      }
    }
  };
  for (int j = 0; j < kRing - 1; ++j) load(j);

  float dhz[kMT][2][2];   // dh_t * z of the previous step
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) dhz[mt][hr][0] = dhz[mt][hr][1] = 0.0f;

  // full[b] counts the bytes of dg landing in buffer b: step s pushes dg_s
  // into buffer s & 1, and step c > 0 reads buffer (c - 1) & 1 after the
  // ((c - 1) / 2)-th phase of its full. Armed two steps ahead.
  __shared__ __align__(8) uint64_t full[2];
  const uint32_t bar = smem_addr(full);
  // the bytes the other blocks send into a buffer each step
  const uint32_t tile_tx = static_cast<uint32_t>(R * 3 * (H - U) * 2);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    if (N > 1) mbar_expect(bar, tile_tx);       // dg_0, read at step 1
    if (N > 2) mbar_expect(bar + 8, tile_tx);   // dg_1, read at step 2
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // every block of the cluster runs and holds its mbarriers before any
  // block writes into another's shared memory
  cluster.sync();

  for (int s = 0; s < N; ++s) {
    // this step's inputs have landed (this thread's copies, then every
    // thread's), every thread is done with the previous step's ring slot
    // and staging; the previous step's outputs leave, this slot refills
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (s > 0) flush(s - 1);
    load(s + kRing - 1);

    // the previous step's T(dg) @ T(W_hh)^T for the warp's units, one
    // accumulator per gate block (zero at the first step)
    float acc[3][kMT][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][mt][e] = 0.0f;
    if (s > 0) {   // dg of every block has landed
      mbar_wait(bar + ((s - 1) & 1) * 8, ((s - 1) >> 1) & 1);
      if (threadIdx.x == 0 && s + 2 < N)
        mbar_expect(bar + ((s - 1) & 1) * 8, tile_tx);
      const uint32_t db = tile_addr + ((s - 1) & 1) * buf_bytes;
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int kk = 0; kk < kTcMaxKg; ++kk) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            // lane l addresses row l % 16, k half l / 16 of the 16 x 16 tile
            uint32_t a[4];
            ldmatrix_x4_at(a, db + ((mt * 16 + (lane & 15)) * ld + g * H +
                                    kk * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(acc[g][mt], a, bw[g][kk][0], bw[g][kk][1]);
          }
        }
    }

    // element e of an accumulator is (row quad + (e / 2) * 8, unit pair +
    // e % 2): the lane's cells; their inputs from the ring, their outputs
    // into the staging
    const bf16* in = ring + (s % kRing) * kTcInStreams * R * ldq;
    bf16* out = stage + (s & 1) * kTcOutStreams * R * ldq;
    uint32_t wr[kMT][2], wz[kMT][2], whn[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int cell = (mt * 16 + quad + hr * 8) * ldq + lu;
        uint32_t c[kTcInStreams];
#pragma unroll
        for (int q = 0; q < kTcInStreams; ++q)
          c[q] = *reinterpret_cast<const uint32_t*>(in + q * R * ldq + cell);
        float vr[2], vz[2], vn[2], vhn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = hr * 2 + e;
          const float r = half_f32(c[0], e), z = half_f32(c[1], e);
          const float n = half_f32(c[2], e), hn = half_f32(c[3], e);
          const float hp = half_f32(c[4], e), dy = half_f32(c[5], e);
          const float dh_t =
              dy + (((dhz[mt][hr][e] + acc[0][mt][i]) + acc[1][mt][i]) +
                    acc[2][mt][i]);
          if constexpr (kSplitCoef) {
            vn[e] = dh_t * (1.0f - z) * (1.0f - n * n);
            vz[e] = dh_t * (hp - n) * z * (1.0f - z);
            vr[e] = vn[e] * hn * r * (1.0f - r);
          } else {
            const float a = (1.0f - z) * (1.0f - n * n);
            const float c_r = round_to<bf16>(a * hn * r * (1.0f - r));
            const float c_z = round_to<bf16>((hp - n) * z * (1.0f - z));
            const float c_n = round_to<bf16>(a);
            vr[e] = dh_t * c_r;
            vz[e] = dh_t * c_z;
            vn[e] = dh_t * c_n;
          }
          vhn[e] = vn[e] * r;
          dhz[mt][hr][e] = dh_t * z;
        }
        wr[mt][hr] = pack_f32(vr[0], vr[1]);
        wz[mt][hr] = pack_f32(vz[0], vz[1]);
        whn[mt][hr] = pack_f32(vhn[0], vhn[1]);
        const uint32_t words[kTcOutStreams] = {
            wr[mt][hr], wz[mt][hr], pack_f32(vn[0], vn[1]), whn[mt][hr]};
#pragma unroll
        for (int q = 0; q < kTcOutStreams; ++q)
          *reinterpret_cast<uint32_t*>(out + q * R * ldq + cell) = words[q];
      }

    // T([dx_r, dx_z, dhn]) into buffer s & 1 of this block (seen by its
    // warps after the next step's __syncthreads), then the warp's rows of
    // it (8 units of a gate block, 16 bytes) into that buffer of every other
    // block of the cluster; the last step's dg is read by no step
    const uint32_t nb = tile_addr + (s & 1) * buf_bytes;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const uint32_t off = nb + ((mt * 16 + quad + hr * 8) * ld + unit) * 2;
        st_shared(off, wr[mt][hr]);
        st_shared(off + H * 2, wz[mt][hr]);
        st_shared(off + H * 4, whn[mt][hr]);
      }
    __syncwarp();
    if (s + 1 < N) {
      const uint32_t nbar = bar + (s & 1) * 8;
#pragma unroll
      for (int v0 = 0; v0 < 3 * R; v0 += 32) {
        const int v = v0 + lane;   // row v % R of gate block v / R
        if (v < 3 * R) {
          const uint32_t off =
              nb + ((v % R) * ld + (v / R) * H + rank * U + warp * 8) * 2;
          const uint4 val = ld_shared16(off);
          for (int q = 0; q < C; ++q)
            if (q != rank)
              st_async16(cluster_addr(off, q), val, cluster_addr(nbar, q));
        }
      }
    }
  }
  __syncthreads();
  flush(N - 1);
  // no block exits while another may still write into it
  cluster.sync();
}

// The tensor-core kernel's dynamic shared memory (the dg tile, double
// buffered, the input ring and the output staging), threads and W_hh
// fragment registers a lane holds (the wrapper's tc_smem_bytes("bwd", ...),
// tc_threads and TC_WEIGHT_REGS mirror them, held to this source by
// bigru_bwd_tc_layout).
size_t tc_smem_bytes(int H, int C, int R) {
  const size_t ldq = static_cast<size_t>(H / C) + kTcRowPad;
  const size_t ring = R == 16 ? tc_ring<1>() : tc_ring<2>();
  return (2 * static_cast<size_t>(R) * kTcLd +
          (ring * kTcInStreams + 2 * kTcOutStreams) * R * ldq) * sizeof(bf16);
}
constexpr int tc_threads(int H, int C) { return 4 * (H / C); }
constexpr int kTcWeightRegs = 3 * kTcMaxKg * 2;

// H a multiple of 16 up to kTcMaxH, the cluster dividing H into a whole
// number of 8-unit warps, at most kTcMaxThreads threads a block, and one
// or two m16 tiles of rows.
bool valid_tc_plan(int B, int N, int H, int C, int R) {
  return B > 0 && N > 0 && H > 0 && H % 16 == 0 && H <= kTcMaxH &&
         (C == 1 || C == 2 || C == 4 || C == 8) && H % C == 0 &&
         (H / C) % 8 == 0 && tc_threads(H, C) <= kTcMaxThreads &&
         (R == 16 || R == 32);
}

template <int kMT, bool kSplitCoef>
cudaError_t allow_tc_smem(int smem) {
  static std::atomic<int> allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bigru_bwd_tc_kernel<kMT, kSplitCoef>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices) allowed[device].store(smem);
  return err;
}

void make_tc_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int grid_x, int dirs, int H, int C, size_t smem,
                    void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(grid_x, dirs, 1);
  cfg->blockDim = dim3(tc_threads(H, C), 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int kMT, bool kSplitCoef>
int launch_tc_as(const void* w_f, const void* w_b, const void* gs_f,
                 const void* hn_f, const void* ys_f, const void* dy_f,
                 const void* gs_b, const void* hn_b, const void* ys_b,
                 const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                 void* dhn_b, int B, int N, int H, int C, void* stream) {
  constexpr int R = 16 * kMT;
  const size_t smem = tc_smem_bytes(H, C, R);
  cudaError_t err = allow_tc_smem<kMT, kSplitCoef>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_tc_config(&cfg, &attr, C * ((B + R - 1) / R), 2, H, C, smem, stream);
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto out = [](void* p) { return static_cast<bf16*>(p); };
  err = cudaLaunchKernelEx(&cfg, bigru_bwd_tc_kernel<kMT, kSplitCoef>,
                           in(w_f), in(w_b),
                           in(gs_f), in(hn_f), in(ys_f), in(dy_f), in(gs_b),
                           in(hn_b), in(ys_b), in(dy_b), out(dx_f),
                           out(dhn_f), out(dx_b), out(dhn_b), B, N, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kMT>
int tc_max_active_clusters_as(int H, int C) {
  const size_t smem = tc_smem_bytes(H, C, 16 * kMT);
  cudaError_t err = allow_tc_smem<kMT, false>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_tc_config(&cfg, &attr, C, 1, H, C, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bigru_bwd_tc_kernel<kMT, false>,
                                       &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory one block needs, in bytes (the wrapper's
// bigru_smem_bytes mirrors it to pick the cluster size, and is held to it
// through bigru_bwd_smem_bytes when the library loads).
size_t smem_bytes(int kind, int H, int C, int R) {
  const size_t U = static_cast<size_t>((H + C - 1) / C);
  const size_t G = 3 * static_cast<size_t>(H);
  if (kind == kStream)   // the dg tile alone, its rows padded to chunks
    return 2 * static_cast<size_t>(pad_stream(3 * H)) * R * sizeof(float);
  size_t floats = pad4(G * U) + 2 * G * R;
  if (kind == kFused)   // the exchange tile doubles as the staging region
    floats = pad4(G * U) + fused_stage_floats(G, R) +
             kChunk * static_cast<size_t>(R);
  return floats * sizeof(float);
}

// C in 1, 2, 4, 8 with every block owning one unit at least (kLinear and
// kSplit: a slice of ceil(H / C) units, the last one masked where C does
// not divide H; kFused: C divides H into multiples of 16 units), R a
// multiple of kRowsPerThread, within the kind's thread bound; the stream
// kernel (kStream) takes C = 1 .. kStreamMaxC and any H whose dg tile fits
// kMaxSmem (the wrapper's stream_smem_bytes and _stream_rule mirror it,
// held to bigru_bwd_stream_smem_bytes when the library loads)
bool valid_plan(int kind, int B, int N, int H, int C, int R) {
  if (kind == kStream) {
    if (B <= 0 || N <= 0 || H <= 0 || C < 1 || C > kStreamMaxC || R <= 0 ||
        R % kRowsPerThread != 0)
      return false;
    const int U = (H + C - 1) / C;
    return (C - 1) * U < H && U * (R / kRowsPerThread) <= kMaxThreads &&
           smem_bytes(kStream, H, C, R) <= static_cast<size_t>(kMaxSmem);
  }
  if (B <= 0 || N <= 0 || H <= 0 || (C != 1 && C != 2 && C != 4 && C != 8) ||
      R <= 0 || R % kRowsPerThread != 0)
    return false;
  const int U = (H + C - 1) / C;
  if (kind == kFused && (H % C != 0 || U % 16 != 0)) return false;
  return (C - 1) * U < H && U * (R / kRowsPerThread) <= max_threads(kind);
}

template <typename T, int kKind>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T, int kKind>
cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && g_smem_allowed<T, kKind>[device].load() >= smem)
    return cudaSuccess;
  if constexpr (kKind == kStream) {   // clusters above 8 blocks
    err = cudaFuncSetAttribute(bigru_bwd_kernel<T, kKind>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(bigru_bwd_kernel<T, kKind>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<T, kKind>[device].store(smem);
  return err;
}

void make_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                 int kind, int B, int H, int C, int R, int dirs, size_t smem,
                 void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(C * ((B + R - 1) / R), dirs, 1);
  cfg->blockDim = dim3(kind == kFused ? kFusedMaxThreads
                                      : (H + C - 1) / C * (R / kRowsPerThread),
                       1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T, int kKind>
int launch(const void* w_f, const void* w_b, const void* gs_f,
           const void* hn_f, const void* ys_f, const void* dy_f,
           const void* gs_b, const void* hn_b, const void* ys_b,
           const void* dy_b, void* dx_f, void* dhn_f, void* dx_b, void* dhn_b,
           int B, int N, int H, int C, int R, int dirs, int rev,
           const FusedArgs<T>& fa, void* stream) {
  if (!valid_plan(kKind, B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(kKind, H, C, R);
  cudaError_t err = allow_smem<T, kKind>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, kKind, B, H, C, R, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bigru_bwd_kernel<T, kKind>, in(w_f),
                           in(w_b), in(gs_f), in(hn_f), in(ys_f), in(dy_f),
                           in(gs_b), in(hn_b), in(ys_b), in(dy_b), out(dx_f),
                           out(dhn_f), out(dx_b), out(dhn_b), B, N, H, R, rev,
                           fa);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused(const void* w_f, const void* w_b, const void* gs_f,
                 const void* hn_f, const void* ys_f, const void* dy_f,
                 const void* gs_b, const void* hn_b, const void* ys_b,
                 const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                 void* dhn_b, const void* x, const void* wih_f,
                 const void* wih_b, void* dxin_f, void* dxin_b, float* part,
                 float* dwih_f, float* dbih_f, float* dwhh_f, float* dbhh_f,
                 float* dwih_b, float* dbih_b, float* dwhh_b, float* dbhh_b,
                 int B, int N, int H, int D, int C, int R, void* stream) {
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs<T> fa{static_cast<const T*>(x), static_cast<const T*>(wih_f),
                  static_cast<const T*>(wih_b), static_cast<T*>(dxin_f),
                  static_cast<T*>(dxin_b), part, D};
  int rc = launch<T, kFused>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b,
                             ys_b, dy_b, dx_f, dhn_f, dx_b, dhn_b, B, N, H, C,
                             R, 2, 0, fa, stream);
  if (rc != 0) return rc;
  const size_t entries = static_cast<size_t>(D + H) * 3 * H + 6 * H;
  const dim3 grid(static_cast<unsigned>((entries + 255) / 256), 2);
  bigru_bwd_reduce_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, (B + R - 1) / R, D, H, R, dwih_f, dbih_f, dwhh_f, dbhh_f, dwih_b,
      dbih_b, dwhh_b, dbhh_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kKind>
int max_active_clusters(int H, int C, int R) {
  const size_t smem = smem_bytes(kKind, H, C, R);
  cudaError_t err = allow_smem<T, kKind>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, kKind, R, H, C, R, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bigru_bwd_kernel<T, kKind>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int max_active_clusters_of(int kind, int H, int C, int R) {
  switch (kind) {
    case kLinear: return max_active_clusters<T, kLinear>(H, C, R);
    case kSplit: return max_active_clusters<T, kSplit>(H, C, R);
    case kStream: return max_active_clusters<T, kStream>(H, C, R);
    default: return max_active_clusters<T, kFused>(H, C, R);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device, with clusters of C blocks over batch tiles of R rows (R a
// multiple of 4; each block owns ceil(H / C) units, the last block's slice
// masked past H; kFused: C divides H). All tensors are contiguous, in the stream type float
// (_f32) or bfloat16 (_bf16): w_* [H, 3H]; gs_* and dx_* [B, N, 3H]; hn_*,
// ys_*, dy_* and dhn_* [B, N, H]. Returns a cudaError_t code; 0 means the
// launch was accepted.
#define BIGRU_BWD_ENTRY(NAME, TYPE, KIND)                                     \
  int NAME(const void* w_f, const void* w_b, const void* gs_f,               \
           const void* hn_f, const void* ys_f, const void* dy_f,             \
           const void* gs_b, const void* hn_b, const void* ys_b,             \
           const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,            \
           void* dhn_b, int B, int N, int H, int C, int R, void* stream) {   \
    return launch<TYPE, KIND>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b,  \
                              ys_b, dy_b, dx_f, dhn_f, dx_b, dhn_b, B, N, H, \
                              C, R, 2, 0, FusedArgs<TYPE>{}, stream);        \
  }

BIGRU_BWD_ENTRY(bigru_bwd_f32, float, kLinear)
BIGRU_BWD_ENTRY(bigru_bwd_bf16, __nv_bfloat16, kLinear)
// The split kind (#10): as bigru_bwd_*, with the coefficients taken from
// the gates unrounded and the carry's product as three H-deep sums.
BIGRU_BWD_ENTRY(bigru_bwd_split_f32, float, kSplit)
BIGRU_BWD_ENTRY(bigru_bwd_split_bf16, __nv_bfloat16, kSplit)
// The stream kernel: as bigru_bwd_*, with w_* as W_hh^T [3H, H], clusters
// of C = 1 .. 16 blocks and any H whose plan fits.
BIGRU_BWD_ENTRY(bigru_bwd_stream_f32, float, kStream)
BIGRU_BWD_ENTRY(bigru_bwd_stream_bf16, __nv_bfloat16, kStream)
#undef BIGRU_BWD_ENTRY

// The tensor-core BPTT (bf16 streams, both directions): arguments and
// outputs as bigru_bwd_bf16, with clusters of C blocks (C in 1, 2, 4, 8
// dividing H into a whole number of 8-unit warps, at most 256 threads)
// over batch tiles of R = 16 or 32 rows; H a multiple of 16 up to 256.
int bigru_bwd_tc_bf16(const void* w_f, const void* w_b, const void* gs_f,
                      const void* hn_f, const void* ys_f, const void* dy_f,
                      const void* gs_b, const void* hn_b, const void* ys_b,
                      const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                      void* dhn_b, int B, int N, int H, int C, int R,
                      void* stream) {
  if (!valid_tc_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  return (R == 16 ? launch_tc_as<1, false> : launch_tc_as<2, false>)(
      w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b, dx_f, dhn_f,
      dx_b, dhn_b, B, N, H, C, stream);
}

// #10 (kSplit's function) on the tensor-core BPTT: arguments, outputs and
// plans as bigru_bwd_tc_bf16, whose layout (bigru_bwd_tc_layout) and
// cluster counts hold for it.
int bigru_bwd_split_tc_bf16(const void* w_f, const void* w_b,
                            const void* gs_f, const void* hn_f,
                            const void* ys_f, const void* dy_f,
                            const void* gs_b, const void* hn_b,
                            const void* ys_b, const void* dy_b, void* dx_f,
                            void* dhn_f, void* dx_b, void* dhn_b, int B,
                            int N, int H, int C, int R, void* stream) {
  if (!valid_tc_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  return (R == 16 ? launch_tc_as<1, true> : launch_tc_as<2, true>)(
      w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b, dx_f, dhn_f,
      dx_b, dhn_b, B, N, H, C, stream);
}

// How many clusters of the tensor-core BPTT at hidden size H, cluster size
// C and tile R the current device runs at once (kLinear's instance; #10's
// kSplitCoef instance has the same threads and shared memory, and the
// wrapper plans both from this count); a negative cudaError_t code
// on failure. `save` is taken for the forward source's signature of this
// query and ignored.
int bigru_bwd_tc_max_active_clusters(int save, int H, int C, int R) {
  (void)save;
  if (!valid_tc_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return R == 16 ? tc_max_active_clusters_as<1>(H, C)
                 : tc_max_active_clusters_as<2>(H, C);
}

// The tensor-core BPTT's layout at H, C and R, for the wrapper's mirror:
// what 0 = dynamic shared memory in bytes, 1 = threads a block, 2 = W_hh
// fragment registers a lane holds; -1 for a plan it does not take.
int bigru_bwd_tc_layout(int what, int H, int C, int R) {
  if (!valid_tc_plan(1, 1, H, C, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(tc_smem_bytes(H, C, R));
    case 1: return tc_threads(H, C);
    case 2: return kTcWeightRegs;
    default: return -1;
  }
}

// The fused layer VJP (#9): bigru_bwd_*'s walk, whose dx_* and dhn_* are
// scratch here, and the input-side gradients of the layer. x [B, N, D] and
// wih_* [D, 3H] in the stream type; dxin_* [B, N, D] out in it; part holds
// 2 * ceil(B / R) clusters' float32 partials of (D + H) * 3H + (R / 4) * 4H
// floats each, zeroed by the caller; dwih_* [D, 3H], dbih_* [3H], dwhh_*
// [H, 3H], dbhh_* [3H] out in float32. (H / C) must be a multiple of 16.
// Two launches on `stream`: the walk, then the reduction of the partials.
#define BIGRU_BWD_FUSED_ENTRY(NAME, TYPE)                                     \
  int NAME(const void* w_f, const void* w_b, const void* gs_f,               \
           const void* hn_f, const void* ys_f, const void* dy_f,             \
           const void* gs_b, const void* hn_b, const void* ys_b,             \
           const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,            \
           void* dhn_b, const void* x, const void* wih_f, const void* wih_b, \
           void* dxin_f, void* dxin_b, float* part, float* dwih_f,           \
           float* dbih_f, float* dwhh_f, float* dbhh_f, float* dwih_b,       \
           float* dbih_b, float* dwhh_b, float* dbhh_b, int B, int N, int H, \
           int D, int C, int R, void* stream) {                              \
    return launch_fused<TYPE>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b,  \
                              ys_b, dy_b, dx_f, dhn_f, dx_b, dhn_b, x, wih_f, \
                              wih_b, dxin_f, dxin_b, part, dwih_f, dbih_f,   \
                              dwhh_f, dbhh_f, dwih_b, dbih_b, dwhh_b,        \
                              dbhh_b, B, N, H, D, C, R, stream);             \
  }

BIGRU_BWD_FUSED_ENTRY(bigru_bwd_fused_f32, float)
BIGRU_BWD_FUSED_ENTRY(bigru_bwd_fused_bf16, __nv_bfloat16)
#undef BIGRU_BWD_FUSED_ENTRY

// One direction of a GRU: as bigru_bwd_* with a grid of one direction over
// w [H, 3H], gs and dx [B, N, 3H], hn, ys, dy and dhn [B, N, H]; reverse != 0
// for a direction whose forward walked t = N-1 .. 0. The cluster count of
// bigru_bwd_max_active_clusters (kind 0) holds.
int gru_bwd_f32(const void* w, const void* gs, const void* hn, const void* ys,
                const void* dy, void* dx, void* dhn, int B, int N, int H,
                int C, int R, int reverse, void* stream) {
  return launch<float, kLinear>(w, w, gs, hn, ys, dy, gs, hn, ys, dy, dx, dhn,
                                dx, dhn, B, N, H, C, R, 1, reverse,
                                FusedArgs<float>{}, stream);
}

int gru_bwd_bf16(const void* w, const void* gs, const void* hn,
                 const void* ys, const void* dy, void* dx, void* dhn, int B,
                 int N, int H, int C, int R, int reverse, void* stream) {
  return launch<__nv_bfloat16, kLinear>(
      w, w, gs, hn, ys, dy, gs, hn, ys, dy, dx, dhn, dx, dhn, B, N, H, C, R,
      1, reverse, FusedArgs<__nv_bfloat16>{}, stream);
}

// The stream kernel with a grid of one direction: as gru_bwd_*, with w as
// W_hh^T [3H, H] and clusters of C = 1 .. 16 blocks.
int gru_bwd_stream_f32(const void* w, const void* gs, const void* hn,
                       const void* ys, const void* dy, void* dx, void* dhn,
                       int B, int N, int H, int C, int R, int reverse,
                       void* stream) {
  return launch<float, kStream>(w, w, gs, hn, ys, dy, gs, hn, ys, dy, dx,
                                dhn, dx, dhn, B, N, H, C, R, 1, reverse,
                                FusedArgs<float>{}, stream);
}

int gru_bwd_stream_bf16(const void* w, const void* gs, const void* hn,
                        const void* ys, const void* dy, void* dx, void* dhn,
                        int B, int N, int H, int C, int R, int reverse,
                        void* stream) {
  return launch<__nv_bfloat16, kStream>(
      w, w, gs, hn, ys, dy, gs, hn, ys, dy, dx, dhn, dx, dhn, B, N, H, C, R,
      1, reverse, FusedArgs<__nv_bfloat16>{}, stream);
}

// How many clusters of the stream kernel (bf16: 0 or 1; `save` is taken for
// the forward source's signature and ignored) at H, C and R the current
// device runs at once, and its dynamic shared memory in bytes (-1 for a
// plan it does not take), for the wrapper's planner and mirror.
int bigru_bwd_stream_max_active_clusters(int bf16, int save, int H, int C,
                                         int R) {
  (void)save;
  if (!valid_plan(kStream, 1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? max_active_clusters<__nv_bfloat16, kStream>(H, C, R)
              : max_active_clusters<float, kStream>(H, C, R);
}

int bigru_bwd_stream_smem_bytes(int H, int C, int R) {
  if (!valid_plan(kStream, 1, 1, H, C, R)) return -1;
  return static_cast<int>(smem_bytes(kStream, H, C, R));
}

// The unit kernel (H <= 64), batch tiles of R rows (1, 2 or 4): both
// directions of a BiGRU layer (bigru_bwd_unit_*: arguments and outputs as
// bigru_bwd_* without the cluster size; bigru_bwd_split_unit_*: #10, the
// same with kSplit's function) or one direction of a GRU (gru_bwd_unit_*:
// as gru_bwd_*).
#define GRU_BWD_UNIT_ENTRIES(SFX, TYPE)                                       \
  int bigru_bwd_unit_##SFX(const void* w_f, const void* w_b,                 \
                           const void* gs_f, const void* hn_f,               \
                           const void* ys_f, const void* dy_f,               \
                           const void* gs_b, const void* hn_b,               \
                           const void* ys_b, const void* dy_b, void* dx_f,   \
                           void* dhn_f, void* dx_b, void* dhn_b, int B,      \
                           int N, int H, int R, void* stream) {              \
    return launch_unit<TYPE, false>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b,  \
                                    hn_b, ys_b, dy_b, dx_f, dhn_f, dx_b,     \
                                    dhn_b, B, N, H, R, 2, 0, stream);        \
  }                                                                          \
  int bigru_bwd_split_unit_##SFX(                                            \
      const void* w_f, const void* w_b, const void* gs_f, const void* hn_f,  \
      const void* ys_f, const void* dy_f, const void* gs_b,                  \
      const void* hn_b, const void* ys_b, const void* dy_b, void* dx_f,      \
      void* dhn_f, void* dx_b, void* dhn_b, int B, int N, int H, int R,      \
      void* stream) {                                                        \
    return launch_unit<TYPE, true>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b,   \
                                   hn_b, ys_b, dy_b, dx_f, dhn_f, dx_b,      \
                                   dhn_b, B, N, H, R, 2, 0, stream);         \
  }                                                                          \
  int gru_bwd_unit_##SFX(const void* w, const void* gs, const void* hn,      \
                         const void* ys, const void* dy, void* dx,           \
                         void* dhn, int B, int N, int H, int R, int reverse, \
                         void* stream) {                                     \
    return launch_unit<TYPE, false>(w, w, gs, hn, ys, dy, gs, hn, ys, dy,    \
                                    dx, dhn, dx, dhn, B, N, H, R, 1,         \
                                    reverse, stream);                        \
  }

GRU_BWD_UNIT_ENTRIES(f32, float)
GRU_BWD_UNIT_ENTRIES(bf16, __nv_bfloat16)
#undef GRU_BWD_UNIT_ENTRIES

// How many blocks of the unit kernel (bf16: 0 or 1) at hidden size H and
// tile R one SM of the current device runs at once; a negative cudaError_t
// code on failure. `save` is taken for the forward sources' signature of
// this query and ignored (the BPTT has one variant).
int gru_bwd_unit_blocks_per_sm(int bf16, int save, int H, int R) {
  (void)save;
  if (!valid_unit_plan(1, 1, H, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? unit_blocks_per_sm<__nv_bfloat16>(H, R)
              : unit_blocks_per_sm<float>(H, R);
}

// The unit kernel's layout at hidden size H and tile R, for the wrapper's
// mirror: what 0 = static shared memory in bytes, 1 = threads a block, 2 =
// W_hh values a lane holds in registers; -1 for a plan it does not take.
int gru_bwd_unit_layout(int what, int H, int R) {
  if (!valid_unit_plan(1, 1, H, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(unit_smem_bytes(R));
    case 1: return unit_threads(H);
    case 2: return 3 * kKPerLane;
    default: return -1;
  }
}

// How many clusters of kind (0 linear, 1 split, 2 fused) the current device
// runs at once (bf16: 0 or 1); a negative cudaError_t code on failure.
int bigru_bwd_max_active_clusters(int bf16, int kind, int H, int C, int R) {
  if (kind < kLinear || kind > kFused || !valid_plan(kind, 1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? max_active_clusters_of<__nv_bfloat16>(kind, H, C, R)
              : max_active_clusters_of<float>(kind, H, C, R);
}

// Dynamic shared memory, in bytes, one block of kind needs at H, C and R,
// or -1 for a plan the kind does not take. The wrapper holds its mirror of
// the plan rule and of smem_bytes (bigru_smem_bytes) to this at load.
int bigru_bwd_smem_bytes(int kind, int H, int C, int R) {
  if (kind < kLinear || kind > kFused || !valid_plan(kind, 1, 1, H, C, R))
    return -1;
  return static_cast<int>(smem_bytes(kind, H, C, R));
}

const char* bigru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
