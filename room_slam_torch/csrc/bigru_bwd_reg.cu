// Fused GRU recurrence, backward (BPTT), float32 or bfloat16 streams, at H
// 65-256: the register cluster kernel, each block's gate columns of W_hh
// held in registers and the carry's product split by k across a
// thread-block cluster. Two grids: both directions of a BiGRU layer
// (bigru_bwd_reg_*), or one direction of a GRU (gru_bwd_reg_*, with a
// reverse flag).
//
// Replaces, at these widths, two TPU kernels: room_slam_tpu/ops/
// gru_pallas.py::_bigru_bwd_kernel (:357, pallas_call :527) with the grid's
// two directions, and _gru_bwd_kernel (:71, pallas_call :218) with a grid
// of one direction. The function, rounding points and outputs are those of
// bigru_bwd.cu's kLinear kind: from the residuals of the training forward
// (r, z, n, hn) and ys, with h_prev the output one step earlier in the
// forward order (zero at its first step),
//
//   a   = (1 - z) * (1 - n^2)
//   c   = T([a * hn * r * (1 - r), (h_prev - n) * z * (1 - z), a])
//   dh_t = dy_t + dh_carry
//   dx   = [dh_t, dh_t, dh_t] * c                 (stored as T)
//   dhn  = dx_n * r                               (stored as T)
//   dh_carry = T([dx_r, dx_z, dhn]) @ T(W_hh)^T + dh_t * z   (f32 sums)
//
// The forward direction walks t = N-1 .. 0; the backward-in-time direction
// (and a one-direction GRU run with reverse) t = 0 .. N-1.
//
// With kSplitCoef (bigru_bwd_split_reg_*, #10: room_slam_tpu/tools/
// bench_bigru_bwd.py::_bwd_kernel_split, :127, pallas_call :198, at these
// widths on #6's route) a cell forms bigru_bwd.cu's kSplit function
// instead, from its gates unrounded: dn = dh_t (1 - z)(1 - n^2), dz = dh_t
// (h_prev - n) z (1 - z), dr = dn hn r (1 - r), dhn = dn r, and sends
// T([dr, dz, dhn]). The carry keeps this kernel's order, the C blocks'
// partials (each over the block's 3U gate columns, the gates interleaved)
// in rank order, then dh_t z: no three per-gate sums, which would cost
// 4R more registers a thread. #10 is planned and launched as #6; its
// first design (bigru_bwd.cu's kSplit cluster kernel, which held it back:
// 5.4 / 6.1 ms at (32, 500, 255) f32 / bf16) stays reachable by a forced
// cluster plan. On an H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 28) #10 takes 1.714 / 1.710 ms there beside #6's 1.707 / 1.724:
// what bounds #6 below bounds it.
//
// What bounds it on an H100. At (32, 500, 255) f32, two directions, it
// reads 3H + H + H + H and writes 3H + H values per (row, step) and
// direction (163 MB, 49 us at 3.35 TB/s) and does 12.5 GFLOP for the
// carry's product (186 us at 67 TFLOP/s for f32 FMAs); the floor is the
// chain of 500 dependent steps. The first cluster design (bigru_bwd.cu
// bigru_bwd_kernel<T, kLinear>, reached by a forced ("cluster", C, R)
// plan) took 13.6 us a step there (PERF.md section 6): each block holds
// its units' rows of W_hh^T in shared memory, pushes its cells' 3H-wide
// [dx_r, dx_z, dhn] in the stream type to every block by generic
// distributed-shared-memory stores, a cluster.sync() ends every step, and
// each thread then walks a serial 3H-deep (765 at H=255) chain of shared
// loads for its dot product.
//
// What the design does about it: bilstm_bwd.cu's register cluster scheme
// with three gates.
// - The forward's slice in registers. Block q of a cluster of C <= 16 owns
//   U = ceil(H / C) units, up to a power of two, at least 8 (the last slice
//   masked past H), and holds W_hh[k, j] for every k and its own 3U gate
//   columns j: thread t holds k0 = 2 (t / JL) and k0 + 1 for 24 of the
//   columns, JL = U / 8 lanes a pair (48 registers, rounded from the
//   stream type once).
// - A K-split. Each step the block's cells (thread t < U R owns unit t / R,
//   row t % R) write their rounded dg = [dx_r, dx_z, dhn] into a
//   [R / RQ][U / 8][24 RQ + 4] tile of the block's own columns (the padding
//   keeps the JL lanes' reads on distinct banks), one block barrier, and
//   each thread forms the partial dh of its k pair for every row from that
//   tile (16-byte broadcasts, KC columns x RQ rows x 2 k = 8 FMAs each);
//   the JL lanes' partials meet by __shfl_xor_sync. No dg leaves the block.
// - The exchange: each pair's 2R partials go, as float32 by st.async (16
//   or 8 bytes a piece), into slot q of the next buffer of the block
//   owning k0, completing on its mbarrier (this block's own pairs by a
//   store); each warp then arrives on its own block's mbarrier. (C - 1) / C
//   x H x R float32 values a block a step, against (C - 1) / C x 3H x R
//   stream values for the first design's dg exchange. The owner's cell sums
//   the C partials of its unit in rank order, then adds dh_t * z, so the
//   result is bit-equal from run to run. A step waits on its own mbarrier
//   only; the wait is an acquire at the block's scope.
// - Off the chain: the six inputs of a cell (r, z, n, hn, h_prev, dy)
//   loaded two steps ahead by consecutive threads on consecutive units into
//   a two-slot ring, the outputs (dx_r, dx_z, dx_n, dhn) through a
//   three-slot staging area out as coalesced stores after the warp's
//   arrival, every index a shift and a mask.
// Register budget: 48 W_hh values, 2R accumulators and kLoads input values
// a thread (the plan rule keeps 6 U R <= kLoads x threads); blocks of at
// most 256 threads, two blocks an SM, 128 registers a thread (phase 2 of
// chip_smoke.py reports each instance's registers and spills).
//
// Measured on an H100 (chip_smoke.py phase 41, PERF.md section 6): about
// 3.4 us a step at (32, 500, 255) f32 on 8-row tiles (kLinear 13.6), 9.3
// at the scale-up batch (128, 5000, 256) f32 in three waves (kLinear 17.7).
//
// What bounds it now: the step's chain (the wait, the C partials' sum, the
// coefficients, the block barrier, a 24-deep FMA chain a plane, the
// shuffles, the exchange and the arrival) and, at large batches, the
// waves: one copy of W_hh in registers per batch tile, 2 * B / R clusters
// against the 14-16 clusters of 16 blocks an H100 holds at once. The
// wrapper (ops/gru_cuda.py gru_bwd_kernel_route, bigru_reg_plans) picks
// the kernel, the cluster and the tile from the card's own counts, and may
// force the first design or the pipe kernel for an A/B.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxH = 256;           // the widest H the plan rule takes
constexpr int kJPerLane = 24;        // gate columns of the sum a lane holds
constexpr int kMaxThreads = 256;     // __launch_bounds__, two blocks an SM
constexpr int kLoads = 4;            // input values a thread loads a step
constexpr int kStages = 3;           // output staging slots (steps)
constexpr int kMaxC = 16;            // a non-portable cluster of 16 at most
constexpr int kIn = 6;               // staged inputs: r, z, n, hn, h_prev, dy
constexpr int kOut = 4;              // staged outputs: dx_r, dx_z, dx_n, dhn
constexpr int kMaxSmem = 232448;     // dynamic shared memory of one block
constexpr int kMaxDevices = 64;
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

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// units a block owns: ceil(H / C) up to a power of two, at least 8 (a
// lane's 24 columns of the block's 3U); the last block's slice is masked
// past H
__host__ __device__ __forceinline__ int reg_units(int H, int C) {
  const int u = pow2_at_least((H + C - 1) / C);
  return u < 8 ? 8 : u;
}

// threads: JL = U / 8 lanes for each pair of k (of ceil(H / 2)), whole warps
__host__ __device__ __forceinline__ int reg_threads(int H, int C) {
  return ((H + 1) / 2 * (reg_units(H, C) / 8) + 31) / 32 * 32;
}

// floats of a 24-column group of one plane of the dg tile (4 padding
// floats keep the JL lanes' 16-byte reads on distinct banks)
__host__ __device__ __forceinline__ int reg_group(int RQ) {
  return kJPerLane * RQ + 4;
}

// floats of dynamic shared memory: the dg tile [R / RQ][U / 8][group], the
// partials [2][C][U][R], the input ring [2][R][6][U + 1] and the output
// staging [3][4][R][U + 1]
__host__ __device__ __forceinline__ size_t reg_smem_floats(int H, int C,
                                                           int R) {
  const int RQ = R < 4 ? R : 4;
  const size_t U = static_cast<size_t>(reg_units(H, C));
  return (R / RQ) * (U / 8) * reg_group(RQ) + 2 * C * U * R +
         (2 * kIn + kStages * kOut) * R * (U + 1);
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
// top. Thread t holds W_hh[k0 + i, column of jl * 24 + jj] (i < 2, jj < 24)
// of the block's 3U gate columns (column jb: gate jb / U of unit rank * U +
// jb % U), k0 = 2 * (t / JL), jl = t % JL, JL = U / 8; thread t < U * R
// also owns the cell (unit t / R, row t % R) of the block. kSplitCoef:
// #10's coefficient step (bigru_bwd.cu's kSplit function), the same chain,
// exchange and plan.
template <typename T, int R, bool kSplitCoef>
__global__ void __launch_bounds__(kMaxThreads, 2)
bigru_bwd_reg_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                     const T* __restrict__ gs_f, const T* __restrict__ hn_f,
                     const T* __restrict__ ys_f, const T* __restrict__ dy_f,
                     const T* __restrict__ gs_b, const T* __restrict__ hn_b,
                     const T* __restrict__ ys_b, const T* __restrict__ dy_b,
                     T* __restrict__ dx_f, T* __restrict__ dhn_f,
                     T* __restrict__ dx_b, T* __restrict__ dhn_b, int B,
                     int N, int H, int rev) {
  constexpr int RQ = R < 4 ? R : 4;       // rows of one float4 read
  constexpr int QD = R / RQ;              // planes of the dg tile
  constexpr int KC = 4 / RQ;              // columns of one float4 read
  constexpr int kChunks = kJPerLane / KC;
  constexpr int GP = kJPerLane * RQ + 4;
  constexpr int kPieces = R >= 2 ? R / 2 : 1;   // of 16 (R = 1: 8) bytes
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 reg_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = reg_units(H, C);
  const int lgU = __ffs(U) - 1;    // U is a power of two: shifts, no divides
  const int UP = U + 1;
  const int JL = U / 8;
  const int lgJL = lgU - 3;
  const int KG = (H + 1) / 2;                    // pairs of k
  const int G = 3 * H;
  const int threads = static_cast<int>(blockDim.x);
  float* dgt = reinterpret_cast<float*>(reg_smem);   // [QD][U / 8][GP]
  float* part = dgt + QD * (U / 8) * GP;             // [2][C][U][R]
  float* ring = part + 2 * C * U * R;                // [2][R][6][UP]
  float* stage = ring + 2 * kIn * R * UP;            // [3][4][R][UP]
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int jl = tid & (JL - 1);
  const int kg = tid >> lgJL;
  const int k0 = 2 * kg;
  const int row0 = (blockIdx.x / C) * R;

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
  // the walk: t = N-1 .. 0 for the forward direction; h_prev is h at the
  // forward order's previous step (t - 1 forward, t + 1 backward), zero at
  // its first
  auto t_of = [&](int s) { return bwd ? s : N - 1 - s; };
  const int first = bwd ? N - 1 : 0;
  const int dprev = bwd ? 1 : -1;

  // this thread's W_hh values: column jb = jl * 24 + jj of the block, gate
  // jb / U of unit rank * U + jb % U; zero past H
  float wr[2][kJPerLane];
#pragma unroll
  for (int jj = 0; jj < kJPerLane; ++jj) {
    const int jb = jl * kJPerLane + jj;
    const int unit = rank * U + (jb & (U - 1));
    const int col = (jb >> lgU) * H + unit;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wr[i][jj] = kg < KG && k0 + i < H && unit < H
                      ? to_f32<T>(w[static_cast<size_t>(k0 + i) * G + col])
                      : 0.0f;
  }
  // the tile, and the partials: the slots of units past H are never sent
  for (int i = tid; i < QD * (U / 8) * GP + 2 * C * U * R; i += threads)
    dgt[i] = 0.0f;

  // a step's inputs, element e = (r * 6 + q) * U + u of the block's units
  // (consecutive threads on consecutive units): loaded into registers two
  // steps ahead, put into their ring slot the step before they are used
  const int n_in = kIn * R * U;
  T xr[kLoads];
  auto in_at = [&](int s, int e) -> const T* {   // nullptr: a zero
    const int t = t_of(s);
    const int u = e & (U - 1), rq = e >> lgU;
    const int q = rq % kIn, row = row0 + rq / kIn;
    const int gu = rank * U + u;
    if (row >= B || gu >= H || (q == 4 && t == first)) return nullptr;
    const size_t cell = static_cast<size_t>(row) * N + t;
    if (q < 3) return gs + cell * G + q * H + gu;
    if (q == 3) return hns + cell * H + gu;
    if (q == 4) return ys + (cell + dprev) * H + gu;
    return dys + cell * H + gu;
  };
  auto load_in = [&](int s) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = tid + j * threads;
      if (e < n_in) {
        const T* p = in_at(s, e);
        xr[j] = p ? *p : from_f32<T>(0.0f);
      }
    }
  };
  auto store_in = [&](int s) {
    float* slot = ring + (s & 1) * kIn * R * UP;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = tid + j * threads;
      if (e < n_in) slot[(e >> lgU) * UP + (e & (U - 1))] = to_f32<T>(xr[j]);
    }
  };
  // the staged outputs of a step, element (q * R + r) * U + u, stored with
  // consecutive threads on consecutive units (at most 3 a thread: 6UR <=
  // kLoads threads)
  auto flush = [&](int s, int slot) {
    const size_t t = static_cast<size_t>(t_of(s));
    const float* st = stage + slot * kOut * R * UP;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = tid + j * threads;
      if (e >= kOut * R * U) break;
      const int u = e & (U - 1), qr = e >> lgU;
      const int q = qr / R, row = row0 + qr % R, gu = rank * U + u;
      if (row < B && gu < H) {
        const T v = from_f32<T>(st[qr * UP + u]);
        const size_t cell = static_cast<size_t>(row) * N + t;
        if (q < 3)
          dx[cell * G + q * H + gu] = v;
        else
          dhn[cell * H + gu] = v;
      }
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
  const int cu = tid / R, cr = tid & (R - 1);   // the cell's unit and row
  float dhz = 0.0f;               // dh_t * z of the previous step
  int slot = 0;                   // the step's staging slot, s % kStages
  for (int s = 0; s < N; ++s) {
    const int buf = s & 1;
    if (s > 0) mbar_wait(bar + buf * 8, ((s - 1) >> 1) & 1);
    if (cell) {
      const float* in = ring + buf * kIn * R * UP + cr * kIn * UP + cu;
      const float rg = in[0], zg = in[UP], ng = in[2 * UP];
      const float hn = in[3 * UP], hp = in[4 * UP];
      float c_r = 0.0f, c_z = 0.0f, c_n = 0.0f;   // kLinear's coefficients
      if constexpr (!kSplitCoef) {
        const float a = (1.0f - zg) * (1.0f - ng * ng);
        c_r = round_to<T>(a * hn * rg * (1.0f - rg));
        c_z = round_to<T>((hp - ng) * zg * (1.0f - zg));
        c_n = round_to<T>(a);
      }
      // the carry's product: the C blocks' partials in rank order (none at
      // step 0), then dh_t * z of the previous step
      float dh = 0.0f;
      if (s > 0) {
        const float* pp = part + (buf * C * U + cu) * R + cr;
        for (int q = 0; q < C; ++q) dh += pp[q * U * R];
      }
      const float dh_t = in[5 * UP] + (dh + dhz);
      float d[3];
      if constexpr (kSplitCoef) {
        d[2] = dh_t * (1.0f - zg) * (1.0f - ng * ng);
        d[1] = dh_t * (hp - ng) * zg * (1.0f - zg);
        d[0] = d[2] * hn * rg * (1.0f - rg);
      } else {
        d[0] = dh_t * c_r;
        d[1] = dh_t * c_z;
        d[2] = dh_t * c_n;
      }
      const float dhn_t = d[2] * rg;
      dhz = dh_t * zg;
      const float dg[3] = {d[0], d[1], dhn_t};
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const int jb = g * U + cu;
        dgt[(cr / RQ) * (U / 8) * GP + (jb / kJPerLane) * GP +
            (jb % kJPerLane) * RQ + cr % RQ] = round_to<T>(dg[g]);
      }
      float* st = stage + slot * kOut * R * UP + cr * UP + cu;
      st[0] = d[0];
      st[R * UP] = d[1];
      st[2 * R * UP] = d[2];
      st[3 * R * UP] = dhn_t;
    }
    const int prev = slot == 0 ? kStages - 1 : slot - 1;
    if (s + 1 == N) {
      if (s > 0) flush(s - 1, prev);
      break;
    }
    __syncthreads();   // the step's dg tile is whole

    // partial dh_carry[k0 + i] of the block's columns: T(dg) . T(W_hh[k0 +
    // i, :]), the lane's 24 columns, then the JL lanes' partials
    float acc[2][R];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] = 0.0f;
#pragma unroll
    for (int qd = 0; qd < QD; ++qd) {
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
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
  __syncthreads();
  flush(N - 1, slot);
  // no block exits while another may still write into it
  cluster.sync();
}

// The plan rule (the wrapper's _reg_rule(..., gates=3) and
// reg_smem_bytes("bwd", ..., gates=3) mirror it, held to
// bigru_bwd_reg_layout when the library loads): H up to kMaxH, a cluster of
// up to kMaxC blocks each owning a unit at least, tiles of 1, 2, 4 or 8
// rows, at most kMaxThreads threads and kMaxSmem bytes a block, and at most
// kLoads of a step's inputs a thread.
bool valid_reg_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || H > kMaxH || C < 1 || C > kMaxC ||
      (R != 1 && R != 2 && R != 4 && R != 8))
    return false;
  const int U = reg_units(H, C);
  return (C - 1) * U < H && reg_threads(H, C) <= kMaxThreads &&
         kIn * U * R <= kLoads * reg_threads(H, C) &&
         reg_smem_floats(H, C, R) * sizeof(float) <= kMaxSmem;
}

// The dynamic shared memory (and clusters above 8 blocks) an instance may
// use, set once per device and again only for more.
template <typename T, int R, bool kSplitCoef>
cudaError_t reg_prepare(int smem) {
  static std::atomic<int> allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bigru_bwd_reg_kernel<T, R, kSplitCoef>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bigru_bwd_reg_kernel<T, R, kSplitCoef>,
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

template <typename T, int R, bool kSplitCoef>
int launch_reg_as(const void* w_f, const void* w_b, const void* gs_f,
                  const void* hn_f, const void* ys_f, const void* dy_f,
                  const void* gs_b, const void* hn_b, const void* ys_b,
                  const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                  void* dhn_b, int B, int N, int H, int C, int dirs, int rev,
                  void* stream) {
  const size_t smem = reg_smem_floats(H, C, R) * sizeof(float);
  cudaError_t err = reg_prepare<T, R, kSplitCoef>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, (B + R - 1) / R, H, C, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bigru_bwd_reg_kernel<T, R, kSplitCoef>,
                           in(w_f),
                           in(w_b), in(gs_f), in(hn_f), in(ys_f), in(dy_f),
                           in(gs_b), in(hn_b), in(ys_b), in(dy_b), out(dx_f),
                           out(dhn_f), out(dx_b), out(dhn_b), B, N, H, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSplitCoef>
int launch_reg(const void* w_f, const void* w_b, const void* gs_f,
               const void* hn_f, const void* ys_f, const void* dy_f,
               const void* gs_b, const void* hn_b, const void* ys_b,
               const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
               void* dhn_b, int B, int N, int H, int C, int R, int dirs,
               int rev, void* stream) {
  if (!valid_reg_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* fn = R == 1   ? launch_reg_as<T, 1, kSplitCoef>
             : R == 2 ? launch_reg_as<T, 2, kSplitCoef>
             : R == 4 ? launch_reg_as<T, 4, kSplitCoef>
                      : launch_reg_as<T, 8, kSplitCoef>;
  return fn(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b, dy_b, dx_f,
            dhn_f, dx_b, dhn_b, B, N, H, C, dirs, rev, stream);
}

// kLinear's instances (#10's have the same threads and shared memory)
template <typename T, int R>
int reg_max_active_as(int H, int C) {
  const size_t smem = reg_smem_floats(H, C, R) * sizeof(float);
  cudaError_t err = reg_prepare<T, R, false>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, 1, H, C, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bigru_bwd_reg_kernel<T, R, false>,
                                       &cfg);
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
// device, with clusters of C = 1 .. 16 blocks over batch tiles of R = 1, 2,
// 4 or 8 rows; H up to 256. Arguments and outputs as bigru_bwd.cu's
// cluster entries: contiguous tensors in the stream type float (_f32) or
// bfloat16 (_bf16), w [H, 3H]; gs and dx [B, N, 3H]; hn, ys, dy and dhn
// [B, N, H]; the one-direction entry for a direction whose forward walked
// t = N-1 .. 0 where reverse != 0. bigru_bwd_split_reg_*: #10, as
// bigru_bwd_reg_* with kSplit's function. Returns a cudaError_t code; 0
// means the launch was accepted.
#define BIGRU_BWD_REG_ENTRIES(SFX, TYPE)                                      \
  int bigru_bwd_reg_##SFX(const void* w_f, const void* w_b,                  \
                          const void* gs_f, const void* hn_f,                \
                          const void* ys_f, const void* dy_f,                \
                          const void* gs_b, const void* hn_b,                \
                          const void* ys_b, const void* dy_b, void* dx_f,    \
                          void* dhn_f, void* dx_b, void* dhn_b, int B,       \
                          int N, int H, int C, int R, void* stream) {        \
    return launch_reg<TYPE, false>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b,   \
                                   hn_b, ys_b, dy_b, dx_f, dhn_f, dx_b,      \
                                   dhn_b, B, N, H, C, R, 2, 0, stream);      \
  }                                                                          \
  int bigru_bwd_split_reg_##SFX(                                             \
      const void* w_f, const void* w_b, const void* gs_f, const void* hn_f,  \
      const void* ys_f, const void* dy_f, const void* gs_b,                  \
      const void* hn_b, const void* ys_b, const void* dy_b, void* dx_f,      \
      void* dhn_f, void* dx_b, void* dhn_b, int B, int N, int H, int C,      \
      int R, void* stream) {                                                 \
    return launch_reg<TYPE, true>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b,    \
                                  hn_b, ys_b, dy_b, dx_f, dhn_f, dx_b,       \
                                  dhn_b, B, N, H, C, R, 2, 0, stream);       \
  }                                                                          \
  int gru_bwd_reg_##SFX(const void* w, const void* gs, const void* hn,       \
                        const void* ys, const void* dy, void* dx, void* dhn, \
                        int B, int N, int H, int C, int R, int reverse,      \
                        void* stream) {                                      \
    return launch_reg<TYPE, false>(w, w, gs, hn, ys, dy, gs, hn, ys, dy, dx, \
                                   dhn, dx, dhn, B, N, H, C, R, 1, reverse,  \
                                   stream);                                  \
  }

BIGRU_BWD_REG_ENTRIES(f32, float)
BIGRU_BWD_REG_ENTRIES(bf16, __nv_bfloat16)
#undef BIGRU_BWD_REG_ENTRIES

// How many clusters of the kernel (bf16: 0 or 1; `save` is taken for the
// forward source's signature and ignored) at H, C and R the current device
// runs at once; a negative cudaError_t code on failure.
int bigru_bwd_reg_max_active_clusters(int bf16, int save, int H, int C,
                                      int R) {
  (void)save;
  if (!valid_reg_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? reg_max_active<__nv_bfloat16>(H, C, R)
              : reg_max_active<float>(H, C, R);
}

// The kernel's layout at H, C and R, for the wrapper's mirror: what 0 =
// dynamic shared memory in bytes, 1 = threads a block, 2 = units a block;
// -1 for a plan it does not take.
int bigru_bwd_reg_layout(int what, int H, int C, int R) {
  if (!valid_reg_plan(1, 1, H, C, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(reg_smem_floats(H, C, R) * sizeof(float));
    case 1: return reg_threads(H, C);
    case 2: return reg_units(H, C);
    default: return -1;
  }
}

const char* bigru_bwd_reg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
