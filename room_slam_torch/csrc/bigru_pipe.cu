// The GRU BPTT's pipe kernel (bigru_bwd_pipe_kernel), float32 or bfloat16
// streams, both directions of a BiGRU layer (bigru_bwd_pipe_*) or one
// direction of a GRU (gru_bwd_pipe_*, with a reverse flag): the route of
// the BPTT above H = 256 to H = 1024 (gru_cuda.gru_bwd_kernel_route). Its
// own source, so that nvcc builds it beside bigru_bwd.cu.
//
// Replaces, at those widths, the same two TPU kernels as bigru_bwd.cu's
// kLinear: room_slam_tpu/ops/gru_pallas.py::_bigru_bwd_kernel (:357,
// pallas_call :527) with the grid's two directions and _gru_bwd_kernel
// (:71, pallas_call :218) with a grid of one direction. The per-step
// arithmetic, the rounding points and the outputs are kLinear's (see
// bigru_bwd.cu's notes): with T() the rounding to the stream type and
// h_prev the output one step earlier in the forward order (zero at its
// first step),
//
//   a   = (1 - z) * (1 - n^2)
//   c   = T([a * hn * r * (1 - r), (h_prev - n) * z * (1 - z), a])
//   dh_t = dy_t + dh_carry
//   dx   = [dh_t, dh_t, dh_t] * c                 (stored as T)
//   dhn  = dx_n * r                               (stored as T)
//   dh_carry = dh_t * z + T([dx_r, dx_z, dhn]) @ T(W_hh)^T
//
// only the order of the float32 sums of the product differs: here the C
// blocks' partial sums, each over its own 3U gate columns, added in rank
// order, then dh_t * z.
//
// With kSplitCoef (bigru_bwd_split_pipe_*, #10: room_slam_tpu/tools/
// bench_bigru_bwd.py::_bwd_kernel_split, :127, pallas_call :198, at these
// widths on #6's route) a cell forms bigru_bwd.cu's kSplit function
// instead, from its gates unrounded (dn = dh_t (1 - z)(1 - n^2), dz = dh_t
// (h_prev - n) z (1 - z), dr = dn hn r (1 - r), dhn = dn r) and stores
// T([dr, dz, dhn]) as its dg. The carry keeps this kernel's order (the
// partials above, a chunk's 12 columns mixing gates): three per-gate
// accumulators would take 8R more registers a consumer thread. #10's first
// design (the kSplit cluster kernel) takes only the multiples of 8 from 264
// to 360 of these widths, which held it back: no kernel above; #10 is
// planned and launched as #6. On an H100 (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py phase 28) it takes 4.644 ms at (32, 500, 512) bf16 beside
// #6's 4.659: what bounds #6 below bounds it.
//
// The first design for these widths (the stream kernel, bigru_bwd.cu's
// kStream, reached by a forced ("stream", C, R) plan below H = 1025 and
// the route above): kLinear's chain with each thread walking its unit's
// column of W_hh^T [3H, H] from L2 (kStreamK = 8 values in flight), the
// whole [3H, R] dg tile pushed to every block of a cluster of up to 16
// and a cluster.sync() a step, a float4 of dg for four FMAs: 77-83 us a
// step at (32, 500, 512) f32 on an H100 (chip_smoke.py phase 40), cuDNN
// 28-37.
//
// What the pipe kernel does about it (the LSTM's pipe kernel,
// bilstm_pipe.cu, with three gates):
// - The K-split: block q of a cluster of C <= 16 owns U units (ceil(H / C)
//   up to a multiple of 4) and forms, from its (unit, row) cells' r, z, n,
//   hn, h_prev and dy, the coefficients, dh_t, dx and dhn, so that no dg
//   leaves the block. It multiplies its own T([dx_r, dx_z, dhn]) [R x 3U]
//   by its own 3U gate columns of W_hh, and sends its float32 partial dh
//   [R][H] to the owners by st.async, 16 bytes (a k group of 4, one row) a
//   piece, on the owner's mbarrier. The owner sums the C partials of a
//   cell in rank order, then adds dh_t * z: bit-equal run to run, one
//   mbarrier wait a step, no cluster barrier.
// - The block's slice of W_hh, packed by the wrapper as [3U][HP] per block
//   (rnn_cuda.pipe_weights; HP = H to a multiple of 8, zero past H), is cut
//   into chunks of 12 gate columns. A producer warp loads them by
//   cp.async.bulk on an mbarrier a stage: the first P chunks once, held for
//   the whole walk, the rest through a ring of kPipeRing stages, released
//   by the consumer warps on an empty mbarrier and reloaded a step (the
//   whole slice held where it fits: at H = 320 in f32 with 16 blocks,
//   3 x 20 x 320 x 4 B = 75 KiB). The producer runs ahead across the
//   step's exchange.
// - The GEMM [R x 3U] x [3U x H] of a step on CUDA cores: consumer thread
//   t owns k group t (four consecutive k; H <= 1024, so one group a thread)
//   and every row of the tile, reading a float4 of W (8 bytes in bf16) and
//   the R rows of dg as 16-byte broadcasts for each gate column: 4 R FMAs
//   for R / 4 + 1 shared loads.
// - Batch tiles of 1, 2, 4, 8, 12 or 16 rows, ranked by rnn_cuda.pipe_plans
//   (gates = 3) from the card's own cluster counts, so that 2 directions x
//   ceil(B / R) tiles x C blocks fill the card in one wave where they can.
// - Blocks of four consumer warps (H <= 512) may take 255 registers a
//   thread (kWide false), the wider ones (up to eight consumer warps) 168.
// What bounds it (chip_smoke.py phase 40 on an H100; PERF.md section 6):
// at (32, 500, 512) f32, 16 x 12, a block's step is 590 K FMAs (4608
// cycles of issue on four warps) and 120 KiB of W_hh streamed (72 KiB
// held), about 6.7 us a step: the GEMM, short of its issue rate with one
// warp a scheduler, then the cells, waits and barrier. At H = 320 the
// planner's pick (the LSTM's cost model) is not the card's fastest plan
// (PERF.md section 7).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

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

constexpr int kIn = 6;            // a cell's inputs: r, z, n, hn, h_prev, dy
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block
constexpr int kMaxDevices = 64;   // devices whose shared-memory limit is kept

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

// the same, and `bytes` more to land in the phase (from the other blocks,
// or from a bulk copy)
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity`, an acquire at the block's scope (the
// bytes the other blocks send complete on this block's mbarrier). A wait
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

// four floats into shared::cluster address `dst` of another block of the
// cluster, completed on that block's mbarrier `bar`
__device__ __forceinline__ void st_async16(uint32_t dst, float a, float b,
                                           float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}

// one bulk copy global -> this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumer warps' barrier (the producer warp runs on)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// four W_hh values of a chunk row, as floats
__device__ __forceinline__ void load_w4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p,
                                        float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}

// the R rows of one gate column of the dg tile (16-byte broadcasts)
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&d)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else {
    static_assert(R == 1, "tiles of 1, 2 or a multiple of 4 rows");
    d[0] = p[0];
  }
}

// ---------------------------------------------------------------------------
// The layout (the wrapper's rnn_cuda.pipe_layout with gates = 3 mirrors it,
// held to bigru_bwd_pipe_layout when the library loads)
// ---------------------------------------------------------------------------

constexpr int kPipeGroups = 256;    // k groups of 4 a block sums: H <= 1024
constexpr int kPipeMinWarps = 4;    // consumer warps at least
constexpr int kPipeCells = 4;       // (unit, row) cells a consumer thread
constexpr int kPipeRing = 4;        // ring stages where the slice does not fit
constexpr int kPipeMaxStages = 32;  // stages (and their mbarriers) at most
constexpr int kPipeMaxC = 16;       // a non-portable cluster of 16 at most
constexpr int kPipeJC = 12;         // gate columns of a chunk (3U: 12 | 3U)
// __launch_bounds__: blocks of kPipeMinWarps consumer warps (H <= 512) may
// take 255 registers a thread, the wider ones 168 (ptxas's cap at 288)
constexpr int kPipeNarrowThreads = 32 * (kPipeMinWarps + 1);
constexpr int kPipeThreads = kPipeGroups + 32;

// H padded to whole 16-byte rows of bf16: a chunk row of the packed slice
__host__ __device__ __forceinline__ int pipe_hp(int H) {
  return (H + 7) / 8 * 8;
}

// units a block owns: ceil(H / C) up to a multiple of 4, so that a k group
// of 4 lies in one block's units (the last block's slice masked past H)
__host__ __device__ __forceinline__ int pipe_units(int H, int C) {
  return ((H + C - 1) / C + 3) / 4 * 4;
}

// consumer warps: one thread for each k group, kPipeMinWarps at least (the
// block adds one producer warp)
__host__ __device__ __forceinline__ int pipe_warps(int H) {
  const int w = (pipe_hp(H) / 4 + 31) / 32;
  return w < kPipeMinWarps ? kPipeMinWarps : w;
}

// chunks of the slice (its 3U gate columns, kPipeJC a chunk)
__host__ __device__ __forceinline__ int pipe_chunks(int H, int C) {
  return 3 * pipe_units(H, C) / kPipeJC;
}

__host__ __device__ __forceinline__ size_t pipe_chunk_bytes(int H,
                                                            int wbytes) {
  return static_cast<size_t>(kPipeJC) * pipe_hp(H) * wbytes;
}

// bytes beside the chunks: the partials [2][C][R][U], the dg tile [3U][R]
// and the mbarriers (full and empty of kPipeMaxStages stages, and two)
__host__ __device__ __forceinline__ size_t pipe_fixed_bytes(int H, int C,
                                                            int R) {
  const size_t U = static_cast<size_t>(pipe_units(H, C));
  return (2 * C * R * U + 3 * U * R) * sizeof(float) +
         (2 * kPipeMaxStages + 2) * 8;
}

// the chunks a block holds at once: as many as fit, at most the slice's
__host__ __device__ __forceinline__ int pipe_stages(int H, int C, int R,
                                                    int wbytes) {
  const size_t fixed = pipe_fixed_bytes(H, C, R);
  if (fixed >= static_cast<size_t>(kMaxSmem)) return 0;
  size_t s = (kMaxSmem - fixed) / pipe_chunk_bytes(H, wbytes);
  const size_t nc = static_cast<size_t>(pipe_chunks(H, C));
  if (s > nc) s = nc;
  if (s > static_cast<size_t>(kPipeMaxStages)) s = kPipeMaxStages;
  return static_cast<int>(s);
}

// of those, the ring stages the streamed chunks pass through: none where
// the whole slice is held, else kPipeRing (fewer where fewer fit)
__host__ __device__ __forceinline__ int pipe_ring(int H, int C, int R,
                                                  int wbytes) {
  const int s = pipe_stages(H, C, R, wbytes);
  if (s >= pipe_chunks(H, C)) return 0;
  return s < kPipeRing ? s : kPipeRing;
}

// ---------------------------------------------------------------------------
// The kernel. One cluster per (direction, batch tile of R rows); see the
// notes at the top. Block `rank` owns units rank * U .. rank * U + U - 1
// and reads its slice of W_hh packed by the wrapper: [C][3U][HP], row g * U
// + u of block q the column g * H + q * U + u of W_hh over k, zero past H.
// Consumer thread t owns the cells t + i * NTC (unit e % U, row e / U) and
// the k group t (k = 4 t .. 4 t + 3); the last warp is the producer.
// kWide: blocks of more than kPipeMinWarps consumer warps. kSplitCoef:
// #10's coefficient step (bigru_bwd.cu's kSplit function), the same chain,
// exchange and plan.
// ---------------------------------------------------------------------------

template <typename T, int R, bool kWide, bool kSplitCoef>
__global__ void __launch_bounds__(kWide ? kPipeThreads : kPipeNarrowThreads,
                                  1)
bigru_bwd_pipe_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                      const T* __restrict__ gs_f, const T* __restrict__ hn_f,
                      const T* __restrict__ ys_f, const T* __restrict__ dy_f,
                      const T* __restrict__ gs_b, const T* __restrict__ hn_b,
                      const T* __restrict__ ys_b, const T* __restrict__ dy_b,
                      T* __restrict__ dx_f, T* __restrict__ dhn_f,
                      T* __restrict__ dx_b, T* __restrict__ dhn_b, int B,
                      int N, int H, int rev) {
  constexpr int JC = kPipeJC;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 pipe_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = pipe_units(H, C);
  const int HP = pipe_hp(H);
  const int G = 3 * H;
  const int NWC = pipe_warps(H);
  const int NTC = 32 * NWC;
  const int NC = pipe_chunks(H, C);
  const int S = pipe_stages(H, C, R, sizeof(T));
  const int SR = pipe_ring(H, C, R, sizeof(T));
  const int P = S - SR;    // chunks held for the whole walk
  const int RC = NC - P;   // chunks streamed a step
  const int chunk = JC * HP;
  const uint32_t cbytes = static_cast<uint32_t>(chunk * sizeof(T));
  T* ring = reinterpret_cast<T*>(pipe_smem);                    // [S][JC][HP]
  float* part =
      reinterpret_cast<float*>(ring + static_cast<size_t>(S) * chunk);
  float* dgt = part + 2 * C * R * U;                             // [3U][R]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dgt + 3 * U * R);
  const uint32_t ring0 = smem_addr(ring);
  // full[st] (the chunk landed), empty[st] (every consumer warp is done
  // with it) and the partials' pbar[b], 8 bytes each
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8u * kPipeMaxStages;
  const uint32_t pbar0 = full0 + 16u * kPipeMaxStages;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);

  // the partials of units past H are never sent: zero
  for (int i = tid; i < 2 * C * R * U; i += static_cast<int>(blockDim.x))
    part[i] = 0.0f;
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full0 + 8u * st, 1);
      mbar_init(empty0 + 8u * st, NWC);
    }
    mbar_init(pbar0, NWC);
    mbar_init(pbar0 + 8, NWC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // every block of the cluster holds its zero partials and its mbarriers
  // before any block writes into another's shared memory
  cluster.sync();

  if (warp == NWC) {
    // the producer: the held chunks once, then the streamed chunks of every
    // step but the last in order, each into the next ring stage once every
    // consumer warp has released it
    if (lane == 0 && N > 1) {
      const T* wsl =
          (bwd ? w_b : w_f) + static_cast<size_t>(rank) * 3 * U * HP;
      for (int c = 0; c < P; ++c) {
        mbar_arrive_expect(full0 + 8u * c, cbytes);
        bulk_load(ring0 + c * cbytes, wsl + static_cast<size_t>(c) * chunk,
                  cbytes, full0 + 8u * c);
      }
      const long long total = static_cast<long long>(N - 1) * RC;
      int st = 0, c = P;
      uint32_t ph = 0;
      for (long long i = 0; i < total; ++i) {
        if (i >= SR) mbar_wait(empty0 + 8u * (P + st), ph ^ 1u);
        const uint32_t full = full0 + 8u * (P + st);
        mbar_arrive_expect(full, cbytes);
        bulk_load(ring0 + (P + st) * cbytes,
                  wsl + static_cast<size_t>(c) * chunk, cbytes, full);
        if (++st == SR) {
          st = 0;
          ph ^= 1u;
        }
        if (++c == NC) c = P;
      }
    }
    __syncwarp();
  } else {
    const int row0 = (blockIdx.x / C) * R;
    const T* gs = bwd ? gs_b : gs_f;
    const T* hns = bwd ? hn_b : hn_f;
    const T* yss = bwd ? ys_b : ys_f;
    const T* dys = bwd ? dy_b : dy_f;
    T* dx = bwd ? dx_b : dx_f;
    T* dhn = bwd ? dhn_b : dhn_f;
    // the walk: t = N-1 .. 0 for the forward direction; h_prev is ys at
    // the direction's previous step (t - 1 forward, t + 1 backward), zero
    // at its first
    auto t_of = [&](int s) { return bwd ? s : N - 1 - s; };
    const int first = bwd ? N - 1 : 0;
    const int dprev = bwd ? H : -H;

    // this thread's cells: consecutive threads on consecutive units
    int cu[kPipeCells], cr[kPipeCells];
    bool cin[kPipeCells], cok[kPipeCells];
    size_t cgo[kPipeCells], cho[kPipeCells];   // (row, t = 0, unit) offsets
#pragma unroll
    for (int i = 0; i < kPipeCells; ++i) {
      const int e = tid + i * NTC;
      cin[i] = e < U * R;
      cu[i] = cin[i] ? e % U : 0;
      cr[i] = cin[i] ? e / U : 0;
      const int gu = rank * U + cu[i], row = row0 + cr[i];
      cok[i] = cin[i] && gu < H && row < B;
      const size_t rw = static_cast<size_t>(cok[i] ? row : 0);
      cgo[i] = rw * N * G + (cok[i] ? gu : 0);
      cho[i] = rw * N * H + (cok[i] ? gu : 0);
    }
    // the cells' r, z, n, hn, h_prev and dy of the next step, as loaded
    T x[kPipeCells][kIn];
    auto load = [&](int s) {
      const size_t t = static_cast<size_t>(t_of(s));
      const T zero = from_f32<T>(0.0f);
#pragma unroll
      for (int i = 0; i < kPipeCells; ++i) {
        if (cok[i]) {
          const T* gt = gs + cgo[i] + t * G;
          const size_t ht = cho[i] + t * H;
          x[i][0] = gt[0];
          x[i][1] = gt[H];
          x[i][2] = gt[2 * H];
          x[i][3] = hns[ht];
          x[i][4] = static_cast<int>(t) != first ? yss[ht + dprev] : zero;
          x[i][5] = dys[ht];
        } else {
#pragma unroll
          for (int q = 0; q < kIn; ++q) x[i][q] = zero;
        }
      }
    };
    float dhz[kPipeCells];   // dh_t * z of the cell's previous step
#pragma unroll
    for (int i = 0; i < kPipeCells; ++i) dhz[i] = 0.0f;
    load(0);

    // this thread's k group, the block owning it and its place there
    const int gk = 4 * tid;
    const bool gwork = gk < HP;
    const bool gsend = gk < H;
    const int gown = gsend ? gk / U : 0;
    const int gkl = gk - gown * U;
    // bytes of partials the other blocks send this block a step: R rows of
    // each of its k groups below H
    const int mine = H - rank * U < U ? H - rank * U : U;
    const uint32_t part_tx =
        static_cast<uint32_t>((C - 1) * ((mine + 3) / 4) * 16 * R);
    int st = 0;         // the ring stage of the next streamed chunk
    uint32_t ph = 0;    // and its phase
    for (int s = 0; s < N; ++s) {
      const int buf = s & 1;
      // step s reads buffer s & 1 (step s-1's partials): the ((s - 1) /
      // 2)-th phase of pbar[s & 1]
      if (s > 0) mbar_wait(pbar0 + 8u * buf, ((s - 1) >> 1) & 1);
      const float* pb = part + buf * C * R * U;
      const size_t t = static_cast<size_t>(t_of(s));
#pragma unroll
      for (int i = 0; i < kPipeCells; ++i) {
        if (!cin[i]) continue;
        float v[kIn];
#pragma unroll
        for (int q = 0; q < kIn; ++q) v[q] = to_f32<T>(x[i][q]);
        const float r = v[0], z = v[1], n = v[2], hn = v[3], hp = v[4];
        float c_r = 0.0f, c_z = 0.0f, c_n = 0.0f;   // kLinear's coefficients
        if constexpr (!kSplitCoef) {
          const float a = (1.0f - z) * (1.0f - n * n);
          c_r = round_to<T>(a * hn * r * (1.0f - r));
          c_z = round_to<T>((hp - n) * z * (1.0f - z));
          c_n = round_to<T>(a);
        }
        // dh_carry: the C blocks' partials in rank order (none at step 0),
        // then dh_t * z of the previous step
        float dh = 0.0f;
        if (s > 0) {
          const float* pp = pb + cr[i] * U + cu[i];
          for (int q = 0; q < C; ++q) dh += pp[q * R * U];
        }
        const float dh_t = v[5] + (dhz[i] + dh);
        float dxr, dxz, dxn;
        if constexpr (kSplitCoef) {
          dxn = dh_t * (1.0f - z) * (1.0f - n * n);
          dxz = dh_t * (hp - n) * z * (1.0f - z);
          dxr = dxn * hn * r * (1.0f - r);
        } else {
          dxr = dh_t * c_r;
          dxz = dh_t * c_z;
          dxn = dh_t * c_n;
        }
        const float dhn_t = dxn * r;
        dhz[i] = dh_t * z;
        if (cok[i]) {
          T* o = dx + cgo[i] + t * G;
          o[0] = from_f32<T>(dxr);
          o[H] = from_f32<T>(dxz);
          o[2 * H] = from_f32<T>(dxn);
          dhn[cho[i] + t * H] = from_f32<T>(dhn_t);
        }
        float* d = dgt + cu[i] * R + cr[i];
        d[0] = cok[i] ? round_to<T>(dxr) : 0.0f;
        d[U * R] = cok[i] ? round_to<T>(dxz) : 0.0f;
        d[2 * U * R] = cok[i] ? round_to<T>(dhn_t) : 0.0f;
      }
      if (s + 1 == N) break;
      load(s + 1);
      consumer_sync(NTC);   // the step's dg tile is whole

      // partial dh_carry[k] of the block's columns for the thread's k
      // group: T(dg) . T(W_hh[k, columns]), chunk by chunk
      float acc[4][R];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int rr = 0; rr < R; ++rr) acc[e][rr] = 0.0f;
      for (int c = 0; c < NC; ++c) {
        int stage = c;
        const bool streamed = c >= P;
        if (!streamed) {
          if (s == 0) mbar_wait(full0 + 8u * c, 0);
        } else {
          stage = P + st;
          mbar_wait(full0 + 8u * stage, ph);
          if (++st == SR) {
            st = 0;
            ph ^= 1u;
          }
        }
        const T* wc = ring + static_cast<size_t>(stage) * chunk;
        const float* dk = dgt + c * JC * R;
        if (gwork) {
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            float dv[R];
            load_rows<R>(dk + j * R, dv);
            float w[4];
            load_w4(wc + j * HP + gk, w);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int rr = 0; rr < R; ++rr)
                acc[e][rr] = fmaf(dv[rr], w[e], acc[e][rr]);
          }
        }
        if (streamed) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8u * stage);
        }
      }

      // the group's R rows into slot `rank` of the next buffer of the block
      // owning it: this block's by a store, another's by st.async on its
      // mbarrier
      const int nb = buf ^ 1;
      if (gsend) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          float* dst = part + ((nb * C + rank) * R + rr) * U + gkl;
          if (gown == rank) {
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc[0][rr], acc[1][rr], acc[2][rr], acc[3][rr]);
          } else {
            st_async16(cluster_addr(smem_addr(dst), gown), acc[0][rr],
                       acc[1][rr], acc[2][rr], acc[3][rr],
                       cluster_addr(pbar0 + 8u * nb, gown));
          }
        }
      }
      // the warp's arrival on this block's own buffer: its partials are
      // sent and its reads of the dg tile and the partials are done
      __syncwarp();
      if (lane == 0) {
        if (warp == 0)
          mbar_arrive_expect(pbar0 + 8u * nb, part_tx);
        else
          mbar_arrive(pbar0 + 8u * nb);
      }
    }
  }
  // no block exits while another may still write into it
  cluster.sync();
}

// ---------------------------------------------------------------------------
// Host side: the plan rule, launches and queries
// ---------------------------------------------------------------------------

// The plan rule (the wrapper's _pipe_rule with gates = 3 mirrors it): a
// cluster of 1 to kPipeMaxC blocks each owning a unit, one k group a thread
// (H <= 1024), tiles of 1, 2, 4, 8, 12 or 16 rows, at most kPipeCells
// cells a consumer thread, and two chunks of the slice in shared memory at
// least (one where the slice is one chunk).
int pipe_row_slot(int R) {
  switch (R) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    case 12: return 4;
    case 16: return 5;
    default: return -1;
  }
}

bool valid_pipe_plan(int B, int N, int H, int C, int R, int wbytes) {
  if (B <= 0 || N <= 0 || H <= 0 || C < 1 || C > kPipeMaxC) return false;
  if (pipe_hp(H) / 4 > kPipeGroups || pipe_row_slot(R) < 0) return false;
  const int U = pipe_units(H, C);
  if ((C - 1) * U >= H || U * R > kPipeCells * 32 * pipe_warps(H))
    return false;
  const int nc = pipe_chunks(H, C);
  return pipe_stages(H, C, R, wbytes) >= (nc < 2 ? nc : 2);
}

size_t pipe_smem_bytes(int H, int C, int R, int wbytes) {
  return pipe_stages(H, C, R, wbytes) * pipe_chunk_bytes(H, wbytes) +
         pipe_fixed_bytes(H, C, R);
}

template <typename T>
using PipeKernel = void (*)(const T*, const T*, const T*, const T*,
                            const T*, const T*, const T*, const T*,
                            const T*, const T*, T*, T*, T*, T*, int, int,
                            int, int);

template <typename T, bool kWide, bool kSplitCoef>
PipeKernel<T> pipe_kernel_as(int R) {
  switch (R) {
    case 1: return bigru_bwd_pipe_kernel<T, 1, kWide, kSplitCoef>;
    case 2: return bigru_bwd_pipe_kernel<T, 2, kWide, kSplitCoef>;
    case 4: return bigru_bwd_pipe_kernel<T, 4, kWide, kSplitCoef>;
    case 8: return bigru_bwd_pipe_kernel<T, 8, kWide, kSplitCoef>;
    case 12: return bigru_bwd_pipe_kernel<T, 12, kWide, kSplitCoef>;
    case 16: return bigru_bwd_pipe_kernel<T, 16, kWide, kSplitCoef>;
    default: return nullptr;
  }
}

// the instance for tile R at H: narrow blocks (four consumer warps, to
// H = 512) or wide ones
template <typename T, bool kSplitCoef>
PipeKernel<T> pipe_kernel(int R, int H) {
  return pipe_warps(H) > kPipeMinWarps
             ? pipe_kernel_as<T, true, kSplitCoef>(R)
             : pipe_kernel_as<T, false, kSplitCoef>(R);
}

// The dynamic shared memory the instance of slot `slot` (a tile and a block
// width; #6's and #10's instances apart, by kSplitCoef) may use and its
// non-portable cluster size, set once per device and again only for more.
template <typename T, bool kSplitCoef>
cudaError_t pipe_prepare(PipeKernel<T> fn, int slot, int smem) {
  static std::atomic<int> allowed[12][kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[slot][device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && device < kMaxDevices)
    allowed[slot][device].store(smem);
  return err;
}

int pipe_slot(int R, int H) {
  return 2 * pipe_row_slot(R) + (pipe_warps(H) > kPipeMinWarps);
}

// A launch of `tiles` clusters of C blocks over `dirs` directions.
void make_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                 int tiles, int H, int C, int dirs, size_t smem,
                 void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(C * tiles, dirs, 1);
  cfg->blockDim = dim3(32 * (pipe_warps(H) + 1), 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T, bool kSplitCoef>
int launch_pipe(const void* w_f, const void* w_b, const void* gs_f,
                const void* hn_f, const void* ys_f, const void* dy_f,
                const void* gs_b, const void* hn_b, const void* ys_b,
                const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                void* dhn_b, int B, int N, int H, int C, int R, int dirs,
                int rev, void* stream) {
  const int wbytes = static_cast<int>(sizeof(T));
  if (!valid_pipe_plan(B, N, H, C, R, wbytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const PipeKernel<T> fn = pipe_kernel<T, kSplitCoef>(R, H);
  const size_t smem = pipe_smem_bytes(H, C, R, wbytes);
  cudaError_t err = pipe_prepare<T, kSplitCoef>(fn, pipe_slot(R, H),
                                                static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, (B + R - 1) / R, H, C, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, fn, in(w_f), in(w_b), in(gs_f), in(hn_f),
                           in(ys_f), in(dy_f), in(gs_b), in(hn_b), in(ys_b),
                           in(dy_b), out(dx_f), out(dhn_f), out(dx_b),
                           out(dhn_b), B, N, H, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// kLinear's instances (#10's have the same threads and shared memory)
template <typename T>
int pipe_max_active(int H, int C, int R) {
  const int wbytes = static_cast<int>(sizeof(T));
  const PipeKernel<T> fn = pipe_kernel<T, false>(R, H);
  const size_t smem = pipe_smem_bytes(H, C, R, wbytes);
  cudaError_t err = pipe_prepare<T, false>(fn, pipe_slot(R, H),
                                           static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, 1, H, C, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device; returns a cudaError_t code, 0 when the launch was accepted. All
// tensors are contiguous, in the stream type float (_f32) or bfloat16
// (_bf16): w_* W_hh packed by rnn_cuda.pipe_weights at this C
// ([C][3U][HP]); gs_* and dx_* [B, N, 3H]; hn_*, ys_*, dy_* and dhn_*
// [B, N, H]; clusters of C = 1 .. 16 blocks over batch tiles of R = 1, 2,
// 4, 8, 12 or 16 rows. gru_bwd_pipe_*: a grid of one direction, reverse !=
// 0 for a direction whose forward walked t = N-1 .. 0.
// bigru_bwd_split_pipe_*: #10, as bigru_bwd_pipe_* with kSplit's function.
#define BIGRU_BWD_PIPE_ENTRIES(SFX, TYPE)                                     \
  int bigru_bwd_pipe_##SFX(const void* w_f, const void* w_b,                 \
                           const void* gs_f, const void* hn_f,               \
                           const void* ys_f, const void* dy_f,               \
                           const void* gs_b, const void* hn_b,               \
                           const void* ys_b, const void* dy_b, void* dx_f,   \
                           void* dhn_f, void* dx_b, void* dhn_b, int B,      \
                           int N, int H, int C, int R, void* stream) {       \
    return launch_pipe<TYPE, false>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b,  \
                                    hn_b, ys_b, dy_b, dx_f, dhn_f, dx_b,     \
                                    dhn_b, B, N, H, C, R, 2, 0, stream);     \
  }                                                                          \
  int bigru_bwd_split_pipe_##SFX(                                            \
      const void* w_f, const void* w_b, const void* gs_f, const void* hn_f,  \
      const void* ys_f, const void* dy_f, const void* gs_b,                  \
      const void* hn_b, const void* ys_b, const void* dy_b, void* dx_f,      \
      void* dhn_f, void* dx_b, void* dhn_b, int B, int N, int H, int C,      \
      int R, void* stream) {                                                 \
    return launch_pipe<TYPE, true>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b,   \
                                   hn_b, ys_b, dy_b, dx_f, dhn_f, dx_b,      \
                                   dhn_b, B, N, H, C, R, 2, 0, stream);      \
  }                                                                          \
  int gru_bwd_pipe_##SFX(const void* w, const void* gs, const void* hn,      \
                         const void* ys, const void* dy, void* dx,           \
                         void* dhn, int B, int N, int H, int C, int R,       \
                         int reverse, void* stream) {                        \
    return launch_pipe<TYPE, false>(w, w, gs, hn, ys, dy, gs, hn, ys, dy,    \
                                    dx, dhn, dx, dhn, B, N, H, C, R, 1,      \
                                    reverse, stream);                        \
  }

BIGRU_BWD_PIPE_ENTRIES(f32, float)
BIGRU_BWD_PIPE_ENTRIES(bf16, __nv_bfloat16)
#undef BIGRU_BWD_PIPE_ENTRIES

// How many clusters of the pipe kernel (bf16: 0 or 1; `save` is taken for
// the forward source's signature and ignored) at H, C and R the current
// device runs at once; a negative cudaError_t code on failure.
int bigru_bwd_pipe_max_active_clusters(int bf16, int save, int H, int C,
                                       int R) {
  (void)save;
  if (!valid_pipe_plan(1, 1, H, C, R, bf16 ? 2 : 4))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? pipe_max_active<__nv_bfloat16>(H, C, R)
              : pipe_max_active<float>(H, C, R);
}

// The pipe kernel's layout at H, C and R with W_hh in bf16 (1) or float32
// (0), for the wrapper's mirror: what 0 = dynamic shared memory in bytes,
// 1 = threads a block, 2 = units a block, 3 = chunks in shared memory, 4 =
// of those held for the whole walk, 5 = chunks of the slice; -1 for a plan
// it does not take.
int bigru_bwd_pipe_layout(int what, int bf16, int H, int C, int R) {
  const int wbytes = bf16 ? 2 : 4;
  if (!valid_pipe_plan(1, 1, H, C, R, wbytes)) return -1;
  switch (what) {
    case 0: return static_cast<int>(pipe_smem_bytes(H, C, R, wbytes));
    case 1: return 32 * (pipe_warps(H) + 1);
    case 2: return pipe_units(H, C);
    case 3: return pipe_stages(H, C, R, wbytes);
    case 4:
      return pipe_stages(H, C, R, wbytes) - pipe_ring(H, C, R, wbytes);
    case 5: return pipe_chunks(H, C);
    default: return -1;
  }
}

const char* bigru_pipe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
