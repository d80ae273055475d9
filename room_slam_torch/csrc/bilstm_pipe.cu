// The LSTM BPTT's pipe kernel (bilstm_bwd_pipe_kernel), float32 or bfloat16
// streams, both directions of a BiLSTM layer (bilstm_bwd_pipe_*) or one
// direction of an LSTM (lstm_bwd_pipe_*, with a reverse flag): the route of
// the BPTT above H = 256 (to 1816, by a forced plan to 2048). Its own
// source, so that nvcc builds it beside bilstm_bwd.cu (the other LSTM BPTT
// kernels), not after them.
//
// Replaces, at those widths, the same two TPU kernels as bilstm_bwd.cu:
// room_slam_tpu/ops/rnn_pallas.py::_bilstm_bwd_kernel (:438, pallas_call
// :606) with the grid's two directions and _lstm_bwd_chunk_kernel (:242,
// pallas_call :315) with a grid of one direction; the per-step arithmetic,
// the rounding points and the outputs (dg [B, N, 4H] per direction) are
// bilstm_bwd.cu's (see its notes), only the order of the float32 sums of
// dh_carry differs.
//
// Above H = 256 no block holds its share of W_hh in registers, and at
// H = 512 in f32 no cluster holds all of W_hh in shared memory (4 MiB a
// direction against 16 x 227 KB), so W_hh comes from L2 every step.
//
// The first design for these widths (the stream kernel of bilstm_bwd.cu,
// reached only by a forced ("stream", C, R) plan since the pipe kernel took
// the route): the first cluster kernel with kStream, each thread walking its unit's column
// of W_hh^T [4H, H] (a transposed copy the wrapper makes) from L2 with
// kStreamK values in flight, the dg tile [2][4H][R] exchanged to every
// block and a cluster.sync() a step; up to H = 1816, where the 4H-row dg
// tile fills a block. What held it back (phase 40 on an H100, 104.3 us a
// step at (32, 500, 512) f32, cuDNN 37.4): 256 dependent L2 round trips a
// thread a step with three warps an SM to hide them, a float4 of dg for
// four FMAs, about 92 KB of dg pushed to every block by generic remote
// stores, and the full cluster barrier.
//
// What the pipe kernel (bilstm_bwd_pipe_kernel, #2 and #4 alike: the
// route above H = 256 as far as the stream kernel takes H, 1816, where
// chip_smoke.py phase 40 times the two in turns; by a forced plan to 2048)
// does about it:
// - The register kernel's K-split: block q of a cluster owns U units
//   (ceil(H / C) up to a multiple of 4), forms dg only for its own (unit,
//   row) cells and multiplies it by its own 4U gate columns of W_hh, so no
//   dg leaves the block. Its float32 partial dh [R][H] go to their owners
//   by st.async, 16 bytes (a k group of 4, one row) a piece, on the
//   owner's mbarrier, and the owner sums the C partials of a cell in rank
//   order: bit-equal run to run, one mbarrier wait a step, no cluster
//   barrier, (C - 1) / C x H x R float32 a block a step.
// - The block's slice of W_hh, packed by the wrapper as [4U][HP] per block
//   (rnn_cuda.pipe_weights; HP = H to a multiple of 8, zero past H), is cut
//   into chunks of 16 gate columns (8 above H = 1024, where two such chunks
//   in f32 fill a block). A producer warp loads them by
//   cp.async.bulk on an mbarrier a stage: the first P chunks once, held for
//   the whole walk, the rest through a ring of kPipeRing stages, released
//   by the consumer warps on an empty mbarrier and reloaded a step (or the
//   whole slice held where it fits: at H = 320 in f32, at 512 in bf16).
//   The producer runs ahead across the step's exchange.
// - The GEMM [R x 4U] x [4U x H] of a step: consumer thread t owns k group
//   t (four consecutive k; a second group t + NTC above H = 1024) and every
//   row of the tile, reading a float4 of W (8 bytes in bf16) and the R rows
//   of dg as 16-byte broadcasts for each gate column: 4 R FMAs for R / 4 +
//   1 shared loads.
// - Batch tiles of 1, 2, 4, 8, 12 or 16 rows, so that 2 directions x
//   ceil(B / R) tiles x C blocks fill the card in one wave (at B = 32, two
//   directions, 16 x 12: six clusters of 16, where the card holds seven);
//   rnn_cuda.pipe_plans weighs a block's FMA issue against its streamed L2
//   bytes and the grid's.
// - Blocks of four consumer warps (H <= 512) may take 255 registers a
//   thread (kWide false): under the 288-thread bound's 168 the 8- to
//   16-row tiles spill (the ptxas counts chip_smoke.py phase 2 prints).
// What bounds it (chip_smoke.py phase 40 on an H100; PERF.md section 6):
// at (32, 500, 512) f32, 16 x 12, a block's step is 786 K FMAs (6144
// cycles of issue on four warps) and 224 KiB of W_hh streamed (32 KiB
// held), about 11 us a step: the GEMM, short of its issue rate with one
// warp a scheduler, then the cells, waits and barrier. At H = 1816 in f32
// the two directions' W_hh (105 MB) overflow L2 and the grid takes two or
// three waves; there cuDNN is faster.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

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

constexpr int kRegIn = 7;         // a cell's inputs: i, f, g, o, c, c_prev, dy
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

// four floats into shared::cluster address `dst` of another block
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

// ---------------------------------------------------------------------------
// The pipe kernel (bilstm_bwd_pipe_kernel; see the notes at the top): the
// register kernel's (bilstm_bwd.cu) K-split, with the block's slice of W_hh streamed through
// shared memory by a producer warp (cp.async.bulk on mbarriers) and the part
// of the slice that fits held there for the whole walk.
// ---------------------------------------------------------------------------

constexpr int kPipeGroups = 256;    // k groups of 4 in one pass of the block
constexpr int kPipeMinWarps = 4;    // consumer warps at least
constexpr int kPipeCells = 4;       // (unit, row) cells a consumer thread
constexpr int kPipeRing = 4;        // ring stages where the slice does not fit
constexpr int kPipeMaxStages = 32;  // stages (and their mbarriers) at most
constexpr int kPipeMaxC = 16;       // a non-portable cluster of 16 at most
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

// k groups a consumer thread sums (1 up to H = 1024, then 2)
__host__ __device__ __forceinline__ int pipe_kpt(int H) {
  return (pipe_hp(H) / 4 + kPipeGroups - 1) / kPipeGroups;
}

// gate columns of the slice a chunk: 16 where a thread sums one k group,
// 8 above (where two chunks of 16 columns in f32 would not fit a block)
__host__ __device__ __forceinline__ constexpr int pipe_jc_of(int kpt) {
  return kpt == 1 ? 16 : 8;
}
__host__ __device__ __forceinline__ int pipe_jc(int H) {
  return pipe_jc_of(pipe_kpt(H));
}

// consumer warps: one thread for each k group of a pass, kPipeMinWarps at
// least (the block adds one producer warp)
__host__ __device__ __forceinline__ int pipe_warps(int H) {
  const int k = pipe_kpt(H);
  const int w = ((pipe_hp(H) / 4 + k - 1) / k + 31) / 32;
  return w < kPipeMinWarps ? kPipeMinWarps : w;
}

// chunks of the slice (its 4U gate columns, pipe_jc a chunk; 4U is a
// multiple of 16)
__host__ __device__ __forceinline__ int pipe_chunks(int H, int C) {
  return 4 * pipe_units(H, C) / pipe_jc(H);
}

__host__ __device__ __forceinline__ size_t pipe_chunk_bytes(int H,
                                                            int wbytes) {
  return static_cast<size_t>(pipe_jc(H)) * pipe_hp(H) * wbytes;
}

// bytes beside the chunks: the partials [2][C][R][U], the dg tile [4U][R]
// and the mbarriers (full and empty of kPipeMaxStages stages, and two)
__host__ __device__ __forceinline__ size_t pipe_fixed_bytes(int H, int C,
                                                            int R) {
  const size_t U = static_cast<size_t>(pipe_units(H, C));
  return (2 * C * R * U + 4 * U * R) * sizeof(float) +
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

// One cluster per (direction, batch tile of R rows); see the notes at the
// top. Block `rank` owns units rank * U .. rank * U + U - 1 and reads its
// slice of W_hh packed by the wrapper (rnn_cuda.pipe_weights): [C][4U][HP],
// row g * U + u of block q the column g * H + q * U + u of W_hh over k, zero
// past H. Consumer thread t owns the cells tid + i * NTC (unit e % U, row
// e / U) and the k groups t + p * NTC (k = 4 g .. 4 g + 3, p < KPT); the
// last warp is the producer. kWide: blocks of more than kPipeMinWarps
// consumer warps.
template <typename T, int R, int KPT, bool kWide>
__global__ void __launch_bounds__(kWide ? kPipeThreads : kPipeNarrowThreads,
                                  1)
bilstm_bwd_pipe_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                       const T* __restrict__ gs_f, const T* __restrict__ cs_f,
                       const T* __restrict__ dy_f, const T* __restrict__ gs_b,
                       const T* __restrict__ cs_b, const T* __restrict__ dy_b,
                       T* __restrict__ dg_f, T* __restrict__ dg_b, int B,
                       int N, int H, int rev) {
  constexpr int JC = pipe_jc_of(KPT);   // gate columns a chunk
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 pipe_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = pipe_units(H, C);
  const int HP = pipe_hp(H);
  const int G = 4 * H;
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
  float* dgt = part + 2 * C * R * U;                             // [4U][R]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dgt + 4 * U * R);
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
          (bwd ? w_b : w_f) + static_cast<size_t>(rank) * 4 * U * HP;
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
    const T* cs = bwd ? cs_b : cs_f;
    const T* dys = bwd ? dy_b : dy_f;
    T* dg = bwd ? dg_b : dg_f;
    // the walk: t = N-1 .. 0 for the forward direction; c_prev is c at the
    // direction's previous step (t - 1 forward, t + 1 backward), zero at
    // its first
    auto t_of = [&](int s) { return bwd ? s : N - 1 - s; };
    const int first = bwd ? N - 1 : 0;
    const int dprev = bwd ? H : -H;

    // this thread's cells: consecutive threads on consecutive units
    int cu[kPipeCells], cr[kPipeCells];
    bool cin[kPipeCells], cok[kPipeCells];
    size_t cgo[kPipeCells], cco[kPipeCells];   // (row, t = 0, unit) offsets
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
      cco[i] = rw * N * H + (cok[i] ? gu : 0);
    }
    // the cells' i, f, g, o, c, c_prev and dy of the next step, as loaded
    T x[kPipeCells][kRegIn];
    auto load = [&](int s) {
      const size_t t = static_cast<size_t>(t_of(s));
      const T zero = from_f32<T>(0.0f);
#pragma unroll
      for (int i = 0; i < kPipeCells; ++i) {
        if (cok[i]) {
          const T* gt = gs + cgo[i] + t * G;
          const T* ct = cs + cco[i] + t * H;
          x[i][0] = gt[0];
          x[i][1] = gt[H];
          x[i][2] = gt[2 * H];
          x[i][3] = gt[3 * H];
          x[i][4] = ct[0];
          x[i][5] = static_cast<int>(t) != first ? ct[dprev] : zero;
          x[i][6] = dys[cco[i] + t * H];
        } else {
#pragma unroll
          for (int q = 0; q < kRegIn; ++q) x[i][q] = zero;
        }
      }
    };
    float dc[kPipeCells];
#pragma unroll
    for (int i = 0; i < kPipeCells; ++i) dc[i] = 0.0f;
    load(0);

    // this thread's k groups, each block's owner and place there
    int gk[KPT], gown[KPT], gkl[KPT];
    bool gwork[KPT], gsend[KPT];
#pragma unroll
    for (int p = 0; p < KPT; ++p) {
      const int g = tid + p * NTC;
      gk[p] = 4 * g;
      gwork[p] = 4 * g < HP;
      gsend[p] = 4 * g < H;
      gown[p] = gsend[p] ? 4 * g / U : 0;
      gkl[p] = 4 * g - gown[p] * U;
    }
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
        float v[kRegIn];
#pragma unroll
        for (int q = 0; q < kRegIn; ++q) v[q] = to_f32<T>(x[i][q]);
        const float ig = v[0], fg = v[1], gg = v[2], og = v[3];
        const float tanh_c = tanhf(v[4]);
        const float c_c = round_to<T>(og * (1.0f - tanh_c * tanh_c));
        const float c_i = round_to<T>(gg * ig * (1.0f - ig));
        const float c_f = round_to<T>(v[5] * fg * (1.0f - fg));
        const float c_g = round_to<T>(ig * (1.0f - gg * gg));
        const float c_o = round_to<T>(tanh_c * og * (1.0f - og));
        // dh_carry: the C blocks' partials in rank order (none at step 0)
        float dh = 0.0f;
        if (s > 0) {
          const float* pp = pb + cr[i] * U + cu[i];
          for (int q = 0; q < C; ++q) dh += pp[q * R * U];
        }
        const float dh_t = v[6] + dh;
        const float dc_t = dc[i] + dh_t * c_c;
        const float d[4] = {dc_t * c_i, dc_t * c_f, dc_t * c_g, dh_t * c_o};
        dc[i] = dc_t * fg;
        T* o = dg + cgo[i] + t * G;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (cok[i]) o[g * H] = from_f32<T>(d[g]);
          dgt[(g * U + cu[i]) * R + cr[i]] = cok[i] ? round_to<T>(d[g]) : 0.0f;
        }
      }
      if (s + 1 == N) break;
      load(s + 1);
      consumer_sync(NTC);   // the step's dg tile is whole

      // partial dh_carry[k] of the block's columns for the thread's k
      // groups: T(dg) . T(W_hh[k, columns]), chunk by chunk
      float acc[KPT][4][R];
#pragma unroll
      for (int p = 0; p < KPT; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[p][e][r] = 0.0f;
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
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          float dv[R];
          load_rows<R>(dk + j * R, dv);
#pragma unroll
          for (int p = 0; p < KPT; ++p) {
            if (!gwork[p]) continue;
            float w[4];
            load_w4(wc + j * HP + gk[p], w);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[p][e][r] = fmaf(dv[r], w[e], acc[p][e][r]);
          }
        }
        if (streamed) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8u * stage);
        }
      }

      // each group's R rows into slot `rank` of the next buffer of the
      // block owning it: this block's by a store, another's by st.async on
      // its mbarrier
      const int nb = buf ^ 1;
#pragma unroll
      for (int p = 0; p < KPT; ++p) {
        if (!gsend[p]) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float* dst = part + ((nb * C + rank) * R + r) * U + gkl[p];
          if (gown[p] == rank) {
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc[p][0][r], acc[p][1][r], acc[p][2][r], acc[p][3][r]);
          } else {
            st_async16(cluster_addr(smem_addr(dst), gown[p]), acc[p][0][r],
                       acc[p][1][r], acc[p][2][r], acc[p][3][r],
                       cluster_addr(pbar0 + 8u * nb, gown[p]));
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

// The dynamic shared memory the cluster kernel `fn` (the register or the
// pipe kernel's) may use and its non-portable cluster size, set once per
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

// A launch of `tiles` clusters of C blocks of `threads` over `dirs`
// directions (the register and the pipe kernels).
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

// The pipe kernel's plan rule (the wrapper's _pipe_rule and pipe_layout
// mirror it, held to bilstm_bwd_pipe_layout when the library loads): a
// cluster of 1 to kPipeMaxC blocks each owning a unit, two passes of k
// groups at most (H <= 2048), tiles of 1, 2, 4 or 8 rows (a single pass
// also 12 and 16: at most 64 sums a thread), at most kPipeCells cells a
// consumer thread, and two chunks of the slice in shared memory at least
// (one where the slice is one chunk).
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
  const int kpt = pipe_kpt(H);
  const int slot = pipe_row_slot(R);
  if (kpt > 2 || slot < 0 || (kpt == 2 && slot > 3)) return false;
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
                            const T*, const T*, const T*, const T*, T*, T*,
                            int, int, int, int);

template <typename T, bool kWide>
PipeKernel<T> pipe_kernel_as(int R) {
  switch (R) {
    case 1: return bilstm_bwd_pipe_kernel<T, 1, 1, kWide>;
    case 2: return bilstm_bwd_pipe_kernel<T, 2, 1, kWide>;
    case 4: return bilstm_bwd_pipe_kernel<T, 4, 1, kWide>;
    case 8: return bilstm_bwd_pipe_kernel<T, 8, 1, kWide>;
    case 12: return bilstm_bwd_pipe_kernel<T, 12, 1, kWide>;
    case 16: return bilstm_bwd_pipe_kernel<T, 16, 1, kWide>;
    default: return nullptr;
  }
}

// the instance for tile R at H: one k group a thread (to H = 1024) or two,
// narrow blocks (four consumer warps, to H = 512) or wide ones
template <typename T>
PipeKernel<T> pipe_kernel(int R, int H) {
  if (pipe_kpt(H) == 1)
    return pipe_warps(H) > kPipeMinWarps ? pipe_kernel_as<T, true>(R)
                                         : pipe_kernel_as<T, false>(R);
  switch (R) {
    case 1: return bilstm_bwd_pipe_kernel<T, 1, 2, true>;
    case 2: return bilstm_bwd_pipe_kernel<T, 2, 2, true>;
    case 4: return bilstm_bwd_pipe_kernel<T, 4, 2, true>;
    case 8: return bilstm_bwd_pipe_kernel<T, 8, 2, true>;
    default: return nullptr;
  }
}

// the slot of pipe_prepare's cache for tile R at H
int pipe_slot(int R, int H) {
  return (2 * pipe_row_slot(R) + pipe_kpt(H) - 1) * 2 +
         (pipe_warps(H) > kPipeMinWarps);
}

template <typename T>
cudaError_t pipe_prepare(PipeKernel<T> fn, int slot, int smem) {
  static std::atomic<int> allowed[24][kMaxDevices];
  return allow_smem_of(fn, allowed[slot], smem);
}

template <typename T>
int launch_pipe(const void* w_f, const void* w_b, const void* gs_f,
                const void* cs_f, const void* dy_f, const void* gs_b,
                const void* cs_b, const void* dy_b, void* dg_f, void* dg_b,
                int B, int N, int H, int C, int R, int dirs, int rev,
                void* stream) {
  const int wbytes = static_cast<int>(sizeof(T));
  if (!valid_pipe_plan(B, N, H, C, R, wbytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const PipeKernel<T> fn = pipe_kernel<T>(R, H);
  const size_t smem = pipe_smem_bytes(H, C, R, wbytes);
  cudaError_t err =
      pipe_prepare<T>(fn, pipe_slot(R, H), static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, (B + R - 1) / R, 32 * (pipe_warps(H) + 1), C,
                  dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, fn, in(w_f), in(w_b), in(gs_f), in(cs_f),
                           in(dy_f), in(gs_b), in(cs_b), in(dy_b), out(dg_f),
                           out(dg_b), B, N, H, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pipe_max_active(int H, int C, int R) {
  const int wbytes = static_cast<int>(sizeof(T));
  const PipeKernel<T> fn = pipe_kernel<T>(R, H);
  const size_t smem = pipe_smem_bytes(H, C, R, wbytes);
  cudaError_t err =
      pipe_prepare<T>(fn, pipe_slot(R, H), static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, 1, 32 * (pipe_warps(H) + 1), C, 1, smem,
                  nullptr);
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
// ([C][4U][HP]); gs_* and dg_* [B, N, 4H]; cs_* and dy_* [B, N, H];
// clusters of C = 1 .. 16 blocks over batch tiles of R = 1, 2, 4, 8, 12 or
// 16 rows. lstm_bwd_pipe_*: a grid of one direction, reverse != 0 for a
// direction whose forward walked t = N-1 .. 0.
#define BILSTM_BWD_PIPE_ENTRIES(SFX, TYPE)                                    \
  int bilstm_bwd_pipe_##SFX(const void* w_f, const void* w_b,                \
                            const void* gs_f, const void* cs_f,              \
                            const void* dy_f, const void* gs_b,              \
                            const void* cs_b, const void* dy_b, void* dg_f,  \
                            void* dg_b, int B, int N, int H, int C, int R,   \
                            void* stream) {                                  \
    return launch_pipe<TYPE>(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b,   \
                             dg_f, dg_b, B, N, H, C, R, 2, 0, stream);       \
  }                                                                          \
  int lstm_bwd_pipe_##SFX(const void* w, const void* gs, const void* cs,     \
                          const void* dy, void* dg, int B, int N, int H,     \
                          int C, int R, int reverse, void* stream) {         \
    return launch_pipe<TYPE>(w, w, gs, cs, dy, gs, cs, dy, dg, dg, B, N, H,  \
                             C, R, 1, reverse, stream);                      \
  }

BILSTM_BWD_PIPE_ENTRIES(f32, float)
BILSTM_BWD_PIPE_ENTRIES(bf16, __nv_bfloat16)
#undef BILSTM_BWD_PIPE_ENTRIES

// How many clusters of the pipe kernel (bf16: 0 or 1; `save` is taken for
// the forward source's signature and ignored) at H, C and R the current
// device runs at once; a negative cudaError_t code on failure.
int bilstm_bwd_pipe_max_active_clusters(int bf16, int save, int H, int C,
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
int bilstm_bwd_pipe_layout(int what, int bf16, int H, int C, int R) {
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

const char* bilstm_pipe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
