// Fused GRU recurrence, forward, float32 or bfloat16 streams, at H 65-256:
// the register cluster kernel, W_hh split by hidden units across a
// thread-block cluster and held in registers. The light variant and the
// training variant that also saves residuals; two grids: both directions
// of a BiGRU layer (bigru_fwd_reg_*, bigru_fwd_train_reg_*), or one
// direction of a GRU (gru_fwd_reg_*, gru_fwd_train_reg_*, with a reverse
// flag).
//
// Replaces, at these widths, two TPU kernels, both their light pallas_call
// and their save_residuals one: room_slam_tpu/ops/gru_pallas.py::
// _bigru_fwd_kernel (:314, pallas_call :483 and :454) with the grid's two
// directions, and _gru_fwd_kernel (:39, pallas_call :182 and :155) with a
// grid of one direction. The function, rounding points and outputs are
// those of bigru_fwd.cu (torch nn.GRU numerics, gate order r, z, n):
//
//   hg = T(h_{t-1}) @ T(W_hh) + b_hh     (f32 sums; T = the stream type)
//   r = sigmoid(xg_r + hg_r), z = sigmoid(xg_z + hg_z)
//   n = tanh(xg_n + r * hg_n)
//   h_t = (1 - z) * n + z * h_{t-1}      (f32 carry)
//
// and the training variant (kSave) also stores the activated gates (r, z,
// n) [B, N, 3H] and hn = hg_n [B, N, H] of every step, in the stream type.
// The forward direction walks t = 0 .. N-1, the backward one t = N-1 .. 0,
// both over xg in original time order.
//
// What bounds it on an H100. At (32, 500, 255) f32, two directions, the
// light kernel moves 65 MB (19 us at 3.35 TB/s) and does 12.5 GFLOP (186
// us at 67 TFLOP/s for f32 FMAs); neither is the floor: the walk is 500
// dependent steps, each a 255-deep dot product for 765 gate columns of
// every row, so the time is 500 times the latency of one step. The first
// cluster design (bigru_fwd.cu bigru_fwd_kernel, reached by a forced
// ("cluster", C, R) plan) took 6.6 us a step there (PERF.md section 6):
// each thread walks a serial H-deep chain of shared-memory loads (three
// scalar W loads and a float4 of h feed 12 FMAs), pushes its h to every
// block by generic distributed-shared-memory stores, and a full
// cluster.sync() ends every step; xg comes one step ahead by scalar loads
// and the outputs leave as scalar stores.
//
// What the design does about it: bilstm_fwd.cu's register cluster scheme
// with three gates.
// - W_hh in registers. Block q of a cluster of C <= 16 owns U = ceil(H / C)
//   units, up to a power of two (the last slice masked past H); L = 8
//   lanes serve a unit up to H = 128, 16 above. Lane p holds the r, z and
//   n columns of its unit for its 16 k = (c * L + p) * KC + e, as float32
//   rounded from the stream type once: 48 registers (the LSTM's 64), which
//   leaves room for tiles of 8 rows.
// - h_{t-1} from a double-buffered tile [2][R / 4][TK][min(R, 4)] (an
//   8-row tile as two planes of 4 rows, so that a unit's lanes read
//   consecutive 16-byte words) as 16-byte broadcasts, each feeding KC k x
//   min(R, 4) rows x 3 gates = 12 FMAs. The L lanes' partial sums meet by
//   __shfl_xor_sync, a reduce-scatter over the rows, then an all-reduce
//   over the rest, so every lane ends with the three sums of row p % R and
//   the cell and its f32 carry stay in its registers (lanes p < R own the
//   row's outputs).
// - The exchange without a cluster barrier: each warp writes its units'
//   T(h_t) into its own next buffer, sends that region (16 or 8 bytes a
//   piece, a piece a plane) into the same buffer of every other block by
//   st.async, whose bytes complete on the receiver's mbarrier, then
//   arrives on its own block's mbarrier. A step waits on that mbarrier
//   only, an acquire at the block's scope.
// - Off the chain, while the bytes travel: xg is loaded two steps ahead by
//   consecutive threads on consecutive units into a two-slot ring in shared
//   memory; the outputs (ys, and with kSave r, z, n and hn) go through a
//   three-slot staging area and leave a step later as coalesced stores,
//   issued after the warp's arrival. Every index a step computes is a shift
//   and a mask (U, L and R are powers of two).
// Register budget: 48 W_hh values, 3R accumulators and (3R + 7) / 8 xg
// values a thread; blocks of at most 256 threads (U * L), launch bound two
// blocks an SM, so 128 registers a thread (phase 2 of chip_smoke.py
// reports each instance's registers and spills).
//
// Measured on an H100 (chip_smoke.py phase 41, PERF.md section 6): about
// 2.5 us a step at (32, 500, 255) f32 on 8-row tiles (the first design
// 6.6), 0.77 at a served request's (1, 1500, 128) (the first design 3.6).
//
// What bounds it now: the step's fixed chain (the mbarrier wait, a 16-deep
// FMA chain a plane, the shuffle rounds, the activations' MUFU latency,
// the exchange and the arrival) and, at large batches, the waves: one copy
// of W_hh in registers per batch tile of R rows, so 2 * B / R clusters of
// C blocks against the 14 clusters of 16 blocks an H100 holds at once (at
// the scale-up batch, B = 128 at H = 256, three waves of 8-row tiles, and
// the forward pipe kernel takes that batch: gru_cuda.reg_route). Tiles of
// two to four groups of 8 rows taking turns within a step, each with its
// own buffers and mbarriers, ran slower there than three waves of 8-row
// tiles and spilled (a throwaway variant, not kept). The wrapper
// (ops/gru_cuda.py gru_fwd_kernel_route, bigru_reg_plans) picks the
// kernel, the cluster and the tile from the card's own counts, and may
// force the first design or the pipe kernel for an A/B.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxH = 256;           // the widest H a lane's 16 k values hold
constexpr int kKPerLane = 16;        // k values of the sum a lane holds
constexpr int kMaxThreads = 256;     // __launch_bounds__, two blocks an SM
constexpr int kStages = 3;           // output staging slots (steps)
constexpr int kMaxC = 16;            // a non-portable cluster of 16 at most
constexpr int kStreams = 5;          // staged outputs: ys, then r, z, n, hn
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

// __expf and a fast reciprocal: a few ulp; exp overflowing to inf gives the
// limits 0 and -1 / +1
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// lanes a hidden unit: 8 up to H = 128 (16 k a lane), 16 above
__host__ __device__ __forceinline__ int reg_lanes(int H) {
  return H <= 8 * kKPerLane ? 8 : 16;
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

// rows of k of the h tile: every unit of the cluster and every k a lane
// reads
__host__ __device__ __forceinline__ int reg_tile_k(int H, int C) {
  const int a = C * reg_units(H, C);
  const int b = kKPerLane * reg_lanes(H);
  return ((a > b ? a : b) + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int reg_threads(int H, int C) {
  return reg_units(H, C) * reg_lanes(H);
}

// floats of dynamic shared memory: the h tile [2][R][TK] (in planes of up
// to 4 rows), the xg ring [2][R][3][U + 1] and the output staging
// [3][5][R][U + 1]
__host__ __device__ __forceinline__ size_t reg_smem_floats(int H, int C,
                                                           int R) {
  const size_t up = static_cast<size_t>(reg_units(H, C)) + 1;
  return 2 * static_cast<size_t>(R) * reg_tile_k(H, C) +
         (2 * 3 + kStages * kStreams) * static_cast<size_t>(R) * up;
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

// One level of the reduce-scatter over the rows: before it, v[g][i] (i <
// R / M) holds the partial sums of row i * M + (p & (M - 1)); after it,
// v[g][j] (j < R / 2M) holds those of row j * 2M + (p & (2M - 1)), summed
// with lane p ^ M's.
template <int M, int R>
__device__ __forceinline__ void scatter_rows(float (&v)[3][R], int p) {
  if constexpr (M < R) {
    const bool b = (p & M) != 0;
#pragma unroll
    for (int j = 0; j < R / (2 * M); ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float keep = b ? v[g][2 * j + 1] : v[g][2 * j];
        const float send = b ? v[g][2 * j] : v[g][2 * j + 1];
        v[g][j] = keep + __shfl_xor_sync(kFullMask, send, M);
      }
    scatter_rows<2 * M, R>(v, p);
  }
}

// The L lanes of a unit each hold partial sums v[g][r] of the three gates
// for the R rows of the tile; afterwards every lane p holds in out[g] the
// full sums of row p % R: a reduce-scatter over the lane bits below R,
// then an all-reduce over the bits from R up to L.
template <int R>
__device__ __forceinline__ void reduce_rows(float (&v)[3][R],
                                            float (&out)[3], int p, int L) {
  scatter_rows<1, R>(v, p);
#pragma unroll
  for (int g = 0; g < 3; ++g) out[g] = v[g][0];
  for (int m = R; m < L; m <<= 1)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      out[g] += __shfl_xor_sync(kFullMask, out[g], m);
}

// One cluster per (direction, batch tile of R rows); see the notes at the
// top. Block `rank` owns units rank * U .. rank * U + U - 1, L lanes each.
template <typename T, bool kSave, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
bigru_fwd_reg_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                     const T* __restrict__ w_f, const float* __restrict__ b_f,
                     const T* __restrict__ w_b, const float* __restrict__ b_b,
                     T* __restrict__ ys_f, T* __restrict__ ys_b,
                     T* __restrict__ gs_f, T* __restrict__ gs_b,
                     T* __restrict__ hn_f, T* __restrict__ hn_b, int B, int N,
                     int H, int rev) {
  constexpr int RQ = R < 4 ? R : 4;         // rows of one float4 read
  constexpr int QD = R / RQ;                // planes of the h tile
  constexpr int lgQD = QD == 2 ? 1 : 0;
  constexpr int KC = 4 / RQ;                // k values of one float4 read
  constexpr int kChunks = kKPerLane / KC;   // float4 reads a plane a step
  constexpr int NX = (3 * R + 7) / 8;       // xg values a thread loads a step
  constexpr int NQ = kSave ? kStreams : 1;
  constexpr int NF = (NQ * R + 7) / 8;      // outputs a thread stores a step
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 reg_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = reg_lanes(H);
  const int lgL = L == 8 ? 3 : 4;
  const int U = reg_units(H, C);
  const int lgU = __ffs(U) - 1;    // U is a power of two: shifts, no divides
  const int UP = U + 1;
  const int TK = reg_tile_k(H, C);
  const int G = 3 * H;
  const int threads = static_cast<int>(blockDim.x);
  float* tile = reinterpret_cast<float*>(reg_smem);   // [2][QD][TK][RQ]
  float* ring = tile + 2 * R * TK;                    // [2][R][3][UP]
  float* stage = ring + 2 * 3 * R * UP;               // [3][5][R][UP]
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = tid & (L - 1);     // lane of the unit
  const int ul = tid >> lgL;       // unit in the block
  const int unit = rank * U + ul;  // ... in the layer
  const bool unit_ok = unit < H;
  const int row0 = (blockIdx.x / C) * R;

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  const float* b = bwd ? b_b : b_f;
  T* ys = bwd ? ys_b : ys_f;
  T* gs = bwd ? gs_b : gs_f;
  T* hns = bwd ? hn_b : hn_f;
  auto t_of = [&](int s) { return bwd ? N - 1 - s : s; };

  // this lane's W_hh values: chunk c covers k = (c * L + p) * KC + e, e <
  // KC, for the r, z and n columns of the unit; zero past H
  float wr[3][kKPerLane];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const int k = (c * L + p) * KC + e;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wr[g][c * KC + e] =
            unit_ok && k < H
                ? to_f32<T>(w[static_cast<size_t>(k) * G + g * H + unit])
                : 0.0f;
    }
  for (int i = tid; i < 2 * R * TK; i += threads) tile[i] = 0.0f;
  const float br = unit_ok ? b[unit] : 0.0f;
  const float bz = unit_ok ? b[H + unit] : 0.0f;
  const float bn = unit_ok ? b[2 * H + unit] : 0.0f;

  // xg of a step, element e = (r * 3 + g) * U + u of the block's units
  // (consecutive threads on consecutive units): loaded into registers two
  // steps ahead, put into its ring slot the step before it is used
  const int n_in = 3 * R * U;
  T xr[NX];
  auto load_x = [&](int s) {
    const size_t t = static_cast<size_t>(t_of(s));
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int e = tid + j * threads;
      if (e < n_in) {
        const int rg = e >> lgU;
        const int row = row0 + rg / 3, gu = rank * U + (e & (U - 1));
        xr[j] = row < B && gu < H
                    ? xg[(static_cast<size_t>(row) * N + t) * G +
                         (rg % 3) * H + gu]
                    : from_f32<T>(0.0f);
      }
    }
  };
  auto store_x = [&](int s) {
    float* slot = ring + (s & 1) * 3 * R * UP;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int e = tid + j * threads;
      if (e < n_in) slot[(e >> lgU) * UP + (e & (U - 1))] = to_f32<T>(xr[j]);
    }
  };
  // the staged outputs of a step, element (q * R + r) * U + u, stored with
  // consecutive threads on consecutive units (at most NF a thread: a block
  // has 8U threads at least)
  auto flush = [&](int s, int slot) {
    const size_t t = static_cast<size_t>(t_of(s));
    const float* st = stage + slot * kStreams * R * UP;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int e = tid + j * threads;
      if (e >= NQ * R * U) break;
      const int u = e & (U - 1), qr = e >> lgU;
      const int q = qr / R, row = row0 + qr % R, gu = rank * U + u;
      if (row < B && gu < H) {
        const T v = from_f32<T>(st[qr * UP + u]);
        const size_t cell = static_cast<size_t>(row) * N + t;
        if (q == 0)
          ys[cell * H + gu] = v;
        else if (q < 4)
          gs[cell * G + (q - 1) * H + gu] = v;
        else
          hns[cell * H + gu] = v;
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
  if (tid == 0) {
    mbar_init(bar, nwarps);
    mbar_init(bar + 8, nwarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // every block of the cluster holds its zero tiles, its first xg slot and
  // its mbarriers before any block writes into another's shared memory
  cluster.sync();

  // the warp's units of a plane of a buffer: upw units x RQ rows,
  // contiguous, sent in 16-byte pieces (8 where that is all of it)
  const int upw = 32 / L;
  const int piece = upw * RQ * 4 >= 16 ? 16 : 8;
  const int lgp = __ffs(upw * RQ * 4 / piece) - 1;   // log2 of the pieces
  const int orow = p & (R - 1);   // the row whose cell this lane updates
  const bool owner = p < R;       // lanes p < R store it
  float h = 0.0f;
  int slot = 0;                   // the step's staging slot, s % kStages

  for (int s = 0; s < N; ++s) {
    const int buf = s & 1;
    if (s > 0) mbar_wait(bar + buf * 8, ((s - 1) >> 1) & 1);
    // the step's xg of the lane's cell, read before the product
    const float* xs = ring + buf * 3 * R * UP + orow * 3 * UP + ul;
    const float x3[3] = {xs[0], xs[UP], xs[2 * UP]};

    // the three gate sums of row orow: T(h_{t-1}) . T(W_hh[:, gate cols])
    float acc[3][R];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;
#pragma unroll
    for (int q = 0; q < QD; ++q) {
      const float4* hrow = reinterpret_cast<const float4*>(
                               tile + (buf * QD + q) * TK * RQ) + p;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const float4 hv = hrow[ch * L];
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};   // [e][r]
#pragma unroll
        for (int e = 0; e < KC; ++e)
#pragma unroll
          for (int r = 0; r < RQ; ++r)
#pragma unroll
            for (int g = 0; g < 3; ++g)
              acc[g][q * RQ + r] = fmaf(hk[e * RQ + r], wr[g][ch * KC + e],
                                        acc[g][q * RQ + r]);
      }
    }
    float hg[3];
    reduce_rows<R>(acc, hg, p, L);

    const float hn = hg[2] + bn;
    const float rg = fast_sigmoid(x3[0] + (hg[0] + br));
    const float zg = fast_sigmoid(x3[1] + (hg[1] + bz));
    const float ng = fast_tanh(x3[2] + rg * hn);
    h = (1.0f - zg) * ng + zg * h;
    const float hq = unit_ok ? round_to<T>(h) : 0.0f;
    const int nb = buf ^ 1;
    if (owner) {
      float* st = stage + slot * kStreams * R * UP + orow * UP + ul;
      st[0] = hq;
      if (kSave) {
        st[R * UP] = rg;
        st[2 * R * UP] = zg;
        st[3 * R * UP] = ng;
        st[4 * R * UP] = hn;
      }
      if (s + 1 < N)
        tile[((nb * QD + orow / RQ) * TK + unit) * RQ + orow % RQ] = hq;
    }
    const uint32_t nbar = bar + nb * 8;
    if (s + 1 < N) {
      // the warp's rows of T(h_t) into that buffer of every other block
      __syncwarp();
      const int lgs = lgp + lgQD;   // log2 of the pieces to one block
      const int total = (C - 1) << lgs;
      for (int i = lane; i < total; i += 32) {
        const int d = i >> lgs;
        const int dst = d < rank ? d : d + 1;
        const int q = (i >> lgp) & (QD - 1);
        const uint32_t src =
            smem_addr(tile + ((nb * QD + q) * TK + rank * U + warp * upw) *
                                 RQ) +
            (i & ((1 << lgp) - 1)) * piece;
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
    if (s > 0) flush(s - 1, slot == 0 ? kStages - 1 : slot - 1);
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
  __syncthreads();
  flush(N - 1, slot == 0 ? kStages - 1 : slot - 1);
  // no block exits while another may still write into it
  cluster.sync();
}

// The plan rule (the wrapper's _reg_rule(..., gates=3) and
// reg_smem_bytes("fwd", ..., gates=3) mirror it, held to
// bigru_fwd_reg_layout when the library loads): H up to kMaxH, a cluster of
// up to kMaxC blocks each owning a unit at least, tiles of 1, 2, 4 or 8
// rows, at most kMaxThreads threads and kMaxSmem bytes a block.
bool valid_reg_plan(int B, int N, int H, int C, int R) {
  if (B <= 0 || N <= 0 || H <= 0 || H > kMaxH || C < 1 || C > kMaxC ||
      (R != 1 && R != 2 && R != 4 && R != 8))
    return false;
  return (C - 1) * reg_units(H, C) < H &&
         reg_threads(H, C) <= kMaxThreads &&
         reg_smem_floats(H, C, R) * sizeof(float) <= kMaxSmem;
}

// The dynamic shared memory (and clusters above 8 blocks) an instance may
// use, set once per device and again only for more.
template <typename T, bool kSave, int R>
cudaError_t reg_prepare(int smem) {
  static std::atomic<int> allowed[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bigru_fwd_reg_kernel<T, kSave, R>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bigru_fwd_reg_kernel<T, kSave, R>,
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
                  const float* b_f, const void* w_b, const float* b_b,
                  void* ys_f, void* ys_b, void* gs_f, void* gs_b, void* hn_f,
                  void* hn_b, int B, int N, int H, int C, int dirs, int rev,
                  void* stream) {
  const size_t smem = reg_smem_floats(H, C, R) * sizeof(float);
  cudaError_t err = reg_prepare<T, kSave, R>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_reg_config(&cfg, &attr, (B + R - 1) / R, H, C, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bigru_fwd_reg_kernel<T, kSave, R>, in(xg_f),
                           in(xg_b), in(w_f), b_f, in(w_b), b_b, out(ys_f),
                           out(ys_b), out(gs_f), out(gs_b), out(hn_f),
                           out(hn_b), B, N, H, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSave>
int launch_reg(const void* xg_f, const void* xg_b, const void* w_f,
               const float* b_f, const void* w_b, const float* b_b,
               void* ys_f, void* ys_b, void* gs_f, void* gs_b, void* hn_f,
               void* hn_b, int B, int N, int H, int C, int R, int dirs,
               int rev, void* stream) {
  if (!valid_reg_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* fn = R == 1   ? launch_reg_as<T, kSave, 1>
             : R == 2 ? launch_reg_as<T, kSave, 2>
             : R == 4 ? launch_reg_as<T, kSave, 4>
                      : launch_reg_as<T, kSave, 8>;
  return fn(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b, gs_f, gs_b, hn_f,
            hn_b, B, N, H, C, dirs, rev, stream);
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
      &n, bigru_fwd_reg_kernel<T, kSave, R>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, bool kSave>
int reg_max_active(int H, int C, int R) {
  return R == 1   ? reg_max_active_as<T, kSave, 1>(H, C)
         : R == 2 ? reg_max_active_as<T, kSave, 2>(H, C)
         : R == 4 ? reg_max_active_as<T, kSave, 4>(H, C)
                  : reg_max_active_as<T, kSave, 8>(H, C);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device, with clusters of C = 1 .. 16 blocks over batch tiles of R = 1, 2,
// 4 or 8 rows; H up to 256. Arguments and outputs as bigru_fwd.cu's
// cluster entries: streams contiguous float (_f32) or bfloat16 (_bf16), xg
// [B, N, 3H], w [H, 3H] in the stream type, b [3H] float, ys [B, N, H];
// the training entries also gs [B, N, 3H] (r, z, n) and hn [B, N, H]; the
// one-direction entries walk t = N-1 .. 0 where reverse != 0. Returns a
// cudaError_t code; 0 means the launch was accepted.
#define BIGRU_FWD_REG_ENTRIES(SFX, TYPE)                                      \
  int bigru_fwd_reg_##SFX(const void* xg_f, const void* xg_b,                \
                          const void* w_f, const float* b_f, const void* w_b, \
                          const float* b_b, void* ys_f, void* ys_b, int B,   \
                          int N, int H, int C, int R, void* stream) {        \
    return launch_reg<TYPE, false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,     \
                                   ys_b, nullptr, nullptr, nullptr, nullptr, \
                                   B, N, H, C, R, 2, 0, stream);             \
  }                                                                          \
  int bigru_fwd_train_reg_##SFX(                                             \
      const void* xg_f, const void* xg_b, const void* w_f, const float* b_f, \
      const void* w_b, const float* b_b, void* ys_f, void* ys_b, void* gs_f, \
      void* gs_b, void* hn_f, void* hn_b, int B, int N, int H, int C, int R, \
      void* stream) {                                                        \
    return launch_reg<TYPE, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,      \
                                  ys_b, gs_f, gs_b, hn_f, hn_b, B, N, H, C,  \
                                  R, 2, 0, stream);                          \
  }                                                                          \
  int gru_fwd_reg_##SFX(const void* xg, const void* w, const float* b,       \
                        void* ys, int B, int N, int H, int C, int R,         \
                        int reverse, void* stream) {                         \
    return launch_reg<TYPE, false>(xg, xg, w, b, w, b, ys, ys, nullptr,      \
                                   nullptr, nullptr, nullptr, B, N, H, C, R, \
                                   1, reverse, stream);                      \
  }                                                                          \
  int gru_fwd_train_reg_##SFX(const void* xg, const void* w, const float* b, \
                              void* ys, void* gs, void* hn, int B, int N,    \
                              int H, int C, int R, int reverse,              \
                              void* stream) {                                \
    return launch_reg<TYPE, true>(xg, xg, w, b, w, b, ys, ys, gs, gs, hn,    \
                                  hn, B, N, H, C, R, 1, reverse, stream);    \
  }

BIGRU_FWD_REG_ENTRIES(f32, float)
BIGRU_FWD_REG_ENTRIES(bf16, __nv_bfloat16)
#undef BIGRU_FWD_REG_ENTRIES

// How many clusters of the kernel (bf16: 0 or 1, save: 0 or 1) at H, C and
// R the current device runs at once; a negative cudaError_t code on
// failure.
int bigru_fwd_reg_max_active_clusters(int bf16, int save, int H, int C,
                                      int R) {
  if (!valid_reg_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? reg_max_active<__nv_bfloat16, true>(H, C, R)
                : reg_max_active<__nv_bfloat16, false>(H, C, R);
  return save ? reg_max_active<float, true>(H, C, R)
              : reg_max_active<float, false>(H, C, R);
}

// The kernel's layout at H, C and R, for the wrapper's mirror: what 0 =
// dynamic shared memory in bytes, 1 = threads a block, 2 = units a block;
// -1 for a plan it does not take.
int bigru_fwd_reg_layout(int what, int H, int C, int R) {
  if (!valid_reg_plan(1, 1, H, C, R)) return -1;
  switch (what) {
    case 0: return static_cast<int>(reg_smem_floats(H, C, R) * sizeof(float));
    case 1: return reg_threads(H, C);
    case 2: return reg_units(H, C);
    default: return -1;
  }
}

const char* bigru_fwd_reg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
