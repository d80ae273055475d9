// The GRU forward's pipe kernel (bigru_fwd_pipe_kernel), float32 or
// bfloat16 streams, the light and the residual-saving (kSave) variant, both
// directions of a BiGRU layer (bigru_fwd_pipe_*, bigru_fwd_train_pipe_*) or
// one direction of a GRU (gru_fwd_pipe_*, gru_fwd_train_pipe_*, with a
// reverse flag): the second design of the forward above H = 256. Its own
// source, so that nvcc builds it beside bigru_fwd.cu, not after it.
//
// Replaces, at those widths, the same two TPU kernels as bigru_fwd.cu:
// room_slam_tpu/ops/gru_pallas.py::_bigru_fwd_kernel (:314, pallas_call
// :483 light and :454 training) with the grid's two directions and
// _gru_fwd_kernel (:39, pallas_call :182 light and :155 training) with a
// grid of one direction. The per-step arithmetic, the activations, the
// rounding points and the outputs are the stream kernel's of bigru_fwd.cu
// (see its notes): hg = T(h_{t-1}) . T(W_hh) + b_hh in float32, r and z
// from xg + hg, n = tanh(xg_n + r * hg_n), the h carry float32, ys (and
// with kSave the activated r, z, n and hn = hg_n) stored in the stream
// type. Only the order of the float32 sums of the product differs: each
// gate's sum over k is four partial sums (k = 4 i + p within each chunk of
// 16 rows, p the lane's quarter of the warp) added pairwise by shuffles.
//
// The first design for these widths (the stream kernel of bigru_fwd.cu,
// reached only by a forced ("stream", C, R) plan where this kernel took the
// route): each thread walks its unit's three gate columns of W_hh from L2
// with kStreamK values of k in flight, the h tile is pushed to every block
// by generic remote stores and a cluster.sync() ends every step (29 us a
// step at (32, 500, 512) f32 on an H100, chip_smoke.py phase 40).
//
// The design is bilstm_fwd_pipe.cu's (see its notes) with three gates: the
// block's slice of W_hh packed k-major [C][HP][U][4] by
// rnn_cuda.fwd_pipe_weights, a unit's r, z and n at one k in one 16-byte
// load (8 bytes in bf16; the fourth value zero, so that the two families
// share one layout and one mirror), streamed in chunks of 16 rows of k by a
// producer warp's cp.async.bulk, the part that fits held for the walk (the
// whole slice at H = 320 in f32 and at 512 in bf16), the rest through a
// ring; the product on CUDA cores with the four quarters of a warp summing
// interleaved rows of k, met by shuffles, tiles of 8 and 16 rows in two row
// groups of warps; h exchanged by st.async on mbarriers, one wait a step.

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

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

constexpr unsigned kFullMask = 0xffffffffu;
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

// the same, and `bytes` more to land in the phase
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity`, an acquire at the block's scope (the
// bytes of the other blocks complete on this block's mbarrier). A wait that
// outlasts kWaitTries polls (seconds: a lost exchange, never a slow one)
// traps, so a fault ends the launch with an error instead of hanging the
// card.
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

// 16 bytes into shared::cluster address `dst` of a block of the cluster,
// completed on that block's mbarrier `bar`
__device__ __forceinline__ void st_async16(uint32_t dst, const uint32_t (&v)[4],
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(bar)
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

// four W_hh values (a unit's gates at one k), as floats
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

// the R rows of one k of the h tile (16-byte broadcasts)
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
// The layout (the wrapper's rnn_cuda.fwd_pipe_layout and _fwd_pipe_rule
// mirror it, held to bigru_fwd_pipe_layout when the library loads; the
// layout is bilstm_fwd_pipe.cu's)
// ---------------------------------------------------------------------------

constexpr int kFpJK = 16;          // rows of k a chunk of the slice
constexpr int kFpQuarters = 4;     // lanes of a unit: a warp's quarters
constexpr int kFpUnitsWarp = 8;    // units a consumer warp
constexpr int kFpRing = 4;         // ring stages where the slice does not fit
constexpr int kFpMaxStages = 64;   // stages (and their mbarriers) at most
constexpr int kFpMaxC = 16;        // a non-portable cluster of 16 at most
constexpr int kFpNarrowWarps = 8;  // consumer warps of a narrow block
constexpr int kFpMaxWarps = 15;    // consumer warps at most
// __launch_bounds__: narrow blocks (up to 8 consumer warps and the
// producer) may take 168 registers a thread, wide ones (to 15 and the
// producer: 512 threads) 128 (at most 8 rows a warp there); ptxas sizes the
// cap to the bound rounded up to 128 threads, so 17 warps would get 96
constexpr int kFpNarrowThreads = 32 * (kFpNarrowWarps + 1);
constexpr int kFpWideThreads = 32 * (kFpMaxWarps + 1);

// H padded to whole chunks of kFpJK rows of k
__host__ __device__ __forceinline__ int fp_hp(int H) {
  return (H + kFpJK - 1) / kFpJK * kFpJK;
}

// units a block owns: ceil(H / C) up to a multiple of 4 (16-byte pieces of
// the exchange at any tile)
__host__ __device__ __forceinline__ int fp_units(int H, int C) {
  return ((H + C - 1) / C + 3) / 4 * 4;
}

// warps that cover the block's units once
__host__ __device__ __forceinline__ int fp_unit_warps(int H, int C) {
  return (fp_units(H, C) + kFpUnitsWarp - 1) / kFpUnitsWarp;
}

// row groups: tiles of 8 and 16 rows split into two halves, each walked by
// its own warps (two warps a scheduler), where the block stays within
// kFpMaxWarps; else one
__host__ __device__ __forceinline__ int fp_groups(int H, int C, int R) {
  return (R == 8 || R == 16) && 2 * fp_unit_warps(H, C) <= kFpMaxWarps ? 2
                                                                      : 1;
}

// consumer warps of a block (it adds one producer warp)
__host__ __device__ __forceinline__ int fp_warps(int H, int C, int R) {
  return fp_unit_warps(H, C) * fp_groups(H, C, R);
}

// floats of a row of the h tile: R, 20 at R = 16
__host__ __device__ __forceinline__ constexpr int fp_rs(int R) {
  return R == 16 ? 20 : R;
}

// rows of the h tile: every unit of the cluster and every k of the product
__host__ __device__ __forceinline__ int fp_tk(int H, int C) {
  const int a = C * fp_units(H, C);
  const int b = fp_hp(H);
  return a > b ? a : b;
}

__host__ __device__ __forceinline__ int fp_chunks(int H) {
  return fp_hp(H) / kFpJK;
}

__host__ __device__ __forceinline__ size_t fp_chunk_bytes(int H, int C,
                                                          int wbytes) {
  return static_cast<size_t>(kFpJK) * fp_units(H, C) * 4 * wbytes;
}

// bytes beside the chunks: the h tile [2][TK][RS] and the mbarriers (full
// and empty of kFpMaxStages stages, and two)
__host__ __device__ __forceinline__ size_t fp_fixed_bytes(int H, int C,
                                                          int R) {
  return 2 * static_cast<size_t>(fp_tk(H, C)) * fp_rs(R) * sizeof(float) +
         (2 * kFpMaxStages + 2) * 8;
}

// the chunks a block holds at once: as many as fit, at most the slice's
__host__ __device__ __forceinline__ int fp_stages(int H, int C, int R,
                                                  int wbytes) {
  const size_t fixed = fp_fixed_bytes(H, C, R);
  if (fixed >= static_cast<size_t>(kMaxSmem)) return 0;
  size_t s = (kMaxSmem - fixed) / fp_chunk_bytes(H, C, wbytes);
  const size_t nc = static_cast<size_t>(fp_chunks(H));
  if (s > nc) s = nc;
  if (s > static_cast<size_t>(kFpMaxStages)) s = kFpMaxStages;
  return static_cast<int>(s);
}

// of those, the ring stages the streamed chunks pass through: none where
// the whole slice is held, else kFpRing (fewer where fewer fit)
__host__ __device__ __forceinline__ int fp_ring(int H, int C, int R,
                                                int wbytes) {
  const int s = fp_stages(H, C, R, wbytes);
  if (s >= fp_chunks(H)) return 0;
  return s < kFpRing ? s : kFpRing;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// One cluster per (direction, batch tile of R rows); see the notes at the
// top. Block `rank` owns units rank * U .. rank * U + U - 1 and reads its
// slice of W_hh packed by the wrapper: [C][HP][U][4], value (k, u, g) the
// column g * H + rank * U + u of W_hh at row k (g < 3), zero past H and at
// g = 3. Consumer warp
// w walks units (w % NWU) * 8 .. + 7 for the rows (w / NWU) * R2 .. + R2 - 1
// of the tile (R2 = R / fp_groups); the last warp is the producer. kWide:
// more than kFpNarrowWarps consumer warps.
template <typename T, bool kSave, int R2, bool kWide>
__global__ void __launch_bounds__(kWide ? kFpWideThreads : kFpNarrowThreads,
                                  1)
bigru_fwd_pipe_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                      const T* __restrict__ w_f, const float* __restrict__ b_f,
                      const T* __restrict__ w_b, const float* __restrict__ b_b,
                      T* __restrict__ ys_f, T* __restrict__ ys_b,
                      T* __restrict__ gs_f, T* __restrict__ gs_b,
                      T* __restrict__ hn_f, T* __restrict__ hn_b, int B,
                      int N, int H, int R, int rev) {
  constexpr int NCELL = R2 >= 4 ? R2 / 4 : 1;   // cells a lane updates
  const int RS = fp_rs(R);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 fp_smem[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = fp_units(H, C);
  const int G = 3 * H;
  const int NWU = fp_unit_warps(H, C);
  const int RG = fp_groups(H, C, R);
  const int NWC = NWU * RG;
  const int TK = fp_tk(H, C);
  const int NC = fp_chunks(H);
  const int S = fp_stages(H, C, R, sizeof(T));
  const int SR = fp_ring(H, C, R, sizeof(T));
  const int P = S - SR;    // chunks held for the whole walk
  const int RC = NC - P;   // chunks streamed a step
  const int chunk = kFpJK * U * 4;
  const uint32_t cbytes = static_cast<uint32_t>(chunk * sizeof(T));
  T* ring = reinterpret_cast<T*>(fp_smem);                  // [S][JK][U][4]
  float* tile =
      reinterpret_cast<float*>(ring + static_cast<size_t>(S) * chunk);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tile + 2 * TK * RS);
  const uint32_t ring0 = smem_addr(ring);
  // full[st] (the chunk landed), empty[st] (every consumer warp is done
  // with it) and the h tile's hbar[b], 8 bytes each
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8u * kFpMaxStages;
  const uint32_t hbar0 = full0 + 16u * kFpMaxStages;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);

  // h_{-1} = 0, and the rows no block sends (past C * U) stay zero
  for (int i = tid; i < 2 * TK * RS; i += static_cast<int>(blockDim.x))
    tile[i] = 0.0f;
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full0 + 8u * st, 1);
      mbar_init(empty0 + 8u * st, NWC);
    }
    mbar_init(hbar0, NWC);
    mbar_init(hbar0 + 8, NWC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // every block of the cluster holds its zero tile and its mbarriers before
  // any block writes into another's shared memory
  cluster.sync();

  if (warp == NWC) {
    // the producer: the held chunks once, then the streamed chunks of every
    // step but the first (h_{-1} = 0 needs no product) in order, each into
    // the next ring stage once every consumer warp has released it
    if (lane == 0 && N > 1) {
      const T* wsl = (bwd ? w_b : w_f) +
                     static_cast<size_t>(rank) * fp_hp(H) * U * 4;
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
    const int quarter = lane >> 3;                  // k = 4 i + quarter
    const int ug = warp % NWU;                      // the warp's units
    const int rg = warp / NWU;                      // and rows of the tile
    const int ul = ug * kFpUnitsWarp + (lane & 7);  // unit in the block
    const bool uin = ul < U;
    const int uw = uin ? ul : U - 1;                // the W column it reads
    const int gu = rank * U + ul;                   // unit in the layer
    const bool uok = uin && gu < H;
    const int row0 = (blockIdx.x / C) * R;
    const T* xg = bwd ? xg_b : xg_f;
    const float* b = bwd ? b_b : b_f;
    T* ys = bwd ? ys_b : ys_f;
    T* gs = bwd ? gs_b : gs_f;
    T* hns = bwd ? hn_b : hn_f;
    const float br = uok ? b[gu] : 0.0f;
    const float bz = uok ? b[H + gu] : 0.0f;
    const float bn = uok ? b[2 * H + gu] : 0.0f;
    auto t_of = [&](int s) { return bwd ? N - 1 - s : s; };

    // the lane's cells after the reduce-scatter: rows rg * R2 + (quarter &
    // 1) * R2 / 2 + (quarter >> 1) * R2 / 4 + i (R2 >= 4); row rg * R2 +
    // quarter for the lanes quarter < R2 (R2 < 4)
    int crow[NCELL];
    bool cown[NCELL], cok[NCELL];
    size_t xoff[NCELL], yoff[NCELL];   // (row, t = 0, unit gu) offsets
#pragma unroll
    for (int i = 0; i < NCELL; ++i) {
      if constexpr (R2 >= 4) {
        crow[i] = rg * R2 + (quarter & 1) * (R2 / 2) +
                  (quarter >> 1) * (R2 / 4) + i;
        cown[i] = uin;
      } else {
        crow[i] = rg * R2 + quarter;
        cown[i] = uin && quarter < R2;
      }
      const int row = row0 + crow[i];
      cok[i] = cown[i] && uok && row < B;
      const size_t rw = static_cast<size_t>(cok[i] ? row : 0);
      xoff[i] = rw * N * G + (cok[i] ? gu : 0);
      yoff[i] = rw * N * H + (cok[i] ? gu : 0);
    }
    // the cells' xg of the next step, as loaded
    T xn[NCELL][3];
    auto load_x = [&](int s) {
      const size_t t = static_cast<size_t>(t_of(s));
#pragma unroll
      for (int i = 0; i < NCELL; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          xn[i][g] = cok[i] ? xg[xoff[i] + t * G + g * H]
                            : from_f32<T>(0.0f);
    };
    load_x(0);
    float h[NCELL];   // the cells' float32 carries
#pragma unroll
    for (int i = 0; i < NCELL; ++i) h[i] = 0.0f;

    // the warp's part of a buffer, sent in 16-byte pieces to every other
    // block: its nu units x RS floats, contiguous (one row group), or its
    // R2 rows of each of its units (two: R2 / 4 pieces a unit)
    const int nu = U - ug * kFpUnitsWarp < kFpUnitsWarp
                       ? U - ug * kFpUnitsWarp
                       : kFpUnitsWarp;
    constexpr int kPpu = R2 >= 4 ? R2 / 4 : 1;   // pieces a unit (two groups)
    const int pieces = RG == 1 ? nu * RS / 4 : nu * kPpu;
    const uint32_t tile_tx =
        static_cast<uint32_t>((C - 1) * U * (RG == 1 ? RS : R) * 4);
    int st = 0;         // the ring stage of the next streamed chunk
    uint32_t ph = 0;    // and its phase
    for (int s = 0; s < N; ++s) {
      const int buf = s & 1;
      const size_t t = static_cast<size_t>(t_of(s));
      float x[NCELL][3];
#pragma unroll
      for (int i = 0; i < NCELL; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) x[i][g] = to_f32<T>(xn[i][g]);
      if (s + 1 < N) load_x(s + 1);

      // the three gate sums of the lane's cells: T(h_{t-1}) . T(W_hh)
      float gsum[NCELL][3];
#pragma unroll
      for (int i = 0; i < NCELL; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) gsum[i][g] = 0.0f;
      if (s > 0) {
        // step s reads buffer s & 1 (h_{s-1}): the ((s - 1) / 2)-th phase
        // of hbar[s & 1]
        mbar_wait(hbar0 + 8u * buf, ((s - 1) >> 1) & 1);
        const float* hb = tile + buf * TK * RS;
        float acc[3][R2];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int r = 0; r < R2; ++r) acc[g][r] = 0.0f;
        for (int cc = 0; cc < NC; ++cc) {
          int stage = cc;
          const bool streamed = cc >= P;
          if (!streamed) {
            if (s == 1) mbar_wait(full0 + 8u * cc, 0);
          } else {
            stage = P + st;
            mbar_wait(full0 + 8u * stage, ph);
            if (++st == SR) {
              st = 0;
              ph ^= 1u;
            }
          }
          const T* wc = ring + static_cast<size_t>(stage) * chunk;
          const float* hc = hb + cc * kFpJK * RS + rg * R2;
#pragma unroll
          for (int i = 0; i < kFpJK / kFpQuarters; ++i) {
            const int kr = i * kFpQuarters + quarter;
            float w[4];
            load_w4(wc + (kr * U + uw) * 4, w);
            float hv[R2];
            load_rows<R2>(hc + kr * RS, hv);
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
              for (int r = 0; r < R2; ++r)
                acc[g][r] = fmaf(hv[r], w[g], acc[g][r]);
          }
          if (streamed) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8u * stage);
          }
        }
        // the four quarters' partials: lane bit 3, then bit 4
        if constexpr (R2 >= 4) {
          const bool b0 = (quarter & 1) != 0, b1 = (quarter & 2) != 0;
          float half[3][R2 / 2];
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int j = 0; j < R2 / 2; ++j) {
              const float keep = b0 ? acc[g][R2 / 2 + j] : acc[g][j];
              const float send = b0 ? acc[g][j] : acc[g][R2 / 2 + j];
              half[g][j] = keep + __shfl_xor_sync(kFullMask, send, 8);
            }
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int j = 0; j < R2 / 4; ++j) {
              const float keep = b1 ? half[g][R2 / 4 + j] : half[g][j];
              const float send = b1 ? half[g][j] : half[g][R2 / 4 + j];
              gsum[j][g] = keep + __shfl_xor_sync(kFullMask, send, 16);
            }
        } else if constexpr (R2 == 2) {
          const bool b0 = (quarter & 1) != 0;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float keep = b0 ? acc[g][1] : acc[g][0];
            const float send = b0 ? acc[g][0] : acc[g][1];
            const float v = keep + __shfl_xor_sync(kFullMask, send, 8);
            gsum[0][g] = v + __shfl_xor_sync(kFullMask, v, 16);
          }
        } else {
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float v =
                acc[g][0] + __shfl_xor_sync(kFullMask, acc[g][0], 8);
            gsum[0][g] = v + __shfl_xor_sync(kFullMask, v, 16);
          }
        }
      }

      // the cells: the stream kernel's arithmetic, b_hh added to the sums
      const int nb = buf ^ 1;
      float* own = tile + (nb * TK + rank * U) * RS;
#pragma unroll
      for (int i = 0; i < NCELL; ++i) {
        if (!cown[i]) continue;
        const float hn = gsum[i][2] + bn;
        const float r = sigmoid_f(x[i][0] + (gsum[i][0] + br));
        const float z = sigmoid_f(x[i][1] + (gsum[i][1] + bz));
        const float n = tanhf(x[i][2] + r * hn);
        h[i] = (1.0f - z) * n + z * h[i];
        if (cok[i]) {
          ys[yoff[i] + t * H] = from_f32<T>(h[i]);
          if (kSave) {
            T* gt = gs + xoff[i] + t * G;
            gt[0] = from_f32<T>(r);
            gt[H] = from_f32<T>(z);
            gt[2 * H] = from_f32<T>(n);
            hns[yoff[i] + t * H] = from_f32<T>(hn);
          }
        }
        if (s + 1 < N)
          own[ul * RS + crow[i]] = uok ? to_f32<T>(from_f32<T>(h[i])) : 0.0f;
      }
      if (s + 1 < N) {
        // the warp's units of T(h_t) into that buffer of every other block,
        // then the warp's arrival on its own
        const uint32_t nbar = hbar0 + 8u * nb;
        __syncwarp();
        const uint32_t region = smem_addr(own + ug * kFpUnitsWarp * RS);
        for (int p = lane; p < pieces; p += 32) {
          // the piece's 16 bytes, loaded once, to each other block
          const int off = RG == 1 ? 4 * p
                                  : (p / kPpu) * RS + rg * R2 + 4 * (p % kPpu);
          const uint32_t src = region + off * 4;
          uint32_t v[4];
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                       : "r"(src)
                       : "memory");
          for (int q = 0; q < C; ++q)
            if (q != rank)
              st_async16(cluster_addr(src, q), v, cluster_addr(nbar, q));
        }
        __syncwarp();
        if (lane == 0) {
          if (warp == 0)
            mbar_arrive_expect(nbar, tile_tx);
          else
            mbar_arrive(nbar);
        }
      }
    }
  }
  // no block exits while another may still write into it
  cluster.sync();
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

// The plan rule (the wrapper's _fwd_pipe_rule mirrors it): a cluster of 1
// to kFpMaxC blocks each owning a unit, at most kFpMaxWarps consumer warps
// (U <= 120), tiles of 1, 2, 4, 8, 12 or 16 rows (16 in two row groups
// only, 12 in narrow blocks only: at most 8 rows a warp in a wide one), and
// two chunks of the slice in shared memory at least (one where the slice is
// one chunk).
bool fp_row_ok(int R) {
  return R == 1 || R == 2 || R == 4 || R == 8 || R == 12 || R == 16;
}

bool valid_fp_plan(int B, int N, int H, int C, int R, int wbytes) {
  if (B <= 0 || N <= 0 || H <= 0 || C < 1 || C > kFpMaxC || !fp_row_ok(R))
    return false;
  const int U = fp_units(H, C);
  const int warps = fp_warps(H, C, R);
  if ((C - 1) * U >= H || warps > kFpMaxWarps ||
      (R == 16 && fp_groups(H, C, R) != 2) ||
      (R == 12 && warps > kFpNarrowWarps))
    return false;
  const int nc = fp_chunks(H);
  return fp_stages(H, C, R, wbytes) >= (nc < 2 ? nc : 2);
}

size_t fp_smem_bytes(int H, int C, int R, int wbytes) {
  return fp_stages(H, C, R, wbytes) * fp_chunk_bytes(H, C, wbytes) +
         fp_fixed_bytes(H, C, R);
}

int fp_threads(int H, int C, int R) { return 32 * (fp_warps(H, C, R) + 1); }

template <typename T, bool kSave>
using FpKernel = void (*)(const T*, const T*, const T*, const float*,
                          const T*, const float*, T*, T*, T*, T*, T*, T*, int,
                          int, int, int, int);

// the instance for R2 rows a warp, narrow or wide
template <typename T, bool kSave>
FpKernel<T, kSave> fp_kernel(int R2, bool wide) {
  if (wide) {
    switch (R2) {
      case 1: return bigru_fwd_pipe_kernel<T, kSave, 1, true>;
      case 2: return bigru_fwd_pipe_kernel<T, kSave, 2, true>;
      case 4: return bigru_fwd_pipe_kernel<T, kSave, 4, true>;
      case 8: return bigru_fwd_pipe_kernel<T, kSave, 8, true>;
      default: return nullptr;
    }
  }
  switch (R2) {
    case 1: return bigru_fwd_pipe_kernel<T, kSave, 1, false>;
    case 2: return bigru_fwd_pipe_kernel<T, kSave, 2, false>;
    case 4: return bigru_fwd_pipe_kernel<T, kSave, 4, false>;
    case 8: return bigru_fwd_pipe_kernel<T, kSave, 8, false>;
    case 12: return bigru_fwd_pipe_kernel<T, kSave, 12, false>;
    default: return nullptr;
  }
}

// the slot of fp_prepare's cache for R2 rows a warp, narrow or wide
int fp_slot(int R2, bool wide) {
  const int r = R2 == 1 ? 0 : R2 == 2 ? 1 : R2 == 4 ? 2 : R2 == 8 ? 3 : 4;
  return 2 * r + (wide ? 1 : 0);
}

// The dynamic shared memory the instance `fn` may use and its non-portable
// cluster size, set once per device and again only for more.
template <typename T, bool kSave>
cudaError_t fp_prepare(FpKernel<T, kSave> fn, int slot, int smem) {
  static std::atomic<int> allowed[10][kMaxDevices];
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

void make_fp_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
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

template <typename T, bool kSave>
int launch_fp(const void* xg_f, const void* xg_b, const void* w_f,
              const float* b_f, const void* w_b, const float* b_b,
              void* ys_f, void* ys_b, void* gs_f, void* gs_b, void* hn_f,
              void* hn_b, int B, int N, int H, int C, int R, int dirs,
              int rev, void* stream) {
  const int wbytes = static_cast<int>(sizeof(T));
  if (!valid_fp_plan(B, N, H, C, R, wbytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = fp_warps(H, C, R) > kFpNarrowWarps;
  const int R2 = R / fp_groups(H, C, R);
  const FpKernel<T, kSave> fn = fp_kernel<T, kSave>(R2, wide);
  const size_t smem = fp_smem_bytes(H, C, R, wbytes);
  cudaError_t err =
      fp_prepare<T, kSave>(fn, fp_slot(R2, wide), static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_fp_config(&cfg, &attr, (B + R - 1) / R, fp_threads(H, C, R), C, dirs,
                 smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, fn, in(xg_f), in(xg_b), in(w_f), b_f,
                           in(w_b), b_b, out(ys_f), out(ys_b), out(gs_f),
                           out(gs_b), out(hn_f), out(hn_b), B, N, H, R, rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSave>
int fp_max_active(int H, int C, int R) {
  const int wbytes = static_cast<int>(sizeof(T));
  const bool wide = fp_warps(H, C, R) > kFpNarrowWarps;
  const int R2 = R / fp_groups(H, C, R);
  const FpKernel<T, kSave> fn = fp_kernel<T, kSave>(R2, wide);
  const size_t smem = fp_smem_bytes(H, C, R, wbytes);
  cudaError_t err =
      fp_prepare<T, kSave>(fn, fp_slot(R2, wide), static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_fp_config(&cfg, &attr, 1, fp_threads(H, C, R), C, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device; returns a cudaError_t code, 0 when the launch was accepted. All
// streams are contiguous, in the stream type float (_f32) or bfloat16
// (_bf16): xg_* [B, N, 3H]; w_* W_hh packed by rnn_cuda.fwd_pipe_weights
// at this C ([C][HP][U][4]); b_* [3H] float32; ys_* and hn_* [B, N, H];
// gs_* [B, N, 3H]; clusters of C = 1 .. 16 blocks over batch tiles of R =
// 1, 2, 4, 8, 12 or 16 rows. gru_*: a grid of one direction, reverse != 0
// walks t = N-1 .. 0.
#define BIGRU_FWD_PIPE_ENTRIES(SFX, TYPE)                                     \
  int bigru_fwd_pipe_##SFX(const void* xg_f, const void* xg_b,               \
                           const void* w_f, const float* b_f,                \
                           const void* w_b, const float* b_b, void* ys_f,    \
                           void* ys_b, int B, int N, int H, int C, int R,    \
                           void* stream) {                                   \
    return launch_fp<TYPE, false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,      \
                                  ys_b, nullptr, nullptr, nullptr, nullptr,  \
                                  B, N, H, C, R, 2, 0, stream);              \
  }                                                                          \
  int bigru_fwd_train_pipe_##SFX(                                            \
      const void* xg_f, const void* xg_b, const void* w_f, const float* b_f, \
      const void* w_b, const float* b_b, void* ys_f, void* ys_b, void* gs_f, \
      void* gs_b, void* hn_f, void* hn_b, int B, int N, int H, int C, int R, \
      void* stream) {                                                        \
    return launch_fp<TYPE, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b, \
                                 gs_f, gs_b, hn_f, hn_b, B, N, H, C, R, 2,   \
                                 0, stream);                                 \
  }                                                                          \
  int gru_fwd_pipe_##SFX(const void* xg, const void* w, const float* b,      \
                         void* ys, int B, int N, int H, int C, int R,        \
                         int reverse, void* stream) {                        \
    return launch_fp<TYPE, false>(xg, xg, w, b, w, b, ys, ys, nullptr,       \
                                  nullptr, nullptr, nullptr, B, N, H, C, R,  \
                                  1, reverse, stream);                       \
  }                                                                          \
  int gru_fwd_train_pipe_##SFX(const void* xg, const void* w,                \
                               const float* b, void* ys, void* gs, void* hn, \
                               int B, int N, int H, int C, int R,            \
                               int reverse, void* stream) {                  \
    return launch_fp<TYPE, true>(xg, xg, w, b, w, b, ys, ys, gs, gs, hn, hn, \
                                 B, N, H, C, R, 1, reverse, stream);         \
  }

BIGRU_FWD_PIPE_ENTRIES(f32, float)
BIGRU_FWD_PIPE_ENTRIES(bf16, __nv_bfloat16)
#undef BIGRU_FWD_PIPE_ENTRIES

// How many clusters of the pipe kernel (bf16: 0 or 1, save: 0 or 1) at H, C
// and R the current device runs at once; a negative cudaError_t code on
// failure.
int bigru_fwd_pipe_max_active_clusters(int bf16, int save, int H, int C,
                                        int R) {
  if (!valid_fp_plan(1, 1, H, C, R, bf16 ? 2 : 4))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return save ? fp_max_active<__nv_bfloat16, true>(H, C, R)
                : fp_max_active<__nv_bfloat16, false>(H, C, R);
  return save ? fp_max_active<float, true>(H, C, R)
              : fp_max_active<float, false>(H, C, R);
}

// The pipe kernel's layout at H, C and R with W_hh in bf16 (1) or float32
// (0), for the wrapper's mirror: what 0 = dynamic shared memory in bytes,
// 1 = threads a block, 2 = units a block, 3 = chunks in shared memory, 4 =
// of those held for the whole walk, 5 = chunks of the slice; -1 for a plan
// it does not take.
int bigru_fwd_pipe_layout(int what, int bf16, int H, int C, int R) {
  const int wbytes = bf16 ? 2 : 4;
  if (!valid_fp_plan(1, 1, H, C, R, wbytes)) return -1;
  switch (what) {
    case 0: return static_cast<int>(fp_smem_bytes(H, C, R, wbytes));
    case 1: return fp_threads(H, C, R);
    case 2: return fp_units(H, C);
    case 3: return fp_stages(H, C, R, wbytes);
    case 4: return fp_stages(H, C, R, wbytes) - fp_ring(H, C, R, wbytes);
    case 5: return fp_chunks(H);
    default: return -1;
  }
}

const char* bigru_fwd_pipe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
