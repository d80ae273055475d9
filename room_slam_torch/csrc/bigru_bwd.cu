// Fused GRU recurrence, backward (BPTT), float32 or bfloat16 streams, with
// W_hh^T split across the blocks of a thread-block cluster. One source, two
// grids: both directions of a BiGRU layer (bigru_bwd_*), or one direction
// of a GRU (gru_bwd_*, with a reverse flag).
//
// Replaces two TPU kernels: room_slam_tpu/ops/gru_pallas.py::
// _bigru_bwd_kernel (:357, pallas_call :527, launched through
// _bigru_bwd_pallas from _bigru_core_bwd) with the grid's two directions,
// and _gru_bwd_kernel (:71, pallas_call :218, launched through
// _gru_bwd_pallas from _gru_core_bwd) with a grid of one direction. From
// the residuals of the training forward (bigru_fwd.cu, kSave: activated
// gates r, z, n, hn = W_hn h + b_hn, and ys) it walks each direction in
// reverse of its forward order and emits, per direction, dx [B, N, 3H]
// (the cotangent of the gate stream xg) and dhn [B, N, H]. dW_hh and db_hh
// are a matrix product and a sum outside the kernel, as in the reference.
//
// Per step, with T() the rounding to the stream type, h_prev the output one
// step earlier in the forward order (zero at its first step), and the
// linearized coefficients of the reference (:374-384):
//
//   a   = (1 - z) * (1 - n^2)
//   c   = T([a * hn * r * (1 - r), (h_prev - n) * z * (1 - z), a])
//   dh_t = dy_t + dh_carry
//   dx   = [dh_t, dh_t, dh_t] * c                 (stored as T)
//   dhn  = dx_n * r                               (stored as T)
//   dh_carry = dh_t * z + T([dx_r, dx_z, dhn]) @ T(W_hh)^T   (f32 sums)
//
// The forward direction walks t = N-1 .. 0; the backward-in-time direction
// (and a single-direction GRU run with reverse) walks t = 0 .. N-1 and takes
// h_prev from t + 1. All arrays are in original time order.
//
// What bounds it on an H100. At the scale-up shape (B=128, N=5000, H=256,
// bf16) it reads 3H + H + H + H and writes 3H + H values per (row, step) and
// direction, 6.6 GB for both directions (1.96 ms at 3.35 TB/s), and does
// 2 * 3H * H multiply-adds per (row, step) and direction for dg @ W_hh^T,
// 504 GFLOP for both (0.51 ms at 989 TFLOP/s for bf16 operands). At the
// legacy GRU shape (one direction, B=32, N=500, H=64, f32) it moves 41 MB
// (12.2 us) and does 0.39 GFLOP (5.9 us at 67 TFLOP/s). The real floor is
// the serial chain of 5000 (500) dependent steps, each a 768-deep (192-deep)
// dot product per (row, unit);
// measured on an H100 a step takes 18.5 us, by the look of it bound by
// shared-memory loads: per j, one W load and one 128-bit broadcast load of
// four rows of dg feed four FMAs (see bigru_fwd.cu).
//
// What the design does about it. W_hh^T is [3H, H]: 768 KiB in float32 at
// H=256. One cluster of C blocks (1, 2, 4 or 8, planned by the wrapper as
// for bigru_fwd.cu) handles one (direction, batch tile of R rows); its
// block of rank q owns the U = H / C units q*U .. q*U+U-1 of dh and holds
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
// step. Tensor cores are left for later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerThread = 4;  // batch rows of one thread (a float4)
static_assert(kRowsPerThread == 4, "rows travel as one float4");
constexpr int kMaxThreads = 512;

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

struct StepIn {
  float r, z, n, hn, hp, dy;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bigru_bwd_kernel(const T* __restrict__ w_f, const T* __restrict__ w_b,
                 const T* __restrict__ gs_f, const T* __restrict__ hn_f,
                 const T* __restrict__ ys_f, const T* __restrict__ dy_f,
                 const T* __restrict__ gs_b, const T* __restrict__ hn_b,
                 const T* __restrict__ ys_b, const T* __restrict__ dy_b,
                 T* __restrict__ dx_f, T* __restrict__ dhn_f,
                 T* __restrict__ dx_b, T* __restrict__ dhn_b,
                 int B, int N, int H, int R, int rev) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = H / C;
  const int G = 3 * H;
  float* wt_s = smem;                       // [3H][U] W_hh[unit, j]
  float* dg_s = smem + pad4(static_cast<size_t>(G) * U);   // [2][3H][R]

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const int u = threadIdx.x % U;
  const int r0 = (threadIdx.x / U) * kRowsPerThread;
  const int gu = rank * U + u;
  const int row0 = (blockIdx.x / C) * R + r0;

  // rows rank*U .. rank*U+U-1 of W_hh, transposed: consecutive threads read
  // consecutive columns of one row
  for (int idx = threadIdx.x; idx < U * G; idx += blockDim.x) {
    const int uu = idx / G;
    const int j = idx - uu * G;
    const size_t row = static_cast<size_t>(rank * U + uu);
    wt_s[j * U + uu] = to_f32<T>(w[row * G + j]);
  }

  bool valid[kRowsPerThread];
  size_t goff[kRowsPerThread];  // gates / dx of (row, t = 0, unit gu)
  size_t hoff[kRowsPerThread];  // hn, ys, dy, dhn of (row, t = 0, unit gu)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    valid[i] = row0 + i < B;
    const size_t row = static_cast<size_t>(valid[i] ? row0 + i : 0);
    goff[i] = row * N * G + gu;
    hoff[i] = row * N * H + gu;
  }
  const T* gs = bwd ? gs_b : gs_f;
  const T* hns = bwd ? hn_b : hn_f;
  const T* dys = bwd ? dy_b : dy_f;
  T* dx = bwd ? dx_b : dx_f;
  T* dhn = bwd ? dhn_b : dhn_f;
  // h at the forward order's previous step (t - 1 forward, t + 1
  // backward), read only after that order's first step
  const int first = bwd ? N - 1 : 0;
  const T* hps = (bwd ? ys_b : ys_f) + (bwd ? H : -H);

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
      const float a = (1.0f - c.z) * (1.0f - c.n * c.n);
      const float c_r = round_to<T>(a * c.hn * c.r * (1.0f - c.r));
      const float c_z = round_to<T>((c.hp - c.n) * c.z * (1.0f - c.z));
      const float c_n = round_to<T>(a);
      const float dh_t = c.dy + dh[i];
      const float dxr = dh_t * c_r;
      const float dxz = dh_t * c_z;
      const float dxn = dh_t * c_n;
      const float dhn_t = dxn * c.r;
      if (valid[i]) {
        T* o = dx + goff[i] + static_cast<size_t>(t) * G;
        o[0] = from_f32<T>(dxr);
        o[H] = from_f32<T>(dxz);
        o[2 * H] = from_f32<T>(dxn);
        dhn[hoff[i] + static_cast<size_t>(t) * H] = from_f32<T>(dhn_t);
      }
      dgr[i] = round_to<T>(dxr);
      dgz[i] = round_to<T>(dxz);
      dgn[i] = round_to<T>(dhn_t);
      dhz[i] = dh_t * c.z;
    }

    // push this thread's dg = [dx_r, dx_z, dhn] into every block's tile
    float* slot = dg_s + (s & 1) * G * R;
    float* mine = slot + gu * R + r0;
    const float4 vr = make_float4(dgr[0], dgr[1], dgr[2], dgr[3]);
    const float4 vz = make_float4(dgz[0], dgz[1], dgz[2], dgz[3]);
    const float4 vn = make_float4(dgn[0], dgn[1], dgn[2], dgn[3]);
    for (int q = 0; q < C; ++q) {
      float* dst = cluster.map_shared_rank(mine, q);
      *reinterpret_cast<float4*>(dst) = vr;
      *reinterpret_cast<float4*>(dst + H * R) = vz;
      *reinterpret_cast<float4*>(dst + 2 * H * R) = vn;
    }
    cluster.sync();

    // dh_carry = dh_t * z + dg . W_hh^T[:, unit]; two partial sums a row
    const float* dgb = slot + r0;
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
    for (int i = 0; i < kRowsPerThread; ++i) dh[i] = dhz[i] + (a0[i] + a1[i]);
  }
}

// Dynamic shared memory one block needs, in bytes (the wrapper's
// bigru_smem_bytes("bwd", ...) mirrors it to pick the cluster size).
size_t smem_bytes(int H, int C, int R) {
  const size_t U = static_cast<size_t>(H / C);
  const size_t G = 3 * static_cast<size_t>(H);
  return (pad4(G * U) + 2 * G * R) * sizeof(float);
}

bool valid_plan(int B, int N, int H, int C, int R) {
  return B > 0 && N > 0 && H > 0 && C >= 1 && C <= 8 && H % C == 0 &&
         R > 0 && R % kRowsPerThread == 0 &&
         (H / C) * (R / kRowsPerThread) <= kMaxThreads;
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
  err = cudaFuncSetAttribute(bigru_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<T>[device].store(smem);
  return err;
}

void make_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B,
                 int H, int C, int R, int dirs, size_t smem, void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(C * ((B + R - 1) / R), dirs, 1);
  cfg->blockDim = dim3((H / C) * (R / kRowsPerThread), 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T>
int launch(const void* w_f, const void* w_b, const void* gs_f,
           const void* hn_f, const void* ys_f, const void* dy_f,
           const void* gs_b, const void* hn_b, const void* ys_b,
           const void* dy_b, void* dx_f, void* dhn_f, void* dx_b, void* dhn_b,
           int B, int N, int H, int C, int R, int dirs, int rev,
           void* stream) {
  if (!valid_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H, C, R);
  cudaError_t err = allow_smem<T>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, B, H, C, R, dirs, smem, stream);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  err = cudaLaunchKernelEx(&cfg, bigru_bwd_kernel<T>, in(w_f), in(w_b),
                           in(gs_f), in(hn_f), in(ys_f), in(dy_f), in(gs_b),
                           in(hn_b), in(ys_b), in(dy_b), out(dx_f),
                           out(dhn_f), out(dx_b), out(dhn_b), B, N, H, R,
                           rev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_active_clusters(int H, int C, int R) {
  const size_t smem = smem_bytes(H, C, R);
  cudaError_t err = allow_smem<T>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, R, H, C, R, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bigru_bwd_kernel<T>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device, with clusters of C blocks over batch tiles of R rows (H % C == 0,
// R a multiple of 4). All tensors are contiguous, in the stream type float
// (_f32) or bfloat16 (_bf16): w_* [H, 3H]; gs_* and dx_* [B, N, 3H]; hn_*,
// ys_*, dy_* and dhn_* [B, N, H]. Returns a cudaError_t code; 0 means the
// launch was accepted.
int bigru_bwd_f32(const void* w_f, const void* w_b, const void* gs_f,
                  const void* hn_f, const void* ys_f, const void* dy_f,
                  const void* gs_b, const void* hn_b, const void* ys_b,
                  const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                  void* dhn_b, int B, int N, int H, int C, int R,
                  void* stream) {
  return launch<float>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b, ys_b,
                       dy_b, dx_f, dhn_f, dx_b, dhn_b, B, N, H, C, R, 2, 0,
                       stream);
}

int bigru_bwd_bf16(const void* w_f, const void* w_b, const void* gs_f,
                   const void* hn_f, const void* ys_f, const void* dy_f,
                   const void* gs_b, const void* hn_b, const void* ys_b,
                   const void* dy_b, void* dx_f, void* dhn_f, void* dx_b,
                   void* dhn_b, int B, int N, int H, int C, int R,
                   void* stream) {
  return launch<__nv_bfloat16>(w_f, w_b, gs_f, hn_f, ys_f, dy_f, gs_b, hn_b,
                               ys_b, dy_b, dx_f, dhn_f, dx_b, dhn_b, B, N, H,
                               C, R, 2, 0, stream);
}

// One direction of a GRU: as bigru_bwd_* with a grid of one direction over
// w [H, 3H], gs and dx [B, N, 3H], hn, ys, dy and dhn [B, N, H]; reverse != 0
// for a direction whose forward walked t = N-1 .. 0. The cluster count of
// bigru_bwd_max_active_clusters holds.
int gru_bwd_f32(const void* w, const void* gs, const void* hn, const void* ys,
                const void* dy, void* dx, void* dhn, int B, int N, int H,
                int C, int R, int reverse, void* stream) {
  return launch<float>(w, w, gs, hn, ys, dy, gs, hn, ys, dy, dx, dhn, dx, dhn,
                       B, N, H, C, R, 1, reverse, stream);
}

int gru_bwd_bf16(const void* w, const void* gs, const void* hn,
                 const void* ys, const void* dy, void* dx, void* dhn, int B,
                 int N, int H, int C, int R, int reverse, void* stream) {
  return launch<__nv_bfloat16>(w, w, gs, hn, ys, dy, gs, hn, ys, dy, dx, dhn,
                               dx, dhn, B, N, H, C, R, 1, reverse, stream);
}

// How many clusters the current device runs at once (bf16: 0 or 1); a
// negative cudaError_t code on failure.
int bigru_bwd_max_active_clusters(int bf16, int H, int C, int R) {
  if (!valid_plan(1, 1, H, C, R))
    return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? max_active_clusters<__nv_bfloat16>(H, C, R)
              : max_active_clusters<float>(H, C, R);
}

const char* bigru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
