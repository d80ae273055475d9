// Fused bidirectional GRU recurrence, forward, float32 or bfloat16 streams:
// the inference (light) variant and the training variant that also saves
// residuals, with W_hh split across the blocks of a thread-block cluster.
//
// Replaces the TPU kernel room_slam_tpu/ops/gru_pallas.py::_bigru_fwd_kernel
// (launched through _bigru_fwd_pallas and bigru_recurrence_pallas), both its
// save_residuals pallas_call and its light one. For one BiGRU layer, both
// directions, with torch nn.GRU numerics (gate order r, z, n):
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
// copies are made and every output comes back in original time order. Every
// step of the padded window runs; there is no mask, as in the reference.
//
// What bounds it on an H100. At the scale-up shape (B=128, N=5000, H=256,
// bf16) the light kernel moves 3H in and H out per (row, step) and direction,
// 2.6 GB for both directions (0.78 ms at 3.35 TB/s), and does 2 * 3H * H
// multiply-adds per (row, step) and direction, 504 GFLOP for both (0.51 ms
// at 989 TFLOP/s for bf16 operands).
// Neither is the real floor: the recurrence is a chain of 5000 dependent
// steps, each a 256-deep dot product for 768 gate columns of every row, so
// the time is 5000 times the latency of one step. On CUDA cores with
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
// batch tile of R rows), and its block of rank q owns the U = H / C hidden
// units q*U .. q*U+U-1: it holds the W_hh columns of the r, z and n gates of
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

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__host__ __device__ __forceinline__ size_t pad4(size_t n) {
  return (n + 3) / 4 * 4;
}

template <typename T, bool kSave>
__global__ void __launch_bounds__(kMaxThreads)
bigru_fwd_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                 const T* __restrict__ w_f, const float* __restrict__ b_f,
                 const T* __restrict__ w_b, const float* __restrict__ b_b,
                 T* __restrict__ ys_f, T* __restrict__ ys_b,
                 T* __restrict__ gs_f, T* __restrict__ gs_b,
                 T* __restrict__ hn_f, T* __restrict__ hn_b,
                 int B, int N, int H, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int U = H / C;
  const int G = 3 * H;
  float* w_s = smem;                             // [H][3U] W_hh columns
  float* h_s = smem + pad4(static_cast<size_t>(H) * 3 * U);  // [2][H][R]

  const bool bwd = blockIdx.y == 1;
  const T* xg = bwd ? xg_b : xg_f;
  const T* w = bwd ? w_b : w_f;
  const float* b = bwd ? b_b : b_f;
  const int u = threadIdx.x % U;
  const int r0 = (threadIdx.x / U) * kRowsPerThread;  // first row in tile
  const int gu = rank * U + u;                        // global hidden unit
  const int row0 = (blockIdx.x / C) * R + r0;

  // this block's W_hh columns: c = gate * U + unit, for every k
  for (int idx = threadIdx.x; idx < H * 3 * U; idx += blockDim.x) {
    const int k = idx / (3 * U);
    const int c = idx - k * 3 * U;
    const int gate = c / U;
    w_s[idx] = to_f32<T>(w[static_cast<size_t>(k) * G + gate * H + rank * U +
                           (c - gate * U)]);
  }
  for (int idx = threadIdx.x; idx < H * R; idx += blockDim.x) h_s[idx] = 0.0f;
  const float br = b[gu];
  const float bz = b[H + gu];
  const float bn = b[2 * H + gu];

  bool valid[kRowsPerThread];
  size_t xoff[kRowsPerThread];  // xg / gates of (row, t = 0, unit gu)
  size_t yoff[kRowsPerThread];  // ys / hn of (row, t = 0, unit gu)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    valid[i] = row0 + i < B;
    const size_t row = static_cast<size_t>(valid[i] ? row0 + i : 0);
    xoff[i] = row * N * G + gu;
    yoff[i] = row * N * H + gu;
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

    const float* hb = h_s + (s & 1) * H * R + r0;
    float ar[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    float az[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    float an[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
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
    float* slot = h_s + ((s + 1) & 1) * H * R + gu * R + r0;
    const float4 hv = make_float4(hq[0], hq[1], hq[2], hq[3]);
    for (int q = 0; q < C; ++q)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(slot, q)) = hv;
    cluster.sync();
  }
}

// Dynamic shared memory one block needs, in bytes (the wrapper's
// bigru_smem_bytes("fwd", ...) mirrors it to pick the cluster size).
size_t smem_bytes(int H, int C, int R) {
  const size_t U = static_cast<size_t>(H / C);
  return (pad4(static_cast<size_t>(H) * 3 * U) +
          2 * static_cast<size_t>(H) * R) * sizeof(float);
}

bool valid_plan(int B, int N, int H, int C, int R) {
  return B > 0 && N > 0 && H > 0 && C >= 1 && C <= 8 && H % C == 0 &&
         R > 0 && R % kRowsPerThread == 0 &&
         (H / C) * (R / kRowsPerThread) <= kMaxThreads;
}

// Dynamic shared memory each variant is already allowed on each device, so
// the attribute is set once per device (and again only for a larger size).
constexpr int kMaxDevices = 64;
template <typename T, bool kSave>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T, bool kSave>
cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && g_smem_allowed<T, kSave>[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bigru_fwd_kernel<T, kSave>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<T, kSave>[device].store(smem);
  return err;
}

void make_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B,
                 int H, int C, int R, size_t smem, void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(C * ((B + R - 1) / R), 2, 1);
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

template <typename T, bool kSave>
int launch(const void* xg_f, const void* xg_b, const void* w_f,
           const float* b_f, const void* w_b, const float* b_b, void* ys_f,
           void* ys_b, void* gs_f, void* gs_b, void* hn_f, void* hn_b, int B,
           int N, int H, int C, int R, void* stream) {
  if (!valid_plan(B, N, H, C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H, C, R);
  cudaError_t err = allow_smem<T, kSave>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, B, H, C, R, smem, stream);
  err = cudaLaunchKernelEx(
      &cfg, bigru_fwd_kernel<T, kSave>, static_cast<const T*>(xg_f),
      static_cast<const T*>(xg_b), static_cast<const T*>(w_f), b_f,
      static_cast<const T*>(w_b), b_b, static_cast<T*>(ys_f),
      static_cast<T*>(ys_b), static_cast<T*>(gs_f), static_cast<T*>(gs_b),
      static_cast<T*>(hn_f), static_cast<T*>(hn_b), B, N, H, R);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSave>
int max_active_clusters(int H, int C, int R) {
  const size_t smem = smem_bytes(H, C, R);
  cudaError_t err = allow_smem<T, kSave>(static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  make_config(&cfg, &attr, R, H, C, R, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bigru_fwd_kernel<T, kSave>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device, with clusters of C blocks over batch tiles of R rows (H % C == 0,
// R a multiple of 4). Streams are contiguous float (_f32) or bfloat16
// (_bf16): xg_* [B, N, 3H], w_* [H, 3H] already in the stream type, ys_*
// [B, N, H]; b_* [3H] is float. Returns a cudaError_t code; 0 means the
// launch was accepted.
int bigru_fwd_f32(const void* xg_f, const void* xg_b, const void* w_f,
                  const float* b_f, const void* w_b, const float* b_b,
                  void* ys_f, void* ys_b, int B, int N, int H, int C, int R,
                  void* stream) {
  return launch<float, false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b,
                              nullptr, nullptr, nullptr, nullptr, B, N, H, C,
                              R, stream);
}

int bigru_fwd_bf16(const void* xg_f, const void* xg_b, const void* w_f,
                   const float* b_f, const void* w_b, const float* b_b,
                   void* ys_f, void* ys_b, int B, int N, int H, int C, int R,
                   void* stream) {
  return launch<__nv_bfloat16, false>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,
                                      ys_b, nullptr, nullptr, nullptr,
                                      nullptr, B, N, H, C, R, stream);
}

// As bigru_fwd_*, and also writes the residuals of every step: gs_*
// [B, N, 3H] (activated r, z, n) and hn_* [B, N, H], in the stream type.
int bigru_fwd_train_f32(const void* xg_f, const void* xg_b, const void* w_f,
                        const float* b_f, const void* w_b, const float* b_b,
                        void* ys_f, void* ys_b, void* gs_f, void* gs_b,
                        void* hn_f, void* hn_b, int B, int N, int H, int C,
                        int R, void* stream) {
  return launch<float, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f, ys_b,
                             gs_f, gs_b, hn_f, hn_b, B, N, H, C, R, stream);
}

int bigru_fwd_train_bf16(const void* xg_f, const void* xg_b, const void* w_f,
                         const float* b_f, const void* w_b, const float* b_b,
                         void* ys_f, void* ys_b, void* gs_f, void* gs_b,
                         void* hn_f, void* hn_b, int B, int N, int H, int C,
                         int R, void* stream) {
  return launch<__nv_bfloat16, true>(xg_f, xg_b, w_f, b_f, w_b, b_b, ys_f,
                                     ys_b, gs_f, gs_b, hn_f, hn_b, B, N, H, C,
                                     R, stream);
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

const char* bigru_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
