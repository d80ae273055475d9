// Fused bidirectional LSTM recurrence, forward, float32: the inference
// (light) variant and the training variant that also saves residuals.
//
// Replaces the TPU kernel room_slam_tpu/ops/rnn_pallas.py::_bilstm_fwd_kernel
// (launched through _bilstm_fwd_pallas and bilstm_recurrence_pallas), both
// its light pallas_call and its save_residuals one. For one BiLSTM layer,
// both directions:
//
//   g_t = xg_t + h_{t-1} @ W_hh          (gate order i, f, g, o)
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
//
// The training variant (kSave) also stores, per direction, c_t [B, N, H]
// and the activated gates (sigmoid i, sigmoid f, tanh g, sigmoid o)
// [B, N, 4H] of every step: the residuals the backward kernel
// (bilstm_bwd.cu) reads.
//
// The forward direction walks t = 0 .. N-1 over xg_f; the backward
// direction walks t = N-1 .. 0 over xg_b (given in original time order), so
// no flipped copies are made and every output comes back in original time
// order. Every step of the padded window runs; there is no mask, as in the
// reference.
//
// What bounds it on an H100. At the bench shape (B=32, N=500, H=64) the
// light kernel reads 32.8 MB of xg and writes 8.2 MB of ys (about 12 us at
// 3.35 TB/s) and does about 1.07 GFLOP (about 16 us at 67 TFLOP/s f32); the
// training variant writes 41 MB more residuals (about 12 us more). Neither
// is the real floor: the recurrence is a chain of N dependent steps, each a
// 64-deep dot product per gate column, a barrier, the cell update and a
// second barrier, so the time is N times the latency of one step (expected
// near a millisecond at N=500).
//
// What the design does about it. One block per (batch tile of kRows rows,
// direction); each direction's W_hh (64 x 256 f32 = 64 KiB at H=64) stays
// resident in dynamic shared memory for the whole walk, as do the h carry
// and the step's gate pre-activations; the c carry lives in a register of
// the thread that owns the (row, unit) cell. Thread j owns gate column j,
// so W_hh reads are conflict-free and h reads are broadcasts. Next step's
// xg is prefetched into registers before this step's dot products, so the
// global-memory latency sits off the serial chain. The residual stores are
// fire-and-forget and sit off the chain too. Everything else (wgmma, TMA,
// more rows per block, splitting a step across a cluster) is left for
// later work.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int kRows = 4;  // batch rows per block; kRows * H == 4H threads

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kSave>
__global__ void __launch_bounds__(512)
bilstm_fwd_kernel(const float* __restrict__ xg_f,
                  const float* __restrict__ xg_b,
                  const float* __restrict__ w_f,
                  const float* __restrict__ w_b,
                  float* __restrict__ ys_f,
                  float* __restrict__ ys_b,
                  float* __restrict__ cs_f,
                  float* __restrict__ cs_b,
                  float* __restrict__ gs_f,
                  float* __restrict__ gs_b,
                  int B, int N, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* w_s = smem;            // [H, 4H]  this direction's W_hh
  float* g_s = w_s + H * G;     // [kRows, 4H]  gate pre-activations
  float* h_s = g_s + kRows * G; // [kRows, H]  h carry

  const bool bwd = blockIdx.y == 1;
  const float* xg = bwd ? xg_b : xg_f;
  const float* w = bwd ? w_b : w_f;
  float* ys = bwd ? ys_b : ys_f;
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;  // gate column, 0 .. 4H-1

  for (int idx = j; idx < H * G; idx += G) w_s[idx] = w[idx];
  for (int idx = j; idx < kRows * H; idx += G) h_s[idx] = 0.0f;

  // The (row, unit) cell this thread updates; its c carry is a register.
  const int cb = j / H;
  const int cu = j - cb * H;
  const bool cell_valid = row0 + cb < B;
  const size_t cell_row = static_cast<size_t>(cell_valid ? row0 + cb : 0);
  float c = 0.0f;

  const size_t row_stride = static_cast<size_t>(N) * G;
  bool valid[kRows];
  const float* xrow[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    valid[b] = row0 + b < B;
    xrow[b] = xg + static_cast<size_t>(valid[b] ? row0 + b : 0) * row_stride +
              j;
  }
  float* yrow = ys + cell_row * N * H + cu;
  float* crow = nullptr;
  float* grow = nullptr;
  if (kSave) {
    crow = (bwd ? cs_b : cs_f) + cell_row * N * H + cu;
    grow = (bwd ? gs_b : gs_f) + cell_row * row_stride + cu;
  }

  float xnext[kRows];
  {
    const int t0 = bwd ? N - 1 : 0;
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      xnext[b] = valid[b] ? xrow[b][static_cast<size_t>(t0) * G] : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? N - 1 - s : s;
    float acc[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[b] = xnext[b];
    if (s + 1 < N) {
      const size_t tn = static_cast<size_t>(bwd ? t - 1 : t + 1) * G;
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        xnext[b] = valid[b] ? xrow[b][tn] : 0.0f;
    }

#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float wk = w_s[k * G + j];
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        acc[b] = fmaf(h_s[b * H + k], wk, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < kRows; ++b) g_s[b * G + j] = acc[b];
    __syncthreads();

    const float* gr = g_s + cb * G;
    const float ig = sigmoid_f(gr[cu]);
    const float fg = sigmoid_f(gr[H + cu]);
    const float gg = tanhf(gr[2 * H + cu]);
    const float og = sigmoid_f(gr[3 * H + cu]);
    c = fg * c + ig * gg;
    const float h = og * tanhf(c);
    h_s[cb * H + cu] = h;
    if (cell_valid) {
      yrow[static_cast<size_t>(t) * H] = h;
      if (kSave) {
        crow[static_cast<size_t>(t) * H] = c;
        float* gt = grow + static_cast<size_t>(t) * G;
        gt[0] = ig;
        gt[H] = fg;
        gt[2 * H] = gg;
        gt[3 * H] = og;
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory one block needs at hidden size H, in bytes (the
// wrapper's bilstm_smem_bytes mirrors it to refuse an H that cannot fit).
size_t smem_bytes(int H) {
  const size_t G = 4 * static_cast<size_t>(H);
  return (static_cast<size_t>(H) * G + kRows * G +
          kRows * static_cast<size_t>(H)) * sizeof(float);
}

// Dynamic shared memory each variant is already allowed on each device, so
// the attribute is set once per device (and again only for a larger H).
constexpr int kMaxDevices = 64;
template <bool kSave>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <bool kSave>
cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && g_smem_allowed<kSave>[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bilstm_fwd_kernel<kSave>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<kSave>[device].store(smem);
  return err;
}

template <bool kSave>
int launch(const float* xg_f, const float* xg_b, const float* w_f,
           const float* w_b, float* ys_f, float* ys_b, float* cs_f,
           float* cs_b, float* gs_f, float* gs_b, int B, int N, int H,
           void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || 4 * H > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H);
  const cudaError_t err = allow_smem<kSave>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, 2);
  bilstm_fwd_kernel<kSave>
      <<<grid, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
          xg_f, xg_b, w_f, w_b, ys_f, ys_b, cs_f, cs_b, gs_f, gs_b, B, N, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device. All tensors are contiguous float32: xg_* [B, N, 4H],
// w_* [H, 4H], ys_* [B, N, H]. Returns a cudaError_t code; 0 means the
// launch was accepted.
int bilstm_fwd_f32(const float* xg_f, const float* xg_b, const float* w_f,
                   const float* w_b, float* ys_f, float* ys_b, int B, int N,
                   int H, void* stream) {
  return launch<false>(xg_f, xg_b, w_f, w_b, ys_f, ys_b, nullptr, nullptr,
                       nullptr, nullptr, B, N, H, stream);
}

// As bilstm_fwd_f32, and also writes the residuals of every step:
// cs_* [B, N, H] (c_t) and gs_* [B, N, 4H] (activated i, f, g, o).
int bilstm_fwd_train_f32(const float* xg_f, const float* xg_b,
                         const float* w_f, const float* w_b, float* ys_f,
                         float* ys_b, float* cs_f, float* cs_b, float* gs_f,
                         float* gs_b, int B, int N, int H, void* stream) {
  return launch<true>(xg_f, xg_b, w_f, w_b, ys_f, ys_b, cs_f, cs_b, gs_f,
                      gs_b, B, N, H, stream);
}

const char* bilstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
