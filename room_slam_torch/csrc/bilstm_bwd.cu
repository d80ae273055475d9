// Fused bidirectional LSTM recurrence, backward (BPTT), float32.
//
// Replaces the TPU kernel room_slam_tpu/ops/rnn_pallas.py::_bilstm_bwd_kernel
// (launched through _bilstm_bwd_pallas from _bilstm_core_bwd). From the
// residuals of the training forward (bilstm_fwd.cu, kSave) it walks both
// directions of one BiLSTM layer in reverse of their forward order and
// emits the gate cotangent dg [B, N, 4H] per direction, which is also the
// cotangent of the gate stream xg. dW_hh = sum_t h_{t-1}^T dg_t is one
// matrix product outside the kernel, as in the reference.
//
// Per step, with the linearized coefficients of the reference (:459-473)
// computed from the saved activated gates (i, f, g, o), c_t and c_{t-1}
// (c at the walk's next step, zero after its last):
//
//   c_c = o * (1 - tanh(c)^2)
//   c4  = [g * i(1-i), c_prev * f(1-f), i * (1-g^2), tanh(c) * o(1-o)]
//   dh_t = dy_t + dh_carry
//   dc_t = dc_carry + dh_t * c_c
//   dg   = [dc_t, dc_t, dc_t, dh_t] * c4
//   dh_carry = dg @ W_hh^T        (a 4H-deep dot product per unit)
//   dc_carry = dc_t * f
//
// The forward direction walks t = N-1 .. 0; the backward-in-time direction
// walks t = 0 .. N-1. All arrays are in original time order.
//
// What bounds it on an H100. At the flagship training shape (B=20,
// N=1500, H=64) it reads 4H + 2H floats and writes 4H floats per (row, step)
// and direction, 154 MB in all (about 46 us at 3.35 TB/s), and does about
// 2 GFLOP (about 30 us at 67 TFLOP/s f32). The real floor is the serial
// chain of N dependent steps, each a 256-deep dot product and a barrier.
//
// What the design does about it. One block per (batch tile of kRows rows,
// direction), 4H threads; thread j owns the (row, unit) cell (j / H, j % H)
// and keeps that cell's dh and dc carries in registers, since the dot
// product for dh_carry[row, unit] is its own. W_hh^T (256 x 64 f32 = 64 KiB
// at H=64) is transposed once into dynamic shared memory and stays there for
// the whole walk, so the dot product's W reads are conflict-free and its dg
// reads are broadcasts. dg goes through a double-buffered shared tile, so
// each step needs one barrier. The next step's gates, c, c_{t-1} and dy are
// prefetched into registers before this step's dot product, every load
// independent of earlier steps. c_{t-1} is read through a second pointer
// into cs, shifted by one step, at the same index as c and dy: each c is read
// twice and the second read hits the cache (measured faster on an H100 than
// a separate c_prev array, a guarded read at t +- 1, or taking it from the
// next step's prefetch). The coefficients are computed beside the chain, so
// no extra pass over the residuals is made.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int kRows = 4;  // batch rows per block; kRows * H == 4H threads

struct StepIn {
  float i, f, g, o, c, cp, dy;
};

__global__ void __launch_bounds__(512)
bilstm_bwd_kernel(const float* __restrict__ w_f,
                  const float* __restrict__ w_b,
                  const float* __restrict__ gs_f,
                  const float* __restrict__ cs_f,
                  const float* __restrict__ dy_f,
                  const float* __restrict__ gs_b,
                  const float* __restrict__ cs_b,
                  const float* __restrict__ dy_b,
                  float* __restrict__ dg_f,
                  float* __restrict__ dg_b,
                  int B, int N, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* wt_s = smem;            // [4H, H]  this direction's W_hh^T
  float* dg_s = wt_s + G * H;    // [2][kRows, 4H]  dg, double-buffered

  const bool bwd = blockIdx.y == 1;
  const float* w = bwd ? w_b : w_f;
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;

  for (int idx = j; idx < H * G; idx += G) {
    const int k = idx / G;
    wt_s[(idx - k * G) * H + k] = w[idx];
  }

  const int cb = j / H;
  const int cu = j - cb * H;
  const bool valid = row0 + cb < B;
  const size_t row = static_cast<size_t>(valid ? row0 + cb : 0);
  const size_t goff = row * N * G + cu;   // gates / dg of this cell at t = 0
  const size_t coff = row * N * H + cu;   // c, dy of this cell
  const float* gs = (bwd ? gs_b : gs_f) + goff;
  const float* cs = (bwd ? cs_b : cs_f) + coff;
  const float* dy = (bwd ? dy_b : dy_f) + coff;
  float* dg = (bwd ? dg_b : dg_f) + goff;

  // c at the direction's previous step (t - 1 forward, t + 1 backward),
  // read only after the direction's first step
  const int first = bwd ? N - 1 : 0;
  const float* cps = cs + (bwd ? H : -H);
  auto load = [&](int t) {
    StepIn in{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const float* gt = gs + static_cast<size_t>(t) * G;
      const size_t tc = static_cast<size_t>(t) * H;
      in.i = gt[0];
      in.f = gt[H];
      in.g = gt[2 * H];
      in.o = gt[3 * H];
      in.c = cs[tc];
      if (t != first) in.cp = cps[tc];
      in.dy = dy[tc];
    }
    return in;
  };

  float dh = 0.0f;
  float dc = 0.0f;
  StepIn nxt = load(bwd ? 0 : N - 1);
  __syncthreads();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? s : N - 1 - s;
    const StepIn cur = nxt;
    if (s + 1 < N) nxt = load(bwd ? t + 1 : t - 1);

    const float tanh_c = tanhf(cur.c);
    const float dh_t = cur.dy + dh;
    const float dc_t = dc + dh_t * (cur.o * (1.0f - tanh_c * tanh_c));
    const float d_i = dc_t * (cur.g * cur.i * (1.0f - cur.i));
    const float d_f = dc_t * (cur.cp * cur.f * (1.0f - cur.f));
    const float d_g = dc_t * (cur.i * (1.0f - cur.g * cur.g));
    const float d_o = dh_t * (tanh_c * cur.o * (1.0f - cur.o));
    dc = dc_t * cur.f;

    float* buf = dg_s + (s & 1) * (kRows * G) + cb * G;
    buf[cu] = d_i;
    buf[H + cu] = d_f;
    buf[2 * H + cu] = d_g;
    buf[3 * H + cu] = d_o;
    if (valid) {
      float* out = dg + static_cast<size_t>(t) * G;
      out[0] = d_i;
      out[H] = d_f;
      out[2 * H] = d_g;
      out[3 * H] = d_o;
    }
    __syncthreads();

    // dh_carry = dg_row . W_hh^T[:, cu]; four partial sums for ILP
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int q = 0; q < G; q += 4) {
      a0 = fmaf(buf[q], wt_s[q * H + cu], a0);
      a1 = fmaf(buf[q + 1], wt_s[(q + 1) * H + cu], a1);
      a2 = fmaf(buf[q + 2], wt_s[(q + 2) * H + cu], a2);
      a3 = fmaf(buf[q + 3], wt_s[(q + 3) * H + cu], a3);
    }
    dh = (a0 + a1) + (a2 + a3);
  }
}

// Dynamic shared memory one block needs at hidden size H, in bytes (the
// wrapper's bilstm_bwd_smem_bytes mirrors it).
size_t smem_bytes(int H) {
  const size_t G = 4 * static_cast<size_t>(H);
  return (G * static_cast<size_t>(H) + 2 * kRows * G) * sizeof(float);
}

constexpr int kMaxDevices = 64;
std::atomic<int> g_smem_allowed[kMaxDevices];

cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && g_smem_allowed[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bilstm_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed[device].store(smem);
  return err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device. All tensors are contiguous float32: w_* [H, 4H]; gs_* and dg_*
// [B, N, 4H]; cs_* and dy_* [B, N, H]. Returns a cudaError_t code; 0 means
// the launch was accepted.
int bilstm_bwd_f32(const float* w_f, const float* w_b, const float* gs_f,
                   const float* cs_f, const float* dy_f, const float* gs_b,
                   const float* cs_b, const float* dy_b, float* dg_f,
                   float* dg_b, int B, int N, int H, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || 4 * H > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H);
  const cudaError_t err = allow_smem(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, 2);
  bilstm_bwd_kernel<<<grid, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b, dg_f, dg_b, B, N, H);
  return static_cast<int>(cudaGetLastError());
}

const char* bilstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
