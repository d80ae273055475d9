// Fused LSTM recurrence, backward (BPTT), float32 or bfloat16 streams. One
// source, two grids: both directions of a BiLSTM layer (bilstm_bwd_*), or one
// direction of an LSTM (lstm_bwd_*, with a reverse flag).
//
// Replaces two TPU kernels: room_slam_tpu/ops/rnn_pallas.py::
// _bilstm_bwd_kernel (:438, pallas_call :606, launched through
// _bilstm_bwd_pallas from _bilstm_core_bwd) with the grid's two directions,
// and _lstm_bwd_chunk_kernel (:242, pallas_call :315, launched through
// _lstm_bwd_pallas from _lstm_core_bwd) with a grid of one direction. From
// the residuals of the training forward (bilstm_fwd.cu, kSave) it walks each
// direction in reverse of its forward order and emits the gate cotangent
// dg [B, N, 4H] per direction, which is also the cotangent of the gate
// stream xg. dW_hh = sum_t h_{t-1}^T dg_t is one matrix product outside the
// kernel, as in the reference.
//
// Per step, with the linearized coefficients of the reference (:459-473)
// computed from the saved activated gates (i, f, g, o), c_t and c_{t-1}
// (c at the walk's next step, zero after its last), and T() the rounding to
// the stream type where the Pallas kernels round (:464-491, :618-620):
//
//   c_c = T(o * (1 - tanh(c)^2))
//   c4  = T([g * i(1-i), c_prev * f(1-f), i * (1-g^2), tanh(c) * o(1-o)])
//   dh_t = dy_t + dh_carry
//   dc_t = dc_carry + dh_t * c_c
//   dg   = [dc_t, dc_t, dc_t, dh_t] * c4            (stored as T)
//   dh_carry = T(dg) @ T(W_hh)^T  (a 4H-deep f32 dot product per unit)
//   dc_carry = dc_t * f                              (f32 carries)
//
// The forward direction walks t = N-1 .. 0; the backward-in-time direction
// (and a single-direction LSTM run with reverse) walks t = 0 .. N-1 and
// takes c_prev from t + 1. All arrays are in original time order.
//
// What bounds it on an H100. At the flagship training shape (B=20,
// N=1500, H=64) it reads 4H + 2H floats and writes 4H floats per (row, step)
// and direction, 154 MB in all (about 46 us at 3.35 TB/s), and does about
// 2 GFLOP (about 30 us at 67 TFLOP/s f32); at the single-direction shape
// (B=32, N=500, H=64) 41 MB (12 us) and 0.54 GFLOP (8 us). The real floor
// is the serial
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int kRows = 4;  // batch rows per block; kRows * H == 4H threads

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

// One step's inputs as loaded, in the stream type. A bf16 step is widened
// at the top of the step that uses it, so no conversion waits on a load in
// flight; a float32 step is copied whole. Both shapes were timed on an H100
// against the alternatives (PERF.md): widening bf16 as it loads, and
// widening float32 through a helper or holding it the bf16 way, were
// slower.
template <typename T>
struct StepIn {
  T i, f, g, o, c, cp, dy;
};

template <typename T>
__global__ void __launch_bounds__(512)
bilstm_bwd_kernel(const T* __restrict__ w_f,
                  const T* __restrict__ w_b,
                  const T* __restrict__ gs_f,
                  const T* __restrict__ cs_f,
                  const T* __restrict__ dy_f,
                  const T* __restrict__ gs_b,
                  const T* __restrict__ cs_b,
                  const T* __restrict__ dy_b,
                  T* __restrict__ dg_f,
                  T* __restrict__ dg_b,
                  int B, int N, int H, int rev) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* wt_s = smem;            // [4H, H]  this direction's W_hh^T
  float* dg_s = wt_s + G * H;    // [2][kRows, 4H]  dg, double-buffered

  // a grid of two directions: y = 1 walks backward; of one: rev says
  const bool bwd = (blockIdx.y == 1) != (rev != 0);
  const T* w = bwd ? w_b : w_f;
  const int row0 = blockIdx.x * kRows;
  const int j = threadIdx.x;

  for (int idx = j; idx < H * G; idx += G) {
    const int k = idx / G;
    wt_s[(idx - k * G) * H + k] = to_f32<T>(w[idx]);
  }

  const int cb = j / H;
  const int cu = j - cb * H;
  const bool valid = row0 + cb < B;
  const size_t row = static_cast<size_t>(valid ? row0 + cb : 0);
  const size_t goff = row * N * G + cu;   // gates / dg of this cell at t = 0
  const size_t coff = row * N * H + cu;   // c, dy of this cell
  const T* gs = (bwd ? gs_b : gs_f) + goff;
  const T* cs = (bwd ? cs_b : cs_f) + coff;
  const T* dy = (bwd ? dy_b : dy_f) + coff;
  T* dg = (bwd ? dg_b : dg_f) + goff;

  // c at the direction's previous step (t - 1 forward, t + 1 backward),
  // read only after the direction's first step
  const int first = bwd ? N - 1 : 0;
  const T* cps = cs + (bwd ? H : -H);
  auto load = [&](int t) {
    StepIn<T> in{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const T* gt = gs + static_cast<size_t>(t) * G;
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
  StepIn<T> nxt = load(bwd ? 0 : N - 1);
  __syncthreads();

  for (int s = 0; s < N; ++s) {
    const int t = bwd ? s : N - 1 - s;
    StepIn<float> cur;
    if constexpr (std::is_same<T, float>::value) {
      cur = nxt;
    } else {
      cur = {to_f32<T>(nxt.i), to_f32<T>(nxt.f), to_f32<T>(nxt.g),
             to_f32<T>(nxt.o), to_f32<T>(nxt.c), to_f32<T>(nxt.cp),
             to_f32<T>(nxt.dy)};
    }
    if (s + 1 < N) nxt = load(bwd ? t + 1 : t - 1);

    const float ci = cur.i, cf = cur.f;
    const float cg = cur.g, co = cur.o;
    const float cc = cur.c, ccp = cur.cp;
    const float tanh_c = tanhf(cc);
    const float dh_t = cur.dy + dh;
    const float dc_t =
        dc + dh_t * round_to<T>(co * (1.0f - tanh_c * tanh_c));
    const float d_i = dc_t * round_to<T>(cg * ci * (1.0f - ci));
    const float d_f = dc_t * round_to<T>(ccp * cf * (1.0f - cf));
    const float d_g = dc_t * round_to<T>(ci * (1.0f - cg * cg));
    const float d_o = dh_t * round_to<T>(tanh_c * co * (1.0f - co));
    dc = dc_t * cf;

    float* buf = dg_s + (s & 1) * (kRows * G) + cb * G;
    buf[cu] = round_to<T>(d_i);
    buf[H + cu] = round_to<T>(d_f);
    buf[2 * H + cu] = round_to<T>(d_g);
    buf[3 * H + cu] = round_to<T>(d_o);
    if (valid) {
      T* out = dg + static_cast<size_t>(t) * G;
      out[0] = from_f32<T>(d_i);
      out[H] = from_f32<T>(d_f);
      out[2 * H] = from_f32<T>(d_g);
      out[3 * H] = from_f32<T>(d_o);
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
template <typename T>
std::atomic<int> g_smem_allowed[kMaxDevices];

template <typename T>
cudaError_t allow_smem(int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && g_smem_allowed<T>[device].load() >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(bilstm_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < kMaxDevices)
    g_smem_allowed<T>[device].store(smem);
  return err;
}

template <typename T>
int launch(const void* w_f, const void* w_b, const void* gs_f,
           const void* cs_f, const void* dy_f, const void* gs_b,
           const void* cs_b, const void* dy_b, void* dg_f, void* dg_b, int B,
           int N, int H, int dirs, int rev, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || 4 * H > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H);
  const cudaError_t err = allow_smem<T>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, dirs);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  bilstm_bwd_kernel<T><<<grid, 4 * H, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      in(w_f), in(w_b), in(gs_f), in(cs_f), in(dy_f), in(gs_b), in(cs_b),
      in(dy_b), out(dg_f), out(dg_b), B, N, H, rev);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device. All tensors are contiguous, in the stream type float (_f32) or
// bfloat16 (_bf16): w_* [H, 4H]; gs_* and dg_* [B, N, 4H]; cs_* and dy_*
// [B, N, H]. Returns a cudaError_t code; 0 means the launch was accepted.
// lstm_bwd_*: one direction of an LSTM, a grid of one direction over w
// [H, 4H], gs and dg [B, N, 4H], cs and dy [B, N, H]; reverse != 0 for a
// direction whose forward walked t = N-1 .. 0.
#define BILSTM_BWD_ENTRIES(SFX, TYPE)                                         \
  int bilstm_bwd_##SFX(const void* w_f, const void* w_b, const void* gs_f,   \
                       const void* cs_f, const void* dy_f, const void* gs_b, \
                       const void* cs_b, const void* dy_b, void* dg_f,       \
                       void* dg_b, int B, int N, int H, void* stream) {      \
    return launch<TYPE>(w_f, w_b, gs_f, cs_f, dy_f, gs_b, cs_b, dy_b, dg_f,  \
                        dg_b, B, N, H, 2, 0, stream);                        \
  }                                                                          \
  int lstm_bwd_##SFX(const void* w, const void* gs, const void* cs,          \
                     const void* dy, void* dg, int B, int N, int H,          \
                     int reverse, void* stream) {                            \
    return launch<TYPE>(w, w, gs, cs, dy, gs, cs, dy, dg, dg, B, N, H, 1,    \
                        reverse, stream);                                    \
  }

BILSTM_BWD_ENTRIES(f32, float)
BILSTM_BWD_ENTRIES(bf16, __nv_bfloat16)
#undef BILSTM_BWD_ENTRIES

const char* bilstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
