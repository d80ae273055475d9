// Exact linear-sum assignment (the Hungarian algorithm) on the card, one
// problem a block: the matcher of the set criterion, the validation metrics
// and the legacy loss.
//
// Replaces the JAX package's on-device matcher, room_slam_tpu/ops/
// hungarian.py::solve_square (:30) and solve_rect (:150), reached through
// hungarian_match (:108, the square form), hungarian_match_batch (:143) and
// hungarian_match_fast (:227, the transposed rectangular form). Those run as
// lax loops vmapped over the batch; none of them is a Pallas kernel. Before
// this kernel the port copied each batch's cost to the host and called
// scipy, a device-to-host round trip on every training step.
//
// The algorithm is the textbook shortest augmenting path with row and
// column potentials u, v, 1-indexed with a virtual column 0. Row i is
// inserted by a Dijkstra walk over the columns: each step relaxes the free
// columns with row i0 = p[j0],
//
//   cur_j = (cost[i0 - 1][j - 1] - u[i0]) - v[j]
//   if cur_j < minv_j: minv_j = cur_j, way[j] = j0
//
// takes the free column j1 of least minv (ties to the lowest index, as
// jnp.argmin breaks them), and moves the potentials by delta = minv_j1:
// u[p[j]] += delta and v[j] -= delta on the used columns (column 0 too),
// minv_j -= delta on the others. The walk ends at a column with no row, and
// the path is unwound through way[]. Each float expression keeps the JAX
// module's order (two subtractions left to right, one add or subtract a
// potential), and nvcc contracts no subtraction into an FMA, so the
// potentials, and with them every choice among ties, come out as the JAX
// module's on the CPU.
//
// One block solves one problem of n rows and m columns (n <= m): B blocks
// for a batch. Thread j owns column j, the virtual column 0 included, so a
// block has m + 1 threads rounded up to a warp, at most 1024 (m <= 1023;
// the models have m = 30-80). Its v_j, minv_j and used flag live in its
// registers; u (by row), p (the row of each column) and way live in shared
// memory, where every thread reads u[i0] and p[j0] and one thread walks the
// path. The argmin of a step is a shuffle reduction of (value, index) pairs
// in each warp, then across the warps' results. A step costs two block
// barriers; an insertion runs one step per column it reaches.
//
// n_rows[b] (optional, on the device) limits the insertion to the first
// n_rows[b] rows, as solve_rect's traced n_rows does: the kernel reads it
// itself, so no count returns to the host. Outputs: row_for_col[b][j] =
// p[j + 1] - 1 (the square solver's answer; -1 for a column with no row)
// and col_for_row[b][i] (the rectangular solver's; -1 for a row not
// inserted).
//
// What bounds it on an H100. The work is a chain of dependent steps, each a
// block-wide argmin: about 1-2 us a step. The bytes (the cost once, the
// outputs once) are a few hundred KB at the scale-up batch: far below that.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
constexpr int kMaxThreads = 1024;

// (value, index) pair of least value, ties to the lower index.
__device__ __forceinline__ void arg_less(float& val, int& idx, float ov,
                                         int oi) {
  if (ov < val || (ov == val && oi < idx)) {
    val = ov;
    idx = oi;
  }
}

__device__ __forceinline__ void warp_argmin(float& val, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, val, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    arg_less(val, idx, ov, oi);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    hungarian_kernel(const float* __restrict__ cost,
                     const int* __restrict__ n_rows, int n, int m,
                     int* __restrict__ row_for_col,
                     int* __restrict__ col_for_row) {
  extern __shared__ int smem[];
  int* p = smem;                                  // [m + 1]
  int* way = p + (m + 1);                         // [m + 1]
  float* u = reinterpret_cast<float*>(way + (m + 1));   // [n + 1]
  __shared__ float red_val[32];
  __shared__ int red_idx[32];
  __shared__ int s_j1;
  __shared__ float s_delta;

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool col = j <= m;
  const float* C = cost + static_cast<size_t>(b) * n * m;

  for (int r = j; r <= n; r += blockDim.x) u[r] = 0.f;
  if (col) {
    p[j] = 0;
    way[j] = 0;
  }
  float v = 0.f;
  int rows = n;
  if (n_rows != nullptr) rows = min(max(n_rows[b], 0), n);
  __syncthreads();

  for (int i = 1; i <= rows; ++i) {
    float minv = kInf;
    bool used = false;
    if (j == 0) p[0] = i;
    __syncthreads();
    int j0 = 0;
    while (p[j0] != 0) {
      const int i0 = p[j0];
      const float ui0 = u[i0];
      if (j == j0) used = true;
      float masked = kInf;
      if (col && j >= 1 && !used) {
        const float cur =
            __fsub_rn(__fsub_rn(C[static_cast<size_t>(i0 - 1) * m + (j - 1)],
                                ui0),
                      v);
        if (cur < minv) {
          minv = cur;
          way[j] = j0;
        }
        masked = minv;
      }
      float val = masked;
      int idx = j;
      warp_argmin(val, idx);
      if (lane == 0) {
        red_val[warp] = val;
        red_idx[warp] = idx;
      }
      __syncthreads();
      if (warp == 0) {
        val = lane < n_warps ? red_val[lane] : kInf;
        idx = lane < n_warps ? red_idx[lane] : kMaxThreads + lane;
        warp_argmin(val, idx);
        if (lane == 0) {
          s_j1 = idx;
          s_delta = val;
        }
      }
      __syncthreads();
      const int j1 = s_j1;
      const float delta = s_delta;
      if (col) {
        if (used) {
          // p[j] differ over the used columns: one add per row
          u[p[j]] = __fadd_rn(u[p[j]], delta);
          v = __fsub_rn(v, delta);
        } else {
          minv = __fsub_rn(minv, delta);
        }
      }
      j0 = j1;
      __syncthreads();
    }
    if (j == 0) {
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  if (j >= 1 && col) row_for_col[static_cast<size_t>(b) * m + j - 1] =
      p[j] - 1;
  for (int r = j; r < n; r += blockDim.x)
    col_for_row[static_cast<size_t>(b) * n + r] = -1;
  __syncthreads();
  if (j >= 1 && col && p[j] >= 1)
    col_for_row[static_cast<size_t>(b) * n + p[j] - 1] = j - 1;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block at n rows, m columns, in bytes.
int hungarian_smem_bytes(int n, int m) {
  return static_cast<int>(2 * (m + 1) * sizeof(int) + (n + 1) * sizeof(float));
}

// Threads a block at m columns (m + 1 rounded up to a warp); -1 above 1023
// columns.
int hungarian_threads(int m) {
  const int t = (m + 1 + 31) / 32 * 32;
  return t > kMaxThreads ? -1 : t;
}

// Launch on `stream` (a cudaStream_t) of the calling thread's current
// device. cost [B, n, m] float32, contiguous, n <= m <= 1023; n_rows [B]
// int32 or null (every row); row_for_col [B, m] and col_for_row [B, n]
// int32. Returns a cudaError_t code; 0 means the launch was accepted.
int hungarian_solve(const void* cost, const void* n_rows, void* row_for_col,
                    void* col_for_row, int B, int n, int m, void* stream) {
  const int threads = hungarian_threads(m);
  if (B < 0 || n < 0 || n > m || threads < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = static_cast<size_t>(hungarian_smem_bytes(n, m));
  hungarian_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_rows), n, m,
      static_cast<int*>(row_for_col), static_cast<int*>(col_for_row));
  return static_cast<int>(cudaGetLastError());
}

const char* hungarian_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
