// Row LayerNorm forward and backward for GPT training (sm_90a): the route
// for the widths layer_norm_sm90.cu has no instance of (every width but
// 1024, 2048 and 4096 columns).
//
// Replace the TPU kernels apex_tpu/ops/fused_layer_norm.py::_pallas_ln_fwd
// (forward: y, and the fp32 mean and invvar the backward keeps) and
// ::_pallas_ln_bwd (backward: dx in one pass, dgamma/dbeta as per-block
// partials plus a second, ordered reduction: the part1/part2 structure of
// the reference's cuda_layer_norm_gradient).  x, y, dy, dx are [rows, cols]
// in x's dtype (fp32 or bf16); the statistics, the weight and bias, and
// their gradients are fp32 (the caller casts weights of another dtype), as
// on the main path, where the weights are fp32 masters and x is bf16.
//
// What bounds them on an H100: bytes.  At the GPT-1.3B training shape
// (rows = 4 * 2048, cols = 2048, bf16) the forward must move ~67 MB (x in,
// y out, two fp32 stats out: ~0.02 ms at 3.35 TB/s) and the backward ~100
// MB (x, dy in, dx out: ~0.03 ms), against a handful of flops per element.
// The design keeps every reduction in fp32 registers with warp shuffles
// (one warp per row, 16-byte vector loads); a row is re-read from L1/L2
// rather than held whole in registers, which keeps any cols legal.  The
// variance is mean((x - mean)^2), as _ln_fwd_kernel computes it, not
// E[x^2] - mean^2.  Nothing uses atomics: each dgamma/dbeta column is
// summed in one fixed order, first over a block's 32 rows, then over the
// blocks, so two runs give bitwise-equal results.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;  // backward: rows per dgamma/dbeta partial

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mean,
                  float* __restrict__ invvar, int rows, int cols, float eps) {
  constexpr int U = 16 / sizeof(T);
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<int64_t>(row) * cols;
  float buf[U];
  float s = 0.f;
  for (int c = lane * U; c < cols; c += 32 * U) {
    apex::load16(xr + c, buf);
#pragma unroll
    for (int u = 0; u < U; ++u) s += buf[u];
  }
  const float mu = warp_sum(s) / cols;
  float ss = 0.f;
  for (int c = lane * U; c < cols; c += 32 * U) {
    apex::load16(xr + c, buf);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float d = buf[u] - mu;
      ss += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(ss) / cols + eps);
  T* yr = y + static_cast<int64_t>(row) * cols;
  for (int c = lane * U; c < cols; c += 32 * U) {
    apex::load16(xr + c, buf);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v = (buf[u] - mu) * rs;
      if (w != nullptr) v = v * w[c + u];
      if (b != nullptr) v = v + b[c + u];
      apex::store(yr + c + u, v);
    }
  }
  if (lane == 0) {
    mean[row] = mu;
    invvar[row] = rs;
  }
}

// Part 1: dx of 32 rows (one warp per row, c1 = mean(g w) and c2 =
// mean(g w xhat) in one pass), then this block's dgamma/dbeta partial of
// every column (one thread per column, the 32 rows in order).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ mean, const float* __restrict__ invvar,
                  const float* __restrict__ w, T* __restrict__ dx, float* __restrict__ part_w,
                  float* __restrict__ part_b, int rows, int cols) {
  constexpr int U = 16 / sizeof(T);
  __shared__ float mu_s[kRowsPerBlock], rs_s[kRowsPerBlock];
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, rows - r0);
  if (threadIdx.x < nrows) {
    mu_s[threadIdx.x] = mean[r0 + threadIdx.x];
    rs_s[threadIdx.x] = invvar[r0 + threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float xb[U], gb[U];
  for (int i = warp; i < nrows; i += kWarps) {
    const int64_t off = static_cast<int64_t>(r0 + i) * cols;
    const float mu = mu_s[i], rs = rs_s[i];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * U; c < cols; c += 32 * U) {
      apex::load16(x + off + c, xb);
      apex::load16(dy + off + c, gb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float gw = w != nullptr ? gb[u] * w[c + u] : gb[u];
        s1 += gw;
        s2 += gw * ((xb[u] - mu) * rs);
      }
    }
    const float c1 = warp_sum(s1) / cols, c2 = warp_sum(s2) / cols;
    for (int c = lane * U; c < cols; c += 32 * U) {
      apex::load16(x + off + c, xb);
      apex::load16(dy + off + c, gb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float gw = w != nullptr ? gb[u] * w[c + u] : gb[u];
        const float xhat = (xb[u] - mu) * rs;
        apex::store(dx + off + c + u, (gw - c1 - xhat * c2) * rs);
      }
    }
  }

  if (part_w == nullptr && part_b == nullptr) return;
  const int64_t pbase = static_cast<int64_t>(blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float aw = 0.f, ab = 0.f;
    for (int i = 0; i < nrows; ++i) {
      const int64_t off = static_cast<int64_t>(r0 + i) * cols + c;
      const float g = apex::to_float(dy[off]);
      aw += g * ((apex::to_float(x[off]) - mu_s[i]) * rs_s[i]);
      ab += g;
    }
    if (part_w != nullptr) part_w[pbase + c] = aw;
    if (part_b != nullptr) part_b[pbase + c] = ab;
  }
}

// Part 2: each column's partials summed over the blocks in order.
__global__ void __launch_bounds__(kThreads)
    ln_bwd_reduce_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                         float* __restrict__ dw, float* __restrict__ db, int n_parts, int cols) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  float aw = 0.f, ab = 0.f;
  for (int p = 0; p < n_parts; ++p) {
    const int64_t off = static_cast<int64_t>(p) * cols + c;
    if (dw != nullptr) aw += part_w[off];
    if (db != nullptr) ab += part_b[off];
  }
  if (dw != nullptr) dw[c] = aw;
  if (db != nullptr) db[c] = ab;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y [rows, cols] contiguous, cols a
// multiple of 16 bytes; w, b fp32 [cols] or null; mean, invvar fp32
// [rows].  Returns cudaGetLastError() after the launch.
int layer_norm_fwd(int dtype, int device, const void* x, const float* w, const float* b,
                   void* y, float* mean, float* invvar, int rows, int cols, float eps,
                   void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (rows + kWarps - 1) / kWarps;
  if (dtype == 0)
    ln_fwd_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), w, b, static_cast<float*>(y), mean, invvar, rows, cols, eps);
  else if (dtype == 1)
    ln_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), w, b, static_cast<__nv_bfloat16*>(y), mean, invvar, rows, cols, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// dx like x; dw, db fp32 [cols] or null (then w, b had none); w fp32 or
// null; part: fp32 workspace of 2 * ceil(rows / 32) * cols.  Launches the
// two parts in order on `stream`; returns the first launch error.
int layer_norm_bwd(int dtype, int device, const void* x, const void* dy, const float* mean,
                   const float* invvar, const float* w, void* dx, float* dw, float* db,
                   float* part, int rows, int cols, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parts = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  float* part_w = dw != nullptr ? part : nullptr;
  float* part_b = db != nullptr ? part + static_cast<int64_t>(n_parts) * cols : nullptr;
  if (dtype == 0)
    ln_bwd_kernel<float><<<n_parts, kThreads, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(dy), mean, invvar, w, static_cast<float*>(dx), part_w, part_b, rows, cols);
  else if (dtype == 1)
    ln_bwd_kernel<__nv_bfloat16><<<n_parts, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), mean, invvar, w, static_cast<__nv_bfloat16*>(dx), part_w, part_b, rows, cols);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (dw == nullptr && db == nullptr)) return err;
  ln_bwd_reduce_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, 0, st>>>(part_w, part_b, dw, db, n_parts, cols);
  return cudaGetLastError();
}

}  // extern "C"
