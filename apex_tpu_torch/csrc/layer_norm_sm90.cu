// Row LayerNorm forward and backward for Hopper (sm_90a), each row read
// once and held in registers: the route for fp32, bf16 and fp16 x at 1024,
// 2048 and 4096 columns (layer_norm.cu keeps every other width).  fp16
// (amp's half) has entry points of its own, so its launches count apart;
// it takes bf16's instances (8 values a 16-byte vector), and a y or dx
// past fp16's range becomes inf, which nothing clamps.
//
// Replace the TPU kernels apex_tpu/ops/fused_layer_norm.py::_pallas_ln_fwd
// (forward: y in x's dtype, the fp32 mean and invvar the backward keeps;
// body _ln_fwd_kernel) and ::_pallas_ln_bwd (backward: dx in one pass,
// fp32 dgamma/dbeta).  The weight and bias and their gradients are fp32
// (the caller casts weights of another dtype), as on the main paths, where
// the weights are fp32 masters and x is bf16.
//
// What bounds them on an H100: bytes.  At the GPT-1.3B training shape
// (rows = 4 * 2048, cols = 2048, bf16) the forward must move ~67 MB (x in,
// y out: ~0.020 ms at 3.35 TB/s) and the backward ~101 MB (x, dy in, dx
// out: ~0.030 ms), against a handful of flops an element.  So every byte
// is read once and moved as 16-byte vectors:
//
// * A row belongs to W warps (a "group"; W = 1 where a lane's share fits
//   its registers).  Lane l of warp i of the group holds the row's 16-byte
//   vectors (v * W + i) * 32 + l, v < V, so each warp instruction reads or
//   writes 512 contiguous bytes.  The group loads its whole row before any
//   arithmetic, and the next row it owns while it works on this one.
// * The statistics come from registers: warp shuffles, then, for W > 1, a
//   fixed-order sum of the W warps' partials through shared memory under a
//   named barrier of the group's own (the other groups of the block run
//   on).  var = mean((x - mean)^2), as _ln_fwd_kernel computes it, not
//   E[x^2] - mean^2; eps inside the rsqrt.  y and dx leave as packed 16-byte
//   stores.
// * The weight and bias are copied once a block into shared memory, and the
//   block walks a fixed set of rows (8 / W groups, each taking every
//   (8 / W)-th row of the block's span).
// * The backward keeps each lane's dgamma/dbeta sums over the rows its
//   group owns in registers (16 columns a lane: two accumulators each, so
//   a lane holds 16 values of x and 16 of dy, W = cols / 512), adds the
//   block's groups in group order in shared memory, and writes one partial
//   per block of 32 rows.  A second kernel sums each column's partials over
//   many blocks (32 columns a block, eight strided slices of the partials
//   then the slices in order).  Nothing uses atomics, and every sum runs in
//   an order fixed by rows and cols (and the instance, which dtype and cols
//   pick), never by the SM count or the schedule: two runs agree bit for
//   bit.  Rows past the end of a ragged last block are never read, so their
//   statistics cannot reach dgamma.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdSteps = 4;           // forward: rows a group walks per block
constexpr int kBwdRowsPerBlock = 32;   // backward: rows per dgamma/dbeta partial
constexpr int kBwdLaneCols = 16;       // backward: columns a lane accumulates
constexpr int kColsPerBlock = 32;      // second pass: columns a block sums
constexpr int kSlices = kThreads / kColsPerBlock;

// 16 bytes of T widened to fp32, and fp32 narrowed (round to nearest even)
// back into 16 bytes of T.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 narrow(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

template <>
struct Pack<__half> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& v, float* f) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 narrow(const float* f) {
    uint4 v;
    __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// N consecutive fp32 values from 16-byte aligned shared memory.
template <int N>
__device__ __forceinline__ void load_shared(const float* src, float* dst) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 t = s4[q];
    dst[4 * q] = t.x;
    dst[4 * q + 1] = t.y;
    dst[4 * q + 2] = t.z;
    dst[4 * q + 3] = t.w;
  }
}

// The group's barrier: barrier 1 + g over its W warps (0 is __syncthreads).
__device__ __forceinline__ void group_barrier(int g, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(threads) : "memory");
}

// Sums of K values over the group's W warps, warps in order.  red holds
// two buffers of [kWarps][K]; a group alternates between them, so a warp
// that runs ahead to the next sum never overwrites one that a slower warp
// of its group still reads (it passes the group's barrier only after every
// warp has read the previous buffer).
template <int W, int K>
__device__ __forceinline__ void group_sum(float (&v)[K], float* red, int& buf, int g,
                                          int wi) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if constexpr (W > 1) {
    float* r = red + buf * kWarps * K;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) r[(g * W + wi) * K + k] = v[k];
    }
    group_barrier(g, W * 32);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) t += r[(g * W + i) * K + k];
      v[k] = t;
    }
    buf ^= 1;
  }
}

// One group a row, V 16-byte vectors a lane, W warps a row; a block takes
// kFwdSteps rows a group.  Dynamic shared memory: w, b [cols] fp32.
template <typename T, int V, int W>
__global__ void __launch_bounds__(kThreads, 2)
    ln_fwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mean,
                float* __restrict__ invvar, int rows, float eps) {
  using P = Pack<T>;
  constexpr int G = kWarps / W, C = V * W * 32 * P::N;
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);
  float* bs = ws + C;
  __shared__ float red[2 * kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / W, wi = warp % W;
  const int r0 = blockIdx.x * G * kFwdSteps;
  const int rend = min(rows, r0 + G * kFwdSteps);
  int row = r0 + g;
  uint4 xv[V];
  if (row < rend) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * C);
#pragma unroll
    for (int v = 0; v < V; ++v) xv[v] = __ldg(xr + (v * W + wi) * 32 + lane);
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    ws[c] = w != nullptr ? w[c] : 1.f;
    bs[c] = b != nullptr ? b[c] : 0.f;
  }
  __syncthreads();
  int buf = 0;
  for (; row < rend; row += G) {
    uint4 xn[V];
    if (row + G < rend) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row + G) * C);
#pragma unroll
      for (int v = 0; v < V; ++v) xn[v] = __ldg(xr + (v * W + wi) * 32 + lane);
    }
    float f[P::N];
    float s[1] = {0.f};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      P::widen(xv[v], f);
#pragma unroll
      for (int u = 0; u < P::N; ++u) s[0] += f[u];
    }
    group_sum<W>(s, red, buf, g, wi);
    const float mu = s[0] / C;
    float ss[1] = {0.f};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      P::widen(xv[v], f);
#pragma unroll
      for (int u = 0; u < P::N; ++u) {
        const float d = f[u] - mu;
        ss[0] += d * d;
      }
    }
    group_sum<W>(ss, red, buf, g, wi);
    const float rs = rsqrtf(ss[0] / C + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<int64_t>(row) * C);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = (v * W + wi) * 32 + lane;
      float wf[P::N], bf[P::N];
      load_shared<P::N>(ws + j * P::N, wf);
      load_shared<P::N>(bs + j * P::N, bf);
      P::widen(xv[v], f);
#pragma unroll
      for (int u = 0; u < P::N; ++u) f[u] = (f[u] - mu) * rs * wf[u] + bf[u];
      yr[j] = P::narrow(f);
    }
    if (wi == 0 && lane == 0) {
      mean[row] = mu;
      invvar[row] = rs;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) xv[v] = xn[v];
  }
}

// dx of kBwdRowsPerBlock rows (one group a row, c1 = mean(g w) and c2 =
// mean(g w xhat) in one pass over the registers), and this block's
// dgamma/dbeta partial of every column.  Dynamic shared memory: w [cols]
// during the rows, then the groups' sums [G][2][cols].
template <typename T, int V, int W>
__global__ void __launch_bounds__(kThreads, 2)
    ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ mean, const float* __restrict__ invvar,
                const float* __restrict__ w, T* __restrict__ dx, float* __restrict__ part_w,
                float* __restrict__ part_b, int rows) {
  using P = Pack<T>;
  constexpr int N = P::N, G = kWarps / W, C = V * W * 32 * N, E = V * N;
  static_assert(E == kBwdLaneCols, "a lane accumulates kBwdLaneCols columns");
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);
  float* sums = ws;  // reused once the rows are done
  __shared__ float red[2 * kWarps * 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / W, wi = warp % W;
  const int r0 = blockIdx.x * kBwdRowsPerBlock;
  const int rend = min(rows, r0 + kBwdRowsPerBlock);
  int row = r0 + g;
  uint4 xv[V], gv[V];
  float mu = 0.f, rs = 0.f;
  if (row < rend) {
    const int64_t off = static_cast<int64_t>(row) * C;
    const uint4* xr = reinterpret_cast<const uint4*>(x + off);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + off);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xv[v] = __ldg(xr + (v * W + wi) * 32 + lane);
      gv[v] = __ldg(gr + (v * W + wi) * 32 + lane);
    }
    mu = __ldg(mean + row);
    rs = __ldg(invvar + row);
  }
  for (int c = threadIdx.x; c < C; c += kThreads) ws[c] = w != nullptr ? w[c] : 1.f;
  __syncthreads();
  float aw[E], ab[E];
#pragma unroll
  for (int e = 0; e < E; ++e) aw[e] = ab[e] = 0.f;
  int buf = 0;
  for (; row < rend; row += G) {
    uint4 xn[V], gn[V];
    float mu_n = 0.f, rs_n = 0.f;
    if (row + G < rend) {
      const int64_t off = static_cast<int64_t>(row + G) * C;
      const uint4* xr = reinterpret_cast<const uint4*>(x + off);
      const uint4* gr = reinterpret_cast<const uint4*>(dy + off);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        xn[v] = __ldg(xr + (v * W + wi) * 32 + lane);
        gn[v] = __ldg(gr + (v * W + wi) * 32 + lane);
      }
      mu_n = __ldg(mean + row + G);
      rs_n = __ldg(invvar + row + G);
    }
    float xf[N], gf[N], wf[N];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = (v * W + wi) * 32 + lane;
      P::widen(xv[v], xf);
      P::widen(gv[v], gf);
      load_shared<N>(ws + j * N, wf);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const float xhat = (xf[u] - mu) * rs;
        const float gw = gf[u] * wf[u];
        s[0] += gw;
        s[1] += gw * xhat;
        aw[v * N + u] += gf[u] * xhat;
        ab[v * N + u] += gf[u];
      }
    }
    group_sum<W>(s, red, buf, g, wi);
    const float c1 = s[0] / C, c2 = s[1] / C;
    uint4* dr = reinterpret_cast<uint4*>(dx + static_cast<int64_t>(row) * C);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int j = (v * W + wi) * 32 + lane;
      P::widen(xv[v], xf);
      P::widen(gv[v], gf);
      load_shared<N>(ws + j * N, wf);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const float xhat = (xf[u] - mu) * rs;
        const float gw = gf[u] * wf[u];
        xf[u] = (gw - c1 - xhat * c2) * rs;
      }
      dr[j] = P::narrow(xf);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xv[v] = xn[v];
      gv[v] = gn[v];
    }
    mu = mu_n;
    rs = rs_n;
  }
  if (part_w == nullptr && part_b == nullptr) return;  // the whole block
  __syncthreads();  // every group is past its rows: ws may be overwritten
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = (v * W + wi) * 32 + lane;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      sums[(2 * g) * C + j * N + u] = aw[v * N + u];
      sums[(2 * g + 1) * C + j * N + u] = ab[v * N + u];
    }
  }
  __syncthreads();
  const int64_t pbase = static_cast<int64_t>(blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      sw += sums[(2 * i) * C + c];
      sb += sums[(2 * i + 1) * C + c];
    }
    if (part_w != nullptr) part_w[pbase + c] = sw;
    if (part_b != nullptr) part_b[pbase + c] = sb;
  }
}

// Each column's partials summed: block (x, y) takes columns [32 x, 32 x +
// 32) of dweight (y = 0) or dbias (y = 1); slice s of its threads sums
// partials s, s + 8, s + 16, ... in order, then slice 0 adds the eight
// slices in order.
__global__ void __launch_bounds__(kThreads)
    ln_bwd_cols(const float* __restrict__ part, float* __restrict__ dw,
                float* __restrict__ db, int n_parts, int cols) {
  float* out = blockIdx.y == 0 ? dw : db;
  if (out == nullptr) return;  // the whole block
  const float* src = part + static_cast<int64_t>(blockIdx.y) * n_parts * cols;
  __shared__ float slices[kSlices][kColsPerBlock];
  const int lane = threadIdx.x % kColsPerBlock, slice = threadIdx.x / kColsPerBlock;
  const int c = blockIdx.x * kColsPerBlock + lane;
  float a = 0.f;
  if (c < cols) {
#pragma unroll 8
    for (int p = slice; p < n_parts; p += kSlices) a += src[static_cast<int64_t>(p) * cols + c];
  }
  slices[slice][lane] = a;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kSlices; ++i) t += slices[i][lane];
    out[c] = t;
  }
}

template <typename T, int V, int W>
cudaError_t launch_fwd(const void* x, const float* w, const float* b, void* y, float* mean,
                       float* invvar, int rows, float eps, cudaStream_t st) {
  constexpr int G = kWarps / W, C = V * W * 32 * Pack<T>::N;
  const int grid = (rows + G * kFwdSteps - 1) / (G * kFwdSteps);
  ln_fwd_rows<T, V, W><<<grid, kThreads, 2 * C * sizeof(float), st>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), mean, invvar, rows, eps);
  return cudaGetLastError();
}

template <typename T, int V, int W>
cudaError_t launch_bwd(const void* x, const void* dy, const float* mean, const float* invvar,
                       const float* w, void* dx, float* dw, float* db, float* part, int rows,
                       cudaStream_t st) {
  constexpr int G = kWarps / W, C = V * W * 32 * Pack<T>::N;
  const int n_parts = (rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  float* part_w = dw != nullptr ? part : nullptr;
  float* part_b = db != nullptr ? part + static_cast<int64_t>(n_parts) * C : nullptr;
  const size_t smem = 2 * G * C * sizeof(float);  // 32 KB: [G][2][cols] covers w [cols]
  ln_bwd_rows<T, V, W><<<n_parts, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, invvar, w, static_cast<T*>(dx),
      part_w, part_b, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (dw == nullptr && db == nullptr)) return err;
  const dim3 grid((C + kColsPerBlock - 1) / kColsPerBlock, 2);
  ln_bwd_cols<<<grid, kThreads, 0, st>>>(part, dw, db, n_parts, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; cols 1024, 2048 or 4096.  x, y [rows,
// cols] contiguous and 16-byte aligned; w, b fp32 [cols] or null; mean,
// invvar fp32 [rows].  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a dtype or width it has no instance of).
int layer_norm_fwd_sm90(int dtype, int device, const void* x, const float* w, const float* b,
                        void* y, float* mean, float* invvar, int rows, int cols, float eps,
                        void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (cols == 1024) return launch_fwd<__nv_bfloat16, 4, 1>(x, w, b, y, mean, invvar, rows, eps, st);
    if (cols == 2048) return launch_fwd<__nv_bfloat16, 8, 1>(x, w, b, y, mean, invvar, rows, eps, st);
    if (cols == 4096) return launch_fwd<__nv_bfloat16, 8, 2>(x, w, b, y, mean, invvar, rows, eps, st);
  } else if (dtype == 0) {
    if (cols == 1024) return launch_fwd<float, 8, 1>(x, w, b, y, mean, invvar, rows, eps, st);
    if (cols == 2048) return launch_fwd<float, 8, 2>(x, w, b, y, mean, invvar, rows, eps, st);
    if (cols == 4096) return launch_fwd<float, 8, 4>(x, w, b, y, mean, invvar, rows, eps, st);
  }
  return cudaErrorInvalidValue;
}

// The same forward on fp16 x and y (dtype must be 2).
int layer_norm_fwd_sm90_f16(int dtype, int device, const void* x, const float* w,
                            const float* b, void* y, float* mean, float* invvar, int rows,
                            int cols, float eps, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (dtype != 2) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols == 1024) return launch_fwd<__half, 4, 1>(x, w, b, y, mean, invvar, rows, eps, st);
  if (cols == 2048) return launch_fwd<__half, 8, 1>(x, w, b, y, mean, invvar, rows, eps, st);
  if (cols == 4096) return launch_fwd<__half, 8, 2>(x, w, b, y, mean, invvar, rows, eps, st);
  return cudaErrorInvalidValue;
}

// dx like x; dw, db fp32 [cols] or null (then w, b had none); w fp32 or
// null; part: fp32 workspace of 2 * ceil(rows / 32) * cols.  Launches the
// row pass and the column pass in order on `stream`; returns the first
// launch error.
int layer_norm_bwd_sm90(int dtype, int device, const void* x, const void* dy,
                        const float* mean, const float* invvar, const float* w, void* dx,
                        float* dw, float* db, float* part, int rows, int cols, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (cols == 1024)
      return launch_bwd<__nv_bfloat16, 2, 2>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
    if (cols == 2048)
      return launch_bwd<__nv_bfloat16, 2, 4>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
    if (cols == 4096)
      return launch_bwd<__nv_bfloat16, 2, 8>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
  } else if (dtype == 0) {
    if (cols == 1024)
      return launch_bwd<float, 4, 2>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
    if (cols == 2048)
      return launch_bwd<float, 4, 4>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
    if (cols == 4096)
      return launch_bwd<float, 4, 8>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
  }
  return cudaErrorInvalidValue;
}

// The same backward on fp16 x, dy and dx (dtype must be 2).
int layer_norm_bwd_sm90_f16(int dtype, int device, const void* x, const void* dy,
                            const float* mean, const float* invvar, const float* w, void* dx,
                            float* dw, float* db, float* part, int rows, int cols,
                            void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (dtype != 2) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols == 1024)
    return launch_bwd<__half, 2, 2>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
  if (cols == 2048)
    return launch_bwd<__half, 2, 4>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
  if (cols == 4096)
    return launch_bwd<__half, 2, 8>(x, dy, mean, invvar, w, dx, dw, db, part, rows, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
