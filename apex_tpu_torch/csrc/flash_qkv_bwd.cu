// Packed-QKV self-attention backward for GPT training (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_qkv_bwd_pallas:
// from (qkv, dctx, ctx, lse) it writes dqkv [b, s, H * 3 * d] in the same
// Megatron-interleaved layout as qkv, so the projection's backward reads it
// with no transpose.  Per (row r, column c) of a visible tile:
//   p  = exp(q.k * scale - lse[r])                    (undropped)
//   dp = dctx[r] . v[c]
//   with dropout: p~ = keep ? p / (1 - rate) : 0, dp~ = keep ? dp / (1 - rate) : 0
//   dv[c] += p~ dctx[r];  ds = p (dp~ - delta[r]) scale;  dk[c] += ds q[r];  dq[r] += ds k[c]
// with delta[r] = dctx[r] . ctx[r] and the keep bits redrawn from the
// forward's counter hash at the same global (row, col).
//
// What bounds it on an H100: at the GPT-1.3B training shape (b = 4, s =
// 2048, 16 heads of 128, bf16, causal) it moves ~168 MB (qkv, dctx, ctx,
// lse read once, dqkv written once: ~0.05 ms) and does ~2.5x the
// forward's operations (~172 GFLOP on the causal half with the scores
// recomputed in both passes below: ~0.17 ms at 989 TFLOP/s), so at the
// roof it is bound by operations.  This first version uses scalar fp32
// FMAs out of shared memory and is far from that.
//
// Design: deterministic without atomics.  The TPU sums dq serially inside
// one program; blocks on Hopper run in no order, so the work is split by
// what each block owns:
//   1. delta: one warp per row, rowsum(dctx * ctx) in fp32 into a [b*H, s]
//      workspace;
//   2. dk/dv: one 256-thread block per (64-column k-tile, batch*head) walks
//      the q-tiles at and below the causal diagonal in order, recomputing p
//      and dp, and owns the dk and dv of its columns;
//   3. dq: one 256-thread block per (64-row q-tile, batch*head) walks the
//      k-tiles up to the diagonal in order, recomputing p and dp again, and
//      owns the dq of its rows.
// Every output element is summed by one thread in one fixed order, so two
// runs give bitwise-equal gradients.  Thread t owns tile rows 2*(t/8) and
// 2*(t/8)+1 and columns t%8 + 8j: the 16 scores it recomputes, and the 2 x
// 16 output elements (columns t%8 + 8jj of head dim 128) it accumulates.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kB = 64;  // rows of a q-tile, columns of a k-tile

template <int D>
struct BwdTile {
  static constexpr int RS = D + 1;   // padded row stride of a [64, D] tile
  static constexpr int PS = kB + 1;  // padded row stride of a [64, 64] tile
  static constexpr int kTileFloats = kB * RS;
};

// rows [0, nrows) of a [rows, D] strided source into a padded fp32 tile;
// rows past nrows read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t row_stride,
                                          int nrows) {
  constexpr int U = 16 / sizeof(T);
  constexpr int CH = D / U;
  for (int idx = threadIdx.x; idx < kB * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * U;
    float buf[U];
    if (r < nrows) {
      apex::load16(src + r * row_stride + c, buf);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) buf[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) dst[r * BwdTile<D>::RS + c + u] = buf[u];
  }
}

// s[i][j] = a[ty*2+i] . b[tx+8j] over D, for a/b padded [64, D] tiles.
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[2][8], const float* a, const float* b) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[2], y[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) x[i] = a[(ty * 2 + i) * BwdTile<D>::RS + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = b[(tx + 8 * j) * BwdTile<D>::RS + c];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

struct Params {
  int H, s, causal;
  float scale;
  uint32_t seed, thresh;
  float inv_keep;  // 1 / (1 - rate)
  const int* seg_q;
  const int* seg_k;
  int seg_div;
};

// Of one score, given q.k and dctx.v: the p that multiplies dctx into dv
// (dropped and rescaled) and ds; both are 0 where the pair is masked.
__device__ __forceinline__ void score_grads(const Params& P, int bh, int row, int col,
                                            float qk, float dov, float lse, float delta,
                                            bool live, bool drop, float* p_drop, float* ds) {
  float p = 0.f;
  if (live && lse > kNegInf / 2) p = expf(qk * P.scale - lse);
  float pd = p, dp = dov;
  if (drop) {
    const bool keep = apex::dropout_keep(P.seed, bh, row, col, P.thresh);
    pd = keep ? p * P.inv_keep : 0.f;
    dp = keep ? dov * P.inv_keep : 0.f;
  }
  *p_drop = pd;
  *ds = p * (dp - delta) * P.scale;
}

__device__ __forceinline__ bool visible(const Params& P, int bh, int row, int col) {
  if (row >= P.s || col >= P.s) return false;
  if (P.causal && row < col) return false;
  if (P.seg_q != nullptr) {
    const int64_t srow = static_cast<int64_t>(bh / P.seg_div) * P.s;
    return P.seg_q[srow + row] == P.seg_k[srow + col];
  }
  return true;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ dctx, const T* __restrict__ ctx, float* __restrict__ delta,
                 int H, int s, int rows) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int bh = warp / s, r = warp % s, b = bh / H, h = bh % H;
  const int64_t off = (static_cast<int64_t>(b) * s + r) * H * D + static_cast<int64_t>(h) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(apex::to_float(dctx[off + c]), apex::to_float(ctx[off + c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[warp] = acc;
}

// dk and dv of one 64-column k-tile of one batch*head.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dqkv, Params P) {
  using BT = BwdTile<D>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT::kTileFloats;
  float* Qs = Vs + BT::kTileFloats;
  float* dOs = Qs + BT::kTileFloats;
  float* Ps = dOs + BT::kTileFloats;
  float* dSs = Ps + kB * BT::PS;
  __shared__ float lse_s[kB], delta_s[kB];

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, b = bh / P.H, h = bh % P.H;
  const int k0 = blockIdx.x * kB;
  const int ncols = min(kB, P.s - k0);
  const int64_t row = static_cast<int64_t>(P.H) * 3 * D, crow = static_cast<int64_t>(P.H) * D;
  const T* base = qkv + static_cast<int64_t>(b) * P.s * row + h * 3 * D;
  const T* dbase = dctx + static_cast<int64_t>(b) * P.s * crow + h * D;

  load_rows<T, D>(Ks, base + k0 * row + D, row, ncols);
  load_rows<T, D>(Vs, base + k0 * row + 2 * D, row, ncols);

  float dk[2][D / 8], dv[2][D / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int n_qb = (P.s + kB - 1) / kB;
  for (int qb = P.causal ? k0 / kB : 0; qb < n_qb; ++qb) {
    const int q0 = qb * kB, nrows = min(kB, P.s - q0);
    load_rows<T, D>(Qs, base + q0 * row, row, nrows);
    load_rows<T, D>(dOs, dbase + q0 * crow, crow, nrows);
    if (tid < kB) {
      lse_s[tid] = tid < nrows ? lse[static_cast<int64_t>(bh) * P.s + q0 + tid] : kNegInf;
      delta_s[tid] = tid < nrows ? delta[static_cast<int64_t>(bh) * P.s + q0 + tid] : 0.f;
    }
    __syncthreads();
    float qk[2][8], dov[2][8];
    tile_dots<D>(qk, Qs, Ks);
    tile_dots<D>(dov, dOs, Vs);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        float pd, ds;
        score_grads(P, bh, q0 + r, k0 + c, qk[i][j], dov[i][j], lse_s[r], delta_s[r],
                    visible(P, bh, q0 + r, k0 + c), DROP, &pd, &ds);
        Ps[r * BT::PS + c] = pd;
        dSs[r * BT::PS + c] = ds;
      }
    }
    __syncthreads();
    // dv[c] += sum_r p~[r][c] dctx[r];  dk[c] += sum_r ds[r][c] q[r]
#pragma unroll 2
    for (int r = 0; r < kB; ++r) {
      float pc[2], sc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pc[i] = Ps[r * BT::PS + ty * 2 + i];
        sc[i] = dSs[r * BT::PS + ty * 2 + i];
      }
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const float o = dOs[r * BT::RS + tx + 8 * jj], qv = Qs[r * BT::RS + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dv[i][jj] = fmaf(pc[i], o, dv[i][jj]);
          dk[i][jj] = fmaf(sc[i], qv, dk[i][jj]);
        }
      }
    }
    __syncthreads();  // before the next q-tile overwrites Qs, dOs, Ps, dSs
  }

  T* out = dqkv + static_cast<int64_t>(b) * P.s * row + h * 3 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = ty * 2 + i;
    if (c >= ncols) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      apex::store(out + (k0 + c) * row + D + tx + 8 * jj, dk[i][jj]);
      apex::store(out + (k0 + c) * row + 2 * D + tx + 8 * jj, dv[i][jj]);
    }
  }
}

// dq of one 64-row q-tile of one batch*head.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dqkv, Params P) {
  using BT = BwdTile<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT::kTileFloats;
  float* Ks = dOs + BT::kTileFloats;
  float* Vs = Ks + BT::kTileFloats;
  float* dSs = Vs + BT::kTileFloats;
  __shared__ float lse_s[kB], delta_s[kB];

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, b = bh / P.H, h = bh % P.H;
  const int q0 = blockIdx.x * kB;
  const int nrows = min(kB, P.s - q0);
  const int64_t row = static_cast<int64_t>(P.H) * 3 * D, crow = static_cast<int64_t>(P.H) * D;
  const T* base = qkv + static_cast<int64_t>(b) * P.s * row + h * 3 * D;

  load_rows<T, D>(Qs, base + q0 * row, row, nrows);
  load_rows<T, D>(dOs, dctx + static_cast<int64_t>(b) * P.s * crow + h * D + q0 * crow, crow,
                  nrows);
  if (tid < kB) {
    lse_s[tid] = tid < nrows ? lse[static_cast<int64_t>(bh) * P.s + q0 + tid] : kNegInf;
    delta_s[tid] = tid < nrows ? delta[static_cast<int64_t>(bh) * P.s + q0 + tid] : 0.f;
  }

  float dq[2][D / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) dq[i][jj] = 0.f;

  const int n_kb = (P.s + kB - 1) / kB;
  const int kb_end = P.causal ? min(n_kb, (q0 + nrows - 1) / kB + 1) : n_kb;
  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kB, ncols = min(kB, P.s - k0);
    load_rows<T, D>(Ks, base + k0 * row + D, row, ncols);
    load_rows<T, D>(Vs, base + k0 * row + 2 * D, row, ncols);
    __syncthreads();
    float qk[2][8], dov[2][8];
    tile_dots<D>(qk, Qs, Ks);
    tile_dots<D>(dov, dOs, Vs);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        float pd, ds;
        score_grads(P, bh, q0 + r, k0 + c, qk[i][j], dov[i][j], lse_s[r], delta_s[r],
                    visible(P, bh, q0 + r, k0 + c), DROP, &pd, &ds);
        dSs[r * BT::PS + c] = ds;
      }
    }
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]
#pragma unroll 2
    for (int c = 0; c < kB; ++c) {
      float sr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) sr[i] = dSs[(ty * 2 + i) * BT::PS + c];
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const float kv = Ks[c * BT::RS + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 2; ++i) dq[i][jj] = fmaf(sr[i], kv, dq[i][jj]);
      }
    }
    __syncthreads();  // before the next k-tile overwrites Ks, Vs, dSs
  }

  T* out = dqkv + static_cast<int64_t>(b) * P.s * row + h * 3 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) apex::store(out + (q0 + r) * row + tx + 8 * jj, dq[i][jj]);
  }
}

template <typename T, int D, bool DROP>
cudaError_t launch(const void* qkv, const void* dctx, const void* ctx, const float* lse,
                   float* delta, void* dqkv, int B, const Params& P, cudaStream_t stream) {
  using BT = BwdTile<D>;
  const int rows = B * P.H * P.s;
  delta_kernel<T, D><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      static_cast<const T*>(dctx), static_cast<const T*>(ctx), delta, P.H, P.s, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_b = (P.s + kB - 1) / kB;
  const size_t kv_smem = sizeof(float) * (4 * BT::kTileFloats + 2 * kB * BT::PS);
  err = apex::allow_smem(dkdv_kernel<T, D, DROP>, kv_smem);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, D, DROP><<<dim3(n_b, B * P.H), kThreads, kv_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dctx), lse, delta, static_cast<T*>(dqkv),
      P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t q_smem = sizeof(float) * (4 * BT::kTileFloats + kB * BT::PS);
  err = apex::allow_smem(dq_kernel<T, D, DROP>, q_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<T, D, DROP><<<dim3(n_b, B * P.H), kThreads, q_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dctx), lse, delta, static_cast<T*>(dqkv),
      P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool drop, const void* qkv, const void* dctx, const void* ctx,
                     const float* lse, float* delta, void* dqkv, int B, const Params& P,
                     cudaStream_t stream) {
  if (drop) return launch<T, 128, true>(qkv, dctx, ctx, lse, delta, dqkv, B, P, stream);
  return launch<T, 128, false>(qkv, dctx, ctx, lse, delta, dqkv, B, P, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d: head dim (128).  qkv/dqkv [B, s,
// H*3*d], ctx/dctx [B, s, H*d] (all contiguous), lse and the delta
// workspace [B*H, s] fp32.  seg_q/seg_k may be null; seg row = (b*H + h) /
// seg_div.  thresh = round(rate * 2^32) and inv_keep = 1 / (1 - rate)
// (thresh 0 and inv_keep 1: no dropout).  Launches three kernels in order
// on `stream`; returns the first launch error, or cudaSuccess.
int flash_qkv_bwd(int dtype, int d, int device, const void* qkv, const void* dctx,
                  const void* ctx, const float* lse, float* delta, void* dqkv,
                  const int* seg_q, const int* seg_k, int seg_div, int B, int H, int s,
                  float scale, int causal, uint32_t seed, uint32_t thresh, float inv_keep,
                  void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (s <= 0 || B * H <= 0) return cudaSuccess;
  if (d != 128) return cudaErrorInvalidValue;
  const Params P{H, s, causal, scale, seed, thresh, inv_keep, seg_q, seg_k, seg_div};
  const bool drop = !(thresh == 0 && inv_keep == 1.f);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(drop, qkv, dctx, ctx, lse, delta, dqkv, B, P, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(drop, qkv, dctx, ctx, lse, delta, dqkv, B, P, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
