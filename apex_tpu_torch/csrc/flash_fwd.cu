// Flash attention forward for the serving prefill (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_fwd_pallas
// (the "varlen" and "stream_skip" routes the prefill takes, with
// segment ids and a causal mask): softmax(q k^T * scale + masks) v and
// the fp32 log-sum-exp of every row.
//
// What bounds it on an H100: at the prefill shape (bh = 16, s = 1024,
// d = 128, bf16) the kernel must move ~17 MB (q, k, v read once, o
// written once: ~5 us at 3.35 TB/s) and do ~4 GFLOP on the live causal
// tiles (~4 us at the 989 TFLOP/s bf16 tensor-core rate), so a kernel at
// the roof would be bound by both about equally.  This first version is
// bound by neither: it multiplies with scalar fp32 FMAs out of shared
// memory (no mma/wgmma, no TMA), which caps it well below the tensor-core
// rate.  What the design does instead is keep the work small: each block
// takes its k-range from the segment ids before touching K/V (the
// _segment_block_bounds rule: a 64-column tile whose segment-id interval
// cannot meet the q-block's is never loaded) and cuts it at the causal
// limit, so padding and cross-segment tiles cost nothing; the S x S score
// matrix never leaves shared memory; loads are 16-byte vectors.
//
// Layout: one block of 128 threads per (64-row q-block, batch*head); q,
// k, v, o are [B, H, s, d] with any strides whose last one is 1 (the
// prefill hands in strided views of the fused qkv projection, and o is
// written straight into the [B, s, H, d] order the output projection
// reads).  Segment ids are [rows, s] int32, row = bh / seg_div, so a
// per-batch id row serves every head without being repeated.  The TPU
// kernel's 8-row lse slab ([bh, n_qb, 8, block_q]) is a Mosaic layout
// choice and is not copied: lse is a plain [bh, sq] fp32 array.

#include <climits>

#include "flash_tile.cuh"

namespace {

using flash::kBK;
using flash::kThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, int seg_div, int H, int sq, int sk,
                     int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                     int64_t kss, int64_t osb, int64_t osh, int64_t oss, float scale,
                     int causal) {
  constexpr int RM = 4;
  using TL = flash::Tile<D, RM>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KPs = Qs + TL::BQ * TL::QS;
  float* Vs = KPs + TL::KP;
  __shared__ int64_t col_off[kBK];
  __shared__ int seg_tile[kBK];
  __shared__ int q_lo, q_hi, kb_lo, kb_hi;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TL::BQ;
  const int nrows = min(TL::BQ, sq - q0);
  const int n_kb = (sk + kBK - 1) / kBK;
  const bool has_seg = seg_q != nullptr;
  const int* sq_row = has_seg ? seg_q + static_cast<int64_t>(bh / seg_div) * sq : nullptr;
  const int* sk_row = has_seg ? seg_k + static_cast<int64_t>(bh / seg_div) * sk : nullptr;

  flash::load_q<D, RM>(Qs, q + b * qsb + h * qsh + q0 * qss, qss, nrows);

  // the block-skip range: k-tiles whose [min, max] segment interval meets
  // the q-block's (a tile outside it has no equal pair and is skipped)
  if (tid == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    if (has_seg) {
      for (int r = 0; r < nrows; ++r) {
        lo = min(lo, sq_row[q0 + r]);
        hi = max(hi, sq_row[q0 + r]);
      }
    }
    q_lo = lo;
    q_hi = hi;
    kb_lo = has_seg ? n_kb : 0;
    kb_hi = has_seg ? 0 : n_kb;
  }
  __syncthreads();
  if (has_seg) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int kb = warp; kb < n_kb; kb += kThreads / 32) {
      int kmin = INT_MAX, kmax = INT_MIN;
      for (int c = kb * kBK + lane; c < min(sk, (kb + 1) * kBK); c += 32) {
        kmin = min(kmin, sk_row[c]);
        kmax = max(kmax, sk_row[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
      }
      // integer min/max: the result does not depend on arrival order
      if (lane == 0 && q_lo <= kmax && kmin <= q_hi) {
        atomicMin(&kb_lo, kb);
        atomicMax(&kb_hi, kb + 1);
      }
    }
  }
  __syncthreads();
  int lo = kb_lo, hi = kb_hi;
  if (causal) {
    const int last = q0 + nrows - 1 + (sk - sq);  // last visible column
    hi = min(hi, last >= 0 ? last / kBK + 1 : 0);
  }

  const int ty = tid >> 3;
  int my_seg[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    my_seg[i] = (has_seg && r < nrows) ? sq_row[q0 + r] : 0;
  }

  flash::Acc<D, RM> acc;
  acc.init();
  const T* kbase = k + b * ksb + h * ksh;
  const T* vbase = v + b * ksb + h * ksh;
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * kBK;
    const int ncols = min(kBK, sk - k0);
    if (tid < kBK) {
      col_off[tid] = tid < ncols ? static_cast<int64_t>(k0 + tid) * kss : -1;
      seg_tile[tid] = (has_seg && tid < ncols) ? sk_row[k0 + tid] : 0;
    }
    __syncthreads();
    flash::load_kv<D, RM>(KPs, Vs, kbase, vbase, col_off);
    __syncthreads();
    flash::attend_tile<D, RM>(acc, Qs, KPs, Vs, scale, [&](int i, int j) {
      const int row = q0 + ty * RM + i, col = k0 + j;
      return j < ncols && (!has_seg || my_seg[i] == seg_tile[j]) &&
             (!causal || row + (sk - sq) >= col);
    });
  }
  flash::finish<D, RM>(acc, o + b * osb + h * osh + q0 * oss, oss, nrows,
                       lse + static_cast<int64_t>(bh) * sq + q0);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* seg_q, const int* seg_k, int seg_div, int B, int H, int sq,
                   int sk, const int64_t* st, float scale, int causal, cudaStream_t stream) {
  using TL = flash::Tile<D, 4>;
  const cudaError_t attr = flash::allow_smem(flash_fwd_kernel<T, D>, TL::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sq + TL::BQ - 1) / TL::BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, TL::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seg_q, seg_k, seg_div, H, sq, sk, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                       const int* seg_q, const int* seg_k, int seg_div, int B, int H, int sq,
                       int sk, const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: q (b, h, s), k and v
// (b, h, s), o (b, h, s), in elements.  seg_q/seg_k may be null (no
// segments).  Returns cudaGetLastError() after the launch.
int flash_fwd(int dtype, int d, int device, const void* q, const void* k, const void* v,
              void* o, float* lse, const int* seg_q, const int* seg_k, int seg_div, int B,
              int H, int sq, int sk, const int64_t* strides, float scale, int causal,
              void* stream) {
  const flash::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (sq <= 0 || B * H <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, strides, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, strides, scale, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
