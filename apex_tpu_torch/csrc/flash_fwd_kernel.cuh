// The flash-attention forward block, shared by flash_fwd.cu (generic
// attention, K1: the serving prefill and the multi-head attention modules)
// and flash_qkv_fwd.cu (packed self-attention for training, K3):
// softmax(q k^T * scale + mask_bias + masks) v and the fp32 log-sum-exp of
// every row, with optional attention dropout.
//
// One block of 128 threads per (64-row q-block, batch*head) walks 64-column
// k-tiles in order with an fp32 online softmax (flash_tile.cuh).  q, k, v,
// o are [B, H, s, d] with any strides whose last one is 1.  Segment ids are
// [rows, s] int32, row = bh / seg_div, so a per-batch id row serves every
// head without being repeated.  Before touching K/V each block takes its
// k-range from the segment ids (the _segment_block_bounds rule: a 64-column
// tile whose segment-id interval cannot meet the q-block's is never
// loaded) and cuts it at the causal limit.  lse is a plain [bh, sq] fp32
// array; the TPU kernels' 8-row lse slab is a Mosaic layout and is not
// copied.
//
// Additive mask (MASK): fp32, read as a [B, H, sq, sk] view through four
// strides that may be 0, so a [b, 1, 1, sk] key-padding mask or a
// [1, 1, sq, sk] attention mask is never materialised per head.  It is
// added to the scaled score before the segment and causal masks, as the
// JAX package's _apply_masks orders them.
//
// Dropout (DROP): the keep bit of score (row, col) of batch-head bh comes
// from the JAX package's counter hash at GLOBAL coordinates
// (common.cuh::dropout_keep), so the backward redraws the same bits.  As on
// the TPU (_make_fwd_kernel_qkv), p enters the running sum l before it is
// dropped, so lse counts every visible column, and a kept p is divided by
// keep_prob = 1 - rate before it multiplies V.
//
// MASK and DROP are template flags: the instance without either (the
// serving prefill's) carries no code for them.

#pragma once

#include <climits>

#include "flash_tile.cuh"

namespace {

using flash::kBK;
using flash::kThreads;

template <typename T, int D, bool DROP, bool MASK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ mask, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, int seg_div, int H, int sq, int sk,
                     int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                     int64_t kss, int64_t osb, int64_t osh, int64_t oss, int64_t msb,
                     int64_t msh, int64_t msq, int64_t msk, float scale, int causal,
                     uint32_t seed, uint32_t thresh, float keep_prob) {
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
  const float* mbase = MASK ? mask + b * msb + h * msh : nullptr;
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
    const auto live = [&](int i, int j) {
      const int row = q0 + ty * RM + i, col = k0 + j;
      return j < ncols && (!has_seg || my_seg[i] == seg_tile[j]) &&
             (!causal || row + (sk - sq) >= col);
    };
    // the additive mask of a visible pair (row < sq: a padding row of the
    // last q-block reads nothing)
    const auto bias = [&](int i, int j, float x) {
      const int row = q0 + ty * RM + i;
      return row < sq ? x + mbase[row * msq + (k0 + j) * msk] : x;
    };
    const auto drop = [&](int i, int j, float p) {
      const bool keep = apex::dropout_keep(seed, bh, q0 + ty * RM + i, k0 + j, thresh);
      return keep ? p / keep_prob : 0.f;
    };
    if constexpr (DROP && MASK) {
      flash::attend_tile<D, RM>(acc, Qs, KPs, Vs, scale, live, drop, bias);
    } else if constexpr (DROP) {
      flash::attend_tile<D, RM>(acc, Qs, KPs, Vs, scale, live, drop);
    } else if constexpr (MASK) {
      flash::attend_tile<D, RM>(acc, Qs, KPs, Vs, scale, live, flash::NoDrop(), bias);
    } else {
      flash::attend_tile<D, RM>(acc, Qs, KPs, Vs, scale, live);
    }
  }
  flash::finish<D, RM>(acc, o + b * osb + h * osh + q0 * oss, oss, nrows,
                       lse + static_cast<int64_t>(bh) * sq + q0);
}

// What a launch of the forward block needs; pointers are untyped, the
// instance casts them.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const float* mask;  // null: no additive mask
  const int* seg_q;   // null: no segments
  const int* seg_k;
  int seg_div;
  int B, H, sq, sk;
  // strides in elements: q, k/v and o of (b, h, s); mask of (b, h, row, col)
  int64_t q_st[3], kv_st[3], o_st[3], m_st[4];
  float scale;
  int causal;
  uint32_t seed, thresh;  // dropout; thresh 0 with keep_prob 1: none
  float keep_prob;
};

// Launch one instance on `stream`.  Returns cudaGetLastError() after the
// launch.
template <typename T, int D, bool DROP, bool MASK>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  using TL = flash::Tile<D, 4>;
  const cudaError_t attr = flash::allow_smem(flash_fwd_kernel<T, D, DROP, MASK>, TL::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.sq + TL::BQ - 1) / TL::BQ, a.B * a.H);
  flash_fwd_kernel<T, D, DROP, MASK><<<grid, kThreads, TL::kSmemBytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.mask, a.seg_q, a.seg_k, a.seg_div, a.H, a.sq, a.sk,
      a.q_st[0], a.q_st[1], a.q_st[2], a.kv_st[0], a.kv_st[1], a.kv_st[2], a.o_st[0],
      a.o_st[1], a.o_st[2], a.m_st[0], a.m_st[1], a.m_st[2], a.m_st[3], a.scale, a.causal,
      a.seed, a.thresh, a.keep_prob);
  return cudaGetLastError();
}

}  // namespace
