// Shared tile machinery of the attention forwards: flash_fwd.cu (prefill),
// flash_qkv_fwd.cu (packed self-attention, training) and flash_decode.cu
// (paged decode).
//
// One thread block of 128 threads owns BQ = 16 * RM query rows and walks
// key/value columns in tiles of 64, in order, carrying an fp32 online
// softmax (running max m, running sum l, unnormalised output acc) from
// one tile to the next.  Thread t owns rows ty*RM .. ty*RM+RM-1 with
// ty = t / 8, score columns tx + 8j (j < 8) and output columns tx + 8jj
// (jj < D/8) with tx = t % 8, so the eight threads of a row group are
// eight neighbouring lanes and a row reduction is three shuffles.
//
// The masking rules are the JAX package's (apex_tpu/ops/attention.py):
// masked scores are set to the sentinel -1e30, exp is forced to 0 while a
// row's running max is still the sentinel (_masked_exp), a row that saw no
// visible column returns exact zeros and lse = -1e30.  Every sum runs in
// one fixed order per block; nothing is shared between blocks, so results
// are deterministic and each row is independent of every other row.

#pragma once

#include "common.cuh"

namespace flash {

using apex::load16;
using apex::store;
using apex::to_float;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBK = 64;  // key/value columns per tile

// The value of p that multiplies V: p itself, or p with attention dropout
// applied (flash_fwd_kernel.cuh).  The running sum l always takes the
// undropped p, so lse counts every visible column.
struct NoDrop {
  __device__ __forceinline__ float operator()(int, int, float p) const { return p; }
};

// The scaled score of a visible pair before the masks: the score itself,
// or the score plus an additive mask (flash_fwd_kernel.cuh).
struct NoBias {
  __device__ __forceinline__ float operator()(int, int, float s) const { return s; }
};

template <int D, int RM>
struct Tile {
  static constexpr int BQ = 16 * RM;
  static constexpr int QS = D + 2;       // padded row strides: spread the
  static constexpr int KS = D + 1;       // rows of a warp over the banks
  static constexpr int PS = kBK + 1;
  // the K tile's buffer holds P once the scores are taken
  static constexpr int KP = (kBK * KS > BQ * PS) ? kBK * KS : BQ * PS;
  static constexpr int kFloats = BQ * QS + KP + kBK * D;
  static constexpr size_t kSmemBytes = sizeof(float) * kFloats;
};

template <int D, int RM>
struct Acc {
  float o[RM][D / 8];
  float m[RM];
  float l[RM];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) o[i][jj] = 0.f;
    }
  }
};

// Rows [0, nrows) of q (row stride `row_stride` elements) into Qs as fp32;
// rows past nrows are zero.
template <int D, int RM, typename T>
__device__ __forceinline__ void load_q(float* Qs, const T* q, int64_t row_stride, int nrows) {
  using TL = Tile<D, RM>;
  constexpr int U = 16 / sizeof(T);
  constexpr int CH = D / U;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < TL::BQ * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * U;
    float buf[U];
    if (r < nrows) {
      load16(q + r * row_stride + c, buf);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) buf[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) Qs[r * TL::QS + c + u] = buf[u];
  }
}

// One K/V tile: column j's row starts at element offset col_off[j] of k
// and of v (both share their strides), or is absent (col_off[j] < 0) and
// reads as zeros.
template <int D, int RM, typename T>
__device__ __forceinline__ void load_kv(float* Ks, float* Vs, const T* k, const T* v,
                                        const int64_t* col_off) {
  using TL = Tile<D, RM>;
  constexpr int U = 16 / sizeof(T);
  constexpr int CH = D / U;
  for (int idx = threadIdx.x; idx < kBK * CH; idx += kThreads) {
    const int j = idx / CH, c = (idx % CH) * U;
    const int64_t off = col_off[j];
    float kb[U], vb[U];
    if (off >= 0) {
      load16(k + off + c, kb);
      load16(v + off + c, vb);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) kb[u] = vb[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Ks[j * TL::KS + c + u] = kb[u];
      Vs[j * D + c + u] = vb[u];
    }
  }
}

// Fold one loaded tile into the running state.  live(i, j) says whether
// this thread's row i may see tile column j; bias(i, j, s) gives a visible
// pair's scaled score with its additive mask; drop(i, j, p) gives the value
// of p that multiplies V.
template <int D, int RM, typename Live, typename Drop = NoDrop, typename Bias = NoBias>
__device__ __forceinline__ void attend_tile(Acc<D, RM>& a, const float* Qs, float* KPs,
                                            const float* Vs, float scale, Live live,
                                            Drop drop = Drop(), Bias bias = Bias()) {
  using TL = Tile<D, RM>;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  float s[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float q[RM], k[8];
#pragma unroll
    for (int i = 0; i < RM; ++i) q[i] = Qs[(ty * RM + i) * TL::QS + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = KPs[(tx + 8 * j) * TL::KS + c];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(q[i], k[j], s[i][j]);
  }
  __syncthreads();  // every K read is done before P overwrites the buffer

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = live(i, tx + 8 * j) ? bias(i, tx + 8 * j, s[i][j] * scale) : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(a.m[i], mx);
    const float alpha = (a.m[i] <= kNegInf / 2) ? 0.f : expf(a.m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = (m_new <= kNegInf / 2) ? 0.f : expf(s[i][j] - m_new);
      KPs[(ty * RM + i) * TL::PS + tx + 8 * j] = drop(i, tx + 8 * j, p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    a.l[i] = alpha * a.l[i] + sum;
    a.m[i] = m_new;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) a.o[i][jj] *= alpha;
  }
  __syncthreads();

#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = KPs[(ty * RM + i) * TL::PS + kk];
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const float v = Vs[kk * D + tx + 8 * jj];
#pragma unroll
      for (int i = 0; i < RM; ++i) a.o[i][jj] = fmaf(p[i], v, a.o[i][jj]);
    }
  }
  __syncthreads();  // before the next tile's loads overwrite K/V/P
}

// o rows [0, nrows) (row stride o_row_stride); lse (if given) per row.
template <int D, int RM, typename T>
__device__ __forceinline__ void finish(const Acc<D, RM>& a, T* o, int64_t o_row_stride,
                                       int nrows, float* lse) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (r >= nrows) continue;
    const float l_safe = (a.l[i] == 0.f) ? 1.f : a.l[i];
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) store(o + r * o_row_stride + tx + 8 * jj, a.o[i][jj] / l_safe);
    if (lse != nullptr && tx == 0) lse[r] = (a.l[i] == 0.f) ? kNegInf : a.m[i] + logf(l_safe);
  }
}

using apex::allow_smem;
using apex::DeviceGuard;

}  // namespace flash
