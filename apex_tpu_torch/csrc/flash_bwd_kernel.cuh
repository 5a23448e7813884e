// The flash-attention backward, shared by flash_bwd.cu (generic attention,
// K2) and flash_qkv_bwd.cu (packed self-attention for training, K4), as
// flash_fwd_kernel.cuh is by their forwards: K4 is this backward on the
// strided views of the packed qkv, ctx and dqkv.
//
// Three passes that each own their outputs, so no two blocks ever add into
// one element and two runs give bitwise-equal gradients (no atomics):
//   1. delta: rowsum(do * o) in fp32 per row;
//   2. dk/dv: one 256-thread block per (64-column k-tile, batch*head)
//      walks its live q-tiles in order, recomputing p and dp;
//   3. dq: one 256-thread block per (64-row q-tile, batch*head) walks its
//      live k-tiles in order, recomputing them again.
// The TPU's grid kernel keeps dq in a persistent fp32 scratch across an
// in-order grid (_make_fused_bwd_kernel); Hopper's blocks run in no order,
// so each output is owned by one block instead.
//
// Thread t owns tile rows 2*(t/8) and 2*(t/8)+1 and columns t%8 + 8j: the
// 16 scores it recomputes, and the 2 x D/8 output elements (columns
// t%8 + 8jj of the head dim) it accumulates.  Per (row r, column c) of a
// visible pair:
//   p  = exp(s - lse[r])   with s the scaled (and masked) score, undropped
//   dp = do[r] . v[c]
//   with dropout: p~ = keep ? p / (1 - rate) : 0, dp~ = keep ? dp / (1 - rate) : 0
//   dv[c] += p~ do[r];  ds = p (dp~ - delta[r]) scale;  dk[c] += ds q[r];  dq[r] += ds k[c]
// with the keep bits redrawn from the forward's counter hash at the same
// global (row, col) of batch-head bh = b * H + head.  A row whose lse is
// the -1e30 sentinel (it saw no column) has p = 0, not exp(0): its dq is 0
// and it adds nothing to dk/dv.
//
// Skipping works in both directions.  Pass 3 takes the forward's rule
// (k-tiles whose segment-id interval meets the q-tile's, cut at the causal
// limit); pass 2 takes the transposed rule (_segment_block_bounds' second
// output: q-tiles whose interval meets the k-tile's) and starts the causal
// walk at row max(0, k0 - (sk - sq)).  Both are conservative: a skipped
// tile has no visible pair.  Each block computes its range from the
// segment ids itself and, when given `visits`, writes how many tiles it
// walked, so a caller can hold the rule against a plain statement of it.
//
// Layout: q, o, do [B, H, sq, d]; k, v [B, H, sk, d]; dq, dk, dv written
// through their own strides, all with a unit last stride.  The fp32 mask is
// read through four strides that may be 0; segment ids are [rows, s] int32
// with row = bh / seg_div.  The mask (MASK) and dropout (DROP) are
// template flags, as in the forward: K4's instances (no mask) carry no code
// for the mask, and an instance without dropout none for the hash.

#pragma once

#include <climits>

#include "common.cuh"

namespace bwd {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kB = 64;  // rows of a q-tile, columns of a k-tile

template <int D>
struct BwdTile {
  static constexpr int RS = D + 1;   // padded row stride of a [64, D] tile
  static constexpr int PS = kB + 1;  // padded row stride of a [64, 64] tile
  static constexpr int kTileFloats = kB * RS;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B*H, sq]
  float* delta;      // [B*H, sq] workspace
  void* dq;
  void* dk;
  void* dv;
  const float* mask;  // null: none
  const int* seg_q;   // null: no segments
  const int* seg_k;
  int seg_div;
  int* visits;  // null, or [B*H*n_kb] then [B*H*n_qb] tiles walked per block
  int B, H, sq, sk, causal;
  float scale;
  uint32_t seed, thresh;  // dropout: keep iff hash >= thresh
  float inv_keep;         // 1 / (1 - rate)
  // strides in elements, (b, h, s) of q, k/v, o, do, dq, dk/dv; mask (b, h, row, col)
  int64_t q_st[3], kv_st[3], o_st[3], do_st[3], dq_st[3], dkv_st[3], m_st[4];
};

template <typename T>
__device__ __forceinline__ const T* at(const void* p, const int64_t* st, int b, int h) {
  return static_cast<const T*>(p) + b * st[0] + h * st[1];
}

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

// Block-wide: [*lo, *hi) = the first and one past the last of the 64-wide
// tiles of ids[0, n) whose [min, max] interval meets [want_lo, want_hi],
// or (n_tiles, 0) when none does.  Every thread must call it.
__device__ __forceinline__ void live_tiles(const int* ids, int n, int want_lo, int want_hi,
                                           int* lo, int* hi) {
  const int n_t = (n + kB - 1) / kB;
  if (threadIdx.x == 0) {
    *lo = n_t;
    *hi = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n_t; t += kThreads / 32) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int c = t * kB + lane; c < min(n, (t + 1) * kB); c += 32) {
      mn = min(mn, ids[c]);
      mx = max(mx, ids[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    // integer min/max: the result does not depend on arrival order
    if (lane == 0 && want_lo <= mx && mn <= want_hi) {
      atomicMin(lo, t);
      atomicMax(hi, t + 1);
    }
  }
  __syncthreads();
}

// Block-wide: the [min, max] of ids[0, n) (n <= 64) into *mn, *mx.
__device__ __forceinline__ void own_interval(const int* ids, int n, int* mn, int* mx) {
  if (threadIdx.x < 32) {
    int a = INT_MAX, z = INT_MIN;
    for (int c = threadIdx.x; c < n; c += 32) {
      a = min(a, ids[c]);
      z = max(z, ids[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a = min(a, __shfl_xor_sync(0xffffffffu, a, off));
      z = max(z, __shfl_xor_sync(0xffffffffu, z, off));
    }
    if (threadIdx.x == 0) {
      *mn = a;
      *mx = z;
    }
  }
  __syncthreads();
}

// Of the pair (row, col) of one tile, given q.k and do.v: the p that
// multiplies do into dv (dropped and rescaled) and ds; both are 0 where
// the segment or causal mask hides the pair or the row saw nothing.  The
// additive mask joins the scaled score before p is taken.
template <bool MASK, bool DROP>
__device__ __forceinline__ void score_grads(const Args& a, const float* mrow, float qk,
                                            float dov, float lse, float delta, int bh, int r,
                                            int c, int nrows, int ncols, int row, int col,
                                            int seg_r, int seg_c, float* p_drop, float* ds) {
  const bool live = r < nrows && c < ncols && seg_r == seg_c &&
                    (!a.causal || row + (a.sk - a.sq) >= col);
  float s = qk * a.scale;
  if (MASK && live) s += mrow[row * a.m_st[2] + col * a.m_st[3]];
  float p = 0.f;
  if (live && lse > kNegInf / 2) p = expf(s - lse);
  float pd = p, dp = dov;
  if (DROP) {
    const bool keep = apex::dropout_keep(a.seed, bh, row, col, a.thresh);
    pd = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dov * a.inv_keep : 0.f;
  }
  *p_drop = pd;
  *ds = p * (dp - delta) * a.scale;
}

// The dk/dv pass's update for one q-tile: dv[c] += sum_r p~[r][c] do[r],
// dk[c] += sum_r ds[r][c] q[r], rows in order.
template <int D>
__device__ __forceinline__ void accumulate_dkdv(float (&dk)[2][D / 8], float (&dv)[2][D / 8],
                                                const float* Ps, const float* dSs,
                                                const float* dOs, const float* Qs) {
  using BT = BwdTile<D>;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
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
}

// The dq pass's update for one k-tile: dq[r] += sum_c ds[r][c] k[c],
// columns in order.
template <int D>
__device__ __forceinline__ void accumulate_dq(float (&dq)[2][D / 8], const float* dSs,
                                              const float* Ks) {
  using BT = BwdTile<D>;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
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
}

template <int D>
__device__ __forceinline__ void zero(float (&x)[2][D / 8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) x[i][jj] = 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta(Args a, int rows) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int bh = warp / a.sq, r = warp % a.sq, b = bh / a.H, h = bh % a.H;
  const T* o = at<T>(a.o, a.o_st, b, h) + r * a.o_st[2];
  const T* d = at<T>(a.dout, a.do_st, b, h) + r * a.do_st[2];
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(apex::to_float(d[c]), apex::to_float(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[warp] = acc;
}

// dk and dv of one 64-column k-tile of one batch*head.
template <typename T, int D, bool MASK, bool DROP>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(Args a) {
  using BT = BwdTile<D>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT::kTileFloats;
  float* Qs = Vs + BT::kTileFloats;
  float* dOs = Qs + BT::kTileFloats;
  float* Ps = dOs + BT::kTileFloats;
  float* dSs = Ps + kB * BT::PS;
  __shared__ float lse_s[kB], delta_s[kB];
  __shared__ int segq_s[kB], segk_s[kB];
  __shared__ int own_lo, own_hi, t_lo, t_hi;

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kB;
  const int ncols = min(kB, a.sk - k0);
  const int n_qb = (a.sq + kB - 1) / kB;
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.sq : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.sk : nullptr;
  const float* mrow = MASK ? a.mask + b * a.m_st[0] + h * a.m_st[1] : nullptr;

  load_rows<T, D>(Ks, at<T>(a.k, a.kv_st, b, h) + k0 * a.kv_st[2], a.kv_st[2], ncols);
  load_rows<T, D>(Vs, at<T>(a.v, a.kv_st, b, h) + k0 * a.kv_st[2], a.kv_st[2], ncols);
  if (tid < kB) segk_s[tid] = (has_seg && tid < ncols) ? sk_row[k0 + tid] : 0;

  // the live q-tiles: the transposed segment rule, then the causal start
  int lo = 0, hi = n_qb;
  if (has_seg) {
    own_interval(sk_row + k0, ncols, &own_lo, &own_hi);
    live_tiles(sq_row, a.sq, own_lo, own_hi, &t_lo, &t_hi);
    lo = t_lo;
    hi = t_hi;
  }
  if (a.causal) {
    const int first = k0 - (a.sk - a.sq);  // the first row that sees column k0
    lo = max(lo, first <= 0 ? 0 : min(n_qb, first / kB));
  }
  if (a.visits != nullptr && tid == 0)
    a.visits[static_cast<int64_t>(bh) * gridDim.x + blockIdx.x] = max(0, hi - lo);

  float dk[2][D / 8], dv[2][D / 8];
  zero<D>(dk);
  zero<D>(dv);
  const T* qbase = at<T>(a.q, a.q_st, b, h);
  const T* dobase = at<T>(a.dout, a.do_st, b, h);
  for (int qb = lo; qb < hi; ++qb) {
    const int q0 = qb * kB, nrows = min(kB, a.sq - q0);
    load_rows<T, D>(Qs, qbase + q0 * a.q_st[2], a.q_st[2], nrows);
    load_rows<T, D>(dOs, dobase + q0 * a.do_st[2], a.do_st[2], nrows);
    if (tid < kB) {
      const int64_t i = static_cast<int64_t>(bh) * a.sq + q0 + tid;
      lse_s[tid] = tid < nrows ? a.lse[i] : kNegInf;
      delta_s[tid] = tid < nrows ? a.delta[i] : 0.f;
      segq_s[tid] = (has_seg && tid < nrows) ? sq_row[q0 + tid] : 0;
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
        score_grads<MASK, DROP>(a, mrow, qk[i][j], dov[i][j], lse_s[r], delta_s[r], bh, r, c, nrows, ncols,
                    q0 + r, k0 + c, segq_s[r], segk_s[c], &pd, &ds);
        Ps[r * BT::PS + c] = pd;
        dSs[r * BT::PS + c] = ds;
      }
    }
    __syncthreads();
    accumulate_dkdv<D>(dk, dv, Ps, dSs, dOs, Qs);
    __syncthreads();  // before the next q-tile overwrites Qs, dOs, Ps, dSs
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.dkv_st[0] + h * a.dkv_st[1];
  T* dvb = static_cast<T*>(a.dv) + b * a.dkv_st[0] + h * a.dkv_st[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = ty * 2 + i;
    if (c >= ncols) continue;
    const int64_t off = (k0 + c) * a.dkv_st[2];
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      apex::store(dkb + off + tx + 8 * jj, dk[i][jj]);
      apex::store(dvb + off + tx + 8 * jj, dv[i][jj]);
    }
  }
}

// dq of one 64-row q-tile of one batch*head.
template <typename T, int D, bool MASK, bool DROP>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(Args a) {
  using BT = BwdTile<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT::kTileFloats;
  float* Ks = dOs + BT::kTileFloats;
  float* Vs = Ks + BT::kTileFloats;
  float* dSs = Vs + BT::kTileFloats;
  __shared__ float lse_s[kB], delta_s[kB];
  __shared__ int segq_s[kB], segk_s[kB];
  __shared__ int own_lo, own_hi, t_lo, t_hi;

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kB;
  const int nrows = min(kB, a.sq - q0);
  const int n_kb = (a.sk + kB - 1) / kB;
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.sq : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.sk : nullptr;
  const float* mrow = MASK ? a.mask + b * a.m_st[0] + h * a.m_st[1] : nullptr;

  load_rows<T, D>(Qs, at<T>(a.q, a.q_st, b, h) + q0 * a.q_st[2], a.q_st[2], nrows);
  load_rows<T, D>(dOs, at<T>(a.dout, a.do_st, b, h) + q0 * a.do_st[2], a.do_st[2], nrows);
  if (tid < kB) {
    const int64_t i = static_cast<int64_t>(bh) * a.sq + q0 + tid;
    lse_s[tid] = tid < nrows ? a.lse[i] : kNegInf;
    delta_s[tid] = tid < nrows ? a.delta[i] : 0.f;
    segq_s[tid] = (has_seg && tid < nrows) ? sq_row[q0 + tid] : 0;
  }

  // the live k-tiles: the forward's segment rule, then the causal limit
  int lo = 0, hi = n_kb;
  if (has_seg) {
    own_interval(sq_row + q0, nrows, &own_lo, &own_hi);
    live_tiles(sk_row, a.sk, own_lo, own_hi, &t_lo, &t_hi);
    lo = t_lo;
    hi = t_hi;
  }
  if (a.causal) {
    const int last = q0 + nrows - 1 + (a.sk - a.sq);  // the last column row q0+nrows-1 sees
    hi = min(hi, last >= 0 ? last / kB + 1 : 0);
  }
  if (a.visits != nullptr && tid == 0) {
    const int64_t kv_blocks = static_cast<int64_t>(a.B) * a.H * n_kb;
    a.visits[kv_blocks + static_cast<int64_t>(bh) * gridDim.x + blockIdx.x] = max(0, hi - lo);
  }

  float dq[2][D / 8];
  zero<D>(dq);
  const T* kbase = at<T>(a.k, a.kv_st, b, h);
  const T* vbase = at<T>(a.v, a.kv_st, b, h);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * kB, ncols = min(kB, a.sk - k0);
    load_rows<T, D>(Ks, kbase + k0 * a.kv_st[2], a.kv_st[2], ncols);
    load_rows<T, D>(Vs, vbase + k0 * a.kv_st[2], a.kv_st[2], ncols);
    if (tid < kB) segk_s[tid] = (has_seg && tid < ncols) ? sk_row[k0 + tid] : 0;
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
        score_grads<MASK, DROP>(a, mrow, qk[i][j], dov[i][j], lse_s[r], delta_s[r], bh, r, c, nrows, ncols,
                    q0 + r, k0 + c, segq_s[r], segk_s[c], &pd, &ds);
        dSs[r * BT::PS + c] = ds;
      }
    }
    __syncthreads();
    accumulate_dq<D>(dq, dSs, Ks);
    __syncthreads();  // before the next k-tile overwrites Ks, Vs, dSs
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.dq_st[0] + h * a.dq_st[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    if (r >= nrows) continue;
    const int64_t off = (q0 + r) * a.dq_st[2];
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) apex::store(dqb + off + tx + 8 * jj, dq[i][jj]);
  }
}

// Launch the three passes of one instance in order on `stream`.  Returns
// the first launch error, or cudaSuccess.
template <typename T, int D, bool MASK, bool DROP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using BT = BwdTile<D>;
  const int rows = a.B * a.H * a.sq;
  attn_bwd_delta<T, D><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_kb = (a.sk + kB - 1) / kB, n_qb = (a.sq + kB - 1) / kB;
  const size_t kv_smem = sizeof(float) * (4 * BT::kTileFloats + 2 * kB * BT::PS);
  err = apex::allow_smem(attn_bwd_dkdv<T, D, MASK, DROP>, kv_smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv<T, D, MASK, DROP><<<dim3(n_kb, a.B * a.H), kThreads, kv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t q_smem = sizeof(float) * (4 * BT::kTileFloats + kB * BT::PS);
  err = apex::allow_smem(attn_bwd_dq<T, D, MASK, DROP>, q_smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq<T, D, MASK, DROP><<<dim3(n_qb, a.B * a.H), kThreads, q_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace bwd
