// Generic flash attention backward on Hopper's tensor cores (sm_90a: wgmma
// and TMA): the bf16 route of K2 at head dims 64 and 128.  flash_bwd.cu
// stays the route for fp32 and for head dim 8.
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_bwd_pallas:
// from (q, k, v, o, lse, do) it writes dq, dk and dv with the forward's
// (flash_fwd.cu's) additive mask, segment ids, causal mask aligned to the
// end of the keys (query r sees keys <= r + sk - sq) and dropout.  Per
// visible (query r, key c):
//   p  = exp(q.k * scale + mask - lse[r])              (undropped)
//   dp = do[r] . v[c]
//   with dropout: p~ = keep ? p / (1 - rate) : 0, dp~ = keep ? dp / (1 - rate) : 0
//   dv[c] += p~ do[r];  ds = p (dp~ - delta[r]) scale;  dk[c] += ds q[r];  dq[r] += ds k[c]
// with delta[r] = do[r] . o[r] and the keep bits redrawn from the
// forward's counter hash at the same global (row = query, col = key) of
// batch-head bh = b * H + head.  p~ and ds are rounded to bf16 before they
// multiply (the JAX kernel's p_drop.astype(do.dtype) and
// ds.astype(q.dtype)); every sum is fp32.  A query that saw no key (K1's
// lse sentinel -1e30) has p = 0: its dq is exactly 0 and it adds nothing
// to dk and dv.
//
// What bounds it on an H100: at the multi-head attention path's encoder
// shape ([32, 16, 256, 64], key padding) it must read q, k, v, o and do
// once and write dq, dk and dv once (~0.04 ms at 3.35 TB/s) and does ten
// flops of d per visible pair (~0.014 ms at 989 TFLOP/s): bound by bytes
// at the roof, so the design keeps loads in flight (TMA, a ring of
// stages) and does every product on the tensor cores so that the math
// hides under them.
//
// Design: packed-QKV K4's (flash_qkv_bwd_sm90.cu), generalized to strided
// [B, H, s, d] operands, sq != sk, the additive mask and a head dim of 64.
// Three launches, each output owned by one block, no atomics, so two runs
// give bitwise-equal gradients:
//   1. attn_bwd_delta_sm90: delta = rowsum(do * o) in fp32, a warp a row.
//   2. attn_bwd_dkdv_sm90: one block per (128-key tile, batch*head), two
//      warpgroups of 64 keys each with their K and V resident in shared
//      memory; warp 0 also streams 32-query Q and dO tiles (with their
//      lse, delta and segment ids) through a ring of four stages.  The
//      transposed products S^T = K Q^T and dP^T = V dO^T put a key on each
//      accumulator row and a query on each column, so P~^T and dS^T land
//      in accumulator layout and feed dV += P~^T dO and dK += dS^T Q as
//      register A fragments (dO and Q as MN-major B).  It walks the live
//      query tiles: the transposed segment rule, and under the causal mask
//      from the tile holding query k0 - (sk - sq) on.
//   3. attn_bwd_dq_sm90: one block per (128-query tile, batch*head), two
//      warpgroups of 64 rows with Q and dO resident, K/V tiles of 64 keys
//      streamed by warp 0 through three stages; S and dP recomputed, dQ +=
//      dS K (K as MN-major B).  It walks the forward's live key tiles, cut
//      at the causal limit.
// Operands: every TMA map is built from the tensor's own (d, s, h, b)
// strides (sm90_host::bf16_map_4d), so the modules' permuted views of
// their projections load without a copy, and dq, dk, dv are stored
// through their own strides.  Rows of a ragged last tile arrive as zeros;
// a query past the end carries lse = +inf into the kernel (p = 0), and a
// key past the end has zero K and V rows: it adds 0 to dq (its exponent
// capped, so that p stays finite for a row whose every key the additive
// mask hides), and its dk/dv rows are not stored.
// The fp32 mask is read through its four strides, any of which may be 0
// (a broadcast TMA cannot describe), by the consumer threads themselves:
// each loads the mask values of its own accumulator elements after the
// tile's score products.
// Passes 2 and 3 write, when given `visits`, how many tiles each block
// walked ([B*H*ceil(sk/128)] for pass 2, then [B*H*ceil(sq/128)] for
// pass 3), so a caller can hold the skip rule against a plain statement
// of it.  Elementwise work as in K4: masks behind one branch a tile,
// hidden pairs at -inf, p by ex2.approx.
// The causal mask, the additive mask and dropout are template flags, as
// in the scalar K2: an instance carries no code for what it does not do.

#include <climits>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInf = __builtin_huge_valf();
constexpr float kMaxLog2 = 64.f;  // the dq pass's cap on an exponent

// pass 2: keys a block (64 a warpgroup), queries a streamed tile, stages
constexpr int kKV2 = 128, kQ2 = 32, kStages2 = 4;
// pass 3: queries a block (64 a warpgroup), keys a streamed tile, stages
constexpr int kQ3 = 128, kK3 = 64, kStages3 = 3;

// Blocks an SM the registers are sized for: two at head dim 64 where the
// instance fits 128 registers a thread without a spill (the dk/dv pass
// without the additive mask, the dq pass without the mask and the causal
// cut), so that one block's loads overlap the other's products; else one.
__host__ __device__ constexpr int blocks_per_sm(int d, bool heavy) {
  return d == 64 && !heavy ? 2 : 1;
}

template <int D>
struct Smem2 {
  static constexpr int kResBytes = kKV2 * D * 2;  // K or V of the block
  static constexpr int kResBox = kKV2 * 128;      // one 64-column box of it
  static constexpr int kTileBytes = kQ2 * D * 2;  // a Q or dO tile
  static constexpr int kTileBox = kQ2 * 128;
  static constexpr size_t kBytes = 2 * kResBytes + 2 * kStages2 * kTileBytes + 1024;
};

template <int D>
struct Smem3 {
  static constexpr int kResBytes = kQ3 * D * 2;   // Q or dO of the block
  static constexpr int kResBox = kQ3 * 128;
  static constexpr int kTileBytes = kK3 * D * 2;  // a K or V tile
  static constexpr int kTileBox = kK3 * 128;
  static constexpr size_t kBytes = 2 * kResBytes + 2 * kStages3 * kTileBytes + 1024;
};

struct Args {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // [B*H, sq]
  float* delta;      // [B*H, sq] workspace
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* mask;  // null: none
  const int* seg_q;   // null: no segments
  const int* seg_k;
  int seg_div;
  int* visits;        // null, or tiles walked per block
  int B, H, sq, sk;
  float scale, scale_log2;
  uint32_t seed, thresh;
  float inv_keep;     // 1 / (1 - rate)
  // strides in elements: (b, h, s) of o, do, dq, dk, dv; mask (b, h, row, col)
  int64_t o_st[3], do_st[3], dq_st[3], dk_st[3], dv_st[3], m_st[4];
};

template <int D>
__global__ void __launch_bounds__(256) attn_bwd_delta_sm90(Args a, int rows) {
  const int w = (blockIdx.x * 256 + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= rows) return;
  const int bh = w / a.sq, r = w % a.sq, b = bh / a.H, h = bh % a.H;
  const __nv_bfloat16* o = a.o + b * a.o_st[0] + h * a.o_st[1] + r * a.o_st[2];
  const __nv_bfloat16* d = a.dout + b * a.do_st[0] + h * a.do_st[1] + r * a.do_st[2];
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[w] = acc;
}

// Of one pair, from its score in log2 units less lse (-inf where the pair
// is hidden or the query saw no key, so p = 0): p~ and ds.
template <bool DROP>
__device__ __forceinline__ void pair_grads(const Args& a, int bh, float s, float dp, float delta,
                                           int query, int key, float* pd, float* ds) {
  const float p = sm90::ex2(s);
  float pdrop = p, dpd = dp;
  if (DROP) {
    const bool keep = apex::dropout_keep(a.seed, bh, query, key, a.thresh);
    pdrop = keep ? p * a.inv_keep : 0.f;
    dpd = keep ? dp * a.inv_keep : 0.f;
  }
  *pd = pdrop;
  *ds = p * (dpd - delta) * a.scale;
}

// The additive mask of (query, key) in log2 units, 0 outside [sq, sk)
// (a ragged tile's padding rows and columns are never read).
__device__ __forceinline__ float mask_l2(const Args& a, const float* mrow, int query, int key) {
  return query < a.sq && key < a.sk ? mrow[query * a.m_st[2] + key * a.m_st[3]] * kLog2e : 0.f;
}

// The register A fragments of a [64, 16 k] bf16 tile from fp32 accumulator
// elements (see sm90.cuh: the accumulator's d[8 k .. 8 k + 7] are the A
// fragment of its k-th 16 columns).
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) f[kk][u] = sm90::pack_bf16(x[8 * kk + 2 * u], x[8 * kk + 2 * u + 1]);
}

// d[64 x D] += A[64 x 16] B[16 x D], A from registers, B MN-major from
// `box` (its D columns in 64-column boxes `box_bytes` apart).
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint32_t box,
                                       int k, uint32_t box_bytes) {
  if constexpr (D == 128) {
    sm90::wgmma_rs_n128<1>(d, a, sm90::desc_mnmajor(box, k, box_bytes), 1);
  } else {
    sm90::wgmma_rs_n64<1>(d, a, sm90::desc_mnmajor(box, k, box_bytes), 1);
  }
}

// Store rows r0 and r0 + 8 of a [64 x D] accumulator of this thread (lane
// 4 g + t: columns 8 j + 2 t, + 1) as bf16 pairs at out + row * row_stride,
// rows at or past `end` skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t row_stride, int r0,
                                           int end, const float (&acc)[D / 2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= end) continue;
    __nv_bfloat16* out = base + row * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          sm90::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: dK and dV of one 128-key tile of one batch*head

template <int D, bool CAUSAL, bool MASK, bool DROP>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(D, MASK))
    attn_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do, const Args a) {
  using SM = Smem2<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Ks = sm90::align1024(smem_raw);
  uint8_t* const Vs = Ks + SM::kResBytes;
  uint8_t* const Qs = Vs + SM::kResBytes;               // [kStages2][tile]
  uint8_t* const dOs = Qs + kStages2 * SM::kTileBytes;  // [kStages2][tile]
  __shared__ __align__(8) uint64_t kv_full, t_full[kStages2], t_empty[kStages2];
  __shared__ float lse_s[kStages2][kQ2], delta_s[kStages2][kQ2];
  __shared__ int segq_s[kStages2][kQ2], seg_tile[kStages2][2];
  __shared__ int own[kConsumers][2];
  __shared__ int t_lo, t_hi;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kb = blockIdx.y, k0 = kb * kKV2;
  const int nkeys = min(kKV2, a.sk - k0);
  const int n_qt = (a.sq + kQ2 - 1) / kQ2;
  const int off = a.sk - a.sq;  // causal: query r sees keys <= r + off
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.sq : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.sk : nullptr;
  const float* mrow = MASK ? a.mask + b * a.m_st[0] + h * a.m_st[1] : nullptr;

  if (tid == 0) {
    sm90::mbar_init(&kv_full, 1);
#pragma unroll
    for (int i = 0; i < kStages2; ++i) {
      sm90::mbar_init(&t_full[i], 1);
      sm90::mbar_init(&t_empty[i], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  // the live query tiles: the transposed segment rule, then the causal start
  int lo = 0, hi = n_qt;
  if (has_seg) {
    sm90::own_intervals(sk_row, k0, nkeys, own);
    sm90::live_tiles(sq_row, a.sq, kQ2, own, &t_lo, &t_hi);
    lo = t_lo;
    hi = t_hi;
  } else {
    __syncthreads();
  }
  if (CAUSAL) {
    const int first = k0 - off;  // the first query that sees key k0
    lo = max(lo, first <= 0 ? 0 : min(n_qt, first / kQ2));
  }
  if (a.visits != nullptr && tid == 0)
    a.visits[static_cast<int64_t>(bh) * gridDim.y + kb] = max(0, hi - lo);

  // warp 0 loads: K and V once, then query tile i of the walk into stage
  // i % kStages2 once that stage is free, with the tile's lse (log2 units;
  // +inf where the query is past the end or saw no key, so its p is 0),
  // delta and segment ids
  const int n_tiles = max(0, hi - lo);
  const auto load_tile = [&](int i) {
    const int st = i % kStages2, c0 = (lo + i) * kQ2;
    const int q = c0 + lane;
    float lv = kInf, dv = 0.f;
    int sv = INT_MIN;
    if (q < a.sq) {
      const float x = a.lse[static_cast<int64_t>(bh) * a.sq + q];
      lv = x > kNegInf / 2 ? x * kLog2e : kInf;
      dv = a.delta[static_cast<int64_t>(bh) * a.sq + q];
      if (has_seg) sv = sq_row[q];
    }
    lse_s[st][lane] = lv;
    delta_s[st][lane] = dv;
    if (has_seg) {
      segq_s[st][lane] = sv;
      int mn = q < a.sq ? sv : INT_MAX, mx = q < a.sq ? sv : INT_MIN;
      sm90::warp_min_max(mn, mx);
      if (lane == 0) {
        seg_tile[st][0] = mn;
        seg_tile[st][1] = mx;
      }
    }
    __syncwarp();  // written before lane 0's arrive releases them
    if (lane == 0) {
      sm90::mbar_expect_tx(&t_full[st], 2 * SM::kTileBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_4d(Qs + st * SM::kTileBytes + x * SM::kTileBox, &tm_q, &t_full[st], 64 * x,
                          c0, h, b);
        sm90::tma_load_4d(dOs + st * SM::kTileBytes + x * SM::kTileBox, &tm_do, &t_full[st],
                          64 * x, c0, h, b);
      }
    }
    __syncwarp();
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_expect_tx(&kv_full, 2 * SM::kResBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_4d(Ks + x * SM::kResBox, &tm_k, &kv_full, 64 * x, k0, h, b);
        sm90::tma_load_4d(Vs + x * SM::kResBox, &tm_v, &kv_full, 64 * x, k0, h, b);
      }
    }
    for (int i = 0; i < min(n_tiles, kStages2); ++i) load_tile(i);  // the ring starts empty
  }

  // -- warpgroup wg: keys k0 + 64 wg .. + 63 ----------------------------------
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int kw = k0 + 64 * wg;
  const int key0 = kw + 16 * (warp & 3) + g;  // this thread's keys: key0, key0 + 8
  int my_seg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) my_seg[r] = key0 + 8 * r < a.sk ? sk_row[key0 + 8 * r] : INT_MAX;
  }
  const bool wg_uniform = has_seg && own[wg][0] == own[wg][1];

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
  float sacc[kQ2 / 2], pacc[kQ2 / 2];
#pragma unroll
  for (int x = 0; x < kQ2 / 2; ++x) sacc[x] = pacc[x] = 0.f;

  const uint32_t k_box = sm90::smem_u32(Ks) + 64 * wg * 128;
  const uint32_t v_box = sm90::smem_u32(Vs) + 64 * wg * 128;
  sm90::mbar_wait(&kv_full, 0);
  for (int qt = lo, i = 0; qt < hi; ++qt, ++i) {
    const int st = i % kStages2, c0 = qt * kQ2;
    sm90::mbar_wait(&t_full[st], (i / kStages2) & 1);
    if (!CAUSAL || c0 + kQ2 - 1 + off >= kw) {
      const uint32_t q_box = sm90::smem_u32(Qs + st * SM::kTileBytes);
      const uint32_t do_box = sm90::smem_u32(dOs + st * SM::kTileBytes);
      // S^T = K Q^T and dP^T = V dO^T, keys on rows, queries on columns
      sm90::fence_regs(sacc);
      sm90::fence_regs(pacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n32<0>(sacc, sm90::desc_kmajor(k_box + (kk / 4) * SM::kResBox, kk % 4),
                              sm90::desc_kmajor(q_box + (kk / 4) * SM::kTileBox, kk % 4),
                              kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n32<0>(pacc, sm90::desc_kmajor(v_box + (kk / 4) * SM::kResBox, kk % 4),
                              sm90::desc_kmajor(do_box + (kk / 4) * SM::kTileBox, kk % 4),
                              kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      sm90::fence_regs(pacc);

      // accumulator (x): key key0 + 8 ((x >> 1) & 1), query c0 + c.
      // Scores in log2 units less lse, the additive mask joined; hidden
      // pairs at -inf, behind one branch a tile (a branch inside the
      // element loop costs a convergence barrier per element)
#pragma unroll
      for (int x = 0; x < kQ2 / 2; ++x) {
        const int c = 8 * (x >> 2) + 2 * t + (x & 1);
        sacc[x] = sacc[x] * a.scale_log2 - lse_s[st][c];
        if constexpr (MASK) sacc[x] += mask_l2(a, mrow, c0 + c, key0 + 8 * ((x >> 1) & 1));
      }
      const bool seg_mask = has_seg && !(wg_uniform && seg_tile[st][0] == seg_tile[st][1] &&
                                         seg_tile[st][0] == own[wg][0]);
      const auto mask = [&](auto with_seg) {
#pragma unroll
        for (int x = 0; x < kQ2 / 2; ++x) {
          const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
          bool live = !CAUSAL || key0 + 8 * r <= c0 + c + off;
          if (decltype(with_seg)::value) live = live && segq_s[st][c] == my_seg[r];
          sacc[x] = live ? sacc[x] : -kInf;
        }
      };
      if (seg_mask) {
        mask(std::true_type());
      } else if (CAUSAL && kw + 63 > c0 + off) {
        mask(std::false_type());
      }
#pragma unroll
      for (int x = 0; x < kQ2 / 2; ++x) {
        const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
        pair_grads<DROP>(a, bh, sacc[x], pacc[x], delta_s[st][c], c0 + c, key0 + 8 * r,
                         &sacc[x], &pacc[x]);
      }
      uint32_t pf[kQ2 / 16][4], sf[kQ2 / 16][4];
      to_frags<kQ2>(pf, sacc);
      to_frags<kQ2>(sf, pacc);
      // dV += P~^T dO and dK += dS^T Q, dO and Q read MN-major
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ2 / 16; ++kk) mma_rs<D>(dv, pf[kk], do_box, kk, SM::kTileBox);
#pragma unroll
      for (int kk = 0; kk < kQ2 / 16; ++kk) mma_rs<D>(dk, sf[kk], q_box, kk, SM::kTileBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
    }
    sm90::mbar_arrive(&t_empty[st]);
    if (warp == 0 && i + kStages2 < n_tiles) {
      sm90::mbar_wait(&t_empty[st], (i / kStages2) & 1);  // both warpgroups are done with it
      load_tile(i + kStages2);
    }
  }

  const int row0 = 16 * (warp & 3) + g;  // this thread's first row of the warpgroup
  store_rows<D>(a.dk + b * a.dk_st[0] + h * a.dk_st[1], a.dk_st[2], kw + row0, a.sk, dk);
  store_rows<D>(a.dv + b * a.dv_st[0] + h * a.dv_st[1], a.dv_st[2], kw + row0, a.sk, dv);
}

// ---------------------------------------------------------------------------
// pass 3: dQ of one 128-query tile of one batch*head

template <int D, bool CAUSAL, bool MASK, bool DROP>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(D, MASK || CAUSAL))
    attn_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using SM = Smem3<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = sm90::align1024(smem_raw);
  uint8_t* const dOs = Qs + SM::kResBytes;
  uint8_t* const Ks = dOs + SM::kResBytes;               // [kStages3][tile]
  uint8_t* const Vs = Ks + kStages3 * SM::kTileBytes;    // [kStages3][tile]
  __shared__ __align__(8) uint64_t q_full, t_full[kStages3], t_empty[kStages3];
  __shared__ int segk_s[kStages3][kK3], seg_tile[kStages3][2];
  __shared__ int own[kConsumers][2];
  __shared__ int t_lo, t_hi;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_qb = gridDim.y;
  const int qb = CAUSAL ? n_qb - 1 - blockIdx.y : blockIdx.y;  // the longest walks first
  const int q0 = qb * kQ3;
  const int nrows = min(kQ3, a.sq - q0);
  const int n_kt = (a.sk + kK3 - 1) / kK3;
  const int off = a.sk - a.sq;  // causal: query r sees keys <= r + off
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.sq : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.sk : nullptr;
  const float* mrow = MASK ? a.mask + b * a.m_st[0] + h * a.m_st[1] : nullptr;

  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages3; ++i) {
      sm90::mbar_init(&t_full[i], 1);
      sm90::mbar_init(&t_empty[i], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  // the live key tiles: the forward's segment rule, then the causal limit
  int lo = 0, hi = n_kt;
  if (has_seg) {
    sm90::own_intervals(sq_row, q0, nrows, own);
    sm90::live_tiles(sk_row, a.sk, kK3, own, &t_lo, &t_hi);
    lo = t_lo;
    hi = t_hi;
  } else {
    __syncthreads();
  }
  if (CAUSAL) {
    const int last = q0 + nrows - 1 + off;  // the last key the block's last query sees
    hi = min(hi, last >= 0 ? last / kK3 + 1 : 0);
  }
  if (a.visits != nullptr && tid == 0) {
    const int64_t kv_blocks = static_cast<int64_t>(a.B) * a.H * ((a.sk + kKV2 - 1) / kKV2);
    a.visits[kv_blocks + static_cast<int64_t>(bh) * n_qb + qb] = max(0, hi - lo);
  }

  // warp 0 loads: Q and dO once, then key tile i of the walk into stage
  // i % kStages3 (its ids, with segments, into segk_s) once that stage is
  // free
  const int n_tiles = max(0, hi - lo);
  const auto load_tile = [&](int i) {
    const int st = i % kStages3, k0 = (lo + i) * kK3;
    if (has_seg) sm90::stage_ids(sk_row, k0, kK3, a.sk, segk_s[st], seg_tile[st]);
    if (lane == 0) {
      sm90::mbar_expect_tx(&t_full[st], 2 * SM::kTileBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_4d(Ks + st * SM::kTileBytes + x * SM::kTileBox, &tm_k, &t_full[st], 64 * x,
                          k0, h, b);
        sm90::tma_load_4d(Vs + st * SM::kTileBytes + x * SM::kTileBox, &tm_v, &t_full[st], 64 * x,
                          k0, h, b);
      }
    }
    __syncwarp();
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_expect_tx(&q_full, 2 * SM::kResBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_4d(Qs + x * SM::kResBox, &tm_q, &q_full, 64 * x, q0, h, b);
        sm90::tma_load_4d(dOs + x * SM::kResBox, &tm_do, &q_full, 64 * x, q0, h, b);
      }
    }
    for (int i = 0; i < min(n_tiles, kStages3); ++i) load_tile(i);  // the ring starts empty
  }

  // -- warpgroup wg: queries q0 + 64 wg .. + 63 -------------------------------
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;
  const int row0 = qw + 16 * (warp & 3) + g;  // this thread's queries: row0, row0 + 8
  float lse_l2[2], delta[2];
  int my_seg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    lse_l2[r] = kInf;
    delta[r] = 0.f;
    if (q < a.sq) {
      const float x = a.lse[static_cast<int64_t>(bh) * a.sq + q];
      lse_l2[r] = x > kNegInf / 2 ? x * kLog2e : kInf;
      delta[r] = a.delta[static_cast<int64_t>(bh) * a.sq + q];
      if (has_seg) my_seg[r] = sq_row[q];
    } else if (has_seg) {
      my_seg[r] = INT_MAX;
    }
  }
  const bool wg_uniform = has_seg && own[wg][0] == own[wg][1];

  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  float sacc[kK3 / 2], pacc[kK3 / 2];
#pragma unroll
  for (int x = 0; x < kK3 / 2; ++x) sacc[x] = pacc[x] = 0.f;

  const uint32_t q_box = sm90::smem_u32(Qs) + 64 * wg * 128;
  const uint32_t do_box = sm90::smem_u32(dOs) + 64 * wg * 128;
  sm90::mbar_wait(&q_full, 0);
  for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
    const int st = i % kStages3, k0 = kt * kK3;
    sm90::mbar_wait(&t_full[st], (i / kStages3) & 1);
    if (!CAUSAL || k0 <= qw + 63 + off) {
      const uint32_t k_box = sm90::smem_u32(Ks + st * SM::kTileBytes);
      const uint32_t v_box = sm90::smem_u32(Vs + st * SM::kTileBytes);
      // S = Q K^T and dP = dO V^T
      sm90::fence_regs(sacc);
      sm90::fence_regs(pacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(sacc, sm90::desc_kmajor(q_box + (kk / 4) * SM::kResBox, kk % 4),
                              sm90::desc_kmajor(k_box + (kk / 4) * SM::kTileBox, kk % 4),
                              kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(pacc, sm90::desc_kmajor(do_box + (kk / 4) * SM::kResBox, kk % 4),
                              sm90::desc_kmajor(v_box + (kk / 4) * SM::kTileBox, kk % 4),
                              kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      sm90::fence_regs(pacc);

      // accumulator (x): query row0 + 8 ((x >> 1) & 1), key k0 + c.
      // Scores in log2 units less lse, the additive mask joined; hidden
      // pairs at -inf, behind one branch a tile.  A key past the end of a
      // ragged last tile has a zero K row (score 0) and adds ds * 0 to dq;
      // its exponent is capped at kMaxLog2 so that ds stays finite where
      // lse is far below 0 (a row whose every key the mask hides).  A
      // real pair's exponent is at most rounding above 0, so the cap
      // never binds there.
#pragma unroll
      for (int x = 0; x < kK3 / 2; ++x) {
        const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
        sacc[x] = sacc[x] * a.scale_log2 - lse_l2[r];
        if constexpr (MASK) sacc[x] += mask_l2(a, mrow, row0 + 8 * r, k0 + c);
        sacc[x] = fminf(sacc[x], kMaxLog2);
      }
      const bool seg_mask = has_seg && !(wg_uniform && seg_tile[st][0] == seg_tile[st][1] &&
                                         seg_tile[st][0] == own[wg][0]);
      const auto mask = [&](auto with_seg) {
#pragma unroll
        for (int x = 0; x < kK3 / 2; ++x) {
          const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
          bool live = !CAUSAL || k0 + c <= row0 + 8 * r + off;
          if (decltype(with_seg)::value) live = live && segk_s[st][c] == my_seg[r];
          sacc[x] = live ? sacc[x] : -kInf;
        }
      };
      if (seg_mask) {
        mask(std::true_type());
      } else if (CAUSAL && k0 + kK3 - 1 > qw + off) {
        mask(std::false_type());
      }
#pragma unroll
      for (int x = 0; x < kK3 / 2; ++x) {
        const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
        float unused;
        pair_grads<DROP>(a, bh, sacc[x], pacc[x], delta[r], row0 + 8 * r, k0 + c, &unused,
                         &pacc[x]);
      }
      uint32_t sf[kK3 / 16][4];
      to_frags<kK3>(sf, pacc);
      // dQ += dS K, K read MN-major
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK3 / 16; ++kk) mma_rs<D>(dq, sf[kk], k_box, kk, SM::kTileBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
    }
    sm90::mbar_arrive(&t_empty[st]);
    if (warp == 0 && i + kStages3 < n_tiles) {
      sm90::mbar_wait(&t_empty[st], (i / kStages3) & 1);  // both warpgroups are done with it
      load_tile(i + kStages3);
    }
  }

  store_rows<D>(a.dq + b * a.dq_st[0] + h * a.dq_st[1], a.dq_st[2], row0, a.sq, dq);
}

// The operands the TMA maps describe: base and (b, h, s) strides.
struct Operand {
  const void* ptr;
  const int64_t* st;
};

template <int D, bool CAUSAL, bool MASK, bool DROP>
cudaError_t launch(const Args& a, Operand q, Operand k, Operand v, Operand dout,
                   cudaStream_t stream) {
  CUtensorMap k128, v128, q32, do32, q128, do128, k64, v64;
  cudaError_t err;
  const auto map = [&](CUtensorMap* m, Operand t, int rows, int box) {
    return sm90_host::bf16_map_4d(m, t.ptr, a.B, a.H, rows, D, t.st, box);
  };
  if ((err = map(&k128, k, a.sk, kKV2)) != cudaSuccess ||
      (err = map(&v128, v, a.sk, kKV2)) != cudaSuccess ||
      (err = map(&q32, q, a.sq, kQ2)) != cudaSuccess ||
      (err = map(&do32, dout, a.sq, kQ2)) != cudaSuccess ||
      (err = map(&q128, q, a.sq, kQ3)) != cudaSuccess ||
      (err = map(&do128, dout, a.sq, kQ3)) != cudaSuccess ||
      (err = map(&k64, k, a.sk, kK3)) != cudaSuccess ||
      (err = map(&v64, v, a.sk, kK3)) != cudaSuccess)
    return err;

  const int rows = a.B * a.H * a.sq;
  attn_bwd_delta_sm90<D><<<(rows + 7) / 8, 256, 0, stream>>>(a, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = apex::allow_smem(attn_bwd_dkdv_sm90<D, CAUSAL, MASK, DROP>, Smem2<D>::kBytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_sm90<D, CAUSAL, MASK, DROP>
      <<<dim3(a.B * a.H, (a.sk + kKV2 - 1) / kKV2), kThreads, Smem2<D>::kBytes, stream>>>(
          k128, v128, q32, do32, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = apex::allow_smem(attn_bwd_dq_sm90<D, CAUSAL, MASK, DROP>, Smem3<D>::kBytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_sm90<D, CAUSAL, MASK, DROP>
      <<<dim3(a.B * a.H, (a.sq + kQ3 - 1) / kQ3), kThreads, Smem3<D>::kBytes, stream>>>(
          q128, do128, k64, v64, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(bool causal, bool mask, bool drop, const Args& a, Operand q, Operand k,
                     Operand v, Operand dout, cudaStream_t s) {
  if (causal) {
    if (mask) {
      return drop ? launch<D, true, true, true>(a, q, k, v, dout, s)
                  : launch<D, true, true, false>(a, q, k, v, dout, s);
    }
    return drop ? launch<D, true, false, true>(a, q, k, v, dout, s)
                : launch<D, true, false, false>(a, q, k, v, dout, s);
  }
  if (mask) {
    return drop ? launch<D, false, true, true>(a, q, k, v, dout, s)
                : launch<D, false, true, false>(a, q, k, v, dout, s);
  }
  return drop ? launch<D, false, false, true>(a, q, k, v, dout, s)
              : launch<D, false, false, false>(a, q, k, v, dout, s);
}

}  // namespace

extern "C" {

// bf16 only; d: head dim (64 or 128).  strides: (b, h, s) of q, k, v, o,
// do, dq, dk, dv, then the mask's (b, h, row, col), in elements (28
// values); every operand has a unit last stride, 16-byte aligned rows and
// a zero stride only where its dimension has size 1.  lse and the delta
// workspace are [B*H, sq] fp32.  mask, seg_q/seg_k and visits may be
// null; seg row = (b*H + h) / seg_div.  visits, when given, is int32
// [B*H*ceil(sk/128)] (pass 2) then [B*H*ceil(sq/128)] (pass 3).  thresh =
// round(rate * 2^32) and inv_keep = 1 / (1 - rate) (thresh 0 and inv_keep
// 1: no dropout).  Launches three kernels in order on `stream`; returns
// the first launch error, or cudaSuccess.
int flash_bwd_sm90(int d, int device, const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, const float* mask, const int* seg_q, const int* seg_k,
                   int seg_div, int* visits, int B, int H, int sq, int sk,
                   const int64_t* strides, float scale, int causal, uint32_t seed,
                   uint32_t thresh, float inv_keep, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (sq <= 0 || sk <= 0 || B * H <= 0) return cudaSuccess;
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
         delta, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
         static_cast<__nv_bfloat16*>(dv), mask, seg_q, seg_k, seg_div, visits, B, H, sq, sk,
         scale, scale * kLog2e, seed, thresh, inv_keep};
  int64_t* dst[5] = {a.o_st, a.do_st, a.dq_st, a.dk_st, a.dv_st};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[9 + 3 * t + i];
  for (int i = 0; i < 4; ++i) a.m_st[i] = strides[24 + i];
  const Operand oq{q, strides}, ok{k, strides + 3}, ov{v, strides + 6}, odo{dout, strides + 12};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = !(thresh == 0 && inv_keep == 1.f);
  if (d == 64) return dispatch<64>(causal != 0, mask != nullptr, drop, a, oq, ok, ov, odo, st);
  return dispatch<128>(causal != 0, mask != nullptr, drop, a, oq, ok, ov, odo, st);
}

}  // extern "C"
