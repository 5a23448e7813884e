// Packed-QKV self-attention backward for GPT training, on Hopper's tensor
// cores (sm_90a: wgmma and TMA).  The bf16 route of K4; flash_qkv_bwd.cu
// stays the fp32 route.
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_qkv_bwd_pallas:
// from (qkv, dctx, ctx, lse) it writes dqkv [b, s, H * 3 * d] in qkv's
// Megatron-interleaved layout.  Per visible (query r, key c):
//   p  = exp(q.k * scale - lse[r])                    (undropped)
//   dp = dctx[r] . v[c]
//   with dropout: p~ = keep ? p / (1 - rate) : 0, dp~ = keep ? dp / (1 - rate) : 0
//   dv[c] += p~ dctx[r];  ds = p (dp~ - delta[r]) scale;  dk[c] += ds q[r];  dq[r] += ds k[c]
// with delta[r] = dctx[r] . ctx[r] and the keep bits redrawn from the
// forward's counter hash at the same global (row = query, col = key).  p~
// and ds are rounded to bf16 before they multiply (the JAX kernel's
// p_drop.astype(do.dtype) and ds.astype(q.dtype)); every sum is fp32.
//
// What bounds it on an H100: at the GPT-1.3B training shape (b = 4, s =
// 2048, 16 heads of 128, causal) it moves ~168 MB (~0.05 ms at 3.35 TB/s)
// and, with the scores recomputed in the dq pass, does seven products per
// visible pair (~241 GFLOP, ~0.24 ms at 989 TFLOP/s; the JAX count of five
// is ~0.17 ms): bound by operations, so every product runs on the tensor
// cores by wgmma, fed by TMA.  Seven products instead of five cap this
// design at 5/7 of the floor; spilling dS, or dq partials with an ordered
// reduction, would remove the recompute.  At BERT-large's padded shape (b = 16, s
// = 512, 16 heads of 64, key padding, not causal) it moves ~135 MB (~0.040
// ms) for ~29 GFLOP (~0.030 ms): bound by bytes there.
//
// Design: three launches, each output owned by one block, no atomics, so
// two runs give bitwise-equal gradients.
//   1. qkv_bwd_delta_sm90: delta = rowsum(dctx * ctx) in fp32, a warp a row.
//   2. qkv_bwd_dkdv_sm90: one block per (128-key tile, batch*head), two
//      warpgroups of 64 keys each with their K and V resident in shared
//      memory; warp 0 also streams 32-query Q and dO tiles (with their
//      lse, delta and segment ids) through a ring of four stages.  The
//      transposed products S^T = K Q^T and dP^T = V dO^T put a key on each
//      accumulator row and a query on each column, so P~^T and dS^T land
//      in accumulator layout and feed dV += P~^T dO and dK += dS^T Q as
//      register A fragments (dO and Q as MN-major B).  It walks the live
//      query tiles: the transposed segment rule, and under the causal mask
//      from the tile holding query k0 on.
//   3. qkv_bwd_dq_sm90: one block per (128-query tile, batch*head), two
//      warpgroups of 64 rows with Q and dO resident, K/V tiles of 64 keys
//      streamed by warp 0 through three stages; S and dP recomputed, dQ +=
//      dS K (K as MN-major B).  It walks the forward's live key tiles, cut
//      at the causal limit.
// No producer-only warp: a ninth warp would put three warps on one of the
// SM's four register-file partitions and cap every thread at 168
// registers, which dK and dV's accumulators do not fit.
// Passes 2 and 3 write, when given `visits`, how many tiles each block
// walked ([B*H*n_k128] for pass 2, then [B*H*n_q128] for pass 3), so a
// caller can hold the skip rule against a plain statement of it.  Rows of
// a ragged last tile arrive as zeros (TMA); a query past the end or one
// that saw no key carries lse = +inf into the kernel, so its p is 0.
// Elementwise work as in the forward: masks behind one branch a tile,
// hidden pairs at -inf, p by ex2.approx.
//
// Template on the head dim D, built at 128 (GPT) and 64 (BERT-large): one
// entry point each, so that launches count by instance.  At D = 64 the
// resident and streamed tiles are one 64-column box, dV, dK and dQ are
// m64n64k16 products and a thread holds 32 sums of each; the tiles
// (QKV_SM90_BWD_TILES), rings and warpgroups are those of D = 128.

#include <climits>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInf = __builtin_huge_valf();

// pass 2: keys a block (64 a warpgroup), queries a streamed tile, stages
constexpr int kKV2 = 128, kQ2 = 32, kStages2 = 4;
// pass 3: queries a block (64 a warpgroup), keys a streamed tile, stages
constexpr int kQ3 = 128, kK3 = 64, kStages3 = 3;

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

struct BwdArgs {
  const __nv_bfloat16* dctx;
  const __nv_bfloat16* ctx;
  const float* lse;  // [B*H, s]
  float* delta;      // [B*H, s] workspace
  __nv_bfloat16* dqkv;
  const int* seg_q;  // null: no segments
  const int* seg_k;
  int seg_div;
  int* visits;       // null, or tiles walked per block
  int B, H, s;
  float scale, scale_log2;
  uint32_t seed, thresh;
  float inv_keep;    // 1 / (1 - rate)
};

template <int D>
__global__ void __launch_bounds__(256) qkv_bwd_delta_sm90(BwdArgs a, int rows) {
  const int w = (blockIdx.x * 256 + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= rows) return;
  const int bh = w / a.s, r = w % a.s, b = bh / a.H, h = bh % a.H;
  const int64_t off = (static_cast<int64_t>(b) * a.s + r) * a.H * D + h * D;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.dctx + off + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.ctx + off + c));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) a.delta[w] = acc;
}

// d[64 x D] += A[64 x 16] B[16 x D], A from registers, B MN-major from
// `box` (its D columns in 64-column boxes `box_bytes` apart).
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint32_t box,
                                       int k, uint32_t box_bytes) {
  static_assert(D == 64 || D == 128, "head dims 64 and 128 are built");
  if constexpr (D == 128) {
    sm90::wgmma_rs_n128<1>(d, a, sm90::desc_mnmajor(box, k, box_bytes), 1);
  } else {
    sm90::wgmma_rs_n64<1>(d, a, sm90::desc_mnmajor(box, k, box_bytes), 1);
  }
}

// Of one pair, from its score in log2 units less lse (-inf where the pair
// is hidden or the query saw no key, so p = 0): p~ and ds.
template <bool DROP>
__device__ __forceinline__ void pair_grads(const BwdArgs& a, int bh, float s, float dp,
                                           float delta, int query, int key, float* pd,
                                           float* ds) {
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

// ---------------------------------------------------------------------------
// pass 2: dK and dV of one 128-key tile of one batch*head

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    qkv_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_kv,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
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
  const int nkeys = min(kKV2, a.s - k0);
  const int n_qt = (a.s + kQ2 - 1) / kQ2;
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.s : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.s : nullptr;

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
    sm90::live_tiles(sq_row, a.s, kQ2, own, &t_lo, &t_hi);
    lo = t_lo;
    hi = t_hi;
  } else {
    __syncthreads();
  }
  if (CAUSAL) lo = max(lo, min(n_qt, k0 / kQ2));
  if (a.visits != nullptr && tid == 0)
    a.visits[static_cast<int64_t>(bh) * gridDim.y + kb] = max(0, hi - lo);

  // warp 0 loads: K and V once, then query tile i of the walk into stage
  // i % kStages2 once that stage is free, with the tile's lse (log2 units;
  // +inf where the query is past the end or saw no key, so its p is 0),
  // delta and segment ids
  const int col = h * 3 * D;
  const int n_tiles = max(0, hi - lo);
  const auto issue = [&](int i) {
    const int st = i % kStages2, c0 = (lo + i) * kQ2;
    const int q = c0 + lane;
    float lv = kInf, dv = 0.f;
    int sv = INT_MIN;
    if (q < a.s) {
      const float x = a.lse[static_cast<int64_t>(bh) * a.s + q];
      lv = x > kNegInf / 2 ? x * kLog2e : kInf;
      dv = a.delta[static_cast<int64_t>(bh) * a.s + q];
      if (has_seg) sv = sq_row[q];
    }
    lse_s[st][lane] = lv;
    delta_s[st][lane] = dv;
    if (has_seg) {
      segq_s[st][lane] = sv;
      int mn = q < a.s ? sv : INT_MAX, mx = q < a.s ? sv : INT_MIN;
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
        sm90::tma_load_3d(Qs + st * SM::kTileBytes + x * SM::kTileBox, &tm_q, &t_full[st],
                          col + 64 * x, c0, b);
        sm90::tma_load_3d(dOs + st * SM::kTileBytes + x * SM::kTileBox, &tm_do, &t_full[st],
                          h * D + 64 * x, c0, b);
      }
    }
    __syncwarp();
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_expect_tx(&kv_full, 2 * SM::kResBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_3d(Ks + x * SM::kResBox, &tm_kv, &kv_full, col + D + 64 * x, k0, b);
        sm90::tma_load_3d(Vs + x * SM::kResBox, &tm_kv, &kv_full, col + 2 * D + 64 * x, k0, b);
      }
    }
    for (int i = 0; i < min(n_tiles, kStages2); ++i) issue(i);  // the ring starts empty
  }

  // -- warpgroup wg: keys k0 + 64 wg .. + 63 ----------------------------------
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int kw = k0 + 64 * wg;
  const int key0 = kw + 16 * (warp & 3) + g;  // this thread's keys: key0, key0 + 8
  int my_seg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) my_seg[r] = key0 + 8 * r < a.s ? sk_row[key0 + 8 * r] : INT_MAX;
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
    if (!CAUSAL || c0 + kQ2 - 1 >= kw) {
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

      // accumulator (x): key key0 + 8 ((x >> 1) & 1), query c0 + c.  Scores
      // in log2 units less lse; hidden pairs at -inf, behind one branch a
      // tile (a branch inside the element loop costs a convergence
      // barrier per element)
#pragma unroll
      for (int x = 0; x < kQ2 / 2; ++x) {
        const int c = 8 * (x >> 2) + 2 * t + (x & 1);
        sacc[x] = sacc[x] * a.scale_log2 - lse_s[st][c];
      }
      const bool seg_mask = has_seg && !(wg_uniform && seg_tile[st][0] == seg_tile[st][1] &&
                                         seg_tile[st][0] == own[wg][0]);
      const auto mask = [&](auto with_seg) {
#pragma unroll
        for (int x = 0; x < kQ2 / 2; ++x) {
          const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
          bool live = !CAUSAL || key0 + 8 * r <= c0 + c;
          if (decltype(with_seg)::value) live = live && segq_s[st][c] == my_seg[r];
          sacc[x] = live ? sacc[x] : -kInf;
        }
      };
      if (seg_mask) {
        mask(std::true_type());
      } else if (CAUSAL && c0 < kw + 63) {
        mask(std::false_type());
      }
#pragma unroll
      for (int x = 0; x < kQ2 / 2; ++x) {
        const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
        pair_grads<DROP>(a, bh, sacc[x], pacc[x], delta_s[st][c], c0 + c, key0 + 8 * r,
                         &sacc[x], &pacc[x]);
      }
      uint32_t pf[kQ2 / 16][4], sf[kQ2 / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQ2 / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pf[kk][u] = sm90::pack_bf16(sacc[8 * kk + 2 * u], sacc[8 * kk + 2 * u + 1]);
          sf[kk][u] = sm90::pack_bf16(pacc[8 * kk + 2 * u], pacc[8 * kk + 2 * u + 1]);
        }
      }
      // dV += P~^T dO and dK += dS^T Q, dO and Q read MN-major
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ2 / 16; ++kk)
        mma_rs<D>(dv, pf[kk], do_box, kk, SM::kTileBox);
#pragma unroll
      for (int kk = 0; kk < kQ2 / 16; ++kk)
        mma_rs<D>(dk, sf[kk], q_box, kk, SM::kTileBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
    }
    sm90::mbar_arrive(&t_empty[st]);
    if (warp == 0 && i + kStages2 < n_tiles) {
      sm90::mbar_wait(&t_empty[st], (i / kStages2) & 1);  // both warpgroups are done with it
      issue(i + kStages2);
    }
  }

  // epilogue: dk and dv into dqkv at the packed offsets of k and v
  const int64_t row = static_cast<int64_t>(a.H) * 3 * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.s) continue;
    __nv_bfloat16* out = a.dqkv + (static_cast<int64_t>(b) * a.s + key) * row + h * 3 * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + D + 8 * j) =
          sm90::pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(out + 2 * D + 8 * j) =
          sm90::pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: dQ of one 128-query tile of one batch*head

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    qkv_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_kv, const BwdArgs a) {
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
  const int qb = CAUSAL ? n_qb - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kQ3;
  const int nrows = min(kQ3, a.s - q0);
  const int n_kt = (a.s + kK3 - 1) / kK3;
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.s : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.s : nullptr;

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
    sm90::live_tiles(sk_row, a.s, kK3, own, &t_lo, &t_hi);
    lo = t_lo;
    hi = t_hi;
  } else {
    __syncthreads();
  }
  if (CAUSAL) hi = min(hi, (q0 + nrows - 1) / kK3 + 1);
  if (a.visits != nullptr && tid == 0) {
    const int64_t kv_blocks = static_cast<int64_t>(a.B) * a.H * ((a.s + kKV2 - 1) / kKV2);
    a.visits[kv_blocks + static_cast<int64_t>(bh) * n_qb + qb] = max(0, hi - lo);
  }

  // warp 0 loads: Q and dO once, then key tile i of the walk into stage
  // i % kStages3 (its ids, with segments, into segk_s) once that stage is
  // free
  const int col = h * 3 * D;
  const int n_tiles = max(0, hi - lo);
  const auto issue = [&](int i) {
    const int st = i % kStages3, k0 = (lo + i) * kK3;
    if (has_seg) sm90::stage_ids(sk_row, k0, kK3, a.s, segk_s[st], seg_tile[st]);
    if (lane == 0) {
      sm90::mbar_expect_tx(&t_full[st], 2 * SM::kTileBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_3d(Ks + st * SM::kTileBytes + x * SM::kTileBox, &tm_kv, &t_full[st],
                          col + D + 64 * x, k0, b);
        sm90::tma_load_3d(Vs + st * SM::kTileBytes + x * SM::kTileBox, &tm_kv, &t_full[st],
                          col + 2 * D + 64 * x, k0, b);
      }
    }
    __syncwarp();
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_expect_tx(&q_full, 2 * SM::kResBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_3d(Qs + x * SM::kResBox, &tm_q, &q_full, col + 64 * x, q0, b);
        sm90::tma_load_3d(dOs + x * SM::kResBox, &tm_do, &q_full, h * D + 64 * x, q0, b);
      }
    }
    for (int i = 0; i < min(n_tiles, kStages3); ++i) issue(i);  // the ring starts empty
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
    if (q < a.s) {
      const float x = a.lse[static_cast<int64_t>(bh) * a.s + q];
      lse_l2[r] = x > kNegInf / 2 ? x * kLog2e : kInf;
      delta[r] = a.delta[static_cast<int64_t>(bh) * a.s + q];
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
    if (!CAUSAL || k0 <= qw + 63) {
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

      // accumulator (x): query row0 + 8 ((x >> 1) & 1), key k0 + c.  Scores
      // in log2 units less lse; hidden pairs at -inf, behind one branch a
      // tile.  Keys past the end need no mask: their K and V rows are
      // zeros, so they add nothing to dq.
#pragma unroll
      for (int x = 0; x < kK3 / 2; ++x) sacc[x] = sacc[x] * a.scale_log2 - lse_l2[(x >> 1) & 1];
      const bool seg_mask = has_seg && !(wg_uniform && seg_tile[st][0] == seg_tile[st][1] &&
                                         seg_tile[st][0] == own[wg][0]);
      const auto mask = [&](auto with_seg) {
#pragma unroll
        for (int x = 0; x < kK3 / 2; ++x) {
          const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
          bool live = !CAUSAL || k0 + c <= row0 + 8 * r;
          if (decltype(with_seg)::value) live = live && segk_s[st][c] == my_seg[r];
          sacc[x] = live ? sacc[x] : -kInf;
        }
      };
      if (seg_mask) {
        mask(std::true_type());
      } else if (CAUSAL && k0 + kK3 - 1 > qw) {
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
#pragma unroll
      for (int kk = 0; kk < kK3 / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sf[kk][u] = sm90::pack_bf16(pacc[8 * kk + 2 * u], pacc[8 * kk + 2 * u + 1]);
      }
      // dQ += dS K, K read MN-major
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK3 / 16; ++kk)
        mma_rs<D>(dq, sf[kk], k_box, kk, SM::kTileBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
    }
    sm90::mbar_arrive(&t_empty[st]);
    if (warp == 0 && i + kStages3 < n_tiles) {
      sm90::mbar_wait(&t_empty[st], (i / kStages3) & 1);  // both warpgroups are done with it
      issue(i + kStages3);
    }
  }

  const int64_t row = static_cast<int64_t>(a.H) * 3 * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= a.s) continue;
    __nv_bfloat16* out = a.dqkv + (static_cast<int64_t>(b) * a.s + q) * row + h * 3 * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          sm90::pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

template <int D, bool CAUSAL, bool DROP>
cudaError_t launch(const BwdArgs& a, const void* qkv, cudaStream_t stream) {
  const int64_t w = static_cast<int64_t>(a.H) * 3 * D, wc = static_cast<int64_t>(a.H) * D;
  CUtensorMap kv128, q32, do32, q128, do128, kv64;
  cudaError_t err;
  if ((err = sm90_host::bf16_map(&kv128, qkv, a.B, a.s, w, kKV2)) != cudaSuccess ||
      (err = sm90_host::bf16_map(&q32, qkv, a.B, a.s, w, kQ2)) != cudaSuccess ||
      (err = sm90_host::bf16_map(&do32, a.dctx, a.B, a.s, wc, kQ2)) != cudaSuccess ||
      (err = sm90_host::bf16_map(&q128, qkv, a.B, a.s, w, kQ3)) != cudaSuccess ||
      (err = sm90_host::bf16_map(&do128, a.dctx, a.B, a.s, wc, kQ3)) != cudaSuccess ||
      (err = sm90_host::bf16_map(&kv64, qkv, a.B, a.s, w, kK3)) != cudaSuccess)
    return err;

  const int rows = a.B * a.H * a.s;
  qkv_bwd_delta_sm90<D><<<(rows + 7) / 8, 256, 0, stream>>>(a, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = apex::allow_smem(qkv_bwd_dkdv_sm90<D, CAUSAL, DROP>, Smem2<D>::kBytes);
  if (err != cudaSuccess) return err;
  qkv_bwd_dkdv_sm90<D, CAUSAL, DROP>
      <<<dim3(a.B * a.H, (a.s + kKV2 - 1) / kKV2), kThreads, Smem2<D>::kBytes, stream>>>(
          kv128, q32, do32, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = apex::allow_smem(qkv_bwd_dq_sm90<D, CAUSAL, DROP>, Smem3<D>::kBytes);
  if (err != cudaSuccess) return err;
  qkv_bwd_dq_sm90<D, CAUSAL, DROP>
      <<<dim3(a.B * a.H, (a.s + kQ3 - 1) / kQ3), kThreads, Smem3<D>::kBytes, stream>>>(
          q128, do128, kv64, a);
  return cudaGetLastError();
}

}  // namespace

namespace {

template <int D>
int run(int device, const void* qkv, const void* dctx, const void* ctx, const float* lse,
        float* delta, void* dqkv, const int* seg_q, const int* seg_k, int seg_div, int* visits,
        int B, int H, int s, float scale, int causal, uint32_t seed, uint32_t thresh,
        float inv_keep, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (s <= 0 || B * H <= 0) return cudaSuccess;
  const BwdArgs a{static_cast<const __nv_bfloat16*>(dctx), static_cast<const __nv_bfloat16*>(ctx),
                  lse, delta, static_cast<__nv_bfloat16*>(dqkv), seg_q, seg_k, seg_div, visits,
                  B, H, s, scale, scale * kLog2e, seed, thresh, inv_keep};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = !(thresh == 0 && inv_keep == 1.f);
  if (causal) {
    return drop ? launch<D, true, true>(a, qkv, st) : launch<D, true, false>(a, qkv, st);
  }
  return drop ? launch<D, false, true>(a, qkv, st) : launch<D, false, false>(a, qkv, st);
}

}  // namespace

extern "C" {

// bf16 only; d: head dim (128 here, 64 in flash_qkv_bwd_sm90_d64).
// qkv/dqkv [B, s, H*3*d], ctx/dctx [B, s, H*d] (all contiguous, 16-byte
// aligned), lse and the delta workspace [B*H, s] fp32.  seg_q/seg_k may be
// null; seg row = (b*H + h) / seg_div.  visits may be null, else int32
// [B*H*ceil(s/128)] (pass 2) then [B*H*ceil(s/128)] (pass 3).  thresh =
// round(rate * 2^32) and inv_keep = 1 / (1 - rate) (thresh 0 and inv_keep
// 1: no dropout).  Launches three kernels in order on `stream`; returns
// the first launch error, or cudaSuccess.
int flash_qkv_bwd_sm90(int d, int device, const void* qkv, const void* dctx, const void* ctx,
                       const float* lse, float* delta, void* dqkv, const int* seg_q,
                       const int* seg_k, int seg_div, int* visits, int B, int H, int s,
                       float scale, int causal, uint32_t seed, uint32_t thresh, float inv_keep,
                       void* stream) {
  if (d != 128) return cudaErrorInvalidValue;
  return run<128>(device, qkv, dctx, ctx, lse, delta, dqkv, seg_q, seg_k, seg_div, visits, B, H,
                  s, scale, causal, seed, thresh, inv_keep, stream);
}

// The same at head dim 64 (d must be 64).
int flash_qkv_bwd_sm90_d64(int d, int device, const void* qkv, const void* dctx,
                           const void* ctx, const float* lse, float* delta, void* dqkv,
                           const int* seg_q, const int* seg_k, int seg_div, int* visits, int B,
                           int H, int s, float scale, int causal, uint32_t seed, uint32_t thresh,
                           float inv_keep, void* stream) {
  if (d != 64) return cudaErrorInvalidValue;
  return run<64>(device, qkv, dctx, ctx, lse, delta, dqkv, seg_q, seg_k, seg_div, visits, B, H,
                 s, scale, causal, seed, thresh, inv_keep, stream);
}

}  // extern "C"
