// Generic flash attention forward on Hopper's tensor cores (sm_90a: wgmma
// and TMA): the bf16 route of K1 at head dims 64 and 128, under the
// serving prefill and the multi-head attention modules.  flash_fwd.cu
// stays the route for fp32 and for head dim 8.
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_fwd_pallas:
// o = softmax(q k^T * scale + mask + masks) v and the fp32 log-sum-exp of
// every row, with the masks in _apply_masks' order: the additive fp32 mask
// first, then segment ids, then the causal mask aligned to the end of the
// keys (query r sees keys <= r + sk - sq); optional attention dropout.  A
// row that sees no key has o exactly 0 and lse -1e30.  q [B, H, sq, d],
// k/v [B, H, sk, d], o [B, H, sq, d] with any strides whose last one is 1.
//
// What bounds it on an H100: at the multi-head attention path's encoder
// shape ([32, 16, 256, 64], key padding) it must read q, k, v once and
// write o and lse once (~0.016 ms at 3.35 TB/s) and does four flops of d
// per visible pair (~0.006 ms at 989 TFLOP/s); at the serving prefill's
// ([1, 16, 1024, 128], causal, segments) ~0.005 ms either way.  Bound by
// bytes at the roof, so loads stay in flight (TMA, a ring of stages) and
// both products run on the tensor cores so that the softmax hides under
// them.
//
// Design: packed-QKV K3's (flash_qkv_fwd_sm90.cu), generalized as K2's
// tensor-core route (flash_bwd_sm90.cu) generalized K4.  One block per
// (128-query tile, batch*head): two consumer warpgroups of 64 rows; thread
// 0 loads the Q tile once by TMA before the segment scan, and warp 0 then
// loads 128-key K and V tiles through a ring of two stages with full/empty
// mbarriers, refilling a stage as soon as both warpgroups have released
// it (at head dim 64 a tile is taken in two 64-key softmax steps where
// two blocks fit an SM: two_steps below).  A warpgroup computes S = Q K^T by
// wgmma from shared memory (K-major: d contiguous in both), runs the
// online softmax in registers on the accumulator layout, converts P to
// bf16 A fragments in registers (the JAX kernel's rounding point:
// p.astype(v.dtype) before P V) and adds P V by wgmma with V as an
// MN-major B read through the transpose bit.  No atomics and no split
// over keys: two runs give the same bits.
// Operands: every TMA map is built from the tensor's own (d, s, h, b)
// strides (sm90_host::bf16_map_4d), so the prefill's views of its fused
// projection and the modules' permuted views load without a copy; rows of
// a ragged last tile arrive as zeros and are hidden (keys) or not stored
// (queries); o is stored through its own strides.  The fp32 mask is read
// through its four strides, any of which may be 0 (a broadcast TMA cannot
// describe), by the consumer threads at their own accumulator elements
// after the step's score product, as selects (add_mask).  Segment ids
// [rows, s] (row = bh / seg_div) give each block its live key tiles
// before any K/V load (the _segment_block_bounds rule, sm90::live_tiles),
// cut at the causal limit; `visits`, when given, receives how many tiles
// each block walked, so a caller can hold the rule against a plain
// statement of it.
// Numerics: the running max and lse are kept in natural-log units of
// (s * scale + mask), as the plain version computes them, and only the
// exponent (x - m) * log2(e) goes through ex2.approx; a base-2 running max
// would move lse by an ulp of |lse| where an additive mask puts it near
// -1e4, and rows whose max such a mask puts at |m| >= kExactFrom take
// their scores as one fp32 FMA chain, the plain version's rounding.
// Masks are applied behind one branch a step (a branch inside the
// element loop costs a convergence barrier per element); a hidden score
// is -inf, whose p is 0.  As on the TPU (_make_fwd_kernel) p enters the
// running sum l before dropout, and a kept p is scaled by 1 / (1 - rate)
// before it is rounded; keep bits come from the counter hash at the
// global (bh, row, col), so the backward redraws them.  Heavier q tiles
// (causal: later rows) are scheduled first.
// The causal mask, the additive mask and dropout are template flags, as in
// the scalar K1: an instance carries no code for what it does not do.

#include <climits>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;          // query rows of a block (64 a warpgroup)
constexpr int kBK = 128;          // keys of a streamed tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;     // warpgroups, each consuming every tile
constexpr int kThreads = 128 * kConsumers;
constexpr float kNegInf = -1e30f;  // the running max of a row that saw nothing
constexpr float kInf = __builtin_huge_valf();
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kExactFrom = 256.f;  // |row max| from which scores take the FMA chain

// Instances that take each 128-key tile in two softmax steps of 64 keys,
// so that the S accumulators (32 registers a thread, not 64) leave room
// for two blocks an SM (128 registers a thread), one block's loads and
// segment scan overlapping the other's products: head dim 64, but for
// dropout (its keep-bit hash) and the additive mask without the causal
// mask, which ptxas spills at 128 registers.  The rest run one block an
// SM (at head dim 128: 160 KB of shared memory a block), one step a tile.
__host__ __device__ constexpr bool two_steps(int d, bool causal, bool mask, bool drop) {
  return d == 64 && !drop && (causal || !mask);
}

template <int D>
struct Smem {
  static constexpr int kQBytes = kBQ * D * 2;     // D / 64 boxes of [kBQ, 64]
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kBoxBytes = kBK * 128;     // one [kBK, 64] box of it
  static constexpr size_t kBytes = kQBytes + 2 * kStages * kTileBytes + 1024;
};

struct Args {
  __nv_bfloat16* o;
  float* lse;         // [B*H, sq]
  const float* mask;  // null: none
  const int* seg_q;   // null: no segments
  const int* seg_k;
  int seg_div;
  int* visits;        // null, or tiles walked per block [B*H, ceil(sq/128)]
  int B, H, sq, sk;
  float scale;
  uint32_t seed, thresh;
  float inv_keep;     // 1 / (1 - rate)
  // strides in elements: o (b, h, s); mask (b, h, row, col)
  int64_t o_st[3], m_st[4];
};

// q[qr] . k[kr] of a Q and a K tile in shared memory (kBQ = kBK rows a
// box of 64 bf16 columns, 128-byte swizzle: see sm90.cuh) as one fp32 FMA
// chain over d in column order.
static_assert(kBQ == kBK, "dot_chain reads Q and K boxes of one size");
template <int D>
__device__ __forceinline__ float dot_chain(const uint8_t* qs, int qr, const uint8_t* ks, int kr) {
  float s = 0.f;
#pragma unroll 1
  for (int c8 = 0; c8 < D / 8; ++c8) {
    const int box = (c8 / 8) * kBQ * 128, chunk = c8 % 8;
    const uint4 qv =
        *reinterpret_cast<const uint4*>(qs + box + qr * 128 + ((chunk ^ (qr & 7)) << 4));
    const uint4 kv =
        *reinterpret_cast<const uint4*>(ks + box + kr * 128 + ((chunk ^ (kr & 7)) << 4));
    const __nv_bfloat162* qh = reinterpret_cast<const __nv_bfloat162*>(&qv);
    const __nv_bfloat162* kh = reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 qf = __bfloat1622float2(qh[u]), kf = __bfloat1622float2(kh[u]);
      s = fmaf(qf.x, kf.x, s);
      s = fmaf(qf.y, kf.y, s);
    }
  }
  return s;
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], both K-major through descriptors.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 128) {
    sm90::wgmma_ss_n128<0>(d, da, db, acc);
  } else {
    sm90::wgmma_ss_n64<0>(d, da, db, acc);
  }
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

template <int D, bool CAUSAL, bool MASK, bool DROP>
__global__ void __launch_bounds__(kThreads, two_steps(D, CAUSAL, MASK, DROP) ? 2 : 1)
    attn_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using SM = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = sm90::align1024(smem_raw);
  uint8_t* const Ks = Qs + SM::kQBytes;                // [kStages][tile]
  uint8_t* const Vs = Ks + kStages * SM::kTileBytes;   // [kStages][tile]
  __shared__ __align__(8) uint64_t q_full, kv_full[kStages], kv_empty[kStages];
  __shared__ int seg_cols[kStages][kBK];  // with segments: each stage's key ids
  __shared__ int seg_tile[kStages][2];    // and their [min, max]
  __shared__ int own[kConsumers][2];      // [min, max] of each warpgroup's rows
  __shared__ int kb_lo, kb_hi;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int n_qb = gridDim.y;
  const int qb = CAUSAL ? n_qb - 1 - blockIdx.y : blockIdx.y;  // the longest walks first
  const int q0 = qb * kBQ;
  const int nrows = min(kBQ, a.sq - q0);
  const int n_kb = (a.sk + kBK - 1) / kBK;
  const int off = a.sk - a.sq;  // causal: query r sees keys <= r + off
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.sq : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.sk : nullptr;
  const float* mrow = MASK ? a.mask + b * a.m_st[0] + h * a.m_st[1] : nullptr;

  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&kv_full[i], 1);
      sm90::mbar_init(&kv_empty[i], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
    // Q first: it does not wait for the segment scan
    sm90::mbar_expect_tx(&q_full, SM::kQBytes);
#pragma unroll
    for (int x = 0; x < D / 64; ++x)
      sm90::tma_load_4d(Qs + x * kBQ * 128, &tm_q, &q_full, 64 * x, q0, h, b);
  }
  // the live key tiles: the segment rule, then the causal limit
  int lo = 0, hi = n_kb;
  if (has_seg) {
    sm90::own_intervals(sq_row, q0, nrows, own);
    sm90::live_tiles(sk_row, a.sk, kBK, own, &kb_lo, &kb_hi);
    lo = kb_lo;
    hi = kb_hi;
  } else {
    __syncthreads();
  }
  if (CAUSAL) {
    const int last = q0 + nrows - 1 + off;  // the last key the block's last query sees
    hi = min(hi, last >= 0 ? last / kBK + 1 : 0);
  }
  const int n_tiles = max(0, hi - lo);
  if (a.visits != nullptr && tid == 0)
    a.visits[static_cast<int64_t>(bh) * n_qb + qb] = n_tiles;

  // warp 0 loads key tile i of the walk into stage i % kStages (its ids,
  // with segments, into seg_cols) once that stage is free
  const auto issue = [&](int i) {
    const int st = i % kStages, k0 = (lo + i) * kBK;
    if (has_seg) sm90::stage_ids(sk_row, k0, kBK, a.sk, seg_cols[st], seg_tile[st]);
    if (lane == 0) {
      sm90::mbar_expect_tx(&kv_full[st], 2 * SM::kTileBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_4d(Ks + st * SM::kTileBytes + x * SM::kBoxBytes, &tm_k, &kv_full[st],
                          64 * x, k0, h, b);
        sm90::tma_load_4d(Vs + st * SM::kTileBytes + x * SM::kBoxBytes, &tm_v, &kv_full[st],
                          64 * x, k0, h, b);
      }
    }
    __syncwarp();
  };
  if (warp == 0)
    for (int i = 0; i < min(n_tiles, kStages); ++i) issue(i);  // the ring starts empty

  // -- warpgroup wg: query rows q0 + 64 wg .. + 63 ---------------------------
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;                  // first row of the warpgroup
  const int row0 = qw + 16 * (warp & 3) + g;    // this thread's rows: row0, row0 + 8
  int my_seg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) my_seg[r] = row0 + 8 * r < a.sq ? sq_row[row0 + 8 * r] : INT_MAX;
  }
  const bool wg_uniform = has_seg && own[wg][0] == own[wg][1];

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  constexpr int kSub = two_steps(D, CAUSAL, MASK, DROP) ? 64 : 128;  // keys of a softmax step
  float sacc[kSub / 2];
#pragma unroll
  for (int i = 0; i < kSub / 2; ++i) sacc[i] = 0.f;

  // Add the additive mask at this thread's accumulator elements of the
  // step from key kc, read through the mask's strides.  A row past sq
  // reads row 0's values (it is never stored); a key past sk reads
  // nothing (its score is hidden later).  A select, not a branch, an
  // element.
  const auto add_mask = [&](int kc) {
    if (a.m_st[3] == 1) {
      // unit column stride (every mask the modules build): a pointer a
      // row, the elements at immediate offsets from it
      const float* mr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r < a.sq ? row0 + 8 * r : 0;
        mr[r] = mrow + row * a.m_st[2] + kc + 2 * t;
      }
      if (kc + kSub <= a.sk) {  // the whole step lies inside the keys
#pragma unroll
        for (int x = 0; x < kSub / 2; ++x)
          sacc[x] = __fadd_rn(sacc[x], mr[(x >> 1) & 1][8 * (x >> 2) + (x & 1)]);
        return;
      }
#pragma unroll
      for (int x = 0; x < kSub / 2; ++x) {
        const int c = 8 * (x >> 2) + (x & 1);
        sacc[x] = __fadd_rn(sacc[x], kc + 2 * t + c < a.sk ? mr[(x >> 1) & 1][c] : 0.f);
        if ((x & 7) == 7) asm volatile("" ::: "memory");  // 8 loads in flight
      }
      return;
    }
    // any strides (rare): 8 loads in flight, each with its own address
#pragma unroll
    for (int x = 0; x < kSub / 2; ++x) {
      const int row = row0 + 8 * ((x >> 1) & 1), key = kc + 8 * (x >> 2) + 2 * t + (x & 1);
      sacc[x] = __fadd_rn(sacc[x], row < a.sq && key < a.sk
                                       ? mrow[row * a.m_st[2] + key * a.m_st[3]]
                                       : 0.f);
      if ((x & 7) == 7) asm volatile("" ::: "memory");
    }
  };

  const uint32_t q_box = sm90::smem_u32(Qs) + 64 * wg * 128;
  sm90::mbar_wait(&q_full, 0);
  for (int kb = lo, i = 0; kb < hi; ++kb, ++i) {
    const int st = i % kStages;
    const int k0 = kb * kBK;
    sm90::mbar_wait(&kv_full[st], (i / kStages) & 1);
    const uint32_t k_box = sm90::smem_u32(Ks + st * SM::kTileBytes);
    const uint32_t v_box = sm90::smem_u32(Vs + st * SM::kTileBytes);
#pragma unroll
    for (int sub = 0; sub < kBK / kSub; ++sub) {
      const int kc = k0 + sub * kSub;  // the step's first key
      if (CAUSAL && kc > qw + 63 + off) continue;  // hidden from every row of the warpgroup
      // S = Q K^T over the head dim, 16 columns a step
      sm90::fence_regs(sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sm90::desc_kmajor(q_box + (kk / 4) * kBQ * 128, kk % 4);
        const uint64_t db =
            sm90::desc_kmajor(k_box + (kk / 4) * SM::kBoxBytes + sub * kSub * 128, kk % 4);
        mma_ss<kSub>(sacc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);

      // accumulator (x): query row0 + 8 ((x >> 1) & 1), key kc + c.
      // Scores in natural units, each op rounded on its own as the plain
      // version rounds them: s * scale, then + mask
#pragma unroll
      for (int x = 0; x < kSub / 2; ++x) sacc[x] = __fmul_rn(sacc[x], a.scale);
      if constexpr (MASK) add_mask(kc);
      // hidden scores at -inf, only where a step crosses the causal limit,
      // the end of the keys or a segment boundary, one branch a step
      const bool seg_mask = has_seg && !(wg_uniform && seg_tile[st][0] == seg_tile[st][1] &&
                                         seg_tile[st][0] == own[wg][0]);
      const auto mask = [&](auto with_seg) {
#pragma unroll
        for (int x = 0; x < kSub / 2; ++x) {
          const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
          bool live = kc + c < a.sk;
          if (CAUSAL) live = live && kc + c <= row0 + 8 * r + off;
          if (decltype(with_seg)::value) live = live && seg_cols[st][sub * kSub + c] == my_seg[r];
          sacc[x] = live ? sacc[x] : -kInf;
        }
      };
      if (seg_mask) {
        mask(std::true_type());
      } else if ((CAUSAL && kc + kSub - 1 > qw + off) || kc + kSub > a.sk) {
        mask(std::false_type());
      }
      // online softmax on the accumulator layout: a row's kSub / 4 values
      // of the step lie in the four lanes of a quad; max and sum run in
      // four independent chains a row
      float m_new[2];
      const auto row_max = [&]() {
        float mp[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) mp[r][q] = -kInf;
#pragma unroll
        for (int x = 0; x < kSub / 2; ++x) {
          const int r = (x >> 1) & 1, q = ((x >> 2) & 1) * 2 + (x & 1);
          mp[r][q] = fmaxf(mp[r][q], sacc[x]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          m_new[r] = fmaxf(m[r], mx);  // stays kNegInf while the row saw nothing
        }
      };
      row_max();
      if constexpr (MASK) {
        // A row whose every visible score an additive mask of magnitude
        // >= kExactFrom dominates keeps its max, and so its lse, where
        // fp32's spacing is >= 2^-15 and grows to ~1e-3 at 1e4: there the
        // last bits in which the tensor cores' sums differ from one fp32
        // FMA chain move a rounded score, and so lse, by a whole step.
        // Such rows (rare: a batch row whose keys are all masked) take
        // their scores again as one FMA chain over d in column order, the
        // plain version's (and the scalar kernel's) rounding, from the
        // bf16 Q and K tiles in shared memory.
        const bool exact0 = fabsf(m_new[0]) >= kExactFrom && m_new[0] > kNegInf / 2;
        const bool exact1 = fabsf(m_new[1]) >= kExactFrom && m_new[1] > kNegInf / 2;
        if (__any_sync(0xffffffffu, exact0 || exact1)) {
          const uint8_t* const kt = Ks + st * SM::kTileBytes;
#pragma unroll
          for (int x = 0; x < kSub / 2; ++x) {
            const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
            if (!(r ? exact1 : exact0) || sacc[x] == -kInf) continue;
            const int row = row0 + 8 * r, key = kc + c;
            float y = __fmul_rn(dot_chain<D>(Qs, row - q0, kt, sub * kSub + c), a.scale);
            if (row < a.sq) y = __fadd_rn(y, mrow[row * a.m_st[2] + key * a.m_st[3]]);
            sacc[x] = y;
          }
          row_max();
        }
      }
      float alpha[2], sp[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = sm90::ex2(__fmul_rn(m[r] - m_new[r], kLog2e));
#pragma unroll
        for (int q = 0; q < 4; ++q) sp[r][q] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < kSub / 2; ++x) {
        const int r = (x >> 1) & 1, q = ((x >> 2) & 1) * 2 + (x & 1);
        sacc[x] = sm90::ex2(__fmul_rn(sacc[x] - m_new[r], kLog2e));
        sp[r][q] += sacc[x];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = (sp[r][0] + sp[r][1]) + (sp[r][2] + sp[r][3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = alpha[r] * l[r] + sum;
        m[r] = m_new[r];
      }
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];

      // P (dropped, rescaled) to bf16 A fragments, 16 keys a step
      uint32_t pf[kSub / 16][4];
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int x = 8 * kk + 2 * u;
          float p0 = sacc[x], p1 = sacc[x + 1];
          if (DROP) {
            const uint32_t row = row0 + 8 * ((x >> 1) & 1);
            const uint32_t col = kc + 8 * (x >> 2) + 2 * t;
            p0 = apex::dropout_keep(a.seed, bh, row, col, a.thresh) ? p0 * a.inv_keep : 0.f;
            p1 = apex::dropout_keep(a.seed, bh, row, col + 1, a.thresh) ? p1 * a.inv_keep : 0.f;
          }
          pf[kk][u] = sm90::pack_bf16(p0, p1);
        }
      }
      // O += P V, V read MN-major (the transpose bit)
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk)
        mma_rs<D>(o, pf[kk], v_box, sub * (kSub / 16) + kk, SM::kBoxBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    sm90::mbar_arrive(&kv_empty[st]);
    if (warp == 0 && i + kStages < n_tiles) {
      sm90::mbar_wait(&kv_empty[st], (i / kStages) & 1);  // both warpgroups are done with it
      issue(i + kStages);
    }
  }

  // epilogue: o / l in bf16 through o's strides (rows past sq not
  // stored), lse = m + log(l) in natural-log units; a row that saw no key
  // has l = 0: o exactly 0 and lse -1e30
  __nv_bfloat16* const obase = a.o + b * a.o_st[0] + h * a.o_st[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* out = obase + row * a.o_st[2] + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = sm90::pack_bf16(
          __fdiv_rn(o[4 * j + 2 * r], l_safe), __fdiv_rn(o[4 * j + 2 * r + 1], l_safe));
    if (t == 0)
      a.lse[static_cast<int64_t>(bh) * a.sq + row] =
          l[r] == 0.f ? kNegInf : __fadd_rn(m[r], logf(l_safe));
  }
}

template <int D, bool CAUSAL, bool MASK, bool DROP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Args& a, cudaStream_t stream) {
  const cudaError_t attr = apex::allow_smem(attn_fwd_sm90<D, CAUSAL, MASK, DROP>, Smem<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.B * a.H, (a.sq + kBQ - 1) / kBQ);
  attn_fwd_sm90<D, CAUSAL, MASK, DROP><<<grid, kThreads, Smem<D>::kBytes, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(bool causal, bool mask, bool drop, const CUtensorMap& tq,
                     const CUtensorMap& tk, const CUtensorMap& tv, const Args& a,
                     cudaStream_t s) {
  if (causal) {
    if (mask) {
      return drop ? launch<D, true, true, true>(tq, tk, tv, a, s)
                  : launch<D, true, true, false>(tq, tk, tv, a, s);
    }
    return drop ? launch<D, true, false, true>(tq, tk, tv, a, s)
                : launch<D, true, false, false>(tq, tk, tv, a, s);
  }
  if (mask) {
    return drop ? launch<D, false, true, true>(tq, tk, tv, a, s)
                : launch<D, false, true, false>(tq, tk, tv, a, s);
  }
  return drop ? launch<D, false, false, true>(tq, tk, tv, a, s)
              : launch<D, false, false, false>(tq, tk, tv, a, s);
}

}  // namespace

extern "C" {

// bf16 only; d: head dim (64 or 128).  strides: (b, h, s) of q, k, v and
// o, then the mask's (b, h, row, col), in elements (16 values); q, k, v
// have a unit last stride, 16-byte aligned rows and a zero stride only
// where their dimension has size 1.  lse is [B*H, sq] fp32.  mask,
// seg_q/seg_k and visits may be null; seg row = (b*H + h) / seg_div.
// visits, when given, is int32 [B*H*ceil(sq/128)].  thresh = round(rate *
// 2^32) and inv_keep = 1 / (1 - rate) (thresh 0 and inv_keep 1: no
// dropout).  Returns cudaGetLastError() after the launch.
int flash_fwd_sm90(int d, int device, const void* q, const void* k, const void* v, void* o,
                   float* lse, const float* mask, const int* seg_q, const int* seg_k,
                   int seg_div, int* visits, int B, int H, int sq, int sk,
                   const int64_t* strides, float scale, int causal, uint32_t seed,
                   uint32_t thresh, float inv_keep, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (sq <= 0 || B * H <= 0) return cudaSuccess;
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if (sk < 0) return cudaErrorInvalidValue;
  Args a{static_cast<__nv_bfloat16*>(o), lse, mask, seg_q, seg_k, seg_div, visits, B, H, sq, sk,
         scale, seed, thresh, inv_keep};
  for (int i = 0; i < 3; ++i) a.o_st[i] = strides[9 + i];
  for (int i = 0; i < 4; ++i) a.m_st[i] = strides[12 + i];
  // sk = 0 walks no tile (every row sees nothing); its maps take one row
  const int kv_rows = sk > 0 ? sk : 1;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = sm90_host::bf16_map_4d(&tq, q, B, H, sq, d, strides, kBQ)) != cudaSuccess ||
      (err = sm90_host::bf16_map_4d(&tk, k, B, H, kv_rows, d, strides + 3, kBK)) != cudaSuccess ||
      (err = sm90_host::bf16_map_4d(&tv, v, B, H, kv_rows, d, strides + 6, kBK)) != cudaSuccess)
    return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = !(thresh == 0 && inv_keep == 1.f);
  if (d == 64) return dispatch<64>(causal != 0, mask != nullptr, drop, tq, tk, tv, a, st);
  return dispatch<128>(causal != 0, mask != nullptr, drop, tq, tk, tv, a, st);
}

}  // extern "C"
