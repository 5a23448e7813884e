// Packed-QKV self-attention forward for GPT training, on Hopper's tensor
// cores (sm_90a: wgmma and TMA).  The bf16 route of K3; flash_qkv_fwd.cu
// stays the fp32 route.
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_qkv_fwd_pallas:
// attention read straight from the QKV projection's output in its
// Megatron-interleaved layout, qkv [b, s, H * 3 * d] with head h's q, k and
// v at columns [h*3d, +d), [+d, +2d), [+2d, +3d); ctx [b, s, H * d] in the
// order the output projection reads; lse [b * H, s] fp32 (-1e30 for a row
// that sees no key) for the backward; causal or not (a template flag),
// optional segment ids, optional attention dropout, any s.
//
// What bounds it on an H100: at the GPT-1.3B training shape (b = 4, s =
// 2048, 16 heads of 128, causal) the kernel must move ~134 MB (qkv read
// once, ctx and lse written once: ~0.04 ms at 3.35 TB/s) and do ~69 GFLOP
// on the visible half of the score matrix (~0.07 ms at the 989 TFLOP/s bf16
// tensor-core rate): bound by operations, so both products run on the
// tensor cores by wgmma, fed by TMA.  At BERT-large's padded shape (b =
// 16, s = 512, 16 heads of 64, key padding, not causal) it must move ~68
// MB (~0.020 ms) for ~12 GFLOP on the visible pairs (~0.012 ms): bound by
// bytes there.
//
// Design.  One block per (128-row q tile, batch*head): two warpgroups of 64
// query rows each.  Warp 0 also loads: the Q tile once by TMA, then 128-key
// K and V tiles through a ring of two stages with full/empty mbarriers,
// refilling a stage as soon as both warpgroups have released it; tiles
// past the causal diagonal or outside the segment-id range (the
// _segment_block_bounds rule, computed in the block) are never loaded.  (A
// ninth, producer-only warp would put three warps on one of the SM's four
// register-file partitions and cap every thread at 168 registers, which
// the accumulators do not fit.)  A warpgroup computes S = Q K^T by wgmma
// with both operands in shared memory (K-major: d contiguous in both),
// runs the online softmax in registers on the accumulator layout,
// converts P to bf16 A fragments in registers (the JAX kernel's rounding
// point: p.astype(v.dtype) before P V) and adds P V by wgmma with V as an
// MN-major B read through the transpose bit.  Only tiles that cross the
// causal diagonal, the end of the sequence or a segment boundary are
// masked element by element, behind one branch a tile (a branch inside
// the element loop costs a convergence barrier per element); a hidden
// score becomes -inf, whose p is 0.  As on the TPU (_make_fwd_kernel_qkv)
// p enters the running sum l before dropout, and a kept p is scaled by 1
// / (1 - rate) before it is rounded.  Exponentials are ex2.approx in base
// 2 with the scale folded in, the row max and sum run in four
// independent chains; lse is returned in natural-log units.  Heavier q
// tiles (causal: later rows) are scheduled first.
//
// Template on the head dim D, built at 128 (GPT) and 64 (BERT-large): one
// entry point each, so that launches count by instance.  At D = 64, Q and
// each K or V tile are one 64-column box, P V is m64n64k16 and a thread
// holds 32 output sums; tiles, ring and warpgroups are those of D = 128
// (one block an SM).

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
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int kQBytes = kBQ * D * 2;     // D / 64 boxes of [kBQ, 64]
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kBoxBytes = kBK * 128;     // one [kBK, 64] box of it
  static constexpr size_t kBytes = kQBytes + 2 * kStages * kTileBytes + 1024;
};

struct FwdArgs {
  __nv_bfloat16* ctx;
  float* lse;
  const int* seg_q;  // null: no segments
  const int* seg_k;
  int seg_div;
  int B, H, s;
  float scale_log2;  // scale * log2(e)
  uint32_t seed, thresh;
  float inv_keep;    // 1 / (1 - rate)
};

// o[64 x D] += P[64 x 16] V[16 x D], P from registers, V MN-major from
// `box` (its D columns in 64-column boxes `box_bytes` apart).
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&p)[4], uint32_t box,
                                       int k, uint32_t box_bytes) {
  static_assert(D == 64 || D == 128, "head dims 64 and 128 are built");
  if constexpr (D == 128) {
    sm90::wgmma_rs_n128<1>(o, p, sm90::desc_mnmajor(box, k, box_bytes), 1);
  } else {
    sm90::wgmma_rs_n64<1>(o, p, sm90::desc_mnmajor(box, k, box_bytes), 1);
  }
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    qkv_fwd_sm90(const __grid_constant__ CUtensorMap tm, const FwdArgs a) {
  using SM = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = sm90::align1024(smem_raw);
  uint8_t* const Ks = Qs + SM::kQBytes;
  uint8_t* const Vs = Ks + kStages * SM::kTileBytes;
  __shared__ __align__(8) uint64_t q_full, kv_full[kStages], kv_empty[kStages];
  __shared__ int seg_cols[kStages][kBK];  // with segments: each stage's key ids
  __shared__ int seg_tile[kStages][2];    // and their [min, max]
  __shared__ int wg_seg[kConsumers][2];   // [min, max] of each warpgroup's rows
  __shared__ int kb_lo, kb_hi;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qb = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBQ;
  const int nrows = min(kBQ, a.s - q0);
  const int n_kb = (a.s + kBK - 1) / kBK;
  const bool has_seg = a.seg_q != nullptr;
  const int* sq_row = has_seg ? a.seg_q + static_cast<int64_t>(bh / a.seg_div) * a.s : nullptr;
  const int* sk_row = has_seg ? a.seg_k + static_cast<int64_t>(bh / a.seg_div) * a.s : nullptr;

  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&kv_full[i], 1);
      sm90::mbar_init(&kv_empty[i], 128 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  // the k-tile range: tiles whose segment-id interval meets the q tile's,
  // then the causal limit
  int lo = 0, hi = n_kb;
  if (has_seg) {
    sm90::own_intervals(sq_row, q0, nrows, wg_seg);
    sm90::live_tiles(sk_row, a.s, kBK, wg_seg, &kb_lo, &kb_hi);
    lo = kb_lo;
    hi = kb_hi;
  } else {
    __syncthreads();
  }
  if (CAUSAL) hi = min(hi, (q0 + nrows - 1) / kBK + 1);

  // warp 0 loads: Q once, then walk tile i into stage i % kStages (its
  // ids, with segments, into seg_cols) once that stage is free
  const int n_tiles = max(0, hi - lo);
  const auto issue = [&](int i) {
    const int st = i % kStages, k0 = (lo + i) * kBK;
    if (has_seg) sm90::stage_ids(sk_row, k0, kBK, a.s, seg_cols[st], seg_tile[st]);
    if (lane == 0) {
      sm90::mbar_expect_tx(&kv_full[st], 2 * SM::kTileBytes);
      uint8_t* kd = Ks + st * SM::kTileBytes;
      uint8_t* vd = Vs + st * SM::kTileBytes;
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        sm90::tma_load_3d(kd + x * SM::kBoxBytes, &tm, &kv_full[st], h * 3 * D + D + 64 * x, k0,
                          b);
        sm90::tma_load_3d(vd + x * SM::kBoxBytes, &tm, &kv_full[st], h * 3 * D + 2 * D + 64 * x,
                          k0, b);
      }
    }
    __syncwarp();
  };
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_expect_tx(&q_full, SM::kQBytes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x)
        sm90::tma_load_3d(Qs + x * kBQ * 128, &tm, &q_full, h * 3 * D + 64 * x, q0, b);
    }
    for (int i = 0; i < min(n_tiles, kStages); ++i) issue(i);  // the ring starts empty
  }

  // -- warpgroup wg: query rows q0 + 64 wg .. + 63 -------------------------
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;                  // first row of the warpgroup
  const int row0 = qw + 16 * (warp & 3) + g;    // this thread's rows: row0, row0 + 8
  int my_seg[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) my_seg[r] = row0 + 8 * r < a.s ? sq_row[row0 + 8 * r] : INT_MIN;
  }
  const bool wg_uniform = has_seg && wg_seg[wg][0] == wg_seg[wg][1];

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sacc[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.f;

  const uint32_t q_box = sm90::smem_u32(Qs) + 64 * wg * 128;
  sm90::mbar_wait(&q_full, 0);
  for (int kb = lo, i = 0; kb < hi; ++kb, ++i) {
    const int st = i % kStages;
    const int k0 = kb * kBK;
    sm90::mbar_wait(&kv_full[st], (i / kStages) & 1);
    if (!CAUSAL || k0 <= qw + 63) {
      // S = Q K^T over the head dim, 16 columns a step
      const uint32_t k_box = sm90::smem_u32(Ks + st * SM::kTileBytes);
      sm90::fence_regs(sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sm90::desc_kmajor(q_box + (kk / 4) * kBQ * 128, kk % 4);
        const uint64_t db = sm90::desc_kmajor(k_box + (kk / 4) * SM::kBoxBytes, kk % 4);
        sm90::wgmma_ss_n128<0>(sacc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);

      // scores in log2 units; masks only where a tile crosses the diagonal,
      // the end of the sequence or a segment boundary, one branch a tile
      // (a branch inside the element loop costs a convergence barrier per
      // element).  A hidden score is -inf, so its p is 0 with no select.
#pragma unroll
      for (int x = 0; x < kBK / 2; ++x) sacc[x] *= a.scale_log2;
      const bool seg_mask = has_seg && !(wg_uniform && seg_tile[st][0] == seg_tile[st][1] &&
                                         seg_tile[st][0] == wg_seg[wg][0]);
      const auto mask = [&](auto with_seg) {
#pragma unroll
        for (int x = 0; x < kBK / 2; ++x) {
          const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t + (x & 1);
          bool live = k0 + c < a.s;
          if (CAUSAL) live = live && k0 + c <= row0 + 8 * r;
          if (decltype(with_seg)::value) live = live && seg_cols[st][c] == my_seg[r];
          sacc[x] = live ? sacc[x] : -kInf;
        }
      };
      if (seg_mask) {
        mask(std::true_type());
      } else if ((CAUSAL && k0 + kBK - 1 > qw) || k0 + kBK > a.s) {
        mask(std::false_type());
      }
      // online softmax on the accumulator layout: a row's 32 values of the
      // tile lie in the four lanes of a quad; max and sum run in four
      // independent chains a row
      float mp[2][4], sp[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          mp[r][q] = -kInf;
          sp[r][q] = 0.f;
        }
#pragma unroll
      for (int x = 0; x < kBK / 2; ++x) {
        const int r = (x >> 1) & 1, q = ((x >> 2) & 1) * 2 + (x & 1);
        mp[r][q] = fmaxf(mp[r][q], sacc[x]);
      }
      float alpha[2], m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[r] = fmaxf(m[r], mx);  // stays kNegInf while the row saw nothing
        alpha[r] = sm90::ex2(m[r] - m_new[r]);
      }
#pragma unroll
      for (int x = 0; x < kBK / 2; ++x) {
        const int r = (x >> 1) & 1, q = ((x >> 2) & 1) * 2 + (x & 1);
        sacc[x] = sm90::ex2(sacc[x] - m_new[r]);
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
      uint32_t pf[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int x = 8 * kk + 2 * u;
          float p0 = sacc[x], p1 = sacc[x + 1];
          if (DROP) {
            const uint32_t row = row0 + 8 * ((x >> 1) & 1);
            const uint32_t col = k0 + 8 * (x >> 2) + 2 * t;
            p0 = apex::dropout_keep(a.seed, bh, row, col, a.thresh) ? p0 * a.inv_keep : 0.f;
            p1 = apex::dropout_keep(a.seed, bh, row, col + 1, a.thresh) ? p1 * a.inv_keep : 0.f;
          }
          pf[kk][u] = sm90::pack_bf16(p0, p1);
        }
      }
      // O += P V, V read MN-major (the transpose bit)
      const uint32_t v_box = sm90::smem_u32(Vs + st * SM::kTileBytes);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma_pv<D>(o, pf[kk], v_box, kk, SM::kBoxBytes);
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

  // epilogue: O / l in bf16, lse in natural-log units
  const int64_t crow = static_cast<int64_t>(a.H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.s) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    __nv_bfloat16* out = a.ctx + (static_cast<int64_t>(b) * a.s + row) * crow + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          sm90::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t == 0)
      a.lse[static_cast<int64_t>(bh) * a.s + row] =
          l[r] == 0.f ? kNegInf : (m[r] + log2f(l_safe)) * kLn2;
  }
}

template <int D, bool CAUSAL, bool DROP>
cudaError_t launch(const CUtensorMap& tm, const FwdArgs& a, cudaStream_t stream) {
  const cudaError_t attr = apex::allow_smem(qkv_fwd_sm90<D, CAUSAL, DROP>, Smem<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.B * a.H, (a.s + kBQ - 1) / kBQ);
  qkv_fwd_sm90<D, CAUSAL, DROP><<<grid, kThreads, Smem<D>::kBytes, stream>>>(tm, a);
  return cudaGetLastError();
}

}  // namespace

namespace {

template <int D>
int run(int device, const void* qkv, void* ctx, float* lse, const int* seg_q, const int* seg_k,
        int seg_div, int B, int H, int s, float scale, int causal, uint32_t seed,
        uint32_t thresh, float keep_prob, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (s <= 0 || B * H <= 0) return cudaSuccess;
  CUtensorMap tm;
  const cudaError_t err =
      sm90_host::bf16_map(&tm, qkv, B, s, static_cast<int64_t>(H) * 3 * D, kBK);
  if (err != cudaSuccess) return err;
  const FwdArgs a{static_cast<__nv_bfloat16*>(ctx), lse, seg_q, seg_k, seg_div, B, H, s,
                  scale * kLog2e, seed, thresh, 1.f / keep_prob};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = !(thresh == 0 && keep_prob == 1.f);
  if (causal) {
    return drop ? launch<D, true, true>(tm, a, st) : launch<D, true, false>(tm, a, st);
  }
  return drop ? launch<D, false, true>(tm, a, st) : launch<D, false, false>(tm, a, st);
}

}  // namespace

extern "C" {

// bf16 only; d: head dim (128 here, 64 in flash_qkv_fwd_sm90_d64).  qkv
// [B, s, H*3*d] and ctx [B, s, H*d] contiguous, 16-byte aligned; lse [B*H,
// s] fp32.  seg_q/seg_k may be null (no segments); with them, seg row = (b
// * H + h) / seg_div.  thresh = round(rate * 2^32) (0: no dropout),
// keep_prob = 1 - rate.  Returns cudaGetLastError() after the launch.
int flash_qkv_fwd_sm90(int d, int device, const void* qkv, void* ctx, float* lse,
                       const int* seg_q, const int* seg_k, int seg_div, int B, int H, int s,
                       float scale, int causal, uint32_t seed, uint32_t thresh, float keep_prob,
                       void* stream) {
  if (d != 128) return cudaErrorInvalidValue;
  return run<128>(device, qkv, ctx, lse, seg_q, seg_k, seg_div, B, H, s, scale, causal, seed,
                  thresh, keep_prob, stream);
}

// The same at head dim 64 (d must be 64).
int flash_qkv_fwd_sm90_d64(int d, int device, const void* qkv, void* ctx, float* lse,
                           const int* seg_q, const int* seg_k, int seg_div, int B, int H, int s,
                           float scale, int causal, uint32_t seed, uint32_t thresh,
                           float keep_prob, void* stream) {
  if (d != 64) return cudaErrorInvalidValue;
  return run<64>(device, qkv, ctx, lse, seg_q, seg_k, seg_div, B, H, s, scale, causal, seed,
                 thresh, keep_prob, stream);
}

}  // extern "C"
