// The attention dot floor on Hopper's tensor cores (sm_90a: wgmma and TMA):
// the route of profiling/roofs.py::attention_dots for every input it takes.
// attention_dots.cu (mma.sync, cp.async) is the route it replaced, kept to
// be timed beside it.
//
// Replaces the TPU kernel bench.py::_attention_dot_floor (its Pallas
// kernel: per batch-head, per q block of bq rows, for every k block of bk
// columns that the rule keeps, S = q k^T in fp32, P = bf16(S * 1e-3),
// O += P v in fp32; O written once as bf16).  A pair (i, j) is summed iff
//   (i // bq) * bq + bq - 1 >= (j // bk) * bk,
// per tile, not per element, so every row of a q block keeps the same
// prefix [0, kmax) of the keys.  bq and bk are multiples of 64 that divide
// s.  Each row's keys are added into one fp32 accumulator in key order, 64
// keys a step; no atomics, so two runs give the same bits (they differ
// from the JAX kernel's tree sum and from attention_dots.cu's by a few
// fp32 roundings: the tests hold it to 2^-7 of the output's scale).
//
// What bounds it on an H100: operations.  At bench.py's shape (bh 128, s
// 1024, d 64, blocks 512) the kept pairs are 3/4 of the dense square: 25.8
// GFLOP, 0.026 ms at 989 TFLOP/s, against 67 MB of q, k, v and o (0.020 ms
// at 3.35 TB/s); at GPT-1.3B's (bh 64, s 2048, d 128, blocks 64) 70.9
// GFLOP, 0.072 ms.  A floor that a hand kernel cannot outrun needs the
// card's full tensor-core rate, which only wgmma reaches.
//
// Design: K3's (flash_qkv_fwd_sm90.cu) minus the softmax.  One block per
// (q tile, batch-head), a consumer warpgroup per 64 query rows of the
// tile: three at head dim 128, two at 64 (there two blocks an SM).
// Thread 0 loads the Q tile once by TMA, then 64-key K and V steps through
// a ring of stages with full/empty mbarriers (one arrive a warp), and warp
// 0 refills a stage once every warpgroup has released it; steps past the
// block's kept prefix are never loaded.  The step is 64 keys because the
// rule's prefix is 64-granular: at blocks of 64 neighbouring warpgroups
// keep prefixes 64 keys apart, and a warpgroup multiplies exactly the
// pairs the rule keeps (S by m64n64k16, P V over k = 64), then walks the
// block's remaining steps only to release them.  A warpgroup whose rows
// lie past s (a q tail: TMA reads them as zeros) multiplies nothing and
// stores nothing.  S = Q K^T by wgmma with both operands in shared memory
// (K-major); P = bf16(S * 1e-3) is converted straight from the
// accumulator into A fragments in registers; O += P V by wgmma with V
// read MN-major through the transpose bit.  The two products are
// pipelined: S of step i + 1 is issued before P V of step i, and the
// warpgroup waits only for S (wgmma.wait_group 1), so the convert of step
// i + 1 runs while the tensor cores add P V of step i; P lives in two
// register buffers, one per step in flight.  A stage is released once its
// P V is known complete, one step later, so the ring needs three stages
// or more.  Each warpgroup's chain of dependent wgmmas and barrier waits,
// not the tensor cores' rate nor the memory, sets the time (the probes of
// scripts/attention_dots_sm90_ab.py), hence as many warpgroups an SM as
// the registers allow.  Blocks run in groups of batch-heads, the q tiles
// with the longest walks first inside a group.  `visits`, when given,
// receives the 64 x 64 sub-tiles each block multiplied, so a caller can
// hold the walk against the rule's pair count.

#include <algorithm>
#include <climits>

#include "sm90.cuh"

namespace {

constexpr int kStep = 64;         // keys of a step: the skip rule's granule
constexpr float kScale = 1e-3f;   // bench.py's (sc * 1e-3)
// by head dim: consumer warpgroups a block (64 query rows each), stages of
// the ring, blocks an SM
constexpr int kWarpgroupsD64 = 2, kStagesD64 = 5, kBlocksD64 = 2;
constexpr int kWarpgroupsD128 = 3, kStagesD128 = 5;
// blocks run in groups of batch-heads whose K and V together take at most
// this many bytes (a third of the H100's 50 MB L2), every q tile of a group
// before the next group, so that K and V are read from HBM about once
constexpr int64_t kGroupBytes = 16ll << 20;

__host__ __device__ constexpr int blocks_per_sm(int d) { return d == 64 ? kBlocksD64 : 1; }
__host__ __device__ constexpr int warpgroups(int d) {
  return d == 64 ? kWarpgroupsD64 : kWarpgroupsD128;
}
__host__ __device__ constexpr int rows_per_block(int d) { return 64 * warpgroups(d); }

template <int D>
struct Smem {
  static constexpr int kBQ = rows_per_block(D);  // query rows of a block
  static constexpr int kStages = D == 64 ? kStagesD64 : kStagesD128;
  static constexpr int kQBytes = kBQ * D * 2;          // D / 64 boxes of [kBQ, 64]
  static constexpr int kBoxBytes = kStep * 128;        // one [kStep, 64] box
  static constexpr int kXBytes = kStages * kBoxBytes;  // a 64-column slab of the ring
  static constexpr int kTileBytes = kStep * D * 2;     // a step of K or of V
  static constexpr size_t kBytes = kQBytes + 2 * kStages * kTileBytes + 1024;
  static_assert(kStages >= 3, "a stage is held until the next step's P V is issued");
};

struct Args {
  __nv_bfloat16* o;
  int* visits;  // null, or sub-tiles multiplied per block [bh, ceil(s / rows_per_block)]
  int bh, s, bq, bk;
  int group;    // batch-heads a group of blocks
};

// the 64-key steps a warpgroup whose first row is qw multiplies: its rows
// lie in one q block (bq is a multiple of 64), whose last row's k block
// ends the prefix; none past s
__device__ __forceinline__ int steps_of(const Args& a, int qw) {
  if (qw >= a.s) return 0;
  const int last = qw / a.bq * a.bq + a.bq - 1;
  return (last / a.bk + 1) * a.bk / kStep;
}

// d[64 x D] += A[64 x 16] B[16 x D], A from registers, B MN-major from
// `box` (its D columns in 64-column slabs `slab_bytes` apart).
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint32_t box,
                                       int k, uint32_t slab_bytes) {
  if constexpr (D == 128) {
    sm90::wgmma_rs_n128<1>(d, a, sm90::desc_mnmajor(box, k, slab_bytes), 1);
  } else {
    sm90::wgmma_rs_n64<1>(d, a, sm90::desc_mnmajor(box, k, slab_bytes), 1);
  }
}

template <int D>
__global__ void __launch_bounds__(128 * warpgroups(D), blocks_per_sm(D))
    attention_dots_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using SM = Smem<D>;
  constexpr int kStages = SM::kStages, kBQ = SM::kBQ, kConsumers = warpgroups(D);
  using PFrag = uint32_t[kStep / 16][4];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = sm90::align1024(smem_raw);
  // K and V rings, [D / 64][kStages][kStep rows of 128 B]
  uint8_t* const Ks = Qs + SM::kQBytes;
  uint8_t* const Vs = Ks + kStages * SM::kTileBytes;
  __shared__ __align__(8) uint64_t q_full, kv_full[kStages], kv_empty[kStages];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block b: group b / (group * n_qt); inside it the q tiles with the
  // longest walks first, each over the group's batch-heads
  const int n_qt = (a.s + kBQ - 1) / kBQ;
  const int per_group = a.group * n_qt;
  const int gr = blockIdx.x / per_group, r = blockIdx.x % per_group;
  const int g_size = min(a.group, a.bh - gr * a.group);
  const int bh = gr * a.group + r % g_size;
  const int qt = n_qt - 1 - r / g_size;
  const int q0 = qt * kBQ;
  const int wg = warp >> 2;
  const int my_steps = steps_of(a, q0 + 64 * wg);
  // the block's walk: the longest prefix of its warpgroups (the last one
  // inside s)
  int n_steps = 0, visits = 0;
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) {
    n_steps = max(n_steps, steps_of(a, q0 + 64 * w));
    visits += steps_of(a, q0 + 64 * w);
  }

  // thread 0 loads step i of the walk into stage i % kStages
  const auto issue = [&](int i) {
    const int st = i % kStages;
    sm90::mbar_expect_tx(&kv_full[st], 2 * SM::kTileBytes);
#pragma unroll
    for (int x = 0; x < D / 64; ++x) {
      const int off = x * SM::kXBytes + st * SM::kBoxBytes;
      sm90::tma_load_3d(Ks + off, &tm_k, &kv_full[st], 64 * x, i * kStep, bh);
      sm90::tma_load_3d(Vs + off, &tm_v, &kv_full[st], 64 * x, i * kStep, bh);
    }
  };
  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&kv_full[i], 1);
      sm90::mbar_init(&kv_empty[i], 4 * kConsumers);  // one arrive a warp
    }
    sm90::fence_barrier_init();
    if (a.visits != nullptr) a.visits[static_cast<int64_t>(bh) * n_qt + qt] = visits;
    sm90::mbar_expect_tx(&q_full, SM::kQBytes);
#pragma unroll
    for (int x = 0; x < D / 64; ++x)
      sm90::tma_load_3d(Qs + x * kBQ * 128, &tm_q, &q_full, 64 * x, q0, bh);
    for (int i = 0; i < min(n_steps, kStages); ++i) issue(i);  // the ring starts empty
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // release step i's stage (each warp once its share of the step's
  // products is complete); warp 0 then refills it with step i + kStages
  // once every warpgroup has released it
  const auto release = [&](int i) {
    const int st = i % kStages;
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&kv_empty[st]);
    if (warp == 0 && i + kStages < n_steps) {
      sm90::mbar_wait(&kv_empty[st], (i / kStages) & 1);
      if (lane == 0) issue(i + kStages);
      __syncwarp();
    }
  };
  const auto wait_full = [&](int i) {
    sm90::mbar_wait(&kv_full[i % kStages], (i / kStages) & 1);
  };

  // -- warpgroup wg: query rows q0 + 64 wg .. + 63 ---------------------------
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + g;  // this thread's rows: row0, row0 + 8
  const uint32_t q_box = sm90::smem_u32(Qs) + 64 * wg * 128;
  const uint32_t k_ring = sm90::smem_u32(Ks), v_ring = sm90::smem_u32(Vs);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sacc[kStep / 2];
#pragma unroll
  for (int i = 0; i < kStep / 2; ++i) sacc[i] = 0.f;
  PFrag pa, pb;

  // S = Q K^T of step i into sacc over the head dim, 16 columns a wgmma
  const auto issue_s = [&](int i) {
    const uint32_t k_box = k_ring + (i % kStages) * SM::kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = sm90::desc_kmajor(q_box + (kk / 4) * kBQ * 128, kk % 4);
      const uint64_t db = sm90::desc_kmajor(k_box + (kk / 4) * SM::kXBytes, kk % 4);
      sm90::wgmma_ss_n64<0>(sacc, da, db, kk > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P V of step i, 16 keys a wgmma
  const auto issue_pv = [&](int i, const PFrag& p) {
    const uint32_t v_box = v_ring + (i % kStages) * SM::kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) mma_rs<D>(o, p[kk], v_box, kk, SM::kXBytes);
    sm90::wgmma_commit();
  };
  // P = bf16(S * 1e-3): the product rounded in fp32, then once to bf16
  // (RN), straight from the accumulator into A fragments
  const auto to_p = [&](PFrag& p) {
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int x = 8 * kk + 2 * u;
        p[kk][u] = sm90::pack_bf16(__fmul_rn(sacc[x], kScale), __fmul_rn(sacc[x + 1], kScale));
      }
  };
  // step i with a step after it: S of step i + 1 goes in before P V of
  // step i, and only S is waited for; P V of step i - 1 is then complete
  const auto step_more = [&](int i, const PFrag& cur, PFrag& nxt) {
    wait_full(i + 1);
    sm90::wgmma_fence();
    issue_s(i + 1);
    issue_pv(i, cur);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sacc);
    to_p(nxt);
    if (i > 0) release(i - 1);
  };
  // the last step: P V alone, then everything is complete
  const auto step_last = [&](int i, const PFrag& cur) {
    sm90::wgmma_fence();
    issue_pv(i, cur);
    sm90::wgmma_wait<0>();
    if (i > 0) release(i - 1);
    release(i);
  };

  sm90::mbar_wait(&q_full, 0);
  if (my_steps > 0) {
    wait_full(0);
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    to_p(pa);
    int i = 0;
    for (; i + 2 < my_steps; i += 2) {  // two at a time: the P buffers swap roles
      step_more(i, pa, pb);
      step_more(i + 1, pb, pa);
    }
    if (i + 1 < my_steps) {
      step_more(i, pa, pb);
      step_last(i + 1, pb);
    } else {
      step_last(i, pa);
    }
    sm90::fence_regs(o);

    // o as bf16, rounded once; every row of an active warpgroup is < s
    __nv_bfloat16* out = a.o + (static_cast<int64_t>(bh) * a.s + row0) * D + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * r * D + 8 * j) =
            sm90::pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
  // the block's steps past this warpgroup's prefix: released unread
  for (int i = my_steps; i < n_steps; ++i) {
    wait_full(i);
    release(i);
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Args& a, cudaStream_t stream) {
  const cudaError_t attr = apex::allow_smem(attention_dots_sm90_kernel<D>, Smem<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  const int64_t blocks = static_cast<int64_t>(a.bh) * ((a.s + Smem<D>::kBQ - 1) / Smem<D>::kBQ);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attention_dots_sm90_kernel<D><<<static_cast<unsigned>(blocks), 128 * warpgroups(D),
                                  Smem<D>::kBytes, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: bf16 [bh, s, d] contiguous, 16-byte aligned; d 64 or 128.
// bq, bk: the JAX blocks already clipped to s (min(block, s)), multiples
// of 64 that divide s.  visits: null, or int32 [bh * ceil(s / (64 *
// warpgroups(d)))] that receives the 64 x 64 sub-tiles each block
// multiplied.  Writes every row of o.  Returns cudaGetLastError() after
// the launch.
int attention_dots_sm90(int device, const void* q, const void* k, const void* v, void* o,
                        int* visits, int bh, int s, int d, int bq, int bk, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (bh <= 0 || s <= 0 || bq <= 0 || bk <= 0 || bq % kStep || bk % kStep || s % bq ||
      s % bk || (d != 64 && d != 128))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = sm90_host::bf16_map(&tq, q, bh, s, d, rows_per_block(d))) != cudaSuccess ||
      (err = sm90_host::bf16_map(&tk, k, bh, s, d, kStep)) != cudaSuccess ||
      (err = sm90_host::bf16_map(&tv, v, bh, s, d, kStep)) != cudaSuccess)
    return err;
  const int64_t kv_bytes = static_cast<int64_t>(s) * d * 4;  // one batch-head's K and V
  const int group =
      static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(bh, kGroupBytes / kv_bytes)));
  const Args a{static_cast<__nv_bfloat16*>(o), visits, bh, s, bq, bk, group};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch<64>(tq, tk, tv, a, st) : launch<128>(tq, tk, tv, a, st);
}

}  // extern "C"
