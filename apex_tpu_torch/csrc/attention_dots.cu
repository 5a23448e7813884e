// The attention dot floor (sm_90a): only the two attention products, on the
// tensor cores, with the JAX bench's static causal tile skip.
//
// Replaces the TPU kernel bench.py::_attention_dot_floor (its Pallas
// kernel: per batch-head, per q block of bq rows, for every k block of bk
// columns that the rule keeps, S = q k^T in fp32, P = bf16(S * 1e-3),
// O += P v in fp32; O written once as bf16).  A pair (i, j) is summed iff
//   (i // bq) * bq + bq - 1 >= (j // bk) * bk,
// per tile, not per element: diagonal tiles are multiplied in full, so bq
// and bk are arguments of the function, not tuning knobs.  For every row
// the kept columns are a prefix [0, kmax) of the keys.  The JAX kernel
// sums its per-tile products with a tree sum; this one adds each 64-column
// step into one fp32 accumulator in order, so its bits differ from the
// JAX kernel's by a few fp32 roundings (the tests hold it to 2^-7 of the
// output's scale); it is deterministic run to run (no atomics).
//
// What bounds it on an H100: operations.  At bench.py's shape (bh 128, s
// 1024, d 64, blocks 512) the kept pairs are 3/4 of the dense square:
// 25.8 GFLOP, 0.026 ms at 989 TFLOP/s, against 67 MB of q, k, v and o
// (0.020 ms at 3.35 TB/s).  The products must run on the tensor cores, as
// the TPU kernel's run on the MXU: a floor made of scalar FMAs would
// measure what the scalar flash kernels measure.  Design: one block of 4
// warps per (64-row q tile, batch-head); each warp owns 16 query rows,
// held as mma A fragments in registers for the whole walk.  The block
// walks the kept keys in steps of 64.  K and V tiles stream into shared
// memory by cp.async, two stages deep, so the next step's loads overlap
// this step's products; rows are padded by 16 bytes so that every
// fragment load is conflict-free.  S = q k^T by mma.sync m16n8k16 (bf16
// in, fp32 sums, K's fragments by 32-bit shared loads); P = bf16(S *
// 1e-3) packed straight from the S accumulators into A fragments (the
// m16n8 accumulator layout is the A layout of two neighbouring tiles);
// O += P v by mma.sync into fp32 registers, V's fragments by ldmatrix
// .trans from its row-major tile.  q tiles with the most keys start
// first.  No wgmma and no TMA: attention_dots_sm90.cu, on both, is the
// route of every input now; this kernel is launched only to be compared
// with it.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;        // query rows a block, key columns a step
constexpr int kPad = 8;          // bf16 padding a shared row (16 bytes)
constexpr float kScale = 1e-3f;  // bench.py's (sc * 1e-3)

template <int D>
struct Layout {
  static constexpr int RS = D + kPad;               // row stride of a K or V tile
  static constexpr int kTileElems = kTile * RS;     // one K or V tile
  static constexpr int kStages = 2;
  static constexpr size_t kSmemBytes = sizeof(__nv_bfloat16) * 2 * kStages * kTileElems;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (completes at cp_async_wait)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of matrix i in r[i],
// the elements (2t, g) and (2t + 1, g) of its rows as stored (lane = 4 g + t)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// two fp32 values as one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c (16 x 8, fp32) += a (16 x 16, row-major, bf16) . b (16 x 8, column-major, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k16 (lane = 4 g + t): A holds rows g and g + 8 at
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds rows (k) 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column (n) g; C holds rows g and g + 8 at columns 2t,
// 2t + 1.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_dots_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          int s, int bq, int bk) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * D;
  // every row of the tile lies in one q block (kTile divides bq), so all
  // keep the same prefix of keys
  const int steps = ((q0 / bq * bq + bq - 1) / bk + 1) * bk / kTile;

  // stage st holds K then V of one step: [kTile][RS] each, row-major
  auto load_step = [&](int st, int k0) {
    __nv_bfloat16* ks = smem + st * 2 * L::kTileElems;
    __nv_bfloat16* vs = ks + L::kTileElems;
    const __nv_bfloat16* kg = k + base + static_cast<int64_t>(k0) * D;
    const __nv_bfloat16* vg = v + base + static_cast<int64_t>(k0) * D;
    for (int i = tid; i < kTile * D / 8; i += kThreads) {  // neighbours on neighbouring columns
      const int r = i / (D / 8), c = i % (D / 8) * 8;
      cp_async16(ks + r * L::RS + c, kg + r * D + c);
      cp_async16(vs + r * L::RS + c, vg + r * D + c);
    }
    cp_async_commit();
  };
  load_step(0, 0);

  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qw = q + base + static_cast<int64_t>(q0 + warp * 16) * D + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld32(qw + g * D + kk * 16);
    qa[kk][1] = ld32(qw + (g + 8) * D + kk * 16);
    qa[kk][2] = ld32(qw + g * D + kk * 16 + 8);
    qa[kk][3] = ld32(qw + (g + 8) * D + kk * 16 + 8);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;

  // this lane's row address within a 16-key, 16-column block for ldmatrix
  const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1), v_col = 8 * (lane >> 4);
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      load_step((it + 1) & 1, (it + 1) * kTile);
      cp_async_wait<1>();  // this step's tiles are in; the next one's in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = smem + (it & 1) * 2 * L::kTileElems;
    const __nv_bfloat16* vs = ks + L::kTileElems;

    // S = q k^T for this warp's 16 rows and the step's 64 keys
    float sc[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * L::RS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma(sc[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    // O += bf16(S * 1e-3) v, sixteen keys at a time
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const float(&lo)[4] = sc[2 * kk];
      const float(&hi)[4] = sc[2 * kk + 1];
      const uint32_t pa[4] = {pack(lo[0] * kScale, lo[1] * kScale),
                              pack(lo[2] * kScale, lo[3] * kScale),
                              pack(hi[0] * kScale, hi[1] * kScale),
                              pack(hi[2] * kScale, hi[3] * kScale)};
#pragma unroll
      for (int jn = 0; jn < D / 16; ++jn) {  // two 8-column tiles of O a load
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (kk * 16 + v_row) * L::RS + jn * 16 + v_col);
        mma(acc[2 * jn], pa, b[0], b[1]);
        mma(acc[2 * jn + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  __nv_bfloat16* ow = o + base + static_cast<int64_t>(q0 + warp * 16) * D + 2 * t;
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
    *reinterpret_cast<__nv_bfloat162*>(ow + g * D + jn * 8) =
        __floats2bfloat162_rn(acc[jn][0], acc[jn][1]);
    *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * D + jn * 8) =
        __floats2bfloat162_rn(acc[jn][2], acc[jn][3]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s, int bq,
                   int bk, cudaStream_t st) {
  using L = Layout<D>;
  const cudaError_t err = apex::allow_smem(attention_dots_kernel<D>, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(s / kTile, bh);
  attention_dots_kernel<D><<<grid, kThreads, L::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), s, bq, bk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: bf16 [bh, s, d] contiguous, 16-byte aligned; d 64 or 128.
// bq, bk: the JAX blocks already clipped to s (min(block, s)), multiples
// of 64 that divide s.  Writes every row of o.  Returns cudaGetLastError()
// after the launch.
int attention_dots(int device, const void* q, const void* k, const void* v, void* o, int bh,
                   int s, int d, int bq, int bk, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (bh <= 0 || bh > 65535 || s <= 0 || bq <= 0 || bk <= 0 || bq % kTile || bk % kTile ||
      s % bq || s % bk)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, bh, s, bq, bk, st);
  if (d == 128) return launch<128>(q, k, v, o, bh, s, bq, bk, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
