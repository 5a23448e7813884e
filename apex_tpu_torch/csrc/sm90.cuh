// Hopper building blocks of the tensor-core attention kernels
// (flash_qkv_fwd_sm90.cu, flash_qkv_bwd_sm90.cu, flash_bwd_sm90.cu), as raw inline PTX for
// sm_90a: the warpgroup matrix multiply (wgmma.mma_async m64nNk16, bf16 or
// fp16 in, fp32 sums) with its shared-memory matrix descriptor and its fence,
// commit and wait; mbarrier init, arrive, expect-tx and parity wait; TMA
// tile loads (cp.async.bulk.tensor, 3-D and 4-D); the block-wide segment-id intervals
// of the tile skip; and, on the host, the encoding of a TMA tensor map by
// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPointByVersion (no -lcuda: the libraries link only the
// CUDA runtime).  Outputs are stored from registers by the threads, not by
// TMA, so no proxy fence is needed before them.
//
// Shared-memory layout every operand uses: a TMA box of 64 bf16 columns
// (128 bytes) by R rows, written with CU_TENSOR_MAP_SWIZZLE_128B: row r at
// byte 128 r of the box, its eight 16-byte chunks permuted by chunk ^ (r %
// 8).  A 128-wide head is two such boxes, the second right after the
// first.  Every box starts on a 1024-byte boundary, so the swizzle pattern
// (a function of address bits 4-9) lines up with the descriptor's.
//
// The same bytes serve wgmma two ways:
// * K-major (the reduced dimension is the box's 64 contiguous columns):
//   rows in 8-row groups 1024 bytes apart (stride byte offset 1024), and
//   the k-th 16-column step of a box starts 32 k bytes into it;
// * MN-major (the box's columns are the output's N, its rows the reduced
//   dimension; transpose bit set): 8-row groups of the reduced dimension
//   1024 bytes apart (stride byte offset), the next 64 columns of N in the
//   next box (leading byte offset = the box's size), and the k-th 16-row
//   step starts 2048 k bytes in.
//
// Register layouts (PTX ISA, wgmma register fragments): the fp32
// accumulator of m64nNk16 gives warp w of the warpgroup rows 16 w .. 16 w +
// 15; lane 4 g + t holds d[4 j + e] at row 16 w + g + 8 (e / 2), column 8 j
// + 2 t + e % 2.  The A fragment of a k16 step from registers is the
// m16n8k16 one: four bf16 pairs at (g, 2t), (g + 8, 2t), (g, 2t + 8), (g +
// 8, 2t + 8), which are the accumulator's d[8 k + 0..7] for the columns 16
// k .. 16 k + 15: a P or dS tile passes from one product to the next
// without leaving registers.

#pragma once

#include <climits>
#include <type_traits>

#include <cuda.h>

#include "common.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (dynamic shared memory is
// only 16-byte aligned; launches ask for 1024 bytes of slack)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// -- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// spin until the phase of parity `parity` has completed (a fresh barrier
// counts its phase "before 0", parity 1, as complete).  A phase that has
// not completed after ~2^34 cycles (seconds) is a fault: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
  __syncwarp();  // the warp leaves the spin together (wgmma is .aligned)
}

// -- TMA -------------------------------------------------------------------

// one box of a 3-D tensor map at element coordinates (c0 innermost) into
// shared memory; completes on `bar` with the box's bytes (out-of-range
// elements arrive as zeros and count all the same)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box of a 4-D tensor map at element coordinates (c0 innermost), as
// tma_load_3d
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// -- wgmma -----------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// K-major operand: the k-th 16-column step of a [rows, 128 B] swizzled box
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t box, int k) {
  return desc_sw128(box + 32u * k, 16u, 1024u);
}

// MN-major operand (transposed): the k-th 16-row step of a pair of
// swizzled boxes `box_bytes` apart (N columns 0-63, then 64-127)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t box, int k, uint32_t box_bytes) {
  return desc_sw128(box + 2048u * k, box_bytes, 1024u);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the instruction stream: an accumulator is
// written by wgmma asynchronously, so its reads must not move above the
// wait, nor its writes below the next mma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x by the special-function unit (~2 ulp; a result below 2^-126 is 0,
// and 2^-inf is 0, which the masks rely on)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two fp32 values rounded (to nearest even) into one register of T pairs:
// the A fragment's and the stores' packing, T = __nv_bfloat16 or __half.
// An fp16 overflow becomes inf: nothing clamps it.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

// The wgmma instructions below, for 16-bit operands T (bf16, the
// default, or fp16: the same shapes, register layouts and rates); the
// fp32 accumulator registers as "+f" operands.
#define SM90_D16(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SM90_D32(d)                                                                       \
  SM90_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),       \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_D64(d)                                                                       \
  SM90_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_R16                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
#define SM90_R32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
#define SM90_R64                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
// A and B through descriptors: operands A and B, the accumulate flag ACC,
// the transpose-B immediate TB (operand numbers, as strings)
#define SM90_SS(SHAPE, TY, REGS, A, B, ACC, TB)                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" ACC ", 0;\n"                                       \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " {" REGS "}, %" A ", %" B      \
  ", p, 1, 1, 0, %" TB ";\n}\n"
// A from four registers A0..A3, B through a descriptor, then ACC and TB
// as above
#define SM90_RS(SHAPE, TY, REGS, A0, A1, A2, A3, B, ACC, TB)                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" ACC ", 0;\n"                                       \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " {" REGS "}, {%" A0 ", %" A1   \
  ", %" A2 ", %" A3 "}, %" B ", p, 1, 1, %" TB ";\n}\n"

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B read through shared-memory
// descriptors; accumulate 0 overwrites d.
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (is_f16<T>) {
    asm volatile(SM90_SS("m64n32k16", "f16", SM90_R16, "16", "17", "18", "19")
                 : SM90_D16(d)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  } else {
    asm volatile(SM90_SS("m64n32k16", "bf16", SM90_R16, "16", "17", "18", "19")
                 : SM90_D16(d)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B read through shared-memory
// descriptors; accumulate 0 overwrites d.
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (is_f16<T>) {
    asm volatile(SM90_SS("m64n64k16", "f16", SM90_R32, "32", "33", "34", "35")
                 : SM90_D32(d)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  } else {
    asm volatile(SM90_SS("m64n64k16", "bf16", SM90_R32, "32", "33", "34", "35")
                 : SM90_D32(d)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B read through shared-memory
// descriptors; accumulate 0 overwrites d.
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (is_f16<T>) {
    asm volatile(SM90_SS("m64n128k16", "f16", SM90_R64, "64", "65", "66", "67")
                 : SM90_D64(d)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  } else {
    asm volatile(SM90_SS("m64n128k16", "bf16", SM90_R64, "64", "65", "66", "67")
                 : SM90_D64(d)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the m16n8k16
// A fragment of each warp's 16 rows, T pairs), B through a descriptor.
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  if constexpr (is_f16<T>) {
    asm volatile(SM90_RS("m64n64k16", "f16", SM90_R32, "32", "33", "34", "35", "36", "37", "38")
                 : SM90_D32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
                   "n"(TRANS_B));
  } else {
    asm volatile(SM90_RS("m64n64k16", "bf16", SM90_R32, "32", "33", "34", "35", "36", "37", "38")
                 : SM90_D32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
                   "n"(TRANS_B));
  }
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (the m16n8k16
// A fragment of each warp's 16 rows, T pairs), B through a descriptor.
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  if constexpr (is_f16<T>) {
    asm volatile(SM90_RS("m64n128k16", "f16", SM90_R64, "64", "65", "66", "67", "68", "69", "70")
                 : SM90_D64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
                   "n"(TRANS_B));
  } else {
    asm volatile(SM90_RS("m64n128k16", "bf16", SM90_R64, "64", "65", "66", "67", "68", "69", "70")
                 : SM90_D64(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
                   "n"(TRANS_B));
  }
}

// -- the segment-id tile skip (the _segment_block_bounds rule) -----------------

__device__ __forceinline__ void warp_min_max(int& mn, int& mx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
}

// Block-wide, every thread: the [min, max] of ids over rows [r0, r0 + n)
// split in 64-row halves (one a warpgroup), into own[half][0..1].  Integer
// min/max: the result does not depend on arrival order.
__device__ __forceinline__ void own_intervals(const int* ids, int r0, int n, int (&own)[2][2]) {
  if (threadIdx.x < 4) own[threadIdx.x / 2][threadIdx.x % 2] = (threadIdx.x % 2) ? INT_MIN : INT_MAX;
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int v = ids[r0 + r];
    atomicMin(&own[r / 64][0], v);
    atomicMax(&own[r / 64][1], v);
  }
  __syncthreads();
}

// Block-wide, every thread: [*lo, *hi) = the first and one past the last of
// the `tile`-wide tiles of ids[0, n) whose [min, max] meets the union of
// own's intervals, or (n_tiles, 0) when none does.
__device__ __forceinline__ void live_tiles(const int* ids, int n, int tile,
                                           const int (&own)[2][2], int* lo, int* hi) {
  const int want_lo = min(own[0][0], own[1][0]), want_hi = max(own[0][1], own[1][1]);
  const int n_t = (n + tile - 1) / tile;
  if (threadIdx.x == 0) {
    *lo = n_t;
    *hi = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int tt = warp; tt < n_t; tt += blockDim.x / 32) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int c = tt * tile + lane; c < min(n, (tt + 1) * tile); c += 32) {
      mn = min(mn, ids[c]);
      mx = max(mx, ids[c]);
    }
    warp_min_max(mn, mx);
    if (lane == 0 && want_lo <= mx && mn <= want_hi) {
      atomicMin(lo, tt);
      atomicMax(hi, tt + 1);
    }
  }
  __syncthreads();
}

// Warp-wide: ids[k0 + c] for c < n into dst (INT_MIN past `end`), and the
// [min, max] of those before `end` into range (by lane 0), for a stage of
// the ring; the warp's writes are ordered before lane 0's later arrive.
__device__ __forceinline__ void stage_ids(const int* ids, int k0, int n, int end, int* dst,
                                          int* range) {
  const int lane = threadIdx.x & 31;
  int mn = INT_MAX, mx = INT_MIN;
  for (int c = lane; c < n; c += 32) {
    const int v = k0 + c < end ? ids[k0 + c] : INT_MIN;
    dst[c] = v;
    if (k0 + c < end) {
      mn = min(mn, v);
      mx = max(mx, v);
    }
  }
  warp_min_max(mn, mx);
  if (lane == 0) {
    range[0] = mn;
    range[1] = mx;
  }
  __syncwarp();
}

}  // namespace sm90

// -- host: TMA tensor maps ---------------------------------------------------

namespace sm90_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (null if the installed CUDA
// has none)
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA element type of a 16-bit T (bf16, or fp16: the same 2 bytes,
// so every stride and box below holds for both).
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A bf16 (or, by `dtype`, fp16) [batch, rows, width] tensor (contiguous)
// as a 3-D TMA map whose boxes are 64 columns by box_rows rows of one
// batch entry, 128-byte swizzle.  Rows past `rows` read as zeros, so a
// ragged last tile never sees the next batch entry's tokens.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int batch, int rows,
                            int64_t width, int box_rows,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(width) * 2 * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, dtype, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 [b, h, rows, width] tensor with a unit last stride and element
// strides st = (b, h, row), as a 4-D TMA map (dims width, rows, h, b) whose
// boxes are 64 columns by box_rows rows of one (b, h), 128-byte swizzle.
// The tensor may be any strided view (heads and batch interleaved with
// the rows, as the attention modules' projections are); every stride is a
// multiple of 16 bytes, and a zero stride only on a dimension of size 1
// (the stride of such a dimension is never used: it is given the next
// compact value).  Rows past `rows` read as zeros.
inline cudaError_t bf16_map_4d(CUtensorMap* map, const void* base, int b, int h, int rows,
                               int width, const int64_t* st, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const int64_t el[3] = {st[2], st[1], st[0]};  // row, h, b
  cuuint64_t strides[3];
  cuuint64_t prev = static_cast<cuuint64_t>(width) * 2, prev_n = 1;
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t s = dims[i + 1] == 1 ? prev * prev_n : static_cast<cuuint64_t>(el[i]) * 2;
    if (el[i] < 0 || s == 0 || s % 16 != 0) return cudaErrorInvalidValue;
    strides[i] = prev = s;
    prev_n = dims[i + 1];
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90_host
