// Paged decode attention for the serving engine (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_decode_pallas:
// attention of the last q_len positions of each request against that
// request's K/V, which lives in fixed-size pages of a shared pool and is
// found through a page table.  Query row i sees columns
// [0, kv_len - q_len + i]; a row whose window is empty returns exact
// zeros.
//
// What bounds it on an H100: bytes.  A decode step reads each live K/V
// page once (2 * sum(kv_len) * h * d * 2 bytes in bf16) and does 4 d
// flops per (query row, visible column), about one flop per byte, far
// below the ~295 flops per byte where the tensor cores become the limit.
// What the design does about it: every block reads only the pages its
// request actually uses (the tile loop ends at the last visible column,
// not at p_max), loads them with 16-byte vector loads into shared memory
// once per (request, head), and never gathers the pages into a
// contiguous copy the way the plain version does.  This first version
// has one block per (request, head, 16 query rows), 128 blocks at
// the main path's batch of 8 x 16 heads, with no split over pages: a
// split-K would need a cross-block reduction, and the engine's bitwise
// batched == sequential contract needs each row's sums in one fixed
// order.  The TPU kernel's scalar-prefetch of the page table becomes a
// per-tile read of the table by the block itself.
//
// Layout: q [B, H, q_len, d] and o [B, H, q_len, d] with any strides
// whose last one is 1 (the engine hands in a view of the fused qkv
// projection and reads o back in [B, q_len, H, d] order); pools
// [n_pages, page_size, H, d] with strides (page, slot, head) shared by K
// and V; page_table [B, p_max] int32; kv_len [B] int32.

#include "flash_tile.cuh"

namespace {

using flash::kBK;
using flash::kThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp, T* __restrict__ o,
                        const int* __restrict__ page_table, const int* __restrict__ kv_len,
                        int q_len, int p_max, int page_size, int n_pages, int64_t qsb,
                        int64_t qsh, int64_t qss, int64_t psp, int64_t pss, int64_t psh,
                        int64_t osb, int64_t osh, int64_t oss, float scale) {
  constexpr int RM = 1;  // 16 query rows per block; grid.x covers any q_len
  using TL = flash::Tile<D, RM>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KPs = Qs + TL::BQ * TL::QS;
  float* Vs = KPs + TL::KP;
  __shared__ int64_t col_off[kBK];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * TL::BQ;
  const int nrows = min(TL::BQ, q_len - r0);
  const int kv = kv_len[b];
  const int shift = kv - q_len + r0;  // row i of this block sees cols <= shift + i
  // columns any row of this block may see, capped at the table's reach
  const int ncols = max(0, min(shift + nrows, p_max * page_size));
  const int* table = page_table + static_cast<int64_t>(b) * p_max;

  flash::load_q<D, RM>(Qs, q + b * qsb + h * qsh + r0 * qss, qss, nrows);

  const int ty = tid >> 3;
  flash::Acc<D, RM> acc;
  acc.init();
  for (int k0 = 0; k0 < ncols; k0 += kBK) {
    if (tid < kBK) {
      const int col = k0 + tid;
      int64_t off = -1;
      if (col < ncols) {
        const int page = table[col / page_size];
        // a page id outside the pool is a corrupt table: stop the launch
        // (the caller sees an error), as the plain version's indexing raises
        if (page < 0 || page >= n_pages) __trap();
        off = page * psp + static_cast<int64_t>(col % page_size) * pss + h * psh;
      }
      col_off[tid] = off;
    }
    __syncthreads();
    flash::load_kv<D, RM>(KPs, Vs, kp, vp, col_off);
    __syncthreads();
    flash::attend_tile<D, RM>(acc, Qs, KPs, Vs, scale, [&](int i, int j) {
      const int r = ty * RM + i;
      return r < nrows && k0 + j <= shift + r;
    });
  }
  flash::finish<D, RM>(acc, o + b * osb + h * osh + r0 * oss, oss, nrows, nullptr);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, void* o,
                   const int* page_table, const int* kv_len, int B, int H, int q_len, int p_max,
                   int page_size, int n_pages, const int64_t* st, float scale,
                   cudaStream_t stream) {
  using TL = flash::Tile<D, 1>;
  const cudaError_t attr = flash::allow_smem(flash_decode_kernel<T, D>, TL::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((q_len + TL::BQ - 1) / TL::BQ, H, B);
  flash_decode_kernel<T, D><<<grid, kThreads, TL::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<T*>(o), page_table, kv_len, q_len, p_max, page_size, n_pages, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kp, const void* vp, void* o,
                       const int* page_table, const int* kv_len, int B, int H, int q_len,
                       int p_max, int page_size, int n_pages, const int64_t* st, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, kp, vp, o, page_table, kv_len, B, H, q_len, p_max, page_size, n_pages, st, scale, stream);
    case 128: return launch<T, 128>(q, kp, vp, o, page_table, kv_len, B, H, q_len, p_max, page_size, n_pages, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: q (b, h, row), pools
// (page, slot, head), o (b, h, row), in elements.  Returns
// cudaGetLastError() after the launch.
int flash_decode(int dtype, int d, int device, const void* q, const void* k_pages,
                 const void* v_pages, void* o, const int* page_table, const int* kv_len, int B,
                 int H, int q_len, int p_max, int page_size, int n_pages,
                 const int64_t* strides, float scale, void* stream) {
  const flash::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (B <= 0 || H <= 0 || q_len <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k_pages, v_pages, o, page_table, kv_len, B, H, q_len, p_max, page_size, n_pages, strides, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k_pages, v_pages, o, page_table, kv_len, B, H, q_len, p_max, page_size, n_pages, strides, scale, s);
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
