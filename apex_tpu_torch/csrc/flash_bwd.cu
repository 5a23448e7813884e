// Flash attention backward (sm_90a): the gradients of the generic
// flash_attention (flash_fwd.cu), as the multi-head attention modules and
// flash_attention_varlen differentiate it.
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_bwd_pallas
// (its "tiles", "grid" and "grid_skip" routes): from (q, k, v, o, lse, do)
// it writes dq, dk and dv with the forward's additive mask, segment ids
// (with tile skipping), causal mask aligned to the end of the keys (row i
// sees columns <= i + sk - sq) and the dropout bits replayed from the
// forward's counter hash.
//
// What bounds it on an H100: at the Transformer-big encoder shape (bh =
// 512, s = 256, d = 64, bf16, non-causal) it must read q, k, v, o and do
// once and write dq, dk and dv once (~134 MB: ~0.040 ms at 3.35 TB/s) and
// do ~10 d flops per visible pair (the two score products recomputed, dv,
// dp, dk, dq: ~21 GFLOP, ~0.022 ms at 989 TFLOP/s), so at the roof it is
// bound by bytes.  This first version multiplies with scalar fp32 FMAs out
// of shared memory and is far from either bound; what its design does is
// keep every gradient deterministic and every dead tile unvisited.
//
// Design (flash_bwd_kernel.cuh, shared with the packed backward K4):
// three passes, no atomics, so two runs give bitwise-equal gradients:
//   1. delta per row, rowsum(do * o);
//   2. dk/dv per 64-column k-tile, walking its live q-tiles in order;
//   3. dq per 64-row q-tile, walking its live k-tiles in order.
// Segment ids skip dead tiles in both directions, computed in the block;
// the causal walk is shifted by sk - sq.
//
// Layout: q, o, do [B, H, sq, d]; k, v [B, H, sk, d]; dq, dk, dv written
// through their own strides, all with a unit last stride (the modules
// hand in strided views of their projections and get the gradients back
// in [s, b, h] order).  The fp32 mask is read through four strides that
// may be 0; segment ids are [rows, s] int32 with row = bh / seg_div; bh =
// b * H + head indexes the dropout hash, as in the forward.  Instances:
// head dims 8, 64 and 128, fp32 and bf16, each with and without the mask
// and dropout.

#include "flash_bwd_kernel.cuh"

namespace {

template <typename T, int D>
cudaError_t launch_any(const bwd::Args& a, cudaStream_t stream) {
  const bool drop = !(a.thresh == 0 && a.inv_keep == 1.f);
  if (a.mask != nullptr) {
    if (drop) return bwd::launch<T, D, true, true>(a, stream);
    return bwd::launch<T, D, true, false>(a, stream);
  }
  if (drop) return bwd::launch<T, D, false, true>(a, stream);
  return bwd::launch<T, D, false, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_d(int d, const bwd::Args& a, cudaStream_t stream) {
  switch (d) {
    case 8: return launch_any<T, 8>(a, stream);
    case 64: return launch_any<T, 64>(a, stream);
    case 128: return launch_any<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d: head dim (8, 64 or 128).  strides:
// (b, h, s) of q, k/v, o, do, dq, dk/dv, then the mask's (b, h, row, col),
// in elements (22 values).  lse and the delta workspace are [B*H, sq]
// fp32.  mask, seg_q/seg_k and visits may be null.  thresh =
// round(rate * 2^32) and inv_keep = 1 / (1 - rate) (thresh 0 and inv_keep
// 1: no dropout).  Launches three kernels in order on `stream`; returns
// the first launch error, or cudaSuccess.
int flash_bwd(int dtype, int d, int device, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, const float* mask, const int* seg_q, const int* seg_k,
              int seg_div, int* visits, int B, int H, int sq, int sk, const int64_t* strides,
              float scale, int causal, uint32_t seed, uint32_t thresh, float inv_keep,
              void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (sq <= 0 || sk <= 0 || B * H <= 0) return cudaSuccess;
  bwd::Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, mask, seg_q, seg_k, seg_div, visits,
              B, H, sq, sk, causal, scale, seed, thresh, inv_keep};
  int64_t* dst[6] = {a.q_st, a.kv_st, a.o_st, a.do_st, a.dq_st, a.dkv_st};
  for (int t = 0; t < 6; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  for (int i = 0; i < 4; ++i) a.m_st[i] = strides[18 + i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, a, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
