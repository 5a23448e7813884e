// Packed-QKV self-attention backward for GPT training (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_qkv_bwd_pallas:
// from (qkv, dctx, ctx, lse) it writes dqkv [b, s, H * 3 * d] in the same
// Megatron-interleaved layout as qkv, so the projection's backward reads it
// with no transpose.  Per (row r, column c) of a visible tile:
//   p  = exp(q.k * scale - lse[r])                    (undropped)
//   dp = dctx[r] . v[c]
//   with dropout: p~ = keep ? p / (1 - rate) : 0, dp~ = keep ? dp / (1 - rate) : 0
//   dv[c] += p~ dctx[r];  ds = p (dp~ - delta[r]) scale;  dk[c] += ds q[r];  dq[r] += ds k[c]
// with delta[r] = dctx[r] . ctx[r] and the keep bits redrawn from the
// forward's counter hash at the same global (row, col).
//
// What bounds it on an H100: at the GPT-1.3B training shape (b = 4, s =
// 2048, 16 heads of 128, bf16, causal) it moves ~168 MB (qkv, dctx, ctx,
// lse read once, dqkv written once: ~0.05 ms) and does ~2.5x the
// forward's operations (~172 GFLOP on the causal half with the scores
// recomputed in both passes below: ~0.17 ms at 989 TFLOP/s), so at the
// roof it is bound by operations.  This first version uses scalar fp32
// FMAs out of shared memory and is far from that.
//
// Design: the packed layout is only strides, so this is the generic
// backward of flash_bwd_kernel.cuh (K2's three deterministic passes:
// delta, dk/dv per k-tile, dq per q-tile, no atomics) run on strided views:
// head h's q, k and v at columns h*3d + {0, d, 2d} of a token's qkv row,
// ctx and dctx at h*d of a [b, s, H*d] row, and dq, dk, dv written into
// dqkv at the same places as q, k and v.  No head transposes before or
// after; two runs give bitwise-equal gradients.

#include "flash_bwd_kernel.cuh"

namespace {

template <typename T, int D>
cudaError_t launch_qkv(const void* qkv, const void* dctx, const void* ctx, const float* lse,
                       float* delta, void* dqkv, const int* seg_q, const int* seg_k,
                       int seg_div, int B, int H, int s, float scale, int causal, uint32_t seed,
                       uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const int64_t row = static_cast<int64_t>(H) * 3 * D;  // one token's qkv row
  const int64_t crow = static_cast<int64_t>(H) * D;     // one token's ctx row
  const T* q = static_cast<const T*>(qkv);
  T* dq = static_cast<T*>(dqkv);
  const int64_t packed[3] = {s * row, 3 * D, row}, flat[3] = {s * crow, D, crow};
  bwd::Args a{q, q + D, q + 2 * D, ctx, dctx, lse, delta, dq, dq + D, dq + 2 * D, nullptr,
              seg_q, seg_k, seg_div, nullptr, B, H, s, s, causal, scale, seed, thresh,
              inv_keep};
  for (int i = 0; i < 3; ++i) {
    a.q_st[i] = a.kv_st[i] = a.dq_st[i] = a.dkv_st[i] = packed[i];
    a.o_st[i] = a.do_st[i] = flat[i];
  }
  if (thresh == 0 && inv_keep == 1.f) return bwd::launch<T, D, false, false>(a, stream);
  return bwd::launch<T, D, false, true>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d: head dim (128).  qkv/dqkv [B, s,
// H*3*d], ctx/dctx [B, s, H*d] (all contiguous), lse and the delta
// workspace [B*H, s] fp32.  seg_q/seg_k may be null; seg row = (b*H + h) /
// seg_div.  thresh = round(rate * 2^32) and inv_keep = 1 / (1 - rate)
// (thresh 0 and inv_keep 1: no dropout).  Launches three kernels in order
// on `stream`; returns the first launch error, or cudaSuccess.
int flash_qkv_bwd(int dtype, int d, int device, const void* qkv, const void* dctx,
                  const void* ctx, const float* lse, float* delta, void* dqkv,
                  const int* seg_q, const int* seg_k, int seg_div, int B, int H, int s,
                  float scale, int causal, uint32_t seed, uint32_t thresh, float inv_keep,
                  void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (s <= 0 || B * H <= 0) return cudaSuccess;
  if (d != 128) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_qkv<float, 128>(qkv, dctx, ctx, lse, delta, dqkv, seg_q, seg_k, seg_div, B, H,
                                  s, scale, causal, seed, thresh, inv_keep, st);
  if (dtype == 1)
    return launch_qkv<__nv_bfloat16, 128>(qkv, dctx, ctx, lse, delta, dqkv, seg_q, seg_k,
                                          seg_div, B, H, s, scale, causal, seed, thresh,
                                          inv_keep, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
