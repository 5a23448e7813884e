// Packed-QKV self-attention forward for GPT training (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_qkv_fwd_pallas:
// attention read straight from the QKV projection's output in its
// Megatron-interleaved layout, qkv [b, s, H * 3 * d] with head h's q, k and
// v at columns [h*3d, +d), [+d, +2d), [+2d, +3d); ctx [b, s, H * d] in the
// order the output projection reads; lse [b * H, s] fp32 for the backward;
// causal mask, optional segment ids, optional attention dropout.
//
// What bounds it on an H100: at the GPT-1.3B training shape (b = 4, s =
// 2048, 16 heads of 128, bf16, causal) the kernel must move ~134 MB (qkv
// read once, ctx and lse written once: ~0.04 ms at 3.35 TB/s) and do ~69
// GFLOP on the visible half of the score matrix (~0.07 ms at the 989
// TFLOP/s bf16 tensor-core rate), so at the roof it is bound by operations.
// This first version multiplies with scalar fp32 FMAs out of shared memory
// (no mma/wgmma, no TMA), which caps it far below that rate; what the
// design does is keep the bytes at the minimum and the work at the causal
// half.
//
// Design: the packed layout is only strides, so this is the flash forward
// block of flash_fwd_kernel.cuh (one 128-thread block per 64-row q-block
// and batch*head, online softmax over 64-column k-tiles, tiles past the
// causal limit never loaded) on strided views of qkv, with the dropout hash
// applied to p after the running sum takes it (the TPU order).  No head
// transposes before or after.  The TPU kernel's static schedule merges the
// causal tiles as a tree (_merge_parts); this online softmax merges them in
// column order, so the two differ at rounding level only.  lse is a plain
// [b * H, s] fp32 array, not the TPU's [b, n_hg, group, n_b, 8, block] slab.

#include "flash_fwd_kernel.cuh"

namespace {

template <typename T, int D>
cudaError_t launch_qkv(const void* qkv, void* ctx, float* lse, const int* seg_q,
                       const int* seg_k, int seg_div, int B, int H, int s, float scale,
                       int causal, uint32_t seed, uint32_t thresh, float keep_prob,
                       cudaStream_t stream) {
  const int64_t row = static_cast<int64_t>(H) * 3 * D;  // one token's qkv row
  const int64_t crow = static_cast<int64_t>(H) * D;     // one token's ctx row
  const T* q = static_cast<const T*>(qkv);
  FwdArgs a{q, q + D, q + 2 * D, ctx, lse, nullptr, seg_q, seg_k, seg_div, B, H, s, s,
            // (b, h, s) strides of the q, k/v and ctx views; no mask
            {s * row, 3 * D, row}, {s * row, 3 * D, row}, {s * crow, D, crow}, {0, 0, 0, 0},
            scale, causal, seed, thresh, keep_prob};
  if (thresh == 0 && keep_prob == 1.f) return launch_fwd<T, D, false, false>(a, stream);
  return launch_fwd<T, D, true, false>(a, stream);
}

template <int D>
int run(int dtype, int device, const void* qkv, void* ctx, float* lse, const int* seg_q,
        const int* seg_k, int seg_div, int B, int H, int s, float scale, int causal,
        uint32_t seed, uint32_t thresh, float keep_prob, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (s <= 0 || B * H <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_qkv<float, D>(qkv, ctx, lse, seg_q, seg_k, seg_div, B, H, s, scale, causal,
                                seed, thresh, keep_prob, st);
  if (dtype == 1)
    return launch_qkv<__nv_bfloat16, D>(qkv, ctx, lse, seg_q, seg_k, seg_div, B, H, s, scale,
                                        causal, seed, thresh, keep_prob, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d: head dim (128 here, 64 in
// flash_qkv_fwd_d64: one entry point an instance, so that launches count
// by head dim).  seg_q/seg_k may be null (no segments); with them, seg row
// = (b * H + h) / seg_div.  thresh = round(rate * 2^32) (0: no dropout),
// keep_prob = 1 - rate.  Returns cudaGetLastError() after the launch.
int flash_qkv_fwd(int dtype, int d, int device, const void* qkv, void* ctx, float* lse,
                  const int* seg_q, const int* seg_k, int seg_div, int B, int H, int s,
                  float scale, int causal, uint32_t seed, uint32_t thresh, float keep_prob,
                  void* stream) {
  if (d != 128) return cudaErrorInvalidValue;
  return run<128>(dtype, device, qkv, ctx, lse, seg_q, seg_k, seg_div, B, H, s, scale, causal,
                  seed, thresh, keep_prob, stream);
}

// The same at head dim 64 (d must be 64).
int flash_qkv_fwd_d64(int dtype, int d, int device, const void* qkv, void* ctx, float* lse,
                      const int* seg_q, const int* seg_k, int seg_div, int B, int H, int s,
                      float scale, int causal, uint32_t seed, uint32_t thresh, float keep_prob,
                      void* stream) {
  if (d != 64) return cudaErrorInvalidValue;
  return run<64>(dtype, device, qkv, ctx, lse, seg_q, seg_k, seg_div, B, H, s, scale, causal,
                 seed, thresh, keep_prob, stream);
}

}  // extern "C"
