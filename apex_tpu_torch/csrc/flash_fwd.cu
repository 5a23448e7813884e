// Flash attention forward for the serving prefill (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_fwd_pallas
// (the "varlen" and "stream_skip" routes the prefill takes, with
// segment ids and a causal mask): softmax(q k^T * scale + masks) v and
// the fp32 log-sum-exp of every row.
//
// What bounds it on an H100: at the prefill shape (bh = 16, s = 1024,
// d = 128, bf16) the kernel must move ~17 MB (q, k, v read once, o
// written once: ~5 us at 3.35 TB/s) and do ~4 GFLOP on the live causal
// tiles (~4 us at the 989 TFLOP/s bf16 tensor-core rate), so a kernel at
// the roof would be bound by both about equally.  This first version is
// bound by neither: it multiplies with scalar fp32 FMAs out of shared
// memory (no mma/wgmma, no TMA), which caps it well below the tensor-core
// rate.  What the design does instead is keep the work small: each block
// takes its k-range from the segment ids before touching K/V (the
// _segment_block_bounds rule: a 64-column tile whose segment-id interval
// cannot meet the q-block's is never loaded) and cuts it at the causal
// limit, so padding and cross-segment tiles cost nothing; the S x S score
// matrix never leaves shared memory; loads are 16-byte vectors.
//
// Layout: one block of 128 threads per (64-row q-block, batch*head); q,
// k, v, o are [B, H, s, d] with any strides whose last one is 1 (the
// prefill hands in strided views of the fused qkv projection, and o is
// written straight into the [B, s, H, d] order the output projection
// reads).  Segment ids are [rows, s] int32, row = bh / seg_div, so a
// per-batch id row serves every head without being repeated.  The TPU
// kernel's 8-row lse slab ([bh, n_qb, 8, block_q]) is a Mosaic layout
// choice and is not copied: lse is a plain [bh, sq] fp32 array.

#include "flash_fwd_kernel.cuh"

namespace {

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                       const int* seg_q, const int* seg_k, int seg_div, int B, int H, int sq,
                       int sk, const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 8: return launch_fwd<T, 8, false>(q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, st, scale, causal, 0u, 0u, 1.f, stream);
    case 128: return launch_fwd<T, 128, false>(q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, st, scale, causal, 0u, 0u, 1.f, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: q (b, h, s), k and v
// (b, h, s), o (b, h, s), in elements.  seg_q/seg_k may be null (no
// segments).  Returns cudaGetLastError() after the launch.
int flash_fwd(int dtype, int d, int device, const void* q, const void* k, const void* v,
              void* o, float* lse, const int* seg_q, const int* seg_k, int seg_div, int B,
              int H, int sq, int sk, const int64_t* strides, float scale, int causal,
              void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (sq <= 0 || B * H <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, strides, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, seg_q, seg_k, seg_div, B, H, sq, sk, strides, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
