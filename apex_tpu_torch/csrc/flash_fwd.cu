// Flash attention forward (sm_90a): the serving prefill and the generic
// flash_attention (the multi-head attention modules, varlen).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_fwd_pallas
// (its "varlen", "stream_skip", "tiles" and "stream" routes):
// softmax(q k^T * scale + mask_bias + masks) v and the fp32 log-sum-exp of
// every row, with segment ids, a causal mask aligned to the end of the
// keys, an additive fp32 mask and attention dropout.
//
// What bounds it on an H100: at the prefill shape (bh = 16, s = 1024,
// d = 128, bf16) the kernel must move ~17 MB (q, k, v read once, o
// written once: ~5 us at 3.35 TB/s) and do ~4 GFLOP on the live causal
// tiles (~4 us at the 989 TFLOP/s bf16 tensor-core rate), so a kernel at
// the roof would be bound by both about equally; at the Transformer-big
// encoder shape (bh = 512, s = 256, d = 64, non-causal) it is bound by
// bytes.  This first version is bound by neither: it multiplies with
// scalar fp32 FMAs out of shared memory (no mma/wgmma, no TMA), which caps
// it well below the tensor-core rate.  What the design does instead is
// keep the work small: each block takes its k-range from the segment ids
// before touching K/V (the _segment_block_bounds rule: a 64-column tile
// whose segment-id interval cannot meet the q-block's is never loaded) and
// cuts it at the causal limit, so padding and cross-segment tiles cost
// nothing; the S x S score matrix never leaves shared memory; loads are
// 16-byte vectors; a broadcast mask is read through zero strides, never
// repeated per head in memory.
//
// Layout: one block of 128 threads per (64-row q-block, batch*head); q,
// k, v, o are [B, H, s, d] with any strides whose last one is 1 (the
// prefill and the attention modules hand in strided views of their fused
// projections, and o is written in whatever order the caller allocated).
// Segment ids are [rows, s] int32, row = bh / seg_div, so a per-batch id
// row serves every head without being repeated.  The TPU kernel's 8-row
// lse slab ([bh, n_qb, 8, block_q]) is a Mosaic layout choice and is not
// copied: lse is a plain [bh, sq] fp32 array.  Instances: head dims 8
// (toy), 64 (Transformer-big, BERT) and 128 (GPT-1.3B), fp32 and bf16,
// with and without the mask and dropout (flash_fwd_kernel.cuh).

#include "flash_fwd_kernel.cuh"

namespace {

// The instance for a.mask and a.thresh / a.keep_prob, of one T and D.
template <typename T, int D>
cudaError_t launch_fwd_any(const FwdArgs& a, cudaStream_t stream) {
  const bool drop = !(a.thresh == 0 && a.keep_prob == 1.f);
  if (a.mask != nullptr) {
    if (drop) return launch_fwd<T, D, true, true>(a, stream);
    return launch_fwd<T, D, false, true>(a, stream);
  }
  if (drop) return launch_fwd<T, D, true, false>(a, stream);
  return launch_fwd<T, D, false, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_d(int d, const FwdArgs& a, cudaStream_t stream) {
  switch (d) {
    case 8: return launch_fwd_any<T, 8>(a, stream);
    case 64: return launch_fwd_any<T, 64>(a, stream);
    case 128: return launch_fwd_any<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: q (b, h, s), k and v
// (b, h, s), o (b, h, s), mask (b, h, row, col), in elements.  mask may be
// null (no additive mask; else fp32 [B, H, sq, sk] through its strides);
// seg_q/seg_k may be null (no segments).  thresh = round(rate * 2^32) and
// keep_prob = 1 - rate (thresh 0, keep_prob 1: no dropout).  Returns
// cudaGetLastError() after the launch.
int flash_fwd(int dtype, int d, int device, const void* q, const void* k, const void* v,
              void* o, float* lse, const float* mask, const int* seg_q, const int* seg_k,
              int seg_div, int B, int H, int sq, int sk, const int64_t* strides, float scale,
              int causal, uint32_t seed, uint32_t thresh, float keep_prob, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (sq <= 0 || B * H <= 0) return cudaSuccess;
  FwdArgs a{q, k, v, o, lse, mask, seg_q, seg_k, seg_div, B, H, sq, sk};
  for (int i = 0; i < 3; ++i) {
    a.q_st[i] = strides[i];
    a.kv_st[i] = strides[3 + i];
    a.o_st[i] = strides[6 + i];
  }
  for (int i = 0; i < 4; ++i) a.m_st[i] = strides[9 + i];
  a.scale = scale;
  a.causal = causal;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_prob = keep_prob;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, a, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
