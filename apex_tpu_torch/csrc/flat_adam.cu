// Fused Adam / AdamW over a flat fp32 superblock (sm_90a).
//
// Replaces the TPU kernel apex_tpu/optimizers/flat.py::FlatFusedAdam.
// _span_update (body _adam_kernel): one launch updates p, m and v of one
// contiguous span in place, from the gradient g and three scalars in
// device memory (lr, c1 = 1 - b1^t, c2 = 1 - b2^t), so that nothing in an
// optimizer step reads a value back to the host.  Per element, in the
// JAX kernel's order of operations:
//
//   g    = g + wd p                    (L2 mode, wd != 0)
//   m    = b1 m + (1 - b1) g
//   v    = b2 v + ((1 - b2) g) g
//   upd  = (m / c1) / (sqrt(v / c2) + eps)
//   upd  = upd + wd p                  (AdamW mode, wd != 0)
//   p    = p - lr upd
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, ...): nvcc
// would otherwise contract b1 m + (1 - b1) g into fused multiply-adds, and
// the kernel would no longer give the plain PyTorch version's bits.  The
// host passes b1, 1 - b1, b2, 1 - b2, eps and wd already rounded to fp32
// from double, as the JAX kernel's Python floats are.
//
// What bounds it on an H100: bytes.  Each element reads p, g, m, v and
// writes p, m, v: 28 bytes for ~14 flops.  At the GPT-1.3B superblock
// (1.318e9 elements) that is 36.9 GB, 11.0 ms at 3.35 TB/s.  The design
// is the plain answer to a streaming pass: a grid-stride loop over
// 16-byte float4 loads and stores (spans start on multiples of 1024
// elements, so every vector is aligned), int64 indices, a grid of a few
// blocks per SM.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

enum Decay { kNone = 0, kL2 = 1, kAdamW = 2 };

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

template <int kDecay>
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, float lr,
                                     float c1, float c2, const Consts& k) {
  if (kDecay == kL2) g = __fadd_rn(g, __fmul_rn(k.wd, p));
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), k.eps);
  float upd = __fdiv_rn(__fdiv_rn(m, c1), denom);
  if (kDecay == kAdamW) upd = __fadd_rn(upd, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, upd));
}

template <int kDecay>
__global__ void __launch_bounds__(kThreads)
    flat_adam_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                     float4* __restrict__ m, float4* __restrict__ v,
                     const float* __restrict__ scal, int64_t n4, Consts k) {
  const float lr = scal[0], c1 = scal[1], c2 = scal[2];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = p[i], mv = m[i], vv = v[i];
    const float4 gv = g[i];
    adam<kDecay>(pv.x, gv.x, mv.x, vv.x, lr, c1, c2, k);
    adam<kDecay>(pv.y, gv.y, mv.y, vv.y, lr, c1, c2, k);
    adam<kDecay>(pv.z, gv.z, mv.z, vv.z, lr, c1, c2, k);
    adam<kDecay>(pv.w, gv.w, mv.w, vv.w, lr, c1, c2, k);
    p[i] = pv;
    m[i] = mv;
    v[i] = vv;
  }
}

}  // namespace

extern "C" {

// p, g, m, v: fp32 [n] contiguous, 16-byte aligned, n a multiple of 4; p,
// m, v are updated in place.  scal: fp32 [3] on the device (lr, c1, c2).
// decay: 0 none, 1 L2 (wd folded into g), 2 AdamW (decoupled).  Returns
// cudaGetLastError() after the launch.
int flat_adam(int device, float* p, const float* g, float* m, float* v, const float* scal,
              int64_t n, float b1, float omb1, float b2, float omb2, float eps, float wd,
              int decay, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (n % 4 != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t n4 = n / 4;
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < sms * kBlocksPerSm ? want : sms * kBlocksPerSm);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts k{b1, omb1, b2, omb2, eps, wd};
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  if (decay == kNone)
    flat_adam_kernel<kNone><<<grid, kThreads, 0, st>>>(p4, g4, m4, v4, scal, n4, k);
  else if (decay == kL2)
    flat_adam_kernel<kL2><<<grid, kThreads, 0, st>>>(p4, g4, m4, v4, scal, n4, k);
  else if (decay == kAdamW)
    flat_adam_kernel<kAdamW><<<grid, kThreads, 0, st>>>(p4, g4, m4, v4, scal, n4, k);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
