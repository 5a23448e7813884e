// What every kernel source of the package shares: fp32 <-> T conversion and
// 16-byte vector loads (T = float, __nv_bfloat16, __half), the host-side
// launch helpers, the attention-dropout hash, and the one error-string
// export every library carries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace apex {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// 16 bytes of T from global memory, widened to fp32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const __half* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __half2* h = reinterpret_cast<const __half2*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Attention-dropout keep bit of score (row, col) of batch-head bh: the JAX
// package's counter hash (apex_tpu/ops/attention.py::_keep_from_coords)
// bit for bit in uint32 arithmetic.  Coordinates are global, so every
// tiling of the forward and the backward draws the same bits.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh, uint32_t row,
                                             uint32_t col, uint32_t thresh) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x ^= seed + bh * 0x27D4EB2Fu;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// Host side: raise the dynamic shared memory cap of one kernel instance on
// the current device.  The cap is a per-device attribute, so it is set on
// every launch (a cheap host call) rather than once per process.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Host side: make `device` current for the launch and give the caller's
// current device back on every return path.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) err_ = cudaSetDevice(device);
    else prev_ = -1;  // nothing to restore
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace apex

// Every launcher returns cudaGetLastError(); this names the code.  Each
// source is its own library, so each carries one copy of this symbol.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
