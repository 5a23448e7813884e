// Identity copy of a byte range (sm_90a): the HBM roof probe.
//
// Replaces the TPU kernel bench.py::bench_hbm_roof (copy_kernel, a Pallas
// identity copy over 256 x 2048 fp32 blocks, chained so that every call
// is one real read and one real write of the whole array).  Here the
// chain is two buffers copied into each other in turn
// (apex_tpu_torch/profiling/roofs.py::hbm_roof), so every launch reads
// and writes a full buffer.
//
// What bounds it on an H100: bytes, and nothing else.  A launch reads n
// bytes and writes n; at bench.py's 16384 x 8192 fp32 (512 MiB) that is
// 1.074 GB, 0.3205 ms at 3.35 TB/s.  The design is the plain answer to a
// streaming copy: flat (not the TPU's block grid), one 16-byte access a
// thread (an int4 load and store) and a grid of 256-thread blocks that
// covers the whole range, so the hardware's block scheduler keeps every
// SM full of independent loads; the last n % 16 bytes go one byte a
// thread.  A grid-stride loop over 8 blocks an SM, four accesses a
// thread in flight, took 6.3 % more time on an H100 (NVIDIA H100 80GB
// HBM3, 700 W), the two timed in turns in one process by
// scripts/hbm_copy_ab.py; this copy also took 0.7 % less than
// Tensor.copy_ there.  The dtype does not matter: bytes are copied, so
// the result is bitwise.  Both pointers must be 16-byte aligned; the
// wrapper (roofs.py::_check_copy) refuses a tensor that is not, and the
// launcher checks again.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    copy16_kernel(const int4* __restrict__ src, int4* __restrict__ dst, int64_t n16,
                  const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
                  int tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n16) dst[i] = src[i];
  if (i < tail) dst_tail[i] = src_tail[i];
}

}  // namespace

extern "C" {

// Copy nbytes from src to dst (distinct, non-overlapping, 16-byte aligned
// device buffers): one 16-byte access a thread, then a byte tail.
// Returns cudaGetLastError() after the launch.
int hbm_copy(int device, const void* src, void* dst, int64_t nbytes, void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (nbytes < 0) return cudaErrorInvalidValue;
  if (nbytes == 0) return cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15u)
    return cudaErrorMisalignedAddress;
  const int64_t n16 = nbytes / 16;
  const int tail = static_cast<int>(nbytes % 16);
  const int64_t blocks = (n16 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = blocks < 1 ? 1u : static_cast<unsigned>(blocks);
  const uint8_t* s8 = static_cast<const uint8_t*>(src);
  uint8_t* d8 = static_cast<uint8_t*>(dst);
  copy16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(dst), n16, s8 + n16 * 16,
      d8 + n16 * 16, tail);
  return cudaGetLastError();
}

}  // extern "C"
