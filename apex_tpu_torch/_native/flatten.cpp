// Host-side multi-tensor pack/unpack — apex_C parity.
//
// The reference's apex_C extension (csrc/flatten_unflatten.cpp:16-17) exposes
// torch's flatten/unflatten for DDP bucketing; the CUDA side keeps offset
// tables in TensorListMetadata (csrc/multi_tensor_apply.cuh:19-26).  On TPU
// the *device* packing is one XLA concatenate (multi_tensor/flat.py); what
// remains genuinely host-side is checkpoint/restore and host-staged
// superblock assembly over numpy buffers, where Python-loop memcpy is the
// bottleneck.  This file is that path: C++ scatter/gather over raw byte
// buffers, threaded across tensors.
//
// Plain C ABI (ctypes-friendly; no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Simple static partition of [0, n) across up to t threads.
template <typename F>
void parallel_for(int64_t n, int threads, F f) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) f(i);
    return;
  }
  int t = static_cast<int>(std::min<int64_t>(threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int w = 0; w < t; ++w) {
    pool.emplace_back([=]() {
      for (int64_t i = w; i < n; i += t) f(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Gather n buffers into dst at the given byte offsets.
void apex_tpu_pack(const char** srcs, const int64_t* nbytes,
                   const int64_t* dst_offsets, int64_t n, char* dst,
                   int threads) {
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(dst + dst_offsets[i], srcs[i],
                static_cast<size_t>(nbytes[i]));
  });
}

// Scatter dst-resident bytes back out to n buffers.
void apex_tpu_unpack(const char* src, const int64_t* nbytes,
                     const int64_t* src_offsets, int64_t n, char** dsts,
                     int threads) {
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(dsts[i], src + src_offsets[i],
                static_cast<size_t>(nbytes[i]));
  });
}

}  // extern "C"
