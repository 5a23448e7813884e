"""K9 (``csrc/hbm_copy.cu``) against the grid-stride copy it replaced,
timed in turns on one card.

    python3 scripts/hbm_copy_ab.py [--out FILE.json]

Both candidates copy the HBM roof's two 16384 x 8192 fp32 buffers into
each other in turn, as ``profiling.roofs.hbm_roof`` does, so every launch
reads and writes 512 MiB.  The grid-stride copy (8 blocks of 256 threads
an SM, four 16-byte accesses a thread in flight) is built here from the
source below with the package's ``nvcc`` flags into the git-ignored
``apex_tpu_torch/_build/``.  ``profiling.timing.timed_pair`` takes each
pair in the order a, b, b, a, three times over: K9 against the
grid-stride copy, and K9 against ``Tensor.copy_`` (a device-to-device
memcpy).  Prints the card and one JSON line with each candidate's ms and
TB/s a launch; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from apex_tpu_torch.kernels import _build  # noqa: E402
from apex_tpu_torch.profiling import roofs, timing  # noqa: E402

GRID_STRIDE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256, kBlocksPerSm = 8, kInFlight = 4;

__global__ void __launch_bounds__(kThreads)
    copy_stride(const int4* __restrict__ src, int4* __restrict__ dst, int64_t n16) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kInFlight - 1) * stride < n16; i += kInFlight * stride) {
    int4 r[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) r[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) dst[i + u * stride] = r[u];
  }
  for (; i < n16; i += stride) dst[i] = src[i];
}

extern "C" int copy_stride_launch(const void* src, void* dst, int64_t nbytes,
                                  void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (nbytes % 16) return cudaErrorInvalidValue;
  copy_stride<<<sms * kBlocksPerSm, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), nbytes / 16);
  return cudaGetLastError();
}
"""
ROUNDS = 3


def grid_stride_copy():
    """The grid-stride copy as ``fn(x, out)``, built from source."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    src = _build.BUILD_DIR / "hbm_copy_grid_stride.cu"
    lib = src.with_suffix(".so")
    src.write_text(GRID_STRIDE_SOURCE)
    subprocess.run([_build.cuda_tool(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    launch = ctypes.CDLL(str(lib)).copy_stride_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
    launch.restype = ctypes.c_int

    def copy(x, out):
        code = launch(x.data_ptr(), out.data_ptr(),
                      x.numel() * x.element_size(),
                      torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"copy_stride: CUDA error {code}")
        return out
    return copy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    timing.require_card()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    stride = grid_stride_copy()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(16384, 8192, generator=gen, device="cuda")
    y = torch.empty_like(x)
    if not torch.equal(stride(x, y).view(torch.int32), x.view(torch.int32)):
        raise AssertionError("the grid-stride copy is not bitwise")

    def pingpong(copy):
        def run():
            copy(x, y)
            copy(y, x)
        return run

    k9 = pingpong(roofs.hbm_copy)
    candidates = {"grid_stride": pingpong(stride),
                  "copy_": pingpong(lambda a, b: b.copy_(a))}
    nbytes = roofs.copy_bytes(x)
    result = {"card": card, "launch_bytes": nbytes, "pairs": {}}
    for name, other in candidates.items():
        rounds = [timing.timed_pair(k9, other, (), ()) for _ in range(ROUNDS)]
        ms = {"hbm_copy": [a / 2 for a, _ in rounds],
              name: [b / 2 for _, b in rounds]}
        result["pairs"][f"hbm_copy vs {name}"] = {
            who: {"ms": t, "tb_s": [nbytes / m / 1e9 for m in t]}
            for who, t in ms.items()}
    print(card)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
