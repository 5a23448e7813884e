"""The hand-written Hopper kernels of the package, as launchable objects.

Each :class:`~apex_tpu_torch.kernels._build.Kernel` wraps one C entry
point of one ``csrc/*.cu`` source (built with ``nvcc`` at first use) and
counts its launches.  The tensor-level wrappers that check arguments and
fall back to the plain PyTorch versions for CPU tensors live beside those
versions in :mod:`apex_tpu_torch.ops.attention`.
"""

import ctypes

from apex_tpu_torch.kernels._build import NvccError, Kernel, build_all, build_log

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_strides = ctypes.POINTER(ctypes.c_int64)

#: flash_fwd.cu — flash attention forward (the prefill's attention)
FLASH_FWD = Kernel("flash_fwd.cu", "flash_fwd", [
    _i, _i, _i,                 # dtype, d, device
    _p, _p, _p, _p, _p,         # q, k, v, o, lse
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _i, _i, _i, _i,             # B, H, sq, sk
    _strides,                   # int64[9]: q, k/v, o strides of (b, h, s)
    _f, _i, _p,                 # scale, causal, stream
])

#: flash_decode.cu — attention over the paged KV pool (the decode step)
FLASH_DECODE = Kernel("flash_decode.cu", "flash_decode", [
    _i, _i, _i,                 # dtype, d, device
    _p, _p, _p, _p,             # q, k_pages, v_pages, o
    _p, _p,                     # page_table, kv_len
    _i, _i, _i, _i, _i, _i,     # B, H, q_len, p_max, page_size, n_pages
    _strides,                   # int64[9]: q (b, h, row), pools (page,
                                # slot, head), o (b, h, row)
    _f, _p,                     # scale, stream
])

KERNELS = (FLASH_FWD, FLASH_DECODE)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["NvccError", "Kernel", "build_all", "build_log", "FLASH_FWD",
           "FLASH_DECODE", "KERNELS", "reset_launch_counts"]
