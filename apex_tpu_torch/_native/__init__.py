"""Native host runtime: ``g++`` build at first use + ctypes bindings.

Port of the JAX package's ``apex_tpu/_native``, with byte-identical
copies of its two sources: the threaded multi-tensor pack/unpack
(``flatten.cpp``, the packed checkpoint format's gather) and the
prefetching record loader (``dataloader.cpp``).  They compile at first
use with ``g++`` into one shared object in the git-ignored
``apex_tpu_torch/_build/`` (keyed by a digest of the sources), bound
through ctypes; nothing is built on import.

A failed build raises :class:`NativeBuildError` carrying the compiler's
standard error: there is no silent fallback.  :func:`pack_host_plain` and
:func:`unpack_host_plain` are the numpy statements of what the native
pack and unpack do, which the tests hold the native ones against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), "_build")
_SOURCES = ("flatten.cpp", "dataloader.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or refused the native sources."""


def _digest() -> str:
    h = hashlib.sha256()
    for s in _SOURCES:
        with open(os.path.join(_SRC_DIR, s), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def library_path() -> str:
    """Where the shared object is (or will be) built."""
    return os.path.join(BUILD_DIR, f"native_{_digest()}.so")


def _build() -> ctypes.CDLL:
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
        # build to a temp name then rename: atomic against concurrent builds
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                proc = subprocess.run(
                    ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                     "-pthread", *srcs, "-o", tmp],
                    capture_output=True, text=True)
            except OSError as e:
                raise NativeBuildError(f"cannot run g++: {e}") from e
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"g++ failed (exit {proc.returncode}) building "
                    f"{', '.join(_SOURCES)}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(out)
    ptr, i64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    lib.apex_tpu_pack.restype = None
    lib.apex_tpu_pack.argtypes = [ctypes.POINTER(ptr), i64p, i64p,
                                  ctypes.c_int64, ptr, ctypes.c_int]
    lib.apex_tpu_unpack.restype = None
    lib.apex_tpu_unpack.argtypes = [ptr, i64p, i64p, ctypes.c_int64,
                                    ctypes.POINTER(ptr), ctypes.c_int]
    lib.axl_open.restype = ctypes.c_void_p
    lib.axl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int]
    lib.axl_next.restype = ctypes.c_int
    lib.axl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.axl_num_records.restype = ctypes.c_int64
    lib.axl_num_records.argtypes = [ctypes.c_void_p]
    lib.axl_error_count.restype = ctypes.c_int64
    lib.axl_error_count.argtypes = [ctypes.c_void_p]
    lib.axl_close.restype = None
    lib.axl_close.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on first call; raises
    :class:`NativeBuildError` when it cannot be built."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _build()
    return _lib


def _threads(threads: int) -> int:
    return threads or min(8, max(1, os.cpu_count() or 1))


# ---------------------------------------------------------------------------
# pack/unpack (apex_C flatten/unflatten parity, host side)
# ---------------------------------------------------------------------------


def pack_host(arrays: Sequence[np.ndarray], offsets: Sequence[int],
              total_bytes: int, *, threads: int = 0,
              out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather numpy arrays into one byte buffer at the given byte offsets
    (the memcpys threaded in C++)."""
    lib = get_lib()
    if out is None:
        out = np.zeros(total_bytes, np.uint8)
    assert out.nbytes >= total_bytes
    arrs = [np.ascontiguousarray(a) for a in arrays]
    n = len(arrs)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    nbytes = (ctypes.c_int64 * n)(*[a.nbytes for a in arrs])
    offs = (ctypes.c_int64 * n)(*list(offsets))
    lib.apex_tpu_pack(
        srcs, nbytes, offs, ctypes.c_int64(n),
        ctypes.c_void_p(out.ctypes.data), ctypes.c_int(_threads(threads)))
    return out


def unpack_host(buf: np.ndarray, arrays: Sequence[np.ndarray],
                offsets: Sequence[int], *, threads: int = 0) -> None:
    """Scatter a byte buffer back into the (preallocated, contiguous)
    numpy arrays at the given byte offsets — in place."""
    lib = get_lib()
    buf = np.ascontiguousarray(buf.view(np.uint8).reshape(-1))
    n = len(arrays)
    for a in arrays:
        assert a.flags["C_CONTIGUOUS"], "unpack_host needs contiguous dsts"
    dsts = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    nbytes = (ctypes.c_int64 * n)(*[a.nbytes for a in arrays])
    offs = (ctypes.c_int64 * n)(*list(offsets))
    lib.apex_tpu_unpack(
        ctypes.c_void_p(buf.ctypes.data), nbytes, offs,
        ctypes.c_int64(n), dsts, ctypes.c_int(_threads(threads)))


def pack_host_plain(arrays: Sequence[np.ndarray], offsets: Sequence[int],
                    total_bytes: int) -> np.ndarray:
    """The plain version of :func:`pack_host`: a numpy loop."""
    out = np.zeros(total_bytes, np.uint8)
    for a, off in zip(arrays, offsets):
        a = np.ascontiguousarray(a)
        out[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
    return out


def unpack_host_plain(buf: np.ndarray, arrays: Sequence[np.ndarray],
                      offsets: Sequence[int]) -> None:
    """The plain version of :func:`unpack_host`: a numpy loop."""
    buf = buf.view(np.uint8).reshape(-1)
    for a, off in zip(arrays, offsets):
        a.view(np.uint8).reshape(-1)[:] = buf[off:off + a.nbytes]
