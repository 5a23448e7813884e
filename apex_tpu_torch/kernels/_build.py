"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` compiles, at first use, into a shared library of its
own with a plain C interface — no PyTorch headers, so a build takes
seconds, not minutes::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

All sources build at once, one ``nvcc`` process each.  Every source
includes ``csrc/common.cuh``, so every library exports the one symbol
``kernel_error_string`` that names a launcher's CUDA error code.
Libraries land in
``apex_tpu_torch/_build/`` (git-ignored) under a name keyed by a hash of
the sources and flags, so a stale library is never loaded.  Only the
package's own sources are compiled; nothing is fetched.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
at the toolkit's default ``/usr/local/cuda/bin/nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory / spill report) per
#: source, from the last build in this process
build_log: Dict[str, str] = {}


class NvccError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    candidates: List[Path] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise NvccError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                    "the CUDA kernels are built from source at first use")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [source] + sorted(CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel;
    returns the wall seconds spent (0.0 when everything was built)."""
    with _lock:
        todo = [s for s in sources() if not _library(s).exists()]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        BUILD_DIR.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        jobs = []
        for src in todo:
            out = _library(src)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            build_log[src.name] = log
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        if failed:
            raise NvccError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def load(source_name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source_name>``, building first if
    needed."""
    lib = _libs.get(source_name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_library(CSRC / source_name)))
        _libs[source_name] = lib
    return lib


class Kernel:
    """One C entry point of one source, bound lazily, with a count of
    the launches made through it.

    Calling the object launches: it passes the arguments on, raises if
    the C function reports a CUDA error (the launcher returns
    ``cudaGetLastError()`` right after the launch), and only then adds
    one to :attr:`launches`."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _bind(self):
        lib = load(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string  # every source exports it (common.cuh)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._errstr = fn, err
        return fn

    def __call__(self, *args) -> None:
        fn = self._fn or self._bind()
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code} "
                               f"({self._errstr(code).decode()})")
        self.launches += 1
