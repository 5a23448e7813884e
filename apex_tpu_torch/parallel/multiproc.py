"""Start ranks and join them into a process group.

PyTorch port of the JAX package's ``apex_tpu/parallel/multiproc.py``
(reference apex/parallel/multiproc.py).  Where JAX owns every local
device from one process, here each rank is a process:

* :func:`initialize_distributed` joins the default process group from the
  launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` and :func:`main` set
  them) or from a ``file://`` store, and selects ``cuda:(LOCAL_RANK %
  device_count)``.  It never changes the backend it is given: NCCL
  refuses two ranks on one card, so when ranks would share a card and
  ``nccl`` is asked for it raises and says to pass ``gloo``.
* :func:`main` (``python -m apex_tpu_torch.parallel.multiproc --nproc N
  script.py args`` or ``... --nproc N -m module args``) starts N copies of
  a script with that environment, as the reference's launcher does, waits
  for them, and fails (stopping the others) if one fails.
* :func:`spawn` runs ``fn(rank, world, init_file, *args)`` in N fresh
  processes (``torch.multiprocessing``'s spawn), each joined to a
  ``file://`` store: what the tests and ``chip_smoke.py`` start ranks
  with.  ``fn`` is imported by name in each child, so it must live in a
  module that imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(backend: str, init_method: Optional[str] = None,
                           *, rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           local_rank: Optional[int] = None
                           ) -> torch.device:
    """Join the default process group and return this rank's device
    (``cuda:(local_rank % device_count)``, or the CPU without a card).

    ``rank``, ``world_size`` and ``local_rank`` default to the launcher's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  With ``nccl`` and more
    ranks on this host than cards, raises ``RuntimeError``."""
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", "1"))
                  if world_size is None else world_size)
    local_rank = (int(os.environ.get("LOCAL_RANK", str(rank)))
                  if local_rank is None else local_rank)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if n_cards == 0 or local > n_cards:
            raise RuntimeError(
                f"--distributed-backend nccl with {local} ranks on "
                f"{n_cards} card(s): NCCL refuses two ranks on one device; "
                "pass --distributed-backend gloo (collectives of CUDA "
                "tensors are then staged through the host)")
    device = torch.device("cpu")
    if n_cards:
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kw)
    return device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    """Start ``--nproc`` ranks of a script or module and wait for them."""
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.parallel.multiproc",
        description="start one process per rank with RANK, WORLD_SIZE, "
                    "LOCAL_RANK, MASTER_ADDR and MASTER_PORT set")
    p.add_argument("--nproc", type=int,
                   default=max(1, torch.cuda.device_count()))
    p.add_argument("-m", dest="module", action="store_true",
                   help="the target is a module (python -m)")
    p.add_argument("target")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    port = str(_free_port())
    cmd = [sys.executable] + (["-m"] if a.module else []) + [a.target]
    procs = []
    for r in range(a.nproc):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(a.nproc), LOCAL_WORLD_SIZE=str(a.nproc),
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(cmd + a.args, env=env))
    code = 0
    try:
        while procs:
            for pr in list(procs):
                rc = pr.poll()
                if rc is None:
                    continue
                procs.remove(pr)
                if rc != 0:
                    code = code or rc
                    for other in procs:   # one rank failed: stop the rest
                        other.terminate()
            time.sleep(0.05)
    finally:
        for pr in procs:
            pr.kill()
            pr.wait()
    return code


def _spawned(index, fn, world, init_file, args):
    torch.set_num_threads(1)
    return fn(index, world, init_file, *args)


def spawn(fn, nprocs: int, init_file: str, *args, timeout: float = 600.0
          ) -> None:
    """Run ``fn(rank, nprocs, init_file, *args)`` in ``nprocs`` spawned
    processes (one CPU thread each) and wait for them; an exception in
    any rank is raised here with its traceback.  ``init_file`` names a
    fresh file for the ``file://`` store the ranks join with
    :func:`init_file_group`."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_spawned, args=(fn, nprocs, init_file, args),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks did not finish in {timeout} s")


def init_file_group(backend: str, rank: int, world: int, init_file: str,
                    local_rank: Optional[int] = None) -> torch.device:
    """:func:`initialize_distributed` on the ``file://`` store
    ``init_file`` (the rank body's first call under :func:`spawn`)."""
    return initialize_distributed(backend, f"file://{init_file}", rank=rank,
                                  world_size=world, local_rank=local_rank)


__all__ = ["initialize_distributed", "init_file_group", "main", "spawn"]

if __name__ == "__main__":
    sys.exit(main())
