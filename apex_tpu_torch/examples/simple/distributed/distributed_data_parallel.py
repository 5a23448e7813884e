#!/usr/bin/env python
"""Minimal data-parallel demo (reference
examples/simple/distributed/distributed_data_parallel.py).

PyTorch port of the JAX package's example of the same name: a linear
model under amp O2 (bf16 compute, fp32 masters, dynamic loss scaling),
``FusedSGD`` with momentum, 20 steps, each rank training on its 8 rows of
the global batch and the gradients averaged with
:func:`~apex_tpu_torch.parallel.all_reduce_grads`.  One process a rank::

    python -m apex_tpu_torch.parallel.multiproc --nproc 2 \\
        -m apex_tpu_torch.examples.simple.distributed.distributed_data_parallel \\
        --distributed-backend gloo

``main`` returns the final loss (the mean over the ranks).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import all_reduce_grads, comm
from apex_tpu_torch.parallel.multiproc import initialize_distributed

STEPS = 20


def main(argv=None, device=None, *, params: Optional[dict] = None,
         data: Optional[tuple] = None) -> float:
    """Train 20 steps on this rank's rows and return the final loss.
    ``params`` ({"w": [16, 4], "b": [4]}) and ``data`` ((x [8 n, 16],
    y [8 n, 4]), the global batch) replace the seeded ones."""
    p = argparse.ArgumentParser()
    p.add_argument("--distributed-backend", default="nccl")
    a = p.parse_args(argv)
    if not dist.is_initialized():
        card = initialize_distributed(a.distributed_backend)
        device = device or card
    n, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device or "cuda")
    if rank == 0:
        print(f"running data-parallel over {n} ranks")
    gen = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        params = {"w": torch.randn(16, 4, generator=gen, device=dev),
                  "b": torch.zeros(4, device=dev)}
    if data is None:
        data = (torch.randn(8 * n, 16, generator=gen, device=dev),
                torch.randn(8 * n, 4, generator=gen, device=dev))
    w, b = (params[k].to(dev, torch.float32).clone().requires_grad_()
            for k in ("w", "b"))
    x, y = (t.to(dev, torch.float32)[8 * rank:8 * (rank + 1)] for t in data)
    a_state = amp.initialize("O2")
    half = a_state.props.cast_model_type
    opt = FusedSGD([w, b], lr=0.05, momentum=0.9)
    sc = a_state.scaler.init(dev)

    def loss_fn(w, b):
        pred = x.to(half) @ w.to(half) + b.to(half)
        return torch.mean((pred.float() - y) ** 2)

    for i in range(STEPS):
        grads = torch.autograd.grad(a_state.scaler.scale(loss_fn(w, b), sc),
                                    (w, b))
        grads, finite = a_state.scaler.unscale(grads, sc)
        grads = all_reduce_grads(grads, dist.group.WORLD)
        opt.step_if_finite(finite, grads=grads)
        sc = a_state.scaler.update(sc, finite)
        with torch.no_grad():
            loss = comm.all_reduce(loss_fn(w, b), dist.group.WORLD) / n
        if i % 5 == 0 and rank == 0:
            print(f"step {i:3d}  loss {float(loss):.5f}")
    if rank == 0:
        print("final loss:", float(loss))
    return float(loss)


if __name__ == "__main__":
    main(sys.argv[1:])
