"""Device timers: CUDA events around calls on the card.

The PyTorch counterpart of ``apex_tpu/profiling/trace_report.py::
device_time_ms`` as ``bench.py::_device_ms`` and ``_timed_pair`` use it.
The JAX timer sums the device time of the ops in a profiler trace and
leaves copies out; these span whole calls with CUDA events, so what a
call launches between its kernels (allocations, small ops, launch gaps)
is in the time.  There is one method and no fallback: without a card, or
given a CPU tensor, every timer raises.

* :func:`device_time_ms` — ``steps`` calls back to back after a warm-up,
  operands as warm as the previous call left them: the roofs and the
  microbenches, timed as the JAX bench chains its calls;
* :func:`timed_pair` — two candidates in turns (a, b, b, a) on one card;
* :func:`cold_ms` — one call at a time with L2 flushed before each: the
  kernel rows of the kernel table, operands as cold as the main path
  finds them.
"""

from __future__ import annotations

import statistics
from typing import Callable, Sequence, Tuple

import torch

#: untimed calls before every :func:`device_time_ms`, and its timed calls
#: by default (``bench.py::_device_ms``'s ``steps=4``) and for the roofs
#: (its ``steps=6``); launch counts of a timed run follow from them
WARM = 1
STEPS = 4
ROOF_STEPS = 6

L2_FLUSH_BYTES = 256 * 2 ** 20   # > 5x the H100's 50 MB L2


def require_card(args: Sequence = ()) -> None:
    """Raise ``RuntimeError`` without a CUDA card or for a CPU tensor
    among ``args``: a device time is taken on the card or not at all."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: device times are "
                           "measured on the card only")
    for a in args:
        if isinstance(a, torch.Tensor) and not a.is_cuda:
            raise RuntimeError(f"a {a.device} tensor was given to a device "
                               "timer: time the CUDA path on the card")


def device_time_ms(fn: Callable, *args, steps: int = STEPS) -> float:
    """Mean milliseconds of one ``fn(*args)``: ``WARM`` untimed calls, then
    one CUDA event before and one after ``steps`` calls back to back, then
    ``synchronize()``."""
    require_card(args)
    for _ in range(WARM):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def timed_pair(fn_a: Callable, fn_b: Callable, args_a: Sequence,
               args_b: Sequence) -> Tuple[float, float]:
    """(ms of a, ms of b), each the mean of two :func:`device_time_ms`
    runs taken in the order a, b, b, a on one card, so that a drift of the
    card's clocks weighs on both alike."""
    require_card(tuple(args_a) + tuple(args_b))
    a1 = device_time_ms(fn_a, *args_a)
    b1 = device_time_ms(fn_b, *args_b)
    b2 = device_time_ms(fn_b, *args_b)
    a2 = device_time_ms(fn_a, *args_a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def cold_ms(fn: Callable[[], object], iters: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn`` with its operands cold in L2,
    as the main path finds them (each layer's weights stream through L2
    between two attention calls).  Before each timed call a 256 MiB buffer
    is written, evicting L2, and the device sleeps ~0.5 ms so the host has
    enqueued the call before its start event fires.  CUDA events around
    each call, after ``warm`` untimed calls."""
    require_card()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.mean(s.elapsed_time(e) for s, e in events)
