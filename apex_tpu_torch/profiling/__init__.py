"""Measurement on the card: device timers, the bench's roofs and floor,
and the kernel microbenches.

The PyTorch counterpart of ``apex_tpu/profiling/`` (its device timer) and
of the roof and microbench functions of ``bench.py``:

* :mod:`.timing` — :func:`device_time_ms`, :func:`timed_pair`,
  :func:`cold_ms` (CUDA events; raise without a card);
* :mod:`.roofs` — K9 :func:`hbm_copy` (``csrc/hbm_copy.cu``) and
  :func:`hbm_roof`, :func:`matmul_roof`, K10 :func:`attention_dots`
  (``csrc/attention_dots_sm90.cu``) and :func:`attention_dot_floor`;
* :mod:`.microbench` — :func:`attention_kernel` and
  :func:`layer_norm_kernel`.
"""

from apex_tpu_torch.profiling.microbench import (attention_flops,
                                                 attention_kernel,
                                                 layer_norm_bytes,
                                                 layer_norm_kernel)
from apex_tpu_torch.profiling.roofs import (DotFloor, attention_dot_floor,
                                            attention_dots, bound, copy_bytes,
                                            dots_flops, dots_keep, dots_pairs,
                                            dots_walk, hbm_copy, hbm_roof,
                                            matmul_roof)
from apex_tpu_torch.profiling.timing import (cold_ms, device_time_ms,
                                             require_card, timed_pair)

__all__ = ["DotFloor", "attention_dot_floor", "attention_dots",
           "attention_flops", "attention_kernel", "bound", "cold_ms",
           "copy_bytes", "device_time_ms", "dots_flops", "dots_keep",
           "dots_pairs", "dots_walk", "hbm_copy", "hbm_roof",
           "layer_norm_bytes", "layer_norm_kernel", "matmul_roof",
           "require_card", "timed_pair"]
