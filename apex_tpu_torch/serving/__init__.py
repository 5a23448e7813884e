"""Inference serving on the card: paged KV cache, the decoder model,
the continuous-batching scheduler and the engine (port of the JAX
package's ``apex_tpu/serving``, default mode).

Layers, bottom-up:

* :func:`apex_tpu_torch.ops.flash_attention` /
  :func:`~apex_tpu_torch.ops.flash_decode` — the prefill's and the
  decode step's attention, CUDA kernels on the card;
* :class:`PagedKVCache` — fixed-size pages in a preallocated device
  pool, lowest-first allocation, refcounts;
* :class:`PagedDecoder` — the GPT decoder over that pool;
* :class:`ContinuousBatchingScheduler` + :class:`ServingEngine` —
  admission/growth/preemption/retirement policy and the engine that runs
  it on the device.
"""

from apex_tpu_torch.serving.convert import params_from_jax  # noqa: F401
from apex_tpu_torch.serving.engine import (  # noqa: F401
    ServingEngine,
    SimClock,
    poisson_trace,
)
from apex_tpu_torch.serving.kv_cache import (  # noqa: F401
    PagedKVCache,
    PagePoolCorruption,
    PagePoolExhausted,
)
from apex_tpu_torch.serving.model import (  # noqa: F401
    PagedDecoder,
    ServingModelConfig,
    init_params,
    params_to,
)
from apex_tpu_torch.serving.scheduler import (  # noqa: F401
    FINISHED,
    RUNNING,
    WAITING,
    ContinuousBatchingScheduler,
    QueueFullError,
    Request,
)

__all__ = [
    "ServingEngine",
    "SimClock",
    "poisson_trace",
    "PagedKVCache",
    "PagePoolCorruption",
    "PagePoolExhausted",
    "PagedDecoder",
    "ServingModelConfig",
    "init_params",
    "params_to",
    "params_from_jax",
    "ContinuousBatchingScheduler",
    "QueueFullError",
    "Request",
    "WAITING",
    "RUNNING",
    "FINISHED",
]
