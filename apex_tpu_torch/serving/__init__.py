"""Inference serving on the card: paged KV cache, the decoder model,
the continuous-batching scheduler and the engine (port of the JAX
package's ``apex_tpu/serving``: the default mode, the quantized KV pool
(``kv_quant="int8"`` / ``"fp8"``), speculative decoding and chunked
prefill (``spec=SpecConfig(...)``), prefix sharing
(``prefix_sharing=True``), snapshot/restore/recover, per-page CRCs, the
export and adoption of prefilled pages, and the telemetry events).

Layers, bottom-up:

* :func:`apex_tpu_torch.ops.flash_attention` /
  :func:`~apex_tpu_torch.ops.flash_decode` — the prefill's and the
  decode step's attention, CUDA kernels on the card;
* :class:`PagedKVCache` — fixed-size pages in a preallocated device
  pool, lowest-first allocation, refcounts and copy-on-write; optionally
  int8 / fp8 codes with fp32 scales (:func:`quantize_tokens`);
  :class:`PrefixIndex` keeps finished prompt prefixes' pages shared;
* :class:`PagedDecoder` — the GPT decoder over that pool (prefill,
  decode, and ``extend`` for the verify and chunk steps);
* :mod:`~apex_tpu_torch.serving.spec` — :class:`SpecConfig`, the draft
  proposers (:class:`NgramProposer`) and the verify-accept rule
  (:func:`commit_tokens`);
* :class:`ContinuousBatchingScheduler` + :class:`ServingEngine` —
  admission/growth/preemption/retirement policy and the engine that runs
  it on the device; :func:`set_fault_hook` is the seam the chaos tier
  (:mod:`apex_tpu_torch.resilience.chaos`) injects faults through.
"""

from apex_tpu_torch.serving.convert import params_from_jax  # noqa: F401
from apex_tpu_torch.serving.engine import (  # noqa: F401
    AdmissionRefused,
    ServingEngine,
    SimClock,
    poisson_trace,
    set_fault_hook,
)
from apex_tpu_torch.serving.kv_cache import (  # noqa: F401
    PagedKVCache,
    PagePoolCorruption,
    PagePoolExhausted,
    PrefixIndex,
    quant_pool_dtype,
    quantize_tokens,
    verify_page_payload,
)
from apex_tpu_torch.serving.model import (  # noqa: F401
    PagedDecoder,
    ServingModelConfig,
    init_params,
    params_to,
    quant_qmax,
)
from apex_tpu_torch.serving.scheduler import (  # noqa: F401
    FINISHED,
    RUNNING,
    WAITING,
    ContinuousBatchingScheduler,
    QueueFullError,
    Request,
)
from apex_tpu_torch.serving.spec import (  # noqa: F401
    NgramProposer,
    Proposer,
    SpecConfig,
    commit_tokens,
)

__all__ = [
    "AdmissionRefused",
    "ServingEngine",
    "SimClock",
    "poisson_trace",
    "set_fault_hook",
    "PagedKVCache",
    "PagePoolCorruption",
    "PagePoolExhausted",
    "PrefixIndex",
    "quant_pool_dtype",
    "quantize_tokens",
    "verify_page_payload",
    "PagedDecoder",
    "ServingModelConfig",
    "init_params",
    "params_to",
    "quant_qmax",
    "params_from_jax",
    "ContinuousBatchingScheduler",
    "QueueFullError",
    "Request",
    "WAITING",
    "RUNNING",
    "FINISHED",
    "SpecConfig",
    "Proposer",
    "NgramProposer",
    "commit_tokens",
]
