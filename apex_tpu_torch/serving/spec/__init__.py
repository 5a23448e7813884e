"""Speculative decoding and chunked prefill: the draft-verify subsystem
of the serving engine (port of the JAX package's
``apex_tpu/serving/spec``).

The kernel half is ``flash_decode`` at ``q_len > 1``
(``csrc/flash_decode_sm90.cu`` on the card); this package is the host
policy half:

* :mod:`~apex_tpu_torch.serving.spec.proposer` — draft sources
  (:class:`Proposer`; :class:`NgramProposer`, the suffix-cache
  self-speculative baseline);
* :mod:`~apex_tpu_torch.serving.spec.verify` — the exact greedy
  verify-accept rule (:func:`commit_tokens`), so speculation changes how
  many tokens a step commits, never which;
* :class:`SpecConfig` — the engine's knobs: draft width ``k`` (the
  verify step runs at ``q_len = k + 1``), the proposer, and the
  chunked-prefill width.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from apex_tpu_torch.serving.spec.proposer import (  # noqa: F401
    NgramProposer,
    Proposer,
)
from apex_tpu_torch.serving.spec.verify import commit_tokens  # noqa: F401


@dataclasses.dataclass
class SpecConfig:
    """Speculation and chunking knobs for
    :class:`~apex_tpu_torch.serving.engine.ServingEngine`.

    ``k`` — most draft tokens per request per decode step; the verify
    step runs at ``q_len = k + 1`` (``k = 0`` turns speculation off, e.g.
    a chunked-prefill-only engine).  ``proposer`` — any
    :class:`Proposer`; None builds an :class:`NgramProposer` per engine.
    ``chunk_size`` — the chunked-prefill width in tokens (None turns
    chunking off; contexts up to ``chunk_size`` still take the whole-row
    prefill)."""

    k: int = 4
    proposer: Optional[Proposer] = None
    chunk_size: Optional[int] = None

    def __post_init__(self):
        if self.k < 0:
            raise ValueError("SpecConfig.k must be >= 0")
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError("SpecConfig.chunk_size must be >= 1")
        if self.k == 0 and self.chunk_size is None:
            raise ValueError(
                "SpecConfig with k=0 and no chunk_size enables nothing "
                "— pass spec=None instead")


__all__ = ["SpecConfig", "Proposer", "NgramProposer", "commit_tokens"]
