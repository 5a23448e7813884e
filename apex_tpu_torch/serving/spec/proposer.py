"""Draft-token proposers: the policy half of speculative decoding.

A proposer guesses the next ``k`` tokens of a request's greedy stream so
the engine can score them all in one verify step.  A guess costs
throughput when wrong, never correctness (the verify-accept rule keeps
only what the model endorses), and an empty draft is always legal: the
engine then runs a plain decode step.

:class:`NgramProposer` needs no draft model and no device work: per
request it maps the recent n-grams of the request's own history to where
they last occurred, and drafts what followed.  Indexing is incremental,
each committed token indexed once.
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class Proposer(Protocol):
    """What the engine needs from a draft source.

    ``propose(rid, context, k)`` returns up to ``k`` draft tokens for the
    request whose committed history (prompt + generated) is ``context``;
    ``context`` only grows for a live rid.  ``observe(drafted,
    accepted)`` is each verify step's feedback; ``release(rid)`` drops
    the request's state on every terminal path (retire, timeout, shed)."""

    def propose(self, rid: int, context: Sequence[int],
                k: int) -> List[int]: ...

    def observe(self, drafted: int, accepted: int) -> None: ...

    def release(self, rid: int) -> None: ...


class NgramProposer:
    """Suffix-cache self-speculative proposer.

    Per request, every n-gram (``ngram_n`` down to 1) of the committed
    history points at the position just after its latest occurrence;
    ``propose`` looks the current suffix up, longest n first, and drafts
    the continuation.  A continuation that runs past the end of history
    reads on from the draft itself, so a cycle of period p drafts all
    ``k`` tokens.  Deterministic (latest occurrence wins); ``seed`` is
    recorded and unused.  The state derives from the committed tokens
    alone, so it stays valid across a preemption, and a rid reused with
    another history is detected and re-indexed."""

    def __init__(self, ngram_n: int = 3, seed: int = 0):
        if ngram_n < 1:
            raise ValueError("ngram_n must be >= 1")
        self.ngram_n = int(ngram_n)
        self.seed = int(seed)
        # rid -> {ngram: continuation start}; how many tokens of the
        # rid's history are indexed; the last indexed token
        self._index: Dict[int, Dict[Tuple[int, ...], int]] = {}
        self._indexed: Dict[int, int] = {}
        self._tail: Dict[int, int] = {}
        self.drafted = 0
        self.accepted = 0

    def _reindex(self, rid: int, context: Sequence[int]) -> Dict:
        idx = self._index.setdefault(rid, {})
        done = self._indexed.get(rid, 0)
        # the cursor sits at most at len - 1 for a history that only
        # grew: at or past len, or a changed last indexed token, means
        # the rid now carries another history
        if done and (done >= len(context)
                     or context[done - 1] != self._tail.get(rid)):
            idx.clear()
            done = 0
        # grams ending at t for t < len - 1 (their continuation exists)
        for t in range(done, len(context) - 1):
            for n in range(1, self.ngram_n + 1):
                if t + 1 >= n:
                    idx[tuple(context[t + 1 - n:t + 1])] = t + 1
        done = max(done, len(context) - 1)
        self._indexed[rid] = done
        if done:
            self._tail[rid] = int(context[done - 1])
        return idx

    def propose(self, rid: int, context: Sequence[int],
                k: int) -> List[int]:
        if k <= 0 or len(context) < 2:
            return []
        idx = self._reindex(rid, context)
        L = len(context)
        for n in range(min(self.ngram_n, L - 1), 0, -1):
            start = idx.get(tuple(context[L - n:L]))
            if start is None or start >= L:
                continue
            out: List[int] = []
            while len(out) < k:
                q = start + len(out)
                # past the history the draft continues from itself
                out.append(int(context[q]) if q < L else out[q - L])
            return out
        return []

    def observe(self, drafted: int, accepted: int) -> None:
        self.drafted += int(drafted)
        self.accepted += int(accepted)

    def release(self, rid: int) -> None:
        self._index.pop(rid, None)
        self._indexed.pop(rid, None)
        self._tail.pop(rid, None)

    @property
    def acceptance_rate(self) -> float:
        """Accepted over drafted, lifetime (0.0 before any draft)."""
        return self.accepted / self.drafted if self.drafted else 0.0
