"""Verify-accept: exact greedy acceptance over one verify step.

The engine scores a request's ``j``-token draft in one ``flash_decode``
call at ``q_len = k + 1`` (query rows: the last committed token, then
the draft).  The model's argmax at row ``i`` is the token it would emit
after the draft prefix ``d_1..d_i``.  :func:`commit_tokens` keeps the
longest draft prefix the argmax endorses plus the model's own next token
(the bonus), so every committed token is one greedy decoding would have
produced: speculation changes how many tokens a step commits, never
which.  The commit stops early at ``eos_id`` or at the request's
remaining budget, where sequential decoding would have stopped.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def commit_tokens(draft: Sequence[int], model_argmax: Sequence[int], *,
                  eos_id: Optional[int], remaining: int,
                  ) -> Tuple[List[int], int, int]:
    """Resolve one verify step for one request.

    ``draft``: the ``j`` proposed tokens.  ``model_argmax``: ``j + 1``
    greedy ids for query rows ``[t_last, d_1..d_j]``.  ``remaining``:
    tokens the request may still generate (>= 1).

    Returns ``(committed, n_draft_kv, n_accepted)``: the tokens to append
    to the stream; how many of them are draft tokens whose K/V the
    verify step already wrote (the caller sets ``kv_len += n_draft_kv``;
    the bonus token's K/V is written by the next step, as a decode
    step's is); and the accepted prefix's length before truncation (the
    proposer's quality signal)."""
    j = len(draft)
    if len(model_argmax) != j + 1:
        raise ValueError(
            f"verify returned {len(model_argmax)} argmax rows for a "
            f"{j}-token draft (want {j + 1})")
    if remaining < 1:
        raise ValueError("commit_tokens on a request with no budget")
    a = 0
    while a < j and int(draft[a]) == int(model_argmax[a]):
        a += 1
    committed: List[int] = []
    for t in list(draft[:a]) + [model_argmax[a]]:
        committed.append(int(t))
        if len(committed) >= remaining:
            break
        if eos_id is not None and int(t) == eos_id:
            break
    return committed, min(len(committed), a), a
