"""Divergence guards: skip bad steps, diagnose persistent blow-ups (port
of the JAX package's ``apex_tpu/resilience/guards.py``).

The amp loss scaler already skips a step whose gradients overflow
(``LossScaler.unscale`` -> ``step_if_finite``), but non-amp runs had no
equivalent and nothing ever stopped a run that skips forever.
:class:`StepGuard` covers both::

    guard = StepGuard(max_consecutive_skips=5)
    finite = guard.check(grads)      # one fused all-finite reduce
    opt.step_if_finite(finite)
    guard.update(finite, grads)      # host side: count + diagnose

``update`` raises :class:`DivergenceError` naming the first non-finite
leaf (path + nan/inf counts) once ``max_consecutive_skips`` consecutive
steps were skipped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from apex_tpu_torch.utils.tree import (keystr, tree_flatten_with_path,
                                       tree_isfinite)


class DivergenceError(RuntimeError):
    """Training skipped too many consecutive steps on non-finite values."""


def _floating(leaf) -> Optional[torch.Tensor]:
    """A floating leaf as an fp32 CPU tensor, or None for other leaves."""
    t = leaf if isinstance(leaf, torch.Tensor) else (
        torch.from_numpy(np.asarray(leaf))
        if np.asarray(leaf).dtype.kind in "fiub" else None)
    if t is None or not t.is_floating_point():
        return None
    return t.detach().to("cpu", torch.float32)


def global_grad_norm(tree: Any) -> Optional[float]:
    """Host-side global L2 norm over every floating leaf of ``tree``
    (nan/inf propagate — a diverged tree reports ``nan``/``inf``, which
    is the diagnostic).  Only call on the failure path: this copies every
    leaf to the host."""
    if tree is None:
        return None
    total, seen = 0.0, False
    for _, leaf in tree_flatten_with_path(tree)[0]:
        t = _floating(leaf)
        if t is None:
            continue
        seen = True
        total += float(torch.sum(t.double() ** 2))
    return float(np.sqrt(total)) if seen else None


def first_nonfinite_leaf(tree: Any) -> Optional[str]:
    """Human-readable description of the first leaf containing a non-finite
    value: ``"['dense']['w']: 3 nan, 1 inf (of 128)"``; None if clean.
    Host-side — only call on the failure path."""
    for path, leaf in tree_flatten_with_path(tree)[0]:
        t = _floating(leaf)
        if t is None:
            continue
        finite = torch.isfinite(t)
        if bool(finite.all()):
            continue
        nan = int(torch.isnan(t).sum())
        inf = int((~finite).sum()) - nan
        return f"{keystr(path)}: {nan} nan, {inf} inf (of {t.numel()})"
    return None


@dataclasses.dataclass
class StepGuard:
    """Host-side skip-step policy shared by amp and non-amp train loops.

    ``max_consecutive_skips`` — raise :class:`DivergenceError` when this
    many steps in a row were skipped (0/negative disables raising).  The
    counters are Python ints (one host read per step of the ``finite``
    flag)."""

    max_consecutive_skips: int = 8
    #: optional :class:`~apex_tpu_torch.telemetry.TelemetryBus` — every
    #: skip is emitted as a ``skip`` event (grad norm and loss scale)
    telemetry: Any = None
    consecutive: int = dataclasses.field(default=0, init=False)
    total_skipped: int = dataclasses.field(default=0, init=False)
    total_steps: int = dataclasses.field(default=0, init=False)

    def check(self, tree: Any) -> torch.Tensor:
        """Device-side fused all-finite reduction over the tensors of
        ``tree`` (grads or loss).  Amp runs already have ``finite`` from
        ``scaler.unscale``: feed that to :meth:`update` instead."""
        return tree_isfinite([leaf for _, leaf in
                              tree_flatten_with_path(tree)[0]
                              if isinstance(leaf, torch.Tensor)])

    def update(self, finite, tree: Any = None, *,
               loss_scale: Any = None, step: Optional[int] = None) -> bool:
        """Record one step's outcome; returns True if the step was skipped.

        ``tree`` (typically the grads) is only read on the skip path, for
        the global grad norm and (on the raise path) the first non-finite
        leaf.  ``loss_scale`` — the current scale (device scalar or
        float), read only on the skip path.  ``step`` stamps the emitted
        ``skip`` event."""
        self.total_steps += 1
        if bool(finite):
            self.consecutive = 0
            return False
        self.consecutive += 1
        self.total_skipped += 1
        scale = None if loss_scale is None else float(loss_scale)
        gnorm = global_grad_norm(tree)
        if self.telemetry is not None:
            self.telemetry.emit(
                "skip", step=step, consecutive=self.consecutive,
                total_skipped=self.total_skipped,
                total_steps=self.total_steps,
                grad_norm=gnorm, loss_scale=scale)
        if 0 < self.max_consecutive_skips <= self.consecutive:
            culprit = first_nonfinite_leaf(tree) if tree is not None else None
            where = f" — first non-finite leaf: {culprit}" if culprit else ""
            if gnorm is not None:
                where += f"; global grad-norm {gnorm:.6g}"
            if scale is not None:
                where += f"; loss scale {scale:g}"
            raise DivergenceError(
                f"{self.consecutive} consecutive steps produced non-finite "
                f"values ({self.total_skipped}/{self.total_steps} steps "
                f"skipped so far){where}. The run has diverged; lower the "
                "learning rate, raise loss-scale min_scale, or restore an "
                "earlier checkpoint "
                "(apex_tpu_torch.resilience.restore_resilient).")
        return True

    def sync_from_scaler(self, scaler_state) -> None:
        """Adopt the monotonic ``skipped`` counter of an
        :class:`~apex_tpu_torch.amp.scaler.LossScaleState`, so amp runs
        restored from a checkpoint keep an accurate total."""
        if getattr(scaler_state, "skipped", None) is not None:
            self.total_skipped = int(scaler_state.skipped)
