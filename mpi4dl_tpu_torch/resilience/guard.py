"""Anomaly guard: the per-step numerical tripwire (counterpart of
``mpi4dl_tpu/resilience/guard.py``).

A single NaN (poison batch, bf16 overflow, flaky interconnect bit) must not
kill a multi-day run.  The guard checks every step's loss for finiteness
(and, opt-in, the reported grad norm against a limit); on a hit the
supervised loop rolls state back to the last good checkpoint, skips past
the poison batch, and records ``anomaly``/``recovery`` events in the RunLog
(:mod:`mpi4dl_tpu_torch.resilience.loop` owns the rollback mechanics — the
guard only detects and counts).

Hatches: ``MPI4DL_NO_GUARD=1`` disables the guard;
``MPI4DL_GUARD_GRAD_NORM=<float>`` arms the grad-norm check for step
functions that report ``metrics['grad_norm']`` (none do by default — the
check is opt-in on both sides; :func:`global_norm` is the helper a training
step would use to emit it).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional


class AnomalyError(RuntimeError):
    """Raised when anomalies persist past ``max_rollbacks`` — the data or
    the program is systematically poisoned; restarting is not recovery."""


def _tensors(tree: Any):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for c in tree for t in _tensors(c)]
    return [] if tree is None else [tree]


def global_norm(tree: Any):
    """L2 norm over every tensor of a nest of dicts, lists and tuples (fp32
    accumulation) — the value a training step emits as
    ``metrics['grad_norm']`` to arm the opt-in check."""
    import torch

    leaves = _tensors(tree)
    if not leaves:
        return torch.tensor(0.0, dtype=torch.float32)
    return torch.sqrt(
        sum(torch.sum(torch.square(l.detach().float())).cpu() for l in leaves)
    )


@dataclasses.dataclass
class AnomalyGuard:
    """Detects per-step numerical anomalies; the loop performs the rollback.

    ``check`` returns a human-readable reason string (anomaly) or ``None``
    (step is good).  ``note_rollback`` counts recoveries and raises
    :class:`AnomalyError` once ``max_rollbacks`` is exceeded — a run that
    keeps tripping is not transient and must fail loudly.

    The rollback count DECAYS: every ``rollback_decay_steps`` consecutive
    good steps forgive one past rollback.  Without
    decay the counter was lifetime-monotone, so a long run with rare,
    individually-recoverable NaNs eventually fail-fasted anyway; with it,
    only CLUSTERED anomalies — more than ``max_rollbacks`` without a
    ``rollback_decay_steps``-long clean stretch between them — trip the
    fail-fast.  ``rollback_decay_steps=0`` restores the lifetime counter.
    """

    grad_norm_limit: float = 0.0  # 0 = grad-norm check off
    max_rollbacks: int = 3
    rollbacks: int = 0
    rollback_decay_steps: int = 64  # good steps that forgive one rollback
    good_streak: int = 0

    @classmethod
    def from_env(cls) -> Optional["AnomalyGuard"]:
        """The default-on construction: ``None`` only under
        ``MPI4DL_NO_GUARD=1``; grad-norm limit from
        ``MPI4DL_GUARD_GRAD_NORM``."""
        if os.environ.get("MPI4DL_NO_GUARD", "0") == "1":
            return None
        limit = float(os.environ.get("MPI4DL_GUARD_GRAD_NORM", "0") or 0.0)
        return cls(grad_norm_limit=limit)

    def check(self, loss: float,
              metrics: Optional[Dict[str, Any]] = None) -> Optional[str]:
        reason = self._check(loss, metrics)
        if reason is not None:
            self.good_streak = 0
            return reason
        self.good_streak += 1
        if (self.rollback_decay_steps > 0 and self.rollbacks > 0
                and self.good_streak >= self.rollback_decay_steps):
            self.rollbacks -= 1
            self.good_streak = 0
        return None

    def _check(self, loss: float,
               metrics: Optional[Dict[str, Any]] = None) -> Optional[str]:
        if not math.isfinite(loss):
            return f"non-finite loss {loss}"
        if self.grad_norm_limit > 0 and metrics is not None:
            gn = metrics.get("grad_norm")
            if gn is not None:
                gn = float(gn)
                if not math.isfinite(gn):
                    return f"non-finite grad norm {gn}"
                if gn > self.grad_norm_limit:
                    return (
                        f"grad norm {gn:.4g} exceeds limit "
                        f"{self.grad_norm_limit:.4g}"
                    )
        return None

    def snapshot(self) -> Dict[str, Any]:
        """The guard's current posture, for the flight recorder's anomaly
        ring entry — how close to the fail-fast this anomaly landed."""
        return {
            "rollbacks": self.rollbacks,
            "max_rollbacks": self.max_rollbacks,
            "good_streak": self.good_streak,
            "rollback_decay_steps": self.rollback_decay_steps,
            "grad_norm_limit": self.grad_norm_limit,
        }

    def note_rollback(self) -> None:
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise AnomalyError(
                f"{self.rollbacks} rollbacks exceed max_rollbacks="
                f"{self.max_rollbacks} without a {self.rollback_decay_steps}"
                "-good-step clean stretch between them: anomalies are "
                "clustered, not transient — failing fast"
            )
