"""Supervision plumbing of the training loop (counterpart of the first part of
``mpi4dl_tpu/resilience/supervisor.py``: the crash marker and the
quarantine list).

The loop leaves structured last words when an exception escapes it (or the
watchdog escalates): the crash marker, a small JSON file at the path the
``MPI4DL_CRASH_MARKER`` hatch names, with the phase the loop died in
(``init``, ``fetch``, ``compile`` for the process's first step, ``step``,
``save``, ``loop``), the global step, the error and its base classes — so
a supervisor can classify the failure without parsing tracebacks.  The
marker's schema is the JAX package's (``MARKER_SCHEMA``); a marker written
by either package reads in the other.

Ranks.  Under ``torchrun`` every rank runs the loop and may die on its own;
rank 0 writes its marker at the hatch's path and rank r > 0 at
``<path>.rank<r>``, so the ranks never race on one file
(:func:`rank_path`).  The rank is the default process group's when one is
initialized, else ``RANK`` from the environment, else 0.

``MPI4DL_QUARANTINE_STEPS`` (a comma-separated list of global steps) names
steps the loop skips outright: a supervisor sets it to the anomalous steps
of a run the anomaly guard failed fast on before relaunching it.

The supervisor itself (classification, per-class recovery policies,
relaunches) is not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

MARKER_SCHEMA = 1


def process_rank() -> int:
    """This process's rank: the default process group's, else ``RANK``."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 — no usable distributed runtime
        pass
    try:
        return int(os.environ.get("RANK", "0") or 0)
    except ValueError:
        return 0


def rank_path(path: str, rank: Optional[int] = None) -> str:
    """``path`` for rank 0, ``<path>.rank<r>`` for rank r > 0."""
    r = process_rank() if rank is None else int(rank)
    return path if r == 0 else f"{path}.rank{r}"


def crash_marker_path() -> Optional[str]:
    """Where this process should write its crash marker: the
    ``MPI4DL_CRASH_MARKER`` hatch, per rank (:func:`rank_path`)."""
    path = os.environ.get("MPI4DL_CRASH_MARKER") or None
    return rank_path(path) if path else None


def write_crash_marker(path: str, *, phase: str, gstep: int = -1,
                       steps_run: int = -1,
                       error: Optional[BaseException] = None,
                       failure_class: Optional[str] = None,
                       **extra: Any) -> None:
    """Write the structured crash marker — atomically (tmp + rename), and
    NEVER raising: the marker is evidence about a failure already in
    flight, and masking the original exception with a marker-write error
    would destroy exactly what it exists to preserve."""
    try:
        rec: Dict[str, Any] = {
            "schema": MARKER_SCHEMA, "t": time.time(), "phase": phase,
            "gstep": int(gstep), "steps_run": int(steps_run),
            "failure_class": failure_class,
        }
        if error is not None:
            rec["error_type"] = type(error).__name__
            rec["error"] = repr(error)
            # Base-class names let a classifier match exception FAMILIES
            # (any OSError subclass is transient I/O) without importing the
            # run's modules.
            rec["error_bases"] = [c.__name__ for c in type(error).__mro__]
        rec.update(extra)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 — deliberate: diagnostics never mask
        pass


def read_crash_marker(path: Optional[str]) -> Optional[dict]:
    """Read a crash marker; None when absent/unreadable (no marker is
    itself evidence — the process died too hard to write one)."""
    if not path:
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def quarantine_steps_from_env() -> frozenset:
    """Global steps the supervised loop must SKIP (fetch nothing, train
    nothing), from ``MPI4DL_QUARANTINE_STEPS``."""
    raw = os.environ.get("MPI4DL_QUARANTINE_STEPS", "")
    out = set()
    for tok in raw.split(","):
        tok = tok.strip()
        if tok.lstrip("-").isdigit():
            out.add(int(tok))
    return frozenset(out)
