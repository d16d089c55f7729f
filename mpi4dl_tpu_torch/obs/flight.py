"""Flight recorder: bounded in-memory forensics for training runs
(counterpart of ``mpi4dl_tpu/obs/flight.py``; the same ``flight.json``
schema).

The RunLog is the durable record; the flight recorder is the *crash-scoped*
one — a ring buffer of the last N step records (the card's memory
watermark) plus the last checkpoint / anomaly / quarantine / preempt
events, held in memory at ~zero per-step cost and dumped as a typed
``flight.json`` artifact exactly when a run goes down: anomaly, watchdog
escalation, preemption, and crash-marker writes.  The recorder's ``phase``
disambiguates a hang-in-collective from a data stall from a
checkpoint-gather stall, and the ring's watermark trajectory localizes an
out-of-memory step.

Every supervised run has one by default (``MPI4DL_NO_FLIGHT=1`` disables;
``MPI4DL_FLIGHT_STEPS`` sizes the ring).  The dump lands next to the crash
marker when ``MPI4DL_CRASH_MARKER`` is set and next to the RunLog
otherwise; rank r > 0 of a ``torchrun`` job writes ``flight.json.rank<r>``
(the crash marker's per-rank rule) and records that rank in the dump.

:func:`flight_summary` and :func:`watermark_growth` read a dump back for
the supervisor's classifier.  Each rank holds one card, so the "device"
they name is the rank whose dump it is.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from mpi4dl_tpu_torch.obs.runlog import (
    _jsonable,
    device_memory_watermarks,
    host_rss_peak_bytes,
)

FLIGHT_SCHEMA = 1
FLIGHT_BASENAME = "flight.json"
DEFAULT_FLIGHT_STEPS = 64


def flight_steps_from_env() -> int:
    """Ring capacity from ``MPI4DL_FLIGHT_STEPS`` (default 64)."""
    raw = os.environ.get("MPI4DL_FLIGHT_STEPS")
    try:
        n = int(raw) if raw else DEFAULT_FLIGHT_STEPS
    except ValueError:
        n = DEFAULT_FLIGHT_STEPS
    return max(1, n)


def default_flight_path() -> Optional[str]:
    """Where a dump lands with no explicit path: next to the crash marker
    when that hatch is set (per rank)."""
    from mpi4dl_tpu_torch.resilience.supervisor import rank_path

    marker = os.environ.get("MPI4DL_CRASH_MARKER")
    if marker:
        return rank_path(os.path.join(os.path.dirname(os.path.abspath(marker)),
                                      FLIGHT_BASENAME))
    return None


def read_flight(path: str) -> Optional[Dict[str, Any]]:
    """Parse a ``flight.json`` dump; None on missing/torn/invalid files (a
    crashed run may die mid-write — evidence readers must not)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


class FlightRecorder:
    """Bounded ring of recent step/event records + last-event index."""

    def __init__(self, capacity: int = DEFAULT_FLIGHT_STEPS,
                 path: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self.path = path
        self.steps_seen = 0
        self.phase: Optional[str] = None
        self.gstep = -1
        # The watchdog monitor thread reads tail()/snapshot() while the
        # training thread notes records.
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._last_events: Dict[str, Dict[str, Any]] = {}
        self._dumps: List[str] = []

    @classmethod
    def from_env(cls, path: Optional[str] = None) -> Optional["FlightRecorder"]:
        """The default-on constructor: None when ``MPI4DL_NO_FLIGHT=1``."""
        if os.environ.get("MPI4DL_NO_FLIGHT") == "1":
            return None
        return cls(capacity=flight_steps_from_env(),
                   path=path or default_flight_path())

    # -- recording ---------------------------------------------------------

    def set_phase(self, phase: str, gstep: Optional[int] = None) -> None:
        with self._lock:
            self.phase = phase
            if gstep is not None:
                self.gstep = int(gstep)

    def note(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """One ring entry; non-step kinds also update the last-event index
        (checkpoint / anomaly / quarantine / preempt / ...)."""
        rec = {"kind": kind, "t": time.time()}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        with self._lock:
            self._ring.append(rec)
            if kind != "step":
                self._last_events[kind] = rec
        return rec

    def note_step(self, *, gstep: int, phase: str = "step", step_fn=None,
                  **fields: Any) -> Dict[str, Any]:
        """One completed step: the card's memory watermark (``jit_cache_size``
        null: PyTorch has no compiled-variant cache to probe)."""
        wm = device_memory_watermarks()
        rec = self.note(
            "step",
            gstep=int(gstep),
            memory_peak_bytes=None if wm is None else wm["max"],
            memory_peak_bytes_min=None if wm is None else wm["min"],
            hbm_skew=None if wm is None else wm["hbm_skew"],
            per_device_peak_bytes=None if wm is None else wm["per_device"],
            host_rss_peak_bytes=host_rss_peak_bytes(),
            jit_cache_size=None,
            **fields,
        )
        with self._lock:
            self.steps_seen += 1
            self.gstep = int(gstep)
            self.phase = phase
        return rec

    # -- reading -----------------------------------------------------------

    def tail(self, n: int = 5) -> List[Dict[str, Any]]:
        """The last ``n`` ring entries, oldest first (the watchdog appends
        these to its stall dump)."""
        with self._lock:
            return list(self._ring)[-max(0, int(n)):]

    def snapshot(self, reason: Optional[str] = None,
                 phase: Optional[str] = None,
                 gstep: Optional[int] = None) -> Dict[str, Any]:
        """The typed dump payload (``flight.json`` schema)."""
        with self._lock:
            snap: Dict[str, Any] = {
                "schema": FLIGHT_SCHEMA,
                "t": time.time(),
                "reason": reason,
                "phase": phase if phase is not None else self.phase,
                "gstep": int(gstep) if gstep is not None else self.gstep,
                "capacity": self.capacity,
                "steps_seen": self.steps_seen,
                "ring": list(self._ring),
                "last_events": dict(self._last_events),
                "dumps": list(self._dumps),
            }
        from mpi4dl_tpu_torch.resilience.supervisor import process_rank

        snap["rank"] = process_rank()
        snap["device_memory"] = device_memory_watermarks()
        snap["host_rss_peak_bytes"] = host_rss_peak_bytes()
        return snap

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str, *, phase: Optional[str] = None,
             gstep: Optional[int] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Atomically write ``flight.json``; never raises (forensics must not
        mask the original failure).  Returns the path written, or None when
        no destination resolves / the write fails."""
        dest = path or self.path or default_flight_path()
        if not dest:
            return None
        try:
            snap = self.snapshot(reason, phase=phase, gstep=gstep)
            with self._lock:
                self._dumps.append(reason)
            snap["dumps"] = list(self._dumps)
            os.makedirs(os.path.dirname(os.path.abspath(dest)) or ".",
                        exist_ok=True)
            tmp = dest + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(snap, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, dest)
            return dest
        except Exception:  # noqa: BLE001
            return None  # deliberate: a failed dump must not kill the run


def flight_summary(flight: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The compact evidence block the supervisor attaches to incidents."""
    if not flight or not isinstance(flight, dict):
        return None
    out: Dict[str, Any] = {
        "reason": flight.get("reason"),
        "phase": flight.get("phase"),
        "gstep": flight.get("gstep"),
        "steps_seen": flight.get("steps_seen"),
    }
    growth = watermark_growth(flight)
    if growth is not None:
        out["watermark_growth_bytes"] = growth[0]
        if growth[1] is not None:
            out["watermark_growth_device"] = growth[1]
    return out


def watermark_growth(flight: Dict[str, Any]):
    """(total growth bytes, fastest-growing device) over the dump's ring of
    step records; None when the ring carries fewer than two watermarks (a
    CPU run has none).  The device is an index into the steps'
    ``per_device_peak_bytes``; a dump of a rank (one card, a one-element
    list) names that rank instead."""
    steps = [r for r in flight.get("ring", ())
             if isinstance(r, dict) and r.get("kind") == "step"]
    marks = [r["memory_peak_bytes"] for r in steps
             if isinstance(r.get("memory_peak_bytes"), int)]
    if len(marks) < 2:
        return None
    total = marks[-1] - marks[0]
    per_dev_first = steps[0].get("per_device_peak_bytes")
    per_dev_last = steps[-1].get("per_device_peak_bytes")
    device = None
    if (isinstance(per_dev_first, list) and isinstance(per_dev_last, list)
            and len(per_dev_first) == len(per_dev_last) and per_dev_first):
        deltas = [b - a for a, b in zip(per_dev_first, per_dev_last)]
        best = max(deltas)
        if best > 0:
            device = deltas.index(best)
            if len(deltas) == 1 and isinstance(flight.get("rank"), int):
                device = flight["rank"]
    return total, device
