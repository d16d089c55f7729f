"""Chrome/Perfetto trace-event export of RunLogs (counterpart of the
RunLog half of ``mpi4dl_tpu/obs/trace.py``: the same events for the same
records).

:func:`trace_from_runlog` renders the MEASURED step walls, checkpoint saves
and resilience events of any RunLog file as Trace Event Format JSON that
loads directly in ``chrome://tracing`` / https://ui.perfetto.dev: one
``measured`` process with a ``steps`` lane (one complete span per step
record, ended at the record's write time), a ``checkpoints`` lane
(gather + write spans) and an ``events`` lane (anomaly, recovery, preempt,
quarantine, restore, drill and supervisor records as instants).
Timestamps are microseconds (the format's unit) from the file's first
record.  The compiled-program lanes of the JAX package (simulated wire,
analytical timeline, pipeline ticks) wait for the port's HLO-side
telemetry.  CLI: ``python -m mpi4dl_tpu_torch.obs trace --runlog F --out
trace.json``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

#: The trace-event container's display unit hint.
DISPLAY_TIME_UNIT = "ms"


def _us(ms: float) -> float:
    """Walker/report milliseconds -> trace-event microseconds."""
    return round(ms * 1000.0, 3)


def _span(name: str, pid: int, tid: int, ts_ms: float, dur_ms: float,
          cat: str, args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "name": name, "ph": "X", "cat": cat, "pid": pid, "tid": tid,
        "ts": _us(ts_ms), "dur": max(_us(dur_ms), 0.0),
    }
    if args:
        ev["args"] = args
    return ev


def _instant(name: str, pid: int, tid: int, ts_ms: float, cat: str,
             args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "name": name, "ph": "i", "s": "t", "cat": cat, "pid": pid,
        "tid": tid, "ts": _us(ts_ms),
    }
    if args:
        ev["args"] = args
    return ev


def _meta(pid: int, process: Optional[str] = None, tid: int = 0,
          thread: Optional[str] = None) -> Dict[str, Any]:
    if process is not None:
        return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": process}}
    return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": thread or ""}}


#: RunLog record kinds rendered as instants on the measured event lane.
_RUNLOG_INSTANTS = (
    "anomaly", "recovery", "preempt", "quarantine", "restore", "drill",
    "supervisor",
)


def trace_from_runlog(
    records: List[Dict[str, Any]],
    *,
    label: str = "run",
    pid_base: int = 90,
) -> List[Dict[str, Any]]:
    """Measured lanes from RunLog records: step walls as spans (ended at
    the record's write time, so the span is the step's real wall window),
    checkpoint saves as gather+write spans, resilience/supervisor events as
    instants.  Timeline zero is the file's first record."""
    ts = [float(r["t"]) for r in records if r.get("t") is not None]
    if not ts:
        return []
    t0 = min(ts)
    pid = pid_base
    out: List[Dict[str, Any]] = [
        _meta(pid, process=f"measured [{label}]"),
        _meta(pid, tid=0, thread="steps"),
        _meta(pid, tid=1, thread="checkpoints"),
        _meta(pid, tid=2, thread="events"),
    ]
    for r in records:
        kind, t = r.get("kind"), r.get("t")
        if t is None:
            continue
        end_ms = (float(t) - t0) * 1e3
        if kind == "step" and r.get("ms") is not None:
            dur = float(r["ms"])
            out.append(_span(
                f"step e{r.get('epoch', '?')}:{r.get('step', '?')}",
                pid, 0, max(end_ms - dur, 0.0), dur, "step",
                args={k: r.get(k) for k in (
                    "loss", "images_per_sec", "measured",
                    "memory_peak_bytes", "hbm_skew", "jit_cache_size",
                ) if r.get(k) is not None},
            ))
        elif kind == "checkpoint":
            dur = (float(r.get("gather_ms") or 0.0)
                   + float(r.get("write_ms") or 0.0))
            out.append(_span(
                f"checkpoint {r.get('step_id', '?')}", pid, 1,
                max(end_ms - dur, 0.0), dur, "checkpoint",
                args={k: r.get(k) for k in (
                    "bytes", "gather_ms", "write_ms", "peak_pending_bytes",
                ) if r.get(k) is not None},
            ))
        elif kind in _RUNLOG_INSTANTS:
            detail = (r.get("reason") or r.get("failure_class")
                      or r.get("scenario") or "")
            name = f"{kind} {detail}".strip()
            out.append(_instant(name, pid, 2, end_ms, "event",
                                args={"gstep": r.get("gstep")}))
    return out


def chrome_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Wrap event lists into the JSON-object trace container the viewers
    load (``displayTimeUnit`` is a hint; timestamps stay microseconds)."""
    return {"traceEvents": events, "displayTimeUnit": DISPLAY_TIME_UNIT}
