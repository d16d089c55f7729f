"""Chrome/Perfetto trace-event export (counterpart of
``mpi4dl_tpu/obs/trace.py``: the same lanes for the same records).

:func:`trace_from_runlog` renders the MEASURED step walls, checkpoint saves
and resilience events of any RunLog file as Trace Event Format JSON that
loads directly in ``chrome://tracing`` / https://ui.perfetto.dev: one
``measured`` process with a ``steps`` lane (one complete span per step
record, ended at the record's write time), a ``checkpoints`` lane
(gather + write spans) and an ``events`` lane (anomaly, recovery, preempt,
quarantine, restore, drill and supervisor records as instants).
Timestamps are microseconds (the format's unit) from the file's first
record.

The JAX package's ``hlo_trace_events`` draws lanes of the simulated
compiled schedule; the port draws the same lanes from a profiled step or a
recorded one (:func:`step_trace_events`):

- ``wire``: one span per transfer over its ``begin..end`` window
  (``obs/overlap.py``'s events: the NCCL kernels of a profiled step, or the
  recorded collectives laid on the wire at the CPU's nominal rate), and a
  ``device stall`` lane for the exposed part, ending at the transfer's end;
- ``timeline``: per-scope spans laid end to end, from the measured
  timeline (device ms) or the analytical one (compute and wire ms);
- ``pipeline``: per-stage tick lanes from ``pipeline_ticks``, busy ticks
  plus fill/drain bubble spans (stage ``s`` active over ticks
  ``[s, ticks - (S-1-s))``).

They sit beside the RunLog lanes in one JSON.  CLI: ``python -m
mpi4dl_tpu_torch.obs trace [--families lp,... | --profile F] [--runlog F]
--out trace.json``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from mpi4dl_tpu_torch.obs.timeline import bubble_fraction, pipeline_ticks

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


def step_trace_events(wire: Sequence, *, label: str = "step",
                      timelines: Sequence[dict] = (), schedule: Optional[str] = None,
                      stages: Optional[int] = None, parts: Optional[int] = None,
                      step_ms: Optional[float] = None,
                      pid_base: int = 1) -> List[Dict[str, Any]]:
    """The wire, device-stall, timeline and pipeline lanes of one step
    (module docstring).  ``wire``: ``obs.overlap.WireEvent``s after
    ``simulate`` (ms on one clock); ``timelines``: measured and/or
    analytical timeline dicts.  The lanes occupy pids ``pid_base ..
    pid_base + 2``."""
    from mpi4dl_tpu_torch.obs.overlap import UNSCOPED, wire_class

    wire_pid, tl_pid, pipe_pid = pid_base, pid_base + 1, pid_base + 2
    t0 = min((e.begin_ms for e in wire), default=0.0)
    out: List[Dict[str, Any]] = [
        _meta(wire_pid, process=f"wire [{label}]"),
        _meta(wire_pid, tid=0, thread="wire"),
        _meta(wire_pid, tid=1, thread="device stalls"),
    ]
    for e in wire:
        scope = e.scope or UNSCOPED
        out.append(_span(
            f"{e.cls} {scope}", wire_pid, 0, e.begin_ms - t0, e.wire_ms, "wire",
            args={"bytes": e.bytes, "wire_ms": round(e.wire_ms, 4),
                  "hidden_ms": round(e.hidden_ms, 4),
                  "exposed_ms": round(e.exposed_ms, 4), "sync": e.sync,
                  "quantized_bytes": e.quantized_bytes,
                  "wire_class": wire_class(e.scope, e.cls)}))
        if e.exposed_ms > 0:
            out.append(_span(f"stall {e.cls} {scope}", wire_pid, 1,
                             e.end_ms - e.exposed_ms - t0, e.exposed_ms, "stall",
                             args={"bytes": e.bytes, "sync": e.sync}))
    out.append(_meta(tl_pid, process=f"timeline [{label}]"))
    tid = 0
    for tl in timelines:
        if tl.get("source") == "measured":
            out.append(_meta(tl_pid, tid=tid, thread=f"measured ({tl['device']}) device ms"))
            t = 0.0
            for r in tl["rows"]:
                out.append(_span(r["scope"], tl_pid, tid, t, r["device_ms"], "measured",
                                 args={"ops": r["ops"], "share": r["share"]}))
                t += r["device_ms"]
            tid += 1
            continue
        out.append(_meta(tl_pid, tid=tid, thread="analytical compute (serialized)"))
        out.append(_meta(tl_pid, tid=tid + 1, thread="analytical wire (serialized)"))
        comp_t = wire_t = 0.0
        for r in tl["rows"]:
            if r.get("compute_ms"):
                out.append(_span(r["scope"], tl_pid, tid, comp_t, r["compute_ms"],
                                 "compute", args={"flops": r["flops"]}))
                comp_t += r["compute_ms"]
            if r.get("collective_ms"):
                out.append(_span(r["scope"], tl_pid, tid + 1, wire_t, r["collective_ms"],
                                 "wire", args={"bytes": r["collective_bytes"],
                                               "count": r["collective_count"]}))
                wire_t += r["collective_ms"]
        tid += 2
    ticks = (pipeline_ticks(schedule, stages, parts)
             if schedule and stages and parts else None)
    if ticks is not None:
        bubble = bubble_fraction(schedule, stages, parts)
        tick_ms = (step_ms / parts) if step_ms else 1.0
        out.append(_meta(pipe_pid, process=f"pipeline [{label}]"))
        for s in range(stages):
            out.append(_meta(pipe_pid, tid=s, thread=f"stage {s}"))
            head, tail = s, stages - 1 - s
            if head:
                out.append(_span("bubble (fill)", pipe_pid, s, 0.0, head * tick_ms,
                                 "bubble"))
            for t in range(head, ticks - tail):
                name = f"mb{t - head}" if schedule == "gpipe" else f"tick {t}"
                out.append(_span(name, pipe_pid, s, t * tick_ms, tick_ms, "tick",
                                 args={"schedule": schedule, "tick": t,
                                       "bubble_fraction": bubble}))
            if tail:
                out.append(_span("bubble (drain)", pipe_pid, s, (ticks - tail) * tick_ms,
                                 tail * tick_ms, "bubble"))
    return out


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
