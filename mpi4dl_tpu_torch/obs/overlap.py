"""The exposed-wire ledger (counterpart of ``mpi4dl_tpu/obs/overlap.py``).

The JAX package simulates the compiled schedule: async ``*-start``/
``*-done`` windows against the conv/dot compute scheduled between them.
The port measures instead.  :func:`overlap_ledger` takes wire events
(scope, class, bytes, quantized, issue and end times, sync) and the compute
stream's busy intervals, and returns the JAX ledger's dict with the same
keys:

- a **sync** collective is fully exposed: the device waits from its issue
  to its end, queueing behind an earlier transfer included, and nothing is
  hidden;
- an **async** transfer moves over ``[begin, end]``; the part that compute
  covers is hidden, the rest exposed;
- transfers serialize on one wire: an event without a measured ``begin``
  starts at ``max(issue, the wire's previous end)`` and ends ``wire_ms``
  later, so queueing behind an earlier transfer shows as exposed time, as
  in the JAX model (``mpi4dl_tpu/obs/overlap.py:24-40``);
- ``simulated_step_ms`` = compute ms (the union of the busy intervals) +
  exposed ms.

Producers:

- :func:`ledger_from_trace` reads a profiled step (``obs/kineto.py``).  On
  the card the wire events are the NCCL kernels (their own streams), the
  compute intervals every other device op; each kernel is matched, in
  launch order, to the next launch unit of ``obs/comm_stats.py``'s record
  of a step with the same collectives whose class its name can carry, for
  its class, bytes, scope and sync flag (``batch_isend_irecv`` launches one
  grouped ``SendRecv`` kernel for a whole exchange: it is ONE event with the
  unit's summed counted bytes; NCCL runs an all-to-all as grouped send/recv
  and a barrier as an all-reduce).  In a CPU trace the wire events are the
  gloo ops, one a recorded op.
  Without a record a kernel keeps its trace scope, its class from its name
  and no bytes.  ``source`` is ``"measured"``.
- :func:`ledger_from_records` is the CPU's: gloo (and the ``fake`` group)
  completes each transfer on the calling thread before the step goes on,
  so every transfer is sync and the ledger reads 100% exposed: the honest
  baseline the JAX package's CPU backend gives too (its docstring,
  ``overlap.py:16-19``).  Wire time is bytes over the interconnect rate
  (:func:`~mpi4dl_tpu_torch.obs.costs.ici_bytes_per_s`), compute time the
  counted FLOPs over the peak.

:func:`structural_overlap` is the integer-only projection over the recorded
async/sync flags: per scope and class, async and sync counts, bytes, and
structurally exposed bytes (every sync payload).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from mpi4dl_tpu_torch.obs import kineto
from mpi4dl_tpu_torch.obs.comm_stats import launch_units

UNSCOPED = "<unscoped>"


@dataclasses.dataclass
class WireEvent:
    """One transfer: times in ms on the device clock (or any one clock)."""
    scope: str
    cls: str
    bytes: int
    issue_ms: float
    wire_ms: float = 0.0
    sync: bool = False
    quantized_bytes: int = 0
    begin_ms: Optional[float] = None  # measured start of the transfer
    hidden_ms: float = 0.0
    exposed_ms: float = 0.0
    end_ms: float = 0.0


def wire_class(scope: str, cls: str) -> str:
    """Semantic wire class of a collective from its obs.scope vocabulary —
    the per-class rollup PERF_NOTES' "what moves per step" table uses
    (halo ppermutes / junction gathers / respatial / pipeline handoffs /
    grad+stats reduces); falls back to the HLO opcode class."""
    s = scope or ""
    if "halo" in s or "d2_run" in s or "ring_step_hop" in s:
        return "halo"
    if "junction" in s or "stage_lineup" in s:
        return "junction"
    if "respatial" in s:
        return "respatial"
    if "handoff" in s or "mb_inject" in s or "mirror" in s:
        return "pipeline_handoff"
    if ("grad_reduce" in s or "loss_reduce" in s or "stats" in s
            or "bn_" in s or "optimizer" in s):
        return "grad_stats_reduce"
    return cls


def simulate(events: List[WireEvent], compute: Sequence[Tuple[float, float]]
             ) -> List[WireEvent]:
    """Fill each event's begin, end, hidden and exposed ms (module
    docstring); events in issue order."""
    wire_free = float("-inf")
    for e in sorted(events, key=lambda e: e.issue_ms):
        begin = e.begin_ms if e.begin_ms is not None else max(e.issue_ms, wire_free)
        e.begin_ms, e.end_ms = begin, begin + e.wire_ms
        wire_free = max(wire_free, e.end_ms)
        if e.sync:
            e.hidden_ms = 0.0
            e.exposed_ms = e.end_ms - min(e.issue_ms, begin)
        else:
            e.hidden_ms = kineto.covered(begin, e.end_ms, list(compute))
            e.exposed_ms = e.wire_ms - e.hidden_ms
    return events


def overlap_ledger(events: List[WireEvent], compute: Sequence[Tuple[float, float]],
                   *, ici_bw: Optional[float] = None, ici_source: str = "measured",
                   peak: Optional[float] = None, peak_source: Optional[str] = None,
                   source: str = "measured", top: int = 24) -> dict:
    """The per-scope exposed/hidden wire ledger (the JAX dict's keys; module
    docstring).  ``compute`` is the merged busy intervals in ms."""
    simulate(events, compute)

    def bucket() -> dict:
        return {"bytes": 0, "quantized_bytes": 0, "wire_ms": 0.0,
                "hidden_ms": 0.0, "exposed_ms": 0.0, "async_pairs": 0,
                "sync": 0}

    def add(b: dict, e: WireEvent) -> None:
        b["bytes"] += e.bytes
        b["quantized_bytes"] += e.quantized_bytes
        b["wire_ms"] += e.wire_ms
        b["hidden_ms"] += e.hidden_ms
        b["exposed_ms"] += e.exposed_ms
        b["async_pairs"] += 0 if e.sync else 1
        b["sync"] += 1 if e.sync else 0

    by_scope: Dict[str, dict] = {}
    by_class: Dict[str, dict] = {}
    totals = bucket()
    attributed = 0
    for e in events:
        key = e.scope or UNSCOPED
        row = by_scope.setdefault(key, {**bucket(), "classes": {}})
        add(row, e)
        add(row["classes"].setdefault(e.cls, bucket()), e)
        add(by_class.setdefault(wire_class(e.scope, e.cls), bucket()), e)
        add(totals, e)
        if e.scope:
            attributed += e.bytes

    def rounded(d: dict) -> dict:
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in d.items()}

    rows = [
        {"scope": k, **rounded({kk: vv for kk, vv in v.items()
                                if kk != "classes"}),
         "classes": {c: rounded(b) for c, b in v["classes"].items()}}
        for k, v in sorted(
            by_scope.items(),
            key=lambda kv: (-kv[1]["exposed_ms"], -kv[1]["bytes"]),
        )
    ]
    wire = totals["wire_ms"]
    compute_ms = sum(b - a for a, b in compute)
    return {
        "rows": rows[:top] if top else rows,
        "row_count": len(rows),
        "by_class": {c: rounded(b) for c, b in sorted(
            by_class.items(), key=lambda kv: -kv[1]["exposed_ms"])},
        "totals": rounded(totals),
        "hidden_frac": (
            round(totals["hidden_ms"] / wire, 4) if wire else None
        ),
        "quantized_frac": (
            round(totals["quantized_bytes"] / totals["bytes"], 4)
            if totals["bytes"] else None
        ),
        "attributed_bytes_frac": (
            round(attributed / totals["bytes"], 4) if totals["bytes"]
            else 1.0
        ),
        "compute_ms": round(compute_ms, 4),
        "simulated_step_ms": round(compute_ms + totals["exposed_ms"], 4),
        "peak_flops": peak,
        "peak_source": peak_source,
        "ici_bytes_per_s": ici_bw,
        "ici_source": ici_source,
        "source": source,
    }


_KERNEL_CLASS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                 ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
                 ("sendrecv", "collective-permute"), ("send", "collective-permute"),
                 ("recv", "collective-permute"), ("broadcast", "broadcast"))
# Which recorded classes a wire op of each name class can carry: NCCL runs
# an all-to-all as grouped send/recv, a barrier as an all-reduce.
_CARRIES = {"collective-permute": ("collective-permute", "all-to-all"),
            "all-reduce": ("all-reduce", None), "broadcast": (None,)}


def _name_class(name: str) -> str:
    low = name.lower().replace("_", "")
    return next((c for key, c in _KERNEL_CLASS if key in low), "collective")


def _align(wires: List[dict], units: List[dict]) -> Tuple[List[Optional[dict]], int]:
    """Each wire op (launch order) matched to the next recorded unit
    (issue order) whose class it can carry; (matches, counted units left
    unmatched)."""
    out, j, skipped = [], 0, 0
    for o in wires:
        cls = _name_class(o["name"])
        can = _CARRIES.get(cls, (cls,))
        k = j
        while k < len(units) and units[k]["cls"] not in can and cls != "collective":
            k += 1
        if k < len(units):
            skipped += sum(1 for u in units[j:k] if u["bytes"])
            out.append(units[k])
            j = k + 1
        else:
            out.append(None)
    skipped += sum(1 for u in units[j:] if u["bytes"])
    return out, skipped


def wire_events_from_trace(trace, records: Optional[List[dict]] = None
                           ) -> Tuple[List[WireEvent], List[Tuple[float, float]], dict]:
    """(wire events, compute busy intervals, match info) of one profiled
    step, in ms (module docstring).  ``records``: the step's collectives
    (``obs/comm_stats.py``), else the trace's ``mpi4dl_collectives``."""
    tr = trace if isinstance(trace, kineto.Trace) else kineto.Trace(trace)
    if records is None:
        records = tr.raw.get("mpi4dl_collectives")
    ops = tr.device_ops()
    if tr.has_device:
        wires = [o for o in ops if kineto.is_wire(o)]
        wires.sort(key=lambda o: (o["launch_ts"] is None, o["launch_ts"] or o["ts"]))
    else:
        host = tr.host_ops(("gloo:",)) or [o for o in ops if kineto.is_wire(o)]
        wires = sorted(host, key=lambda o: o["ts"])
    compute = [o for o in ops if not kineto.is_wire(o)]
    spans = [(a / 1e3, b / 1e3) for a, b in kineto.busy_intervals(compute)]
    # On the card one NCCL kernel runs a launch unit (a batch_isend_irecv
    # is one grouped kernel); on gloo each op runs apart.
    units = (launch_units(records) if tr.has_device
             else [launch_units([dict(r, unit=i)])[0] for i, r in enumerate(records)]
             ) if records else []
    match, skipped = _align(wires, units) if units else ([None] * len(wires), 0)
    events = []
    for o, u in zip(wires, match):
        events.append(WireEvent(
            scope=u["scope"] if u else ("" if o["scope"] == kineto.UNSCOPED else o["scope"]),
            cls=(u["cls"] or _name_class(o["name"])) if u else _name_class(o["name"]),
            bytes=u["bytes"] if u else 0,
            quantized_bytes=u["quantized_bytes"] if u else 0,
            sync=bool(u and not u["async"]),
            issue_ms=o["ts"] / 1e3, begin_ms=o["ts"] / 1e3, wire_ms=o["dur"] / 1e3))
    unmatched = sum(1 for u in match if u is None)
    info = {"wire_ops": len(wires), "units": len(units), "unmatched_ops": unmatched,
            "unmatched_units": skipped,
            "matched": bool(units) and not unmatched and not skipped or not wires}
    return events, spans, info


def ledger_from_trace(trace, records: Optional[List[dict]] = None, top: int = 24) -> dict:
    """The measured ledger of one profiled step (module docstring), with
    ``match`` (wire ops, launch units, whether they were matched)."""
    events, spans, info = wire_events_from_trace(trace, records)
    led = overlap_ledger(events, spans, source="measured", top=top)
    led["match"] = info
    return led


def record_events(records: List[dict], compute_ms: float, ici_bw: float
                  ) -> List[WireEvent]:
    """A recorded step's launch units as sync wire events, each
    ``bytes / ici_bw`` long, laid one after another after ``compute_ms``
    of compute (the CPU's layout: :func:`ledger_from_records`)."""
    clock, events = compute_ms, []
    for u in launch_units(records):
        if u["cls"] is None or not u["bytes"]:
            continue
        ms = u["bytes"] / ici_bw * 1e3
        events.append(WireEvent(scope=u["scope"], cls=u["cls"], bytes=u["bytes"],
                                quantized_bytes=u["quantized_bytes"], sync=True,
                                issue_ms=clock, wire_ms=ms))
        clock += ms
    return events


def ledger_from_records(records: List[dict], *, compute_ms: float = 0.0,
                        ici_bw: float, ici_source: str, peak: Optional[float] = None,
                        peak_source: Optional[str] = None, top: int = 24) -> dict:
    """The CPU's ledger of a recorded step (module docstring): every launch
    unit sync, wire ms = bytes / ``ici_bw``, laid after ``compute_ms`` of
    compute."""
    compute = [(0.0, compute_ms)] if compute_ms else []
    return overlap_ledger(record_events(records, compute_ms, ici_bw), compute,
                          ici_bw=ici_bw, ici_source=ici_source, peak=peak,
                          peak_source=peak_source, source="records", top=top)


def structural_overlap(records: List[dict]) -> dict:
    """The integer-only overlap contract of a recorded step: per scope and
    class, async and sync counts, counted bytes, and structurally exposed
    bytes (every sync payload)."""
    per_scope: Dict[str, Dict[str, dict]] = {}
    totals = {"async_pairs": 0, "sync": 0, "bytes": 0, "exposed_bytes": 0}
    for r in records:
        if not r["counted"]:
            continue
        entry = per_scope.setdefault(r["scope"] or UNSCOPED, {}).setdefault(
            r["cls"], {"async_pairs": 0, "sync": 0, "bytes": 0, "exposed_bytes": 0})
        for b in (entry, totals):
            b["async_pairs"] += 1 if r["async"] else 0
            b["sync"] += 0 if r["async"] else 1
            b["bytes"] += r["bytes"]
            b["exposed_bytes"] += 0 if r["async"] else r["bytes"]
    return {
        "per_scope": {s: dict(sorted(ops.items())) for s, ops in sorted(per_scope.items())},
        "totals": totals,
    }


def _ms(v: float) -> str:
    return f"{v:.3f}"


def format_ledger(ledger: dict, top: int = 12) -> str:
    """Human-readable rendering of one overlap ledger (the JAX package's
    text)."""
    t = ledger["totals"]
    hidden_frac = ledger.get("hidden_frac")
    ici = ledger.get("ici_bytes_per_s")
    lines = [
        (f"exposed-wire ledger (ICI {ici:.3g} B/s " if ici else
         "exposed-wire ledger (ICI measured ")
        + f"[{ledger['ici_source']}], peak "
        + (f"{ledger['peak_flops']:.3g} FLOP/s [{ledger['peak_source']}])"
           if ledger.get("peak_flops") else "n/a)"),
        f"wire {_ms(t['wire_ms'])} ms over {t['bytes']} bytes"
        + (f" ({t['quantized_bytes']} quantized)"
           if t.get("quantized_bytes") else "")
        + f" — hidden {_ms(t['hidden_ms'])} ms, exposed "
        f"{_ms(t['exposed_ms'])} ms"
        + (f" (hidden {hidden_frac:.1%})" if hidden_frac is not None else "")
        + f"; async pairs {t['async_pairs']}, sync {t['sync']}",
        f"simulated step {_ms(ledger['simulated_step_ms'])} ms "
        f"(compute {_ms(ledger['compute_ms'])} ms + exposed wire); "
        f"{ledger['attributed_bytes_frac']:.1%} of collective bytes "
        "scope-attributed",
    ]
    if ledger.get("by_class"):
        lines.append("per wire class (exposed/hidden ms, bytes):")
        for cls, b in ledger["by_class"].items():
            lines.append(
                f"  {cls:<18} exposed {_ms(b['exposed_ms']):>9}  hidden "
                f"{_ms(b['hidden_ms']):>9}  {b['bytes']:>12} B  "
                f"(async {b['async_pairs']}, sync {b['sync']})"
            )
    lines.append(
        f"{'scope':<44} {'exposed_ms':>10} {'hidden_ms':>10} "
        f"{'bytes':>12} {'async':>5} {'sync':>5}"
    )
    for r in ledger["rows"][:top]:
        lines.append(
            f"{r['scope'][:44]:<44} {r['exposed_ms']:>10.3f} "
            f"{r['hidden_ms']:>10.3f} {r['bytes']:>12} "
            f"{r['async_pairs']:>5} {r['sync']:>5}"
        )
    return "\n".join(lines)
