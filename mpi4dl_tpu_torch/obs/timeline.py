"""Per-scope step timelines (counterpart of ``mpi4dl_tpu/obs/timeline.py``).

**Analytical** (:func:`analytical_timeline`, the JAX package's fields):
per scope, compute ms = the counted matmul/conv FLOPs (``obs.costs.
counting``'s ``FlopCounterMode`` formulas plus the hand kernels' tallies,
charged to the scope open where they run) over the card's peak, and
collective ms = the recorded collectives' bytes (``obs/comm_stats.py``)
over the interconnect rate.  Serialized = compute + collectives; perfect
overlap = their max; ``schedule_aware`` is the exposed-wire ledger's
reading (``obs/overlap.py``).  As in the JAX package the estimate counts no
elementwise work: a scope of BatchNorms and pools reads near zero.

**Measured** (:func:`measured_timeline`, new beside it: the JAX package
could only estimate): per scope, the device ms of one profiled step, from
its ``torch.profiler`` trace (``obs/kineto.py`` links each device op to the
scope its launch ran in; backward ops to their forward scope).  Device ops
outside every scope are reported as ``UNSCOPED``, never dropped: the rows
add up to ``total_ms`` and ``coverage`` is the named scopes' share.

Also the canonical home of the pipeline tick/bubble arithmetic
(:func:`pipeline_ticks`, :func:`bubble_fraction`; ``obs/report.py``
renders from them).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from mpi4dl_tpu_torch.obs import kineto


def pipeline_ticks(schedule: str, stages: int, parts: int) -> Optional[int]:
    """Scan ticks per optimizer step.  GPipe: ``parts + S - 1`` forward-ish
    ticks (each tick one micro-batch through one stage).  1F1B: each tick
    runs one fwd AND one bwd micro-batch, and fill+drain cover both
    directions: ``parts + 2(S - 1)``.  None for unknown schedules."""
    if schedule == "gpipe":
        return parts + stages - 1
    if schedule == "1f1b":
        return parts + 2 * (stages - 1)
    return None


def bubble_fraction(schedule: str, stages: int, parts: int) -> Optional[float]:
    """Idle-tick fraction of the schedule: ``(ticks - parts) / ticks`` —
    GPipe ``(S-1)/(parts+S-1)``, 1F1B ``2(S-1)/(parts+2(S-1))``."""
    ticks = pipeline_ticks(schedule, stages, parts)
    if ticks is None or ticks <= 0:
        return None
    return (ticks - parts) / ticks


def analytical_timeline(scope_flops: Dict[str, float],
                        scope_colls: Dict[str, Dict[str, int]], *,
                        peak: Optional[float], peak_source: Optional[str],
                        ici_bw: Optional[float], ici_source: Optional[str],
                        ledger: Optional[dict] = None,
                        schedule: Optional[str] = None, stages: Optional[int] = None,
                        parts: Optional[int] = None) -> dict:
    """The JAX package's timeline dict from per-scope FLOPs (``counting``'s
    ``by_scope``) and per-scope collectives (``comm_stats.
    scope_collectives``); ``ledger`` fills ``schedule_aware``."""
    rows = []
    tot_compute_ms = tot_coll_ms = 0.0
    tot_flops = 0.0
    tot_bytes = 0
    for scope in set(scope_flops) | set(scope_colls):
        flops = float(scope_flops.get(scope, 0.0))
        c = scope_colls.get(scope, {"collective_bytes": 0, "collective_count": 0})
        compute_ms = (flops / peak * 1e3) if peak else None
        coll_ms = c["collective_bytes"] / ici_bw * 1e3 if ici_bw else None
        tot_flops += flops
        tot_bytes += int(c["collective_bytes"])
        tot_compute_ms += compute_ms or 0.0
        tot_coll_ms += coll_ms or 0.0
        rows.append({
            "scope": scope or "(unattributed)",
            "flops": flops,
            "compute_ms": round(compute_ms, 4) if compute_ms is not None else None,
            "collective_bytes": int(c["collective_bytes"]),
            "collective_count": int(c["collective_count"]),
            "collective_ms": round(coll_ms, 4) if coll_ms is not None else None,
        })
    rows.sort(key=lambda r: -((r["compute_ms"] or 0) + (r["collective_ms"] or 0)))
    serialized = tot_compute_ms + tot_coll_ms
    overlapped = max(tot_compute_ms, tot_coll_ms)
    out: Dict[str, Any] = {
        "rows": rows,
        "total_flops": tot_flops,
        "total_collective_bytes": tot_bytes,
        "compute_ms": round(tot_compute_ms, 4),
        "collective_ms": round(tot_coll_ms, 4),
        "serialized_ms": round(serialized, 4),
        "overlapped_ms": round(overlapped, 4),
        "overlap_headroom_ms": round(serialized - overlapped, 4),
        "peak_flops": peak,
        "peak_source": peak_source,
        "ici_bytes_per_s": ici_bw,
        "ici_source": ici_source,
    }
    if ledger is not None:
        out["schedule_aware"] = {
            "simulated_step_ms": ledger["simulated_step_ms"],
            "exposed_wire_ms": ledger["totals"]["exposed_ms"],
            "hidden_wire_ms": ledger["totals"]["hidden_ms"],
            "hidden_frac": ledger["hidden_frac"],
            "async_pairs": ledger["totals"]["async_pairs"],
            "sync_collectives": ledger["totals"]["sync"],
        }
    if schedule and stages and parts:
        ticks = pipeline_ticks(schedule, stages, parts)
        bubble = bubble_fraction(schedule, stages, parts)
        out["pipeline"] = {
            "schedule": schedule, "stages": stages, "parts": parts,
            "ticks": ticks, "bubble_fraction": bubble,
            "bubble_adjusted_serialized_ms": (
                round(serialized / (1 - bubble), 4)
                if bubble is not None and bubble < 1 else None
            ),
        }
    return out


def measured_timeline(trace, top: Optional[int] = None) -> dict:
    """Per-scope device ms of one profiled step (module docstring):
    ``rows`` ({scope, device_ms, ops, share} by device ms), ``total_ms``
    (the sum over every device op), ``coverage`` (the named scopes' share),
    ``span_ms`` (first op's start to last op's end), ``ops``, ``linked``
    (device ops whose launch the trace holds) and ``by_neighbour``."""
    tr = trace if isinstance(trace, kineto.Trace) else kineto.Trace(trace)
    ops = tr.device_ops()
    by: Dict[str, Dict[str, float]] = {}
    for o in ops:
        b = by.setdefault(o["scope"], {"device_ms": 0.0, "ops": 0})
        b["device_ms"] += o["dur"] / 1e3
        b["ops"] += 1
    total = sum(b["device_ms"] for b in by.values())
    rows = [{"scope": k, "device_ms": round(v["device_ms"], 4), "ops": int(v["ops"]),
             "share": round(v["device_ms"] / total, 4) if total else 0.0}
            for k, v in sorted(by.items(), key=lambda kv: -kv[1]["device_ms"])]
    named = sum(v["device_ms"] for k, v in by.items() if k != kineto.UNSCOPED)
    span = kineto.span_of(ops)
    return {
        "source": "measured",
        "device": "cuda" if tr.has_device else "cpu",
        "rows": rows[:top] if top else rows,
        "row_count": len(rows),
        "total_ms": round(total, 4),
        "coverage": round(named / total, 4) if total else 1.0,
        "span_ms": round((span[1] - span[0]) / 1e3, 4) if span else 0.0,
        "ops": len(ops),
        "linked": sum(1 for o in ops if o["linked"]),
        "by_neighbour": sum(1 for o in ops if not o["linked"]),
    }


def format_timeline(tl: dict, top: int = 12) -> str:
    """The JAX package's analytical timeline text; a measured timeline
    renders its per-scope device ms."""
    if tl.get("source") == "measured":
        lines = [f"measured timeline ({tl['device']}): {tl['total_ms']:.3f} ms of device "
                 f"ops over a {tl['span_ms']:.3f} ms span, {tl['ops']} ops, "
                 f"{tl['coverage']:.1%} in named scopes",
                 f"{'scope':<44} {'device_ms':>10} {'share':>6} {'ops':>6}"]
        for r in tl["rows"][:top]:
            lines.append(f"{r['scope'][:44]:<44} {r['device_ms']:>10.3f} "
                         f"{r['share']:>6.1%} {r['ops']:>6}")
        return "\n".join(lines)
    lines = [
        f"analytical timeline (peak {tl['peak_flops']:.3g} FLOP/s "
        f"[{tl['peak_source']}], ICI {tl['ici_bytes_per_s']:.3g} B/s "
        f"[{tl['ici_source']}])"
        if tl.get("peak_flops") else
        "analytical timeline (no peak FLOPs — collective times only)",
        f"serialized {tl['serialized_ms']:.3f} ms = compute "
        f"{tl['compute_ms']:.3f} + collectives {tl['collective_ms']:.3f}; "
        f"perfect overlap {tl['overlapped_ms']:.3f} ms "
        f"(headroom {tl['overlap_headroom_ms']:.3f} ms)",
    ]
    sa = tl.get("schedule_aware")
    if sa:
        hf = sa.get("hidden_frac")
        lines.append(
            f"schedule-aware: simulated step {sa['simulated_step_ms']:.3f} "
            f"ms — exposed wire {sa['exposed_wire_ms']:.3f} ms, hidden "
            f"{sa['hidden_wire_ms']:.3f} ms"
            + (f" ({hf:.1%} hidden)" if hf is not None else "")
            + f"; async pairs {sa['async_pairs']}, "
              f"sync {sa['sync_collectives']}"
        )
    pipe = tl.get("pipeline")
    if pipe:
        lines.append(
            f"pipeline: {pipe['schedule']} stages={pipe['stages']} "
            f"parts={pipe['parts']} ticks={pipe['ticks']} "
            f"bubble={pipe['bubble_fraction']:.3f}"
            + (
                f"  bubble-adjusted {pipe['bubble_adjusted_serialized_ms']:.3f} ms"
                if pipe.get("bubble_adjusted_serialized_ms") is not None else ""
            )
        )
    lines.append(
        f"{'scope':<44} {'compute_ms':>10} {'coll_ms':>8} {'coll_bytes':>12}"
    )
    for r in tl["rows"][:top]:
        lines.append(
            f"{r['scope'][:44]:<44} "
            f"{(r['compute_ms'] if r['compute_ms'] is not None else 0):>10.4f} "
            f"{(r['collective_ms'] if r['collective_ms'] is not None else 0):>8.4f} "
            f"{r['collective_bytes']:>12}"
        )
    return "\n".join(lines)
