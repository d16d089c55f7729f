"""Render a RunLog JSONL file as a human-readable summary (counterpart of
``mpi4dl_tpu/obs/report.py``: the same lines for the same records, but
the ``devices:`` line, which names the torch and CUDA versions where the
JAX package names its jax version).

Pure string construction (printing happens in obs/__main__.py — the CLI
surface; library modules never print).  The summary is computed from the
step records themselves, so it works on files from crashed runs that never
wrote a summary record.  Sections whose records the port's runners do not
write yet (``mem_probe``, ``hbm``, ``overlap``, ``timeline``,
``junction_sweep``, ``supervisor``, ``drill``, ``fleet``) render when
present, as the JAX package's do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from mpi4dl_tpu_torch.obs.costs import mfu
from mpi4dl_tpu_torch.obs.runlog import read_runlog
from mpi4dl_tpu_torch.obs.timeline import bubble_fraction, pipeline_ticks
# Same interpolation as StepMeter.stats(), so report percentiles of the raw
# step records always match a run's own summary record.
from mpi4dl_tpu_torch.utils.misc import _percentile as _pct

# The collective classes of a cost record's ``collectives`` (the JAX
# package's ``obs/hlo_stats.py:24-27``).
COLLECTIVE_CLASSES = (
    "collective-permute", "all-reduce", "all-gather", "reduce-scatter",
    "all-to-all",
)


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _first(records: List[dict], kind: str) -> Optional[dict]:
    for r in records:
        if r.get("kind") == kind:
            return r
    return None


def render_run(path: str) -> str:
    """The report for one run file."""
    records = read_runlog(path)
    lines: List[str] = [f"== {path}"]
    meta = _first(records, "meta")
    cost = _first(records, "cost")
    steps = [r for r in records if r.get("kind") == "step"]
    measured = [r for r in steps if r.get("measured", True)]
    warmup = len(steps) - len(measured)

    if meta is not None:
        cfg = meta.get("config") or {}
        desc = " ".join(
            f"{k}={cfg[k]}" for k in (
                "model", "image_size", "batch_size", "split_size",
                "spatial_size", "parts", "precision",
            ) if k in cfg
        )
        lines.append(
            f"run: family={meta.get('family', '?')} {desc}".rstrip()
        )
        lines.append(
            f"devices: {meta.get('device_count')} x {meta.get('platform')} "
            f"({meta.get('device_kind')})  mesh={meta.get('mesh')}  "
            f"torch {meta.get('torch_version')} cuda {meta.get('cuda_version')}"
        )
        if meta.get("hatches"):
            lines.append(
                "hatches: " + " ".join(
                    f"{k}={v}" for k, v in sorted(meta["hatches"].items())
                )
            )

    # -- step timings ------------------------------------------------------
    if measured:
        ms = sorted(float(r["ms"]) for r in measured)
        mean = sum(ms) / len(ms)
        med = _pct(ms, 0.5)
        lines.append(
            f"steps: {len(measured)} measured, {warmup} warmup dropped"
        )
        lines.append(
            f"step time ms: mean {mean:.2f}  median {med:.2f}  "
            f"p10 {_pct(ms, 0.10):.2f}  p90 {_pct(ms, 0.90):.2f}  "
            f"min {ms[0]:.2f}"
        )
        ips = [float(r["images_per_sec"]) for r in measured]
        last_loss = measured[-1].get("loss")
        lines.append(
            f"images/sec: mean {sum(ips) / len(ips):.3f}  last-loss "
            + (f"{last_loss:.4f}" if last_loss is not None else "n/a")
        )
    else:
        med = None
        lines.append(f"steps: 0 measured, {warmup} warmup dropped")

    # -- resilience events ---------------------------------------------------
    events = [r for r in records
              if r.get("kind") in ("anomaly", "recovery", "preempt",
                                   "quarantine")]
    if events:
        parts = []
        for r in events:
            at = r.get("gstep", r.get("skipped_step"))
            extra = ""
            if r["kind"] == "anomaly":
                extra = f" ({r.get('reason')})"
            elif r["kind"] == "recovery":
                extra = f" (resumed from {r.get('resumed_from')})"
            parts.append(f"{r['kind']}@{at}{extra}")
        lines.append("resilience events: " + "; ".join(parts))

    # -- supervisor incident timeline ---------------------------------------
    incidents = [r for r in records if r.get("kind") == "supervisor"]
    if incidents:
        lines.append(f"supervisor incidents: {len(incidents)}")
        for r in incidents:
            bits = [f"  attempt {r.get('attempt')}: "
                    f"{r.get('failure_class')} -> {r.get('policy')}"]
            delta = r.get("config_delta")
            if delta:
                bits.append("delta " + ",".join(
                    f"{k}={v}" for k, v in delta.items()
                ))
            probe = r.get("probe") or {}
            if probe.get("probe_peak_gb") is not None:
                gauge = probe.get("budget_gb")
                bits.append(
                    f"probed {probe['probe_peak_gb']} GB"
                    + (f" <= {gauge} GB" if gauge is not None else "")
                )
            if r.get("backoff_s") is not None:
                bits.append(f"backoff {r['backoff_s']} s")
            if r.get("quarantined"):
                bits.append(f"quarantined {r['quarantined']}")
            lines.append("  ".join(bits))
    sup_sum = _first(records, "supervisor_summary")
    if sup_sum is not None:
        lines.append(
            f"supervisor: {'completed' if sup_sum.get('ok') else 'FAILED'} "
            f"after {sup_sum.get('attempts')} leg(s), "
            f"{sup_sum.get('incidents')} incident(s)"
            + (f" — {sup_sum.get('reason')}" if sup_sum.get("reason") else "")
        )

    # -- checkpoint ledger (save cost + elastic restores) ------------------
    ckpts = [r for r in records if r.get("kind") == "checkpoint"]
    if ckpts:
        total_b = sum(int(r.get("bytes") or 0) for r in ckpts)
        gather = sum(float(r.get("gather_ms") or 0) for r in ckpts)
        write = sum(float(r.get("write_ms") or 0) for r in ckpts)
        peak = max(int(r.get("peak_pending_bytes") or 0) for r in ckpts)
        lines.append(
            f"checkpoints: {len(ckpts)} saves  {_fmt_bytes(total_b)}  "
            f"gather {gather:.1f} ms  write {write:.1f} ms  "
            f"peak pending {_fmt_bytes(peak)}"
        )
    restores = [r for r in records if r.get("kind") == "restore"]
    for r in restores:
        lines.append(
            f"restore: step {r.get('step_id')} from {r.get('path')}"
            + (" [ELASTIC — saved under a different layout]"
               if r.get("elastic") else "")
        )

    # -- drill verdicts (the resilience drill's records) -------------------
    drills = [r for r in records if r.get("kind") == "drill"]
    if drills:
        ok = sum(1 for r in drills if r.get("passed"))
        lines.append(f"drills: {ok}/{len(drills)} verified recoveries")
        for r in drills:
            mark = "PASS" if r.get("passed") else "FAIL"
            extra = "" if r.get("passed") else f" — {r.get('reason', '')}"
            lines.append(
                f"  {mark} {r.get('scenario')}: {r.get('verdict')}{extra}"
            )

    # -- fleet timeline (the scheduler's decision ledger) ------------------
    fleet = [r for r in records if r.get("kind") == "fleet"]
    if fleet:
        lines.append(f"fleet timeline: {len(fleet)} events")
        for r in fleet:
            bits = [f"  t={r.get('t'):>8} {r.get('event')}"]
            if r.get("job"):
                bits.append(str(r["job"]))
            if r.get("state"):
                bits.append(f"-> {r['state']}")
            if r.get("slice"):
                bits.append(str(r["slice"]))
            if r.get("victim"):
                bits.append(f"victim={r['victim']}")
            if r.get("reason"):
                bits.append(f"({r['reason']})")
            lines.append("  ".join(bits))
    fleet_sum = _first(records, "fleet_summary")
    if fleet_sum is not None:
        jobs = fleet_sum.get("jobs") or {}
        lines.append(
            f"fleet: {'OK' if fleet_sum.get('ok') else 'FAILED'} — "
            + ", ".join(f"{j}={st}" for j, st in sorted(jobs.items()))
            + (f"  (pool {fleet_sum.get('pool')}, "
               f"{fleet_sum.get('events')} events)")
        )

    # -- memory watermark --------------------------------------------------
    dev_peaks = [r.get("memory_peak_bytes") for r in steps
                 if r.get("memory_peak_bytes") is not None]
    rss_peaks = [r.get("host_rss_peak_bytes") for r in steps
                 if r.get("host_rss_peak_bytes") is not None]
    if dev_peaks:
        lines.append(f"memory watermark: {_fmt_bytes(max(dev_peaks))} "
                     "(device peak_bytes_in_use)")
        skews = [r.get("hbm_skew") for r in steps
                 if r.get("hbm_skew") is not None]
        if skews:
            # Hot-vs-cold device spread: SP imbalance shows here while the
            # device-0 watermark still reads healthy.
            lines.append(
                f"hbm skew: {_fmt_bytes(max(skews))} max spread across "
                "local devices (hot tile vs coldest)"
            )
    elif rss_peaks:
        lines.append(f"memory watermark: {_fmt_bytes(max(rss_peaks))} "
                     "(host peak RSS; backend reports no device stats)")
    else:
        lines.append("memory watermark: n/a")

    # -- pipeline schedule -------------------------------------------------
    # Keyed on the meta family, not just split_size: tools that record raw
    # argparse defaults (mem_probe's single-chip mode carries
    # --split-size 2) must not render a pipeline line for a run without one.
    cfg = (meta.get("config") or {}) if meta is not None else {}
    split = int(cfg.get("split_size") or 1)
    if split > 1 and (meta or {}).get("family") != "single":
        parts_n = int(cfg.get("parts") or 1)
        schedule = cfg.get("schedule") or "gpipe"
        # Canonical tick/bubble arithmetic lives in obs/timeline.py; unknown
        # schedules (e.g. mem_probe's multi-schedule sweeps record
        # schedule="both") yield None — don't render one schedule's numbers
        # under another's name.
        ticks = pipeline_ticks(schedule, split, parts_n)
        bubble = bubble_fraction(schedule, split, parts_n)
        line = f"pipeline: schedule={schedule}  stages={split}  parts={parts_n}"
        if ticks is not None:
            line += f"  ticks/step={ticks}  bubble={bubble:.3f}"
        # Corroborate from the cost record's tick scopes: the schedule's
        # scopes that the counted step opened.
        scopes_seen = (cost or {}).get("tick_scopes")
        if scopes_seen:
            line += "  scopes: " + ",".join(scopes_seen)
        lines.append(line)

    # -- exposed wire (overlap ledger, next to the pipeline line) ----------
    for rec in records:
        if rec.get("kind") != "overlap":
            continue
        t = rec.get("totals") or {}
        label = rec.get("label")
        hf = rec.get("hidden_frac")
        qb = t.get("quantized_bytes") or 0
        lines.append(
            "wire" + (f" [{label}]" if label else "") + ": "
            f"{_fmt_bytes(t.get('bytes'))}/step"
            + (f" ({_fmt_bytes(qb)} quantized)" if qb else "")
            + " — exposed "
            f"{t.get('exposed_ms')} ms, hidden {t.get('hidden_ms')} ms"
            + (f" ({hf:.1%} hidden)" if hf is not None else "")
            + f"; async pairs {t.get('async_pairs', 0)}, "
              f"sync {t.get('sync', 0)}; sim step "
              f"{rec.get('simulated_step_ms')} ms"
        )
        exposed_rows = [r for r in (rec.get("rows") or [])
                        if r.get("exposed_ms")]
        for r in exposed_rows[:4]:
            lines.append(
                f"  {r['exposed_ms']:>10.3f} ms exposed  "
                f"{_fmt_bytes(r.get('bytes')):>10}  {r['scope']}"
            )

    # -- retraces ----------------------------------------------------------
    sizes = [r.get("jit_cache_size") for r in steps
             if r.get("jit_cache_size") is not None]
    if sizes:
        if max(sizes) <= 2:
            # 2 variants is the normal donate+reshard pattern: the first call
            # sees unsharded inputs, every later call the mesh-sharded state.
            note = ""
        else:
            note = "  RETRACE HAZARD (shape/dtype/sharding churn in the loop)"
        lines.append(f"compiled step variants (jit cache): {max(sizes)}{note}")

    # -- derived cost metrics ----------------------------------------------
    if cost is not None:
        flops = cost.get("flops")
        nbytes = cost.get("bytes_accessed")
        ai = cost.get("arithmetic_intensity")
        if flops:
            lines.append(
                f"cost model: flops/step {flops:.4g}  bytes/step "
                f"{_fmt_bytes(nbytes)}  arithmetic intensity "
                + (f"{ai:.2f} flops/byte" if ai else "n/a")
            )
        else:
            lines.append("cost model: n/a (backend lacks cost_analysis)")
        peak = cost.get("peak_flops")
        ndev = cost.get("device_count") or 1
        # flops is one device's share (the step of a one-process run, a
        # rank's mean on ranks), so utilization is against ONE card's peak.
        util = mfu(flops, med, peak)
        if util is not None:
            lines.append(
                f"mfu estimate: {util:.4f} "
                f"(median step, per-device peak {peak:.3g} FLOP/s, "
                f"{ndev} devices, peak source: {cost.get('peak_source')})"
            )
        else:
            lines.append("mfu estimate: n/a (missing flops, steps, or peak)")
        coll = cost.get("collectives") or {}
        if coll:
            lines.append("collectives per step (compiled HLO):")
            for cls in COLLECTIVE_CLASSES:
                c = coll.get(cls) or {}
                lines.append(
                    f"  {cls:<19} count {c.get('count', 0):>4}  "
                    f"bytes {_fmt_bytes(c.get('bytes', 0))}"
                )
            lines.append(
                f"  {'total':<19} count {coll.get('total_count', 0):>4}  "
                f"bytes {_fmt_bytes(coll.get('total_bytes', 0))}"
            )

    # -- mem_probe / HBM attribution / timeline / junction sweep -----------
    probe = _first(records, "mem_probe")
    if probe is not None and probe.get("table"):
        lines.append("mem_probe (compile-only peak HBM):")
        lines.extend("  " + ln for ln in str(probe["table"]).splitlines())
    if probe is not None and probe.get("parts_delta"):
        pd = probe["parts_delta"]
        for sched, d in (pd.get("per_schedule") or {}).items():
            lines.append(
                f"O(parts) growth [{sched}] parts {pd.get('parts_a')} -> "
                f"{pd.get('parts_b')} (top group: "
                f"{d.get('top_growth_group')}):"
            )
            for k, v in list(
                (d.get("growth_bytes_per_part") or {}).items()
            )[:6]:
                lines.append(f"  {_fmt_bytes(v):>10}/part  {k}")
    for rec in records:
        if rec.get("kind") != "hbm":
            continue
        bd = rec.get("breakdown") or {}
        label = rec.get("label")
        lines.append(
            "hbm attribution" + (f" [{label}]" if label else "") + ": peak "
            f"{_fmt_bytes(bd.get('peak_bytes_est'))} (analytical), coverage "
            f"{bd.get('coverage', 0):.1%}"
        )
        for k, v in list((bd.get("by_scope") or {}).items())[:6]:
            lines.append(f"  {_fmt_bytes(v):>10}  {k}")
    for tl in records:
        if tl.get("kind") != "timeline" or tl.get("source") != "measured":
            continue
        label = tl.get("label")
        lines.append(
            "measured timeline" + (f" [{label}]" if label else "") + ": "
            f"{tl.get('total_ms')} ms of device ops, {tl.get('coverage', 0):.1%} in "
            f"named scopes ({tl.get('ops')} ops)"
        )
        for r in (tl.get("rows") or [])[:6]:
            lines.append(f"  {r['device_ms']:>10.3f} ms  {r['scope']}")
    ops = _first(records, "xprof_ops")
    if ops is not None:
        lines.append(f"device ops: total self time {ops.get('total_self_ms')} ms "
                     f"(top {len(ops.get('ops') or [])})")
        for o in (ops.get("ops") or [])[:6]:
            lines.append(f"  {o.get('self_ms'):>10.3f} ms  x{o.get('occurrences')}  "
                         f"{o.get('name')}  [{o.get('category')}]")
    tl = next((r for r in records if r.get("kind") == "timeline"
               and r.get("source") != "measured"), None)
    if tl is not None:
        lines.append(
            f"analytical timeline: serialized {tl.get('serialized_ms')} ms "
            f"(compute {tl.get('compute_ms')} + collectives "
            f"{tl.get('collective_ms')}), perfect overlap "
            f"{tl.get('overlapped_ms')} ms — headroom "
            f"{tl.get('overlap_headroom_ms')} ms"
        )
    sweep = _first(records, "junction_sweep")
    if sweep is not None:
        lines.append(
            "junction placement frontier (spatial_until -> peak GB/device):"
        )
        for p in sweep.get("placements") or []:
            mark = " <-- best" if p.get("best") else ""
            lines.append(
                f"  spatial_until={p.get('spatial_until'):>3}  "
                f"{p.get('peak_gb_est')} GB{mark}"
            )
    return "\n".join(lines)


def render(paths: Sequence[str]) -> str:
    return "\n\n".join(render_run(p) for p in paths)


# ---------------------------------------------------------------------------
# A/B regression compare (the perf gate over RunLog artifacts)
# ---------------------------------------------------------------------------

# metric name -> (direction, extractor).  Direction "lower"/"higher" is the
# GOOD direction; a move in the other direction beyond the threshold is a
# regression breach.
def _median_ms(records: List[dict]) -> Optional[float]:
    ms = sorted(
        float(r["ms"]) for r in records
        if r.get("kind") == "step" and r.get("measured", True)
    )
    return _pct(ms, 0.5) if ms else None


def _mean_ips(records: List[dict]) -> Optional[float]:
    ips = [
        float(r["images_per_sec"]) for r in records
        if r.get("kind") == "step" and r.get("measured", True)
    ]
    return sum(ips) / len(ips) if ips else None


def _peak_hbm(records: List[dict]) -> Optional[float]:
    peaks = [
        r["memory_peak_bytes"] for r in records
        if r.get("kind") == "step" and r.get("memory_peak_bytes") is not None
    ]
    if peaks:
        return max(peaks)
    # Compile-only artifacts fall back to the analytical liveness estimate.
    # Never mixed with measured watermarks: the estimate over-counts by a
    # documented 1.1-2.4x (obs/hbm.py), so max() across the two kinds would
    # compare incomparable quantities between an instrumented and a plain
    # run.
    est = [
        r["breakdown"]["peak_bytes_est"] for r in records
        if r.get("kind") == "hbm"
        and (r.get("breakdown") or {}).get("peak_bytes_est")
    ]
    return max(est) if est else None


def _coll_bytes(records: List[dict]) -> Optional[float]:
    for r in records:
        if r.get("kind") == "cost" and (r.get("collectives") or {}).get(
            "total_bytes"
        ) is not None:
            return float(r["collectives"]["total_bytes"])
    return None


def _probe_peak_gb(records: List[dict]) -> Optional[float]:
    for r in records:
        if r.get("kind") == "mem_probe":
            rows = r.get("schedules") or {}
            vals = [
                v.get("peak_gb_est") for v in rows.values()
                if isinstance(v, dict) and v.get("peak_gb_est") is not None
            ]
            if vals:
                return min(vals)
            if r.get("peak_gb_est") is not None:
                return float(r["peak_gb_est"])
    return None


def _overlap_byte_pairs(records: List[dict]) -> List[Tuple[float, float]]:
    """(total, quantized) wire bytes of every ``overlap`` record — the one
    scan both wire-byte compare metrics min-reduce over."""
    return [
        (float(t["bytes"]), float(t.get("quantized_bytes") or 0))
        for r in records if r.get("kind") == "overlap"
        for t in [r.get("totals") or {}] if t.get("bytes") is not None
    ]


def _wire_bytes(records: List[dict]) -> Optional[float]:
    """Total wire bytes/step from ``overlap`` records (best probed row)."""
    pairs = _overlap_byte_pairs(records)
    return min(b for b, _ in pairs) if pairs else None


def _raw_wire_bytes(records: List[dict]) -> Optional[float]:
    """UNQUANTIZED wire bytes/step (total - quantized) — the quantized-vs-
    raw split as a first-class compare metric: a run that loses its
    quantized payloads (the quant layer silently off) regresses here even
    if total bytes barely move.  Records predating the quantized_bytes
    column report their total (all-raw)."""
    pairs = _overlap_byte_pairs(records)
    return min(b - q for b, q in pairs) if pairs else None


def _exposed_wire_ms(records: List[dict]) -> Optional[float]:
    """Exposed-wire time from ``overlap`` records (best probed row, like
    the mem_probe peak metric), falling back to the timeline record's
    schedule-aware block for older artifacts."""
    vals = [
        float(r["totals"]["exposed_ms"]) for r in records
        if r.get("kind") == "overlap"
        and (r.get("totals") or {}).get("exposed_ms") is not None
    ]
    if vals:
        return min(vals)
    for r in records:
        sa = (r.get("schedule_aware") or {}) if r.get("kind") == "timeline" \
            else {}
        if sa.get("exposed_wire_ms") is not None:
            return float(sa["exposed_wire_ms"])
    return None


_COMPARE_METRICS = [
    ("step ms (median)", "lower", _median_ms),
    ("images/sec (mean)", "higher", _mean_ips),
    ("peak HBM bytes", "lower", _peak_hbm),
    ("collective bytes/step", "lower", _coll_bytes),
    ("mem_probe peak GB", "lower", _probe_peak_gb),
    ("exposed wire ms", "lower", _exposed_wire_ms),
    ("wire bytes/step", "lower", _wire_bytes),
    ("raw (unquantized) wire bytes", "lower", _raw_wire_bytes),
]


def compare_runs(path_a: str, path_b: str,
                 threshold_pct: float = 5.0) -> Tuple[str, int]:
    """Per-metric regression diff of two RunLog files (A = baseline,
    B = candidate).  Returns ``(report text, breach count)`` — a breach is a
    metric that moved against its good direction by more than
    ``threshold_pct`` percent.  Metrics absent from either file are skipped
    (reported as such), so a compile-only probe artifact and a full
    benchmark run can still be compared on their shared metrics."""
    ra, rb = read_runlog(path_a), read_runlog(path_b)
    lines = [f"== compare  A: {path_a}  ->  B: {path_b}  "
             f"(threshold {threshold_pct:g}%)"]
    breaches = 0
    for name, good, fn in _COMPARE_METRICS:
        va, vb = fn(ra), fn(rb)
        if va is None or vb is None:
            lines.append(f"  {name:<24} n/a (missing in "
                         f"{'A' if va is None else 'B'})")
            continue
        if va == 0:
            delta_pct = 0.0 if vb == 0 else float("inf")
        else:
            delta_pct = (vb - va) / abs(va) * 100.0
        regressed = (
            delta_pct > threshold_pct if good == "lower"
            else delta_pct < -threshold_pct
        )
        flag = "  REGRESSION" if regressed else ""
        breaches += int(regressed)
        lines.append(
            f"  {name:<24} {va:>14.4g} -> {vb:>14.4g}  "
            f"({delta_pct:+.2f}%){flag}"
        )
    lines.append(
        f"{breaches} regression(s) beyond threshold" if breaches
        else "no regressions beyond threshold"
    )
    return "\n".join(lines), breaches
