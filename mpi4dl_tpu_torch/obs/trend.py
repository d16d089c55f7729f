"""Fleet-trend rollup: trajectory + regression gate over a telemetry dir
(counterpart of ``mpi4dl_tpu/obs/trend.py``; the same table and gate).

``obs report --trend DIR`` scans one directory for every RunLog
(``*.jsonl``) and every bench-ladder artifact (``BENCH_*.json``), renders
the per-metric trajectory over time, and gates the NEWEST run of each
RunLog series against its predecessor with the same extractors and
threshold semantics as ``obs report --compare`` — exit 1 on a breach, so a
CI lane pointed at its telemetry artifacts becomes a perf-regression gate
with zero extra plumbing.

Two deliberate scoping rules keep the gate honest:

- **series-scoped**: RunLog files group by their ``RunLog.create`` prefix
  (``bench-resnet56-<stamp>-p<pid>.jsonl`` -> series ``bench-resnet56``),
  and only newest-vs-previous WITHIN a series gates — a supervisor drill
  log is never "a regression against" a bench log that happens to sort
  next to it;
- **bench artifacts are informational**: ``BENCH_*.json`` rung rows
  (img/s, MFU) render in the trajectory but never gate.  Half the
  historical artifacts are crash tails whose outer JSON is front-truncated
  (``parsed: null``); the reader prefers the ``parsed`` block, attempts a
  bounded brace-scan recovery of the tail, and skips with a note — a
  missing rung must not turn the trend lane permanently red.

:func:`trend_report` is the programmatic product (the ``--trend-out`` JSON
artifact); :func:`format_trend` the rendered table.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from mpi4dl_tpu_torch.obs.report import _COMPARE_METRICS
from mpi4dl_tpu_torch.obs.runlog import read_runlog

TREND_SCHEMA = 1

#: ``RunLog.create`` filename shape: ``<prefix>-<stamp>-p<pid>[-n].jsonl``.
_SERIES_RE = re.compile(r"^(?P<series>.+)-\d{8}-\d{6}-p\d+(?:-\d+)?$")


def runlog_series(path: str) -> str:
    """The series key of one RunLog file — its ``RunLog.create`` prefix,
    or the whole basename for hand-named files."""
    base = os.path.basename(path)
    if base.endswith(".jsonl"):
        base = base[: -len(".jsonl")]
    m = _SERIES_RE.match(base)
    return m.group("series") if m else base


def _recover_truncated_json(text: str,
                            scan_limit: int = 200) -> Optional[dict]:
    """Bounded brace-scan recovery of a front-truncated JSON document: try
    ``raw_decode`` at each ``{`` (first ``scan_limit`` of them) and keep
    the best complete dict — preferring one that carries bench ``rungs``.
    Returns None when nothing decodes."""
    dec = json.JSONDecoder()
    best: Optional[dict] = None
    tried = 0
    for m in re.finditer(r"\{", text):
        if tried >= scan_limit:
            break
        tried += 1
        try:
            val, _ = dec.raw_decode(text, m.start())
        except ValueError:
            continue
        if not isinstance(val, dict):
            continue
        if "rungs" in val:
            return val
        if best is None or len(val) > len(best):
            best = val
    return best


def _bench_rungs(doc: dict) -> Dict[str, Any]:
    """Normalize the two bench-artifact shapes to ``{rung: row}``:
    ladder crash-capture files nest under ``parsed.rungs``; the
    BENCH_stripe/BENCH_ci refresh files carry ``rungs`` at top level."""
    parsed = doc.get("parsed")
    if isinstance(parsed, dict) and isinstance(parsed.get("rungs"), dict):
        return parsed["rungs"]
    if isinstance(doc.get("rungs"), dict):
        return doc["rungs"]
    return {}


def read_bench_artifact(path: str) -> Dict[str, Any]:
    """One BENCH_*.json as a trend row: ``rungs`` (possibly recovered from
    a truncated tail), ``recovered`` flag, and a ``note`` when the
    artifact yields nothing usable.  Never raises on artifact content."""
    out: Dict[str, Any] = {"path": path, "rungs": {}, "recovered": False}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        out["note"] = f"unreadable: {e}"
        return out
    if not isinstance(doc, dict):
        out["note"] = "not a JSON object"
        return out
    rungs = _bench_rungs(doc)
    if not rungs and isinstance(doc.get("tail"), str):
        # Crash-captured ladder run: the outer doc is {n, cmd, rc, tail,
        # parsed: null} with the result JSON front-truncated inside tail.
        rec = _recover_truncated_json(doc["tail"])
        if rec is not None:
            rungs = _bench_rungs({"parsed": rec, **rec})
            out["recovered"] = bool(rungs)
    if not rungs:
        out["note"] = "no rung rows (crash tail beyond recovery)"
        return out
    out["rungs"] = {
        str(k): {
            f: v.get(f) for f in ("img_per_sec", "mfu", "timing_mode")
            if isinstance(v, dict) and v.get(f) is not None
        }
        for k, v in rungs.items()
    }
    out["source"] = doc.get("source")
    return out


def _run_row(path: str) -> Dict[str, Any]:
    records = read_runlog(path)
    ts = [float(r["t"]) for r in records if r.get("t") is not None]
    metrics = {}
    for name, good, fn in _COMPARE_METRICS:
        v = fn(records)
        if v is not None:
            metrics[name] = v
    return {
        "path": path,
        "series": runlog_series(path),
        "t": min(ts) if ts else os.path.getmtime(path),
        "records": len(records),
        "metrics": metrics,
    }


def _gate(prev: Dict[str, Any], new: Dict[str, Any],
          threshold_pct: float) -> Dict[str, Any]:
    """Newest-vs-previous breach check with --compare semantics."""
    rows = []
    breaches = 0
    for name, good, _fn in _COMPARE_METRICS:
        va = prev["metrics"].get(name)
        vb = new["metrics"].get(name)
        if va is None or vb is None:
            continue
        if va == 0:
            delta = 0.0 if vb == 0 else float("inf")
        else:
            delta = (vb - va) / abs(va) * 100.0
        regressed = (delta > threshold_pct if good == "lower"
                     else delta < -threshold_pct)
        breaches += int(regressed)
        rows.append({"metric": name, "baseline": va, "candidate": vb,
                     "delta_pct": round(delta, 4), "regressed": regressed})
    return {
        "series": new["series"],
        "baseline": prev["path"],
        "candidate": new["path"],
        "metrics": rows,
        "breaches": breaches,
    }


def trend_report(directory: str,
                 threshold_pct: float = 5.0) -> Dict[str, Any]:
    """Scan ``directory`` (non-recursive) and build the trend artifact:
    per-RunLog trajectory rows (time-ordered), bench rung rows, and the
    per-series newest-vs-previous gates.  ``breaches`` > 0 means the
    newest run of some series regressed past the threshold."""
    names = sorted(os.listdir(directory))
    runs = [
        _run_row(os.path.join(directory, n))
        for n in names if n.endswith(".jsonl")
    ]
    runs.sort(key=lambda r: (r["series"], r["t"], r["path"]))
    bench = [
        read_bench_artifact(os.path.join(directory, n))
        for n in names
        if n.startswith("BENCH_") and n.endswith(".json")
    ]

    gates: List[Dict[str, Any]] = []
    by_series: Dict[str, List[Dict[str, Any]]] = {}
    for r in runs:
        by_series.setdefault(r["series"], []).append(r)
    for series, rows in sorted(by_series.items()):
        if len(rows) >= 2:
            gates.append(_gate(rows[-2], rows[-1], threshold_pct))
    return {
        "schema": TREND_SCHEMA,
        "directory": directory,
        "threshold_pct": threshold_pct,
        "runs": runs,
        "bench": bench,
        "gates": gates,
        "breaches": sum(g["breaches"] for g in gates),
    }


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def format_trend(trend: Dict[str, Any]) -> str:
    """Rendered trajectory + gate table of one :func:`trend_report`."""
    lines = [
        f"== trend  {trend['directory']}  "
        f"(threshold {trend['threshold_pct']:g}%)"
    ]
    shown = [m for m, _g, _f in _COMPARE_METRICS[:4]]
    for series, rows in _group(trend["runs"]).items():
        lines.append(f"series {series}: {len(rows)} run(s)")
        for r in rows:
            vals = "  ".join(
                f"{m}={_fmt(r['metrics'][m])}" for m in shown
                if m in r["metrics"]
            ) or "(no comparable metrics)"
            lines.append(f"  {os.path.basename(r['path'])}  {vals}")
    for b in trend["bench"]:
        base = os.path.basename(b["path"])
        if b.get("note"):
            lines.append(f"bench {base}: skipped — {b['note']}")
            continue
        mark = " [recovered from crash tail]" if b.get("recovered") else ""
        lines.append(f"bench {base}{mark}:")
        for rung, row in sorted(b["rungs"].items()):
            vals = "  ".join(f"{k}={_fmt(v)}" for k, v in row.items())
            lines.append(f"  rung {rung}: {vals}")
    for g in trend["gates"]:
        verdict = (f"{g['breaches']} REGRESSION(S)" if g["breaches"]
                   else "ok")
        lines.append(
            f"gate [{g['series']}] {os.path.basename(g['baseline'])} -> "
            f"{os.path.basename(g['candidate'])}: {verdict}"
        )
        for m in g["metrics"]:
            flag = "  REGRESSION" if m["regressed"] else ""
            lines.append(
                f"  {m['metric']:<24} {_fmt(m['baseline']):>12} -> "
                f"{_fmt(m['candidate']):>12}  "
                f"({m['delta_pct']:+.2f}%){flag}"
            )
    if not trend["gates"]:
        lines.append("gate: n/a (no series with two or more runs)")
    lines.append(
        f"{trend['breaches']} regression(s) beyond threshold"
        if trend["breaches"] else "no regressions beyond threshold"
    )
    return "\n".join(lines)


def _group(runs: List[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    out: Dict[str, List[Dict[str, Any]]] = {}
    for r in runs:
        out.setdefault(r["series"], []).append(r)
    return out
