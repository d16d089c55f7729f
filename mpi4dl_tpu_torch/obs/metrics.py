"""OpenMetrics/Prometheus text exposition over RunLog records
(counterpart of ``mpi4dl_tpu/obs/metrics.py``; the same families, names,
labels and bytes for the same records).

Any RunLog file (a training run's, a supervisor's) renders to the
OpenMetrics text format — step-latency quantiles (the same
``_percentile`` interpolation as ``StepMeter.stats()`` and ``obs
report``, so the scrape never disagrees with the report), throughput,
per-device memory watermark and skew, wire bytes per step split
quantized/raw, and supervisor incident counters by failure class.

Two sinks:

- **file** — :func:`write_metrics_file` drops a snapshot atomically next
  to the RunLog (the runners write ``<runlog>.prom`` at the end of a run;
  a node-exporter textfile collector or CI artifact picks it up);
- **endpoint** — :func:`serve_metrics` is a stdlib-only HTTP server whose
  ``/metrics`` re-reads the RunLog(s) per scrape (the
  ``MPI4DL_METRICS_PORT`` hatch is the CLI's default port).

Aggregation: :func:`metrics_from_runlogs` merges many RunLogs — a fleet's
per-job supervisor logs plus the fleet log — into ONE exposition, every
sample labeled ``job="<id>"``, each metric family declared exactly once.
``serve_metrics`` accepts the same multi-source forms, so one
``MPI4DL_METRICS_PORT`` endpoint serves them all.

CLI: ``python -m mpi4dl_tpu_torch.obs metrics run.jsonl [more.jsonl | DIR
...] [--out F] [--serve [PORT]]`` (a DIR argument expands to every
``*.jsonl`` under it, recursively).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from mpi4dl_tpu_torch.obs.runlog import read_runlog
from mpi4dl_tpu_torch.utils.misc import _percentile

#: Exposition content type (OpenMetrics; Prometheus scrapes it natively).
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_QUANTILES = (0.5, 0.9, 0.99)


def metrics_port_from_env() -> Optional[int]:
    """The ``MPI4DL_METRICS_PORT`` hatch as an int port, or None (unset or
    unparsable — file-sink only)."""
    raw = os.environ.get("MPI4DL_METRICS_PORT", "")
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


def _num(v: float) -> str:
    """Float rendering that round-trips and never uses locale separators."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _esc(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_esc(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Exposition:
    """Ordered OpenMetrics text builder (families declared once, samples
    appended under them, ``# EOF`` terminator)."""

    def __init__(self) -> None:
        self.lines: List[str] = []

    def family(self, name: str, mtype: str, help_text: str) -> None:
        self.lines.append(f"# TYPE {name} {mtype}")
        self.lines.append(f"# HELP {name} {help_text}")

    def sample(self, name: str, value: float,
               labels: Optional[Dict[str, Any]] = None) -> None:
        self.lines.append(f"{name}{_labels(labels)} {_num(float(value))}")

    def text(self) -> str:
        return "\n".join(self.lines + ["# EOF"]) + "\n"


def _measured_steps(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [r for r in records
            if r.get("kind") == "step" and r.get("measured", True)]


def _wire_totals(
    records: List[Dict[str, Any]],
) -> Optional[Tuple[float, float]]:
    """(total, quantized) wire bytes/step from ``overlap`` records — the
    min-bytes row, matching the ``obs report --compare`` extractors."""
    pairs = [
        (float(t["bytes"]), float(t.get("quantized_bytes") or 0))
        for r in records if r.get("kind") == "overlap"
        for t in [r.get("totals") or {}] if t.get("bytes") is not None
    ]
    return min(pairs) if pairs else None


#: One family's worth of samples: (name, type, help, [(sample_name,
#: value, labels), ...]).  The collect/emit split is what lets
#: :func:`metrics_from_runlogs` merge many record streams under ONE
#: family declaration per metric (OpenMetrics forbids repeating # TYPE).
_Family = Tuple[str, str, str, List[Tuple[str, float, Optional[Dict[str, Any]]]]]


def _collect(records: List[Dict[str, Any]], *, prefix: str,
             labels: Optional[Dict[str, Any]] = None) -> List[_Family]:
    """Per-family samples of one record stream.  Families with no source
    records are omitted (absent metric > lying zero), so the output of a
    supervisor log and a bench log differ in families, not in junk.
    ``labels`` (e.g. ``{"job": "alpha"}``) is stamped onto every sample."""
    base = dict(labels or {})

    def lab(extra: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        merged = {**base, **(extra or {})}
        return merged or None

    fams: List[_Family] = []
    steps = _measured_steps(records)

    if steps:
        ms = sorted(float(r["ms"]) for r in steps)
        name = f"{prefix}_step_latency_ms"
        samples = [(name, _percentile(ms, q), lab({"quantile": _num(q)}))
                   for q in _QUANTILES]
        samples += [(name + "_sum", sum(ms), lab()),
                    (name + "_count", float(len(ms)), lab())]
        fams.append((name, "summary",
                     "Measured optimizer-step wall time.", samples))

        ips = [float(r["images_per_sec"]) for r in steps
               if r.get("images_per_sec") is not None]
        if ips:
            name = f"{prefix}_images_per_sec"
            fams.append((name, "gauge", "Mean measured throughput.",
                         [(name, sum(ips) / len(ips), lab())]))

        peaks = [int(r["memory_peak_bytes"]) for r in steps
                 if r.get("memory_peak_bytes") is not None]
        if peaks:
            name = f"{prefix}_device_hbm_peak_bytes"
            fams.append((name, "gauge",
                         "Max per-device allocator watermark over the run.",
                         [(name, float(max(peaks)), lab())]))
        skews = [int(r["hbm_skew"]) for r in steps
                 if r.get("hbm_skew") is not None]
        if skews:
            name = f"{prefix}_device_hbm_skew_bytes"
            fams.append((name, "gauge",
                         "Max hot-vs-cold device watermark spread (SP "
                         "imbalance shows here before the hot tile OOMs).",
                         [(name, float(max(skews)), lab())]))
        rss = [int(r["host_rss_peak_bytes"]) for r in steps
               if r.get("host_rss_peak_bytes") is not None]
        if rss:
            name = f"{prefix}_host_rss_peak_bytes"
            fams.append((name, "gauge", "Peak host RSS over the run.",
                         [(name, float(max(rss)), lab())]))

    wire = _wire_totals(records)
    if wire is not None:
        total, quant = wire
        name = f"{prefix}_wire_bytes_per_step"
        fams.append((name, "gauge",
                     "Collective wire payload per step (overlap ledger; "
                     "quantized = sub-f32 dtypes on the wire).",
                     [(name, total, lab({"kind": "total"})),
                      (name, quant, lab({"kind": "quantized"})),
                      (name, total - quant, lab({"kind": "raw"}))]))

    counts: Dict[str, int] = {}
    for r in records:
        if r.get("kind") in ("anomaly", "recovery", "preempt",
                             "quarantine", "restore"):
            counts[str(r["kind"])] = counts.get(str(r["kind"]), 0) + 1
    if counts:
        name = f"{prefix}_resilience_events"
        fams.append((name, "counter",
                     "Resilience events recorded by the supervised loop.",
                     [(name + "_total", float(n), lab({"event": kind}))
                      for kind, n in sorted(counts.items())]))

    incidents: Dict[str, int] = {}
    for r in records:
        if r.get("kind") == "supervisor" and r.get("failure_class"):
            cls = str(r["failure_class"])
            incidents[cls] = incidents.get(cls, 0) + 1
    if incidents:
        name = f"{prefix}_supervisor_incidents"
        fams.append((name, "counter",
                     "Supervisor incidents by typed failure class.",
                     [(name + "_total", float(n), lab({"class": cls}))
                      for cls, n in sorted(incidents.items())]))
    for r in records:
        if r.get("kind") == "supervisor_summary":
            name = f"{prefix}_supervisor_ok"
            fams.append((name, "gauge",
                         "1 = the supervised run completed, 0 = gave up.",
                         [(name, 1.0 if r.get("ok") else 0.0, lab())]))
            break

    fleet_events: Dict[str, int] = {}
    for r in records:
        if r.get("kind") == "fleet" and r.get("event"):
            ev = str(r["event"])
            fleet_events[ev] = fleet_events.get(ev, 0) + 1
    if fleet_events:
        name = f"{prefix}_fleet_events"
        fams.append((name, "counter",
                     "Fleet scheduler decisions by event type.",
                     [(name + "_total", float(n), lab({"event": ev}))
                      for ev, n in sorted(fleet_events.items())]))
    for r in records:
        if r.get("kind") == "fleet_summary":
            name = f"{prefix}_fleet_ok"
            fams.append((name, "gauge",
                         "1 = every fleet job reached a non-failed "
                         "terminal state.",
                         [(name, 1.0 if r.get("ok") else 0.0, lab())]))
            states: Dict[str, int] = {}
            for st in (r.get("jobs") or {}).values():
                states[str(st)] = states.get(str(st), 0) + 1
            if states:
                name = f"{prefix}_fleet_jobs"
                fams.append((name, "gauge",
                             "Fleet jobs by final lifecycle state.",
                             [(name, float(n), lab({"state": st}))
                              for st, n in sorted(states.items())]))
            break

    if steps:
        name = f"{prefix}_steps"
        fams.append((name, "counter", "Measured optimizer steps.",
                     [(name + "_total", float(len(steps)), lab())]))
    return fams


def _emit(families: List[_Family]) -> str:
    exp = _Exposition()
    for name, mtype, help_text, samples in families:
        exp.family(name, mtype, help_text)
        for sname, value, slabels in samples:
            exp.sample(sname, value, slabels)
    return exp.text()


def metrics_from_records(records: List[Dict[str, Any]],
                         *, prefix: str = "mpi4dl",
                         labels: Optional[Dict[str, Any]] = None) -> str:
    """The OpenMetrics exposition of one record stream."""
    return _emit(_collect(records, prefix=prefix, labels=labels))


def metrics_from_runlog(path: str, *, prefix: str = "mpi4dl") -> str:
    return metrics_from_records(read_runlog(path), prefix=prefix)


def _job_paths(source) -> List[Tuple[str, str]]:
    """Normalize a metrics source into ``[(job, path), ...]``.

    A mapping is taken verbatim (sorted by job for a stable exposition).
    For a sequence of paths the job id is inferred: the file stem, except
    when stems collide (the fleet layout is ``jobs/<id>/supervisor00.jsonl``
    — every job's log shares a stem), in which case the parent directory
    name is used; any survivors of both rules are uniquified with ``~N``."""
    if isinstance(source, str):
        source = [source]
    if hasattr(source, "items"):
        return sorted((str(j), str(p)) for j, p in source.items())
    paths = [str(p) for p in source]
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    jobs = []
    for p, stem in zip(paths, stems):
        if stems.count(stem) > 1:
            parent = os.path.basename(os.path.dirname(os.path.abspath(p)))
            jobs.append(parent or stem)
        else:
            jobs.append(stem)
    seen: Dict[str, int] = {}
    out: List[Tuple[str, str]] = []
    for job, p in zip(jobs, paths):
        seen[job] = seen.get(job, 0) + 1
        out.append((job if seen[job] == 1 else f"{job}~{seen[job]}", p))
    return out


def metrics_from_runlogs(source, *, prefix: str = "mpi4dl") -> str:
    """ONE exposition over many RunLogs, every sample labeled
    ``job="<id>"`` (a fleet's jobs scrape from a single
    ``MPI4DL_METRICS_PORT`` endpoint, not one port per job).

    ``source``: a mapping ``{job: path}``, a sequence of paths (job ids
    inferred — see :func:`_job_paths`), or a single path string.  Each
    metric family is declared once with every job's samples under it."""
    merged: Dict[str, _Family] = {}
    order: List[str] = []
    for job, path in _job_paths(source):
        for name, mtype, help_text, samples in _collect(
                read_runlog(path), prefix=prefix, labels={"job": job}):
            if name not in merged:
                merged[name] = (name, mtype, help_text, [])
                order.append(name)
            merged[name][3].extend(samples)
    return _emit([merged[name] for name in order])


def _atomic_write(text: str, path: str) -> str:
    """Tmp + replace — a concurrent textfile collector never reads a half
    exposition.  Returns ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return path


def write_metrics_file(records: List[Dict[str, Any]], path: str,
                       *, prefix: str = "mpi4dl") -> str:
    """Atomic exposition snapshot of one record stream."""
    return _atomic_write(metrics_from_records(records, prefix=prefix), path)


def serve_metrics(source, port: int, *, host: str = "127.0.0.1",
                  prefix: str = "mpi4dl"):
    """A stdlib HTTP server whose ``/metrics`` re-reads ``source`` per
    scrape.  ``source`` is one RunLog path (unlabeled exposition, the
    pre-fleet behavior) or a mapping / sequence of paths (one aggregated
    ``job``-labeled exposition — the fleet's single-endpoint scrape).
    Returns the server (caller owns ``serve_forever`` / ``shutdown``;
    ``server_address[1]`` is the bound port — pass ``port=0`` for an
    ephemeral one in tests)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 — stdlib API name
            if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            try:
                if isinstance(source, str):
                    text = metrics_from_runlog(source, prefix=prefix)
                else:
                    text = metrics_from_runlogs(source, prefix=prefix)
                body = text.encode("utf-8")
            except OSError as e:
                self.send_error(500, explain=str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, format: str, *args: Any) -> None:
            pass  # scrape traffic must not spam the training job's stderr

    return ThreadingHTTPServer((host, port), _Handler)
