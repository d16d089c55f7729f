"""Observability for the PyTorch port (counterpart of ``mpi4dl_tpu/obs``):
scope names and their paths (``obs/scopes.py``), the RunLog and the flight
recorder; the step's cost counts (FLOPs, bytes, MFU: ``obs/costs.py``);
the step instruments, the counterparts of the JAX package's HLO walkers:
the collectives a step issues (``obs/comm_stats.py``), per-scope
attribution of the peak bytes (``obs/hbm.py``), the analytical and
measured per-scope timelines (``obs/timeline.py``), the exposed-wire
ledger (``obs/overlap.py``) and the profiler-trace reader they share
(``obs/kineto.py``); the OpenMetrics exposition, the report, the trend
gate and the trace export, with their CLI (``python -m
mpi4dl_tpu_torch.obs report|overlap|trace|metrics``)."""

from mpi4dl_tpu_torch.obs.comm_stats import (
    collective_stats,
    recording_collectives,
)
from mpi4dl_tpu_torch.obs.costs import (
    arithmetic_intensity,
    counting,
    ici_bytes_per_s,
    mfu,
    peak_flops,
    step_cost,
)
from mpi4dl_tpu_torch.obs.flight import (
    FlightRecorder,
    default_flight_path,
    flight_steps_from_env,
    flight_summary,
    read_flight,
    watermark_growth,
)
from mpi4dl_tpu_torch.obs.metrics import (
    metrics_from_records,
    metrics_from_runlog,
    metrics_from_runlogs,
    serve_metrics,
    write_metrics_file,
)
from mpi4dl_tpu_torch.obs.runlog import (
    RunLog,
    active_hatches,
    device_memory_watermarks,
    host_rss_peak_bytes,
    read_runlog,
)
from mpi4dl_tpu_torch.obs.hbm import (
    compare_breakdowns,
    format_breakdown,
    peak_tracker,
    scope_group_bytes,
    top_scope,
)
from mpi4dl_tpu_torch.obs.overlap import (
    format_ledger,
    ledger_from_records,
    ledger_from_trace,
    overlap_ledger,
    structural_overlap,
)
from mpi4dl_tpu_torch.obs.scopes import (
    current_path,
    instrumenting,
    recording_scopes,
    scope,
    step_annotation,
)
from mpi4dl_tpu_torch.obs.timeline import (
    analytical_timeline,
    format_timeline,
    measured_timeline,
)
from mpi4dl_tpu_torch.obs.trace import chrome_trace, step_trace_events, trace_from_runlog
from mpi4dl_tpu_torch.obs.trend import format_trend, read_bench_artifact, trend_report

__all__ = [
    "FlightRecorder", "RunLog", "active_hatches", "analytical_timeline",
    "arithmetic_intensity", "chrome_trace", "collective_stats", "compare_breakdowns",
    "counting", "current_path", "default_flight_path", "device_memory_watermarks",
    "flight_steps_from_env", "flight_summary", "format_breakdown", "format_ledger",
    "format_timeline", "format_trend", "host_rss_peak_bytes", "ici_bytes_per_s",
    "instrumenting", "ledger_from_records", "ledger_from_trace", "measured_timeline",
    "metrics_from_records", "metrics_from_runlog", "metrics_from_runlogs", "mfu",
    "overlap_ledger", "peak_flops", "peak_tracker", "read_bench_artifact", "read_flight",
    "read_runlog", "recording_collectives", "recording_scopes", "scope",
    "scope_group_bytes", "serve_metrics", "step_annotation", "step_cost",
    "step_trace_events", "structural_overlap", "top_scope", "trace_from_runlog",
    "trend_report", "watermark_growth", "write_metrics_file",
]
