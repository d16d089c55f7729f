"""Observability for the PyTorch port (counterpart of ``mpi4dl_tpu/obs``):
scope names, the RunLog and the flight recorder; the step's cost counts
(FLOPs, bytes, MFU: ``obs/costs.py``); the OpenMetrics exposition, the
report, the trend gate and the RunLog trace export, with their CLI
(``python -m mpi4dl_tpu_torch.obs report|metrics|trace``).  The
compiled-program half of the JAX package's telemetry (collective
statistics, HBM attribution, overlap ledger, analytical timeline) is not
ported yet."""

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
from mpi4dl_tpu_torch.obs.scopes import recording_scopes, scope, step_annotation
from mpi4dl_tpu_torch.obs.trace import chrome_trace, trace_from_runlog
from mpi4dl_tpu_torch.obs.trend import format_trend, read_bench_artifact, trend_report

__all__ = [
    "FlightRecorder", "RunLog", "active_hatches", "arithmetic_intensity",
    "chrome_trace", "counting", "default_flight_path", "device_memory_watermarks",
    "flight_steps_from_env", "flight_summary", "format_trend", "host_rss_peak_bytes",
    "ici_bytes_per_s",
    "metrics_from_records", "metrics_from_runlog", "metrics_from_runlogs", "mfu",
    "peak_flops", "read_bench_artifact", "read_flight", "read_runlog",
    "recording_scopes", "scope", "serve_metrics", "step_annotation", "step_cost",
    "trace_from_runlog", "trend_report", "watermark_growth", "write_metrics_file",
]
