"""Observability for the PyTorch port: scope names, the RunLog and the
flight recorder (counterparts of the JAX package's ``obs/scopes.py``,
``obs/runlog.py`` and ``obs/flight.py``).  The cost table, the metrics
snapshot and the trace tooling are not ported yet."""

from mpi4dl_tpu_torch.obs.flight import (
    FlightRecorder,
    default_flight_path,
    flight_steps_from_env,
    read_flight,
)
from mpi4dl_tpu_torch.obs.runlog import (
    RunLog,
    active_hatches,
    device_memory_watermarks,
    host_rss_peak_bytes,
    read_runlog,
)
from mpi4dl_tpu_torch.obs.scopes import scope, step_annotation

__all__ = [
    "FlightRecorder", "RunLog", "active_hatches", "default_flight_path",
    "device_memory_watermarks", "flight_steps_from_env",
    "host_rss_peak_bytes", "read_flight", "read_runlog", "scope", "step_annotation",
]
