"""RunLog: per-run JSONL telemetry sink (counterpart of
``mpi4dl_tpu/obs/runlog.py``; the same record kinds, fields and schema).

One run = one ``.jsonl`` file; one line = one record, every record carrying
``kind`` (meta | step | summary | anomaly | recovery | preempt |
checkpoint | restore | quarantine | <custom>), ``t`` (unix seconds) and
``schema``.  The first record is the run's metadata — full config, mesh
spec, device kind, torch version, active ``MPI4DL_*`` hatches — so a step
file is self-describing.

The sink is line-buffered and flushes per record, so a crash mid-epoch keeps
everything logged so far.  :func:`read_runlog` is the programmatic reader;
the JAX package's ``read_runlog`` and report tooling read these files too.

Device watermarks come from ``torch.cuda.max_memory_allocated`` of this
process's card (one card per rank); a CPU run reports none.
``jit_cache_size`` has no PyTorch meaning: its key is written as null.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion to JSON-serializable data (dataclasses, dtypes,
    numpy and torch scalars, tuples); falls back to repr so telemetry never
    raises."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):  # numpy / torch scalars
        try:
            return obj.item()
        except Exception:  # noqa: BLE001  # analysis: ok(swallow-except) — repr() below
            pass
    return repr(obj)


def active_hatches() -> Dict[str, str]:
    """Environment values of every ``MPI4DL_*`` hatch that is SET (unset
    hatches are omitted: their defaults are the code's)."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("MPI4DL_")}


def _cuda_in_use() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_watermarks(devices=None) -> Optional[Dict[str, Any]]:
    """Watermarks across ``devices`` (default: this process's card — one
    card a rank): ``max``/``min``/``hbm_skew`` (max − min) plus the raw
    ``per_device`` list; None where CUDA is not in use."""
    import torch

    if not _cuda_in_use():
        return None
    devs = devices if devices is not None else [torch.cuda.current_device()]
    peaks = [int(torch.cuda.max_memory_allocated(d)) for d in devs]
    peaks = [p for p in peaks if p]
    if not peaks:
        return None
    return {
        "max": max(peaks),
        "min": min(peaks),
        "hbm_skew": max(peaks) - min(peaks),
        "devices": len(peaks),
        "per_device": peaks,
    }


def run_device_count() -> int:
    """The devices a run uses: the process group's world size when one is
    up (one device a rank), else 1 (a one-process run holds one device,
    however many the machine has)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_rss_peak_bytes() -> Optional[int]:
    """Process peak RSS — the memory watermark that exists on every host."""
    try:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KB on Linux, bytes on macOS.
        return int(peak if sys.platform == "darwin" else peak * 1024)
    except Exception:  # noqa: BLE001 — non-POSIX host
        return None


class RunLog:
    """Append-only JSONL writer for one run."""

    def __init__(self, path: str):
        self.path = path
        # Most recent record written (any kind) — the step watchdog dumps it
        # to stderr alongside live stacks when a step blows its budget.
        self.last_record: Optional[Dict[str, Any]] = None
        # Most recent record PER KIND: the watchdog pairs the last record
        # with the last `checkpoint` record so a stall inside a shard-
        # gather is distinguishable from a data stall.
        self.last_by_kind: Dict[str, Dict[str, Any]] = {}
        # The async checkpoint writer emits `checkpoint` records from its
        # worker thread while the training thread writes `step` records.
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    @classmethod
    def create(cls, directory: str, prefix: str = "run") -> "RunLog":
        """New uniquely-named run file under ``directory``."""
        os.makedirs(directory, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = f"{prefix}-{stamp}-p{os.getpid()}"
        path = os.path.join(directory, base + ".jsonl")
        n = 0
        while os.path.exists(path):  # same second, same pid: suffix
            n += 1
            path = os.path.join(directory, f"{base}-{n}.jsonl")
        return cls(path)

    # -- records -----------------------------------------------------------

    def write(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = {"kind": kind, "schema": SCHEMA_VERSION, "t": time.time()}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        with self._lock:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            self.last_record = rec
            self.last_by_kind[kind] = rec
        return rec

    def write_meta(self, config: Any = None, mesh_spec: Any = None,
                   argv: Optional[List[str]] = None, device=None,
                   **extra: Any) -> Dict[str, Any]:
        """The run's self-description record (always the file's first
        line): the torch version, the backend and the card's name where the
        JAX package records its jax version and devices.  ``device``: this
        process's device (default: the current card when CUDA is in use).
        ``device_count`` is the run's: the process group's world size when
        one is up (one device a rank), else 1."""
        import torch

        if device is None and _cuda_in_use():
            device = torch.device("cuda", torch.cuda.current_device())
        dev = torch.device(device) if device is not None else torch.device("cpu")
        cuda = dev.type == "cuda"
        return self.write(
            "meta",
            config=config,
            mesh=mesh_spec,
            argv=argv,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            backend=dev.type,
            device_count=run_device_count(),
            device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
            platform="gpu" if cuda else "cpu",
            hatches=active_hatches(),
            **extra,
        )

    def write_step(self, *, epoch: int, step: int, ms: float,
                   images_per_sec: float, loss: float, accuracy: float,
                   step_fn=None, measured: bool = True,
                   **extra: Any) -> Dict[str, Any]:
        """One optimizer step.  ``measured=False`` marks warmup steps
        (excluded from summary stats, kept in the record stream)."""
        wm = device_memory_watermarks()
        return self.write(
            "step",
            epoch=epoch,
            step=step,
            ms=round(float(ms), 3),
            images_per_sec=round(float(images_per_sec), 3),
            loss=float(loss),
            accuracy=float(accuracy),
            measured=bool(measured),
            memory_peak_bytes=None if wm is None else wm["max"],
            memory_peak_bytes_min=None if wm is None else wm["min"],
            hbm_skew=None if wm is None else wm["hbm_skew"],
            host_rss_peak_bytes=host_rss_peak_bytes(),
            jit_cache_size=None,
            **extra,
        )

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_runlog(path: str) -> List[Dict[str, Any]]:
    """Parse one run file back into records, skipping malformed lines with a
    stderr note — a crashed run truncates its last line mid-write."""
    import sys

    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                sys.stderr.write(
                    f"[obs] {path}:{lineno}: skipping torn record "
                    f"({len(line)} bytes) — truncated mid-write?\n")
                continue
    return out
