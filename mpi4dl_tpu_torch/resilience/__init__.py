"""Resilience for the PyTorch port (counterpart of ``mpi4dl_tpu/resilience``,
its first part): the supervised training loop every runner family trains
under, and what it is made of.

- :mod:`~mpi4dl_tpu_torch.resilience.loop` — ``run_supervised``: the
  supervised loop of the lp / sp / gems / gems_sp runners, on one process
  or on the ranks of a ``torchrun`` job.
- :mod:`~mpi4dl_tpu_torch.resilience.guard` — per-step finite-loss (and
  opt-in grad-norm) check; on anomaly the loop rolls back to the last good
  checkpoint and skips the poison batch.
- :mod:`~mpi4dl_tpu_torch.resilience.preempt` — SIGTERM/SIGINT → finish
  the in-flight step, save, return (exit 0).
- :mod:`~mpi4dl_tpu_torch.resilience.writer` — background checkpoint
  writes (device-to-host copies on the training thread; CRC32, write,
  fsync and publish off it).
- :mod:`~mpi4dl_tpu_torch.resilience.faults` — deterministic fault
  injection via ``MPI4DL_FAULT=<kind>@<step>[:arg]``.
- :mod:`~mpi4dl_tpu_torch.resilience.watchdog` — step wall-clock watchdog
  that dumps live stacks, the last RunLog + ``checkpoint`` records, and
  live host and CUDA memory stats before a hang dies silently.
- :mod:`~mpi4dl_tpu_torch.resilience.supervisor` — the crash marker (per
  rank) and the quarantine list the loop honors.

The supervisor's classifier and policies, the planner, the allocator, the
fleet scheduler and the drill harness are not ported yet.
"""

from __future__ import annotations

from mpi4dl_tpu_torch.resilience.faults import (
    CKPT_FAULT_KINDS,
    FAULT_KINDS,
    FaultInjected,
    FaultInjector,
    FaultSpec,
    MeshShrunk,
    corrupt_file,
    fault_from_env,
    lose_shard_files,
    parse_fault,
    synthetic_oom,
)
from mpi4dl_tpu_torch.resilience.guard import AnomalyError, AnomalyGuard, global_norm
from mpi4dl_tpu_torch.resilience.loop import LoopResult, run_supervised
from mpi4dl_tpu_torch.resilience.preempt import PreemptionHandler
from mpi4dl_tpu_torch.resilience.supervisor import (
    crash_marker_path,
    quarantine_steps_from_env,
    read_crash_marker,
    write_crash_marker,
)
from mpi4dl_tpu_torch.resilience.watchdog import (
    HANG_EXIT_CODE,
    StepWatchdog,
    dump_stacks,
    memory_report_lines,
    watchdog_budget_from_env,
    watchdog_compile_budget_from_env,
    watchdog_escalation_from_env,
)
from mpi4dl_tpu_torch.resilience.writer import (
    AsyncCheckpointWriter,
    CheckpointWriteError,
    pending_bytes_budget,
)

__all__ = [
    "CKPT_FAULT_KINDS",
    "FAULT_KINDS",
    "HANG_EXIT_CODE",
    "AnomalyError",
    "AnomalyGuard",
    "AsyncCheckpointWriter",
    "CheckpointWriteError",
    "FaultInjected",
    "FaultInjector",
    "FaultSpec",
    "LoopResult",
    "MeshShrunk",
    "PreemptionHandler",
    "StepWatchdog",
    "corrupt_file",
    "crash_marker_path",
    "dump_stacks",
    "fault_from_env",
    "global_norm",
    "lose_shard_files",
    "memory_report_lines",
    "parse_fault",
    "pending_bytes_budget",
    "quarantine_steps_from_env",
    "read_crash_marker",
    "run_supervised",
    "synthetic_oom",
    "watchdog_budget_from_env",
    "watchdog_compile_budget_from_env",
    "watchdog_escalation_from_env",
    "write_crash_marker",
]
