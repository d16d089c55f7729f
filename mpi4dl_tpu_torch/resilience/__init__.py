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
  rank), the quarantine list the loop honors, and the elastic supervisor:
  legs as rank sets, the typed failure taxonomy, per-class retry/backoff,
  poison-batch quarantine, degrade-and-continue.
- :mod:`~mpi4dl_tpu_torch.resilience.planner` — the degradation ladder,
  the upward (re-expansion) search and the feasibility probe
  (``benchmarks/mem_probe.py``) the supervisor re-plans with.
- :mod:`~mpi4dl_tpu_torch.resilience.drill` — the fault drill harness
  (``python -m mpi4dl_tpu_torch.resilience drill``): scripted disasters
  with typed per-scenario verdicts; ``--supervisor`` drills the
  supervisor's whole control plane.
- :mod:`~mpi4dl_tpu_torch.resilience.allocator` — deterministic
  first-fit-decreasing slices of a device pool, and a slice's environment
  (``CUDA_VISIBLE_DEVICES`` on cards, a gloo rank count on the CPU).
- :mod:`~mpi4dl_tpu_torch.resilience.fleet` — the multi-tenant fleet
  scheduler: N prioritized jobs, each a supervisor on its slice, with
  degraded admission, priority preemption as a graceful drain, slice loss,
  re-expansion and poison quarantine; ``drill --fleet`` is its chaos
  matrix.
"""

from __future__ import annotations

from mpi4dl_tpu_torch.resilience.drill import (
    DrillVerdict,
    Scenario,
    SupervisorScenario,
    default_scenarios,
    run_drills,
    run_scenario,
    run_supervisor_drills,
    supervisor_scenarios,
)
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
from mpi4dl_tpu_torch.resilience.allocator import PackResult, Request, Slice, pack, slice_env
from mpi4dl_tpu_torch.resilience.fleet import (
    JOB_STATES,
    TERMINAL_STATES,
    FleetJob,
    FleetResult,
    FleetScenario,
    FleetScheduler,
    fleet_knobs_from_env,
    fleet_pool,
    fleet_scenarios,
    run_fleet_drills,
    run_fleet_scenario,
    visible_cards,
)
from mpi4dl_tpu_torch.resilience.guard import AnomalyError, AnomalyGuard, global_norm
from mpi4dl_tpu_torch.resilience.loop import LoopResult, run_supervised
from mpi4dl_tpu_torch.resilience.preempt import PreemptionHandler
from mpi4dl_tpu_torch.resilience.planner import (
    INFEASIBLE,
    Plan,
    compile_probe,
    degrade_candidates,
    expand_candidates,
    plan_degrade,
    plan_expand,
    required_devices,
)
from mpi4dl_tpu_torch.resilience.supervisor import (
    FAILURE_CLASSES,
    POLICIES,
    Classification,
    LegOutcome,
    Policy,
    Supervisor,
    SupervisorResult,
    backoff_delay,
    classify_failure,
    crash_marker_path,
    quarantine_steps_from_env,
    read_crash_marker,
    subprocess_leg_launcher,
    supervise_knobs_from_env,
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
    "FAILURE_CLASSES",
    "FAULT_KINDS",
    "HANG_EXIT_CODE",
    "INFEASIBLE",
    "JOB_STATES",
    "POLICIES",
    "TERMINAL_STATES",
    "AnomalyError",
    "AnomalyGuard",
    "AsyncCheckpointWriter",
    "CheckpointWriteError",
    "Classification",
    "DrillVerdict",
    "FaultInjected",
    "FaultInjector",
    "FaultSpec",
    "FleetJob",
    "FleetResult",
    "FleetScenario",
    "FleetScheduler",
    "LegOutcome",
    "LoopResult",
    "MeshShrunk",
    "PackResult",
    "Plan",
    "Policy",
    "PreemptionHandler",
    "Request",
    "Scenario",
    "Slice",
    "StepWatchdog",
    "Supervisor",
    "SupervisorResult",
    "SupervisorScenario",
    "backoff_delay",
    "classify_failure",
    "compile_probe",
    "corrupt_file",
    "crash_marker_path",
    "default_scenarios",
    "degrade_candidates",
    "dump_stacks",
    "expand_candidates",
    "fault_from_env",
    "fleet_knobs_from_env",
    "fleet_pool",
    "fleet_scenarios",
    "global_norm",
    "lose_shard_files",
    "memory_report_lines",
    "pack",
    "parse_fault",
    "pending_bytes_budget",
    "plan_degrade",
    "plan_expand",
    "quarantine_steps_from_env",
    "read_crash_marker",
    "required_devices",
    "run_drills",
    "run_fleet_drills",
    "run_fleet_scenario",
    "run_scenario",
    "run_supervised",
    "run_supervisor_drills",
    "slice_env",
    "subprocess_leg_launcher",
    "supervise_knobs_from_env",
    "supervisor_scenarios",
    "synthetic_oom",
    "visible_cards",
    "watchdog_budget_from_env",
    "watchdog_compile_budget_from_env",
    "watchdog_escalation_from_env",
    "write_crash_marker",
]
