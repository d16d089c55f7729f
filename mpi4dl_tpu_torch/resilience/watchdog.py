"""Step watchdog (counterpart of ``mpi4dl_tpu/resilience/watchdog.py``):
evidence before the silent death.

A wedged collective, a stuck data producer, or a host-side deadlock makes a
training job hang until the scheduler kills it — with nothing on stderr to
debug from.  The watchdog is a monitor thread the supervised loop arms at
the start of each step (covering the batch fetch AND the device step) and
disarms after; if the armed deadline passes, it dumps every live Python
thread's stack, the last RunLog record (including the last ``checkpoint``
record when the loop provides it), and live host and CUDA memory stats to
stderr, once per armed step, and keeps monitoring.  The memory lines plus
the checkpoint record make a stall inside the shard-gather (host RSS
climbing, a ``checkpoint`` record with no successor step) distinguishable
from a data stall.  It never kills the job — it makes the eventual death
diagnosable.

Budget resolution: the ``--watchdog-secs`` flag, else the
``MPI4DL_WATCHDOG_SECS`` hatch, else 0 (off).

Two refinements:

- **Compile grace** — the first step of a process pays one-time costs
  (kernel builds, allocator growth, library autotuning), so one flat
  budget realistic for steady-state steps would false-trigger a stall dump
  on it.  A separate first-step budget (``--watchdog-compile-secs`` /
  ``MPI4DL_WATCHDOG_COMPILE_SECS``, default 10× the step budget) applies
  while ``arm(..., compile=True)`` — the supervised loop passes that until
  its first step completes.
- **Escalation** — a straggler that never finishes must eventually become a
  typed failure, not an endless stream of identical dumps.  With
  ``escalate_after=N`` (``MPI4DL_WATCHDOG_ESCALATE``, 0 = off) the armed
  deadline re-arms after each dump and the N-th consecutive dump of ONE
  armed step calls ``on_escalate(label)`` — the loop then writes a ``hang``
  crash marker and exits the process with :data:`HANG_EXIT_CODE`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

# Exit status of a leg the watchdog escalated out of — the supervisor's
# secondary `hang` evidence when the crash marker is unwritable.
HANG_EXIT_CODE = 82


def watchdog_budget_from_env(flag_value: Optional[float] = None) -> float:
    """Resolve the step budget: explicit flag wins, then the hatch, then 0."""
    if flag_value is not None:
        return float(flag_value)
    return float(os.environ.get("MPI4DL_WATCHDOG_SECS", "0") or 0.0)


def watchdog_compile_budget_from_env(
    flag_value: Optional[float] = None, step_budget: float = 0.0
) -> float:
    """Resolve the first-step/compile budget: explicit flag wins, then the
    ``MPI4DL_WATCHDOG_COMPILE_SECS`` hatch, then 10× the step budget (a
    first-step:step ratio for the engine families)."""
    if flag_value is not None:
        return float(flag_value)
    env = float(os.environ.get("MPI4DL_WATCHDOG_COMPILE_SECS", "0") or 0.0)
    if env > 0:
        return env
    return 10.0 * float(step_budget)


def watchdog_escalation_from_env(flag_value: Optional[int] = None) -> int:
    """Resolve the escalation dump count (0 = dump forever, never escalate):
    explicit value wins, then the ``MPI4DL_WATCHDOG_ESCALATE`` hatch."""
    if flag_value is not None:
        return int(flag_value)
    return int(os.environ.get("MPI4DL_WATCHDOG_ESCALATE", "0") or 0)


def _cuda_device():
    """The calling thread's CUDA device index, where CUDA is in use (the
    current device is per thread, so the watchdog records the training
    thread's when it is built); None otherwise.  Never initializes CUDA."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda.current_device()
    except Exception:  # noqa: BLE001  # analysis: ok(swallow-except) — diagnostics
        # must not raise
        pass
    return None


def memory_report_lines(device=None) -> list:
    """Live memory evidence for the stall dump: host RSS peak plus the CUDA
    caching allocator's stats (``torch.cuda.memory_stats``) and the card's
    free and total bytes (``torch.cuda.mem_get_info``) for ``device``, the
    rank's card (CPU runs have no allocator stats — the host line still
    lands).  Never raises."""
    lines = []
    try:
        from mpi4dl_tpu_torch.obs.runlog import host_rss_peak_bytes

        rss = host_rss_peak_bytes()
        if rss is not None:
            lines.append(f"host rss peak: {rss / 2**30:.2f} GiB")
    except Exception as e:  # noqa: BLE001 — diagnostics must not raise
        lines.append(f"host rss unavailable: {e!r}")
    try:
        import torch

        if device is None:
            lines.append(
                "device allocator stats: none reported (CPU backend)"
            )
        else:
            stats = torch.cuda.memory_stats(device)
            free, total = torch.cuda.mem_get_info(device)
            lines.append(
                f"device cuda:{device} ({torch.cuda.get_device_name(device)}): "
                f"in_use={stats.get('allocated_bytes.all.current')} "
                f"peak={stats.get('allocated_bytes.all.peak')} "
                f"reserved={stats.get('reserved_bytes.all.current')} "
                f"free={free} limit={total}"
            )
    except Exception as e:  # noqa: BLE001 — diagnostics must not raise
        lines.append(f"device memory stats unavailable: {e!r}")
    return lines


def dump_stacks(out) -> None:
    """Write every live Python thread's stack to ``out`` (named by thread)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        out.write(f"--- thread {names.get(ident, '?')} (ident {ident}) ---\n")
        out.write("".join(traceback.format_stack(frame)))


class StepWatchdog:
    """Monitor thread firing a stderr diagnostic when an armed step exceeds
    ``budget_secs``.  ``budget_secs <= 0`` disables everything (``start``
    spawns no thread; ``arm``/``disarm`` are no-ops).

    ``compile_budget_secs`` (default: 10× ``budget_secs``) replaces the
    budget for steps armed with ``compile=True`` — the first-step/compile
    grace.  ``escalate_after=N`` (default 0 = off) re-arms after each dump
    and calls ``on_escalate(label)`` once one armed step has dumped N
    times — the hang path's exit from dump-forever."""

    def __init__(self, budget_secs: float,
                 get_context: Optional[Callable[[], object]] = None,
                 out=None,
                 compile_budget_secs: Optional[float] = None,
                 escalate_after: int = 0,
                 on_escalate: Optional[Callable[[str], None]] = None):
        self.budget = float(budget_secs)
        self.compile_budget = (
            float(compile_budget_secs) if compile_budget_secs is not None
            else 10.0 * self.budget
        )
        self.escalate_after = int(escalate_after)
        self.on_escalate = on_escalate
        self.get_context = get_context
        self.out = out  # None = sys.stderr at fire time (test-friendly)
        self.device = _cuda_device()  # the building (training) thread's card
        self.fired = 0
        self.escalated = False
        self._deadline: Optional[float] = None
        self._armed_budget = self.budget
        self._dumps_this_arm = 0
        self._label = ""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StepWatchdog":
        if self.budget > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._monitor, name="mpi4dl-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- arming ------------------------------------------------------------

    def arm(self, label: str = "", compile: bool = False) -> None:
        """Arm for one step.  ``compile=True`` applies the compile-grace
        budget instead of the step budget (the loop passes it for the
        process's first step — the one that pays the one-time costs)."""
        if self.budget <= 0:
            return
        with self._lock:
            self._label = label
            self._armed_budget = (
                self.compile_budget if compile and self.compile_budget > 0
                else self.budget
            )
            self._dumps_this_arm = 0
            self._deadline = time.monotonic() + self._armed_budget

    def disarm(self) -> None:
        if self.budget <= 0:
            return
        with self._lock:
            self._deadline = None

    # -- monitor -----------------------------------------------------------

    def _monitor(self) -> None:
        poll = max(min(self.budget / 4.0, 0.25), 0.01)
        while not self._stop.wait(poll):
            with self._lock:
                deadline, label = self._deadline, self._label
                armed_budget = self._armed_budget
            if deadline is not None and time.monotonic() > deadline:
                self._dump(label, armed_budget)
                escalate = False
                with self._lock:
                    if self._deadline == deadline:
                        self._dumps_this_arm += 1
                        if (self.escalate_after > 0
                                and self._dumps_this_arm
                                >= self.escalate_after):
                            # N dumps of ONE armed step: the straggler is a
                            # hang, not a blip — hand it to on_escalate.
                            escalate = True
                            self._deadline = None
                        elif self.escalate_after > 0:
                            # keep watching the SAME armed step
                            self._deadline = (
                                time.monotonic() + self._armed_budget
                            )
                        else:
                            # fire once per armed step; a re-arm resets
                            self._deadline = None
                if escalate and self.on_escalate is not None:
                    self.escalated = True
                    self.on_escalate(label)

    def _dump(self, label: str, budget: Optional[float] = None) -> None:
        self.fired += 1
        out = self.out if self.out is not None else sys.stderr
        out.write(
            f"\n=== mpi4dl_tpu_torch watchdog: {label or 'step'} exceeded the "
            f"{budget if budget is not None else self.budget:.1f}s "
            "wall-clock budget ===\n"
        )
        if self.get_context is not None:
            try:
                ctx = self.get_context()
            except Exception as e:
                ctx = f"<context unavailable: {e!r}>"
            # The loop passes {"last": <record>, "last_checkpoint":
            # <record>} so a stalled shard-gather is identifiable by its
            # checkpoint record; plain records render on one line.
            if isinstance(ctx, dict) and "last" in ctx:
                for key, rec in ctx.items():
                    if rec is None:
                        continue
                    if key == "flight_tail" and isinstance(rec, list):
                        # The flight recorder's last ring entries — the
                        # trajectory INTO the stall, one JSON line each.
                        out.write(
                            f"flight tail ({len(rec)} ring entries, "
                            "oldest first):\n")
                        for entry in rec:
                            out.write(f"  flight: {json.dumps(entry)}\n")
                        continue
                    out.write(f"{key} runlog record: {json.dumps(rec)}\n")
            elif ctx is not None:
                rendered = (
                    json.dumps(ctx) if isinstance(ctx, dict) else str(ctx)
                )
                out.write(f"last runlog record: {rendered}\n")
        # Stacks FIRST: memory_report_lines queries the CUDA runtime, and
        # a wedged runtime is exactly what may have tripped the watchdog —
        # the primary diagnostic must already be on stderr if that call
        # never returns.
        dump_stacks(out)
        out.flush()
        for line in memory_report_lines(self.device):
            out.write(f"memory: {line}\n")
        out.flush()
