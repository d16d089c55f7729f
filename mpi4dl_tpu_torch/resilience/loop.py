"""The supervised training loop (counterpart of
``mpi4dl_tpu/resilience/loop.py``) — every runner family trains under it.

The loop wraps the runners' epoch loop with the resilience layer: anomaly
guard with checkpoint rollback, preemption-safe shutdown, background
checkpoint writes, deterministic fault injection, and the step watchdog.
The loop is engine-agnostic — lp / sp / gems / gems_sp all present the
same ``step(state, x, y) -> (state, metrics)`` contract (``x``, ``y`` the
host batch as the data pipeline yields it; the runner's step moves it to
the card), so one loop covers all four.

Step addressing is GLOBAL: ``gstep`` counts optimizer steps across epochs,
the dataset index is ``gstep % steps_per_epoch`` (each epoch replays the
same deterministic batch indices), and checkpoints are numbered by
completed-step count — so a resume at ``step_id`` continues the exact batch
sequence instead of restarting at 0.

Event records written to the RunLog:

- ``anomaly``  — guard tripped (non-finite loss / grad-norm breach)
- ``recovery`` — state rolled back; the poison batch is skipped
- ``preempt``  — SIGTERM/SIGINT honored: in-flight step finished, state
  saved, loop exited cleanly
- ``checkpoint`` — one completed save: copy/write ms, bytes, shard count,
  peak pending host bytes, the training thread's wait and the time until
  the checkpoint was durable
- ``quarantine`` — a step skipped by the poison-batch exclusion
  (``MPI4DL_QUARANTINE_STEPS``)

Supervision plumbing: when the ``MPI4DL_CRASH_MARKER`` hatch points at a
file, any exception escaping the loop first writes a structured crash
marker — the phase it died in (``compile`` covers the process's first
step), the global step, and the error.  The watchdog gives the first step
its compile-grace budget and, under ``MPI4DL_WATCHDOG_ESCALATE``, escalates
a persistent straggler into a typed ``hang`` exit instead of dumping
forever.

Ranks (``group``: a gloo process group over every rank of a ``torchrun``
job; None for one process).  Every rank must take the same decision after
every step, or the ranks part ways and hang in their next collective:

- The loss is all-reduced by every family's step (the same bits on every
  rank); the loop also agrees on non-finiteness with a MAX all-reduce
  after each step, so no rank rolls back alone.  Rollback restores are
  collective (``restore_latest`` over the manager's group): every rank
  makes them.
- A preemption signal reaches the ranks at different moments (or one rank
  alone), so the flag is agreed by the same MAX all-reduce after each step
  and by one after each fetch; every rank then stops at the same step,
  saves and returns.
- A checkpoint fault (``corrupt_ckpt``, ``lost_shard_files``) is applied
  by rank 0 alone: the ranks share one checkpoint directory.

Each all-reduce is one small tensor on the training thread (under a
millisecond on gloo against steps of hundreds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Optional

from mpi4dl_tpu_torch.checkpoint import CheckpointManager, arrays_to_state, state_to_arrays
from mpi4dl_tpu_torch.data import prefetch_batches
from mpi4dl_tpu_torch.resilience.faults import CKPT_FAULT_KINDS, FaultInjector
from mpi4dl_tpu_torch.resilience.guard import AnomalyError, AnomalyGuard
from mpi4dl_tpu_torch.resilience.preempt import PreemptionHandler
from mpi4dl_tpu_torch.resilience.supervisor import (
    crash_marker_path,
    quarantine_steps_from_env,
    write_crash_marker,
)
from mpi4dl_tpu_torch.resilience.watchdog import (
    HANG_EXIT_CODE,
    StepWatchdog,
    watchdog_compile_budget_from_env,
    watchdog_escalation_from_env,
)
from mpi4dl_tpu_torch.resilience.writer import AsyncCheckpointWriter
from mpi4dl_tpu_torch.utils.misc import Timer

_NULL_CTX = contextlib.nullcontext()


@dataclasses.dataclass
class LoopResult:
    state: Any
    metrics: Dict[str, float]  # last completed step's {loss, accuracy}
    steps_run: int  # steps completed by THIS process
    final_step: int  # global step count after the loop (resume point)
    preempted: bool
    anomalies: int


def run_supervised(
    step_fn: Callable,
    state: Any,
    dataset: Any,
    *,
    global_batch: int,
    steps_per_epoch: int,
    num_epochs: int = 1,
    num_workers: int = 0,
    start_step: int = 0,
    ckpt: Optional[CheckpointManager] = None,
    runlog=None,
    meter=None,
    print_fn: Optional[Callable[[str], None]] = None,
    profile: bool = False,
    guard: Optional[AnomalyGuard] = None,
    faults: Optional[FaultInjector] = None,
    watchdog_secs: float = 0.0,
    watchdog_compile_secs: Optional[float] = None,
    snapshot_rollback: bool = False,
    group=None,
    on_step: Optional[Callable[..., None]] = None,
    on_checkpoint: Optional[Callable[[Any], None]] = None,
) -> LoopResult:
    """Run ``steps_per_epoch * num_epochs`` supervised steps from
    ``start_step``; returns the final state plus what happened.

    Checkpoint cadence: a guard baseline before the first step when the
    directory is empty, every epoch boundary, and on preemption — all
    through the background writer.  Without ``ckpt``, the guard is
    DETECTION-ONLY: an anomaly raises :class:`AnomalyError` after logging
    (fail fast beats both silent NaN training and an implicit full-state
    host copy) —
    unless ``snapshot_rollback=True``, which opts into an in-memory host
    snapshot refreshed at the checkpoint cadence (costs a full extra copy
    of the training state in host RAM; fine for tests/small models, not
    for pathology-scale stage buffers).

    Additions of the port: ``group`` (module docstring, "Ranks");
    ``on_step(gstep=, loss=, ms=, fetch_ms=)`` after each completed step
    (``fetch_ms``: the loop's wait for that step's batch); and
    ``on_checkpoint(stats)`` after each durable save (on the writer's
    thread).
    """
    emit = print_fn if print_fn is not None else (lambda line: None)
    faults = faults if faults is not None else FaultInjector(None)
    timer = Timer()
    total = steps_per_epoch * num_epochs
    gstep = start_step
    metrics_out: Dict[str, float] = {}
    anomalies = 0
    preempted = False
    steps_run = 0
    # Supervision plumbing: where to leave structured last words,
    # which steps are quarantined, which phase the loop is in (the crash
    # marker's phase field — "compile" is the process's first step).
    marker_path = crash_marker_path()
    quarantine = quarantine_steps_from_env()
    phase = "init"
    lead = group is None or _group_rank(group) == 0

    def agree(*flags: bool):
        """Each flag true on ANY rank (a MAX all-reduce); alone, as is."""
        if group is None:
            return flags
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return tuple(bool(v) for v in t.tolist())

    # Flight recorder: the always-on in-memory forensic ring every run has
    # by default.  Dumps land next to the crash marker when one is set,
    # else next to the RunLog; no destination = ring only (the watchdog
    # still reads its tail).
    from mpi4dl_tpu_torch.obs.flight import (
        FLIGHT_BASENAME,
        FlightRecorder,
        default_flight_path,
    )

    fpath = default_flight_path()
    if fpath is None and runlog is not None and getattr(runlog, "path", None):
        fpath = os.path.join(
            os.path.dirname(os.path.abspath(runlog.path)), FLIGHT_BASENAME)
    flight = FlightRecorder.from_env(path=fpath)

    def _ckpt_record(stats) -> None:
        """Emit the ``checkpoint`` RunLog record (on the writer's worker
        thread — RunLog.write is locked)."""
        if runlog is not None and stats is not None:
            runlog.write("checkpoint", **stats.record())
        if flight is not None and stats is not None:
            flight.note("checkpoint", **stats.record())
        if on_checkpoint is not None and stats is not None:
            on_checkpoint(stats)

    writer = (
        AsyncCheckpointWriter(ckpt, on_saved=_ckpt_record)
        if ckpt is not None else None
    )

    def _save(st: Any, step_id: int) -> Optional[str]:
        nonlocal phase
        if ckpt is None:
            return None
        phase = "save"
        path = writer.save(st, step_id)
        if faults.spec is not None and faults.spec.kind in CKPT_FAULT_KINDS:
            writer.flush()  # the fault corrupts a file, not a queue entry
            faults.after_save(step_id, path if lead else None)
        return path

    # Rollback target: newest on-disk checkpoint, else (opt-in) an
    # in-memory host snapshot (host copies are mandatory either way —
    # donation invalidates the device buffers the moment the next step
    # runs).  No ckpt and no opt-in = detection-only guard.
    snapshot = None
    if guard is not None:
        if ckpt is not None:
            if ckpt.latest_path() is None:
                _save(state, gstep)
        elif snapshot_rollback:
            snapshot = (state_to_arrays(state, gstep), gstep)

    def _boundary_save(st: Any, step_id: int) -> None:
        """Epoch-boundary persistence — one policy for the normal path and
        the rollback-jumped-the-boundary path (incl. step_id == total: the
        final state must persist or a resume replays the tail forever)."""
        nonlocal snapshot
        if ckpt is not None:
            _save(st, step_id)
        elif snapshot is not None:
            snapshot = (state_to_arrays(st, step_id), step_id)

    from mpi4dl_tpu_torch.obs.scopes import step_annotation

    def _wd_context():
        """Stall-dump context: the last record of any kind PLUS the last
        ``checkpoint`` record, so a stall inside the shard-gather is
        distinguishable from a data stall — and the flight-recorder tail,
        the trajectory leading into the stall."""
        if runlog is None and flight is None:
            return None
        ctx = {
            "last": getattr(runlog, "last_record", None)
            if runlog is not None else None,
            "last_checkpoint": (getattr(runlog, "last_by_kind", {}).get(
                "checkpoint") if runlog is not None else None),
        }
        if flight is not None:
            ctx["flight_tail"] = flight.tail(5)
        return ctx

    def _escalate(label: str) -> None:
        """Watchdog escalation: the straggler never finished — leave a
        typed ``hang`` marker and exit the process so a supervisor can
        classify and relaunch.  ``os._exit`` is deliberate: the training
        thread is wedged inside the very call we are escalating out of."""
        if flight is not None:
            # `phase` says WHERE the run is wedged (fetch = data stall,
            # step = collective, save = checkpoint gather) — the evidence
            # a supervisor uses to split the hang classes.
            flight.dump("watchdog_escalation", phase=phase, gstep=gstep)
        if marker_path:
            write_crash_marker(
                marker_path, phase="step", gstep=gstep,
                steps_run=steps_run, failure_class="hang", label=label,
            )
        os._exit(HANG_EXIT_CODE)

    escalate_n = watchdog_escalation_from_env()
    watchdog = StepWatchdog(
        watchdog_secs,
        get_context=_wd_context,
        compile_budget_secs=watchdog_compile_budget_from_env(
            watchdog_compile_secs, watchdog_secs
        ),
        escalate_after=escalate_n,
        on_escalate=_escalate if escalate_n > 0 else None,
    )
    _on_signal = (
        (lambda signum: flight.note("preempt_signal", signum=signum,
                                    gstep=gstep))
        if flight is not None else None
    )
    preempt = PreemptionHandler(on_signal=_on_signal)

    def _preempt_exit(st: Any, step_id: int) -> None:
        saved = _save(st, step_id) is not None
        if writer is not None:
            writer.flush()  # "saved" must mean durable before exiting
        if runlog is not None:
            runlog.write("preempt", gstep=step_id, signum=preempt.signum,
                         saved=saved)
        if flight is not None:
            flight.note("preempt", gstep=step_id, signum=preempt.signum,
                        saved=saved)
            flight.dump("preemption", phase=phase, gstep=step_id)
        emit(
            (f"preemption signal {preempt.signum}" if preempt.signum is not None
             else "preemption signalled on another rank") + " — "
            + (f"checkpoint saved at step {step_id}"
               if saved else
               f"NO checkpoint dir configured, step-{step_id} progress is "
               "not resumable")
            + "; exiting cleanly"
        )

    try:
        with preempt, watchdog:
            while gstep < total and not preempted:
                # One contiguous segment of the batch stream; a rollback
                # closes it and reopens past the poison batch.
                segment = prefetch_batches(
                    dataset, global_batch, gstep, total,
                    index_of=lambda g: g % steps_per_epoch,
                    num_workers=num_workers, stall_hook=faults.stall_seconds,
                )
                rollback_to = None
                try:
                    while True:
                        # Arm BEFORE the fetch: a stalled producer is
                        # exactly the hang the watchdog exists for.  The
                        # process's first step pays one-time costs, so it
                        # gets the compile-grace budget instead of the step
                        # budget.
                        watchdog.arm(f"step {gstep}",
                                     compile=steps_run == 0)
                        phase = "fetch"
                        t_fetch = time.perf_counter()
                        try:
                            g, (x, y) = next(segment)
                        except StopIteration:
                            watchdog.disarm()
                            break
                        fetch_ms = (time.perf_counter() - t_fetch) * 1e3
                        # A signal that landed during the fetch must not pay
                        # for a whole extra step before being honored — the
                        # grace window may not cover it.  `gstep` steps are
                        # complete; the just-fetched batch is simply dropped.
                        if agree(preempt.requested)[0]:
                            watchdog.disarm()
                            _preempt_exit(state, gstep)
                            preempted = True
                            break
                        epoch, i = divmod(g, steps_per_epoch)
                        if g in quarantine:
                            # Supervisor poison-batch exclusion: a step the
                            # anomaly guard already fail-fasted on is
                            # skipped outright — same advance-past
                            # semantics as a rollback skip.
                            watchdog.disarm()
                            emit(f"step {g} quarantined "
                                 "(MPI4DL_QUARANTINE_STEPS); skipping")
                            if runlog is not None:
                                runlog.write("quarantine", gstep=g,
                                             epoch=epoch, step=i)
                            if flight is not None:
                                flight.note("quarantine", gstep=g,
                                            epoch=epoch, step=i)
                            gstep = g + 1
                            if gstep % steps_per_epoch == 0:
                                _boundary_save(state, gstep)
                            continue
                        phase = "compile" if steps_run == 0 else "step"
                        faults.before_step(g)
                        x = faults.poison_batch(g, x)
                        timer.start()
                        with step_annotation(g) if profile else _NULL_CTX:
                            state, metrics = step_fn(state, x, y)
                            loss = float(metrics["loss"])  # blocks on device
                        ms = timer.stop()
                        watchdog.disarm()
                        phase = "loop"
                        loss = faults.poison_loss(g, loss)
                        # One decision for every rank: a non-finite loss on
                        # any rank is an anomaly on all, and the preemption
                        # flag (honored below) is any rank's.
                        bad, stop = agree(not math.isfinite(loss),
                                          preempt.requested)
                        if bad and math.isfinite(loss):
                            loss = float("nan")

                        reason = (
                            guard.check(loss, metrics)
                            if guard is not None else None
                        )
                        if reason is not None:
                            anomalies += 1
                            if runlog is not None:
                                runlog.write(
                                    "anomaly", gstep=g, epoch=epoch, step=i,
                                    loss=loss, reason=reason,
                                )
                            if flight is not None:
                                flight.note("anomaly", gstep=g, epoch=epoch,
                                            step=i, loss=loss, reason=reason,
                                            guard=guard.snapshot()
                                            if guard is not None else None)
                                flight.dump("anomaly", phase="step", gstep=g)
                            emit(f"anomaly at step {g}: {reason}")
                            if ckpt is None and snapshot is None:
                                # detection-only: no rollback target exists
                                # (and silently continuing would train on a
                                # possibly-poisoned state)
                                raise AnomalyError(
                                    f"anomaly at step {g} ({reason}) with no "
                                    "rollback target — pass a checkpoint "
                                    "directory (or snapshot_rollback=True) "
                                    "to recover instead of failing fast"
                                )
                            guard.note_rollback()  # raises when exhausted
                            if ckpt is not None:
                                writer.flush()
                                # require=True: with every on-disk file
                                # invalid, handing back the live (possibly
                                # NaN-poisoned) template as a "recovery"
                                # would keep training on corrupt weights —
                                # fail loudly instead.
                                state, good = ckpt.restore_latest(
                                    state, require=True
                                )
                            else:
                                arrays, good = snapshot
                                state = arrays_to_state(arrays, state)
                            if runlog is not None:
                                runlog.write(
                                    "recovery", resumed_from=good,
                                    skipped_step=g, next_step=g + 1,
                                )
                            emit(
                                f"rolled back to step {good}; skipping "
                                f"poison batch {g}"
                            )
                            rollback_to = g + 1
                            break

                        measured = meter.add(ms) if meter is not None else True
                        acc = float(metrics.get("accuracy", math.nan))
                        metrics_out = {"loss": loss, "accuracy": acc}
                        emit(
                            f"epoch {epoch} step {i} time_ms {ms:.1f} "
                            f"images_per_sec {global_batch / (ms / 1e3):.3f} "
                            f"loss {loss:.4f} acc {acc:.4f}"
                        )
                        if runlog is not None:
                            runlog.write_step(
                                epoch=epoch, step=i, ms=ms,
                                images_per_sec=global_batch / (ms / 1e3),
                                loss=loss, accuracy=acc, step_fn=step_fn,
                                measured=measured, gstep=g,
                            )
                        if flight is not None:
                            flight.note_step(
                                gstep=g, phase=phase, step_fn=step_fn,
                                epoch=epoch, step=i, ms=round(ms, 3),
                                loss=loss,
                            )
                        if on_step is not None:
                            on_step(gstep=g, loss=loss, ms=ms,
                                    fetch_ms=fetch_ms)
                        gstep = g + 1
                        steps_run += 1

                        if stop:
                            _preempt_exit(state, gstep)
                            preempted = True
                            break
                        if gstep % steps_per_epoch == 0:
                            _boundary_save(state, gstep)
                finally:
                    segment.close()
                if rollback_to is not None:
                    gstep = rollback_to
                    # A skipped poison batch can jump PAST an epoch boundary
                    # (or land on the very last step): the boundary save
                    # must still happen, or the rollback target silently
                    # ages — and a final-step rollback would leave nothing
                    # newer than the baseline, so every resume re-trains the
                    # whole run just to re-skip the same poison batch.
                    if gstep % steps_per_epoch == 0:
                        _boundary_save(state, gstep)
            if writer is not None:
                # Every rank learns together whether the last saves are
                # durable (close() alone would fail only the rank whose
                # worker failed).
                writer.flush()
    except BaseException as e:
        # The run's structured last words: phase + step + error, written
        # BEFORE the exception propagates so a supervisor can classify this
        # death even if the interpreter never unwinds further.
        # write_crash_marker itself never raises.
        if flight is not None:
            flight.note("crash", error_type=type(e).__name__,
                        error=str(e)[:500], phase=phase, gstep=gstep)
            flight.dump("crash", phase=phase, gstep=gstep)
        if marker_path:
            extra = {}
            spec = getattr(e, "spec", None)
            if isinstance(spec, str) and spec:
                extra["shrunk_spec"] = spec  # MeshShrunk carries it
            write_crash_marker(
                marker_path, phase=phase, gstep=gstep,
                steps_run=steps_run, error=e, **extra,
            )
        raise
    finally:
        if writer is not None:
            writer.close()

    return LoopResult(
        state=state, metrics=metrics_out, steps_run=steps_run,
        final_step=gstep, preempted=preempted, anomalies=anomalies,
    )


def _group_rank(group) -> int:
    import torch.distributed as dist

    return dist.get_rank(group)
