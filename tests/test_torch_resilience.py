"""The resilience layer of the PyTorch port (mpi4dl_tpu_torch/resilience,
obs/runlog.py, obs/flight.py) against the JAX package's
(mpi4dl_tpu/resilience, tests/test_resilience.py).

The JAX tests' cases that need no JAX engine, on a torch toy step (the
same ``_ToyDataset``; ``w ← w − 0.05·∇mean((xw−y)²)`` in float32): the
loop, epoch checkpoints, fallbacks past corrupt / torn / shard-less
checkpoints, kill and resume bitwise, one rollback per NaN kind, snapshot
rollback, fail-fast, rollbacks on the final step and across an epoch
boundary, preemption during a fetch, the guard, the watchdog (budgets of
at most 0.5 s), escalation to a typed ``hang`` crash marker, the
background writer (equal to the synchronous save, latched errors, the
memory bound), the ``checkpoint`` record, fault parsing and single-shot
injectors.

Parity: ``mpi4dl_tpu.resilience.run_supervised`` on the JAX toy step and
the port's loop on the torch toy step, under the same ``FaultSpec`` (and a
resume where the fault stops the run): the RunLog record kinds in order
with their step fields (``checkpoint`` records, which the background
writers emit from their own threads, compared as their own ordered
stream), the ``LoopResult`` fields, and the checkpoint step ids on disk
are equal; ``w`` within 1e-6 relative.  Checkpoints written by either
package's background writer restore in the other, every leaf equal, and
the JAX ``read_runlog`` parses the port's RunLog.  JAX is imported inside
the parity tests only.
"""

from __future__ import annotations

import io
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.checkpoint import (
    CheckpointInvalid, CheckpointManager, cheap_validate, load_arrays,
)
from mpi4dl_tpu_torch.data import prefetch_batches
from mpi4dl_tpu_torch.obs import RunLog, read_flight, read_runlog
from mpi4dl_tpu_torch.resilience import (
    CKPT_FAULT_KINDS,
    FAULT_KINDS,
    HANG_EXIT_CODE,
    AnomalyError,
    AnomalyGuard,
    AsyncCheckpointWriter,
    CheckpointWriteError,
    FaultInjected,
    FaultInjector,
    FaultSpec,
    MeshShrunk,
    PreemptionHandler,
    StepWatchdog,
    corrupt_file,
    global_norm,
    lose_shard_files,
    parse_fault,
    read_crash_marker,
    run_supervised,
)


# ---------------------------------------------------------------------------
# Toy harness (tests/test_resilience.py's, with a torch step).
# ---------------------------------------------------------------------------


class _ToyDataset:
    """Deterministic per-index regression batches (x @ [1,2,3,4])."""

    def batch(self, idx, batch_size):
        rng = np.random.default_rng(1000 + idx)
        x = rng.standard_normal((batch_size, 4)).astype(np.float32)
        y = (x @ np.array([1.0, 2.0, 3.0, 4.0], np.float32)).astype(np.float32)
        return x, y


def _toy_step():
    def step(state, x, y):
        x = torch.as_tensor(np.asarray(x))
        y = torch.as_tensor(np.asarray(y))
        w = state["w"].detach().requires_grad_(True)
        loss = torch.mean((x @ w - y) ** 2)
        (grad,) = torch.autograd.grad(loss, w)
        return ({"w": (w - 0.05 * grad).detach()},
                {"loss": loss.detach(), "accuracy": torch.tensor(0.0)})

    return step


def _toy_state():
    return {"w": torch.zeros(4, dtype=torch.float32)}


def _run_toy(tmp_path, *, steps=4, epochs=1, start=0, ckpt_dir=None,
             faults=None, guard=None, runlog=None, watchdog_secs=0.0,
             num_workers=0, state=None, snapshot_rollback=False, step=None):
    ckpt = CheckpointManager(str(ckpt_dir)) if ckpt_dir is not None else None
    if ckpt is not None and start == 0 and ckpt.latest_path() is not None:
        st, start = ckpt.restore_latest(state or _toy_state())
    else:
        st = state or _toy_state()
    return run_supervised(
        step or _toy_step(), st, _ToyDataset(),
        global_batch=8, steps_per_epoch=steps, num_epochs=epochs,
        num_workers=num_workers, start_step=start, ckpt=ckpt,
        runlog=runlog, guard=guard, faults=faults,
        watchdog_secs=watchdog_secs, snapshot_rollback=snapshot_rollback,
    )


# ---------------------------------------------------------------------------
# Loop basics and checkpoint fallbacks
# ---------------------------------------------------------------------------


def test_supervised_loop_completes(tmp_path):
    res = _run_toy(tmp_path, steps=4)
    assert res.steps_run == 4 and res.final_step == 4
    assert not res.preempted and res.anomalies == 0
    assert np.isfinite(res.metrics["loss"])


def test_supervised_loop_epoch_checkpoints(tmp_path):
    ckpt_dir = tmp_path / "ck"
    _run_toy(tmp_path, steps=2, epochs=2, ckpt_dir=ckpt_dir, guard=AnomalyGuard())
    mgr = CheckpointManager(str(ckpt_dir))
    # guard baseline at 0, epoch boundaries at 2 and 4 (keep=3)
    assert mgr.latest_path().endswith("ckpt_4")
    _, step_id = mgr.restore_latest(_toy_state())
    assert step_id == 4


def _truncate_a_shard(path):
    shard = next(os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(".bin"))
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 3)


@pytest.mark.parametrize("damage", ["corrupt", "torn", "lost_shards"])
def test_damaged_newest_checkpoint_falls_back(tmp_path, damage):
    """A flipped byte (the CRC pass), a truncated shard file and vanished
    shard files (the cheap stat pass) are each walked past to the older
    valid checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save({"a": torch.full((4,), 1.0), "b": torch.full((4,), 1.0)}, step_id=1)
    path2 = mgr.save({"a": torch.full((4,), 2.0), "b": torch.full((4,), 2.0)}, step_id=2)
    {"corrupt": corrupt_file, "torn": _truncate_a_shard,
     "lost_shards": lose_shard_files}[damage](path2)
    state, step_id = mgr.restore_latest({"a": torch.zeros(4), "b": torch.zeros(4)})
    assert step_id == 1
    assert torch.equal(state["a"], torch.full((4,), 1.0))


def test_torn_npz_checkpoint_falls_back(tmp_path):
    v1 = CheckpointManager(str(tmp_path), format="npz")
    v1.save({"w": torch.full((4,), 1.0)}, step_id=1)
    p2 = v1.save({"w": torch.full((4,), 2.0)}, step_id=2)
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) // 3)
    _, step_id = v1.restore_latest(_toy_state())
    assert step_id == 1


def test_lose_shard_files_keeps_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save({"a": torch.ones(4), "b": torch.ones(4)}, 1)
    lose_shard_files(path)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    with pytest.raises(CheckpointInvalid, match="missing"):
        cheap_validate(path)


# ---------------------------------------------------------------------------
# Kill and resume, rollbacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sigterm", "reshape"])
def test_kill_and_resume_bit_identical_toy(tmp_path, kind):
    """SIGTERM before step 2 (``reshape`` is a preemption in the loop):
    the step finishes, ``ckpt_3`` is saved, the loop returns; the resume
    ends bitwise where the uninterrupted run does."""
    control = _run_toy(tmp_path, steps=4)
    ckpt_dir = tmp_path / "ck"
    killed = _run_toy(tmp_path, steps=4, ckpt_dir=ckpt_dir,
                      faults=FaultInjector(FaultSpec(kind, 2, opts="parts=2")))
    assert killed.preempted and killed.final_step == 3
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_3"]  # no guard: no baseline
    resumed = _run_toy(tmp_path, steps=4, ckpt_dir=ckpt_dir)
    assert resumed.final_step == 4 and not resumed.preempted
    assert resumed.metrics["loss"] == control.metrics["loss"]
    assert torch.equal(resumed.state["w"], control.state["w"])


@pytest.mark.parametrize("kind", ["nan_loss", "nan_batch"])
def test_nan_injection_one_rollback(tmp_path, kind):
    runlog = RunLog(str(tmp_path / "tele" / "run.jsonl"))
    res = _run_toy(tmp_path, steps=4, ckpt_dir=tmp_path / "ck",
                   faults=FaultInjector(FaultSpec(kind, 2)),
                   guard=AnomalyGuard(), runlog=runlog)
    runlog.close()
    assert res.anomalies == 1 and res.final_step == 4
    assert np.isfinite(res.metrics["loss"])
    assert torch.isfinite(res.state["w"]).all()
    recs = read_runlog(runlog.path)
    anomalies = [r for r in recs if r["kind"] == "anomaly"]
    recoveries = [r for r in recs if r["kind"] == "recovery"]
    assert len(anomalies) == 1 and anomalies[0]["gstep"] == 2
    assert len(recoveries) == 1
    assert recoveries[0]["skipped_step"] == 2 and recoveries[0]["resumed_from"] == 0
    assert [r["gstep"] for r in recs if r["kind"] == "step"] == [0, 1, 3]
    # The flight recorder dumped its ring next to the RunLog.
    flight = read_flight(str(tmp_path / "tele" / "flight.json"))
    assert flight["reason"] == "anomaly" and flight["gstep"] == 2


def test_nan_rollback_with_snapshot_opt_in(tmp_path):
    res = _run_toy(tmp_path, steps=4, snapshot_rollback=True,
                   faults=FaultInjector(FaultSpec("nan_loss", 1)), guard=AnomalyGuard())
    assert res.anomalies == 1 and res.final_step == 4
    assert np.isfinite(res.metrics["loss"])


def test_nan_without_rollback_target_fails_fast(tmp_path):
    with pytest.raises(AnomalyError):
        _run_toy(tmp_path, steps=4, faults=FaultInjector(FaultSpec("nan_loss", 1)),
                 guard=AnomalyGuard())


def test_rollback_on_final_step_persists_progress(tmp_path):
    ckpt_dir = tmp_path / "ck"
    res = _run_toy(tmp_path, steps=4, ckpt_dir=ckpt_dir,
                   faults=FaultInjector(FaultSpec("nan_loss", 3)), guard=AnomalyGuard())
    assert res.anomalies == 1 and res.final_step == 4
    _, step_id = CheckpointManager(str(ckpt_dir)).restore_latest(_toy_state())
    assert step_id == 4  # not the step-0 baseline


def test_rollback_across_epoch_boundary_still_checkpoints(tmp_path):
    ckpt_dir = tmp_path / "ck"
    res = _run_toy(tmp_path, steps=2, epochs=2, ckpt_dir=ckpt_dir,
                   faults=FaultInjector(FaultSpec("nan_loss", 1)), guard=AnomalyGuard())
    assert res.anomalies == 1 and res.final_step == 4
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_0", "ckpt_2", "ckpt_4"]


class _SigtermOnFetch:
    """Delivers SIGTERM during the fetch of one index."""

    def __init__(self, at_idx):
        self.at_idx = at_idx
        self.inner = _ToyDataset()

    def batch(self, idx, batch_size):
        if idx == self.at_idx:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner.batch(idx, batch_size)


def test_preemption_during_fetch_exits_without_extra_step(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    res = run_supervised(_toy_step(), _toy_state(), _SigtermOnFetch(2),
                         global_batch=8, steps_per_epoch=4, num_epochs=1, ckpt=ckpt)
    assert res.preempted
    assert res.steps_run == 2 and res.final_step == 2  # step 2 never ran
    _, step_id = ckpt.restore_latest(_toy_state())
    assert step_id == 2


def test_rollback_with_all_checkpoints_invalid_fails_loudly(tmp_path):
    ckpt_dir = tmp_path / "ck"
    corrupt_file(CheckpointManager(str(ckpt_dir)).save(_toy_state(), step_id=0))
    with pytest.raises(CheckpointInvalid):
        _run_toy(tmp_path, steps=4, ckpt_dir=ckpt_dir,
                 faults=FaultInjector(FaultSpec("nan_batch", 1)), guard=AnomalyGuard())


def test_quarantined_step_is_skipped(tmp_path, monkeypatch):
    monkeypatch.setenv("MPI4DL_QUARANTINE_STEPS", "1, 2")
    runlog = RunLog(str(tmp_path / "run.jsonl"))
    res = _run_toy(tmp_path, steps=4, runlog=runlog)
    runlog.close()
    assert res.final_step == 4 and res.steps_run == 2
    recs = read_runlog(runlog.path)
    assert [r["gstep"] for r in recs if r["kind"] == "quarantine"] == [1, 2]


def test_crash_marker_names_the_phase_per_rank(tmp_path, monkeypatch):
    """An injected crash leaves the marker with its phase and step; rank r
    > 0 writes ``<path>.rank<r>``."""
    from mpi4dl_tpu_torch.resilience.supervisor import crash_marker_path

    marker = str(tmp_path / "m.json")
    monkeypatch.setenv("MPI4DL_CRASH_MARKER", marker)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(FaultInjected):
        _run_toy(tmp_path, steps=4, faults=FaultInjector(FaultSpec("raise", 2)))
    m = read_crash_marker(marker)
    assert m["phase"] == "step" and m["gstep"] == 2 and m["steps_run"] == 2
    assert m["error_type"] == "FaultInjected" and "RuntimeError" in m["error_bases"]
    monkeypatch.setenv("RANK", "3")
    assert crash_marker_path() == marker + ".rank3"
    with pytest.raises(MeshShrunk):
        _run_toy(tmp_path, steps=4,
                 faults=FaultInjector(FaultSpec("mesh_shrunk", 0, opts="devices=4")))
    m = read_crash_marker(marker + ".rank3")
    assert m["phase"] == "compile" and m["shrunk_spec"] == "devices=4"


# ---------------------------------------------------------------------------
# Guard
# ---------------------------------------------------------------------------


def test_persistent_anomalies_fail_fast():
    guard = AnomalyGuard(max_rollbacks=2)
    guard.note_rollback()
    guard.note_rollback()
    with pytest.raises(AnomalyError):
        guard.note_rollback()


def test_guard_grad_norm_limit():
    g = AnomalyGuard(grad_norm_limit=10.0)
    assert g.check(1.0, {"grad_norm": 5.0}) is None
    assert g.check(1.0, {"grad_norm": torch.tensor(50.0)}) is not None
    assert g.check(1.0, {}) is None  # opt-in: no metric, no check
    assert g.check(float("inf")) is not None
    assert AnomalyGuard().check(1.0, {"grad_norm": 1e30}) is None  # limit off
    norm = global_norm({"b": [torch.full((2,), 3.0)], "a": torch.tensor([4.0, 0.0])})
    assert float(norm) == pytest.approx(np.sqrt(9 + 9 + 16))


def test_guard_hatches(monkeypatch):
    monkeypatch.setenv("MPI4DL_NO_GUARD", "1")
    assert AnomalyGuard.from_env() is None
    monkeypatch.delenv("MPI4DL_NO_GUARD")
    monkeypatch.setenv("MPI4DL_GUARD_GRAD_NORM", "7.5")
    assert AnomalyGuard.from_env().grad_norm_limit == 7.5


def test_guard_rollback_decay_forgives_spaced_anomalies():
    g = AnomalyGuard(max_rollbacks=2, rollback_decay_steps=3)
    for _round in range(6):
        assert g.check(float("nan")) is not None
        g.note_rollback()  # never raises: decay keeps the count low
        for _ in range(3):
            assert g.check(1.0) is None
    assert g.rollbacks <= 2


def test_guard_clustered_anomalies_still_fail_fast():
    g = AnomalyGuard(max_rollbacks=2, rollback_decay_steps=3)
    g.note_rollback()
    assert g.check(1.0) is None
    g.note_rollback()
    with pytest.raises(AnomalyError):
        g.note_rollback()


def test_guard_decay_disabled_keeps_lifetime_counter():
    g = AnomalyGuard(max_rollbacks=1, rollback_decay_steps=0)
    g.note_rollback()
    for _ in range(100):
        g.check(1.0)
    with pytest.raises(AnomalyError):
        g.note_rollback()


def test_guard_anomaly_resets_good_streak():
    g = AnomalyGuard(max_rollbacks=1, rollback_decay_steps=4)
    g.note_rollback()
    g.check(1.0)
    g.check(1.0)
    g.check(float("nan"))
    g.check(1.0)
    g.check(1.0)
    assert g.rollbacks == 1


# ---------------------------------------------------------------------------
# Preemption handler
# ---------------------------------------------------------------------------


def test_preemption_handler_latches_and_restores_handlers():
    seen = []
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler(on_signal=seen.append) as h:
        assert h.active and signal.getsignal(signal.SIGTERM) == h._handle
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert h.requested and h.signum == signal.SIGTERM and seen == [signal.SIGTERM]
    assert signal.getsignal(signal.SIGTERM) == before and not h.active


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------


def test_watchdog_fires_on_stalled_step(tmp_path, capfd):
    """stall_data@2:0.5 + a 0.15 s budget: the producer stall is covered
    (the loop arms before the fetch) and the dump lands on stderr, with the
    memory lines, while the run completes."""
    res = _run_toy(tmp_path, steps=4, num_workers=1,
                   faults=FaultInjector(FaultSpec("stall_data", 2, 0.5)),
                   watchdog_secs=0.15)
    assert res.final_step == 4
    err = capfd.readouterr().err
    assert "watchdog: step 2 exceeded" in err
    assert "--- thread" in err
    assert "memory: host rss peak" in err
    assert "memory: device allocator stats: none reported (CPU backend)" in err


def test_watchdog_unit_fire_once_and_context():
    out = io.StringIO()
    wd = StepWatchdog(0.05, get_context=lambda: {"kind": "step", "gstep": 9}, out=out)
    with wd:
        wd.arm("step 9")
        time.sleep(0.4)
        assert wd.fired == 1  # once per armed step, not per poll
        wd.disarm()
    text = out.getvalue()
    assert "step 9 exceeded" in text
    assert json.dumps({"kind": "step", "gstep": 9}) in text
    assert "MainThread" in text


def test_watchdog_disarmed_never_fires():
    out = io.StringIO()
    with StepWatchdog(0.05, out=out) as wd:
        wd.arm("fast step")
        wd.disarm()
        time.sleep(0.2)
    assert wd.fired == 0 and out.getvalue() == ""


def test_watchdog_compile_grace_covers_the_first_step():
    out = io.StringIO()
    wd = StepWatchdog(0.05, compile_budget_secs=5.0, out=out)
    with wd:
        wd.arm("step 0", compile=True)
        time.sleep(0.25)
        wd.disarm()
        assert wd.fired == 0
        wd.arm("step 1")
        time.sleep(0.25)
        wd.disarm()
    assert wd.fired == 1
    assert "step 0 exceeded" not in out.getvalue()
    assert "step 1 exceeded the 0.1s" in out.getvalue()


def test_watchdog_compile_budget_still_fires_when_exceeded():
    out = io.StringIO()
    wd = StepWatchdog(0.02, compile_budget_secs=0.1, out=out)
    with wd:
        wd.arm("step 0", compile=True)
        time.sleep(0.05)
        assert wd.fired == 0
        time.sleep(0.3)
        wd.disarm()
    assert wd.fired >= 1


def test_watchdog_budget_resolution(monkeypatch):
    from mpi4dl_tpu_torch.resilience import (
        watchdog_budget_from_env,
        watchdog_compile_budget_from_env,
        watchdog_escalation_from_env,
    )

    monkeypatch.delenv("MPI4DL_WATCHDOG_SECS", raising=False)
    assert watchdog_budget_from_env() == 0.0
    monkeypatch.setenv("MPI4DL_WATCHDOG_SECS", "0.5")
    assert watchdog_budget_from_env() == 0.5 and watchdog_budget_from_env(2) == 2.0
    monkeypatch.delenv("MPI4DL_WATCHDOG_COMPILE_SECS", raising=False)
    assert watchdog_compile_budget_from_env(None, 2.0) == 20.0
    monkeypatch.setenv("MPI4DL_WATCHDOG_COMPILE_SECS", "7")
    assert watchdog_compile_budget_from_env(None, 2.0) == 7.0
    assert watchdog_compile_budget_from_env(3.0, 2.0) == 3.0
    monkeypatch.delenv("MPI4DL_WATCHDOG_ESCALATE", raising=False)
    assert watchdog_escalation_from_env() == 0
    monkeypatch.setenv("MPI4DL_WATCHDOG_ESCALATE", "3")
    assert watchdog_escalation_from_env() == 3 and watchdog_escalation_from_env(1) == 1


def test_loop_compile_grace_both_phases(capfd):
    tstep = _toy_step()
    calls = {"n": 0}

    def step(state, x, y):
        n = calls["n"]
        calls["n"] += 1
        if n in (0, 2):
            time.sleep(0.35)
        return tstep(state, x, y)

    res = run_supervised(step, _toy_state(), _ToyDataset(), global_batch=8,
                         steps_per_epoch=4, num_epochs=1, watchdog_secs=0.12,
                         watchdog_compile_secs=3.0)
    assert res.final_step == 4
    err = capfd.readouterr().err
    assert "step 0 exceeded" not in err
    assert "step 2 exceeded" in err


def test_watchdog_escalates_after_n_dumps():
    escalated = []
    wd = StepWatchdog(0.03, escalate_after=2, on_escalate=escalated.append,
                      out=io.StringIO())
    with wd:
        wd.arm("step 3")
        deadline = time.monotonic() + 3.0
        while not escalated and time.monotonic() < deadline:
            time.sleep(0.01)
        wd.disarm()
    assert escalated == ["step 3"] and wd.escalated and wd.fired >= 2
    wd2 = StepWatchdog(0.05, escalate_after=3, on_escalate=escalated.append,
                       out=io.StringIO())
    with wd2:
        for i in range(3):
            wd2.arm(f"step {i}")
            time.sleep(0.12)
            wd2.disarm()
    assert not wd2.escalated


def test_slow_step_fault_escalates_to_typed_hang_marker(tmp_path, monkeypatch, capfd):
    marker = str(tmp_path / "m.json")
    monkeypatch.setenv("MPI4DL_CRASH_MARKER", marker)
    monkeypatch.setenv("MPI4DL_WATCHDOG_ESCALATE", "2")
    monkeypatch.setenv("RANK", "0")
    exited = []
    monkeypatch.setattr("mpi4dl_tpu_torch.resilience.loop.os._exit",
                        lambda code: exited.append(code))
    _run_toy(tmp_path, steps=4, faults=FaultInjector(FaultSpec("slow_step", 2, 0.5)),
             watchdog_secs=0.1)
    assert exited and exited[0] == HANG_EXIT_CODE == 82
    m = read_crash_marker(marker)
    assert m is not None and m["failure_class"] == "hang" and m["gstep"] == 2
    flight = read_flight(str(tmp_path / "flight.json"))
    assert flight["reason"] == "watchdog_escalation"


def test_watchdog_dump_memory_and_checkpoint_record():
    out = io.StringIO()
    ctx = {"last": {"kind": "step", "gstep": 9},
           "last_checkpoint": {"kind": "checkpoint", "gstep": 8, "bytes": 123}}
    wd = StepWatchdog(0.05, get_context=lambda: ctx, out=out)
    with wd:
        wd.arm("step 9")
        time.sleep(0.4)
        wd.disarm()
    text = out.getvalue()
    assert "last_checkpoint runlog record" in text
    assert json.dumps({"kind": "checkpoint", "gstep": 8, "bytes": 123}) in text
    assert "memory:" in text and "host rss peak" in text


# ---------------------------------------------------------------------------
# Background writer
# ---------------------------------------------------------------------------


def _mixed_state():
    return {"w": torch.arange(16.0), "b": torch.ones((2, 2)),
            "h": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16),
            "n": torch.arange(5, dtype=torch.int32)}


def test_async_writer_matches_sync(tmp_path):
    state = _mixed_state()
    sync_path = CheckpointManager(str(tmp_path / "sync"), fingerprint="ff").save(state, 3)
    async_mgr = CheckpointManager(str(tmp_path / "async"), fingerprint="ff")
    saved = []
    with AsyncCheckpointWriter(async_mgr, on_saved=saved.append) as w:
        apath = w.save(state, step_id=3)
        w.flush()
    a, sid_a = load_arrays(apath, expected_fingerprint="ff")
    s, sid_s = load_arrays(sync_path, expected_fingerprint="ff")
    assert sid_a == sid_s == 3 and a.keys() == s.keys()
    for k in s:
        assert torch.equal(a[k], s[k]), k
    with open(os.path.join(apath, "manifest.json")) as f:
        am = json.load(f)
    with open(os.path.join(sync_path, "manifest.json")) as f:
        sm = json.load(f)
    assert am == sm
    (st,) = saved
    assert st.step_id == 3 and st.durable_ms >= st.stall_ms > 0


def test_async_writer_latches_errors(tmp_path, monkeypatch):
    from mpi4dl_tpu_torch import checkpoint as ckpt_mod

    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(ckpt_mod.ShardedSaveTxn, "add_shard",
                        lambda self, *a: (_ for _ in ()).throw(OSError("disk gone")))
    w = AsyncCheckpointWriter(mgr)
    w.save({"w": torch.ones(2)}, 1)
    with pytest.raises(CheckpointWriteError, match="disk gone"):
        w.flush()
    w.close()
    assert not os.path.exists(mgr.path_for(1))
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]


def test_async_writer_memory_bound(tmp_path, monkeypatch):
    """Copied-but-unwritten bytes stay inside the budget even when the
    disk is slow (the training thread blocks instead of buffering)."""
    from mpi4dl_tpu_torch.checkpoint import ShardedSaveTxn

    orig = ShardedSaveTxn.add_shard

    def slow_add(self, leaf_id, offset, arr):
        time.sleep(0.01)
        return orig(self, leaf_id, offset, arr)

    monkeypatch.setattr(ShardedSaveTxn, "add_shard", slow_add)
    state = {f"l{i}": torch.ones(1 << 16) for i in range(8)}
    total, budget = 8 * (1 << 18), 2 << 18
    mgr = CheckpointManager(str(tmp_path))
    with AsyncCheckpointWriter(mgr, max_pending_bytes=budget) as w:
        path = w.save(state, 1)
        w.flush()
        assert budget // 2 <= w.peak_pending_bytes <= budget < total
    arrays, step_id = load_arrays(path)
    assert step_id == 1 and len(arrays) == 8
    stats = mgr.last_save_stats
    assert stats.bytes == total and stats.peak_pending_bytes <= budget


def test_async_writer_holds_many_small_leaves_to_the_byte_budget(tmp_path, monkeypatch):
    """Only the byte budget throttles the training thread: a state of many
    small leaves (AmoebaNet's 1382) is copied and queued whole while a slow
    disk writes it, instead of waiting on a count of queued items."""
    from mpi4dl_tpu_torch.checkpoint import ShardedSaveTxn

    orig = ShardedSaveTxn.add_shard

    def slow_add(self, leaf_id, offset, arr):
        time.sleep(0.002)
        return orig(self, leaf_id, offset, arr)

    monkeypatch.setattr(ShardedSaveTxn, "add_shard", slow_add)
    state = {f"l{i:03d}": torch.ones(256) for i in range(300)}
    with AsyncCheckpointWriter(CheckpointManager(str(tmp_path))) as w:
        w.save(state, 1)
        w.flush()
        assert w.peak_pending_bytes >= 0.9 * 300 * 1024


def test_async_writer_stress_keeps_its_budget(tmp_path):
    """Twelve saves of 64 leaves queued back to back under a 2 KiB budget,
    with the interpreter switching threads every microsecond: every save
    lands and restores, and the budget's count returns to zero (a lost
    update between the training thread and the worker would leave it off
    or deadlock the wait)."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = CheckpointManager(str(tmp_path), keep=12)
        with AsyncCheckpointWriter(mgr, max_pending_bytes=2048) as w:
            for sid in range(12):
                w.save({f"l{i:02d}": torch.full((64,), float(sid)) for i in range(64)}, sid)
            w.flush()
            assert w.budget.used == 0 and w.peak_pending_bytes <= 2048
        assert not w._thread.is_alive()
    finally:
        sys.setswitchinterval(old)
    for sid in range(12):
        arrays, got = load_arrays(mgr.path_for(sid))
        assert got == sid and all(torch.equal(a, torch.full((64,), float(sid)))
                                  for a in arrays.values())


def test_async_writer_npz_format(tmp_path):
    mgr = CheckpointManager(str(tmp_path), format="npz")
    with AsyncCheckpointWriter(mgr) as w:
        path = w.save(_mixed_state(), 2)
    arrays, step_id = load_arrays(path)
    assert step_id == 2 and path.endswith("ckpt_2.npz") and len(arrays) == 4


def test_pending_bytes_budget_hatch(monkeypatch):
    from mpi4dl_tpu_torch.resilience.writer import DEFAULT_PENDING_BYTES, pending_bytes_budget

    monkeypatch.delenv("MPI4DL_CKPT_HOST_BYTES", raising=False)
    assert pending_bytes_budget() == DEFAULT_PENDING_BYTES == 1 << 30
    assert pending_bytes_budget(123) == 123
    monkeypatch.setenv("MPI4DL_CKPT_HOST_BYTES", "4096")
    assert pending_bytes_budget() == 4096


def test_checkpoint_runlog_record(tmp_path):
    runlog = RunLog(str(tmp_path / "run.jsonl"))
    _run_toy(tmp_path, steps=2, epochs=2, ckpt_dir=tmp_path / "ck",
             guard=AnomalyGuard(), runlog=runlog)
    runlog.close()
    recs = [r for r in read_runlog(runlog.path) if r["kind"] == "checkpoint"]
    assert [r["gstep"] for r in recs] == [0, 2, 4]
    for r in recs:
        assert r["bytes"] > 0 and r["shards"] >= 1
        assert r["gather_ms"] >= 0 and r["write_ms"] > 0
        assert r["durable_ms"] >= r["stall_ms"] > 0
        assert r["format"] == "sharded" and r["path"].endswith(f"ckpt_{r['gstep']}")


def test_lost_shard_files_fault_falls_back(tmp_path):
    ckpt_dir = tmp_path / "ck"
    res = _run_toy(tmp_path, steps=2, epochs=2, ckpt_dir=ckpt_dir,
                   faults=FaultInjector(FaultSpec("lost_shard_files", 3)),
                   guard=AnomalyGuard())
    assert res.final_step == 4
    _, step_id = CheckpointManager(str(ckpt_dir)).restore_latest(_toy_state())
    assert step_id == 2


# ---------------------------------------------------------------------------
# Fault specs, injectors, the data hook, RunLog meta
# ---------------------------------------------------------------------------


def test_parse_fault_forms():
    assert parse_fault(None) is None and parse_fault("") is None
    assert parse_fault("nan_loss@3") == FaultSpec("nan_loss", 3)
    assert parse_fault("stall_data@2:1.5") == FaultSpec("stall_data", 2, 1.5)
    spec = parse_fault("reshape@2:slice-method=horizontal,parts=2")
    assert spec.opts == "slice-method=horizontal,parts=2" and spec.arg == 0.0
    for bad in ("nonsense@1", "sigterm", "sigterm@x", "@2"):
        with pytest.raises(ValueError):
            parse_fault(bad)
    with pytest.raises(ValueError, match="numeric arg"):
        parse_fault("stall_data@5:2,5")
    assert len(FAULT_KINDS) == 13 and set(CKPT_FAULT_KINDS) < set(FAULT_KINDS)
    for kind in FAULT_KINDS:
        assert parse_fault(f"{kind}@4").kind == kind


def test_fault_from_env(monkeypatch):
    from mpi4dl_tpu_torch.resilience import fault_from_env

    monkeypatch.setenv("MPI4DL_FAULT", "io_error@7")
    assert fault_from_env() == FaultSpec("io_error", 7)
    assert FaultInjector.from_env().spec == FaultSpec("io_error", 7)


@pytest.mark.parametrize("kind,exc,match", [
    ("raise", FaultInjected, "before step 2"),
    ("oom_step", torch.OutOfMemoryError, "RESOURCE_EXHAUSTED: injected oom_step at step 2"),
    ("mesh_shrunk", MeshShrunk, "devices=4"),
    ("io_error", OSError, "MPI4DL_FAULT=io_error"),
])
def test_fault_injectors_fire_once(kind, exc, match):
    inj = FaultInjector(FaultSpec(kind, 2, opts="devices=4"))
    inj.before_step(1)
    with pytest.raises(exc, match=match):
        inj.before_step(2)
    inj.before_step(2)  # single-shot
    loss = FaultInjector(FaultSpec("nan_loss", 2))
    assert loss.poison_loss(1, 1.0) == 1.0
    assert np.isnan(loss.poison_loss(2, 1.0)) and loss.poison_loss(2, 1.0) == 1.0
    batch = FaultInjector(FaultSpec("nan_batch", 2))
    x = np.ones((2, 3), np.float32)
    assert np.isnan(batch.poison_batch(2, x)).all() and np.isfinite(x).all()
    assert batch.poison_batch(2, x) is x


def test_oom_compile_fires_on_the_first_step_at_or_after_k():
    inj = FaultInjector(FaultSpec("oom_compile", 3))
    with pytest.raises(torch.OutOfMemoryError, match="RESOURCE_EXHAUSTED"):
        inj.before_step(5)  # the process's first step, past k
    late = FaultInjector(FaultSpec("oom_compile", 3))
    late.before_step(1)
    late.before_step(3)  # not the first step: nothing


def test_prefetch_stall_hook_and_addressing():
    seen, stalls = [], []

    class _Rec:
        def batch(self, idx, bs):
            seen.append(idx)
            return np.zeros((bs, 1), np.float32), np.zeros((bs,), np.int32)

    def hook(g):
        stalls.append(g)
        return 0.05 if g == 7 else 0.0

    t0 = time.perf_counter()
    items = list(prefetch_batches(_Rec(), 2, 6, 10, index_of=lambda g: g % 4,
                                  stall_hook=hook))
    assert time.perf_counter() - t0 >= 0.05
    assert [g for g, _ in items] == [6, 7, 8, 9] and stalls == [6, 7, 8, 9]
    assert seen == [2, 3, 0, 1]


def test_runlog_meta_and_step_records(tmp_path):
    runlog = RunLog.create(str(tmp_path), prefix="lp-resnet")
    runlog.write_meta(config={"a": 1}, mesh_spec=(1, 1), argv=["--x"], device="cpu")
    runlog.write_step(epoch=0, step=1, ms=2.5, images_per_sec=3.0, loss=0.5, accuracy=0.0)
    runlog.close()
    meta, step = read_runlog(runlog.path)
    assert meta["kind"] == "meta" and meta["torch_version"] == torch.__version__
    assert meta["backend"] == "cpu" and meta["device_kind"] == "cpu"
    assert step["jit_cache_size"] is None and step["memory_peak_bytes"] is None
    assert step["host_rss_peak_bytes"] > 0


# ---------------------------------------------------------------------------
# Parity with the JAX package's loop
# ---------------------------------------------------------------------------

# (label, fault spec, steps per epoch, epochs, resume after, watchdog secs)
PARITY = [
    ("none", None, 2, 2, False, 0.0),
    ("nan_loss@2", FaultSpec("nan_loss", 2), 2, 2, False, 0.0),
    ("nan_batch@2", FaultSpec("nan_batch", 2), 2, 2, False, 0.0),
    ("sigterm@2", FaultSpec("sigterm", 2), 4, 1, True, 0.0),
    ("corrupt_ckpt@2", FaultSpec("corrupt_ckpt", 2), 2, 2, True, 0.0),
    ("stall_data@1", FaultSpec("stall_data", 1, 0.4), 4, 1, False, 0.15),
    ("final_step_rollback", FaultSpec("nan_loss", 3), 4, 1, False, 0.0),
]

_STEP_FIELDS = ("gstep", "epoch", "step", "skipped_step", "next_step",
                "resumed_from", "saved")


def _jax_side():
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import resilience as jres
    from mpi4dl_tpu.checkpoint import CheckpointManager as JManager
    from mpi4dl_tpu.obs import RunLog as JRunLog

    @jax.jit
    def step(state, x, y):
        def loss_fn(w):
            return jnp.mean((x @ w - y) ** 2)

        loss, grad = jax.value_and_grad(loss_fn)(state["w"])
        return {"w": state["w"] - 0.05 * grad}, {"loss": loss, "accuracy": jnp.float32(0.0)}

    return dict(res=jres, manager=JManager, runlog=JRunLog, step=step,
                state=lambda: {"w": jnp.zeros((4,), jnp.float32)},
                w=lambda st: np.asarray(st["w"]))


def _torch_side():
    from mpi4dl_tpu_torch import resilience as tres

    return dict(res=tres, manager=CheckpointManager, runlog=RunLog, step=_toy_step(),
                state=_toy_state, w=lambda st: st["w"].numpy())


def _parity_run(side, root, spec, steps, epochs, resume, wd):
    """One package's run (and resume) under ``spec``: (records, results,
    checkpoint step ids, final w)."""
    res = side["res"]
    ckdir = root / "ck"
    results = []
    for leg in range(2 if resume else 1):
        mgr = side["manager"](str(ckdir))
        st, start = side["state"](), 0
        if mgr.latest_path() is not None:
            st, start = mgr.restore_latest(st)
        runlog = side["runlog"](str(root / "tele" / "run.jsonl"))
        out = res.run_supervised(
            side["step"], st, _ToyDataset(), global_batch=8, steps_per_epoch=steps,
            num_epochs=epochs, start_step=start, ckpt=mgr, runlog=runlog,
            guard=res.AnomalyGuard(),
            faults=res.FaultInjector(spec if leg == 0 else None), watchdog_secs=wd)
        runlog.close()
        results.append((out.final_step, out.steps_run, out.preempted, out.anomalies))
    recs = read_runlog(str(root / "tele" / "run.jsonl"))
    stream = [(r["kind"],) + tuple(r.get(k) for k in _STEP_FIELDS)
              for r in recs if r["kind"] != "checkpoint"]
    saves = [r["gstep"] for r in recs if r["kind"] == "checkpoint"]
    on_disk = sorted(int(f[5:]) for f in os.listdir(ckdir) if f.startswith("ckpt_"))
    return stream, saves, results, on_disk, side["w"](out.state)


@pytest.mark.parametrize("label,spec,steps,epochs,resume,wd", PARITY,
                         ids=[p[0] for p in PARITY])
def test_loop_matches_the_jax_loop(tmp_path, capfd, label, spec, steps, epochs, resume, wd):
    want = _parity_run(_jax_side(), tmp_path / "jax", spec, steps, epochs, resume, wd)
    got = _parity_run(_torch_side(), tmp_path / "torch", spec, steps, epochs, resume, wd)
    for name, g, w in zip(("records", "checkpoint records", "LoopResult",
                           "checkpoints on disk"), got[:4], want[:4]):
        assert g == w, (name, g, w)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    if wd:
        err = capfd.readouterr().err
        assert err.count("watchdog: step 1 exceeded") == 2, err


def test_async_checkpoints_restore_across_packages(tmp_path):
    import jax.numpy as jnp
    from ml_dtypes import bfloat16

    from mpi4dl_tpu.checkpoint import CheckpointManager as JManager
    from mpi4dl_tpu.resilience import AsyncCheckpointWriter as JWriter

    state = _mixed_state()
    with AsyncCheckpointWriter(CheckpointManager(str(tmp_path / "t"))) as w:
        w.save(state, 5)
    template = {"w": jnp.zeros(16), "b": jnp.zeros((2, 2)),
                "h": jnp.zeros((2, 3), bfloat16), "n": jnp.zeros(5, jnp.int32)}
    got, sid = JManager(str(tmp_path / "t")).restore_latest(template)
    assert sid == 5
    for k, v in state.items():
        want = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        np.testing.assert_array_equal(np.asarray(got[k]).astype(want.dtype), want)
        assert np.asarray(got[k]).dtype == template[k].dtype

    jstate = {k: jnp.asarray(np.asarray(got[k])) for k in got}
    with JWriter(JManager(str(tmp_path / "j"))) as jw:
        jw.save(jstate, 6)
    back, sid = CheckpointManager(str(tmp_path / "j")).restore_latest(
        {k: torch.zeros_like(v) for k, v in state.items()})
    assert sid == 6
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_jax_read_runlog_parses_the_ports_runlog(tmp_path):
    from mpi4dl_tpu.obs import read_runlog as jread

    runlog = RunLog(str(tmp_path / "run.jsonl"))
    runlog.write_meta(config={"model": "toy"}, device="cpu")
    _run_toy(tmp_path, steps=4, ckpt_dir=tmp_path / "ck", runlog=runlog,
             faults=FaultInjector(FaultSpec("nan_batch", 2)), guard=AnomalyGuard())
    runlog.close()
    recs = jread(runlog.path)
    assert recs == read_runlog(runlog.path)
    assert [r["kind"] for r in recs if r["kind"] not in ("checkpoint",)] == [
        "meta", "step", "step", "anomaly", "recovery", "step"]
