"""The fleet scheduler of the PyTorch port with the real leg launcher: every
leg a rank set of ``python -m mpi4dl_tpu_torch.resilience leg`` processes on
gloo (``device="cpu"``), one thread per rank.

- A priority-10 arrival preempts a 2-rank victim on a pool of four: both
  victim ranks get SIGTERM, agree on one step boundary, checkpoint and exit
  0; the arrival runs on all four ranks; the victim resumes from its own
  checkpoint and its final loss equals its solo control's bitwise (same
  geometry).
- A stop raced against a real spawn (the leg SIGTERMed while its ranks are
  still starting) ends the supervisor ``stopped`` with no incident and no
  hang in the rendezvous.
- The counterpart of the JAX package's ``test_fleet_crash_cascade_end_to_end``
  (slow lane, eight gloo ranks).
"""

from __future__ import annotations

import os
import threading
import time

import pytest

from mpi4dl_tpu_torch.obs.flight import FLIGHT_BASENAME, read_flight
from mpi4dl_tpu_torch.resilience import (
    FleetJob,
    FleetScheduler,
    Supervisor,
    fleet_scenarios,
    subprocess_leg_launcher,
)
from mpi4dl_tpu_torch.resilience import fleet as tf
from mpi4dl_tpu_torch.resilience.supervisor import rank_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RESNET = {"model": "resnet", "image-size": 32, "num-layers": 1, "num-classes": 10,
           "batch-size": 4, "steps-per-epoch": 2}


@pytest.fixture(autouse=True)
def _leg_env(monkeypatch):
    for name in ("MPI4DL_FLEET_DEVICES", "MPI4DL_FLEET_POISON_ATTEMPTS", "MPI4DL_FLEET_JOB",
                 "MPI4DL_FLEET_SLICE_DEVICES", "MPI4DL_SUPERVISE_MAX_ATTEMPTS", "MPI4DL_FAULT",
                 "MPI4DL_FAULT_RANKS", "MPI4DL_STRIPE_BWD", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF", "0.05")
    monkeypatch.chdir(ROOT)


def test_priority_arrival_drains_both_victim_ranks_and_the_victim_resumes_bitwise(tmp_path):
    """Pool 4: ``lo`` (lp over 2 stages, 8 steps) checkpoints at step 2 and
    straggles 3 s before step 3 (``slow_step``, loss-neutral), which holds
    the drain window open; ``hi`` (lp over 4 stages, priority 10) has no
    geometry on the 2 free ranks, so it preempts ``lo``.  The solo control
    (``lo``'s flags, no fault) runs beside the fleet on ranks of its own."""
    lo = {**_RESNET, "split-size": 2, "num-epochs": 4}
    hi = {**_RESNET, "split-size": 4, "num-epochs": 1}
    control = {}
    launch = subprocess_leg_launcher("lp", "resnet", str(tmp_path / "control"))
    solo = threading.Thread(target=lambda: control.update(out=launch(
        {**lo, "device": "cpu", "checkpoint-dir": str(tmp_path / "ck_control")}, {}, 1)))
    solo.start()
    sched = FleetScheduler(str(tmp_path), devices=4, device="cpu", linger_s=0.2)
    sched.submit(FleetJob("lo", "lp", lo, priority=0, fault="slow_step@3:3"))
    stop_ev = threading.Event()
    trig = tf._start_trigger(str(tmp_path / "jobs" / "lo" / "ck"), 2, lambda: sched.submit(
        FleetJob("hi", "lp", hi, priority=10)), stop_ev)
    try:
        res = sched.run(deadline_s=150)
    finally:
        stop_ev.set()
        trig.join()
        solo.join()
    assert res.ok, res.jobs
    assert [(r["event"], r.get("job"), r.get("state_to")) for r in res.timeline] == [
        ("submit", "lo", None), ("admit", "lo", "admitted"), ("launch", "lo", "running"),
        ("submit", "hi", None), ("preempt", "lo", None), ("drain", "lo", "preempting"),
        ("drained", "lo", "queued"), ("admit", "hi", "admitted"), ("launch", "hi", "running"),
        ("done", "hi", "done"), ("admit", "lo", "admitted"), ("launch", "lo", "running"),
        ("done", "lo", "done")]
    jlo, jhi = res.jobs["lo"], res.jobs["hi"]
    assert jlo["launches"] == 2 and jlo["displaced"] and jlo["start_step"] >= 3
    assert jhi["launches"] == 1 and not jhi["displaced"]
    assert (jlo["fleet_job_tag"], jhi["fleet_job_tag"]) == ("lo", "hi")
    out = control["out"]
    assert out.rc == 0 and jlo["loss"] == out.result["loss"]  # bitwise
    # Both ranks of the drained leg got the SIGTERM themselves.
    adir = tmp_path / "legs" / "launch001" / "lo" / "attempt1"
    for r in (0, 1):
        dump = read_flight(rank_path(str(adir / FLIGHT_BASENAME), r))
        assert dump is not None and dump.get("reason") == "preemption", dump
        assert dump["last_events"]["preempt_signal"]["signum"] == 15, dump["last_events"]
    assert tf._contamination_problems(str(tmp_path), res) == []


def test_stop_raced_against_a_real_spawn_ends_stopped_without_a_hang(tmp_path):
    rt = tf._JobRuntime()
    spawned = []

    def on_spawn(proc):
        spawned.append(proc)
        rt.register(proc)
        if len(spawned) == 1:
            rt.request_stop("preempted by higher-priority job 'hi'")

    flags = {**_RESNET, "split-size": 2, "num-epochs": 1, "device": "cpu",
             "checkpoint-dir": str(tmp_path / "ck")}
    t0 = time.monotonic()
    res = Supervisor("lp", "resnet", flags, workdir=str(tmp_path / "legs"), job="lo",
                     stop=rt.stop_reason, on_spawn=on_spawn).run()
    assert time.monotonic() - t0 < 20
    assert len(spawned) == 2 and all(p.returncode == -15 for p in spawned)
    assert res.stopped and res.attempts == 1 and res.incidents == []
    assert (tmp_path / "legs" / "lo" / "attempt1").is_dir()


@pytest.mark.slow
def test_fleet_crash_cascade_end_to_end(tmp_path):
    """Real rank sets at the JAX geometry (two 2x2 jobs, pool 8, gloo): both
    tenants hit the same transient-I/O fault, both recover from the step-2
    checkpoint saved just before it, and their retry backoffs are
    de-synchronized by the per-(job, attempt) jitter."""
    from mpi4dl_tpu_torch.benchmarks.fleet_check import retry_check

    sc = next(s for s in fleet_scenarios() if s.name == "fleet_crash_cascade")
    v = tf.run_fleet_scenario(sc, str(tmp_path), log=print, device="cpu")
    assert v.passed, (v.kind, v.details)
    assert v.kind == "verified_recovery"
    row = {}
    assert retry_check(row, str(tmp_path / sc.name), 2, sc.expect_done) == ""
    assert row["retry_restores"] == {"alpha": [2], "beta": [2]}
    seqs = v.details["backoff_s"]
    assert seqs["alpha"] and seqs["beta"]
    assert seqs["alpha"] != seqs["beta"]
