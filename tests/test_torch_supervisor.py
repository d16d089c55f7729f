"""The elastic supervisor of the PyTorch port (mpi4dl_tpu_torch/resilience/
supervisor.py, planner.py, obs/flight.py's summaries) against the JAX
package's (mpi4dl_tpu/resilience, tests/test_supervisor.py).

Parity, on the same inputs: the planner's ``degrade_candidates``,
``plan_degrade``, ``expand_candidates`` and ``plan_expand`` give equal
``Plan``s over flag dicts x the four families x failure classes x stub
probes; ``classify_failure`` gives the same class and evidence on every
evidence tuple of ``tests/test_supervisor.py`` (markers, exit codes,
stderr tails, RunLog tails, flight dumps); ``backoff_delay`` the same
draws; and one scripted launcher, returning the same ``LegOutcome``
sequence to both supervisors, gives equal incident records and
``SupervisorResult``s.  The port's own: the markers its loop writes for a
``torch.OutOfMemoryError`` in the first and a later step, the supervisor
leaving CUDA uninitialized, and legs as rank sets — two gloo ranks, one of
them faulted with ``oom_step@1``, classified from that rank's marker with
its peer listed under ``ranks``, then degraded and resumed elastically,
that clean leg's losses bitwise the unsupervised run's from the same
checkpoint.  JAX
is imported inside the parity tests only.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import shutil

import pytest
import torch

from mpi4dl_tpu_torch.obs import RunLog, read_runlog
from mpi4dl_tpu_torch.resilience import (
    FAILURE_CLASSES,
    HANG_EXIT_CODE,
    INFEASIBLE,
    POLICIES,
    FaultInjector,
    FaultSpec,
    LegOutcome,
    MeshShrunk,
    Supervisor,
    backoff_delay,
    classify_failure,
    degrade_candidates,
    expand_candidates,
    plan_degrade,
    plan_expand,
    read_crash_marker,
    run_supervised,
    subprocess_leg_launcher,
    synthetic_oom,
)

from test_torch_resilience import _ToyDataset, _toy_state, _toy_step


def _jax():
    import mpi4dl_tpu.resilience as jr
    from mpi4dl_tpu.resilience import planner as jp

    return jr, jp


def _marker_for(error, phase="step", gstep=2, **extra):
    return {
        "schema": 1, "phase": phase, "gstep": gstep, "steps_run": gstep,
        "failure_class": extra.pop("failure_class", None),
        "error_type": type(error).__name__, "error": repr(error),
        "error_bases": [c.__name__ for c in type(error).__mro__],
        **extra,
    }


class AnomalyError(RuntimeError):
    pass


class CheckpointInvalid(ValueError):
    pass


# ---------------------------------------------------------------------------
# Planner parity
# ---------------------------------------------------------------------------

_FLAG_SETS = [
    {"split-size": 2, "parts": 4, "batch-size": 4, "num-spatial-parts": "4",
     "slice-method": "square"},
    {"parts": 2, "batch-size": 4, "num-spatial-parts": "4", "slice-method": "square",
     "split-size": 1},
    {"parts": 2, "batch-size": 4, "num-spatial-parts": "4", "slice-method": "vertical",
     "split-size": 2},
    {"parts": 4, "batch-size": 4, "times": 1, "split-size": 2},
    {"parts": 1, "split-size": 2},
    {"parts": 8, "batch-size": 6, "times": 2, "split-size": 4, "data-parallel": 2,
     "num-spatial-parts": "16,4", "spatial-size": 2, "stripe-bwd": True},
    {"parts": 2, "batch-size": 2, "num-spatial-parts": "2", "slice-method": "horizontal",
     "spatial-until": "auto"},
]
_PREFERRED = {"parts": 8, "batch-size": 8, "num-spatial-parts": "16", "spatial-until": 9,
              "split-size": 2}


def _stub_probes(inf):
    return {
        "none": None,
        "feasible": lambda f, e: 10.0,
        "infeasible": lambda f, e: inf,
        "unavailable": lambda f, e: None,
        "over_budget": lambda f, e: 200.0 if f.get("parts", 1) > 1 else 10.0,
    }


@pytest.mark.parametrize("family", ["lp", "gems", "sp", "gems_sp"])
def test_planner_matches_the_jax_planner(family):
    _, jp = _jax()
    from mpi4dl_tpu_torch.resilience import planner as tp

    asd = dataclasses.asdict
    checked = 0
    for flags in _FLAG_SETS:
        assert tp.required_devices(flags, family) == jp.required_devices(flags, family)
        assert ([asd(p) for p in degrade_candidates(flags, family)]
                == [asd(p) for p in jp.degrade_candidates(flags, family)])
        assert ([asd(p) for p in expand_candidates(flags, _PREFERRED, family)]
                == [asd(p) for p in jp.expand_candidates(flags, _PREFERRED, family)])
        for cls in ("oom_compile", "oom_step", "mesh_shrunk"):
            for ev in (None, {"shrunk_spec": "devices=4"}, {"shrunk_spec": "devices=2"}):
                for name, ours in _stub_probes(INFEASIBLE).items():
                    theirs = _stub_probes(jp.INFEASIBLE)[name]
                    for budget in (None, 95.0):
                        a = plan_degrade(flags, family, cls, budget_gb=budget, probe=ours,
                                         evidence=ev)
                        b = jp.plan_degrade(flags, family, cls, budget_gb=budget,
                                            probe=theirs, evidence=ev)
                        assert (a and asd(a)) == (b and asd(b)), (flags, cls, ev, name)
                        checked += 1
        for devices in (None, 2, 4, 64):
            for name, ours in _stub_probes(INFEASIBLE).items():
                theirs = _stub_probes(jp.INFEASIBLE)[name]
                a = plan_expand(flags, _PREFERRED, family, devices=devices,
                                budget_gb=95.0, probe=ours)
                b = jp.plan_expand(flags, _PREFERRED, family, devices=devices,
                                   budget_gb=95.0, probe=theirs)
                assert (a and asd(a)) == (b and asd(b)), (flags, devices, name)
    assert checked == len(_FLAG_SETS) * 3 * 3 * 5 * 2


def test_probe_argv_builds_what_the_leg_trains():
    """The probe gets the leg's geometry (slice method, junction, stripe,
    precision, kernels) and not its run-only flags."""
    from mpi4dl_tpu_torch.resilience.planner import _probe_argv

    argv = _probe_argv(
        {"batch-size": 4, "parts": 2, "split-size": 2, "num-spatial-parts": "8",
         "slice-method": "vertical", "spatial-until": "auto", "stripe-bwd": True,
         "precision": "bf_16", "pallas-conv": True, "checkpoint-dir": "ck",
         "telemetry-dir": "t", "steps-per-epoch": 2, "device": "cpu"},
        "sp", "amoebanet", "/tmp/out.json")
    joined = " ".join(argv)
    for part in ("--family sp", "--model amoebanet", "--schedule gpipe",
                 "--out /tmp/out.json", "--slice-method vertical",
                 "--num-spatial-parts 8", "--spatial-until auto", "--stripe-bwd",
                 "--precision bf_16", "--pallas-conv"):
        assert part in joined, part
    for gone in ("--checkpoint-dir", "--telemetry-dir", "--steps-per-epoch", "--device"):
        assert gone not in joined


# ---------------------------------------------------------------------------
# Classification parity
# ---------------------------------------------------------------------------


def _flight(phase="step", steps_seen=3, marks=(100, 150, 400), per_device=True):
    ring = [{"kind": "step", "gstep": i, "memory_peak_bytes": m,
             "per_device_peak_bytes": [m] if per_device else None}
            for i, m in enumerate(marks)]
    return {"schema": 1, "reason": "crash", "phase": phase, "gstep": len(marks),
            "steps_seen": steps_seen, "ring": ring}


def _evidence_tuples():
    """(exit_code, marker, records, stderr_tail, flight) of every case of
    tests/test_supervisor.py:77-151, plus flight-refined ones and the
    CUDA caching allocator's own message."""
    cuda_oom = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 3.10 GiB is free.")
    tail = "...RESOURCE_EXHAUSTED: out of memory allocating 12GB..."
    recovered = [{"kind": "anomaly", "gstep": 2}, {"kind": "recovery", "resumed_from": 0},
                 {"kind": "step", "gstep": 3}, {"kind": "step", "gstep": 4},
                 {"kind": "step", "gstep": 5}]
    return [
        (1, _marker_for(synthetic_oom("oom_compile", 0), phase="compile", gstep=0), (), "",
         None),
        (1, _marker_for(synthetic_oom("oom_step", 2), phase="step"), (), "", None),
        (1, _marker_for(OSError("nfs blip")), (), "", None),
        (1, _marker_for(MeshShrunk("devices=4"), shrunk_spec="devices=4"), (), "", None),
        (1, {"schema": 1, "phase": "step", "gstep": 3, "failure_class": "hang"}, (), "",
         None),
        (1, _marker_for(AnomalyError("4 rollbacks")),
         [{"kind": "anomaly", "gstep": 1}, {"kind": "anomaly", "gstep": 3}], "", None),
        (1, _marker_for(CheckpointInvalid(
            "ck/ckpt_2: shard file leaf00001_s000.bin missing (leaf 1)"), phase="init"),
         (), "", None),
        (-11, None, recovered, "", None),
        (1, None, recovered + [{"kind": "anomaly", "gstep": 6}], "", None),
        (HANG_EXIT_CODE, None, (), "", None),
        (-signal.SIGKILL, None, (), "", None),
        (-signal.SIGTERM, None, (), "", None),
        (7, None, (), "", None),
        (1, None, [], tail, None),
        (1, None, [{"kind": "step", "gstep": 0}], tail, None),
        # flight-refined
        (HANG_EXIT_CODE, None, (), "", _flight(phase="fetch")),
        (1, {"schema": 1, "phase": "save", "gstep": 4, "failure_class": "hang"}, (), "",
         _flight(phase="save")),
        (1, _marker_for(synthetic_oom("oom_step", 2), phase="step"), (), "", _flight()),
        (1, None, [], tail, _flight(steps_seen=2)),
        (1, None, [], tail, _flight(steps_seen=0, marks=(5,))),
        (1, {"schema": 1, "phase": "step", "gstep": 3, "failure_class": "oom_step"}, (), "",
         _flight(per_device=False)),
        # the card's own allocator error, at the first and a later step
        (1, _marker_for(cuda_oom, phase="compile", gstep=0), (), "", None),
        (1, _marker_for(cuda_oom, phase="step", gstep=5), (), "", _flight()),
        (1, None, [{"kind": "step", "gstep": 0}], repr(cuda_oom), None),
    ]


def test_classify_failure_matches_the_jax_classifier():
    jr, _ = _jax()
    classes = set()
    for ev in _evidence_tuples():
        ours = classify_failure(*ev)
        theirs = jr.classify_failure(*ev)
        assert (ours.failure_class, ours.evidence) == (theirs.failure_class,
                                                       theirs.evidence), ev
        classes.add(ours.failure_class)
    assert classes == set(FAILURE_CLASSES)
    assert set(POLICIES) == set(FAILURE_CLASSES) == set(jr.FAILURE_CLASSES)
    assert {k: dataclasses.asdict(v) for k, v in POLICIES.items()} == {
        k: dataclasses.asdict(v) for k, v in jr.POLICIES.items()}


def test_flight_summaries_name_the_rank_of_a_rank_dump():
    from mpi4dl_tpu.obs.flight import flight_summary as jax_summary

    from mpi4dl_tpu_torch.obs.flight import flight_summary, watermark_growth

    fl = _flight()
    assert flight_summary(fl) == jax_summary(fl)
    assert watermark_growth(fl) == (300, 0)
    assert watermark_growth({**fl, "rank": 3}) == (300, 3)
    assert flight_summary(None) is None and watermark_growth(_flight(marks=(1,))) is None


@pytest.mark.parametrize("first", [True, False])
def test_loop_marker_of_a_cuda_oom_classifies_by_phase(tmp_path, monkeypatch, first):
    """The port's loop writing the marker for the caching allocator's
    ``torch.OutOfMemoryError``: ``oom_compile`` in the process's first
    step, ``oom_step`` in a later one."""
    marker = str(tmp_path / "m.json")
    monkeypatch.setenv("MPI4DL_CRASH_MARKER", marker)
    monkeypatch.setenv("RANK", "0")
    at = 0 if first else 2
    inner = _toy_step()

    def step(state, x, y):
        step.calls += 1
        if step.calls == at + 1:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total "
                "capacity of 79.19 GiB of which 3.10 GiB is free.")
        return inner(state, x, y)

    step.calls = 0
    with pytest.raises(torch.OutOfMemoryError):
        run_supervised(step, _toy_state(), _ToyDataset(), global_batch=8,
                       steps_per_epoch=4, num_epochs=1)
    m = read_crash_marker(marker)
    assert m["phase"] == ("compile" if first else "step") and m["gstep"] == at
    c = classify_failure(1, m)
    assert c.failure_class == ("oom_compile" if first else "oom_step")
    assert c.evidence["source"] == "marker:oom_pattern"


def test_fault_ranks_confine_the_fault(monkeypatch):
    from mpi4dl_tpu_torch.resilience import fault_from_env

    monkeypatch.setenv("MPI4DL_FAULT", "oom_step@1")
    monkeypatch.setenv("MPI4DL_FAULT_RANKS", "1,3")
    monkeypatch.setenv("RANK", "1")
    assert fault_from_env() == FaultSpec("oom_step", 1)
    monkeypatch.setenv("RANK", "2")
    assert fault_from_env() is None
    monkeypatch.delenv("MPI4DL_FAULT_RANKS")
    assert FaultInjector.from_env().spec == FaultSpec("oom_step", 1)


# ---------------------------------------------------------------------------
# Backoff and the supervisor against the JAX supervisor
# ---------------------------------------------------------------------------


def test_backoff_delay_matches_the_jax_draws():
    jr, _ = _jax()
    for seed in (0, 7):
        for job in ("", "alpha"):
            ours = [backoff_delay(a, base=1.0, cap=30.0, seed=seed, job=job)
                    for a in range(11)]
            theirs = [jr.backoff_delay(a, base=1.0, cap=30.0, seed=seed, job=job)
                      for a in range(11)]
            assert ours == theirs


_PP_FLAGS = {"split-size": 2, "parts": 4, "batch-size": 4,
             "num-spatial-parts": "4", "slice-method": "square"}


def _script(case, outcome):
    """The launch script of one test_supervisor.py case, building each
    ``LegOutcome`` with ``outcome`` (either package's class)."""

    def oom(kind):
        return _marker_for(synthetic_oom(kind, 0 if kind == "oom_compile" else 2),
                           phase="compile" if kind == "oom_compile" else "step",
                           gstep=0 if kind == "oom_compile" else 2)

    done = {"loss": 1.0, "final_step": 4}
    table = {
        "clean": lambda a: outcome(rc=0, result=done),
        "transient_io": lambda a: (outcome(rc=1, marker=_marker_for(OSError("blip")))
                                   if a == 1 else outcome(rc=0, result=done)),
        "oom_degrade": lambda a: (outcome(rc=1, marker=oom("oom_compile")) if a == 1 else
                                  outcome(rc=0, result={"loss": 0.5, "final_step": 4,
                                                        "elastic": True})),
        "nan_quarantine": lambda a: (outcome(
            rc=1, marker=_marker_for(AnomalyError("clustered")),
            records=[{"kind": "anomaly", "gstep": 1}, {"kind": "anomaly", "gstep": 3}])
            if a == 1 else outcome(rc=0, result=done)),
        "nan_empty": lambda a: (outcome(rc=1, marker=_marker_for(AnomalyError("no steps")))
                                if a == 1 else outcome(rc=0, result=done)),
        "preempted": lambda a: (outcome(rc=0, result={"loss": 1.0, "final_step": 2,
                                                      "preempted": True})
                                if a == 1 else outcome(rc=0, result=done)),
        "per_class_bound": lambda a: outcome(rc=1, marker=_marker_for(OSError("forever"))),
        "global_cap": lambda a: outcome(rc=0, result={"loss": 1.0, "final_step": a,
                                                      "preempted": True}),
        "exhausted": lambda a: outcome(rc=1, marker=oom("oom_step")),
        "hang_then_ok": lambda a: (outcome(rc=HANG_EXIT_CODE, flight=_flight(phase="fetch"))
                                   if a == 1 else outcome(rc=0, result=done)),
        "mesh_shrunk": lambda a: (outcome(rc=1, marker=_marker_for(
            MeshShrunk("devices=4"), shrunk_spec="devices=4")) if a == 1
            else outcome(rc=0, result=done)),
    }
    return table[case]


_SUP_CASES = {
    "clean": {},
    "transient_io": {"fault": "io_error@2", "seed": 3},
    "oom_degrade": {"budget_gb": 95.0, "probe": lambda inf: (lambda f, e: 0.4)},
    "nan_quarantine": {},
    "nan_empty": {},
    "preempted": {},
    "per_class_bound": {},
    "global_cap": {"max_attempts": 3},
    "exhausted": {"probe": lambda inf: (lambda f, e: inf)},
    "hang_then_ok": {"seed": 5},
    "mesh_shrunk": {"flags": {"parts": 2, "batch-size": 4, "num-spatial-parts": "4",
                              "slice-method": "vertical", "split-size": 2}},
}


def _run_sup(cls, outcome, inf, case, tmp, runlog_cls):
    kw = dict(_SUP_CASES[case])
    flags = kw.pop("flags", dict(_PP_FLAGS))
    if "probe" in kw:
        kw["probe"] = kw["probe"](inf)
    calls, slept = [], []
    script = _script(case, outcome)

    def launch(f, e, a):
        calls.append((dict(f), dict(e), a))
        return script(a)

    runlog = runlog_cls(str(tmp))
    res = cls("sp", "resnet", flags, workdir=str(tmp) + "_legs", launch=launch,
              runlog=runlog, _sleep=slept.append, **kw).run()
    runlog.close()
    return res, calls, slept


@pytest.mark.parametrize("case", sorted(_SUP_CASES))
def test_supervisor_matches_the_jax_supervisor(tmp_path, case):
    """One scripted launch sequence into both supervisors: equal results,
    incident records, relaunch flags and environments, backoff sleeps and
    RunLog records (without their times); CUDA stays uninitialized."""
    jr, jp = _jax()
    from mpi4dl_tpu.obs import RunLog as JaxRunLog
    from mpi4dl_tpu.obs import read_runlog as jax_read

    ours = _run_sup(Supervisor, LegOutcome, INFEASIBLE, case, tmp_path / "t.jsonl", RunLog)
    theirs = _run_sup(jr.Supervisor, jr.LegOutcome, jp.INFEASIBLE, case,
                      tmp_path / "j.jsonl", JaxRunLog)
    assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
    assert ours[1:] == theirs[1:]

    def records(path, read):
        return [{k: v for k, v in r.items() if k != "t"} for r in read(str(path))]

    assert records(tmp_path / "t.jsonl", read_runlog) == records(tmp_path / "j.jsonl",
                                                                 jax_read)
    assert not torch.cuda.is_initialized()


def test_supervisor_knobs_resolve_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("MPI4DL_SUPERVISE_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF", "0.5")
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF_CAP", "4")
    sup = Supervisor("sp", "resnet", {}, workdir=str(tmp_path),
                     launch=lambda f, e, a: LegOutcome(rc=0, result={}))
    assert sup.max_attempts == 2
    assert sup.backoff_base == 0.5 and sup.backoff_cap == 4.0


# ---------------------------------------------------------------------------
# Legs as rank sets (gloo ranks on the CPU)
# ---------------------------------------------------------------------------

_SMALL = {"model": "resnet", "image-size": 32, "num-layers": 1, "num-classes": 10,
          "steps-per-epoch": 2, "num-epochs": 1, "device": "cpu"}


def test_rank_set_oom_on_one_rank_is_that_ranks_class(tmp_path, monkeypatch):
    """Two gloo ranks of the lp runner (2 stages, parts 2); rank 1 alone
    runs out of memory before step 1.  The leg is classified ``oom_step``
    from rank 1's marker, rank 0 (stuck in its collective, then killed or
    failing on the closed connection) is listed under ``ranks``, and the
    degraded relaunch (parts 2 -> 1) resumes elastically and completes.
    That clean leg's losses are bitwise those of the unsupervised ``run``
    in this process from the same checkpoint (one rank: two stages at
    parts 1 compute the same bits as one)."""
    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.resilience.supervisor import flags_to_argv

    monkeypatch.setenv("MPI4DL_FAULT_RANKS", "1")
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF", "0")
    ck, at_fault = tmp_path / "ck", tmp_path / "ck_at_fault"
    flags = {**_SMALL, "split-size": 2, "parts": 2, "batch-size": 2, "checkpoint-dir": str(ck)}
    legs = subprocess_leg_launcher("lp", "resnet", str(tmp_path / "legs"), timeout=240,
                                   grace=2.0)

    def launch(f, e, attempt):
        if attempt == 2:
            shutil.copytree(ck, at_fault)
        return legs(f, e, attempt)

    runlog = RunLog(str(tmp_path / "sup.jsonl"))
    res = Supervisor("lp", "resnet", flags, workdir=str(tmp_path / "legs"), runlog=runlog,
                     launch=launch, fault="oom_step@1").run()
    runlog.close()
    assert res.ok, res.reason
    assert res.attempts == 2 and len(res.incidents) == 1
    inc = res.incidents[0]
    assert inc["failure_class"] == "oom_step" and inc["policy"] == "degrade"
    assert inc["evidence"]["source"] == "marker:oom_pattern"
    assert "RESOURCE_EXHAUSTED" in inc["evidence"]["marker_error"]
    ranks = {r["rank"]: r for r in inc["evidence"]["ranks"]}
    assert set(ranks) == {0, 1}
    assert ranks[1]["rc"] == 1 and ranks[1]["marker_class"] == "oom_step"
    assert ranks[0]["rc"] != 0 and ranks[0]["marker_class"] != "oom_step"
    assert inc["config_delta"] == {"parts": {"from": 2, "to": 1}}
    assert res.flags["parts"] == 1
    assert res.final["elastic"] and res.final["final_step"] == 2
    assert math.isfinite(res.final["loss"])
    assert os.path.exists(tmp_path / "legs" / "attempt1" / "crash_marker.json.rank1")
    assert [r["kind"] for r in read_runlog(str(tmp_path / "sup.jsonl"))] == [
        "supervisor", "supervisor_summary"]
    control = run("lp", "resnet", flags_to_argv({**res.flags, "split-size": 1,
                                                 "checkpoint-dir": str(at_fault)}))
    assert control["elastic"] and control["start_step"] == res.final["start_step"]
    assert res.final["losses"] == control["losses"]
    assert res.final["loss"] == control["loss"]
    assert not torch.cuda.is_initialized()
