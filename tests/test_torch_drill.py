"""The drill harness of the PyTorch port (mpi4dl_tpu_torch/resilience/
drill.py and ``python -m mpi4dl_tpu_torch.resilience``) against the JAX
package's (mpi4dl_tpu/resilience/drill.py, tests/test_drill.py and the
judge cases of tests/test_supervisor.py).

- The toy matrix is green through the port's loop and checkpoints, with
  one ``drill`` record a scenario and the summary, the JAX toy matrix's
  verdicts (kinds, losses, steps) on the same toy.
- The judge: each case of ``tests/test_drill.py:82-157`` (scripted leg
  summaries) and of ``tests/test_supervisor.py:591-663`` (a scripted
  launcher factory) gives the JAX package's verdict record.
- The scenario tables and the verdict record's keys are the JAX package's.
- ``drill --fleet`` exits 2 and names ROADMAP A14's third part.
- Slow lane: the supervisor's OOM drill end to end at the JAX geometry,
  SP(2x2) x PP(2) at parts 4 — eight gloo ranks a leg.
JAX is imported inside the parity tests only.
"""

from __future__ import annotations

import dataclasses
import math

import pytest

from mpi4dl_tpu_torch.obs import RunLog, read_runlog
from mpi4dl_tpu_torch.resilience import (
    DrillVerdict,
    LegOutcome,
    Scenario,
    SupervisorScenario,
    default_scenarios,
    run_drills,
    run_scenario,
    supervisor_scenarios,
    synthetic_oom,
)
from mpi4dl_tpu_torch.resilience.drill import (
    parse_reshape_spec,
    run_supervisor_scenario,
    toy_runner,
)


def _jax_drill():
    from mpi4dl_tpu.resilience import drill

    return drill


def _strip(rec):
    """A verdict record without what differs by package or run: error
    reprs name the package's exception types, paths the test's tmp dirs."""
    return {k: v for k, v in rec.items() if k not in ("error",)}


def test_toy_drill_matrix_green_as_the_jax_one(tmp_path):
    runlog = RunLog(str(tmp_path / "drill.jsonl"))
    verdicts = run_drills(toy_runner(), default_scenarios(), str(tmp_path / "t"),
                          runlog=runlog)
    runlog.close()
    assert all(v.passed and v.kind == "verified_recovery" for v in verdicts), [
        (v.scenario, v.kind, v.details) for v in verdicts if not v.passed]
    recs = read_runlog(str(tmp_path / "drill.jsonl"))
    assert [r["kind"] for r in recs] == ["drill"] * 6 + ["drill_summary"]
    assert recs[-1]["passed"] == 6 and not recs[-1]["failed"]
    jd = _jax_drill()
    theirs = jd.run_drills(jd.toy_runner(), jd.default_scenarios(), str(tmp_path / "j"))
    for ours, ref in zip(verdicts, theirs):
        a, b = _strip(ours.record()), _strip(ref.record())
        assert a.keys() == b.keys(), ours.scenario
        for k in a:
            if isinstance(a[k], float) and isinstance(b[k], float):
                assert math.isclose(a[k], b[k], rel_tol=1e-6), (ours.scenario, k)
            elif k != "fault_error":
                assert a[k] == b[k], (ours.scenario, k)


def test_scenario_tables_are_the_jax_ones():
    jd = _jax_drill()
    assert ([dataclasses.asdict(s) for s in default_scenarios()]
            == [dataclasses.asdict(s) for s in jd.default_scenarios()])
    assert ([dataclasses.asdict(s) for s in supervisor_scenarios()]
            == [dataclasses.asdict(s) for s in jd.supervisor_scenarios()])
    oom = {s.name: s for s in supervisor_scenarios()}["sup_oom_degrade"]
    assert oom.overrides["parts"] == 4 and oom.probe
    assert parse_reshape_spec("slice-method=horizontal,parts=2") == {
        "slice-method": "horizontal", "parts": "2"}
    with pytest.raises(ValueError):
        parse_reshape_spec("no-equals-sign")


# ---------------------------------------------------------------------------
# The judge, on scripted legs (tests/test_drill.py:82-157)
# ---------------------------------------------------------------------------

_GOOD = {"loss": 1.0, "final_step": 4, "preempted": False, "anomalies": 0,
         "start_step": 2, "elastic": False}


def _fake_runner(results):
    def runner(tag, *, fault="", ckpt_dir, overrides=None):
        r = results[tag]
        if isinstance(r, BaseException):
            raise r
        return dict(r)

    return runner


_JUDGE_CASES = {
    "fresh_start": (dict(fault="sigterm@2", min_resume_start=2), {
        "control": _GOOD, "fault": {**_GOOD, "preempted": True, "final_step": 3},
        "resume": {**_GOOD, "start_step": 0}}),
    "drift": (dict(fault="sigterm@2", expect="exact"), {
        "control": _GOOD, "fault": {**_GOOD, "preempted": True},
        "resume": {**_GOOD, "loss": 1.0000001}}),
    "close": (dict(fault="sigterm@2", expect="close", rtol=0.05), {
        "control": _GOOD, "fault": {**_GOOD, "preempted": True},
        "resume": {**_GOOD, "loss": 1.02}}),
    "not_honored": (dict(fault="sigterm@2"), {
        "control": _GOOD, "fault": {**_GOOD, "preempted": False}, "resume": _GOOD}),
    "unrecovered_nan": (dict(fault="nan_loss@1", expect="recovered",
                             fault_outcome="complete", resume=False), {
        "control": _GOOD, "fault": {**_GOOD, "anomalies": 0}}),
    "nan_loss_nan": (dict(fault="nan_loss@1", expect="recovered",
                          fault_outcome="complete", resume=False), {
        "control": _GOOD, "fault": {**_GOOD, "anomalies": 1, "loss": float("nan")}}),
    "leg_error": (dict(fault="sigterm@2"), {
        "control": _GOOD, "fault": {**_GOOD, "preempted": True},
        "resume": OSError("disk gone")}),
}


@pytest.mark.parametrize("case", sorted(_JUDGE_CASES))
def test_judge_matches_the_jax_judge(tmp_path, case):
    jd = _jax_drill()
    kw, results = _JUDGE_CASES[case]
    ours = run_scenario(_fake_runner(results), Scenario("s", **kw),
                        str(tmp_path / "t"))
    theirs = jd.run_scenario(_fake_runner(results), jd.Scenario("s", **kw),
                             str(tmp_path / "j"))
    a, b = ours.record(), theirs.record()
    for r in (a, b):
        if isinstance(r.get("final_loss"), float) and math.isnan(r["final_loss"]):
            r["final_loss"] = "nan"
    assert a == b
    assert a["verdict"] == {"fresh_start": "fresh_start", "drift": "drift",
                            "close": "verified_recovery",
                            "not_honored": "fault_not_honored",
                            "unrecovered_nan": "not_recovered",
                            "nan_loss_nan": "not_recovered",
                            "leg_error": "leg_error"}[case]


def test_verdict_record_keys_are_the_jax_ones():
    jd = _jax_drill()
    ours = DrillVerdict("kill_resume", True, "verified_recovery", {"control_loss": 1.0})
    theirs = jd.DrillVerdict("kill_resume", True, "verified_recovery", {"control_loss": 1.0})
    assert ours.record() == theirs.record()
    assert list(ours.record()) == ["scenario", "passed", "verdict", "control_loss"]


# ---------------------------------------------------------------------------
# The supervisor judge, on a scripted launcher (tests/test_supervisor.py:591-663)
# ---------------------------------------------------------------------------


def _marker_for(error, phase="step", gstep=2):
    return {"schema": 1, "phase": phase, "gstep": gstep, "steps_run": gstep,
            "failure_class": None, "error_type": type(error).__name__,
            "error": repr(error), "error_bases": [c.__name__ for c in type(error).__mro__]}


_PP_FLAGS = {"split-size": 2, "parts": 4, "batch-size": 4,
             "num-spatial-parts": "4", "slice-method": "square"}


def _sup_script(case, outcome):
    done = {"loss": 1.0, "final_step": 4}
    if case == "verified":
        return lambda f, e, a: (outcome(rc=1, marker=_marker_for(OSError("blip")))
                                if e.get("MPI4DL_FAULT")
                                else outcome(rc=0, result={**done, "start_step": 2}))
    if case == "misclassified":
        return lambda f, e, a: (outcome(rc=1, marker=_marker_for(OSError("blip")))
                                if e.get("MPI4DL_FAULT") else outcome(rc=0, result=done))
    if case == "false_positive":
        calls = {"n": 0}

        def script(f, e, a):
            calls["n"] += 1
            if calls["n"] == 1:
                return outcome(rc=1, marker=_marker_for(OSError("noise")))
            return outcome(rc=0, result=done)

        return script
    return lambda f, e, a: (
        outcome(rc=1, marker=_marker_for(synthetic_oom("oom_compile", 0), phase="compile"))
        if e.get("MPI4DL_FAULT") else outcome(rc=0, result={**done, "elastic": False}))


_SUP_JUDGE = {
    "verified": dict(fault="io_error@2", expect="exact", expect_class="transient_io",
                     expect_policy="retry"),
    "misclassified": dict(fault="io_error@2", expect="exact", expect_class="oom_step"),
    "false_positive": dict(fault="", expect="clean"),
    "fresh_start": dict(fault="oom_compile@0", expect="close", expect_class="oom_compile",
                        expect_policy="degrade", expect_delta=True,
                        overrides=dict(_PP_FLAGS)),
}


@pytest.mark.parametrize("case", sorted(_SUP_JUDGE))
def test_supervisor_judge_matches_the_jax_judge(tmp_path, case, monkeypatch):
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF", "0")
    jd = _jax_drill()
    from mpi4dl_tpu.resilience.supervisor import LegOutcome as JaxLegOutcome

    def factory(outcome):
        script = _sup_script(case, outcome)
        return lambda family, model, workdir: script

    ours = run_supervisor_scenario(SupervisorScenario("s", **_SUP_JUDGE[case]),
                                   str(tmp_path / "t"), launcher_factory=factory(LegOutcome))
    theirs = jd.run_supervisor_scenario(jd.SupervisorScenario("s", **_SUP_JUDGE[case]),
                                        str(tmp_path / "j"),
                                        launcher_factory=factory(JaxLegOutcome))
    a, b = ours.record(), theirs.record()
    for r in (a, b):
        r["final_flags"].pop("checkpoint-dir", None)
    assert a == b
    assert a["verdict"] == {"verified": "verified_recovery", "misclassified": "misclassified",
                            "false_positive": "false_positive",
                            "fresh_start": "fresh_start"}[case]


def test_drill_cli_toy_and_fleet(tmp_path, capsys, monkeypatch):
    """The toy matrix, and ``drill --fleet --device cpu`` on the OOM-poison
    scenario with fake legs (the poison job's every leg dies of a
    compile-time OOM, the steady tenant completes): one verified recovery,
    gloo slices (no ``CUDA_VISIBLE_DEVICES``), exit 0.  Without
    ``--device cpu`` and with no card it raises."""
    from mpi4dl_tpu_torch.resilience import fleet
    from mpi4dl_tpu_torch.resilience.__main__ import main

    assert main(["drill", "--toy", "--scenarios", "kill_resume,nan_rollback",
                 "--out", str(tmp_path / "out")]) == 0
    assert "2/2 verified recoveries" in capsys.readouterr().out
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF", "0")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    legs = []

    def factory(family, model, workdir, *, job, on_spawn):
        def launch(flags, env, attempt):
            legs.append((job, flags.get("device"), env.get("CUDA_VISIBLE_DEVICES")))
            if job == "poison":
                return LegOutcome(rc=1, marker={
                    "phase": "compile", "error_type": "OutOfMemoryError",
                    "error": "CUDA out of memory. Tried to allocate 2.00 GiB",
                    "error_bases": ["OutOfMemoryError", "RuntimeError"]})
            return LegOutcome(rc=0, result={"loss": 1.0, "final_step": 4,
                                            "start_step": 0, "fleet_job": job})
        return launch

    monkeypatch.setattr(fleet, "subprocess_leg_launcher", factory)
    out = tmp_path / "f"
    assert main(["drill", "--fleet", "--device", "cpu", "--scenarios", "fleet_oom_poison",
                 "--out", str(out)]) == 0
    assert "1/1 verified recoveries" in capsys.readouterr().out
    assert sorted(legs) == [("poison", "cpu", None)] * 2 + [("steady", "cpu", None)]
    recs = read_runlog(str(next(out.glob("drill-*.jsonl"))))
    assert [(r["scenario"], r["verdict"]) for r in recs if r["kind"] == "drill"] == [
        ("fleet_oom_poison", "verified_recovery")]
    fleet_log = read_runlog(str(out / "fleet_oom_poison" / "fleet.jsonl"))
    assert fleet_log[-1]["kind"] == "fleet_summary" and fleet_log[-1]["jobs"] == {
        "poison": "quarantined", "steady": "done"}
    monkeypatch.setattr(fleet.subprocess, "run", _no_nvidia_smi)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["drill", "--fleet", "--scenarios", "fleet_oom_poison", "--out", str(out)])
    with pytest.raises(SystemExit):
        main(["drill", "--fleet", "--supervisor", "--out", str(out)])


def _no_nvidia_smi(*a, **k):
    raise FileNotFoundError("nvidia-smi")


# ---------------------------------------------------------------------------
# End to end on gloo ranks (slow lane: eight ranks a leg)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_supervisor_oom_degrade_drill_end_to_end(tmp_path):
    """The acceptance drill at the JAX geometry: injected oom_compile at
    SP(2x2) x PP(2) parts 4 on eight gloo ranks is classified, the planner
    emits a probed degraded config, the relaunch elastic-restores and
    finishes, and the final loss matches a control at that geometry."""
    sc = {s.name: s for s in supervisor_scenarios()}["sup_oom_degrade"]
    sc = dataclasses.replace(sc, overrides={**sc.overrides, "device": "cpu"})
    v = run_supervisor_scenario(sc, str(tmp_path), log=print)
    assert v.passed and v.kind == "verified_recovery", v.details
    assert v.details["incidents"][0]["failure_class"] == "oom_compile"
    assert "probe_peak_gb" in v.details["incidents"][0]["probe"]
