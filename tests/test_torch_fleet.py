"""The multi-tenant fleet of the PyTorch port (mpi4dl_tpu_torch/resilience/
allocator.py, fleet.py and the supervisor's fleet hooks) against the JAX
package's (mpi4dl_tpu/resilience, tests/test_fleet.py).

Parity, on the same inputs: ``pack`` over request sets made from a numpy
seed (with ``keep`` and pool shrinks, and the malformed specs' errors); the
lifecycle tables and the knobs' precedence; ``fleet_scenarios()`` field by
field, each trigger by what it does to a stub scheduler; and both
``FleetScheduler``s driven by one scripted fake launcher per scheduler test
of ``tests/test_fleet.py`` — the same per-job ``(event, state)`` records
and the same job states and launch counts; fleet RunLogs of either package
render to the same fleet lines through either ``obs report``.  The port's
own points: a slice's environment on cards and on the CPU, the pool counted
from ``CUDA_VISIBLE_DEVICES``, the leg launcher's slice cap, its per-rank
``on_spawn``, the ``job`` namespacing and the ``fleet_job`` tag.  JAX is
imported inside the parity tests only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.resilience import (
    FleetJob,
    FleetScheduler,
    LegOutcome,
    Request,
    Slice,
    Supervisor,
    fleet_pool,
    pack,
    slice_env,
    subprocess_leg_launcher,
)
from mpi4dl_tpu_torch.resilience import fleet as tf

_SP4 = {
    "num-spatial-parts": "4", "slice-method": "horizontal",
    "spatial-until": "auto", "batch-size": 4,
}


def _jax():
    import mpi4dl_tpu.resilience as jr
    from mpi4dl_tpu.resilience import fleet as jf

    return jr, jf


@pytest.fixture(autouse=True)
def _clean_fleet_env(monkeypatch):
    """The ladder and knob helpers read MPI4DL_* hatches — a leaked value
    would silently change which rungs exist."""
    for name in ("MPI4DL_STRIPE_BWD", "MPI4DL_FLEET_DEVICES",
                 "MPI4DL_FLEET_POISON_ATTEMPTS", "MPI4DL_FLEET_JOB",
                 "MPI4DL_FLEET_SLICE_DEVICES", "MPI4DL_SUPERVISE_MAX_ATTEMPTS",
                 "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF", "0.01")
    monkeypatch.setenv("MPI4DL_SUPERVISE_BACKOFF_CAP", "0.05")


# ---------------------------------------------------------------------------
# Allocator, tables, knobs, scenarios: equal to the JAX package's
# ---------------------------------------------------------------------------


def _pack_cases(seed=0, n=240):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k = int(rng.integers(1, 7))
        ids = [f"j{int(i)}" for i in rng.choice(12, size=k, replace=False)]
        if rng.random() < 0.05:
            ids[-1] = ids[0]  # duplicate id
        demands = rng.integers(1, 9, size=k)
        if rng.random() < 0.05:
            demands[int(rng.integers(0, k))] = int(rng.integers(-1, 1))
        reqs = [(i, int(d), int(p)) for i, d, p in
                zip(ids, demands, rng.integers(0, 4, size=k))]
        size = int(rng.integers(1, 17))
        pool = sorted(int(x) for x in rng.choice(20, size=size, replace=False))
        keep = None
        if rng.random() < 0.5:
            keep = {}
            for i in rng.choice(ids + ["ghost"], size=int(rng.integers(1, 3)),
                                replace=False):
                start = int(rng.integers(0, 18))
                keep[str(i)] = tuple(range(start, start + int(rng.integers(1, 4))))
            if rng.random() < 0.5:  # the pool shrinks under the kept slices
                pool = [d for d in pool if d < int(rng.integers(1, 20))] or [0]
        yield reqs, pool, keep


def _pack_result(mod, reqs, pool, keep):
    try:
        res = mod.pack([mod.Request(*r) for r in reqs], pool,
                       keep=None if keep is None else {
                           k: mod.Slice(v) for k, v in keep.items()})
    except ValueError as e:
        return ("ValueError", str(e))
    return ({k: v.devices for k, v in res.placed.items()}, res.unplaced, res.free)


def test_pack_equals_the_jax_pack_over_seeded_request_sets():
    jr, _ = _jax()
    import mpi4dl_tpu_torch.resilience as tr

    cases = list(_pack_cases())
    errors = 0
    for reqs, pool, keep in cases:
        ours = _pack_result(tr, reqs, pool, keep)
        assert ours == _pack_result(jr, reqs, pool, keep), (reqs, pool, keep)
        errors += ours[0] == "ValueError"
    assert len(cases) >= 200 and 0 < errors < len(cases)
    assert Slice((0, 1, 2, 3)).describe() == "[0-3]" and Slice((1, 3)).describe() == "[1,3]"


def test_lifecycle_tables_and_knobs_equal_the_jax_fleet(monkeypatch):
    _, jf = _jax()
    assert tf.JOB_STATES == jf.JOB_STATES
    assert tf.TERMINAL_STATES == jf.TERMINAL_STATES
    assert tf._TRANSITIONS == jf._TRANSITIONS
    for env in ({}, {"MPI4DL_FLEET_DEVICES": "16"},
                {"MPI4DL_FLEET_DEVICES": "16", "MPI4DL_FLEET_POISON_ATTEMPTS": "3"},
                {"MPI4DL_FLEET_POISON_ATTEMPTS": ""}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for args in ((), (4, 1), (None, 5), (2, None)):
            assert tf.fleet_knobs_from_env(*args) == jf.fleet_knobs_from_env(*args)
    for bad in ("", "has space", "-leading", "a/b"):
        with pytest.raises(ValueError):
            FleetJob(bad, "sp", dict(_SP4))


class _Stub:
    """What a trigger may call on a scheduler, recorded."""

    def __init__(self):
        self.calls = []

    def submit(self, job):
        self.calls.append(("submit", dataclasses.asdict(job)))

    def shrink_pool(self, n):
        self.calls.append(("shrink", n))

    def grow_pool(self, n):
        self.calls.append(("grow", n))


def test_fleet_scenarios_equal_the_jax_matrix():
    _, jf = _jax()
    ours, theirs = tf.fleet_scenarios(), jf.fleet_scenarios()
    assert [s.name for s in ours] == [s.name for s in theirs] == [
        "fleet_slice_kill", "fleet_preempt_storm", "fleet_crash_cascade",
        "fleet_oom_poison", "fleet_reexpand"]
    for a, b in zip(ours, theirs):
        for f in dataclasses.fields(jf.FleetScenario):
            if f.name == "jobs":
                assert [dataclasses.asdict(j) for j in a.jobs] == \
                    [dataclasses.asdict(j) for j in b.jobs], a.name
            elif f.name == "trigger":
                sa, sb = _Stub(), _Stub()
                if a.trigger is not None:
                    a.trigger(sa)
                    b.trigger(sb)
                assert (a.trigger is None) == (b.trigger is None)
                assert sa.calls == sb.calls, a.name
            else:
                assert getattr(a, f.name) == getattr(b, f.name), (a.name, f.name)
    assert {f.name for f in dataclasses.fields(tf.FleetScenario)} == \
        {f.name for f in dataclasses.fields(jf.FleetScenario)}


# ---------------------------------------------------------------------------
# Both schedulers under one scripted fake launcher
# ---------------------------------------------------------------------------


class _FakeProc:
    """Stands in for a rank's Popen: the runtime's drain SIGTERMs it."""

    def __init__(self):
        self._done = threading.Event()

    def poll(self):
        return 0 if self._done.is_set() else None

    def terminate(self):
        self._done.set()

    def wait_terminated(self, timeout):
        return self._done.wait(timeout)


def _final(job, *, loss=1.0, start=0, step=4, elastic=False, **extra):
    return {"loss": loss, "final_step": step, "start_step": start,
            "elastic": elastic, "fleet_job": job, **extra}


def _instant(out_cls, box):
    def factory(family, model, workdir, *, job, on_spawn):
        def launch(flags, env, attempt):
            box.setdefault("calls", []).append(
                {"job": job, "env": dict(env), "attempt": attempt})
            return out_cls(rc=0, result=_final(job))
        return launch
    return factory


def _preempt(out_cls, box):
    def factory(family, model, workdir, *, job, on_spawn):
        def launch(flags, env, attempt):
            if job != "lo":
                return out_cls(rc=0, result=_final(job))
            box["lo"] = box.get("lo", 0) + 1
            if box["lo"] == 1:
                procs = [_FakeProc(), _FakeProc()]  # a leg of two ranks
                for p in procs:
                    on_spawn(p)
                box["sched"].submit(box["job"]("hi1", "sp", dict(_SP4), priority=10))
                box["sched"].submit(box["job"]("hi2", "sp", dict(_SP4), priority=9))
                assert all(p.wait_terminated(30) for p in procs), "drain missed a rank"
                return out_cls(rc=0, result=_final(job, step=2, preempted=True))
            return out_cls(rc=0, result=_final(job, start=2))
        return launch
    return factory


def _poison(out_cls, box):
    def factory(family, model, workdir, *, job, on_spawn):
        def launch(flags, env, attempt):
            if job == "poison":
                return out_cls(rc=1, stderr_tail="synthetic wreck")
            return out_cls(rc=0, result=_final(job))
        return launch
    return factory


def _slice_loss(out_cls, box):
    release = box.setdefault("release", threading.Event())

    def factory(family, model, workdir, *, job, on_spawn):
        def launch(flags, env, attempt):
            if job != "nomad":
                assert release.wait(60), "nomad never relaunched"
                return out_cls(rc=0, result=_final(job))
            if "nomad" not in box:
                box["nomad"] = True
                proc = _FakeProc()
                on_spawn(proc)
                box["sched"].shrink_pool(6)
                assert proc.wait_terminated(30), "slice loss never drained"
                return out_cls(rc=0, result=_final(job, step=2, preempted=True))
            release.set()
            return out_cls(rc=0, result=_final(job, start=2, elastic=True))
        return launch
    return factory


def _growth(gate):
    def make(out_cls, box):
        def factory(family, model, workdir, *, job, on_spawn):
            def launch(flags, env, attempt):
                if "first" in box:
                    return out_cls(rc=0, result=_final(job, start=2, elastic=True))
                box["first"] = True
                proc = _FakeProc()
                on_spawn(proc)
                ck = os.path.join(flags["checkpoint-dir"], "ckpt_2")
                if not gate:
                    os.makedirs(ck, exist_ok=True)
                box["sched"].grow_pool(8)
                if gate:
                    assert not proc.wait_terminated(1.0), "drained with no checkpoint"
                    # A rank set's half-written checkpoint never counts.
                    os.makedirs(os.path.join(flags["checkpoint-dir"], ".tmp_ckpt_2_x"))
                    assert not proc.wait_terminated(0.5)
                    os.makedirs(ck)
                assert proc.wait_terminated(30), "expansion never drained"
                return out_cls(rc=0, result=_final(job, step=2, preempted=True))
            return launch
        return factory
    return make


def _namespaced(out_cls, box):
    def factory(family, model, workdir, *, job, on_spawn):
        def launch(flags, env, attempt):
            os.makedirs(os.path.join(workdir, job, f"attempt{attempt}"), exist_ok=True)
            return out_cls(rc=0, result=_final(job))
        return launch
    return factory


# case -> (pool, jobs as (id, family, flags, kw), factory maker)
_CASES = {
    "degraded_admission": (2, [("tight", "sp", _SP4, {})], _instant),
    "duplicate_and_unschedulable": (2, [
        ("dup", "sp", _SP4, {}), ("dup", "sp", _SP4, {}),
        ("wedged", "lp", {"split-size": 4, "parts": 1, "batch-size": 4}, {})], _instant),
    "preemption_drain_resume": (4, [("lo", "sp", _SP4, {"priority": 0})], _preempt),
    "poison_quarantine": (4, [("poison", "sp", _SP4, {"priority": 5, "max_attempts": 1}),
                              ("steady", "sp", _SP4, {"priority": 0})], _poison),
    "slice_loss": (8, [("keeper", "sp", _SP4, {"priority": 1}),
                       ("nomad", "sp", _SP4, {"priority": 0})], _slice_loss),
    "reexpansion": (2, [("sprout", "sp", _SP4, {})], _growth(False)),
    "expansion_waits_for_checkpoint": (2, [("gated", "sp", _SP4, {})], _growth(True)),
    "namespaced_workdirs": (8, [("alpha", "sp", _SP4, {}), ("beta", "sp", _SP4, {})],
                            _namespaced),
}


def _run_fleet(pkg, case, wd, runlog=None):
    pool, jobs, make = _CASES[case]
    box = {"job": pkg.FleetJob}
    kw = {"device": "cpu"} if pkg.__name__.startswith("mpi4dl_tpu_torch") else {}
    sched = pkg.FleetScheduler(str(wd), devices=pool, linger_s=0.2, runlog=runlog,
                               launcher_factory=make(pkg.LegOutcome, box), **kw)
    box["sched"] = sched
    for jid, fam, flags, jkw in jobs:
        sched.submit(pkg.FleetJob(jid, fam, dict(flags), **jkw))
    return sched.run(deadline_s=120), box


def _per_job(res):
    """Each job's ``(event, state)`` sequence.  ``expand_deferred`` is left
    out: whether a degraded job's loop pass lands before its fake leg's
    exit is thread timing in either package (no JAX test asserts it but
    the gated case, which checks it on its own)."""
    out = {}
    for r in res.timeline:
        if r.get("job") and r["event"] != "expand_deferred":
            out.setdefault(r["job"], []).append((r["event"], r.get("state_to")))
    return out


def _summary(res):
    return {j: {k: v[k] for k in ("state", "launches", "failures", "displaced",
                                  "expanded", "degraded", "final_flags", "final_env",
                                  "loss", "start_step", "elastic", "fleet_job_tag")}
            for j, v in res.jobs.items()}


def _fleet_summary(res):
    """The summary record, its event count without ``expand_deferred``."""
    return {**res.summary, "events": res.summary["events"] - len(_events(
        res, "expand_deferred"))}


def _events(res, event):
    return [r for r in res.timeline if r.get("event") == event]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_scheduler_matches_the_jax_scheduler(tmp_path, case):
    import mpi4dl_tpu_torch.resilience as tr

    jr, jf = _jax()
    ours, obox = _run_fleet(tr, case, tmp_path / "t")
    theirs, _ = _run_fleet(jr, case, tmp_path / "j")
    assert _per_job(ours) == _per_job(theirs)
    assert _summary(ours) == _summary(theirs)
    assert ours.ok == theirs.ok and _fleet_summary(ours) == _fleet_summary(theirs)
    assert tf._contamination_problems(str(tmp_path / "t"), ours) == []
    assert not torch.cuda.is_initialized()
    if case == "degraded_admission":
        admit, launch = _events(ours, "admit")[0], _events(ours, "launch")[0]
        assert admit["degrade_rungs"] == ["stripe_bwd", "shrink_sp"]
        assert launch["env"] == {"MPI4DL_FLEET_SLICE_DEVICES": "2", "MPI4DL_STRIPE_BWD": "1"}
        assert obox["calls"][0]["env"]["MPI4DL_FLEET_SLICE_DEVICES"] == "2"
    if case == "duplicate_and_unschedulable":
        assert ours.jobs["wedged"]["state"] == "failed" and not ours.ok
    if case == "preemption_drain_resume":
        assert _events(ours, "preempt")[0]["by"] == "hi1"
        assert ours.jobs["lo"]["start_step"] == 2 and ours.jobs["lo"]["launches"] == 2
    if case == "poison_quarantine":
        assert ours.ok and ours.jobs["poison"]["state"] == "quarantined"
        assert ours.jobs["poison"]["failures"] == 2
    if case == "slice_loss":
        assert _events(ours, "displaced")[0]["lost_devices"] == [6, 7]
        assert _events(ours, "launch")[-1]["geometry"]["num-spatial-parts"] == "2"
    if case == "reexpansion":
        assert _events(ours, "expand_planned")[0]["rungs"] == ["unstripe_bwd", "grow_sp"]
        assert ours.jobs["sprout"]["final_flags"] == _SP4
    if case == "expansion_waits_for_checkpoint":
        order = [r["event"] for r in ours.timeline]
        assert order.index("expand_deferred") < order.index("expand_planned")
        assert [r["event"] for r in theirs.timeline].count("expand_deferred") == \
            order.count("expand_deferred") == 1
    if case == "namespaced_workdirs":
        for jid in ("alpha", "beta"):
            assert sorted(p.name for p in (tmp_path / "t" / "jobs" / jid).glob(
                "supervisor*.jsonl")) == ["supervisor01.jsonl"]


def test_illegal_transition_raises_in_both(tmp_path):
    import mpi4dl_tpu_torch.resilience as tr

    jr, _ = _jax()
    for pkg, kw in ((tr, {"device": "cpu"}), (jr, {})):
        sched = pkg.FleetScheduler(str(tmp_path), devices=4,
                                   launcher_factory=_instant(pkg.LegOutcome, {}), **kw)
        sched._handle_submit(pkg.FleetJob("x", "sp", dict(_SP4)))
        js = sched._jobs["x"]
        js.state = "done"
        with pytest.raises(RuntimeError, match="illegal fleet transition 'done' -> 'running'"):
            sched._transition(js, "running", event="bogus")


def test_contamination_detector_matches_the_jax_one(tmp_path):
    jr, jf = _jax()
    legdir = tmp_path / "legs" / "launch001"
    (legdir / "alpha").mkdir(parents=True)
    cases = [
        ({"alpha": {"state": "done", "fleet_job_tag": "alpha"}},
         [{"event": "launch", "job": "alpha", "workdir": str(legdir)}]),
        ({"alpha": {"state": "done", "fleet_job_tag": "beta"}}, []),
    ]
    for jobs, timeline in cases:
        a = tf._contamination_problems(str(tmp_path), tf.FleetResult(True, jobs, timeline, {}))
        b = jf._contamination_problems(str(tmp_path), jf.FleetResult(True, jobs, timeline, {}))
        assert a == b
    (legdir / "beta").mkdir()
    jobs, timeline = cases[0]
    a = tf._contamination_problems(str(tmp_path), tf.FleetResult(True, jobs, timeline, {}))
    assert a == jf._contamination_problems(str(tmp_path), jf.FleetResult(True, jobs, timeline, {}))
    assert any("launch001" in p for p in a)


def _broken(out_cls, box):
    def factory(family, model, workdir, *, job, on_spawn):
        return lambda flags, env, attempt: out_cls(rc=1, stderr_tail="dead on arrival")
    return factory


@pytest.mark.parametrize("kind", ["verified", "not_recovered"])
def test_run_fleet_scenario_with_fake_legs_matches_the_jax_judge(tmp_path, kind):
    import mpi4dl_tpu_torch.resilience as tr

    jr, _ = _jax()
    verdicts = []
    for pkg, kw in ((tr, {"device": "cpu"}), (jr, {})):
        sc = pkg.FleetScenario(
            "fake", pool=4,
            jobs=(pkg.FleetJob("solo", "sp", dict(_SP4),
                               max_attempts=None if kind == "verified" else 1),),
            expect_done=("solo",), verify_loss=("solo",), deadline_s=60)
        make = _instant if kind == "verified" else _broken
        v = pkg.run_fleet_scenario(sc, str(tmp_path / pkg.__name__),
                                   launcher_factory=make(pkg.LegOutcome, {}), **kw)
        verdicts.append((v.passed, v.kind, {k: v.details.get(k) for k in (
            "pool", "jobs", "jobs_final", "final_loss_solo", "control_loss_solo")}))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][1] == {"verified": "verified_recovery",
                              "not_recovered": "not_recovered"}[kind]


def test_fleet_runlogs_render_the_same_in_both_reports(tmp_path):
    import mpi4dl_tpu_torch.resilience as tr
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.obs.report import render_run

    jr, _ = _jax()
    from mpi4dl_tpu.obs import RunLog as JaxRunLog
    from mpi4dl_tpu.obs.report import render_run as jax_render

    def fleet_lines(text):
        lines = text.splitlines()
        start = next(i for i, line in enumerate(lines) if line.startswith("fleet timeline"))
        end = next(i for i, line in enumerate(lines) if line.startswith("fleet: "))
        return lines[start:end + 1]

    for pkg, log_cls, kw in ((tr, RunLog, {}), (jr, JaxRunLog, {})):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        log = log_cls(path)
        res, _ = _run_fleet(pkg, "preemption_drain_resume", tmp_path / pkg.__name__, log)
        log.close()
        ours, theirs = fleet_lines(render_run(path)), fleet_lines(jax_render(path))
        assert ours == theirs and len(ours) == len(res.timeline) + 2
        assert ours[-1].startswith("fleet: OK — hi1=done, hi2=done, lo=done")


# ---------------------------------------------------------------------------
# The port's own points
# ---------------------------------------------------------------------------


def test_slice_env_on_cards_and_on_the_cpu():
    sl = Slice((2, 3))
    assert slice_env(sl, "cuda", ["4", "5", "6", "7"]) == {
        "MPI4DL_FLEET_SLICE_DEVICES": "2", "CUDA_VISIBLE_DEVICES": "6,7"}
    assert slice_env(Slice((0, 1)), "cuda", ["0", "1"]) == {
        "MPI4DL_FLEET_SLICE_DEVICES": "2", "CUDA_VISIBLE_DEVICES": "0,1"}
    assert slice_env(sl, "cpu", ["4", "5", "6", "7"]) == {"MPI4DL_FLEET_SLICE_DEVICES": "2"}
    with pytest.raises(ValueError, match="outside"):
        slice_env(sl, "cuda", ["0", "1"])


def test_pool_counts_the_visible_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert fleet_pool() == (4, ["4", "5", "6", "7"])
    assert fleet_pool(2) == (2, ["4", "5", "6", "7"])
    monkeypatch.setenv("MPI4DL_FLEET_DEVICES", "3")
    assert fleet_pool()[0] == 3
    with pytest.raises(ValueError, match="exceeds the 4 visible cards"):
        fleet_pool(5)
    monkeypatch.setenv("MPI4DL_FLEET_DEVICES", "6")
    with pytest.raises(ValueError, match="exceeds"):
        FleetScheduler("unused", launcher_factory=_instant(LegOutcome, {}))
    assert fleet_pool(None, "cpu") == (6, [])
    monkeypatch.delenv("MPI4DL_FLEET_DEVICES")
    assert fleet_pool(None, "cpu") == (8, [])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_pool()


def test_fleet_legs_on_cards_see_their_slice_only(tmp_path, monkeypatch):
    """Two 2-rank jobs on four (faked) visible cards: each job's legs get
    the parent's cards at its slice's positions."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    box = {}
    sched = FleetScheduler(str(tmp_path), linger_s=0.2,
                           launcher_factory=_instant(LegOutcome, box))
    flags = {"num-spatial-parts": "2", "slice-method": "vertical"}
    sched.submit(FleetJob("a", "sp", dict(flags), priority=1))
    sched.submit(FleetJob("b", "sp", dict(flags)))
    res = sched.run(deadline_s=60)
    assert res.ok and res.summary["pool"] == 4
    seen = {c["job"]: c["env"]["CUDA_VISIBLE_DEVICES"] for c in box["calls"]}
    assert seen == {"a": "4,5", "b": "6,7"}


class _Popen:
    """A rank process: running at its first poll, then exited 0 — or
    -SIGTERM once terminated while running."""

    spawned = []

    def __init__(self, cmd, env=None, stdout=None, stderr=None):
        self.env, self.returncode, self.polls = env, None, 0
        _Popen.spawned.append(self)

    def poll(self):
        self.polls += 1
        if self.returncode is None and self.polls > 1:
            self.returncode = 0
        return self.returncode

    def terminate(self):
        if self.returncode is None:
            self.returncode = -15

    def kill(self):
        self.terminate()

    def wait(self, timeout=None):
        return self.poll()


def test_launcher_caps_namespaces_and_spawns_per_rank(tmp_path, monkeypatch):
    from mpi4dl_tpu_torch.resilience import supervisor as sup

    monkeypatch.setattr(sup.subprocess, "Popen", _Popen)
    _Popen.spawned = []
    flags = {"num-spatial-parts": "4", "slice-method": "square"}
    seen = []
    launch = subprocess_leg_launcher("sp", "resnet", str(tmp_path), job="alpha",
                                     on_spawn=seen.append)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        launch(flags, {"MPI4DL_FLEET_SLICE_DEVICES": "2"}, 1)
    assert not _Popen.spawned and not (tmp_path / "alpha").exists()
    out = launch(flags, {"MPI4DL_FLEET_SLICE_DEVICES": "4"}, 3)
    assert out.rc == 0 and seen == _Popen.spawned and len(seen) == 4
    assert [p.env["RANK"] for p in seen] == ["0", "1", "2", "3"]
    assert {p.env["MPI4DL_FLEET_JOB"] for p in seen} == {"alpha"}
    assert len({p.env["MASTER_PORT"] for p in seen}) == 1
    assert (tmp_path / "alpha" / "attempt3" / "leg.stderr.rank3").exists()
    assert seen[0].env["MPI4DL_CRASH_MARKER"] == str(
        tmp_path / "alpha" / "attempt3" / "crash_marker.json")


def test_stop_raced_against_the_spawn_drains_the_leg_without_an_incident(
        tmp_path, monkeypatch):
    """The stop lands after rank 0 started: rank 0 is SIGTERMed by the
    drain, rank 1 the moment it registers; the supervisor ends stopped,
    with no incident and no relaunch, and says so in its summary."""
    from mpi4dl_tpu_torch.obs import RunLog, read_runlog
    from mpi4dl_tpu_torch.resilience import supervisor as sup

    monkeypatch.setattr(sup.subprocess, "Popen", _Popen)
    _Popen.spawned = []
    rt = tf._JobRuntime()

    def on_spawn(proc):
        rt.register(proc)
        if len(_Popen.spawned) == 1:
            rt.request_stop("preempted by higher-priority job 'hi'")

    log = RunLog(str(tmp_path / "sup.jsonl"))
    res = Supervisor("sp", "resnet", {"num-spatial-parts": "2", "slice-method": "vertical"},
                     workdir=str(tmp_path), runlog=log, job="lo", stop=rt.stop_reason,
                     on_spawn=on_spawn).run()
    log.close()
    assert [p.returncode for p in _Popen.spawned] == [-15, -15]
    assert res.stopped and not res.ok and res.attempts == 1 and res.incidents == []
    assert res.reason.startswith("preempted by")
    summary = read_runlog(str(tmp_path / "sup.jsonl"))[-1]
    assert summary["kind"] == "supervisor_summary"
    assert summary["stopped"] is True and summary["job"] == "lo"
    # A leg drained at a step boundary: every rank exits 0 preempted.
    res = Supervisor("sp", "resnet", {}, workdir=str(tmp_path), stop=lambda: "drain",
                     launch=lambda f, e, a: LegOutcome(rc=0, result={"preempted": True})).run()
    assert res.stopped and res.attempts == 0


def test_leg_tags_its_result_with_the_fleet_job(tmp_path, monkeypatch):
    from mpi4dl_tpu_torch.benchmarks import common
    from mpi4dl_tpu_torch.resilience.supervisor import run_leg

    monkeypatch.setattr(common, "run", lambda family, model, argv: {"loss": 0.5})
    monkeypatch.setenv("MPI4DL_FLEET_JOB", "alpha")
    monkeypatch.delenv("RANK", raising=False)
    path = tmp_path / "leg_result.json"
    assert run_leg("sp", "resnet", [], str(path)) == 0
    assert json.loads(path.read_text()) == {"loss": 0.5, "fleet_job": "alpha"}


def test_no_card_fleet_raises_and_never_drops_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tf.subprocess, "run", _no_smi)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetScheduler(str(tmp_path), launcher_factory=_instant(LegOutcome, {}))
    sc = tf.FleetScenario("x", pool=1, jobs=(FleetJob("a", "sp", dict(_SP4)),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.run_fleet_scenario(sc, str(tmp_path), launcher_factory=_instant(LegOutcome, {}))
    assert pack([Request("a", 1)], [0]).placed["a"] == Slice((0,))


def _no_smi(*a, **k):
    raise FileNotFoundError("nvidia-smi")
