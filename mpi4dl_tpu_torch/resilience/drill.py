"""Fault drill harness (counterpart of ``mpi4dl_tpu/resilience/drill.py``;
the fleet scheduler's matrix lives in :mod:`.fleet`, as in the JAX
package).

A *drill* is a scripted disaster with a verdict: run a control, inject one
fault (``MPI4DL_FAULT`` semantics), resume, and CHECK that recovery
actually recovered — resumed loss equal to the control where exactness is
promised, within tolerance where the geometry changed, and never a silent
fresh start (the resume leg must report a nonzero restore step).  The same
supervised loop every runner family trains under executes the legs, so a
green drill matrix is evidence about the real trainer, not a mock.

Run the matrix::

    python -m mpi4dl_tpu_torch.resilience drill --out drill_out          # legs on the cards
    python -m mpi4dl_tpu_torch.resilience drill --toy --out drill_out    # toy, in process

Scenario matrix (``default_scenarios``):

==================  ========================================================
``kill_resume``     SIGTERM mid-run → finish step, checkpoint, exit; resume
                    must be bit-identical to the uninterrupted control
``crash_resume``    hard crash (``raise``) mid-run → resume from the last
                    epoch-boundary checkpoint; bit-identical
``corrupt_newest``  newest checkpoint corrupted after write → restore walks
                    back to the older valid one; bit-identical
``nan_rollback``    NaN loss at step k → exactly one rollback, poison batch
                    skipped, run completes finite (exactness is NOT promised
                    — the skipped batch changes the trajectory by design)
``lost_shard``      shard files vanish from the newest checkpoint →
                    manifest-first validation rejects it on a stat pass and
                    restore falls back; bit-identical
``reshape``         preempted mid-run, resume FORCED onto a different
                    geometry (elastic restore) — loss must match a
                    target-geometry control within tolerance
==================  ========================================================

Each scenario emits one ``drill`` RunLog record with a typed verdict:
``verified_recovery`` on pass, or a precise failure kind (``drift``,
``fresh_start``, ``fault_not_honored``, ``leg_error``, ``not_recovered``)
with the evidence.

Supervisor drills (``--supervisor``): the fault goes into the
SUPERVISOR's first leg only, and the judge checks the whole control plane:
the typed classification, the policy (degrade vs retry vs quarantine), the
feasibility-probed config delta, the elastic resume, and the final loss
against a control run at the supervisor's final geometry
(:func:`supervisor_scenarios` / :func:`run_supervisor_scenario`).
Additional failure kinds there: ``misclassified``, ``wrong_policy``
(unexpected policy, unprobed degrade, or a geometry change where none was
allowed), ``false_positive`` (incidents on a clean run).

The port's legs are rank sets: :func:`bench_runner` and the supervisor
drills launch every leg through
:func:`~mpi4dl_tpu_torch.resilience.supervisor.subprocess_leg_launcher`
(one process a rank, gloo ranks with ``--device cpu``, else one card a
rank), never in the caller's process.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from mpi4dl_tpu_torch.resilience.faults import FaultInjected, parse_fault

# runner(tag, *, fault="", ckpt_dir, overrides) -> summary dict with at
# least {loss, final_step, preempted, anomalies, start_step}.
Runner = Callable[..., Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One scripted disaster.  ``overrides`` apply to every leg (flag-name →
    value); ``resume_overrides`` additionally apply to the resume leg AND
    the control leg (the control trains under the TARGET geometry — that is
    what "recovered" must match after a reshape)."""

    name: str
    fault: str  # MPI4DL_FAULT spec for the fault leg
    expect: str = "exact"  # exact | close | recovered
    resume: bool = True  # run a resume leg reusing the fault leg's ckpt dir
    overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    resume_overrides: Mapping[str, Any] = dataclasses.field(
        default_factory=dict
    )
    rtol: float = 0.05  # tolerance for expect="close"
    # The fault leg's expected outward behavior: "preempt" (clean exit with
    # preempted=True), "error" (FaultInjected propagates), "complete".
    fault_outcome: str = "preempt"
    min_resume_start: int = 1  # resume must restore >= this step (no fresh start)


@dataclasses.dataclass
class DrillVerdict:
    """Typed per-scenario outcome — the ``drill`` RunLog record payload."""

    scenario: str
    passed: bool
    kind: str  # verified_recovery | drift | fresh_start | fault_not_honored
    #          | not_recovered | leg_error
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def record(self) -> dict:
        return {"scenario": self.scenario, "passed": self.passed,
                "verdict": self.kind, **self.details}


def parse_reshape_spec(spec: str) -> Dict[str, str]:
    """``slice-method=horizontal,parts=2`` → override dict for the resume
    leg's flags (the free-text arg of a ``reshape@k:<spec>`` fault)."""
    out: Dict[str, str] = {}
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        k, sep, v = tok.partition("=")
        if not sep or not k.strip():
            raise ValueError(
                f"reshape spec {spec!r}: expected flag=value[,flag=value...]"
            )
        out[k.strip()] = v.strip()
    return out


def default_scenarios(
    reshape_spec: str = "slice-method=horizontal,parts=2",
    reshape_base: Optional[Mapping[str, Any]] = None,
) -> List[Scenario]:
    """The full fault matrix, tuned for a 2-epoch × 2-step run (boundary
    checkpoints at steps 0/2/4).  ``reshape_base`` pins the reshape
    scenario's SAVE-side geometry (default SP(2×2)×PP(2) parts=4 — the
    sp_pipeline engine); ``reshape_spec`` is the resume-side skew."""
    if reshape_base is None:
        reshape_base = {"split-size": 2, "parts": 4, "slice-method": "square",
                        "batch-size": 4}
    return [
        Scenario("kill_resume", fault="sigterm@2", expect="exact",
                 min_resume_start=2),
        Scenario("crash_resume", fault="raise@3", expect="exact",
                 fault_outcome="error", min_resume_start=2),
        Scenario("corrupt_newest", fault="corrupt_ckpt@3", expect="exact",
                 fault_outcome="complete", min_resume_start=2),
        Scenario("nan_rollback", fault="nan_loss@1", expect="recovered",
                 fault_outcome="complete", resume=False),
        Scenario("lost_shard", fault="lost_shard_files@3", expect="exact",
                 fault_outcome="complete", min_resume_start=2),
        Scenario("reshape", fault=f"reshape@2:{reshape_spec}",
                 expect="close", overrides=dict(reshape_base),
                 resume_overrides=parse_reshape_spec(reshape_spec),
                 min_resume_start=2),
    ]


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-6)


def run_scenario(runner: Runner, sc: Scenario, workdir: str,
                 log: Callable[[str], None] = lambda s: None) -> DrillVerdict:
    """Execute one scenario's legs and judge the outcome."""
    wd = os.path.join(workdir, sc.name)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd, exist_ok=True)
    details: Dict[str, Any] = {"fault": sc.fault, "expect": sc.expect}
    target_overrides = {**sc.overrides, **sc.resume_overrides}

    def leg(tag: str, **kw) -> Dict[str, Any]:
        log(f"[{sc.name}] {tag} leg...")
        return runner(tag, ckpt_dir=os.path.join(wd, f"ck_{tag}"), **kw)

    try:
        control = leg("control", overrides=target_overrides)
        details["control_loss"] = control.get("loss")
    except (Exception, SystemExit) as e:  # a leg crash is itself a verdict
        return DrillVerdict(sc.name, False, "leg_error",
                            {**details, "leg": "control", "error": repr(e)})

    fault_ck = os.path.join(wd, "ck_fault")
    fault_res: Optional[Dict[str, Any]] = None
    fault_err: Optional[BaseException] = None
    try:
        log(f"[{sc.name}] fault leg ({sc.fault})...")
        fault_res = runner("fault", fault=sc.fault, ckpt_dir=fault_ck,
                           overrides=sc.overrides)
    except FaultInjected as e:
        # ONLY the injected crash counts as the fault being honored; any
        # other exception (engine crash, CUDA error) is a leg failure, never
        # a verified fault.
        fault_err = e
    except (Exception, SystemExit) as e:
        return DrillVerdict(sc.name, False, "leg_error",
                            {**details, "leg": "fault", "error": repr(e)})

    # Did the fault do what the scenario scripted?
    if sc.fault_outcome == "error":
        if fault_err is None:
            return DrillVerdict(
                sc.name, False, "fault_not_honored",
                {**details, "reason": "injected crash did not raise"},
            )
        details["fault_error"] = repr(fault_err)
    elif fault_err is not None:
        return DrillVerdict(sc.name, False, "leg_error",
                            {**details, "leg": "fault",
                             "error": repr(fault_err)})
    elif sc.fault_outcome == "preempt" and not fault_res.get("preempted"):
        return DrillVerdict(
            sc.name, False, "fault_not_honored",
            {**details, "reason": "fault leg was not preempted",
             "fault_summary": fault_res},
        )
    if fault_res is not None:
        details["fault_final_step"] = fault_res.get("final_step")
        details["fault_anomalies"] = fault_res.get("anomalies")

    final = fault_res
    if sc.resume:
        try:
            log(f"[{sc.name}] resume leg...")
            final = runner("resume", ckpt_dir=fault_ck,
                           overrides=target_overrides)
        except (Exception, SystemExit) as e:
            return DrillVerdict(sc.name, False, "leg_error",
                                {**details, "leg": "resume",
                                 "error": repr(e)})
        details["resume_start_step"] = final.get("start_step")
        details["resume_elastic"] = final.get("elastic")
        if int(final.get("start_step") or 0) < sc.min_resume_start:
            return DrillVerdict(
                sc.name, False, "fresh_start",
                {**details,
                 "reason": f"resume restored step "
                           f"{final.get('start_step')} < required "
                           f"{sc.min_resume_start} — progress was lost"},
            )

    loss = final.get("loss") if final else None
    details["final_loss"] = loss
    details["final_step"] = final.get("final_step") if final else None
    if loss is None or not math.isfinite(float(loss)):
        return DrillVerdict(sc.name, False, "not_recovered",
                            {**details, "reason": "non-finite final loss"})

    if sc.expect == "exact":
        if float(loss) != float(control["loss"]):
            return DrillVerdict(
                sc.name, False, "drift",
                {**details,
                 "reason": f"resumed loss {loss!r} != control "
                           f"{control['loss']!r} (bit-identity promised)"},
            )
    elif sc.expect == "close":
        if not _close(float(loss), float(control["loss"]), sc.rtol):
            return DrillVerdict(
                sc.name, False, "drift",
                {**details,
                 "reason": f"resumed loss {loss!r} not within rtol="
                           f"{sc.rtol} of control {control['loss']!r}"},
            )
    elif sc.expect == "recovered":
        if int(final.get("anomalies") or 0) != 1:
            return DrillVerdict(
                sc.name, False, "not_recovered",
                {**details,
                 "reason": f"expected exactly one rollback, got "
                           f"{final.get('anomalies')}"},
            )
    return DrillVerdict(sc.name, True, "verified_recovery", details)


def run_drills(runner: Runner, scenarios: Sequence[Scenario], workdir: str,
               runlog=None,
               log: Callable[[str], None] = lambda s: None
               ) -> List[DrillVerdict]:
    """Run every scenario; one ``drill`` record per verdict plus a final
    ``drill_summary`` record."""
    verdicts = []
    for sc in scenarios:
        v = run_scenario(runner, sc, workdir, log=log)
        verdicts.append(v)
        log(f"[{sc.name}] {'PASS' if v.passed else 'FAIL'} ({v.kind})")
        if runlog is not None:
            runlog.write("drill", **v.record())
    if runlog is not None:
        runlog.write(
            "drill_summary",
            total=len(verdicts),
            passed=sum(v.passed for v in verdicts),
            failed=[v.scenario for v in verdicts if not v.passed],
        )
    return verdicts


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------


def toy_runner() -> Runner:
    """Self-contained toy runner (4-weight linear regression, deterministic
    batches, the JAX package's toy in torch ops) exercising the REAL
    loop/checkpoint/fault machinery in this process — the drill harness's
    own test double and the CLI's ``--toy`` smoke.  All paths derive from
    each leg's ``ckpt_dir``.  Geometry overrides are accepted and recorded
    but have no toy meaning (there is no mesh), so reshape drills degrade
    to kill-and-resume there."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch.checkpoint import CheckpointManager
    from mpi4dl_tpu_torch.resilience.faults import FaultInjector
    from mpi4dl_tpu_torch.resilience.guard import AnomalyGuard
    from mpi4dl_tpu_torch.resilience.loop import run_supervised

    class _Data:
        def batch(self, idx, batch_size):
            rng = np.random.default_rng(1000 + idx)
            x = rng.standard_normal((batch_size, 4)).astype(np.float32)
            y = (x @ np.array([1.0, 2.0, 3.0, 4.0], np.float32)).astype(
                np.float32
            )
            return x, y

    def step(state, x, y):
        x, y = torch.as_tensor(np.asarray(x)), torch.as_tensor(np.asarray(y))
        w = state["w"].detach().requires_grad_(True)
        loss = torch.mean((x @ w - y) ** 2)
        (grad,) = torch.autograd.grad(loss, w)
        return ({"w": (w - 0.05 * grad).detach()},
                {"loss": loss.detach(), "accuracy": torch.tensor(0.0)})

    def runner(tag: str, *, fault: str = "", ckpt_dir: str,
               overrides: Optional[Mapping[str, Any]] = None
               ) -> Dict[str, Any]:
        template = {"w": torch.zeros(4, dtype=torch.float32)}
        ckpt = CheckpointManager(ckpt_dir)
        state, start = ckpt.restore_latest(template)
        res = run_supervised(
            step, state, _Data(), global_batch=8, steps_per_epoch=2,
            num_epochs=2, start_step=start, ckpt=ckpt,
            guard=AnomalyGuard(),
            faults=FaultInjector(parse_fault(fault or None)),
        )
        return {
            "loss": res.metrics.get("loss"),
            "final_step": res.final_step,
            "preempted": res.preempted,
            "anomalies": res.anomalies,
            "start_step": start,
            "elastic": bool(ckpt.last_restore and ckpt.last_restore.elastic),
            "overrides": dict(overrides or {}),
        }

    return runner


def bench_runner(family: str = "sp", model: str = "resnet",
                 base_flags: Optional[Mapping[str, Any]] = None) -> Runner:
    """The real thing: each leg is one full runner entry-point run (flags →
    ranks → engine → supervised loop → checkpoints), launched as a rank set
    through the supervisor's leg launcher under ``<ckpt_dir>_legs``.
    Small default geometry (32² ResNet, 2-step epochs × 2); the reshape
    scenario overrides it to SP(2×2)×PP(2).  A leg that exits non-zero
    raises: :class:`FaultInjected` when its first failing rank's crash
    marker names the injected crash (the judge's ``fault_outcome="error"``),
    else a ``RuntimeError`` with its exit code and error."""
    from mpi4dl_tpu_torch.resilience.supervisor import subprocess_leg_launcher

    defaults: Dict[str, Any] = {
        "image-size": 32, "num-layers": 1, "batch-size": 4,
        "steps-per-epoch": 2, "num-epochs": 2,
    }
    defaults.update(base_flags or {})

    def runner(tag: str, *, fault: str = "", ckpt_dir: str,
               overrides: Optional[Mapping[str, Any]] = None
               ) -> Dict[str, Any]:
        flags = dict(defaults)
        flags.update(overrides or {})
        flags["checkpoint-dir"] = ckpt_dir
        launch = subprocess_leg_launcher(family, model, f"{ckpt_dir}_legs")
        out = launch(flags, {"MPI4DL_FAULT": fault} if fault else {}, 1)
        if out.rc == 0 and out.result is not None:
            return out.result
        marker = out.marker or {}
        if marker.get("error_type") == "FaultInjected":
            raise FaultInjected(marker.get("error") or "injected crash")
        raise RuntimeError(f"leg rc={out.rc}: {marker.get('error') or out.stderr_tail[-400:]}")

    return runner


# ---------------------------------------------------------------------------
# Supervisor-level drills
# ---------------------------------------------------------------------------


# Same small geometry the single-leg drills use: 2-step epochs x 2, so the
# boundary checkpoints land at steps 0/2/4 and a fault at step 2 has a
# fresh checkpoint behind it.
_SUP_BASE: Dict[str, Any] = {
    "image-size": 32, "num-layers": 1, "batch-size": 4,
    "steps-per-epoch": 2, "num-epochs": 2,
}

# The acceptance geometry: SP(2x2)xPP(2) at parts=4 — the config the
# oom drills degrade OUT of (the planner's halve_parts rung is the first
# elastic move there; junction re-placement is excluded for sp_pipeline
# states because it re-packs leaf shapes).
_SUP_OOM_GEO: Dict[str, Any] = {
    "split-size": 2, "parts": 4, "slice-method": "square",
    "num-spatial-parts": "4",
}


@dataclasses.dataclass(frozen=True)
class SupervisorScenario:
    """One scripted disaster for the SUPERVISOR: the fault goes into leg 1
    only; the judge checks classification, policy, config delta, elastic
    resume, and the final loss against a control at the supervisor's final
    geometry."""

    name: str
    fault: str  # empty = clean run (the no-false-positive scenario)
    expect: str  # clean | exact | close
    expect_class: Optional[str] = None
    expect_policy: Optional[str] = None
    # degrade scenarios must change geometry (and be probed + elastic);
    # retry scenarios must NOT change geometry.
    expect_delta: bool = False
    overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    rtol: float = 0.05
    probe: bool = False  # run the real compile-only feasibility probe


def supervisor_scenarios() -> List[SupervisorScenario]:
    """The supervisor drill matrix (the JAX package's four scenarios)."""
    return [
        SupervisorScenario(
            "sup_clean", fault="", expect="clean",
        ),
        SupervisorScenario(
            "sup_oom_degrade", fault="oom_compile@0", expect="close",
            expect_class="oom_compile", expect_policy="degrade",
            expect_delta=True, overrides=dict(_SUP_OOM_GEO), probe=True,
        ),
        SupervisorScenario(
            "sup_oom_step_degrade", fault="oom_step@2", expect="close",
            expect_class="oom_step", expect_policy="degrade",
            expect_delta=True, overrides=dict(_SUP_OOM_GEO), probe=True,
        ),
        SupervisorScenario(
            "sup_transient_io", fault="io_error@2", expect="exact",
            expect_class="transient_io", expect_policy="retry",
            expect_delta=False,
        ),
    ]


def run_supervisor_scenario(
    sc: SupervisorScenario, workdir: str,
    family: str = "sp", model: str = "resnet",
    log: Callable[[str], None] = lambda s: None,
    launcher_factory=None,
) -> DrillVerdict:
    """Execute one supervisor scenario and judge the whole control plane.

    ``launcher_factory(family, model, workdir)`` is injectable for tests;
    the default launches each leg as a fresh rank set through the runner
    entry point (:func:`subprocess_leg_launcher`)."""
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.resilience.planner import compile_probe
    from mpi4dl_tpu_torch.resilience.supervisor import (
        Supervisor,
        subprocess_leg_launcher,
    )

    wd = os.path.join(workdir, sc.name)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd, exist_ok=True)
    details: Dict[str, Any] = {"fault": sc.fault, "expect": sc.expect}
    flags: Dict[str, Any] = {**_SUP_BASE, **sc.overrides,
                             "checkpoint-dir": os.path.join(wd, "ck_sup")}
    factory = (
        launcher_factory if launcher_factory is not None
        else subprocess_leg_launcher
    )
    sup_runlog = RunLog(os.path.join(wd, "supervisor.jsonl"))
    try:
        sup = Supervisor(
            family, model, flags,
            workdir=os.path.join(wd, "legs"),
            runlog=sup_runlog,
            launch=factory(family, model, os.path.join(wd, "legs")),
            probe=compile_probe(family, model) if sc.probe else None,
            fault=sc.fault,
            log=log,
        )
        res = sup.run()
    except (Exception, SystemExit) as e:
        return DrillVerdict(sc.name, False, "leg_error",
                            {**details, "leg": "supervisor",
                             "error": repr(e)})
    finally:
        sup_runlog.close()
    details["attempts"] = res.attempts
    details["incidents"] = res.incidents
    details["final_flags"] = dict(res.flags or {})
    if not res.ok or not res.final:
        return DrillVerdict(sc.name, False, "not_recovered",
                            {**details, "reason": res.reason
                             or "supervisor gave up"})

    if sc.expect == "clean":
        if res.incidents:
            return DrillVerdict(
                sc.name, False, "false_positive",
                {**details,
                 "reason": f"clean run produced {len(res.incidents)} "
                           "incident record(s)"},
            )
        return DrillVerdict(sc.name, True, "verified_recovery", details)

    if not res.incidents:
        return DrillVerdict(
            sc.name, False, "fault_not_honored",
            {**details, "reason": "fault leg produced no incident"},
        )
    first = res.incidents[0]
    if sc.expect_class and first.get("failure_class") != sc.expect_class:
        return DrillVerdict(
            sc.name, False, "misclassified",
            {**details,
             "reason": f"classified {first.get('failure_class')!r}, "
                       f"expected {sc.expect_class!r}"},
        )
    if sc.expect_policy and first.get("policy") != sc.expect_policy:
        return DrillVerdict(
            sc.name, False, "wrong_policy",
            {**details,
             "reason": f"policy {first.get('policy')!r}, expected "
                       f"{sc.expect_policy!r}"},
        )
    changed = dict(res.flags or {}) != flags or bool(res.env)
    if sc.expect_delta:
        if not first.get("config_delta"):
            return DrillVerdict(
                sc.name, False, "wrong_policy",
                {**details, "reason": "degrade incident carries no "
                                      "config delta"},
            )
        if sc.probe and "probe_peak_gb" not in (first.get("probe") or {}):
            return DrillVerdict(
                sc.name, False, "wrong_policy",
                {**details, "reason": "degraded config was not "
                                      "feasibility-probed"},
            )
        if not res.final.get("elastic"):
            return DrillVerdict(
                sc.name, False, "fresh_start",
                {**details,
                 "reason": "degraded relaunch did not elastic-restore "
                           "(final leg reports elastic=false)"},
            )
    elif changed:
        return DrillVerdict(
            sc.name, False, "wrong_policy",
            {**details, "reason": "geometry changed on a retry-class "
                                  "failure"},
        )

    # Control: an uninterrupted run at the supervisor's FINAL geometry.
    control_flags = dict(res.flags or flags)
    control_flags["checkpoint-dir"] = os.path.join(wd, "ck_control")
    log(f"[{sc.name}] control leg at final geometry...")
    control_out = factory(family, model, os.path.join(wd, "control"))(
        control_flags, dict(res.env), 1,
    )
    if control_out.rc != 0 or not control_out.result:
        return DrillVerdict(sc.name, False, "leg_error",
                            {**details, "leg": "control",
                             "error": f"rc={control_out.rc}"})
    control_loss = control_out.result.get("loss")
    loss = res.final.get("loss")
    details["control_loss"], details["final_loss"] = control_loss, loss
    if loss is None or not math.isfinite(float(loss)):
        return DrillVerdict(sc.name, False, "not_recovered",
                            {**details, "reason": "non-finite final loss"})
    if sc.expect == "exact" and float(loss) != float(control_loss):
        return DrillVerdict(
            sc.name, False, "drift",
            {**details,
             "reason": f"final loss {loss!r} != control {control_loss!r} "
                       "(bit-identity promised)"},
        )
    if sc.expect == "close" and not _close(float(loss),
                                           float(control_loss), sc.rtol):
        return DrillVerdict(
            sc.name, False, "drift",
            {**details,
             "reason": f"final loss {loss!r} not within rtol={sc.rtol} "
                       f"of control {control_loss!r}"},
        )
    return DrillVerdict(sc.name, True, "verified_recovery", details)


def run_supervisor_drills(
    scenarios: Sequence[SupervisorScenario], workdir: str,
    family: str = "sp", model: str = "resnet", runlog=None,
    log: Callable[[str], None] = lambda s: None,
    launcher_factory=None,
) -> List[DrillVerdict]:
    """Run the supervisor scenario matrix; one ``drill`` record per verdict
    plus a ``drill_summary`` (same record vocabulary as the single-leg
    matrix, so ``obs report`` renders both)."""
    verdicts = []
    for sc in scenarios:
        v = run_supervisor_scenario(sc, workdir, family, model, log=log,
                                    launcher_factory=launcher_factory)
        verdicts.append(v)
        log(f"[{sc.name}] {'PASS' if v.passed else 'FAIL'} ({v.kind})")
        if runlog is not None:
            runlog.write("drill", **v.record())
    if runlog is not None:
        runlog.write(
            "drill_summary",
            total=len(verdicts),
            passed=sum(v.passed for v in verdicts),
            failed=[v.scenario for v in verdicts if not v.passed],
        )
    return verdicts
