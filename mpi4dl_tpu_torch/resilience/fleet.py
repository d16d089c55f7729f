"""Multi-tenant elastic fleet scheduler (counterpart of
``mpi4dl_tpu/resilience/fleet.py``).

Checkpoints restore elastically across geometries, one job runs under the
typed-failure :class:`~mpi4dl_tpu_torch.resilience.supervisor.Supervisor`,
and the planner searches the degradation ladder in both directions
(:func:`~mpi4dl_tpu_torch.resilience.planner.plan_expand`).  This module
composes them into multi-tenancy: a :class:`FleetScheduler` partitions one
device pool into bin-packed **slices**
(:mod:`~mpi4dl_tpu_torch.resilience.allocator`) and runs N prioritized
training jobs concurrently — each a :class:`Supervisor` in a worker thread
whose legs (rank sets) run on their slice.

Slices on the port.  On cards (``device="cuda"``, the default) a slice is
a set of card positions among the cards this process sees: every rank of
the job's legs sees exactly the slice's cards (``CUDA_VISIBLE_DEVICES``,
:func:`~mpi4dl_tpu_torch.resilience.allocator.slice_env`) and rank r takes
the slice's card r (``LOCAL_RANK``).  The pool is the number of visible
cards, counted without a CUDA context (:func:`visible_cards`);
``MPI4DL_FLEET_DEVICES`` or ``devices=`` may lower it, and a value above
the visible cards raises.  With ``device="cpu"`` a slice is a count of
gloo ranks, the pool defaults to 8 (the JAX default), and every leg runs
with ``--device cpu``.  Both set ``MPI4DL_FLEET_SLICE_DEVICES``, which the
leg launcher holds the leg's rank count to.  The scheduler process never
initializes CUDA.

Jobs move through a typed lifecycle::

    queued -> admitted -> running | degraded
                 ^            |
                 |    preempting | migrating ----> queued (drain + requeue)
                 |            |
                 +--- done | failed | quarantined

and every transition is enforced against ``_TRANSITIONS`` — an illegal move
is a scheduler bug and raises, never a silent state.  The scheduler reacts
to three fleet events:

- **priority preemption** — a high-priority arrival that cannot fit (even
  degraded) drains the lowest-priority victims via a graceful stop: the
  supervisor's ``stop`` hook is armed and every rank of the in-flight leg
  gets SIGTERM, so the ranks agree on a stop at the step boundary,
  checkpoint, and exit; the victim requeues and later resumes from that
  checkpoint.
- **slice loss** — ``shrink_pool`` removes devices; jobs whose slice lost a
  device are *displaced* (drained the same way) and re-admitted onto a
  planner-chosen geometry that fits what is left
  (``plan_degrade(..., "mesh_shrunk")``), elastic-restoring from their own
  checkpoint.  When devices free up again (``grow_pool``, or a tenant
  finishing), degraded jobs **re-expand** toward their preferred geometry
  (``plan_expand``) from the same checkpoint — upward moves are taken only
  when they actually use new devices, and only once the job has published
  a checkpoint since its current launch.
- **poison-job containment** — a job whose supervisor runs keep failing
  (``MPI4DL_FLEET_POISON_ATTEMPTS``, default 2) is quarantined; the queue
  is never starved by a job that cannot succeed.

Every decision is a ``fleet`` RunLog record (and a ``fleet_summary`` closes
the run), the JAX package's records; ``obs report`` renders the timeline
and ``obs metrics`` aggregates the per-job series under ``job="<id>"``
labels.  The ``drill --fleet`` chaos matrix (:func:`fleet_scenarios` /
:func:`run_fleet_drills`) judges slice-kill, preempt-storm, crash-cascade,
OOM-poison and re-expansion scenarios with the drills' typed-verdict
vocabulary.

Knobs: ``MPI4DL_FLEET_DEVICES`` (pool size), ``MPI4DL_FLEET_POISON_ATTEMPTS``
(failed supervisor runs before quarantine, default 2).  CLI::

    python -m mpi4dl_tpu_torch.resilience drill --fleet --out fleet_out
    python -m mpi4dl_tpu_torch.resilience drill --fleet --device cpu --out fleet_out
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue
import re
import shutil
import subprocess
import threading
import time
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
)

from mpi4dl_tpu_torch.resilience.allocator import Request, Slice, pack, slice_env
from mpi4dl_tpu_torch.resilience.drill import DrillVerdict, _close
from mpi4dl_tpu_torch.resilience.planner import (
    degrade_candidates,
    expand_candidates,
    plan_degrade,
    plan_expand,
    required_devices,
)
from mpi4dl_tpu_torch.resilience.supervisor import (
    Supervisor,
    SupervisorResult,
    subprocess_leg_launcher,
)

JOB_STATES = (
    "queued", "admitted", "running", "degraded", "preempting",
    "migrating", "done", "failed", "quarantined",
)

TERMINAL_STATES = ("done", "failed", "quarantined")

# The legal lifecycle moves.  "degraded" is running-at-a-non-preferred
# geometry; "preempting"/"migrating" are drains (stop requested, leg
# checkpointing on its way out) that normally end in a requeue — but a leg
# can also win the race and finish (-> done) or die (-> quarantined).
_TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    "queued": ("admitted", "failed"),
    "admitted": ("running", "degraded", "failed"),
    "running": ("done", "failed", "queued", "quarantined",
                "preempting", "migrating"),
    "degraded": ("done", "failed", "queued", "quarantined",
                 "preempting", "migrating"),
    "preempting": ("queued", "done", "failed", "quarantined"),
    "migrating": ("queued", "done", "failed", "quarantined"),
    "done": (), "failed": (), "quarantined": (),
}

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")


def fleet_knobs_from_env(
    devices: Optional[int] = None,
    poison_attempts: Optional[int] = None,
) -> Dict[str, int]:
    """Resolve the fleet knobs: explicit values win, then the hatches
    (``MPI4DL_FLEET_DEVICES`` / ``MPI4DL_FLEET_POISON_ATTEMPTS``), then the
    defaults (8-device pool, quarantine after 2 failed supervisor runs) —
    the JAX package's precedence.  On cards the pool is bounded by the
    visible cards (:func:`fleet_pool`)."""
    return {
        "devices": int(
            devices if devices is not None
            else os.environ.get("MPI4DL_FLEET_DEVICES", "") or 8
        ),
        "poison_attempts": int(
            poison_attempts if poison_attempts is not None
            else os.environ.get("MPI4DL_FLEET_POISON_ATTEMPTS", "") or 2
        ),
    }


def visible_cards() -> List[str]:
    """The cards this process sees, without creating a CUDA context: the
    entries of ``CUDA_VISIBLE_DEVICES`` when it is set (empty: none), else
    one index per ``GPU`` line of ``nvidia-smi -L`` (none when it cannot
    run)."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is not None:
        return [t.strip() for t in raw.split(",") if t.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    n = sum(1 for line in out.splitlines() if line.startswith("GPU "))
    return [str(i) for i in range(n)]


def fleet_pool(devices: Optional[int] = None,
               device: str = "cuda") -> Tuple[int, List[str]]:
    """The pool size and, on cards, the visible cards it indexes (none on
    the CPU).  On the CPU: :func:`fleet_knobs_from_env`'s size (default 8).  On cards: the
    visible cards, lowered by ``devices`` or ``MPI4DL_FLEET_DEVICES``; a
    size above the visible cards raises, and so does no card at all (pass
    ``device="cpu"`` to run on gloo ranks) — never a silent drop to the
    CPU."""
    if device == "cpu":
        return fleet_knobs_from_env(devices)["devices"], []
    cards = visible_cards()
    if not cards:
        raise RuntimeError("no CUDA device is visible to the fleet; pass "
                           "device='cpu' to run its legs on gloo ranks")
    asked = devices if devices is not None else (
        os.environ.get("MPI4DL_FLEET_DEVICES", "") or None)
    n = len(cards) if asked is None else int(asked)
    if n > len(cards):
        raise ValueError(f"fleet pool of {n} devices exceeds the {len(cards)} "
                         f"visible cards {cards}")
    return n, cards


@dataclasses.dataclass(frozen=True)
class FleetJob:
    """One tenant: a training job with a preferred geometry and a priority.

    ``flags`` is the job's PREFERRED configuration — the scheduler may
    admit it degraded (planner ladder) when the pool is tight and will
    re-expand it toward these flags when devices free.  ``fault`` is a
    drill lever: injected into the first leg of the job's first supervisor
    launch (every launch with ``fault_every`` — the poison-job shape)."""

    id: str
    family: str
    flags: Mapping[str, Any]
    model: str = "resnet"
    priority: int = 0
    fault: str = ""
    fault_every: bool = False
    max_attempts: Optional[int] = None  # per-supervisor-run leg cap

    def __post_init__(self) -> None:
        if not _ID_RE.match(self.id):
            raise ValueError(
                f"fleet job id {self.id!r} must match {_ID_RE.pattern} "
                "(it namespaces filesystem paths and env vars)"
            )


class _JobRuntime:
    """Thread-safe drain plumbing for one live supervisor: the stop reason
    the supervisor polls between legs, and every rank's Popen to SIGTERM so
    an in-flight leg drains NOW instead of at its natural end (the ranks
    agree on one step boundary, checkpoint and exit 0)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stop = ""
        self._procs: List[Any] = []

    def register(self, proc: Any) -> None:
        """``on_spawn`` hook, once a rank: remember the live rank; if a stop
        raced the spawn, terminate it immediately (a rank SIGTERMed before
        its handler is installed exits -SIGTERM, and the launcher kills its
        peers waiting in the rendezvous after the grace)."""
        with self._lock:
            self._procs.append(proc)
            why = self._stop
        if why:
            self._terminate(proc)

    def stop_reason(self) -> str:
        with self._lock:
            return self._stop

    def request_stop(self, reason: str) -> None:
        with self._lock:
            if self._stop:
                return
            self._stop = reason
            procs = list(self._procs)
        for p in procs:
            self._terminate(p)

    @staticmethod
    def _terminate(proc: Any) -> None:
        try:
            if proc.poll() is None:
                proc.terminate()  # SIGTERM -> leg checkpoints + exits
        except OSError:
            pass  # already gone — exactly what a drain wants


@dataclasses.dataclass
class _JobState:
    """Scheduler-private per-job bookkeeping."""

    job: FleetJob
    order: int
    preferred: Dict[str, Any]
    current_flags: Dict[str, Any]
    state: str = "queued"
    current_env: Dict[str, str] = dataclasses.field(default_factory=dict)
    slice: Optional[Slice] = None
    runtime: Optional[_JobRuntime] = None
    launches: int = 0
    launched_t: float = 0.0
    failures: int = 0
    displaced: bool = False
    expanded: bool = False
    expanding: bool = False
    expand_wait_noted: bool = False
    result: Optional[SupervisorResult] = None
    error: str = ""


@dataclasses.dataclass
class FleetResult:
    """What one fleet run left behind: per-job outcomes, the full decision
    timeline (every ``fleet`` record), and the summary record payload."""

    ok: bool
    jobs: Dict[str, Dict[str, Any]]
    timeline: List[Dict[str, Any]]
    summary: Dict[str, Any]


class FleetScheduler:
    """Run N prioritized jobs concurrently on one bin-packed device pool.

    Thread model: ONE scheduler thread (the caller of :meth:`run`) owns all
    job state; worker threads and external triggers communicate only
    through ``self._events`` (a ``queue.Queue``) via :meth:`submit` /
    :meth:`shrink_pool` / :meth:`grow_pool` and the workers' exit events —
    so no job-state lock is needed.

    ``launcher_factory(family, model, workdir, *, job, on_spawn)`` is
    injectable for tests; the default is the real
    :func:`subprocess_leg_launcher` (rank sets).  ``probe`` is the planner
    feasibility probe used for degrade-admission AND expansion planning
    (``None`` = accept unprobed, recorded as such).  ``device`` is where
    the legs run: ``"cuda"`` (slices of the visible cards) or ``"cpu"``
    (gloo ranks); see :func:`fleet_pool`."""

    def __init__(self, workdir: str, *,
                 devices: Optional[int] = None,
                 poison_attempts: Optional[int] = None,
                 runlog=None,
                 probe: Optional[Callable[[Mapping[str, Any],
                                           Mapping[str, str]],
                                          Optional[float]]] = None,
                 budget_gb: Optional[float] = None,
                 seed: int = 0,
                 linger_s: float = 2.0,
                 launcher_factory=None,
                 device: str = "cuda",
                 log: Callable[[str], None] = lambda s: None):
        knobs = fleet_knobs_from_env(devices, poison_attempts)
        n, self.cards = fleet_pool(devices, device)
        self.device = device
        self.workdir = workdir
        self.pool: Tuple[int, ...] = tuple(range(n))
        self.poison_attempts = knobs["poison_attempts"]
        self.runlog = runlog
        self.probe = probe
        self.budget_gb = budget_gb
        self.seed = seed
        self.linger_s = linger_s
        self.launcher_factory = (
            launcher_factory if launcher_factory is not None
            else subprocess_leg_launcher
        )
        self.log = log
        self.timeline: List[Dict[str, Any]] = []
        self._events: "queue.Queue" = queue.Queue()
        self._jobs: Dict[str, _JobState] = {}
        self._threads: List[threading.Thread] = []
        self._order = 0
        self._launch_n = 0
        self._t0 = time.monotonic()

    # -- thread-safe external API (enqueue only) ---------------------------

    def submit(self, job: FleetJob) -> None:
        self._events.put(("submit", job))

    def shrink_pool(self, devices: int) -> None:
        """Fleet-level mesh_shrunk: the pool becomes devices [0, n)."""
        self._events.put(("shrink", int(devices)))

    def grow_pool(self, devices: int) -> None:
        """Devices freed/returned: the pool grows to [0, n)."""
        self._events.put(("grow", int(devices)))

    # -- main loop ---------------------------------------------------------

    def run(self, *, deadline_s: Optional[float] = None) -> FleetResult:
        """Schedule until every job is terminal (plus a ``linger_s`` grace
        for late trigger events), or the deadline aborts the fleet."""
        while True:
            self._drain_events(0.1)
            self._schedule()
            if self._all_terminal():
                if not self._drain_events(self.linger_s):
                    break
                continue
            if (deadline_s is not None
                    and time.monotonic() - self._t0 > deadline_s):
                self._abort(f"fleet deadline {deadline_s}s exceeded")
                break
        self._join_workers()
        return self._finish()

    def _all_terminal(self) -> bool:
        return all(js.state in TERMINAL_STATES
                   for js in self._jobs.values())

    def _drain_events(self, timeout: float) -> int:
        try:
            ev = self._events.get(timeout=timeout)
        except queue.Empty:
            return 0
        n = 0
        while True:
            n += 1
            self._handle_event(ev)
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                return n

    def _handle_event(self, ev: Tuple[Any, ...]) -> None:
        kind = ev[0]
        if kind == "submit":
            self._handle_submit(ev[1])
        elif kind == "exit":
            self._handle_exit(ev[1], ev[2], ev[3])
        elif kind == "shrink":
            self._handle_shrink(ev[1])
        elif kind == "grow":
            self._handle_grow(ev[1])

    def _handle_submit(self, job: FleetJob) -> None:
        if job.id in self._jobs:
            self._record("reject", job=job.id,
                         note="duplicate job id — already in the fleet")
            return
        js = _JobState(job=job, order=self._order,
                       preferred=dict(job.flags),
                       current_flags=dict(job.flags))
        self._order += 1
        self._jobs[job.id] = js
        self._record(
            "submit", job=job.id, priority=job.priority,
            family=job.family,
            need=required_devices(js.preferred, job.family),
        )

    def _handle_shrink(self, to: int) -> None:
        old = self.pool
        self.pool = tuple(range(max(0, to)))
        self._record("mesh_shrunk",
                     note=f"pool {len(old)} -> {len(self.pool)} devices")
        lost = set(old) - set(self.pool)
        for js in self._jobs.values():
            if js.slice is None:
                continue
            dead = [d for d in js.slice.devices if d in lost]
            if not dead:
                continue
            js.displaced = True
            self._record("displaced", job=js.job.id,
                         slice=js.slice.describe(), lost_devices=dead)
            if js.state in ("running", "degraded"):
                self._drain(js, "migrating",
                            f"slice lost devices {dead}")

    def _handle_grow(self, to: int) -> None:
        if to <= len(self.pool):
            return
        old = len(self.pool)
        self.pool = tuple(range(to))
        self._record("mesh_grown",
                     note=f"pool {old} -> {len(self.pool)} devices")

    def _handle_exit(self, job_id: str, res: Optional[SupervisorResult],
                     err: str) -> None:
        js = self._jobs.get(job_id)
        if js is None:
            return
        js.slice = None
        js.runtime = None
        if res is not None:
            js.result = res
        if err:
            js.error = err
            self._fail_or_requeue(js, f"supervisor crashed: {err}")
            return
        assert res is not None
        if res.stopped:
            self._transition(js, "queued", event="drained",
                             note=res.reason, attempts=res.attempts,
                             expanding=js.expanding)
            return
        if res.ok:
            final = res.final or {}
            self._transition(
                js, "done", event="done", attempts=res.attempts,
                launches=js.launches, loss=final.get("loss"),
                final_step=final.get("final_step"),
                start_step=final.get("start_step"),
                elastic=final.get("elastic"),
            )
            return
        self._fail_or_requeue(js, res.reason)

    def _fail_or_requeue(self, js: _JobState, why: str) -> None:
        """Poison containment: a failed supervisor RUN costs one strike;
        at ``poison_attempts`` strikes the job is quarantined so it cannot
        starve the queue with doomed relaunches."""
        js.failures += 1
        if js.failures >= self.poison_attempts:
            self._transition(
                js, "quarantined", event="quarantine",
                failures=js.failures,
                note=f"{js.failures} failed supervisor runs (>= "
                     f"MPI4DL_FLEET_POISON_ATTEMPTS="
                     f"{self.poison_attempts}): {why}",
            )
        else:
            self._transition(js, "queued", event="requeue",
                             failures=js.failures,
                             note=f"supervisor failed: {why}")

    # -- scheduling --------------------------------------------------------

    def _schedule(self) -> None:
        self._admit_queued()
        # Queued jobs get first claim on free devices; only an idle surplus
        # funds re-expansion.
        if not any(js.state == "queued" for js in self._jobs.values()):
            self._maybe_expand()

    def _free_devices(self) -> Tuple[int, ...]:
        held: set = set()
        for js in self._jobs.values():
            if js.slice is not None:
                held |= set(js.slice.devices)
        return tuple(sorted(set(self.pool) - held))

    def _queued(self) -> List[_JobState]:
        return sorted(
            (js for js in self._jobs.values() if js.state == "queued"),
            key=lambda js: (-js.job.priority, js.order),
        )

    def _admit_queued(self) -> None:
        for js in self._queued():
            draining = any(
                d.state in ("preempting", "migrating")
                for d in self._jobs.values()
            )
            free = self._free_devices()
            fam = js.job.family
            flags = dict(js.current_flags)
            env: Dict[str, str] = {}
            admit_info: Dict[str, Any] = {}

            # Upward first: a requeued degraded job re-expands toward its
            # preferred geometry as far as the free pool allows.
            if expand_candidates(flags, js.preferred, fam):
                eplan = plan_expand(
                    flags, js.preferred, fam, devices=len(free),
                    budget_gb=self.budget_gb, probe=self.probe,
                )
                if eplan is not None:
                    flags = dict(eplan.flags)
                    env.update(eplan.env)
                    admit_info.update(
                        expand_rungs=eplan.rungs, expand_delta=eplan.delta,
                        expand_probe=eplan.probe_evidence,
                    )

            need = required_devices(flags, fam)
            if need > len(free):
                if draining:
                    continue  # devices are already on their way back
                dplan = plan_degrade(
                    flags, fam, "mesh_shrunk",
                    budget_gb=self.budget_gb, probe=self.probe,
                    evidence={"shrunk_spec": f"devices={len(free)}"},
                )
                if dplan is None:
                    if not self._maybe_preempt_for(js) and \
                            self._unschedulable(js):
                        self._transition(
                            js, "failed", event="unschedulable",
                            note=f"needs {need} devices; the whole "
                                 f"{len(self.pool)}-device pool cannot fit "
                                 "any ladder geometry",
                        )
                    continue
                flags = dict(dplan.flags)
                env.update(dplan.env)
                need = required_devices(flags, fam)
                admit_info.update(
                    degrade_rungs=dplan.rungs, degrade_delta=dplan.delta,
                    degrade_probe=dplan.probe_evidence,
                    degrade_note=dplan.note,
                )

            packed = pack([Request(js.job.id, need, js.job.priority)], free)
            if js.job.id in packed.unplaced:
                continue  # cannot happen (need <= len(free)); stay queued
            js.current_flags = flags
            js.current_env.update(env)
            js.slice = packed.placed[js.job.id]
            degraded_now = bool(expand_candidates(flags, js.preferred, fam))
            expanded_now = bool(admit_info.get("expand_rungs"))
            if js.expanding and expanded_now:
                js.expanded = True
            js.expanding = False
            self._transition(
                js, "admitted", event="admit",
                slice=js.slice.describe(), devices=need,
                degraded=degraded_now, expanded=expanded_now, **admit_info,
            )
            self._launch(js, degraded_now)

    def _unschedulable(self, js: _JobState) -> bool:
        """True when not even the FULL pool could fit this job at any
        ladder geometry — a spec error, failed loudly instead of queued
        forever."""
        fam = js.job.family
        if required_devices(js.current_flags, fam) <= len(self.pool):
            return False
        return plan_degrade(
            js.current_flags, fam, "mesh_shrunk",
            evidence={"shrunk_spec": f"devices={len(self.pool)}"},
        ) is None

    def _min_devices(self, flags: Mapping[str, Any], family: str) -> int:
        need = required_devices(flags, family)
        for cand in degrade_candidates(flags, family):
            need = min(need, required_devices(cand.flags, family))
        return need

    def _maybe_preempt_for(self, js: _JobState) -> bool:
        """Drain lower-priority tenants until the arrival's PREFERRED
        demand is projected-covered (already-draining slices count), as
        long as at least its minimum ladder geometry will fit.  Victims:
        lowest priority first, newest first among equals."""
        fam = js.job.family
        projected = len(self._free_devices()) + sum(
            len(v.slice) for v in self._jobs.values()
            if v.state in ("preempting", "migrating") and v.slice is not None
        )
        need_pref = required_devices(js.preferred, fam)
        victims = sorted(
            (v for v in self._jobs.values()
             if v.state in ("running", "degraded")
             and v.job.priority < js.job.priority and v.slice is not None),
            key=lambda v: (v.job.priority, -v.order),
        )
        chosen: List[_JobState] = []
        for v in victims:
            if projected >= need_pref:
                break
            chosen.append(v)
            projected += len(v.slice)
        if not chosen or projected < self._min_devices(js.preferred, fam):
            return False
        for v in chosen:
            self._record("preempt", job=v.job.id, by=js.job.id,
                         victim_priority=v.job.priority,
                         arrival_priority=js.job.priority,
                         slice=v.slice.describe())
            v.displaced = True
            self._drain(v, "preempting",
                        f"preempted by higher-priority job {js.job.id!r}")
        return True

    def _resumable_since_launch(self, js: _JobState) -> bool:
        """True once the job has checkpointed SINCE its current launch —
        the earliest point a drain-to-expand can elastic-restore from
        without discarding this leg's compile + progress.  (Old
        checkpoints from previous legs don't count: restoring one would
        lose everything this launch did.)"""
        ck = os.path.join(self.workdir, "jobs", js.job.id, "ck")
        try:
            entries = list(os.scandir(ck))
        except OSError:
            return False
        return any(
            _CKPT_STEP_RE.match(e.name)
            and e.stat().st_mtime > js.launched_t
            for e in entries
        )

    def _maybe_expand(self) -> None:
        """Re-expand degraded jobs onto idle devices.  Only upward moves
        that NEED new devices justify a drain-and-relaunch; device-neutral
        restores (e.g. un-striping) ride along when one happens.  A job
        that has not checkpointed at its CURRENT geometry yet is deferred:
        migrating it would throw away the leg's compile work and leave
        nothing new to elastic-restore from."""
        free = self._free_devices()
        if not free:
            return
        for js in sorted(
            (j for j in self._jobs.values()
             if j.state == "degraded" and j.slice is not None),
            key=lambda j: (-j.job.priority, j.order),
        ):
            if not self._resumable_since_launch(js):
                if not js.expand_wait_noted:
                    js.expand_wait_noted = True
                    self._record(
                        "expand_deferred", job=js.job.id,
                        note="no checkpoint at the current geometry yet — "
                             "expansion waits for a resumable point",
                    )
                continue
            plan = plan_expand(
                js.current_flags, js.preferred, js.job.family,
                devices=len(free) + len(js.slice),
                budget_gb=self.budget_gb, probe=self.probe,
            )
            if plan is None:
                continue
            if required_devices(plan.flags, js.job.family) <= len(js.slice):
                continue
            js.expanding = True
            self._record("expand_planned", job=js.job.id, rungs=plan.rungs,
                         delta=plan.delta, probe=plan.probe_evidence,
                         note=plan.note,
                         devices=len(free) + len(js.slice))
            self._drain(js, "migrating", "re-expansion onto freed devices")
            free = self._free_devices()

    def _drain(self, js: _JobState, state: str, reason: str) -> None:
        self._transition(js, state, event="drain", note=reason)
        if js.runtime is not None:
            js.runtime.request_stop(reason)

    # -- launching ---------------------------------------------------------

    def _launch(self, js: _JobState, degraded_now: bool) -> None:
        from mpi4dl_tpu_torch.obs import RunLog

        assert js.slice is not None
        js.launches += 1
        js.launched_t = time.time()
        js.expand_wait_noted = False
        self._launch_n += 1
        legdir = os.path.join(self.workdir, "legs",
                              f"launch{self._launch_n:03d}")
        jobdir = os.path.join(self.workdir, "jobs", js.job.id)
        os.makedirs(jobdir, exist_ok=True)
        rt = _JobRuntime()
        js.runtime = rt
        inner = self.launcher_factory(
            js.job.family, js.job.model, legdir,
            job=js.job.id, on_spawn=rt.register,
        )
        fleet_env = {**slice_env(js.slice, self.device, self.cards),
                     **js.current_env}

        def launch(flags: Mapping[str, Any], env_extra: Mapping[str, str],
                   attempt: int):
            env = dict(fleet_env)
            env.update(env_extra)
            return inner(flags, env, attempt)

        flags = dict(js.current_flags)
        # The checkpoint dir is pinned per JOB, not per launch: it is the
        # thread of continuity a drain/migrate/re-expand resumes from.
        flags["checkpoint-dir"] = os.path.join(jobdir, "ck")
        if self.device == "cpu":
            flags["device"] = "cpu"
        runlog = RunLog(os.path.join(
            jobdir, f"supervisor{js.launches:02d}.jsonl"))
        fault = js.job.fault if (
            js.launches == 1 or js.job.fault_every) else ""
        sup = Supervisor(
            js.job.family, js.job.model, flags,
            workdir=legdir, runlog=runlog, launch=launch,
            probe=self.probe, budget_gb=self.budget_gb,
            max_attempts=js.job.max_attempts,
            seed=self.seed, fault=fault, job=js.job.id,
            stop=rt.stop_reason, log=self.log,
        )
        self._transition(
            js, "degraded" if degraded_now else "running",
            event="launch", launch=js.launches,
            slice=js.slice.describe(), workdir=legdir,
            fault=fault or None, env=dict(fleet_env),
            geometry={k: flags[k] for k in (
                "num-spatial-parts", "slice-method", "parts", "split-size",
                "spatial-until", "stripe-bwd") if k in flags},
        )
        th = threading.Thread(
            target=self._worker, args=(js.job.id, sup, runlog),
            name=f"fleet-{js.job.id}-{js.launches}", daemon=True,
        )
        self._threads.append(th)
        th.start()

    def _worker(self, job_id: str, sup: Supervisor, runlog) -> None:
        err = ""
        res: Optional[SupervisorResult] = None
        try:
            res = sup.run()
        except Exception as e:  # noqa: BLE001
            err = repr(e)  # surfaced as a typed fleet record by _handle_exit
        finally:
            try:
                runlog.close()
            except OSError:
                pass  # the records already flushed line-by-line
        self._events.put(("exit", job_id, res, err))

    def _join_workers(self) -> None:
        for th in self._threads:
            th.join(timeout=10.0)

    # -- shutdown + records ------------------------------------------------

    def _abort(self, why: str) -> None:
        self._record("timeout", note=why)
        for js in self._jobs.values():
            if js.state not in TERMINAL_STATES and js.runtime is not None:
                js.runtime.request_stop(why)
        t_end = time.monotonic() + 30.0
        while time.monotonic() < t_end and not self._all_terminal():
            if not self._drain_events(0.2):
                if all(not th.is_alive() for th in self._threads):
                    break
        for js in self._jobs.values():
            if js.state not in TERMINAL_STATES:
                old = js.state
                js.state = "failed"  # forced: deadline overrides legality
                self._record("force_failed", job=js.job.id, state_from=old,
                             state_to="failed", note=why)

    def _transition(self, js: _JobState, new: str, *, event: str,
                    **details: Any) -> None:
        old = js.state
        if new not in _TRANSITIONS.get(old, ()):
            raise RuntimeError(
                f"illegal fleet transition {old!r} -> {new!r} for job "
                f"{js.job.id!r} (event {event!r})"
            )
        js.state = new
        self._record(event, job=js.job.id, state_from=old, state_to=new,
                     **details)

    def _record(self, event: str, **details: Any) -> None:
        rec = {"event": event,
               "t": round(time.monotonic() - self._t0, 3), **details}
        self.timeline.append(rec)
        if self.runlog is not None:
            self.runlog.write("fleet", **rec)
        jid = details.get("job")
        note = details.get("note")
        self.log("[fleet] " + event + (f" job={jid}" if jid else "")
                 + (f": {note}" if note else ""))

    def _finish(self) -> FleetResult:
        jobs: Dict[str, Dict[str, Any]] = {}
        for jid in sorted(self._jobs):
            js = self._jobs[jid]
            final = (js.result.final if js.result is not None else None) or {}
            jobs[jid] = {
                "state": js.state,
                "priority": js.job.priority,
                "launches": js.launches,
                "failures": js.failures,
                "displaced": js.displaced,
                "expanded": js.expanded,
                "degraded": bool(expand_candidates(
                    js.current_flags, js.preferred, js.job.family)),
                "final_flags": dict(js.current_flags),
                "final_env": dict(js.current_env),
                "loss": final.get("loss"),
                "final_step": final.get("final_step"),
                "start_step": final.get("start_step"),
                "elastic": final.get("elastic"),
                "fleet_job_tag": final.get("fleet_job"),
                "error": js.error or (
                    js.result.reason
                    if js.result is not None and not js.result.ok else ""),
            }
        ok = bool(
            self._all_terminal()
            and not any(js.state == "failed" for js in self._jobs.values())
        )
        summary = {
            "ok": ok,
            "jobs": {j: jobs[j]["state"] for j in jobs},
            "pool": len(self.pool),
            "events": len(self.timeline),
        }
        if self.runlog is not None:
            self.runlog.write("fleet_summary", **summary)
        return FleetResult(ok=ok, jobs=jobs, timeline=list(self.timeline),
                           summary=summary)


# ---------------------------------------------------------------------------
# Fleet chaos drills (``drill --fleet``)
# ---------------------------------------------------------------------------


# Same small geometry the supervisor drills use: 2-step epochs, boundary
# checkpoints at steps 0/2/4..., tractable on gloo ranks.
_FLEET_BASE: Dict[str, Any] = {
    "image-size": 32, "num-layers": 1, "batch-size": 4,
    "steps-per-epoch": 2, "num-epochs": 2,
}

# The port's checkpoint names (``checkpoint.py``): a sharded checkpoint is
# the directory ``ckpt_<step>/``, published by one atomic rename of a hidden
# ``.tmp_ckpt_*`` directory, and a single-file one ``ckpt_<step>.npz``.
# Hidden ``.tmp_ckpt_*`` / ``.old_ckpt_*`` entries never match, so on ranks
# a checkpoint counts only once it is published.
_CKPT_STEP_RE = re.compile(r"^ckpt_(\d+)(?:\.npz)?$")


def _latest_ckpt_step(ck_dir: str) -> int:
    """Newest completed checkpoint step in a job's pinned checkpoint dir
    (-1 when none) — what the drill triggers watch so a chaos event fires
    only once the victim has real, resumable progress."""
    best = -1
    try:
        names = os.listdir(ck_dir)
    except OSError:
        return best
    for name in names:
        m = _CKPT_STEP_RE.match(name)
        if m:
            best = max(best, int(m.group(1)))
    return best


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """One scripted fleet disaster with declarative expectations.

    ``trigger(sched)`` fires once job ``trigger_after``'s checkpoint
    reaches ``trigger_min_step`` (so drains always have a resumable
    checkpoint behind them).  Expectation fields map to typed verdicts:
    ``expect_done`` -> ``not_recovered``, ``expect_quarantined`` ->
    ``not_quarantined``, ``expect_displaced``/``expect_untouched`` ->
    ``fault_not_honored``, ``expect_expanded`` -> ``no_expansion``,
    ``require_elastic``/``expect_resumed`` -> ``fresh_start``,
    ``verify_loss`` -> ``drift`` (solo control at the job's FINAL
    geometry), ``expect_desynced_backoff`` -> ``retry_storm``, and every
    scenario checks job-namespaced evidence (-> ``contaminated``)."""

    name: str
    pool: int
    jobs: Tuple[FleetJob, ...]
    trigger: Optional[Callable[[FleetScheduler], None]] = None
    trigger_after: str = ""
    trigger_min_step: int = 2
    deadline_s: float = 1500.0
    probe: bool = False
    expect_done: Tuple[str, ...] = ()
    expect_quarantined: Tuple[str, ...] = ()
    expect_displaced: Tuple[str, ...] = ()
    expect_untouched: Tuple[str, ...] = ()
    expect_expanded: Tuple[str, ...] = ()
    expect_resumed: Tuple[str, ...] = ()   # final leg restored step >= 2
    require_elastic: Tuple[str, ...] = ()  # geometry-changed restore
    verify_loss: Tuple[str, ...] = ()
    expect_desynced_backoff: Tuple[str, ...] = ()
    rtol: float = 0.05


def fleet_scenarios() -> List[FleetScenario]:
    """The fleet chaos matrix: the JAX package's, scenario for scenario
    (names, pools, jobs, triggers, expectations).

    Geometries: plain-SP jobs whose preferred config already pins
    ``spatial-until auto`` so the degrade/expand ladder between preferred
    and 2-device survival is exactly {stripe_bwd, shrink_sp} — every rung
    elastic-proven by the drill and supervisor matrices.  The jobs carry no
    ``device`` flag: the scheduler runs every leg with ``--device cpu``
    when it runs on the CPU."""
    sp4 = {**_FLEET_BASE, "num-spatial-parts": "4", "slice-method": "square"}
    elastic4 = {**_FLEET_BASE, "num-spatial-parts": "4",
                "slice-method": "horizontal", "spatial-until": "auto"}
    return [
        # Slice loss: nomad's slice loses devices 6-7; it drains,
        # re-admits degraded onto what is free, elastic-restores, and — if
        # keeper finishes first — re-expands onto keeper's devices.
        FleetScenario(
            "fleet_slice_kill", pool=8,
            jobs=(
                FleetJob("keeper", "sp", {**sp4, "num-epochs": 6},
                         priority=1),
                # Enough epochs that the degraded leg checkpoints at its
                # shrunk geometry with steps to spare — the re-expansion
                # drain needs a real window to land in.
                FleetJob("nomad", "sp", {**elastic4, "num-epochs": 6},
                         priority=0),
            ),
            trigger_after="nomad",
            trigger=lambda s: s.shrink_pool(6),
            expect_done=("keeper", "nomad"),
            expect_displaced=("nomad",),
            expect_untouched=("keeper",),
            require_elastic=("nomad",),
            verify_loss=("nomad",),
        ),
        # Priority preemption: two high-priority arrivals storm a full
        # pool; the low-priority tenant drains at a checkpoint, waits, and
        # resumes at its preferred geometry with no lost progress.
        FleetScenario(
            "fleet_preempt_storm", pool=4,
            jobs=(FleetJob("lo", "sp", {**sp4, "num-epochs": 4},
                           priority=0),),
            trigger_after="lo",
            trigger=lambda s: (
                s.submit(FleetJob("hi1", "sp", dict(sp4), priority=10)),
                s.submit(FleetJob("hi2", "sp", dict(sp4), priority=9)),
            )[0],
            expect_done=("lo", "hi1", "hi2"),
            expect_displaced=("lo",),
            expect_resumed=("lo",),
            verify_loss=("lo",),
        ),
        # Crash cascade: two tenants hit the same transient-I/O fault at
        # the same step; per-(job, attempt) jitter must de-synchronize
        # their retry backoffs (no thundering herd on shared I/O).
        FleetScenario(
            "fleet_crash_cascade", pool=8,
            jobs=(
                FleetJob("alpha", "sp", dict(sp4), fault="io_error@2"),
                FleetJob("beta", "sp", dict(sp4), fault="io_error@2"),
            ),
            expect_done=("alpha", "beta"),
            expect_untouched=("alpha", "beta"),
            expect_desynced_backoff=("alpha", "beta"),
        ),
        # Poison job: compile-OOMs on EVERY launch and its family has no
        # degrade ladder — quarantined after the attempt budget, while the
        # steady tenant is never starved.
        FleetScenario(
            "fleet_oom_poison", pool=8,
            jobs=(
                FleetJob("poison", "lp",
                         {**_FLEET_BASE, "split-size": 2, "parts": 1},
                         priority=5, fault="oom_compile@0",
                         fault_every=True),
                FleetJob("steady", "sp", dict(sp4), priority=0),
            ),
            expect_done=("steady",),
            expect_quarantined=("poison",),
            expect_untouched=("steady",),
        ),
        # Re-expansion: admitted degraded into a 2-device pool, then the
        # pool grows and the job must expand back to its preferred
        # geometry from the same elastic checkpoint (probe-gated).
        FleetScenario(
            "fleet_reexpand", pool=2,
            # The expansion is probe-gated (a compile-only subprocess probe
            # runs inside the scheduler loop before the drain), and
            # post-compile steps are near-instant at this size — so
            # the drain window is held open by a slow_step straggle after
            # the first checkpoint, not by piling on epochs.  The SIGTERM
            # lands mid-straggle and the leg drains at the next step
            # boundary; the straggle is loss-neutral.
            jobs=(FleetJob("sprout", "sp", {**elastic4, "num-epochs": 4},
                           fault="slow_step@2:45"),),
            trigger_after="sprout",
            trigger=lambda s: s.grow_pool(8),
            # Fire on the FIRST checkpoint (step 0, written right after
            # compile): the whole run is the drain window, and the
            # scheduler's resumable-point gate already guarantees the
            # expansion waits for that checkpoint.
            trigger_min_step=0,
            probe=True,
            expect_done=("sprout",),
            expect_expanded=("sprout",),
            require_elastic=("sprout",),
            verify_loss=("sprout",),
        ),
    ]


def _start_trigger(ck_dir: str, min_step: int, fire: Callable[[], None],
                   stop_ev: threading.Event) -> threading.Thread:
    def body() -> None:
        while not stop_ev.wait(0.25):
            if _latest_ckpt_step(ck_dir) >= min_step:
                fire()
                return

    th = threading.Thread(target=body, daemon=True, name="fleet-trigger")
    th.start()
    return th


def _supervisor_records(wd: str, job_id: str) -> List[Dict[str, Any]]:
    from mpi4dl_tpu_torch.obs.runlog import read_runlog

    out: List[Dict[str, Any]] = []
    jobdir = os.path.join(wd, "jobs", job_id)
    try:
        names = sorted(n for n in os.listdir(jobdir)
                       if n.startswith("supervisor") and n.endswith(".jsonl"))
    except OSError:
        return out
    for name in names:
        try:
            out.extend(read_runlog(os.path.join(jobdir, name)))
        except OSError:
            continue  # a missing/partial log just yields no records
    return out


def _contamination_problems(wd: str,
                            res: FleetResult) -> List[str]:
    """Zero cross-job evidence contamination: every completed job's final
    leg summary must carry ITS OWN ``fleet_job`` tag, and every launch
    workdir must contain only its owning job's namespace."""
    problems: List[str] = []
    for jid, j in res.jobs.items():
        if j["state"] == "done" and j.get("fleet_job_tag") != jid:
            problems.append(
                f"job {jid!r}: final leg summary tagged "
                f"{j.get('fleet_job_tag')!r}, expected {jid!r}"
            )
    for rec in res.timeline:
        if rec.get("event") != "launch":
            continue
        legdir = rec.get("workdir") or ""
        try:
            children = sorted(
                e.name for e in os.scandir(legdir) if e.is_dir())
        except OSError:
            continue  # launch that never spawned a leg
        if children and children != [rec.get("job")]:
            problems.append(
                f"launch workdir {legdir!r} owned by {rec.get('job')!r} "
                f"contains {children!r}"
            )
    return problems


def run_fleet_scenario(
    sc: FleetScenario, workdir: str,
    log: Callable[[str], None] = lambda s: None,
    launcher_factory=None,
    device: str = "cuda",
) -> DrillVerdict:
    """Execute one fleet scenario and judge the whole control plane.

    ``device`` is the scheduler's (:class:`FleetScheduler`); the solo
    control of a ``verify_loss`` job runs on the pool's first devices at
    the job's final geometry, under the same slice environment a fleet leg
    of that size gets.  Its loss rides the details as
    ``control_loss_<job>`` beside ``final_loss_<job>``."""
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.resilience.planner import compile_probe

    wd = os.path.join(workdir, sc.name)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd, exist_ok=True)
    details: Dict[str, Any] = {"pool": sc.pool,
                               "jobs": [j.id for j in sc.jobs]}
    probe = None
    if sc.probe and sc.jobs:
        probe = compile_probe(sc.jobs[0].family, sc.jobs[0].model, log=log)
    fleet_log = RunLog(os.path.join(wd, "fleet.jsonl"))
    stop_ev = threading.Event()
    try:
        sched = FleetScheduler(
            wd, devices=sc.pool, runlog=fleet_log, probe=probe, log=log,
            launcher_factory=launcher_factory, device=device,
        )
    except Exception:
        fleet_log.close()
        raise
    for j in sc.jobs:
        sched.submit(j)
    trig: Optional[threading.Thread] = None
    if sc.trigger is not None and sc.trigger_after:
        ck = os.path.join(wd, "jobs", sc.trigger_after, "ck")
        fire = sc.trigger
        trig = _start_trigger(ck, sc.trigger_min_step,
                              lambda: fire(sched), stop_ev)
    try:
        res = sched.run(deadline_s=sc.deadline_s)
    except Exception as e:  # noqa: BLE001 — a scheduler crash IS a verdict
        return DrillVerdict(sc.name, False, "leg_error",
                            {**details, "error": repr(e)})
    finally:
        stop_ev.set()
        if trig is not None:
            trig.join(timeout=2.0)
        fleet_log.close()

    details["jobs_final"] = {
        jid: {k: j.get(k) for k in (
            "state", "launches", "failures", "displaced", "expanded",
            "degraded", "loss", "start_step", "elastic")}
        for jid, j in res.jobs.items()
    }

    for jid in sc.expect_done:
        st = res.jobs.get(jid, {}).get("state")
        if st != "done":
            return DrillVerdict(
                sc.name, False, "not_recovered",
                {**details, "reason": f"job {jid!r} ended {st!r} "
                                      f"(expected done): "
                                      f"{res.jobs.get(jid, {}).get('error')}"},
            )
    for jid in sc.expect_quarantined:
        st = res.jobs.get(jid, {}).get("state")
        if st != "quarantined":
            return DrillVerdict(
                sc.name, False, "not_quarantined",
                {**details, "reason": f"job {jid!r} ended {st!r}, expected "
                                      "quarantined containment"},
            )
    for jid in sc.expect_displaced:
        if not res.jobs.get(jid, {}).get("displaced"):
            return DrillVerdict(
                sc.name, False, "fault_not_honored",
                {**details,
                 "reason": f"job {jid!r} was never displaced/preempted"},
            )
    for jid in sc.expect_untouched:
        j = res.jobs.get(jid, {})
        if j.get("displaced") or j.get("launches") != 1:
            return DrillVerdict(
                sc.name, False, "fault_not_honored",
                {**details,
                 "reason": f"job {jid!r} should have run untouched "
                           f"(displaced={j.get('displaced')}, "
                           f"launches={j.get('launches')})"},
            )
    for jid in sc.expect_expanded:
        j = res.jobs.get(jid, {})
        if not j.get("expanded"):
            return DrillVerdict(
                sc.name, False, "no_expansion",
                {**details, "reason": f"job {jid!r} never re-expanded onto "
                                      "freed devices"},
            )
        if j.get("degraded"):
            return DrillVerdict(
                sc.name, False, "no_expansion",
                {**details, "reason": f"job {jid!r} finished still degraded "
                                      f"({j.get('final_flags')})"},
            )
    for jid in sc.require_elastic:
        if not res.jobs.get(jid, {}).get("elastic"):
            return DrillVerdict(
                sc.name, False, "fresh_start",
                {**details, "reason": f"job {jid!r} final leg did not "
                                      "elastic-restore across geometries"},
            )
    for jid in sc.expect_resumed:
        start = res.jobs.get(jid, {}).get("start_step")
        if int(start or 0) < 2:
            return DrillVerdict(
                sc.name, False, "fresh_start",
                {**details, "reason": f"job {jid!r} resumed from step "
                                      f"{start!r} — progress was lost"},
            )

    if sc.expect_desynced_backoff:
        seqs: Dict[str, List[float]] = {}
        for jid in sc.expect_desynced_backoff:
            seqs[jid] = [
                r["backoff_s"] for r in _supervisor_records(wd, jid)
                if r.get("kind") == "supervisor"
                and r.get("backoff_s") is not None
            ]
        details["backoff_s"] = seqs
        a, b = (seqs[j] for j in sc.expect_desynced_backoff[:2])
        if not a or not b:
            return DrillVerdict(
                sc.name, False, "retry_storm",
                {**details, "reason": "expected backoff incidents on both "
                                      "jobs, got none on at least one"},
            )
        if a == b:
            return DrillVerdict(
                sc.name, False, "retry_storm",
                {**details, "reason": f"identical backoff sequences {a} — "
                                      "concurrent retries are synchronized"},
            )

    problems = _contamination_problems(wd, res)
    if problems:
        return DrillVerdict(sc.name, False, "contaminated",
                            {**details, "problems": problems})

    by_id = {j.id: j for j in sc.jobs}
    factory = (launcher_factory if launcher_factory is not None
               else subprocess_leg_launcher)
    for jid in sc.verify_loss:
        j = res.jobs[jid]
        loss = j.get("loss")
        if loss is None or not math.isfinite(float(loss)):
            return DrillVerdict(
                sc.name, False, "not_recovered",
                {**details, "reason": f"job {jid!r}: non-finite final loss "
                                      f"{loss!r}"},
            )
        job = by_id[jid]
        control_flags = dict(j["final_flags"])
        control_flags["checkpoint-dir"] = os.path.join(
            wd, f"ck_control_{jid}")
        if device == "cpu":
            control_flags["device"] = "cpu"
        env = dict(j["final_env"])
        need = required_devices(j["final_flags"], job.family)
        env.update(slice_env(Slice(tuple(range(need))), device, sched.cards))
        log(f"[{sc.name}] solo control for {jid} at its final geometry...")
        out = factory(
            job.family, job.model, os.path.join(wd, f"control_{jid}"),
            job=f"control-{jid}", on_spawn=None,
        )(control_flags, env, 1)
        if out.rc != 0 or not out.result:
            return DrillVerdict(
                sc.name, False, "leg_error",
                {**details, "leg": f"control:{jid}",
                 "error": f"rc={out.rc}"},
            )
        closs = out.result.get("loss")
        details[f"control_loss_{jid}"] = closs
        details[f"final_loss_{jid}"] = loss
        if closs is None or not _close(float(loss), float(closs), sc.rtol):
            return DrillVerdict(
                sc.name, False, "drift",
                {**details,
                 "reason": f"job {jid!r} loss {loss!r} not within "
                           f"rtol={sc.rtol} of solo control {closs!r}"},
            )
    return DrillVerdict(sc.name, True, "verified_recovery", details)


def run_fleet_drills(
    scenarios: Sequence[FleetScenario], workdir: str, runlog=None,
    log: Callable[[str], None] = lambda s: None,
    launcher_factory=None,
    device: str = "cuda",
) -> List[DrillVerdict]:
    """Run the fleet scenario matrix; one ``drill`` record per verdict plus
    a ``drill_summary`` (same vocabulary as the single-leg and supervisor
    matrices, so
    ``obs report`` renders all three)."""
    verdicts = []
    for sc in scenarios:
        v = run_fleet_scenario(sc, workdir, log=log,
                               launcher_factory=launcher_factory,
                               device=device)
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
