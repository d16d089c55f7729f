"""The elastic supervisor (counterpart of
``mpi4dl_tpu/resilience/supervisor.py``): the crash marker and quarantine
list the training loop honours, the typed failure taxonomy, the per-class
recovery policies and the supervisor that relaunches a job as a sequence
of legs.

The loop leaves structured last words when an exception escapes it (or the
watchdog escalates): the crash marker, a small JSON file at the path the
``MPI4DL_CRASH_MARKER`` hatch names, with the phase the loop died in
(``init``, ``fetch``, ``compile`` for the process's first step, ``step``,
``save``, ``loop``), the global step, the error and its base classes — so
a supervisor can classify the failure without parsing tracebacks.  The
marker's schema is the JAX package's (``MARKER_SCHEMA``); a marker written
by either package reads in the other.

Ranks.  Every rank of a job runs the loop and may die on its own; rank 0
writes its marker at the hatch's path and rank r > 0 at
``<path>.rank<r>``, so the ranks never race on one file
(:func:`rank_path`).  The rank is the default process group's when one is
initialized, else ``RANK`` from the environment, else 0.

``MPI4DL_QUARANTINE_STEPS`` (a comma-separated list of global steps) names
steps the loop skips outright: the supervisor sets it to the anomalous
steps of a run the anomaly guard failed fast on before relaunching it.

Every leg exit is classified into the JAX package's taxonomy from four
evidence sources (the crash marker, the leg's RunLog tail, the exit status
and the flight recorder's dump) and answered with the class's policy:

=================  =========================================================
``oom_compile``    out of memory during the leg's FIRST step (allocator
                   warm-up, kernel builds, cuBLAS workspaces) → **degrade**:
                   the planner re-plans a feasible geometry and the
                   relaunched leg elastic-restores onto it
``oom_step``       out of memory on a later step → **degrade**
``mesh_shrunk``    the device set shrank → **degrade** within the
                   surviving device budget
``nan_cluster``    the anomaly guard failed fast (``AnomalyError``) →
                   **quarantine** the anomalous steps in the relaunch
``hang``           watchdog escalation (exit 82) or SIGKILL → bounded
                   **retry** with backoff
``preempted``      a clean exit with ``preempted`` in the leg's result, or
                   SIGTERM → immediate **resume**
``lost_shard``     restore rejected a checkpoint for vanished shard files →
                   bounded **retry**
``transient_io``   ``OSError`` family / background checkpoint-write failure
                   → bounded **retry** with exponential backoff + jitter
``unknown``        anything else → one **retry**, then fail loudly
=================  =========================================================

Every decision writes a ``supervisor`` RunLog incident record (class,
evidence, policy, attempt, config delta), the JAX package's schema, which
``python -m mpi4dl_tpu_torch.obs report`` renders as an incident timeline.

Legs are rank sets (the port's own point: a JAX leg is one process).
:func:`subprocess_leg_launcher` starts ``required_devices(flags, family)``
processes of ``python -m mpi4dl_tpu_torch.resilience leg`` itself, with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and the
``MASTER_PORT`` of a rendezvous store this process serves for each attempt
(the ``env://`` rendezvous of ``mesh.initialize_distributed``, every rank
a client of the store), not through ``torchrun``, which folds
every rank's exit status into its own: the classifier needs the real one
(82 for a watchdog escalation, −SIGKILL, −SIGTERM).  When a rank exits
non-zero, the launcher SIGKILLs the others after a short grace (never
SIGTERM: the preemption handler would start a collective save with a dead
peer).  The leg's exit code, crash marker and flight dump are those of the
rank that failed first, and every rank's exit code and marker class ride
the evidence as ``ranks``, so that one rank's OOM is not reported as the
``hang`` of its stuck peers.

Fleet hooks (the JAX package's, over rank sets): ``job=`` namespaces every
attempt as ``workdir/<job>/attempt<N>/`` and stamps ``MPI4DL_FLEET_JOB``
into every rank (the leg tags its result with ``fleet_job``);
``on_spawn(proc)`` is called for every rank's process the moment it
starts, so a drain can SIGTERM the whole rank set; the launcher refuses a
leg needing more ranks than ``MPI4DL_FLEET_SLICE_DEVICES`` allows.  The
supervisor polls ``stop()`` between legs: a leg that ends while a stop is
pending (drained at a step boundary, or SIGTERMed before its ranks
rendezvoused) ends the run with ``stopped=True`` and no incident.

The supervisor process itself never initializes CUDA: a context on card 0
would take memory from rank 0's leg.

Knobs: ``MPI4DL_SUPERVISE_MAX_ATTEMPTS`` (total leg launches, default 6),
``MPI4DL_SUPERVISE_BACKOFF`` (base seconds, default 1.0),
``MPI4DL_SUPERVISE_BACKOFF_CAP`` (default 30).  CLI::

    python -m mpi4dl_tpu_torch.resilience supervise --family sp --out sup \\
        -- --image-size 32 --num-layers 1 --batch-size 4 --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from mpi4dl_tpu_torch.resilience.watchdog import HANG_EXIT_CODE

FAILURE_CLASSES = (
    "oom_compile", "oom_step", "nan_cluster", "hang", "preempted",
    "lost_shard", "mesh_shrunk", "transient_io", "unknown",
)

MARKER_SCHEMA = 1

# Substrings that identify a device OOM in an error repr or a stderr tail:
# the JAX package's.  ``RESOURCE_EXHAUSTED`` is the XLA status code the
# synthetic fault carries; the CUDA caching allocator's
# ``torch.OutOfMemoryError`` says "CUDA out of memory. Tried to allocate
# ...".
_OOM_PATTERNS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def process_rank() -> int:
    """This process's rank: the default process group's, else ``RANK``."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001  # analysis: ok(swallow-except) — no usable
        # distributed runtime: fall back to RANK below
        pass
    try:
        return int(os.environ.get("RANK", "0") or 0)
    except ValueError:
        return 0


def rank_path(path: str, rank: Optional[int] = None) -> str:
    """``path`` for rank 0, ``<path>.rank<r>`` for rank r > 0."""
    r = process_rank() if rank is None else int(rank)
    return path if r == 0 else f"{path}.rank{r}"


def crash_marker_path() -> Optional[str]:
    """Where this process should write its crash marker: the
    ``MPI4DL_CRASH_MARKER`` hatch, per rank (:func:`rank_path`)."""
    path = os.environ.get("MPI4DL_CRASH_MARKER") or None
    return rank_path(path) if path else None


def write_crash_marker(path: str, *, phase: str, gstep: int = -1,
                       steps_run: int = -1,
                       error: Optional[BaseException] = None,
                       failure_class: Optional[str] = None,
                       **extra: Any) -> None:
    """Write the structured crash marker — atomically (tmp + rename), and
    NEVER raising: the marker is evidence about a failure already in
    flight, and masking the original exception with a marker-write error
    would destroy exactly what it exists to preserve."""
    try:
        rec: Dict[str, Any] = {
            "schema": MARKER_SCHEMA, "t": time.time(), "phase": phase,
            "gstep": int(gstep), "steps_run": int(steps_run),
            "failure_class": failure_class,
        }
        if error is not None:
            rec["error_type"] = type(error).__name__
            rec["error"] = repr(error)
            # Base-class names let a classifier match exception FAMILIES
            # (any OSError subclass is transient I/O) without importing the
            # run's modules.
            rec["error_bases"] = [c.__name__ for c in type(error).__mro__]
        rec.update(extra)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001  # analysis: ok(swallow-except) — a marker
        # that cannot be written must not mask the error the leg is dying of
        pass


def read_crash_marker(path: Optional[str]) -> Optional[dict]:
    """Read a crash marker; None when absent/unreadable (no marker is
    itself evidence — the process died too hard to write one)."""
    if not path:
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def quarantine_steps_from_env() -> frozenset:
    """Global steps the supervised loop must SKIP (fetch nothing, train
    nothing), from ``MPI4DL_QUARANTINE_STEPS``."""
    raw = os.environ.get("MPI4DL_QUARANTINE_STEPS", "")
    out = set()
    for tok in raw.split(","):
        tok = tok.strip()
        if tok.lstrip("-").isdigit():
            out.add(int(tok))
    return frozenset(out)


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------


def _anomaly_steps(records: Sequence[Mapping[str, Any]]) -> List[int]:
    return sorted({
        int(r["gstep"]) for r in records
        if r.get("kind") == "anomaly" and r.get("gstep") is not None
    })


# Flight-recorder phase -> where a hang actually sits: the recorder's last
# known phase at escalation time tells apart the stalls the exit status
# alone cannot.
_HANG_SITES = {
    "fetch": "data_stall",
    "step": "collective",
    "compile": "collective",
    "save": "checkpoint_gather",
}


def classify_failure(
    exit_code: Optional[int],
    marker: Optional[Mapping[str, Any]] = None,
    records: Sequence[Mapping[str, Any]] = (),
    stderr_tail: str = "",
    flight: Optional[Mapping[str, Any]] = None,
) -> "Classification":
    """Map one leg exit onto the typed taxonomy.

    Evidence precedence: an explicit ``failure_class`` in the marker (the
    watchdog's ``hang``) wins; then the marker's error analysis (type
    family + phase); then the exit status (SIGKILL/escalation exit = hang,
    SIGTERM = preempted); then stderr/RunLog-tail pattern matches; then
    ``unknown`` — never untyped, never silent.

    ``flight`` (the leg's ``flight.json`` dump) refines rather than
    decides: a hang gains a ``hang_site`` (data stall vs collective vs
    checkpoint gather), an ``oom_step`` gains the watermark growth and the
    fastest-growing device (on ranks: the rank), and the
    oom_compile/oom_step split survives a leg whose RunLog never made it
    back (the recorder's ``steps_seen`` says whether the first step ever
    completed)."""
    from mpi4dl_tpu_torch.obs.flight import flight_summary, watermark_growth

    ev: Dict[str, Any] = {"exit_code": exit_code}
    fsum = flight_summary(flight)
    if fsum is not None:
        ev["flight"] = fsum

    def _hang_site() -> Optional[str]:
        if not flight:
            return None
        return _HANG_SITES.get(str(flight.get("phase") or ""))

    def _oom_localize() -> None:
        if not flight:
            return
        growth = watermark_growth(dict(flight))
        if growth is not None:
            ev["oom_watermark_growth_bytes"] = growth[0]
            if growth[1] is not None:
                ev["oom_device"] = growth[1]

    if marker:
        ev.update({
            "marker_phase": marker.get("phase"),
            "marker_gstep": marker.get("gstep"),
            "marker_error": marker.get("error"),
        })
        explicit = marker.get("failure_class")
        if explicit in FAILURE_CLASSES:
            ev["source"] = "marker:explicit"
            if explicit == "hang":
                site = _hang_site()
                if site:
                    ev["hang_site"] = site
            if explicit == "oom_step":
                _oom_localize()
            return Classification(explicit, ev)
        err = str(marker.get("error") or "")
        etype = marker.get("error_type") or ""
        bases = set(marker.get("error_bases") or ())
        if etype == "MeshShrunk" or "MeshShrunk" in bases:
            ev["source"] = "marker:error_type"
            ev["shrunk_spec"] = marker.get("shrunk_spec") or ""
            return Classification("mesh_shrunk", ev)
        if any(p in err for p in _OOM_PATTERNS):
            ev["source"] = "marker:oom_pattern"
            cls = (
                "oom_compile" if marker.get("phase") == "compile"
                else "oom_step"
            )
            if cls == "oom_step":
                _oom_localize()
            return Classification(cls, ev)
        if etype == "AnomalyError":
            ev["source"] = "marker:error_type"
            ev["anomaly_steps"] = _anomaly_steps(records)
            return Classification("nan_cluster", ev)
        if etype in ("CheckpointInvalid", "CheckpointMismatch") and (
            "shard file" in err
        ):
            ev["source"] = "marker:error_type"
            return Classification("lost_shard", ev)
        if "OSError" in bases or etype == "CheckpointWriteError":
            ev["source"] = "marker:error_family"
            return Classification("transient_io", ev)
    if exit_code is not None and exit_code != 0:
        if exit_code == HANG_EXIT_CODE or exit_code == -signal.SIGKILL:
            ev["source"] = "exit_code"
            site = _hang_site()
            if site:
                ev["hang_site"] = site
            return Classification("hang", ev)
        if exit_code == -signal.SIGTERM:
            # killed before the grace-window save finished — still a
            # preemption; the resume loses at most one checkpoint interval
            ev["source"] = "exit_code"
            return Classification("preempted", ev)
    if any(p in stderr_tail for p in _OOM_PATTERNS):
        ev["source"] = "stderr:oom_pattern"
        # No marker phase to split on: a leg that died during its first
        # step never wrote a step record.  The flight recorder's steps_seen
        # covers the case where the RunLog itself was lost.
        stepped = any(r.get("kind") == "step" for r in records)
        if not stepped and flight:
            stepped = int(flight.get("steps_seen") or 0) > 0
        cls = "oom_step" if stepped else "oom_compile"
        if cls == "oom_step":
            _oom_localize()
        return Classification(cls, ev)
    n_anomalies = sum(1 for r in records if r.get("kind") == "anomaly")
    n_recoveries = sum(1 for r in records if r.get("kind") == "recovery")
    if "AnomalyError" in stderr_tail or n_anomalies > n_recoveries:
        # Every guard rollback pairs its anomaly with a recovery record; an
        # UNPAIRED anomaly at death is the guard failing fast.  A leg whose
        # anomalies all recovered and that later died of something else
        # must NOT land here (quarantining healthy steps): it falls through
        # to unknown.
        ev["source"] = "stderr/runlog:anomaly"
        ev["anomaly_steps"] = _anomaly_steps(records)
        return Classification("nan_cluster", ev)
    ev["source"] = "fallback"
    return Classification("unknown", ev)


@dataclasses.dataclass(frozen=True)
class Classification:
    failure_class: str
    evidence: Dict[str, Any]


# ---------------------------------------------------------------------------
# Per-class recovery policy + backoff
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Policy:
    """What the supervisor does about one failure class.  ``max_attempts``
    bounds how many times THIS class may recur before giving up (the
    global ``MPI4DL_SUPERVISE_MAX_ATTEMPTS`` cap applies on top)."""

    action: str  # retry | degrade | quarantine | resume | fail
    max_attempts: int
    backoff: bool = False


POLICIES: Dict[str, Policy] = {
    "oom_compile": Policy("degrade", 3),
    "oom_step": Policy("degrade", 3),
    "mesh_shrunk": Policy("degrade", 3),
    "nan_cluster": Policy("quarantine", 2),
    "hang": Policy("retry", 2, backoff=True),
    "preempted": Policy("resume", 64),
    "lost_shard": Policy("retry", 2, backoff=True),
    "transient_io": Policy("retry", 3, backoff=True),
    "unknown": Policy("retry", 1, backoff=True),
}


def backoff_delay(attempt: int, *, base: float = 1.0, cap: float = 30.0,
                  jitter: float = 0.25, seed: int = 0,
                  job: str = "") -> float:
    """Exponential backoff with bounded jitter, deterministic under
    ``(job, seed)``: ``min(cap, base * 2**(attempt-1))`` scaled by a factor
    in ``[1-jitter, 1+jitter]`` drawn from ``Random`` seeded with the job,
    the seed and the attempt — two supervisors with different seeds or job
    ids de-synchronize their retries while one supervisor's schedule stays
    reproducible (the JAX package's draws, value for value)."""
    raw = min(float(cap), float(base) * (2.0 ** max(0, attempt - 1)))
    # str seeds hash via sha512 — stable across processes, unlike tuples.
    rng = random.Random(f"{job}:{seed}:{attempt}" if job
                        else f"{seed}:{attempt}")
    return raw * (1.0 + jitter * (2.0 * rng.random() - 1.0))


def supervise_knobs_from_env(
    max_attempts: Optional[int] = None,
    base: Optional[float] = None,
    cap: Optional[float] = None,
) -> Dict[str, float]:
    """Resolve the supervisor knobs: explicit values win, then the hatches
    (``MPI4DL_SUPERVISE_MAX_ATTEMPTS`` / ``_BACKOFF`` / ``_BACKOFF_CAP``),
    then the defaults (6 attempts, 1 s base, 30 s cap)."""
    return {
        "max_attempts": int(
            max_attempts if max_attempts is not None
            else os.environ.get("MPI4DL_SUPERVISE_MAX_ATTEMPTS", "") or 6
        ),
        "base": float(
            base if base is not None
            else os.environ.get("MPI4DL_SUPERVISE_BACKOFF", "") or 1.0
        ),
        "cap": float(
            cap if cap is not None
            else os.environ.get("MPI4DL_SUPERVISE_BACKOFF_CAP", "") or 30.0
        ),
    }


# ---------------------------------------------------------------------------
# Leg launching: one leg = one set of ranks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LegOutcome:
    """Everything one leg left behind: exit status, the result summary it
    wrote on success, its crash marker, its RunLog records, the tail of its
    stderr and its flight dump (those of the rank that failed first), and
    on ranks ``ranks``: each rank's exit code and marker class (None when
    the launcher ran no ranks, as a scripted one does)."""

    rc: Optional[int]
    result: Optional[Dict[str, Any]] = None
    marker: Optional[Dict[str, Any]] = None
    records: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    stderr_tail: str = ""
    flight: Optional[Dict[str, Any]] = None
    ranks: Optional[List[Dict[str, Any]]] = None


def flags_to_argv(flags: Mapping[str, Any]) -> List[str]:
    """``{"image-size": 32, "stripe-bwd": True}`` → bench-flag argv (the
    drill override vocabulary; True renders a bare flag, None/False omit)."""
    argv: List[str] = []
    for k, v in flags.items():
        if v is None or v is False:
            continue
        argv.append(f"--{k}")
        if v is not True:
            argv.append(str(v))
    return argv


def _leg_runlog_records(tele_dir: str) -> List[Dict[str, Any]]:
    """The newest RunLog in a leg's telemetry dir (its classification
    evidence); empty when the leg died before opening one."""
    from mpi4dl_tpu_torch.obs.runlog import read_runlog

    try:
        files = sorted(
            os.path.join(tele_dir, f) for f in os.listdir(tele_dir)
            if f.endswith(".jsonl")
        )
    except OSError:
        return []
    if not files:
        return []
    newest = max(files, key=os.path.getmtime)
    try:
        return read_runlog(newest)
    except OSError:
        return []


def _leg_store(world: int):
    """The rendezvous store of one leg, served by this process: the OS
    binds its port, and this process holds it from before the ranks start
    until the leg ends.  The ranks join it as clients
    (``TORCHELASTIC_USE_AGENT_STORE``, as ``torchrun``'s agent serves its
    workers).  A port that is only probed and released can be taken by
    another process before rank 0 binds it (the fleet starts its jobs'
    legs together): rank 0 then fails at the rendezvous, before the leg
    saved anything, and the retry trains from step 0."""
    import datetime

    from torch.distributed import TCPStore

    return TCPStore("127.0.0.1", 0, world_size=world, is_master=True,
                    wait_for_workers=False, timeout=datetime.timedelta(seconds=300))


def _tail(path: str, nbytes: int = 16384) -> str:
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read()
    except OSError:
        return ""


def _first_failed(rcs: Mapping[int, int], markers: Mapping[int, Optional[dict]],
                  order: Sequence[int]) -> int:
    """The rank that failed first: the first seen exiting non-zero, ties
    (ranks found dead at the same poll) broken by their markers' times."""
    first_poll = [r for r in order if rcs.get(r) not in (None, 0)]
    if not first_poll:
        return 0
    return min(first_poll, key=lambda r: (
        (markers.get(r) or {}).get("t", float("inf")), r))


def subprocess_leg_launcher(
    family: str, model: str, workdir: str,
    *, timeout: Optional[float] = None, grace: float = 5.0, job: str = "",
    on_spawn: Optional[Callable[[Any], None]] = None,
) -> Callable[[Mapping[str, Any], Mapping[str, str], int], LegOutcome]:
    """The real launcher: each attempt is one fresh set of
    ``required_devices(flags, family)`` ranks, each a ``python -m
    mpi4dl_tpu_torch.resilience leg`` process (a fresh CUDA context per
    attempt, so an OOM retry is sound).  Per-attempt artifacts land under
    ``workdir/attempt<N>/`` (``workdir/<job>/attempt<N>/`` for a fleet
    job): the crash markers, the leg result JSON (rank 0's), the telemetry
    dir (rank 0's RunLog), each rank's stderr (``leg.stderr``,
    ``leg.stderr.rank<r>``) and flight dump.

    Ranks get the ``env://`` rendezvous (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``: the port of the
    leg's store, :func:`_leg_store`, which this process holds until the
    leg ends) and, for a fleet job, ``MPI4DL_FLEET_JOB``.
    ``on_spawn(proc)`` is called with every rank's ``Popen`` as it starts.  When one rank exits non-zero the
    others get ``grace`` seconds to exit on their own, then SIGKILL; ranks
    that exit 0 (a drained leg among them) are never killed.  Past
    ``timeout`` every rank is killed and the leg reads as a hang.  A leg
    needing more ranks than ``MPI4DL_FLEET_SLICE_DEVICES`` (from
    ``env_extra``, else this process's environment) raises ``ValueError``:
    the fleet sized the slice wrong, which is a scheduler bug."""
    from mpi4dl_tpu_torch.obs.flight import FLIGHT_BASENAME, read_flight
    from mpi4dl_tpu_torch.resilience.planner import required_devices

    def launch(flags: Mapping[str, Any], env_extra: Mapping[str, str],
               attempt: int) -> LegOutcome:
        world = required_devices(flags, family)
        cap = env_extra.get("MPI4DL_FLEET_SLICE_DEVICES",
                            os.environ.get("MPI4DL_FLEET_SLICE_DEVICES", ""))
        if cap and world > int(cap):
            raise ValueError(
                f"leg of job {job or '-'!r} needs {world} ranks but its fleet "
                f"slice holds MPI4DL_FLEET_SLICE_DEVICES={cap}")
        adir = (os.path.join(workdir, job, f"attempt{attempt}") if job
                else os.path.join(workdir, f"attempt{attempt}"))
        os.makedirs(adir, exist_ok=True)
        marker = os.path.join(adir, "crash_marker.json")
        result_path = os.path.join(adir, "leg_result.json")
        tele = os.path.join(adir, "tele")
        leg_flags = dict(flags)
        leg_flags.setdefault("telemetry-dir", tele)
        cmd = [
            sys.executable, "-m", "mpi4dl_tpu_torch.resilience", "leg",
            "--family", family, "--model", model, "--result", result_path,
            "--", *flags_to_argv(leg_flags),
        ]
        env = dict(os.environ)
        # Injected faults never leak into retry legs: the supervisor owns
        # single-shot semantics ACROSS processes (the in-process injector
        # only owns them within one).
        env.pop("MPI4DL_FAULT", None)
        env.update(env_extra)
        env["MPI4DL_CRASH_MARKER"] = marker
        if job:
            env["MPI4DL_FLEET_JOB"] = job
        store = _leg_store(world)
        env.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(store.port), TORCHELASTIC_USE_AGENT_STORE="True",
                   TORCHELASTIC_RESTART_COUNT="0")
        procs, files = {}, []
        try:
            for r in range(world):
                errf = open(rank_path(os.path.join(adir, "leg.stderr"), r), "wb")
                files.append(errf)
                procs[r] = subprocess.Popen(
                    cmd, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                    stdout=errf, stderr=subprocess.STDOUT,
                )
                if on_spawn is not None:
                    on_spawn(procs[r])
            rcs, order, exits = _wait_ranks(procs, timeout, grace)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in files:
                f.close()
            del store
        markers = {r: read_crash_marker(rank_path(marker, r)) for r in procs}
        hung = any(rc is None for rc in rcs.values())
        failed = _first_failed(rcs, markers, order)
        result = None
        try:
            with open(result_path, "r", encoding="utf-8") as f:
                result = json.load(f)
        except (OSError, ValueError):
            result = None
        ranks = [{"rank": r, "rc": rcs[r],
                  "marker_class": (classify_failure(rcs[r], markers[r]).failure_class
                                   if markers[r] else None),
                  **exits[r]}
                 for r in sorted(procs)]
        rc = rcs[failed]
        return LegOutcome(
            rc=HANG_EXIT_CODE if hung and not rc else rc,
            result=result,
            marker=markers[failed],
            records=_leg_runlog_records(tele),
            stderr_tail=_tail(rank_path(os.path.join(adir, "leg.stderr"), failed)),
            flight=read_flight(rank_path(os.path.join(adir, FLIGHT_BASENAME), failed)),
            ranks=ranks,
        )

    return launch


def _wait_ranks(procs: Dict[int, subprocess.Popen], timeout: Optional[float],
                grace: float):
    """Wait for every rank; returns ``(rcs, order, exits)``: each rank's
    exit code (None: killed at the timeout), the ranks that exited non-zero
    first, all found at one poll, and each rank's ``{"exit_s": seconds from
    the wait's start to its exit (to 0.05 s), "killed": bool}``.  After the
    first non-zero exit the others get ``grace`` seconds, then SIGKILL
    (their codes then read −9)."""
    t0 = time.monotonic()
    deadline = None if timeout is None else t0 + timeout
    kill_at = None
    rcs: Dict[int, Optional[int]] = {}
    exits: Dict[int, Dict[str, Any]] = {}
    order: List[int] = []

    def seen(r: int, rc: Optional[int], killed: bool) -> None:
        rcs[r] = rc
        exits[r] = {"exit_s": round(time.monotonic() - t0, 2), "killed": killed}

    while len(rcs) < len(procs):
        now = time.monotonic()
        for r, p in procs.items():
            if r not in rcs and p.poll() is not None:
                seen(r, p.returncode, False)
                if p.returncode != 0 and not order:
                    order = [q for q in procs if procs[q].poll() not in (None, 0)]
                    kill_at = now + grace
        if len(rcs) == len(procs):
            break
        if deadline is not None and now > deadline:
            for r, p in procs.items():
                if r not in rcs:
                    p.kill()
                    p.wait()
                    seen(r, None, True)
            break
        if kill_at is not None and now > kill_at:
            for r, p in procs.items():
                if r not in rcs:
                    p.kill()
                    seen(r, p.wait(), True)
            break
        time.sleep(0.05)
    return rcs, order, exits


def run_leg(family: str, model: str, argv: Sequence[str],
            result_path: Optional[str] = None) -> int:
    """One rank of one training leg in THIS process (the ``leg`` CLI body):
    run the runner entry point, persist rank 0's summary dict for the
    supervisor, and guarantee a crash marker (this rank's) on any failure
    path the supervised loop's own marker did not cover (build and mesh
    errors before the loop starts).  A fleet job's summary carries its
    ``fleet_job`` tag (``MPI4DL_FLEET_JOB``); a rank that ran on a card
    names the card on stderr (:func:`card_identity`)."""
    marker = crash_marker_path()
    try:
        from mpi4dl_tpu_torch.benchmarks.common import run

        result = run(family, model, list(argv))
    except BaseException as e:
        if marker and not os.path.exists(marker):
            write_crash_marker(marker, phase="build", error=e)
        raise
    card = card_identity()
    if card is not None:
        # The leg's card line goes to its stderr, which the fleet drills
        # read (benchmarks/fleet_check.py).
        print(f"leg rank {process_rank()}: card {json.dumps(card)}",  # analysis: ok(print-call)
              file=sys.stderr, flush=True)
    fleet_job = os.environ.get("MPI4DL_FLEET_JOB")
    if fleet_job:
        # The scheduler's contamination check verifies that the evidence
        # stayed in its job's lane.
        result = dict(result)
        result["fleet_job"] = fleet_job
    if result_path and process_rank() == 0:
        tmp = f"{result_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({k: v for k, v in result.items()
                       if _json_safe(v)}, f)
        os.replace(tmp, result_path)
    return 0


def card_identity() -> Optional[Dict[str, Any]]:
    """The card this process computed on: its index among the visible
    cards, the ``CUDA_VISIBLE_DEVICES`` it saw, its PCI bus and domain
    numbers (those of ``nvidia-smi``'s ``pci.bus_id``) and UUID; None when
    this process never initialized CUDA."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    i = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(i)
    return {"index": i, "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "name": props.name, "pci_bus_id": getattr(props, "pci_bus_id", None),
            "pci_domain_id": getattr(props, "pci_domain_id", None),
            "uuid": str(getattr(props, "uuid", "")) or None}


def _json_safe(v: Any) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# The supervisor state machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SupervisorResult:
    ok: bool
    attempts: int
    incidents: List[Dict[str, Any]]
    final: Optional[Dict[str, Any]] = None  # last leg's result summary
    flags: Optional[Dict[str, Any]] = None  # the flags the final leg ran
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    reason: str = ""  # non-empty on failure
    # True when the fleet's stop hook drained this supervisor (graceful
    # preemption / migration) — NOT a job failure: the checkpoint is
    # durable and the scheduler relaunches elsewhere.
    stopped: bool = False


class Supervisor:
    """Run one training job as a sequence of supervised legs.

    ``launch(flags, env_extra, attempt) -> LegOutcome`` is injectable for
    tests; the default is :func:`subprocess_leg_launcher` (rank sets).
    ``probe`` is the planner's feasibility probe (``None`` = accept the first ladder
    rung — the planner still records that the probe was skipped).
    ``fault`` applies to attempt 1 ONLY: the drills inject one disaster
    into the first leg and supervision must recover without it.

    Fleet hooks: ``job`` namespaces the default launcher's attempts and
    rides the summary record; ``on_spawn`` goes to the default launcher;
    ``stop() -> reason`` is polled before each leg and after each leg that
    did not complete: non-empty, the run ends with ``stopped=True`` (no
    incident for the drained leg) instead of relaunching."""

    def __init__(self, family: str, model: str,
                 flags: Mapping[str, Any], *,
                 workdir: str,
                 runlog=None,
                 launch=None,
                 probe: Optional[Callable[[Mapping[str, Any]],
                                          Optional[float]]] = None,
                 budget_gb: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_cap: Optional[float] = None,
                 seed: int = 0,
                 fault: str = "",
                 job: str = "",
                 stop: Optional[Callable[[], str]] = None,
                 on_spawn: Optional[Callable[[Any], None]] = None,
                 log: Callable[[str], None] = lambda s: None,
                 _sleep: Callable[[float], None] = time.sleep):
        knobs = supervise_knobs_from_env(max_attempts, backoff_base,
                                         backoff_cap)
        self.family, self.model = family, model
        self.flags = dict(flags)
        self.workdir = workdir
        self.runlog = runlog
        self.launch = (
            launch if launch is not None
            else subprocess_leg_launcher(family, model, workdir, job=job,
                                         on_spawn=on_spawn)
        )
        self.probe = probe
        self.budget_gb = budget_gb
        self.max_attempts = int(knobs["max_attempts"])
        self.backoff_base = float(knobs["base"])
        self.backoff_cap = float(knobs["cap"])
        self.seed = seed
        self.fault = fault
        self.job = job
        self.stop = stop
        self.log = log
        self._sleep = _sleep

    # -- incident plumbing -------------------------------------------------

    def _incident(self, rec: Dict[str, Any]) -> None:
        if self.runlog is not None:
            self.runlog.write("supervisor", **rec)
        self.log(
            f"[supervisor] attempt {rec.get('attempt')}: "
            f"{rec.get('failure_class')} -> {rec.get('policy')}"
            + (f" ({rec.get('note')})" if rec.get("note") else "")
        )

    def _summary(self, res: SupervisorResult) -> SupervisorResult:
        if self.runlog is not None:
            self.runlog.write(
                "supervisor_summary", ok=res.ok, attempts=res.attempts,
                incidents=len(res.incidents), reason=res.reason,
                final_flags=dict(res.flags or {}), final_env=dict(res.env),
                stopped=res.stopped, job=self.job or None,
            )
        return res

    # -- main loop ---------------------------------------------------------

    def run(self) -> SupervisorResult:
        flags = dict(self.flags)
        env_extra: Dict[str, str] = {}
        incidents: List[Dict[str, Any]] = []
        per_class: Dict[str, int] = {}
        quarantined: set = set()
        last_final: Optional[Dict[str, Any]] = None
        attempt = 0

        def stopped(why: str) -> SupervisorResult:
            # Drained by the fleet: surface the last leg's summary (the
            # drained leg checkpointed on its way out) and say so — a stop
            # is a scheduling decision, not a job failure.
            return self._summary(SupervisorResult(
                ok=False, attempts=attempt, incidents=incidents,
                final=last_final, flags=flags, env=env_extra,
                reason=why, stopped=True,
            ))

        while attempt < self.max_attempts:
            why = self.stop() if self.stop is not None else ""
            if why:
                return stopped(why)
            attempt += 1
            env = dict(env_extra)
            if self.fault and attempt == 1:
                env["MPI4DL_FAULT"] = self.fault
            out = self.launch(flags, env, attempt)
            if out.result is not None:
                last_final = out.result
            if out.rc == 0 and not (out.result or {}).get("preempted"):
                return self._summary(SupervisorResult(
                    ok=True, attempts=attempt, incidents=incidents,
                    final=out.result, flags=flags, env=env_extra,
                ))
            why = self.stop() if self.stop is not None else ""
            if why:
                # A leg of a rank set drained at a step boundary exits 0
                # preempted; one SIGTERMed before its ranks rendezvoused
                # exits -SIGTERM, its peers killed after the grace.  Either
                # way the drain ended it: no incident, no relaunch.
                return stopped(why)
            if out.rc == 0:
                cls = Classification(
                    "preempted",
                    {"exit_code": 0, "source": "leg_result:preempted",
                     "final_step": (out.result or {}).get("final_step")},
                )
            else:
                cls = classify_failure(out.rc, out.marker, out.records,
                                       out.stderr_tail, out.flight)
                if out.ranks is not None:
                    cls.evidence["ranks"] = out.ranks
            policy = POLICIES[cls.failure_class]
            per_class[cls.failure_class] = (
                per_class.get(cls.failure_class, 0) + 1
            )
            nth = per_class[cls.failure_class]
            incident: Dict[str, Any] = {
                "attempt": attempt,
                "failure_class": cls.failure_class,
                "policy": policy.action,
                "class_attempt": nth,
                "evidence": cls.evidence,
            }
            if nth > policy.max_attempts:
                incident["policy"] = "fail"
                incident["note"] = (
                    f"{cls.failure_class} recurred {nth} times "
                    f"(> {policy.max_attempts}) — giving up"
                )
                incidents.append(incident)
                self._incident(incident)
                return self._summary(SupervisorResult(
                    ok=False, attempts=attempt, incidents=incidents,
                    flags=flags, env=env_extra,
                    reason=incident["note"],
                ))

            apply_backoff = policy.backoff
            if policy.action == "degrade":
                from mpi4dl_tpu_torch.resilience.planner import plan_degrade

                plan = plan_degrade(
                    flags, self.family, cls.failure_class,
                    budget_gb=self.budget_gb, probe=self.probe,
                    evidence=cls.evidence,
                )
                if plan is None:
                    incident["policy"] = "fail"
                    incident["note"] = (
                        "degradation ladder exhausted: no feasible "
                        "geometry below the current one"
                    )
                    incidents.append(incident)
                    self._incident(incident)
                    return self._summary(SupervisorResult(
                        ok=False, attempts=attempt, incidents=incidents,
                        flags=flags, env=env_extra,
                        reason=incident["note"],
                    ))
                flags = dict(plan.flags)
                env_extra.update(plan.env)
                incident["config_delta"] = plan.delta
                incident["plan_rungs"] = plan.rungs
                incident["probe"] = plan.probe_evidence
                incident["note"] = plan.note
            elif policy.action == "quarantine":
                steps = set(cls.evidence.get("anomaly_steps") or ())
                steps |= set(_anomaly_steps(out.records))
                if not steps:
                    # no anomalous step identified: nothing to quarantine —
                    # the incident must SAY retry (and back off like one),
                    # not claim a quarantine that never happened
                    incident["policy"] = "retry"
                    apply_backoff = True
                    incident["note"] = (
                        "nan_cluster with no identifiable anomaly steps — "
                        "plain retry"
                    )
                else:
                    quarantined |= steps
                    env_extra["MPI4DL_QUARANTINE_STEPS"] = ",".join(
                        str(s) for s in sorted(quarantined)
                    )
                    incident["quarantined"] = sorted(quarantined)
                    incident["note"] = (
                        f"quarantined poison steps {sorted(steps)}"
                    )
            if apply_backoff:
                delay = backoff_delay(
                    nth, base=self.backoff_base, cap=self.backoff_cap,
                    seed=self.seed, job=self.job,
                )
                incident["backoff_s"] = round(delay, 3)
                incidents.append(incident)
                self._incident(incident)
                self._sleep(delay)
            else:
                incidents.append(incident)
                self._incident(incident)
        return self._summary(SupervisorResult(
            ok=False, attempts=attempt, incidents=incidents, flags=flags,
            env=env_extra,
            reason=f"MPI4DL_SUPERVISE_MAX_ATTEMPTS={self.max_attempts} "
                   "leg launches exhausted",
        ))
