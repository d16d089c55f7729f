"""Degrade-and-continue planner (counterpart of
``mpi4dl_tpu/resilience/planner.py``; the same ladder, order, ``Plan``
records and probe verdicts).

When a leg dies of a resource failure (``oom_compile`` / ``oom_step`` /
``mesh_shrunk``), retrying the same config is doomed: the supervisor needs
a *feasible* geometry to relaunch into.  The planner walks a documented
**degradation ladder**, cumulative (each rung adds one more lever on top of
the previous ones), in this order:

1. **``spatial-until auto``**: re-place the SP→LP junction from the
   analytical placement ledger (``parallel.spatial.choose_spatial_until``).
   Plain-SP family only: moving the junction of an SP x PP state re-packs
   its stage buffers, which orphans the checkpoint the relaunched leg must
   elastic-restore, and feasibility includes restorability.
2. **halve ``parts``**: fewer in-flight micro-batches shrink the pipeline's
   O(parts) trail; leaf-shape-preserving, so elastic.
3. **enable ``MPI4DL_STRIPE_BWD``**: stripe-wise backward through the SP
   region (``ops/stripe_bwd.py``) bounds the backward working set to one
   H-stripe; a layout field of the checkpoint, so the relaunch is a
   recorded reshape.
4. **step down the SP geometry**: fewer spatial tiles (square grids step
   16→4, strip slicings halve), the only rung that reduces the DEVICE
   footprint, and the rung a ``mesh_shrunk`` re-plan lands on.

Each candidate is validated by a **feasibility probe** before the
supervisor relaunches: :func:`compile_probe` runs ``python -m
mpi4dl_tpu_torch.benchmarks.mem_probe`` in a subprocess (a probe that fails
must not take the supervisor with it) and reads its per-rank peak; a
candidate is feasible when the probe builds and steps it and, when a byte
budget is known, it fits.  The name is the JAX package's: there it
compiles the step, here it runs the step once on fake tensors.  The chosen
plan, its rungs and the probe evidence ride the ``supervisor`` incident
record.

:func:`expand_candidates` / :func:`plan_expand` walk the same ladder
upward: when devices free up, a degraded job re-expands toward its
preferred geometry (largest feasible candidate first, the same device
budget and probe gates, skip reasons recorded) from the same elastic
checkpoint it degraded with.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

# Families with a spatial region (the SP rungs only mean something there).
_SPATIAL_FAMILIES = ("sp", "gems_sp")

# Probe verdict for a candidate that failed to build or step (or whose
# probe subprocess died): infinitely infeasible, as opposed to None = "probe
# could not run, accept with a warning".
INFEASIBLE = math.inf


@dataclasses.dataclass(frozen=True)
class Plan:
    """One feasible degraded config: the full flag set to relaunch with,
    env-hatch additions, the delta vs the failing config, the ladder rungs
    applied, and the probe evidence that admitted it."""

    flags: Dict[str, Any]
    env: Dict[str, str]
    delta: Dict[str, Any]
    rungs: List[str]
    note: str
    probe_evidence: Dict[str, Any]


def _flag(flags: Mapping[str, Any], name: str, default: Any) -> Any:
    return flags.get(name, default)


def _first_sp_parts(flags: Mapping[str, Any]) -> int:
    raw = str(_flag(flags, "num-spatial-parts", "4"))
    head = raw.split(",")[0].strip()
    return int(head) if head.lstrip("-").isdigit() else 4


def required_devices(flags: Mapping[str, Any], family: str) -> int:
    """Ranks a config needs (one card each), as ``MeshSpec.from_config``
    counts them, without importing the mesh module: the supervisor that
    calls this never initializes CUDA."""
    dp = int(_flag(flags, "data-parallel", 1))
    split = max(int(_flag(flags, "split-size", 1)), 1)
    if family not in _SPATIAL_FAMILIES:
        return dp * split
    sp = _first_sp_parts(flags)
    spatial_size = int(_flag(flags, "spatial-size", 1))
    tiles = sp if (spatial_size > 0 and sp > 1) else 1
    return dp * split * tiles


def _shrunk_devices(evidence: Optional[Mapping[str, Any]]) -> Optional[int]:
    """Parse the surviving device count out of a ``mesh_shrunk`` spec
    (``devices=4`` — the free-text arg of the fault / the slice's report)."""
    spec = str((evidence or {}).get("shrunk_spec") or "")
    for tok in spec.split(","):
        k, _, v = tok.partition("=")
        if k.strip() == "devices" and v.strip().isdigit():
            return int(v.strip())
    return None


def degrade_candidates(flags: Mapping[str, Any],
                       family: str) -> List[Plan]:
    """The cumulative ladder: candidate *k* applies rungs 1..k (each
    successive candidate strictly more aggressive).  Rungs whose
    precondition fails (parts already 1, stripe already on, ...) are
    skipped, so the list is exactly the moves still available below the
    current config."""
    cands: List[Plan] = []
    cur = dict(flags)
    env: Dict[str, str] = {}
    delta: Dict[str, Any] = {}
    rungs: List[str] = []

    def push(note: str) -> None:
        cands.append(Plan(
            flags=dict(cur), env=dict(env), delta=dict(delta),
            rungs=list(rungs), note=note, probe_evidence={},
        ))

    split = max(int(_flag(flags, "split-size", 1)), 1)
    # Rung 1: analytical junction re-placement (plain-SP only: an
    # sp_pipeline junction move re-packs buffers and orphans the ckpt).
    if (family in _SPATIAL_FAMILIES and split <= 1
            and str(_flag(flags, "spatial-until", "")) != "auto"):
        cur["spatial-until"] = "auto"
        delta["spatial-until"] = "auto"
        rungs.append("spatial_until_auto")
        push("junction re-placed from the analytical frontier")

    # Rung 2: halve parts while the batch still divides.
    parts = int(_flag(flags, "parts", 1))
    batch = int(_flag(flags, "batch-size", 32))
    times = int(_flag(flags, "times", 1))
    if parts >= 2:
        new_parts = parts // 2
        groups = (2 * times * new_parts) if family in ("gems", "gems_sp") \
            else new_parts
        if groups >= 1 and batch % groups == 0:
            cur["parts"] = new_parts
            delta["parts"] = {"from": parts, "to": new_parts}
            rungs.append("halve_parts")
            push(f"parts {parts} -> {new_parts}")

    # Rung 3: stripe-wise backward (resolved layout field — elastic).
    stripe_on = (
        bool(_flag(flags, "stripe-bwd", False))
        or os.environ.get("MPI4DL_STRIPE_BWD", "0") not in ("", "0")
    )
    if family in _SPATIAL_FAMILIES and not stripe_on:
        cur["stripe-bwd"] = True
        env["MPI4DL_STRIPE_BWD"] = "1"
        delta["stripe-bwd"] = {"from": False, "to": True}
        rungs.append("stripe_bwd")
        push("stripe-wise SP-region backward enabled")

    # Rung 4: step down the SP geometry (the device-footprint rung).
    # Square grids step a full side-halving (16 -> 4); strip slicings
    # halve.  A step to 1 tile turns spatial tiling off entirely — allowed
    # only for the plain-SP family (an un-tiled sp_pipeline region is not a
    # supported engine shape).
    sp = _first_sp_parts(flags)
    slice_method = str(_flag(flags, "slice-method", "square"))
    if family in _SPATIAL_FAMILIES and sp > 1:
        new_sp = sp // 4 if slice_method == "square" else sp // 2
        if new_sp >= 2 or (new_sp == 1 and split <= 1):
            cur["num-spatial-parts"] = str(new_sp)
            delta["num-spatial-parts"] = {"from": sp, "to": new_sp}
            rungs.append("shrink_sp")
            push(f"spatial tiles {sp} -> {new_sp}")
    return cands


def _first_feasible(
    cands: Iterable[Plan], family: str, devices: Optional[int],
    budget_gb: Optional[float],
    probe: Optional[Callable[[Mapping[str, Any], Mapping[str, str]],
                             Optional[float]]],
) -> Optional[Plan]:
    """The first candidate that fits ``devices`` (when known) and that the
    probe builds within ``budget_gb`` (when known), with every rejection
    before it recorded in its ``probe_evidence["skipped"]``; ``None`` when
    none does."""
    skipped: List[Dict[str, Any]] = []
    for cand in cands:
        if devices is not None:
            need = required_devices(cand.flags, family)
            if need > devices:
                skipped.append({"rungs": cand.rungs, "reason":
                                f"needs {need} devices, have {devices}"})
                continue
        pe: Dict[str, Any] = {"skipped": skipped} if skipped else {}
        if probe is not None:
            peak = probe(cand.flags, cand.env)
            if peak == INFEASIBLE:
                skipped.append({"rungs": cand.rungs,
                                "reason": "probe failed to compile"})
                continue
            if peak is None:
                pe["probe"] = "unavailable — accepted unprobed"
            else:
                pe["probe_peak_gb"] = peak
                pe["budget_gb"] = budget_gb
                if budget_gb is not None and peak > budget_gb:
                    skipped.append({
                        "rungs": cand.rungs,
                        "reason": f"probe peak {peak} GB > budget "
                                  f"{budget_gb} GB",
                    })
                    continue
        else:
            pe["probe"] = "skipped (no probe configured)"
        return dataclasses.replace(cand, probe_evidence=pe)
    return None


def plan_degrade(
    flags: Mapping[str, Any],
    family: str,
    failure_class: str,
    *,
    budget_gb: Optional[float] = None,
    probe: Optional[Callable[[Mapping[str, Any], Mapping[str, str]],
                             Optional[float]]] = None,
    evidence: Optional[Mapping[str, Any]] = None,
) -> Optional[Plan]:
    """First feasible rung of the ladder, or ``None`` when the ladder is
    exhausted.  Feasibility = (fits the surviving device budget, for
    ``mesh_shrunk``) AND (the probe builds and steps it and — with a
    known ``budget_gb`` — it fits).  Probe outcomes ride the returned
    plan's ``probe_evidence`` so the incident record can SAY why this
    geometry was admitted."""
    devices = (
        _shrunk_devices(evidence) if failure_class == "mesh_shrunk" else None
    )
    return _first_feasible(degrade_candidates(flags, family), family,
                           devices, budget_gb, probe)


# ---------------------------------------------------------------------------
# Upward search: re-expansion toward the preferred geometry
# ---------------------------------------------------------------------------


def expand_candidates(flags: Mapping[str, Any],
                      preferred: Mapping[str, Any],
                      family: str) -> List[Plan]:
    """The ladder walked UPWARD: cumulative candidates that undo the
    degrade levers still separating ``flags`` from ``preferred``, in the
    degrade ladder's own order (junction, parts, stripe, SP geometry) so
    candidate *k* restores levers 1..k and the LAST candidate is the
    preferred geometry itself.  Only the four ladder-controlled keys are
    touched — anything else in ``flags`` (checkpoint dir, steps, ...)
    rides along unchanged, which is what lets a degraded job re-expand
    from the same elastic checkpoint.  Empty when the config already sits
    at its preferred geometry."""
    cands: List[Plan] = []
    cur = dict(flags)
    env: Dict[str, str] = {}
    delta: Dict[str, Any] = {}
    rungs: List[str] = []

    def restore(key: str) -> None:
        if key in preferred:
            cur[key] = preferred[key]
        else:
            cur.pop(key, None)

    def push(note: str) -> None:
        cands.append(Plan(
            flags=dict(cur), env=dict(env), delta=dict(delta),
            rungs=list(rungs), note=note, probe_evidence={},
        ))

    # Rung 1: restore a pinned junction the degrade moved to "auto".
    su_now = str(_flag(flags, "spatial-until", "") or "")
    su_pref = str(_flag(preferred, "spatial-until", "") or "")
    if su_now != su_pref:
        restore("spatial-until")
        delta["spatial-until"] = {"from": su_now or None,
                                  "to": su_pref or None}
        rungs.append("restore_junction")
        push("junction restored to the preferred placement")

    # Rung 2: grow parts back (micro-batch trail restored).
    parts_now = int(_flag(flags, "parts", 1))
    parts_pref = int(_flag(preferred, "parts", 1))
    if parts_pref > parts_now:
        restore("parts")
        delta["parts"] = {"from": parts_now, "to": parts_pref}
        rungs.append("restore_parts")
        push(f"parts {parts_now} -> {parts_pref}")

    # Rung 3: drop the stripe-wise backward the degrade enabled.
    stripe_now = bool(_flag(flags, "stripe-bwd", False))
    stripe_pref = bool(_flag(preferred, "stripe-bwd", False))
    if stripe_now and not stripe_pref:
        restore("stripe-bwd")
        # Explicit "0" so an inherited MPI4DL_STRIPE_BWD=1 from the
        # degraded leg's environment cannot silently re-enable it.
        env["MPI4DL_STRIPE_BWD"] = "0"
        delta["stripe-bwd"] = {"from": True, "to": False}
        rungs.append("unstripe_bwd")
        push("stripe-wise SP-region backward disabled")

    # Rung 4: grow the SP geometry — the only rung that ASKS for devices,
    # so it comes last: a partial expansion that stops short of it still
    # fits the current slice.
    sp_now = _first_sp_parts(flags)
    sp_pref = _first_sp_parts(preferred)
    if family in _SPATIAL_FAMILIES and sp_pref > sp_now:
        restore("num-spatial-parts")
        delta["num-spatial-parts"] = {"from": sp_now, "to": sp_pref}
        rungs.append("grow_sp")
        push(f"spatial tiles {sp_now} -> {sp_pref}")
    return cands


def plan_expand(
    flags: Mapping[str, Any],
    preferred: Mapping[str, Any],
    family: str,
    *,
    devices: Optional[int] = None,
    budget_gb: Optional[float] = None,
    probe: Optional[Callable[[Mapping[str, Any], Mapping[str, str]],
                             Optional[float]]] = None,
) -> Optional[Plan]:
    """The LARGEST feasible expansion of a degraded config toward its
    preferred geometry, or ``None`` when no upward move fits (stay
    degraded).  Mirror image of :func:`plan_degrade`: candidates are
    walked most-expanded-first, gated by the free-device budget and the
    probe; every rejection rides the returned plan's
    ``probe_evidence["skipped"]`` so the fleet's ``expand`` incident can
    SAY why the job landed where it did."""
    return _first_feasible(reversed(expand_candidates(flags, preferred, family)),
                           family, devices, budget_gb, probe)


# ---------------------------------------------------------------------------
# The real feasibility probe: mem_probe on fake tensors, in a subprocess
# ---------------------------------------------------------------------------


def _package_root() -> str:
    """The directory holding ``mpi4dl_tpu_torch``: the probe subprocess
    runs there, so ``-m`` finds this package wherever the caller stands."""
    import mpi4dl_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(mpi4dl_tpu_torch.__file__)))


# Flags of a leg that the probe has no use for: where the leg writes, how
# long it trains, and its device (the probe runs on fake tensors, with no
# card).  The schedule is passed on its own.
_LEG_ONLY_FLAGS = frozenset({
    "checkpoint-dir", "telemetry-dir", "steps-per-epoch", "num-epochs",
    "watchdog-secs", "watchdog-compile-secs", "profile-dir", "device",
    "num-workers", "app", "datapath", "schedule",
})


def _probe_argv(flags: Mapping[str, Any], family: str, model: str,
                out_path: str) -> List[str]:
    """Bench-flag dict → ``mem_probe`` argv: the family, the model and the
    leg's own geometry flags, so that the probe builds the step exactly as
    the relaunched leg's runner would (slice method, junction placement,
    stripe-wise backward, precision and kernels included)."""
    from mpi4dl_tpu_torch.resilience.supervisor import flags_to_argv

    schedule = str(_flag(flags, "schedule", "gpipe"))
    geometry = {k: v for k, v in flags.items() if k not in _LEG_ONLY_FLAGS}
    return ["--family", family, "--model", model, "--schedule", schedule,
            "--out", out_path, *flags_to_argv(geometry)]


def compile_probe(
    family: str, model: str = "resnet", *, timeout: float = 900.0,
    log: Callable[[str], None] = lambda s: None,
) -> Callable[[Mapping[str, Any], Mapping[str, str]], Optional[float]]:
    """Probe factory: returns ``probe(flags, env) -> peak_gb | INFEASIBLE |
    None``.  Runs ``python -m mpi4dl_tpu_torch.benchmarks.mem_probe`` in a
    subprocess (a candidate that fails to build kills the probe process,
    not the supervisor; the probe touches no card) and reads
    ``schedules[<schedule>].peak_gb_est`` from its JSON artifact: the
    largest rank role's peak.  A non-zero exit or a timeout is
    :data:`INFEASIBLE`; a probe that cannot run at all is None."""

    def probe(flags: Mapping[str, Any],
              env_extra: Mapping[str, str]) -> Optional[float]:
        schedule = str(_flag(flags, "schedule", "gpipe"))
        fd, out_path = tempfile.mkstemp(suffix=".json", prefix="mem_probe_")
        os.close(fd)
        env = dict(os.environ)
        env.pop("MPI4DL_FAULT", None)  # a probe must never re-fire a fault
        env.update(env_extra)
        cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.mem_probe",
               *_probe_argv(flags, family, model, out_path)]
        try:
            proc = subprocess.run(
                cmd, env=env, capture_output=True, timeout=timeout,
                cwd=_package_root(),
            )
            if proc.returncode != 0:
                log(f"[planner] probe rc={proc.returncode}: "
                    f"{proc.stderr.decode(errors='replace')[-400:]}")
                return INFEASIBLE
            with open(out_path, "r", encoding="utf-8") as f:
                data = json.load(f)
            row = (data.get("schedules") or {}).get(schedule) or {}
            peak = row.get("peak_gb_est")
            return float(peak) if peak is not None else None
        except subprocess.TimeoutExpired:
            log("[planner] probe timed out — candidate treated as "
                "infeasible")
            return INFEASIBLE
        except (OSError, ValueError) as e:
            log(f"[planner] probe unavailable: {e!r}")
            return None
        finally:
            try:
                os.unlink(out_path)
            except OSError:
                pass

    return probe
