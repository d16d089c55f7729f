"""The fleet chaos matrix on four cards (or on gloo ranks with ``--device
cpu``), in one job.

    python -m mpi4dl_tpu_torch.benchmarks.fleet_check --workdir DIR

This process runs the fleet scheduler (``resilience.fleet``), whose
supervisors start every rank themselves (``subprocess_leg_launcher``), and
never initializes CUDA.  Two parts:

1. ``small``: the JAX package's five scenarios at their own model (ResNet
   32², one layer, bs4, 2-step epochs), mapped onto a pool of 4 cards
   (``CARD_MAP``):

   - ``fleet_preempt_storm``: as in JAX (pool 4; ``lo``, ``hi1``, ``hi2``
     each SP 2x2);
   - ``fleet_reexpand``: pool 2 grown to 4 (JAX: 8); ``sprout`` goes from 2
     tiles to its preferred 4 (the JAX flags), probe-gated;
   - ``fleet_crash_cascade``: pool 4; ``alpha`` and ``beta`` each at 2
     tiles (``--num-spatial-parts 2 --slice-method vertical``; JAX: two
     2x2 jobs on 8);
   - ``fleet_oom_poison``: pool 4; ``poison`` is ``lp`` over 2 stages, as in
     JAX; ``steady`` is at 2 tiles;
   - ``fleet_slice_kill``: pool 4 with ``nomad`` alone at the elastic 2x2;
     shrinking the pool to 2 displaces it, it degrades to 2 tiles, restores
     elastically, and its loss is held against its control.  JAX's
     ``keeper`` cannot sit beside it on four cards (below 2 tiles the
     ``sp`` runner refuses the geometry), so ``keeper``'s
     ``expect_untouched`` is checked only by the ``--device cpu``
     rehearsal, at the JAX geometry.

   A ResNet 32² step takes milliseconds on a card, so a victim could finish
   before its drain lands: on cards the drained jobs (``lo``, ``nomad``)
   straggle ``STRAGGLE`` before step 3 of their first leg (loss-neutral,
   as JAX's ``fleet_reexpand`` already does), which holds the drain window
   open.
2. ``full``: ``fleet_preempt_storm`` at full width (``FULL_FLAGS``:
   AmoebaNet-D(18, 416) 2048² bs1 on 2x2 ranks, D2, bf16, the kernels on,
   remat off, 2-step epochs; ``lo`` 4 epochs): a drain SIGTERMs four NCCL
   ranks mid-step, the victim resumes at its preferred geometry, and its
   losses after the resume are compared with its uninterrupted control's
   (the gap is printed either way).

Every rank of every leg that ran on a card names its card in its stderr
(``leg rank r: card {...}``, ``supervisor.card_identity``): rank r of a leg
must sit on its slice's card r, checked by PCI bus id (and domain and
UUID) against the same identity of each card as a process that sees all
of them names it (``physical_cards``).

In the crash cascade every job's retry legs must restore the step-2
checkpoint (``RETRY_RESTORES``): the boundary save lands just before the
injected ``OSError``, and a retry that restores an older step (or nothing)
lost it.  The scenario's row carries each leg's evidence (``legs``: the
steps it saved, the step it restored, and how it ended: the incident's
class, the crash marker's phase and step, each rank's exit code, seconds
and whether the launcher killed it).  The drill's own verdict stays the
JAX package's.

``--device cpu`` rehearses part 1 at the JAX geometry itself (pool 8,
``keeper`` included, one thread a rank) and part 2 at ``REHEARSAL_FLAGS``.
``--scenarios NAME ...`` runs only those (``fleet_preempt_storm_full`` is
part 2's); a caller in Python picks parts with ``main(argv,
parts=("small",))``.

On cards the first line is each card's name and power limit; the last
line is one JSON object with each scenario's verdict and seconds, the
seconds from each drain request to the victim's exit, the relaunches,
each loss gap and ``ok``: every scenario verified and every rank on its
card (exit 1 otherwise).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shlex
import subprocess
import sys
import time

FULL_FLAGS = ("--model amoebanet --num-layers 18 --num-filters 416 --num-classes 1000 "
              "--precision bf_16 --pallas-conv --no-remat --image-size 2048 --batch-size 1 "
              "--num-spatial-parts 4 --slice-method square --halo-d2 "
              "--steps-per-epoch 2 --num-epochs 2")
REHEARSAL_FLAGS = ("--model amoebanet --num-layers 3 --num-filters 16 --num-classes 10 "
                   "--precision bf_16 --pallas-conv --image-size 256 --batch-size 1 "
                   "--num-spatial-parts 4 --slice-method square --halo-d2 --spatial-until 4 "
                   "--steps-per-epoch 2 --num-epochs 2")
STRAGGLE = "slow_step@3:5"
SMALL_DEADLINE, FULL_DEADLINE = 300.0, 900.0  # seconds a scenario's scheduler may take
_TWO_TILES = {"num-spatial-parts": "2", "slice-method": "vertical"}
# scenario -> (pool, job id -> flag overrides / fault, trigger)
CARD_MAP = {
    "fleet_preempt_storm": {"pool": 4, "fault": {"lo": STRAGGLE}},
    "fleet_reexpand": {"pool": 2, "grow": 4},
    "fleet_crash_cascade": {"pool": 4, "flags": {"alpha": _TWO_TILES, "beta": _TWO_TILES}},
    "fleet_oom_poison": {"pool": 4, "flags": {"steady": _TWO_TILES}},
    "fleet_slice_kill": {"pool": 4, "drop": ("keeper",), "shrink": 2,
                         "fault": {"nomad": STRAGGLE}},
}
PARTS = ("small", "full")
# scenario -> the checkpoint step every retry leg of every job must restore:
# in the crash cascade the step-2 boundary save lands just before the
# injected ``OSError``, so a retry that restores anything older lost it.
RETRY_RESTORES = {"fleet_crash_cascade": 2}
_CARD = re.compile(r"^leg rank (\d+): card (\{.*\})$", re.M)


def card_scenarios():
    """``fleet_scenarios()`` mapped onto four cards (``CARD_MAP``)."""
    from mpi4dl_tpu_torch.resilience.fleet import fleet_scenarios

    out = []
    for sc in fleet_scenarios():
        m = CARD_MAP[sc.name]
        jobs = tuple(
            dataclasses.replace(j, flags={**j.flags, **m.get("flags", {}).get(j.id, {})},
                                fault=m.get("fault", {}).get(j.id, j.fault))
            for j in sc.jobs if j.id not in m.get("drop", ()))
        kw = {"pool": m["pool"], "jobs": jobs, "deadline_s": SMALL_DEADLINE}
        drop = set(m.get("drop", ()))
        for f in ("expect_done", "expect_untouched", "expect_displaced", "verify_loss"):
            kw[f] = tuple(j for j in getattr(sc, f) if j not in drop)
        if "grow" in m:
            n = m["grow"]
            kw["trigger"] = lambda s, n=n: s.grow_pool(n)
        if "shrink" in m:
            n = m["shrink"]
            kw["trigger"] = lambda s, n=n: s.shrink_pool(n)
        out.append(dataclasses.replace(sc, **kw))
    return out


def full_scenario(flags_text: str):
    """``fleet_preempt_storm`` at ``flags_text``: ``lo`` 4 epochs, then
    ``hi1`` and ``hi2`` at priorities 10 and 9, all on the pool of 4."""
    from mpi4dl_tpu_torch.resilience.__main__ import _flags_from_argv
    from mpi4dl_tpu_torch.resilience.fleet import FleetJob, FleetScenario

    flags = _flags_from_argv(shlex.split(flags_text))
    model = flags.pop("model")
    return FleetScenario(
        "fleet_preempt_storm_full", pool=4,
        jobs=(FleetJob("lo", "sp", {**flags, "num-epochs": 4}, model=model, priority=0),),
        trigger_after="lo",
        trigger=lambda s: (
            s.submit(FleetJob("hi1", "sp", dict(flags), model=model, priority=10)),
            s.submit(FleetJob("hi2", "sp", dict(flags), model=model, priority=9)),
        )[0],
        deadline_s=FULL_DEADLINE,
        expect_done=("lo", "hi1", "hi2"), expect_displaced=("lo",),
        expect_resumed=("lo",), verify_loss=("lo",),
    )


def physical_cards():
    """Each card's identity as a process that sees every card names it
    (``supervisor.card_identity``'s fields: PCI bus id, domain, UUID), one
    subprocess so that this one never initializes CUDA; ``nvidia-smi``'s
    ``index,pci.bus_id,uuid`` is printed beside it for the record."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=index,pci.bus_id,uuid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    code = ("import json, torch\n"
            "out = []\n"
            "for i in range(torch.cuda.device_count()):\n"
            "    p = torch.cuda.get_device_properties(i)\n"
            "    out.append({k: getattr(p, k, None) for k in ('pci_bus_id', 'pci_domain_id')}"
            " | {'uuid': str(getattr(p, 'uuid', '')) or None})\n"
            "print(json.dumps(out))")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, check=True)
    cards = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"cards: {cards}", flush=True)
    return cards


def card_placement(timeline, cards) -> dict:
    """Every rank that named its card: on the slice's card r?  Returns
    ``{"checked": n, "wrong": [...]}``."""
    from mpi4dl_tpu_torch.resilience.supervisor import rank_path

    checked, wrong = 0, []
    for rec in timeline:
        if rec.get("event") != "launch" or not rec.get("env", {}).get("CUDA_VISIBLE_DEVICES"):
            continue
        slice_cards = [int(c) for c in rec["env"]["CUDA_VISIBLE_DEVICES"].split(",")]
        jobdir = os.path.join(rec["workdir"], rec["job"])
        for attempt in sorted(os.listdir(jobdir)) if os.path.isdir(jobdir) else []:
            for r in range(len(slice_cards)):
                try:
                    with open(rank_path(os.path.join(jobdir, attempt, "leg.stderr"), r)) as f:
                        seen = {int(a): json.loads(b) for a, b in _CARD.findall(f.read())}
                except OSError:
                    continue
                if r not in seen:
                    continue
                checked += 1
                card, want = seen[r], cards[slice_cards[r]]
                if card["index"] != r or any(card.get(k) != v for k, v in want.items()):
                    wrong.append({"job": rec["job"], "attempt": attempt, "rank": r,
                                  "want_card": slice_cards[r], "saw": card})
    return {"checked": checked, "wrong": wrong}


def drains(wd, timeline):
    """Each drain: seconds from the request to the job's exit as the
    scheduler saw it (``s``), split at the victim leg's ``preempt`` record
    (the ranks agreed on a step boundary and the checkpoint is durable):
    ``to_saved_s`` and ``saved_to_exit_s`` (process teardown until the
    supervisor saw every rank exit).  The split reads the leg's RunLog and
    the supervisor's summary, both on the wall clock; the fleet's records
    carry the scheduler's own clock, so the request's wall time is the
    summary's less ``s``."""
    from mpi4dl_tpu_torch.obs import read_runlog

    out, open_, launched = [], {}, {}
    for r in timeline:
        ev, job = r.get("event"), r.get("job")
        if ev == "launch":
            launched[job] = r
        elif ev == "drain":
            open_[job] = r
        elif ev in ("drained", "done", "quarantine", "requeue") and job in open_:
            d, lr = open_.pop(job), launched[job]
            row = {"job": job, "why": d.get("note"), "ended": ev,
                   "s": round(r["t"] - d["t"], 3)}
            try:
                summ = read_runlog(os.path.join(
                    wd, "jobs", job, f"supervisor{lr['launch']:02d}.jsonl"))[-1]
                jobdir = os.path.join(lr["workdir"], job)
                adir = os.path.join(jobdir, max(os.listdir(jobdir),
                                                key=lambda n: int(n[len("attempt"):])))
                tele = os.path.join(adir, "tele")
                recs = [x for f in sorted(os.listdir(tele)) if f.endswith(".jsonl")
                        for x in read_runlog(os.path.join(tele, f))]
                pre = next(x for x in recs if x["kind"] == "preempt")
                request = summ["t"] - row["s"]
                row.update(saved_step=pre.get("gstep"),
                           to_saved_s=round(pre["t"] - request, 3),
                           saved_to_exit_s=round(summ["t"] - pre["t"], 3))
            except (OSError, StopIteration, KeyError, ValueError, IndexError):
                pass  # a leg that died before its loop wrote no preempt record
            out.append(row)
    return out


def leg_evidence(swd) -> dict:
    """Each job's legs in order (launch, then attempt): ``attempt``, the
    steps of its ``checkpoint`` records (the saves rank 0 saw published),
    ``restored`` (the step of its ``restore`` record; None when it restored
    nothing) and ``incident``, the supervisor's record of how the leg ended
    (class, crash marker phase and step, each rank's exit), None for a leg
    that completed."""
    from mpi4dl_tpu_torch.obs import read_runlog

    def records(d):
        return [x for f in (sorted(os.listdir(d)) if os.path.isdir(d) else [])
                if f.endswith(".jsonl") for x in read_runlog(os.path.join(d, f))]

    out = {}
    legs = os.path.join(swd, "legs")
    for launch in sorted(os.listdir(legs)) if os.path.isdir(legs) else []:
        for job in sorted(os.listdir(os.path.join(legs, launch))):
            n = sum(1 for rows in out.get(job, []) if rows["attempt"] == 1) + 1
            sup =os.path.join(swd, "jobs", job, f"supervisor{n:02d}.jsonl")
            incidents = {r.get("attempt"): r for r in
                         (read_runlog(sup) if os.path.exists(sup) else [])
                         if r["kind"] == "supervisor"}
            jdir = os.path.join(legs, launch, job)
            for attempt in sorted(os.listdir(jdir), key=lambda a: int(a[len("attempt"):])):
                k = int(attempt[len("attempt"):])
                recs = records(os.path.join(jdir, attempt, "tele"))
                inc = incidents.get(k)
                ev = (inc or {}).get("evidence", {})
                out.setdefault(job, []).append({
                    "launch": launch, "attempt": k,
                    "saved": [x.get("gstep") for x in recs if x["kind"] == "checkpoint"],
                    "restored": next((x.get("step_id") for x in recs
                                      if x["kind"] == "restore"), None),
                    "incident": None if inc is None else {
                        "class": inc.get("failure_class"),
                        "marker_phase": ev.get("marker_phase"),
                        "marker_gstep": ev.get("marker_gstep"),
                        "ranks": ev.get("ranks")}})
    return out


def retry_check(row, swd, want: int, jobs) -> str:
    """Adds ``legs`` (:func:`leg_evidence`) and ``retry_restores`` (each
    job's retry legs' restored steps) to ``row``; returns what is wrong
    (empty when every job of ``jobs`` has a retry and each restored step
    ``want``)."""
    row["legs"] = leg_evidence(swd)
    row["retry_restores"] = {j: [leg["restored"] for leg in row["legs"].get(j, [])
                                 if leg["attempt"] > 1] for j in jobs}
    if all(steps and all(s == want for s in steps)
           for steps in row["retry_restores"].values()):
        return ""
    return f"every retry must restore step {want}: {row['retry_restores']}; legs {row['legs']}"


def _ended(incident) -> str:
    if incident is None:
        return "done"
    ranks = ", ".join(f"r{x['rank']} rc {x['rc']} at {x.get('exit_s')} s"
                      + (" killed" if x.get("killed") else "")
                      for x in incident.get("ranks") or [])
    return (f"{incident['class']} (crash marker: phase {incident['marker_phase']}, step "
            f"{incident['marker_gstep']}; {ranks})")


def run_part(name, scenarios, args, cards) -> dict:
    from mpi4dl_tpu_torch.obs import read_runlog
    from mpi4dl_tpu_torch.resilience.fleet import run_fleet_scenario

    wd = os.path.join(args.workdir, name)
    os.makedirs(wd, exist_ok=True)
    rows = {}
    for sc in scenarios:
        t0 = time.perf_counter()
        v = run_fleet_scenario(sc, wd, log=lambda s: print(s, flush=True),
                               device=args.device)
        secs = time.perf_counter() - t0
        swd = os.path.join(wd, sc.name)
        timeline = [r for r in read_runlog(os.path.join(swd, "fleet.jsonl"))
                    if r["kind"] == "fleet"]
        jobs = v.details.get("jobs_final") or {}
        row = {"verdict": v.kind, "passed": v.passed, "s": round(secs, 1),
               "drains": drains(swd, timeline),
               "relaunches": {j: (x.get("launches") or 0) - 1 for j, x in jobs.items()},
               "jobs": {j: {k: x.get(k) for k in ("state", "launches", "failures",
                                                    "start_step", "loss", "elastic")}
                        for j, x in jobs.items()},
               "loss_gap": {j: v.details[f"final_loss_{j}"] - v.details[f"control_loss_{j}"]
                            for j in sc.verify_loss if f"control_loss_{j}" in v.details},
               "reason": v.details.get("reason") or v.details.get("error")
               or v.details.get("problems")}
        if sc.name in RETRY_RESTORES:
            problem = retry_check(row, swd, RETRY_RESTORES[sc.name], sc.expect_done)
            if problem:
                row["passed"], row["reason"] = False, problem
        if cards is not None:
            row["placement"] = card_placement(timeline, cards)
            row["passed"] = (row["passed"] and not row["placement"]["wrong"]
                             and row["placement"]["checked"] > 0)
        rows[sc.name] = row
        print(f"{name}: {sc.name}: {v.kind} in {secs:.1f} s; drains {row['drains']}; "
              f"relaunches {row['relaunches']}; loss gap {row['loss_gap']}"
              + (f"; retries restored {row['retry_restores']}; legs "
                 + "; ".join(f"{j} {leg['launch']}/attempt{leg['attempt']}: saved "
                             f"{leg['saved']}, restored {leg['restored']}, ended "
                             f"{_ended(leg['incident'])}"
                             for j, legs in row["legs"].items() for leg in legs)
                 if "retry_restores" in row else "")
              + (f"; placement {row['placement']}" if cards is not None else "")
              + ("" if v.passed else f"; {row['reason']}"), flush=True)
    return {"ok": all(r["passed"] for r in rows.values()), "scenarios": rows}


def main(argv=None, parts=PARTS) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scenarios", nargs="+", default=None, metavar="NAME",
                    help="run only these scenarios (the full-width one is "
                         "fleet_preempt_storm_full); a part with none is skipped")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    cards = None
    if args.device == "cuda":
        from mpi4dl_tpu_torch.ops import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        _build.build_kernels()  # once, before the ranks load them
        cards = physical_cards()
    else:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    from mpi4dl_tpu_torch.resilience.fleet import fleet_scenarios

    result = {}
    for part in parts:
        t0 = time.perf_counter()
        if part == "small":
            scs = card_scenarios() if args.device == "cuda" else fleet_scenarios()
        else:
            scs = [full_scenario(FULL_FLAGS if args.device == "cuda" else REHEARSAL_FLAGS)]
        if args.scenarios is not None:
            scs = [sc for sc in scs if sc.name in args.scenarios]
            if not scs:
                continue
        result[part] = run_part(part, scs, args, cards)
        result[part]["s"] = round(time.perf_counter() - t0, 1)
        print(f"part {part}: {'held' if result[part]['ok'] else 'FAILED'} in "
              f"{result[part]['s']} s", flush=True)
    import torch

    result["cuda_initialized_here"] = torch.cuda.is_initialized()
    result["ok"] = (all(r["ok"] for r in result.values() if isinstance(r, dict))
                    and not result["cuda_initialized_here"])
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
