"""The memory probe and the elastic supervisor on four cards (or on four
gloo ranks with ``--device cpu``), in one job.

    python -m mpi4dl_tpu_torch.benchmarks.supervisor_check --workdir DIR

This process starts every rank itself (the supervisor's rank-set launcher,
``resilience.supervisor.subprocess_leg_launcher``) and never initializes
CUDA.  Three parts, each printing its lines:

1. ``probe``: for the ``sp`` runner, AmoebaNet-D(18, 416) 2048² bs1 on 2x2
   ranks, D2, and the ``lp`` runner over 4 stages, 1024² bs4 in 4
   micro-batches (both bf16, the kernels on, remat off):
   ``benchmarks.mem_probe`` (the ``lp`` one with ``--schedule both
   --require-1f1b-win``, which must exit 0), then one training step of
   each schedule on the ranks, and each rank's
   ``torch.cuda.max_memory_allocated`` (its ``rank r: peak`` line) beside
   its role's probed peak, which must lie within ``PROBE_TOLERANCE`` of it
   on every rank.
2. ``drill``: ``drill --supervisor``'s four scenarios (ResNet 32², the
   ``sp`` family).  The two OOM scenarios degrade out of the JAX package's
   SP(2x2) x PP(2), eight ranks; here they run at SP(1x2) x PP(2), parts 4,
   four ranks (``OOM_GEOMETRY``), given through
   ``dataclasses.replace(sc, overrides=...)``.  Every verdict must be
   ``verified_recovery``.
3. ``oom``: one real allocator OOM degraded and resumed elastically:
   ``python -m mpi4dl_tpu_torch.resilience supervise`` on the ``sp`` runner
   at 6144² (where the probe puts the step at the card's whole memory, and
   the ladder's junction + stripe-wise-backward rung below ``BUDGET_GB``),
   2 steps.  It must end with exit 0 after an
   ``oom_compile`` incident answered by a probed ``degrade`` and an elastic
   restore.

``--device cpu`` rehearses the three parts on gloo ranks at the small
geometry of ``REHEARSAL`` (no card: the first leg's OOM is injected,
``oom_compile@0``, and the probe has no card peak to meet).  A caller in
Python picks parts with ``main(argv, parts=("probe",))``.

On cards the first line is each card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``); the last line is one JSON
object with every number, then ``ok`` when every part held (exit 1
otherwise).
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

WIDTH = ("--model amoebanet --num-layers 18 --num-filters 416 --num-classes 1000 "
         "--precision bf_16 --pallas-conv --no-remat")
SP_FLAGS = WIDTH + " --image-size 2048 --batch-size 1 --num-spatial-parts 4 --halo-d2"
LP_FLAGS = WIDTH + " --image-size 1024 --batch-size 4 --parts 4 --split-size 4"
OOM_GEOMETRY = "--split-size 2 --parts 4 --slice-method vertical --num-spatial-parts 2"
OOM_FLAGS = WIDTH + " --batch-size 1 --num-spatial-parts 4 --halo-d2"
ON_CARD = {"sp": SP_FLAGS, "lp": LP_FLAGS, "oom": OOM_FLAGS, "oom_image": 6144}
_SMALL_SP = ("--model amoebanet --num-layers 3 --num-filters 16 --batch-size 1 "
             "--num-spatial-parts 4 --halo-d2 --pallas-conv --precision bf_16")
REHEARSAL = {"sp": _SMALL_SP + " --image-size 256 --spatial-until 4",
             "lp": "--model resnet --image-size 32 --num-layers 1 --batch-size 4 --parts 4 "
                   "--split-size 4",
             "oom": _SMALL_SP, "oom_image": 256}
BUDGET_GB = 76.0  # the probe's budget for a degraded geometry, GiB a card
TIMEOUT = 900.0  # seconds a leg
# How far a rank's probed peak may lie from its card's max_memory_allocated
# (chip_smoke.py's phase 25 holds the one-card probe to the same bound).
PROBE_TOLERANCE = 0.15
PARTS = ("probe", "drill", "oom")
_PEAK = re.compile(r"^rank (\d+): peak [0-9.]+ GiB \((\d+) bytes\)", re.M)


def _flags(text: str) -> dict:
    from mpi4dl_tpu_torch.resilience.__main__ import _flags_from_argv

    return _flags_from_argv(shlex.split(text))


def _rank_peaks(adir: str, world: int) -> list:
    """Each rank's ``max_memory_allocated`` from its ``rank r: peak`` line
    (None on the CPU)."""
    from mpi4dl_tpu_torch.resilience.supervisor import rank_path

    out = []
    for r in range(world):
        try:
            with open(rank_path(os.path.join(adir, "leg.stderr"), r)) as f:
                got = {int(a): int(b) for a, b in _PEAK.findall(f.read())}
        except OSError:
            got = {}
        out.append(got.get(r))
    return out


def _probe(family: str, flags: str, schedule: str, gate: bool, out: str) -> dict:
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.mem_probe", "--family", family,
           "--schedule", schedule, "--out", out, *shlex.split(flags)]
    if gate:
        cmd.append("--require-1f1b-win")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stderr[-600:], end="", flush=True)
    data = json.load(open(out)) if os.path.exists(out) else {}
    return {"rc": proc.returncode, "s": round(time.perf_counter() - t0, 1),
            "schedules": {s: {"peak_bytes": r["peak_bytes"],
                              "roles": {x["rank"]: x["peak_bytes"] for x in r["roles"]}}
                          for s, r in (data.get("schedules") or {}).items()},
            "win_1f1b_bytes": data.get("win_1f1b_bytes")}


def _geometry(args) -> dict:
    return ON_CARD if args.device == "cuda" else REHEARSAL


def part_probe(args) -> dict:
    """Part 1: probe against each card's peak."""
    from mpi4dl_tpu_torch.benchmarks.mem_probe import mesh_spec
    from mpi4dl_tpu_torch.config import config_from_args, get_parser
    from mpi4dl_tpu_torch.resilience.supervisor import subprocess_leg_launcher

    rows = {}
    geo = _geometry(args)
    gaps_held = True
    for name, family, flags, schedules in (("sp", "sp", geo["sp"], ["gpipe"]),
                                           ("lp", "lp", geo["lp"], ["gpipe", "1f1b"])):
        wd = os.path.join(args.workdir, "probe", name)
        os.makedirs(wd, exist_ok=True)
        probed = _probe(family, flags, "both" if len(schedules) == 2 else schedules[0],
                        len(schedules) == 2, os.path.join(wd, "probe.json"))
        cfg = config_from_args(get_parser().parse_args(shlex.split(flags)))
        spec = mesh_spec(cfg, family)
        tiles = spec.sph * spec.spw
        for s in schedules:
            leg_flags = {**_flags(flags), "schedule": s, "steps-per-epoch": 1,
                         "num-epochs": 1, **({"device": "cpu"} if args.device == "cpu" else {})}
            launch = subprocess_leg_launcher(family, "amoebanet", os.path.join(wd, s),
                                             timeout=TIMEOUT)
            t0 = time.perf_counter()
            leg = launch(leg_flags, {}, 1)
            card = _rank_peaks(os.path.join(wd, s, "attempt1"), spec.size)
            row = probed["schedules"].get(s, {})
            ranks = []
            for r, peak in enumerate(card):
                stage = (r // tiles) % spec.stage
                p = (row.get("roles") or {}).get(stage * tiles)
                gap = (p - peak) / peak if p and peak else None
                if args.device == "cuda":
                    gaps_held &= gap is not None and abs(gap) <= PROBE_TOLERANCE
                ranks.append({"rank": r, "card_bytes": peak, "probe_bytes": p, "gap": gap})
                print(f"probe: {name} {s} rank {r}: card {peak} B, probe {p} B"
                      + (f", gap {100 * gap:+.2f}%" if gap is not None else ""),
                      flush=True)
            rows[f"{name}_{s}"] = {"leg_rc": leg.rc, "leg_s": round(time.perf_counter() - t0, 1),
                                   "loss": (leg.result or {}).get("loss"), "ranks": ranks}
        rows[f"{name}_probe"] = probed
        print(f"probe: {name}: mem_probe rc {probed['rc']} in {probed['s']} s"
              + (f", 1F1B wins by {probed['win_1f1b_bytes']} bytes" if len(schedules) == 2
                 else ""), flush=True)
    ok = (all(v.get("rc", 0) == 0 and v.get("leg_rc", 0) == 0 for v in rows.values())
          and (rows["lp_probe"]["win_1f1b_bytes"] or 0) > 0 and gaps_held)
    return {"ok": ok, **rows}


def part_drill(args) -> dict:
    """Part 2: the supervisor drill matrix at four ranks."""
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.resilience.drill import run_supervisor_drills, supervisor_scenarios

    device = {"device": "cpu"} if args.device == "cpu" else {}
    scenarios = [dataclasses.replace(sc, overrides={**sc.overrides, **(
        _flags(OOM_GEOMETRY) if sc.probe else {}), **device})
        for sc in supervisor_scenarios()]
    wd = os.path.join(args.workdir, "drill")
    os.makedirs(wd, exist_ok=True)
    runlog = RunLog.create(wd, prefix="drill")
    t0 = time.perf_counter()
    try:
        verdicts = run_supervisor_drills(scenarios, wd, family="sp", model="resnet",
                                         runlog=runlog, log=lambda s: print(s, flush=True))
    finally:
        runlog.close()
    recs = []
    for v in verdicts:
        first = (v.details.get("incidents") or [{}])[0]
        recs.append({"scenario": v.scenario, "verdict": v.kind, "passed": v.passed,
                     "attempts": v.details.get("attempts"),
                     "failure_class": first.get("failure_class"),
                     "policy": first.get("policy"), "config_delta": first.get("config_delta"),
                     "probe": first.get("probe"), "final_loss": v.details.get("final_loss"),
                     "control_loss": v.details.get("control_loss"),
                     "reason": v.details.get("reason")})
        print(f"drill: {v.scenario}: {v.kind}" + (f" ({v.details.get('reason')})"
                                                  if not v.passed else ""), flush=True)
    return {"ok": all(v.passed for v in verdicts), "s": round(time.perf_counter() - t0, 1),
            "verdicts": recs}


def part_oom(args) -> dict:
    """Part 3: one real OOM, degraded and resumed elastically."""
    from mpi4dl_tpu_torch.obs import read_runlog

    wd = os.path.join(args.workdir, "oom")
    geo = _geometry(args)
    flags = shlex.split(geo["oom"]) + ["--image-size", str(geo["oom_image"]),
                                       "--steps-per-epoch", "2", "--num-epochs", "1"]
    env = {**os.environ, "MPI4DL_SUPERVISE_BACKOFF": "0.1"}
    if args.device == "cpu":
        # No allocator to exhaust: the first leg's OOM is injected.
        flags += ["--device", "cpu"]
        env["MPI4DL_FAULT"] = "oom_compile@0"
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.resilience", "supervise", "--family", "sp",
           "--model", "amoebanet", "--out", wd, "--budget-gb", str(BUDGET_GB), "--", *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    secs = time.perf_counter() - t0
    print(proc.stdout[-3000:], proc.stderr[-1500:], sep="", end="", flush=True)
    logs = sorted(f for f in os.listdir(wd) if f.endswith(".jsonl")) if os.path.isdir(wd) else []
    recs = read_runlog(os.path.join(wd, logs[-1])) if logs else []
    incidents = [r for r in recs if r["kind"] == "supervisor"]
    summary = next((r for r in recs if r["kind"] == "supervisor_summary"), {})
    legs = os.path.join(wd, "legs")
    attempts = sorted(os.listdir(legs)) if os.path.isdir(legs) else []
    final = {}
    if attempts:
        try:
            with open(os.path.join(legs, attempts[-1], "leg_result.json")) as f:
                final = json.load(f)
        except (OSError, ValueError):
            final = {}
    world = 4
    peaks = {a: _rank_peaks(os.path.join(legs, a), world) for a in attempts}
    first = incidents[0] if incidents else {}
    out = {"rc": proc.returncode, "s": round(secs, 1), "attempts": summary.get("attempts"),
           "incidents": [{k: i.get(k) for k in ("attempt", "failure_class", "policy",
                                                 "config_delta", "plan_rungs", "probe", "note")}
                          for i in incidents],
           "marker_error": (first.get("evidence") or {}).get("marker_error"),
           "ranks": (first.get("evidence") or {}).get("ranks"),
           "final_flags": summary.get("final_flags"), "final_env": summary.get("final_env"),
           "final_loss": final.get("loss"), "final_elastic": final.get("elastic"),
           "final_start_step": final.get("start_step"), "final_step": final.get("final_step"),
           "rank_peaks": peaks}
    out["ok"] = (proc.returncode == 0 and first.get("failure_class") == "oom_compile"
                 and first.get("policy") == "degrade"
                 and "probe_peak_gb" in (first.get("probe") or {})
                 and bool(final.get("elastic")))
    print(f"oom: rc {proc.returncode} in {secs:.1f} s, incidents "
          f"{[(i['failure_class'], i['policy'], i.get('plan_rungs')) for i in incidents]}, "
          f"final elastic {final.get('elastic')} loss {final.get('loss')}", flush=True)
    return out


def main(argv=None, parts=PARTS) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.device == "cuda":
        from mpi4dl_tpu_torch.ops import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        _build.build_kernels()  # once, before the ranks load them
    result = {}
    for part in parts:
        t0 = time.perf_counter()
        result[part] = {"probe": part_probe, "drill": part_drill, "oom": part_oom}[part](args)
        print(f"part {part}: {'held' if result[part]['ok'] else 'FAILED'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    import torch

    result["cuda_initialized_here"] = torch.cuda.is_initialized()
    print(json.dumps(result), flush=True)
    ok = all(r["ok"] for k, r in result.items() if isinstance(r, dict))
    print("ok" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
