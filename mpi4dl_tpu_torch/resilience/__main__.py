"""CLI: ``python -m mpi4dl_tpu_torch.resilience`` — drills, the elastic
supervisor and its leg entry point (counterpart of
``mpi4dl_tpu/resilience/__main__.py``).

``drill``
    The fault drill matrix (kill/resume, crash/resume, corrupt-newest,
    NaN-rollback, lost-shard, reshape) against the runner entry point, each
    leg a rank set, with typed per-scenario ``drill`` RunLog verdicts;
    ``--toy`` runs it on the toy step in this process.  ``--supervisor``
    runs the SUPERVISOR scenario matrix instead (clean / oom-degrade /
    oom-step-degrade / transient-io): fault into leg 1 only, judge the
    classification, the feasibility-probed degrade, the elastic resume and
    the final loss against a control.  ``--fleet`` runs the FLEET chaos
    matrix (slice kill, preempt storm, crash cascade, OOM poison,
    re-expansion: :func:`~mpi4dl_tpu_torch.resilience.fleet.fleet_scenarios`)
    through the multi-tenant scheduler, its slices on the visible cards, or
    on gloo ranks with ``--device cpu`` (pool 8, the JAX geometry)::

        python -m mpi4dl_tpu_torch.resilience drill --fleet --device cpu --out fleet_out

``supervise``
    Run one training job under the elastic supervisor: legs as rank sets,
    typed failure classification, per-class retry/backoff, degrade-and-
    continue re-planning.  Runner flags go after ``--``::

        python -m mpi4dl_tpu_torch.resilience supervise --family sp --out sup \\
            -- --image-size 32 --num-layers 1 --batch-size 4 --device cpu

``leg``
    One rank of one training leg in this process (what ``supervise``
    launches, ``RANK``/``WORLD_SIZE``/``MASTER_*`` in its environment).
    Writes rank 0's summary JSON for the supervisor and guarantees a crash
    marker on every failure path; a failing rank leaves at once (its peers
    may be blocked in a collective that would hold its exit).

Exit status 0 only on full success (every drill scenario verified / the
supervised job completed)."""

from __future__ import annotations

import argparse
import json
import os
import sys


def _split_argv(argv):
    """Split ``[...supervisor flags..., '--', ...bench flags...]``; also
    returns the full original argv (RunLog provenance must record what
    this invocation actually ran with, not the host process's argv)."""
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--" in argv:
        i = argv.index("--")
        return argv[:i], argv[i + 1:], argv
    return argv, [], argv


def _flags_from_argv(bench_argv):
    """Bench argv → the flag dict the supervisor mutates (``--a 1 --b`` →
    ``{"a": "1", "b": True}``)."""
    flags = {}
    i = 0
    while i < len(bench_argv):
        tok = bench_argv[i]
        if not tok.startswith("--"):
            raise SystemExit(f"supervise: cannot parse bench flag {tok!r} "
                             "(expected --flag [value] pairs after --)")
        key = tok[2:]
        if i + 1 < len(bench_argv) and not bench_argv[i + 1].startswith("--"):
            flags[key] = bench_argv[i + 1]
            i += 2
        else:
            flags[key] = True
            i += 1
    return flags


def _cmd_drill(args, parser, full_argv) -> int:
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.resilience.drill import (
        bench_runner,
        default_scenarios,
        run_drills,
        run_supervisor_drills,
        supervisor_scenarios,
        toy_runner,
    )

    if args.fleet and args.supervisor:
        parser.error("--fleet and --supervisor are mutually exclusive")
    os.makedirs(args.out, exist_ok=True)
    if args.fleet:
        from mpi4dl_tpu_torch.resilience.fleet import fleet_scenarios

        scenarios = fleet_scenarios()
    elif args.supervisor:
        scenarios = supervisor_scenarios()
    else:
        scenarios = default_scenarios(reshape_spec=args.reshape)
    if args.scenarios:
        want = {s.strip() for s in args.scenarios.split(",") if s.strip()}
        unknown = want - {s.name for s in scenarios}
        if unknown:
            parser.error(f"unknown scenario(s) {sorted(unknown)}; have "
                         f"{[s.name for s in scenarios]}")
        scenarios = [s for s in scenarios if s.name in want]

    runlog = RunLog.create(args.out, prefix="drill")
    runlog.write_meta(family=args.family, model=args.model,
                      scenarios=[s.name for s in scenarios],
                      toy=args.toy, supervisor=args.supervisor,
                      fleet=args.fleet, argv=list(full_argv))
    try:
        if args.fleet:
            from mpi4dl_tpu_torch.resilience.fleet import run_fleet_drills

            verdicts = run_fleet_drills(scenarios, args.out, runlog=runlog,
                                        log=print, device=args.device)
        elif args.supervisor:
            verdicts = run_supervisor_drills(
                scenarios, args.out, family=args.family, model=args.model,
                runlog=runlog, log=print,
            )
        else:
            runner = toy_runner() if args.toy else bench_runner(args.family, args.model)
            verdicts = run_drills(runner, scenarios, args.out,
                                  runlog=runlog, log=print)
    finally:
        runlog.close()

    failed = [v for v in verdicts if not v.passed]
    print(f"\ndrill matrix: {len(verdicts) - len(failed)}/{len(verdicts)} "
          f"verified recoveries (runlog: {runlog.path})")
    for v in verdicts:
        mark = "PASS" if v.passed else "FAIL"
        print(f"  {mark} {v.scenario:20s} {v.kind}"
              + ("" if v.passed else f" — {v.details.get('reason', '')}"))
    return 1 if failed else 0


def _cmd_supervise(args, bench_argv, full_argv) -> int:
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.resilience.planner import compile_probe
    from mpi4dl_tpu_torch.resilience.supervisor import Supervisor

    flags = _flags_from_argv(bench_argv)
    os.makedirs(args.out, exist_ok=True)
    if "checkpoint-dir" not in flags:
        # Degrade-and-continue NEEDS a restore point; a supervised job
        # without one would re-train from scratch on every relaunch.
        flags["checkpoint-dir"] = os.path.join(args.out, "ck")
        print(f"note: no --checkpoint-dir in bench flags; using "
              f"{flags['checkpoint-dir']}")
    runlog = RunLog.create(args.out, prefix="supervisor")
    runlog.write("meta_supervisor", family=args.family, model=args.model,
                 flags=dict(flags), budget_gb=args.budget_gb,
                 argv=list(full_argv))
    probe = None
    if not args.no_probe:
        probe = compile_probe(
            args.family, args.model,
            log=lambda s: print(s, file=sys.stderr),
        )
    try:
        sup = Supervisor(
            args.family, args.model, flags,
            workdir=os.path.join(args.out, "legs"),
            runlog=runlog,
            probe=probe,
            budget_gb=args.budget_gb,
            max_attempts=args.max_attempts,
            fault=os.environ.get("MPI4DL_FAULT", ""),
            seed=args.seed,
            log=print,
        )
        res = sup.run()
    finally:
        runlog.close()
    if res.ok:
        print(f"supervised job completed after {res.attempts} leg(s), "
              f"{len(res.incidents)} incident(s); final flags: "
              f"{json.dumps(res.flags)}")
        return 0
    print(f"supervised job FAILED after {res.attempts} leg(s): "
          f"{res.reason}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    argv, bench_argv, full_argv = _split_argv(argv)
    parser = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.resilience",
        description="resilience subsystem CLI",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser(
        "drill",
        help="run a fault drill matrix and emit RunLog verdicts",
    )
    d.add_argument("--out", default="drill_out",
                   help="work/telemetry directory (default: drill_out)")
    d.add_argument("--scenarios", default=None,
                   help="comma-list subset of scenario names (default: all)")
    d.add_argument("--family", default="sp",
                   help="benchmark family for the legs (default: sp)")
    d.add_argument("--model", default="resnet")
    d.add_argument("--reshape", default="slice-method=horizontal,parts=2",
                   metavar="SPEC",
                   help="resume-side geometry skew for the reshape drill "
                        "(flag=value[,flag=value...])")
    d.add_argument("--toy", action="store_true",
                   help="run the toy harness instead of the runners "
                        "(machinery smoke, in this process)")
    d.add_argument("--supervisor", action="store_true",
                   help="run the SUPERVISOR scenario matrix (classification"
                        " + degrade-and-continue + backoff) instead of the "
                        "single-leg matrix")
    d.add_argument("--fleet", action="store_true",
                   help="run the FLEET chaos matrix (multi-tenant scheduler: "
                        "slice kill, preemption, crash cascade, OOM poison, "
                        "re-expansion) instead of the single-leg matrix")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="--fleet: slices of the visible cards (default; "
                        "raises with none) or gloo ranks (cpu)")

    s = sub.add_parser(
        "supervise",
        help="run one training job under the elastic supervisor "
             "(bench flags after --)",
    )
    s.add_argument("--family", default="sp")
    s.add_argument("--model", default="resnet")
    s.add_argument("--out", default="supervise_out",
                   help="work/telemetry directory")
    s.add_argument("--max-attempts", type=int, default=None,
                   help="total leg launches (default: "
                        "MPI4DL_SUPERVISE_MAX_ATTEMPTS, else 6)")
    s.add_argument("--budget-gb", type=float, default=None,
                   help="per-card memory budget the feasibility probe gates "
                        "degraded configs against (default: none — a config "
                        "is feasible when the probe builds and steps it)")
    s.add_argument("--no-probe", action="store_true",
                   help="skip the feasibility probe before degraded "
                        "relaunches")
    s.add_argument("--seed", type=int, default=0,
                   help="backoff-jitter seed (de-synchronizes fleets)")

    l = sub.add_parser(
        "leg",
        help="one rank of one training leg (what supervise launches)",
    )
    l.add_argument("--family", required=True)
    l.add_argument("--model", default="resnet")
    l.add_argument("--result", default=None,
                   help="write the leg's summary dict here as JSON")

    args = parser.parse_args(argv)
    if args.cmd == "drill":
        return _cmd_drill(args, parser, full_argv)
    if args.cmd == "supervise":
        return _cmd_supervise(args, bench_argv, full_argv)
    return _cmd_leg(args, bench_argv)


def _cmd_leg(args, bench_argv) -> int:
    """One rank of a leg; on any failure it prints the traceback and leaves
    at once with exit code 1 (``os._exit``: a live NCCL or gloo group must
    not hold the exit while a peer waits in a collective)."""
    import traceback

    from mpi4dl_tpu_torch.resilience.supervisor import run_leg

    try:
        return run_leg(args.family, args.model, bench_argv, args.result)
    except Exception:  # noqa: BLE001 — the marker is written; leave now
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
