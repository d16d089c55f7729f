"""CLI (counterpart of ``mpi4dl_tpu/obs/__main__.py``):
``python -m mpi4dl_tpu_torch.obs report run.jsonl [more.jsonl ...]``,
``... report --compare A.jsonl B.jsonl [--threshold PCT]``,
``... report --trend DIR [--trend-out F]``,
``... trace --runlog F --out trace.json``, and
``... metrics run.jsonl|DIR [...] [--out F] [--serve [PORT]]``.

``report`` renders the summary of one or more RunLog files (obs/report.py),
the per-metric regression diff of two, or the directory-wide trajectory +
gate (obs/trend.py).  ``trace`` exports a RunLog's measured walls as
Chrome/Perfetto trace-event JSON (obs/trace.py).  ``metrics`` renders
RunLogs as OpenMetrics text (obs/metrics.py).  The commands read files and
need no device.  ``overlap`` and ``trace --families/--hlo`` read the
compiled program, which the port's telemetry does not analyse yet
(ROADMAP A15, second half): they exit 2 and say so.  Exit status: 0 on
success, 1 when --compare/--trend finds a regression past the threshold,
2 on usage errors or unreadable files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

_NOT_PORTED = ("the compiled-program telemetry (overlap ledger, HLO trace "
               "lanes) is not ported yet (ROADMAP A15, second half)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.obs",
        description="Telemetry surfaces of the PyTorch port's RunLogs.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report",
        help="render RunLog JSONL file(s), or A/B-diff two with --compare",
    )
    rep.add_argument("paths", nargs="*", help="run .jsonl file(s)")
    rep.add_argument(
        "--compare", nargs=2, metavar=("A", "B"), default=None,
        help="per-metric regression diff (A = baseline, B = candidate): "
             "step ms, images/sec, peak HBM, collective bytes, mem_probe "
             "peak, exposed wire ms; exit 1 when a metric regresses past "
             "--threshold",
    )
    rep.add_argument(
        "--threshold", type=float, default=5.0,
        help="regression threshold in percent for --compare/--trend "
             "(default 5)",
    )
    rep.add_argument(
        "--trend", default=None, metavar="DIR",
        help="trajectory + newest-vs-previous regression gate over every "
             "RunLog (*.jsonl) and bench artifact (BENCH_*.json) in DIR; "
             "exit 1 when the newest run of a series regresses past "
             "--threshold",
    )
    rep.add_argument(
        "--trend-out", default=None, metavar="F",
        help="also write the --trend JSON artifact to this file",
    )
    sub.add_parser(
        "overlap", add_help=False,
        help="exposed-wire ledger of the compiled program: not ported yet",
    )
    trc = sub.add_parser(
        "trace",
        help="Chrome/Perfetto trace-event export of a RunLog's measured "
             "step walls, checkpoint saves and resilience events",
    )
    trc.add_argument("--families", default=None,
                     help="compiled engine families: not ported yet")
    trc.add_argument("--hlo", default=None, metavar="F",
                     help="compiled-HLO text dump: not ported yet")
    trc.add_argument("--runlog", default=None, metavar="F",
                     help="measured lanes from this RunLog .jsonl")
    trc.add_argument("--out", default=None, metavar="F", required=True,
                     help="write the trace-event JSON here "
                          "(load in ui.perfetto.dev / chrome://tracing)")
    met = sub.add_parser(
        "metrics",
        help="OpenMetrics/Prometheus text exposition of one or more "
             "RunLogs (many → one job-labeled exposition)",
    )
    met.add_argument("paths", nargs="+", metavar="PATH",
                     help="run .jsonl file(s) and/or directories (a "
                          "directory expands to every *.jsonl under it, "
                          "recursively)")
    met.add_argument("--out", default=None, metavar="F",
                     help="write the exposition here (atomic) instead of "
                          "stdout")
    met.add_argument(
        "--serve", nargs="?", type=int, const=-1, default=None,
        metavar="PORT",
        help="serve /metrics over stdlib HTTP, re-reading the RunLog per "
             "scrape (PORT defaults to the MPI4DL_METRICS_PORT hatch)",
    )
    args, extra = ap.parse_known_args(argv)
    if args.cmd == "overlap":
        print(f"obs overlap: {_NOT_PORTED}", file=sys.stderr)
        return 2
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")

    if args.cmd == "trace":
        return _trace_cmd(args)
    if args.cmd == "metrics":
        return _metrics_cmd(args)

    if args.cmd == "report":
        if args.trend:
            if args.compare or args.paths:
                print("obs report: --trend stands alone; drop --compare "
                      "and positional files", file=sys.stderr)
                return 2
            return _trend_cmd(args)
        if args.compare and args.paths:
            print("obs report: --compare takes exactly two files; drop the "
                  "positional run file(s) or the flag", file=sys.stderr)
            return 2
        if args.compare:
            from mpi4dl_tpu_torch.obs.report import compare_runs

            try:
                text, breaches = compare_runs(
                    args.compare[0], args.compare[1], args.threshold
                )
            except OSError as e:
                print(f"obs report: cannot read compare input: {e}",
                      file=sys.stderr)
                return 2
            print(text)
            return 1 if breaches else 0
        if not args.paths:
            print("obs report: need run file(s) or --compare A B",
                  file=sys.stderr)
            return 2
        from mpi4dl_tpu_torch.obs.report import render_run

        for i, path in enumerate(args.paths):
            try:
                text = render_run(path)
            except OSError as e:
                print(f"obs report: cannot read {path}: {e}", file=sys.stderr)
                return 2
            if i:
                print()
            print(text)
        return 0
    return 2  # pragma: no cover — argparse enforces the subcommand


def _trace_cmd(args) -> int:
    """``obs trace --runlog F``: Chrome/Perfetto trace-event JSON of a
    RunLog's measured lanes."""
    from mpi4dl_tpu_torch.obs.runlog import read_runlog
    from mpi4dl_tpu_torch.obs.trace import chrome_trace, trace_from_runlog

    if args.hlo or args.families:
        print(f"obs trace: --families/--hlo: {_NOT_PORTED}", file=sys.stderr)
        return 2
    if not args.runlog:
        print("obs trace: need --runlog", file=sys.stderr)
        return 2
    try:
        records = read_runlog(args.runlog)
    except OSError as e:
        print(f"obs trace: cannot read {args.runlog}: {e}", file=sys.stderr)
        return 2
    events = trace_from_runlog(records, label=args.runlog)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(chrome_trace(events), fh)
        fh.write("\n")
    print(f"obs trace: wrote {len(events)} events to {args.out}")
    return 0


def _metrics_paths(raw: List[str]) -> List[str]:
    """Expand the metrics CLI's positional args: files pass through,
    directories expand to every ``*.jsonl`` under them (recursive,
    sorted)."""
    import glob

    out: List[str] = []
    for p in raw:
        if os.path.isdir(p):
            out.extend(sorted(
                glob.glob(os.path.join(p, "**", "*.jsonl"), recursive=True)
            ))
        else:
            out.append(p)
    return out


def _metrics_cmd(args) -> int:
    """``obs metrics``: OpenMetrics exposition of RunLog(s) — stdout,
    atomic file sink, and/or the stdlib HTTP endpoint.  Multiple inputs
    aggregate into ONE ``job``-labeled exposition."""
    from mpi4dl_tpu_torch.obs.metrics import (
        _atomic_write,
        metrics_from_runlog,
        metrics_from_runlogs,
        metrics_port_from_env,
        serve_metrics,
        write_metrics_file,
    )
    from mpi4dl_tpu_torch.obs.runlog import read_runlog

    paths = _metrics_paths(args.paths)
    if not paths:
        print(f"obs metrics: no .jsonl files in {args.paths}",
              file=sys.stderr)
        return 2
    single = paths[0] if len(paths) == 1 else None
    try:
        if single is not None and args.out:
            write_metrics_file(read_runlog(single), args.out)
            print(f"obs metrics: wrote {args.out}")
        elif args.out:
            _atomic_write(metrics_from_runlogs(paths), args.out)
            print(f"obs metrics: wrote {args.out} "
                  f"({len(paths)} runlogs, job-labeled)")
        elif args.serve is None:
            sys.stdout.write(metrics_from_runlog(single) if single
                             else metrics_from_runlogs(paths))
    except OSError as e:
        print(f"obs metrics: cannot read input: {e}", file=sys.stderr)
        return 2
    if args.serve is not None:
        port = args.serve if args.serve >= 0 else metrics_port_from_env()
        if port is None:
            print("obs metrics: --serve needs a PORT (or set "
                  "MPI4DL_METRICS_PORT)", file=sys.stderr)
            return 2
        srv = serve_metrics(single if single is not None else paths, port)
        host, bound = srv.server_address[0], srv.server_address[1]
        print(f"obs metrics: serving http://{host}:{bound}/metrics "
              "(Ctrl-C to stop)", file=sys.stderr)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
    return 0


def _trend_cmd(args) -> int:
    """``obs report --trend DIR``: trajectory + per-series regression gate
    (obs/trend.py).  Exit 1 on a gated breach."""
    from mpi4dl_tpu_torch.obs.trend import format_trend, trend_report

    if not os.path.isdir(args.trend):
        print(f"obs report: --trend {args.trend}: not a directory",
              file=sys.stderr)
        return 2
    trend = trend_report(args.trend, threshold_pct=args.threshold)
    # Artifact before stdout — a truncated pipe must not cost CI the JSON.
    if args.trend_out:
        with open(args.trend_out, "w", encoding="utf-8") as fh:
            json.dump(trend, fh, indent=1, sort_keys=True)
            fh.write("\n")
    print(format_trend(trend))
    return 1 if trend["breaches"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
