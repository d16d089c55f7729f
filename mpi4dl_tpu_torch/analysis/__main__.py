"""CLI: ``python -m mpi4dl_tpu_torch.analysis [--json] [--baseline F] [paths...]``
(counterpart of ``python -m mpi4dl_tpu.analysis``, its source-level gate).

With no paths it scans the port's tree: ``mpi4dl_tpu_torch/``, the port's
tests ``tests/test_torch_*.py`` and ``chip_smoke.py`` (the env-hatch
dead-flag direction needs the whole tree).  Exit status: 0 when no finding
remains after the baseline, 1 otherwise, 2 on usage errors (a path that
does not exist, a scan that finds no python file).

The artifact gates are subcommands, as in the JAX CLI, each with the same
exit codes: ``contracts`` (the recorded-collective contracts,
``analysis/contracts``), ``ircheck`` (the cross-rank wire verifier,
``analysis/ircheck``) and ``pallascheck`` (the Hopper kernel certifier,
``analysis/pallascheck``)::

    python -m mpi4dl_tpu_torch.analysis contracts [--update] [--quant int8]
    python -m mpi4dl_tpu_torch.analysis ircheck [--families lp,sp]
    python -m mpi4dl_tpu_torch.analysis pallascheck   # on a card
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from typing import List, Optional

from mpi4dl_tpu_torch.analysis import (
    RULE_TABLE,
    apply_baseline,
    build_project,
    load_baseline,
    run_rules,
    stale_pragmas,
)


def repo_root() -> str:
    """The directory that holds the ``mpi4dl_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_paths(root: str) -> List[str]:
    out = [os.path.join(root, "mpi4dl_tpu_torch")]
    out += sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py")))
    out.append(os.path.join(root, "chip_smoke.py"))
    return [p for p in out if os.path.exists(p)]


def scope_filter(paths: List[str], scope: List[str]) -> List[str]:
    """Restrict absolute paths to those inside the gate's scope (a scope
    entry is a file to match exactly or a directory prefix)."""
    return [p for p in paths
            if any(p == s or p.startswith(s.rstrip(os.sep) + os.sep) for s in scope)]


# Files whose declarations are the ground truth other modules are checked
# against: the hatch registry, the mesh's groups, the hot scope patterns,
# the kernel registry's imports and the built sources.  An edit there can
# change the findings of unchanged files, so --changed-only widens to the
# whole tree.
CROSS_FILE_GROUND_TRUTH = (
    "mpi4dl_tpu_torch/config.py", "mpi4dl_tpu_torch/mesh.py",
    "mpi4dl_tpu_torch/quant/policy.py", "mpi4dl_tpu_torch/ops/kernel_registry.py",
    "mpi4dl_tpu_torch/ops/_build.py",
)


def cross_file_ground_truth(paths: List[str]) -> List[str]:
    hits = set()
    for p in paths:
        norm = p.replace(os.sep, "/")
        hits.update(g for g in CROSS_FILE_GROUND_TRUTH if norm == g or norm.endswith("/" + g))
    return sorted(hits)


def changed_python_files(root: str) -> Optional[List[str]]:
    """Absolute ``.py`` paths git reports as changed (worktree and index
    against HEAD) or untracked; None when git cannot say."""
    names: List[str] = []
    toplevel = root
    for cmd in (["git", "-C", root, "rev-parse", "--show-toplevel"],
                ["git", "-C", root, "diff", "--name-only", "HEAD"],
                ["git", "-C", root, "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=30,
                                  check=True)
        except (OSError, subprocess.SubprocessError):
            return None
        if cmd[3] == "rev-parse":
            # git names paths from the top level, which may lie above root
            toplevel = proc.stdout.strip() or root
        else:
            names.extend(proc.stdout.splitlines())
    out = []
    for name in dict.fromkeys(names):
        path = os.path.join(toplevel, name)
        if name.endswith(".py") and os.path.exists(path):
            out.append(os.path.abspath(path))
    return out


def _err(msg: str) -> int:
    print(f"analysis: {msg}", file=sys.stderr)
    return 2


SUBCOMMANDS = ("contracts", "ircheck", "pallascheck")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        import importlib

        sub = importlib.import_module(f"mpi4dl_tpu_torch.analysis.{argv[0]}.__main__")
        return sub.main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analysis",
        description="Source-level analyzer of the PyTorch port (README: "
                    "Static analysis of the port).")
    ap.add_argument("paths", nargs="*", help="files/dirs to scan (default: the port's tree)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--baseline", metavar="F", default=None,
                    help="JSON list of accepted findings to filter out")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="rewrite --baseline without its stale entries")
    ap.add_argument("--changed-only", action="store_true",
                    help="scan only files git reports as changed or untracked (the "
                         "dead-flag direction and staleness reports are off)")
    ap.add_argument("--rule", action="append", default=None, metavar="NAME",
                    help="run only the named rule(s)")
    ap.add_argument("--sarif", metavar="F", default=None,
                    help="also write the findings as a SARIF 2.1.0 log")
    ap.add_argument("--prune-pragmas", action="store_true",
                    help="list stale `# analysis: ok(...)` pragmas of a whole-tree "
                         "scan instead of the normal report")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--hatch-docs", action="store_true",
                    help="print the README table of the port's env hatches")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in RULE_TABLE:
            print(f"{r.name}: {r.description}")
        return 0
    if args.hatch_docs:
        from mpi4dl_tpu_torch.config import hatches_markdown

        print(hatches_markdown())
        return 0
    if args.prune_baseline and not args.baseline:
        return _err("--prune-baseline requires --baseline")
    if args.prune_baseline and args.changed_only:
        return _err("--prune-baseline needs a whole-tree scan and cannot be combined "
                    "with --changed-only")
    if args.prune_pragmas and (args.changed_only or args.paths or args.rule):
        return _err("--prune-pragmas needs a whole-tree all-rules scan and cannot be "
                    "combined with --changed-only, --rule or explicit paths")
    for sub in SUBCOMMANDS:
        if sub in args.paths:
            return _err(f"`{sub}` is a subcommand: give it first "
                        f"(python -m mpi4dl_tpu_torch.analysis {sub} ...)")
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        return _err(f"no such file or directory: {', '.join(missing)}")

    root = repo_root()
    partial_scan = False
    if args.changed_only:
        if args.paths:
            return _err("--changed-only and explicit paths are mutually exclusive")
        changed = changed_python_files(root)
        if changed is None:
            print("analysis: git unavailable; --changed-only falling back to a full "
                  "scan", file=sys.stderr)
            paths = default_paths(root)
        else:
            changed = scope_filter(changed, default_paths(root))
            if not changed:
                print("analysis: no changed python files in scope", file=sys.stderr)
                return 0
            widen = cross_file_ground_truth(changed)
            if widen:
                print("analysis: --changed-only: cross-file ground truth changed "
                      f"({', '.join(widen)}); widening to a full scan", file=sys.stderr)
                paths = default_paths(root)
            else:
                paths = changed
                partial_scan = True
    else:
        paths = args.paths or default_paths(root)
    if not paths:
        return _err("nothing to scan")

    rules = RULE_TABLE
    if args.rule:
        by_name = {r.name: r for r in RULE_TABLE}
        unknown = [n for n in args.rule if n not in by_name]
        if unknown:
            return _err(f"unknown rule(s) {unknown}; have {sorted(by_name)}")
        rules = [by_name[n] for n in args.rule]

    project = build_project(paths, root=root)
    if not project.files:
        return _err("no python files to scan")  # an empty scan is no pass
    if partial_scan:
        project.hatch_decl_in_scan = False  # the dead-flag direction needs every reader
    whole_tree = not partial_scan and not args.paths and rules is RULE_TABLE
    used_pragmas = set() if whole_tree else None
    violations = run_rules(project, rules, used_pragmas=used_pragmas)
    if used_pragmas is not None:
        stale_p = stale_pragmas(project, used_pragmas)
        if args.prune_pragmas:
            by_rel = {f.rel: f for f in project.files}
            for v in stale_p:
                lines = by_rel[v.path].text.splitlines()
                text = lines[v.line - 1].strip() if 0 < v.line <= len(lines) else ""
                print(f"{v.path}:{v.line}: {text}")
            print(f"analysis: {len(stale_p)} stale pragma(s) listed for removal",
                  file=sys.stderr)
            return 1 if stale_p else 0
        violations = sorted(violations + stale_p, key=lambda v: (v.path, v.line, v.rule))
    elif args.prune_pragmas:
        return _err("--prune-pragmas needs a whole-tree all-rules scan")

    stale: List[dict] = []
    if args.baseline:
        baseline = load_baseline(args.baseline)
        violations, stale = apply_baseline(violations, baseline)
        if partial_scan:
            stale = []
        if stale and args.prune_baseline:
            kept = [e for e in baseline if e not in stale]
            with open(args.baseline, "w", encoding="utf-8") as fh:
                json.dump(kept, fh, indent=1)
                fh.write("\n")
            print(f"analysis: pruned {len(stale)} stale baseline entries from "
                  f"{args.baseline} ({len(kept)} kept)", file=sys.stderr)

    if args.sarif:
        from mpi4dl_tpu_torch.analysis.sarif import sarif_log, write_sarif

        descriptions = {r.name: r.description for r in RULE_TABLE}
        descriptions["stale-pragma"] = "# analysis: ok(...) pragma that suppresses nothing"
        write_sarif(args.sarif, sarif_log(violations, descriptions))

    if args.json:
        print(json.dumps({
            "violations": [{"rule": v.rule, "path": v.path, "line": v.line,
                            "message": v.message} for v in violations],
            "stale_baseline": stale,
            "files": len(project.files),
            "rules": [r.name for r in rules],
        }, indent=2))
    else:
        for v in violations:
            print(v.render())
        for e in stale:
            print(f"warning: stale baseline entry (no longer fires): {e.get('path')}: "
                  f"[{e.get('rule')}] {e.get('message')}", file=sys.stderr)
        if stale and not args.prune_baseline:
            print(f"warning: {len(stale)} stale baseline entries — rewrite with "
                  "--prune-baseline", file=sys.stderr)
        print(f"analysis: {len(violations)} violation(s) in {len(project.files)} file(s) "
              f"[groups={','.join(project.groups) or '?'}; hatches={len(project.hatches)}]",
              file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
