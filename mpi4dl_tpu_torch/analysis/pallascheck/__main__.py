"""CLI: ``python -m mpi4dl_tpu_torch.analysis pallascheck [--json] [--kernels
...] [--baseline F] [--sarif F] [--require-smem-frac X] [--no-sanitize]``
(counterpart of ``python -m mpi4dl_tpu.analysis pallascheck``).

Certifies every ``ops/kernel_registry.py`` row on the card: the resources
of each kernel its call launches (ptxas's report kept by the build, the
library's launch table) and the NaN canary (package docstring).  Exit
status: 0 no finding after the baseline, 1 findings, 2 usage or
environment: with no ptxas report (the kernels were not built on this
machine) or no card it exits 2 and certifies nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List


def main(argv=None) -> int:
    from mpi4dl_tpu_torch.analysis.pallascheck import (
        FINDING_KINDS, EnvironmentProblem, check_registry,
    )
    from mpi4dl_tpu_torch.analysis.pallascheck.sanitize import NOT_RUN, NOT_RUN_REASON
    from mpi4dl_tpu_torch.ops.kernel_registry import REGISTRY, case_names

    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analysis pallascheck",
        description="Hopper kernel certifier of the port: the resources of every kernel "
                    "a registry row launches, and the rows' outputs fully written.  "
                    "Finding kinds: " + ", ".join(FINDING_KINDS))
    ap.add_argument("--kernels", metavar="NAMES", default=None,
                    help="comma-separated subset of registry cases; a bare kernel name "
                         "(e.g. halo_conv2d) selects every variant of it "
                         f"(default: {','.join(c.name for c in REGISTRY)})")
    ap.add_argument("--json", action="store_true", help="machine-readable findings on stdout")
    ap.add_argument("--out", metavar="F", default=None,
                    help="also write the JSON findings to this file")
    ap.add_argument("--baseline", metavar="F", default=None,
                    help="JSON list of accepted findings (kind/kernel/case/message)")
    ap.add_argument("--sarif", metavar="F", default=None,
                    help="write the findings as a SARIF 2.1.0 log")
    ap.add_argument("--require-smem-frac", metavar="X", type=float, default=1.0,
                    help="fail a kernel whose static + dynamic shared memory exceeds X of "
                         "the 227 KiB a block may opt in to (default 1.0)")
    ap.add_argument("--no-sanitize", action="store_true",
                    help="skip the runs of the rows' outputs (the untiled-output canary)")
    args = ap.parse_args(argv)

    if not 0.0 < args.require_smem_frac <= 1.0:
        print(f"pallascheck: --require-smem-frac {args.require_smem_frac} must be in "
              "(0, 1]", file=sys.stderr)
        return 2
    wanted = None
    if args.kernels:
        wanted = [k.strip() for k in args.kernels.split(",") if k.strip()]
        known = {c.name for c in REGISTRY} | {c.name.split(":", 1)[0] for c in REGISTRY}
        unknown = [k for k in wanted if k not in known]
        if unknown:
            print(f"pallascheck: unknown kernel(s) {unknown}; have "
                  f"{[c.name for c in REGISTRY]}", file=sys.stderr)
            return 2
    baseline = None
    if args.baseline:
        with open(args.baseline, "r", encoding="utf-8") as fh:
            baseline = json.load(fh)
        if not isinstance(baseline, list):
            print(f"pallascheck: baseline {args.baseline}: expected a JSON list",
                  file=sys.stderr)
            return 2
    cases = case_names(wanted)

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        findings = check_registry(wanted, args.require_smem_frac,
                                  sanitize=not args.no_sanitize)
    except EnvironmentProblem as e:
        print(f"pallascheck: {e}", file=sys.stderr)
        return 2
    if baseline is not None:
        keys = {(e.get("kind", ""), e.get("kernel", ""), e.get("case", ""),
                 e.get("message", "")) for e in baseline}
        findings = [f for f in findings if f.baseline_key not in keys]

    rows: List[dict] = [f.as_dict() for f in findings]
    payload = json.dumps({"findings": rows, "not_run": sorted(NOT_RUN)}, indent=2,
                         sort_keys=True)
    if args.json:
        print(payload)
    else:
        for f in findings:
            print(f.render())
        print(f"pallascheck: {len(findings)} finding(s) across {len(cases)} registry "
              f"row(s) [smem frac {args.require_smem_frac:g}"
              + ("; no canary" if args.no_sanitize else "") + "]", file=sys.stderr)
    print(f"pallascheck: not run: {', '.join(sorted(NOT_RUN))}: {NOT_RUN_REASON}",
          file=sys.stderr)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(payload + "\n")
    if args.sarif:
        from mpi4dl_tpu_torch.analysis.sarif import finding_results, sarif_log, write_sarif

        write_sarif(args.sarif, sarif_log(extra=finding_results(
            findings, "pallascheck", lambda f: "mpi4dl_tpu_torch/ops/kernel_registry.py")))
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
