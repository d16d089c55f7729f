"""CLI: ``python -m mpi4dl_tpu_torch.analysis ircheck [--json] [--families ...]
[--baseline F] [--sarif F] [--quant SPEC]`` (counterpart of ``python -m
mpi4dl_tpu.analysis ircheck``).

Runs every rank role of each engine family on the ``fake`` group (several
processes at once) and every cross-rank check over them (the package
docstring's finding kinds).  Exit status: 0 no finding after the baseline,
1 findings, 2 usage or environment.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List


def main(argv=None) -> int:
    from mpi4dl_tpu_torch.analysis.contracts.engines import default_jobs, extract_many
    from mpi4dl_tpu_torch.analysis.ircheck import FINDING_KINDS, check_roles
    from mpi4dl_tpu_torch.obs.families import ENGINE_FAMILIES

    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analysis ircheck",
        description="Cross-rank wire verifier of the port: record every rank of each "
                    "engine family on the fake group and match the ranks' collectives, "
                    "point-to-point ops, async handles and replication flow.  Finding "
                    "kinds: " + ", ".join(FINDING_KINDS))
    ap.add_argument("--families", metavar="NAMES", default=None,
                    help=f"comma-separated subset (default: {','.join(ENGINE_FAMILIES)})")
    ap.add_argument("--json", action="store_true", help="machine-readable findings on stdout")
    ap.add_argument("--out", metavar="F", default=None,
                    help="also write the JSON findings to this file")
    ap.add_argument("--baseline", metavar="F", default=None,
                    help="JSON list of accepted findings (kind/family/scope/message)")
    ap.add_argument("--sarif", metavar="F", default=None,
                    help="write the findings as a SARIF 2.1.0 log")
    ap.add_argument("--quant", metavar="SPEC", default=None,
                    help="verify the quantized-collective build (e.g. int8)")
    ap.add_argument("--jobs", type=int, default=None,
                    help=f"role processes at once (default {default_jobs()})")
    args = ap.parse_args(argv)

    families = list(ENGINE_FAMILIES)
    if args.families:
        families = [f.strip() for f in args.families.split(",") if f.strip()]
        unknown = [f for f in families if f not in ENGINE_FAMILIES]
        if unknown:
            print(f"ircheck: unknown engine(s) {unknown}; have {list(ENGINE_FAMILIES)}",
                  file=sys.stderr)
            return 2
    if args.quant:
        from mpi4dl_tpu_torch.quant import QuantPolicy

        try:
            policy = QuantPolicy.parse(args.quant)
        except ValueError as e:
            print(f"ircheck: {e}", file=sys.stderr)
            return 2
        if policy is None:
            print("ircheck: --quant off is the raw build; drop the flag", file=sys.stderr)
            return 2
    baseline = None
    if args.baseline:
        with open(args.baseline, "r", encoding="utf-8") as fh:
            baseline = json.load(fh)
        if not isinstance(baseline, list):
            print(f"ircheck: baseline {args.baseline}: expected a JSON list", file=sys.stderr)
            return 2

    roles = extract_many(families, quant=args.quant, jobs=args.jobs)
    findings = [f for family in families for f in check_roles(roles[family], family)]
    if baseline is not None:
        keys = {(e.get("kind", ""), e.get("family", ""), e.get("scope", ""),
                 e.get("message", "")) for e in baseline}
        findings = [f for f in findings if f.baseline_key not in keys]

    rows: List[dict] = [f.as_dict() for f in findings]
    payload = json.dumps({"findings": rows}, indent=2, sort_keys=True)
    if args.json:
        print(payload)
    else:
        for f in findings:
            print(f.render())
        print(f"ircheck: {len(findings)} finding(s) across {len(families)} engine famil"
              f"{'y' if len(families) == 1 else 'ies'}"
              + (f" [quant {args.quant}]" if args.quant else ""), file=sys.stderr)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(payload + "\n")
    if args.sarif:
        from mpi4dl_tpu_torch.analysis.sarif import finding_results, sarif_log, write_sarif

        write_sarif(args.sarif, sarif_log(extra=finding_results(
            findings, "ircheck", lambda f: "mpi4dl_tpu_torch/obs/families.py")))
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
