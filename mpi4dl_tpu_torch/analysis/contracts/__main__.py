"""CLI: ``python -m mpi4dl_tpu_torch.analysis contracts [--update] [--json]``
(counterpart of ``python -m mpi4dl_tpu.analysis contracts``).

Extracts each family's contract (every rank role on real CPU tensors on the
``fake`` group, several processes at once) and diffs it against the golden
under ``mpi4dl_tpu_torch/analysis/contracts/goldens/``.  Exit status: 0 no
drift, 1 drift or a missing golden, 2 usage or environment.  ``--update``
rewrites the goldens; ``--json`` prints the machine-readable diff; ``--out
F`` also writes it.  ``--quant SPEC`` extracts the quantized build against
``goldens/quant_<mode>/`` and gates each family's junction, respatial and
gradient bytes at ``--max-ratio`` x the raw golden's.  The pseudo-family
``kernels`` (the JAX gate's ``pallas``) diffs the Hopper kernels' resources
(``goldens/kernels.json``, ``analysis/pallascheck``): it needs the built
libraries and a card, so it runs only when ``--engines`` names it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List


def default_contracts_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def golden_path(directory: str, family: str) -> str:
    return os.path.join(directory, f"{family}.json")


def quant_dir(raw_directory: str, spec: str) -> str:
    return os.path.join(raw_directory, "quant_" + spec.replace(",", "_").replace("=", "-"))


def _write(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")


def _load(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def _say(args, line: str) -> None:
    if not args.json:
        print(line, flush=True)


def main(argv=None) -> int:
    from mpi4dl_tpu_torch.analysis.contracts.diff import (
        diff_contracts, diff_kernels_contract, quant_byte_ratios, render_drift_report,
        render_ratio_report,
    )
    from mpi4dl_tpu_torch.analysis.contracts.engines import default_jobs, extract_many
    from mpi4dl_tpu_torch.analysis.contracts.extract import contract_of
    from mpi4dl_tpu_torch.obs.families import ENGINE_FAMILIES

    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analysis contracts",
        description="Recorded-collective contract gate of the port: run every rank "
                    "role of each engine family on the fake group and diff its "
                    "contract against the checked-in golden.")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the goldens from the current runs")
    ap.add_argument("--json", action="store_true", help="machine-readable diff on stdout")
    ap.add_argument("--out", metavar="F", default=None,
                    help="also write the JSON diff to this file")
    ap.add_argument("--dir", metavar="D", default=None,
                    help="goldens directory (default: the package's goldens/)")
    ap.add_argument("--engines", metavar="NAMES", default=None,
                    help="comma-separated subset of engine families; the pseudo-family "
                         "`kernels` selects the Hopper kernels' contract (a card and "
                         f"the built libraries) (default: {','.join(ENGINE_FAMILIES)})")
    ap.add_argument("--section", choices=["overlap", "kernels"], default=None,
                    help="restrict drift reporting to one section (plus meta mismatches)")
    ap.add_argument("--quant", metavar="SPEC", default=None,
                    help="extract with the quantized collectives on (e.g. int8); goldens "
                         "under goldens/quant_<mode>/, plus the byte-ratio gate against "
                         "the raw goldens")
    ap.add_argument("--max-ratio", type=float, default=0.55,
                    help="with --quant: max quantized/raw bytes per gated class "
                         "(junction/respatial/grad); exceeded = exit 1 (default 0.55)")
    ap.add_argument("--jobs", type=int, default=None,
                    help=f"role processes at once (default {default_jobs()})")
    args = ap.parse_args(argv)

    families = list(ENGINE_FAMILIES)
    want_kernels = False
    if args.engines:
        families = [f.strip() for f in args.engines.split(",") if f.strip()]
        want_kernels = "kernels" in families
        families = [f for f in families if f != "kernels"]
        unknown = [f for f in families if f not in ENGINE_FAMILIES]
        if unknown:
            print(f"contracts: unknown engine(s) {unknown}; have "
                  f"{list(ENGINE_FAMILIES)} + kernels", file=sys.stderr)
            return 2
    if args.quant:
        from mpi4dl_tpu_torch.quant import QuantPolicy

        try:
            policy = QuantPolicy.parse(args.quant)
        except ValueError as e:
            print(f"contracts: {e}", file=sys.stderr)
            return 2
        if policy is None:
            print("contracts: --quant off is the default contract set; drop the flag",
                  file=sys.stderr)
            return 2
        if want_kernels:
            print("contracts: the kernels contract has no quantized set", file=sys.stderr)
            return 2

    raw_directory = args.dir or default_contracts_dir()
    directory = quant_dir(raw_directory, args.quant) if args.quant else raw_directory
    report: Dict[str, List[dict]] = {}
    ratio_report: Dict[str, dict] = {}
    rc = 0

    def check(name: str, current: dict, differ) -> None:
        nonlocal rc
        path = golden_path(directory if name != "kernels" else raw_directory, name)
        if args.update:
            _write(path, current)
            _say(args, f"contract written: {path}")
            report[name] = []
            return
        if not os.path.exists(path):
            report[name] = [{"kind": "meta", "field": "golden", "golden": None,
                             "current": path}]
            _say(args, f"contract MISSING: no golden at {path} (run with --update)")
            rc = 1
            return
        golden = _load(path)
        drifts = differ(golden, current)
        if args.section:
            drifts = [d for d in drifts if d["kind"] in ("meta", args.section)]
        report[name] = drifts
        rc = rc or (1 if drifts else 0)
        _say(args, render_drift_report(name, drifts))
        if drifts and golden.get("torch") != current.get("torch"):
            _say(args, f"  note: golden was extracted on torch {golden.get('torch')}, "
                       f"this run is torch {current.get('torch')}")

    if families:
        roles = extract_many(families, quant=args.quant, jobs=args.jobs)
        for family in families:
            current = contract_of(family, roles[family])
            if args.quant:
                raw_path = golden_path(raw_directory, family)
                if os.path.exists(raw_path):
                    rows, breaches = quant_byte_ratios(_load(raw_path), current,
                                                       args.max_ratio)
                    _say(args, render_ratio_report(family, rows, breaches, args.max_ratio))
                else:
                    rows, breaches = [], [f"no raw golden at {raw_path}"]
                    print(f"quant ratio gate FAILED for {family}: no raw golden at "
                          f"{raw_path}", file=sys.stderr)
                ratio_report[family] = {"rows": rows, "breaches": breaches}
                rc = rc or (1 if breaches else 0)
            check(family, current, diff_contracts)

    if want_kernels:
        from mpi4dl_tpu_torch.analysis.pallascheck import EnvironmentProblem, kernels_contract

        try:
            current = kernels_contract()
        except EnvironmentProblem as e:
            print(f"contracts: kernels: {e}", file=sys.stderr)
            return 2
        check("kernels", current, diff_kernels_contract)

    payload = json.dumps({"drift": report, **({"quant_ratio": ratio_report}
                                               if ratio_report else {})},
                         indent=2, sort_keys=True)
    if args.json:
        print(payload)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(payload + "\n")
    if rc == 0 and not args.update:
        n = len(families)
        _say(args, f"contracts: {n} engine famil{'y' if n == 1 else 'ies'}"
                   + (" + the kernels contract" if want_kernels else "") + " clean"
                   + (f" [quant {args.quant}]" if args.quant else ""))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
