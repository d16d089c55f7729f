"""The 8192² readiness probe of the port (counterpart of the JAX package's
``benchmarks/readiness_8k.py``), without a card.

The flagship configuration is AmoebaNet-D(18, 416) at 8192² bs1 under
SP(4x4) x PP(2): 32 ranks.  The tool answers the JAX tool's three
questions for the port's own step:

1. **Does the step build at the real shapes?**  The ``sp`` runner's step
   (``benchmarks/common._build``) at the JAX tool's settings (gather
   junction, micro-batch 1, cell remat, bf16, SGD lr 0.001) runs one
   training step on fake tensors (``benchmarks/mem_probe.probe_role``:
   shapes and no storage), one process for each stage role: rank
   ``s · tiles`` of the 32-rank ``fake`` process group, whose collectives
   return at once.  It builds when every role ran its step;
   ``build_seconds`` is the wall time of the roles, which run side by side.
2. **What moves a step?**  Each role's collectives as ``obs/comm_stats.py``
   records them (a send/recv transfer is counted once, on the receiver).
   ``collectives_per_step`` sums the stage roles per class: what one tile
   position of the pipeline receives in a step, the counterpart of the
   JAX tool's per-device SPMD module, which holds every stage's code.
   ``collective_scopes`` splits the same by the scope that issued it
   (halo exchanges, the stage handoff, the junction, the reductions).
3. **Does it fit?**  The largest role's peak (the fake step's live bytes,
   parameters, optimizer state and input included) against the H100
   80GB's device memory.  On an H100 the probe reads 0.3-4.4% under the
   card's ``torch.cuda.max_memory_allocated`` of the same step (PERF.md):
   it does not see library workspaces or the caching allocator's rounding.

The analytic ledger is the JAX tool's: each cell's output bytes in bf16
(``parallel/spatial._cell_bytes`` over ``cell_output_shapes``), a spatial
cell's divided by the tile count of its level.

The flags and gates are the JAX tool's.  ``--spatial-parts 64,16`` is a
square chain whose levels split the spatial region evenly, as there (the
runner's own chain follows its pipeline splits).  ``--attribute`` adds the
probe's ``--attribute --overlap`` instruments: the largest role's peak by
scope (``hbm``) and analytical ``timeline``, and the exposed-wire ledger of
every role's collectives (``overlap``; on the CPU every transfer is sync).
``--require-wire-gb`` needs ``--attribute``.  The process creates no CUDA
context, so it can run beside a live job.

    python -m mpi4dl_tpu_torch.benchmarks.readiness_8k [--image-size 8192]
        [--tiles 4] [--stages 2] [--parts 1] [--require-gb 80] [--out F]

The last line of standard output is the JSON object
(``metric: readiness_8k_per_device_gb``); exit 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

# The H100 80GB HBM3's device memory as a process sees it
# (``torch.cuda.get_device_properties(0).total_memory``, 85,017,493,504
# bytes; ``nvidia-smi`` reads 81559 MiB), in the GiB of the probe's peaks.
H100_HBM_GB = 85017493504 / 2**30
ROLE_TIMEOUT_S = 1800  # one role's fake step at 8192²; PERF.md has the times
PROBE_GAP_NOTE = ("per-rank peak of the fake step (parameters, optimizer state, "
                  "input and live activations); on an H100 the probe reads 0.3-4.4% "
                  "under torch.cuda.max_memory_allocated: library workspaces and the "
                  "caching allocator's rounding are not in it")


def _parser() -> argparse.ArgumentParser:
    from mpi4dl_tpu_torch.config import _spatial_until_arg

    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.benchmarks.readiness_8k",
        description="build, collectives and fit of the SP x PP flagship step, "
                    "on fake tensors")
    p.add_argument("--image-size", type=int, default=8192)
    p.add_argument("--tiles", type=int, default=4, help="spatial grid per dim")
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--parts", type=int, default=1)
    p.add_argument("--schedule", choices=["gpipe", "1f1b"], default="gpipe",
                   help="pipeline-tail schedule")
    p.add_argument("--num-layers", type=int, default=18)
    p.add_argument("--num-filters", type=int, default=416)
    p.add_argument("--spatial-until", default="9", type=_spatial_until_arg,
                   help="cells in the spatial region, or 'auto' (the analytical "
                        "placement, parallel/spatial.choose_spatial_until)")
    p.add_argument("--spatial-parts", default=None, metavar="N[,N...]",
                   help="multi-level square chain, e.g. '64,16'; overrides "
                        "--tiles (level-0 grid = sqrt(N0))")
    p.add_argument("--stripe-bwd", action="store_true",
                   help="the stripe-wise backward through the spatial region")
    p.add_argument("--require-gb", type=float, default=None,
                   help="exit 1 unless the largest role's peak is below this "
                        "many GB (GiB)")
    p.add_argument("--attribute", action="store_true",
                   help="add the peak by scope, the analytical timeline and the "
                        "exposed-wire ledger")
    p.add_argument("--telemetry-dir", default=None,
                   help="mirror the result into a RunLog (readiness, hbm, "
                        "timeline and overlap records)")
    p.add_argument("--quant", default="off", metavar="SPEC",
                   help="quantized-collective policy (off | int8 | fp8 | int4 | "
                        "per-class spec)")
    p.add_argument("--require-wire-gb", type=float, default=None,
                   help="with --attribute: exit 1 when the ledger's wire bytes "
                        "a step exceed this many GB")
    p.add_argument("--out", default=None)
    p.add_argument("--role", type=int, default=None, help=argparse.SUPPRESS)
    return p


def _chain(args) -> Tuple[int, Optional[List[int]]]:
    """(level-0 grid side, the square chain or None)."""
    if not args.spatial_parts:
        return args.tiles, None
    chain = [int(s) for s in args.spatial_parts.split(",")]
    g0 = math.isqrt(chain[0])
    if g0 * g0 != chain[0]:
        raise SystemExit(f"--spatial-parts levels must be perfect squares, got {chain[0]}")
    return g0, chain


def runner_argv(args, su: int) -> List[str]:
    """The ``sp`` runner's flags of the flagship step at ``args``."""
    t, chain = _chain(args)
    out = ["--model", "amoebanet", "--image-size", str(args.image_size),
           "--batch-size", str(args.parts), "--parts", str(args.parts),
           "--num-layers", str(args.num_layers), "--num-filters", str(args.num_filters),
           "--num-classes", "1000", "--precision", "bf_16",
           "--num-spatial-parts", str(chain[0] if chain else t * t),
           "--slice-method", "square", "--split-size", str(args.stages),
           "--schedule", args.schedule, "--spatial-until", str(su),
           "--quant", args.quant]
    return out + (["--stripe-bwd"] if args.stripe_bwd else [])


def level_stops(n_levels: int, su: int) -> List[Tuple[int, int]]:
    """``[(stop_cell, level index)]``: the levels split the region ``[0, su)``
    evenly; a level whose stop collides with the one before is dropped (a
    square chain shrinks level to level, so nothing merges), and the last
    kept level reaches ``su``."""
    from mpi4dl_tpu_torch.cells import split_even

    kept: List[Tuple[int, int]] = []
    for i, (_, stop) in enumerate(split_even(su, n_levels)):
        if stop > (kept[-1][0] if kept else 0):
            kept.append((stop, i))
    kept[-1] = (su, kept[-1][1])
    return kept


def activation_ledger(shapes, su: int, tiles_at) -> Dict[str, list]:
    """Per-device activation bytes of each cell, in bf16: a spatial cell's
    output over its level's tile count (``tiles_at(i)``), a tail cell's
    whole (it lives on one stage)."""
    from mpi4dl_tpu_torch.parallel.spatial import _cell_bytes

    out: Dict[str, list] = {"spatial_cells": [], "tail_cells": []}
    for i, shp in enumerate(shapes):
        b = _cell_bytes(shp, 2)
        if i < su:
            b //= tiles_at(i)
        out["spatial_cells" if i < su else "tail_cells"].append({"cell": i, "bytes": b})
    return out


def _tiles_at(levels: List[Tuple[int, int]]):
    def at(i: int) -> int:
        return next((n for stop, n in levels if i < stop), levels[-1][1])

    return at


def _run_role(argv: List[str], rank: int) -> Dict[str, Any]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.readiness_8k", *argv,
           "--role", str(rank)]
    env = {k: v for k, v in os.environ.items() if k != "MPI4DL_FAULT"}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root, env=env,
                              timeout=ROLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"rank": rank, "error": f"no step within {ROLE_TIMEOUT_S} s"}
    if proc.returncode != 0:
        return {"rank": rank, "error": f"rc {proc.returncode}: {proc.stderr[-1500:]}"}
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def _role(args, su: int) -> Dict[str, Any]:
    """This process's role: one training step of rank ``--role``."""
    from mpi4dl_tpu_torch.benchmarks.common import level_ctxs
    from mpi4dl_tpu_torch.benchmarks.mem_probe import _runner_cfg, probe_role

    cfg = _runner_cfg(runner_argv(args, su), "")
    t, chain = _chain(args)
    parts = chain or [t * t]

    def levels(mdl, tiles):
        ctxs = level_ctxs(cfg, parts, tiles)
        return [(stop, ctxs[i]) for stop, i in level_stops(len(ctxs), su)]

    return probe_role(cfg, "sp", args.role, collectives=True,
                      instruments=args.attribute, levels=levels)


def _sum_collectives(roles: List[Dict[str, Any]]) -> Dict[str, Any]:
    from mpi4dl_tpu_torch.obs.comm_stats import COLLECTIVE_CLASSES

    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_CLASSES}
    for r in roles:
        for k in COLLECTIVE_CLASSES:
            out[k]["count"] += r["collectives"][k]["count"]
            out[k]["bytes"] += r["collectives"][k]["bytes"]
    out["total_bytes"] = sum(out[k]["bytes"] for k in COLLECTIVE_CLASSES)
    return out


def _scope_kinds(roles: List[Dict[str, Any]]) -> Dict[str, Dict[str, int]]:
    """The counted collectives by the innermost scope that issued them, the
    cell and level numbers dropped (``halo_exchange_h``, ``stage_handoff``,
    ``junction_gather``, ``grad_reduce``, ...)."""
    out: Dict[str, Dict[str, int]] = {}
    for r in roles:
        for path, v in r["collective_scopes"].items():
            leaf = (path or "unscoped").split("/")[-1].rstrip("0123456789_")
            b = out.setdefault(leaf, {"count": 0, "bytes": 0})
            b["count"] += v["collective_count"]
            b["bytes"] += v["collective_bytes"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["bytes"]))


def _overlap(roles: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The exposed-wire ledger of every role's recorded collectives."""
    from mpi4dl_tpu_torch.obs.costs import ici_bytes_per_s
    from mpi4dl_tpu_torch.obs.overlap import ledger_from_records

    ici, src = ici_bytes_per_s(None)
    return ledger_from_records([x for r in roles for x in r["collective_records"]],
                               ici_bw=ici, ici_source=src)


def _rollup(ledger: Dict[str, Any]) -> Dict[str, Any]:
    t = ledger["totals"]
    return {
        "wire_gb": round(t["bytes"] / 2**30, 3),
        "quantized_gb": round(t.get("quantized_bytes", 0) / 2**30, 3),
        "exposed_ms": t["exposed_ms"], "hidden_ms": t["hidden_ms"],
        "hidden_frac": ledger["hidden_frac"], "async_pairs": t["async_pairs"],
        "sync_collectives": t["sync"],
        "attributed_bytes_frac": ledger["attributed_bytes_frac"],
        "by_class": {cls: {"exposed_ms": b["exposed_ms"], "hidden_ms": b["hidden_ms"],
                           "gb": round(b["bytes"] / 2**30, 3),
                           "quantized_gb": round(b.get("quantized_bytes", 0) / 2**30, 3)}
                     for cls, b in ledger["by_class"].items()},
    }


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = _parser()
    args = p.parse_args(argv)
    if args.require_wire_gb is not None and not args.attribute:
        # The gate reads the overlap ledger, which only exists under
        # --attribute; a silent no-op would pass it vacuously.
        p.error("--require-wire-gb needs --attribute (the gate reads the "
                "overlap ledger)")
    if args.stripe_bwd:
        os.environ["MPI4DL_STRIPE_BWD"] = "1"
    t, chain = _chain(args)
    px, stages = args.image_size, args.stages

    from mpi4dl_tpu_torch.benchmarks.mem_probe import _runner_cfg
    from mpi4dl_tpu_torch.layer_ctx import spatial_levels_for
    from mpi4dl_tpu_torch.models import build_model
    from mpi4dl_tpu_torch.parallel.spatial import cell_output_shapes, choose_spatial_until
    from mpi4dl_tpu_torch.quant import QuantPolicy

    cfg = _runner_cfg(runner_argv(args, 1), "")
    shapes = cell_output_shapes(build_model(cfg, device="meta"), (1, px, px, 3))
    if args.spatial_until == "auto":
        # With a chain the proxy assumes the level-0 grid for the whole
        # region; coarser levels hold a larger share, so the placement is
        # never deeper than the true optimum.
        su = choose_spatial_until(shapes, t * t, itemsize=2)
        if args.role is None:
            print(f"[readiness] --spatial-until auto -> {su} (analytical placement "
                  f"frontier, {t}x{t} tiles)", file=sys.stderr)
    else:
        su = int(args.spatial_until)
    su = min(su, len(shapes) - 1)
    if args.role is not None:
        print(json.dumps(_role(args, su)))
        return 0

    grids = [c.grid_h * c.grid_w for c in spatial_levels_for("square", chain or [t * t])]
    levels = [(stop, grids[i]) for stop, i in level_stops(len(grids), su)]
    ledger = activation_ledger(shapes, su, _tiles_at(levels))
    mb = {k: [{"cell": c["cell"], "per_device_mb": round(c["bytes"] / 2**20, 1)} for c in v]
          for k, v in ledger.items()}

    n_ranks = t * t * stages
    ranks = [s * t * t for s in range(stages)]
    print(f"[readiness] {len(ranks)} rank role(s) of {n_ranks}: {ranks}", file=sys.stderr)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(ranks)) as ex:
        roles = list(ex.map(lambda r: _run_role(argv, r), ranks))
    build_s = time.perf_counter() - t0
    failed = [r for r in roles if "error" in r]
    quant = QuantPolicy.resolve(args.quant)
    config = {
        "image_size": px, "grid": f"{t}x{t}", "stages": stages, "parts": args.parts,
        "schedule": args.schedule, "devices": n_ranks, "spatial_until": su,
        "spatial_parts": chain,
        "stripe_bwd": bool(args.stripe_bwd or os.environ.get("MPI4DL_STRIPE_BWD") == "1"),
        "model": f"amoebanetd({args.num_layers},{args.num_filters})",
        "quant": quant.spec() if quant else "off",
        "runner_flags": " ".join(runner_argv(args, su)),
    }
    out: Dict[str, Any] = {"metric": "readiness_8k_per_device_gb", "unit": "GB/device",
                           "config": config, "build_seconds": round(build_s, 1),
                           "builds": not failed}
    if failed:
        hint = ("" if args.parts % stages == 0 else
                f"--parts {args.parts} does not divide over --stages {stages}: the SP x PP "
                "step hands each stage's tile ranks an equal chunk of the batch (the JAX "
                "package asserts the same, mpi4dl_tpu/parallel/sp_pipeline.py:299); ")
        out.update(value=None, error=hint + "; ".join(f"rank {r['rank']}: {r['error']}"
                                                      for r in failed)[-3000:])
        print(json.dumps(out))
        return 1
    top = max(roles, key=lambda r: r["peak_bytes"])
    per_dev_gb = top["peak_bytes"] / 2**30
    comm = _sum_collectives(roles)
    out.update({
        "value": round(per_dev_gb, 2),
        "memory_analysis": {
            "roles": [{"rank": r["rank"], "stage": r["rank"] // (t * t),
                       "peak_gb": round(r["peak_bytes"] / 2**30, 3),
                       "by_category_gb": {k: round(v / 2**30, 3)
                                          for k, v in r["by_category"].items()},
                       "seconds": r["seconds"]} for r in roles],
            "note": PROBE_GAP_NOTE,
        },
        "fits_h100_80gb": per_dev_gb < H100_HBM_GB,
        "headroom_h100_gb": round(H100_HBM_GB - per_dev_gb, 1),
        "collectives_per_step": {k: v for k, v in comm.items()
                                 if isinstance(v, dict) and v["count"]},
        "collective_total_gb": round(comm["total_bytes"] / 2**30, 3),
        "collective_scopes": _scope_kinds(roles),
        "activation_ledger": {
            "spatial_cells_sum_per_device_mb": round(
                sum(c["per_device_mb"] for c in mb["spatial_cells"]), 1),
            "tail_cells_sum_total_mb": round(
                sum(c["per_device_mb"] for c in mb["tail_cells"]), 1),
            "largest_spatial_cell_mb": max(
                (c["per_device_mb"] for c in mb["spatial_cells"]), default=0),
        },
    })
    if args.require_gb is not None:
        ok = per_dev_gb < args.require_gb
        out["hbm_gate"] = {"limit_gb": args.require_gb, "ok": ok}
        print(f"[readiness] HBM gate {'ok' if ok else 'FAILED'}: {per_dev_gb:.2f} GB/device "
              f"{'<' if ok else '>='} --require-gb {args.require_gb}", file=sys.stderr)
    if args.attribute:
        from mpi4dl_tpu_torch.obs.hbm import format_breakdown, scope_group_bytes
        from mpi4dl_tpu_torch.obs.overlap import format_ledger

        overlap = _overlap(roles)
        out.update(hbm=top["hbm"], timeline=top["timeline"], overlap=overlap,
                   hbm_phase_groups_gb={k: round(v / 2**30, 3)
                                        for k, v in scope_group_bytes(top["hbm"]).items()},
                   overlap_rollup=_rollup(overlap))
        print(format_breakdown(top["hbm"]), file=sys.stderr)
        print(format_ledger(overlap), file=sys.stderr)
        if args.require_wire_gb is not None:
            wire_gb = out["overlap_rollup"]["wire_gb"]
            ok = wire_gb <= args.require_wire_gb
            out["wire_gate"] = {"limit_gb": args.require_wire_gb, "ok": ok}
            print(f"[readiness] wire gate {'ok' if ok else 'FAILED'}: {wire_gb} GB/step "
                  f"{'<=' if ok else '>'} --require-wire-gb {args.require_wire_gb}",
                  file=sys.stderr)

    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    if args.telemetry_dir:
        from mpi4dl_tpu_torch.obs import RunLog

        runlog = RunLog.create(args.telemetry_dir, prefix="readiness")
        runlog.write_meta(config=config, family="sp", argv=argv)
        runlog.write("readiness", **{k: v for k, v in out.items()
                                     if k not in ("hbm", "timeline", "overlap")})
        if args.attribute:
            runlog.write("hbm", label="readiness", breakdown=out["hbm"])
            runlog.write("timeline", label="readiness", **out["timeline"])
            runlog.write("overlap", label="readiness", **out["overlap"])
        runlog.close()
        print(f"[readiness] telemetry written to {runlog.path}", file=sys.stderr)
    print(line)
    gates = [out.get(g, {}).get("ok", True) for g in ("hbm_gate", "wire_gate")]
    return 0 if all(gates) else 1


if __name__ == "__main__":
    raise SystemExit(main())
