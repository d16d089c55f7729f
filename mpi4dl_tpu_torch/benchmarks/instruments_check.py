"""The step instruments on ranks: the measured exposed-wire ledger, the
recorded collectives and the attribution of each rank's peak, in one job.

    torchrun --nproc-per-node 4 --master-addr localhost --master-port 29535 \\
        -m mpi4dl_tpu_torch.benchmarks.instruments_check --workdir /tmp/ic

Two configurations, each through the runners' own flow
(``benchmarks/common.run``: 2 steps, the first counted, then one more step
recorded (``obs/comm_stats.py``) and one profiled, ``--profile-dir``):

- ``sp``: the ``sp`` runner, AmoebaNet-D(18, 416) 2048² bs1 on a 2x2 grid
  of ranks, D2, the kernels on, bf16 (``--sp-flags`` replaces the flags);
- ``lp``: the ``lp`` runner, GPipe over 4 stages, 1024² bs4 in 4
  micro-batches (``--lp-flags``).

Each rank reads its own trace (``obs/overlap.ledger_from_trace``: the NCCL
kernels matched in launch order to the recorded launch units) and checks:

1. the ledger's bytes per class equal the recorded collectives' count of
   the same step (``collective_stats``), every kernel matched to a unit;
2. hidden + exposed = wire within 1%;
3. the attribution of one step on the card (``mem_probe.card_attribution``)
   covers at least 90% of its peak, and so does the probe's of the same
   rank role (``mem_probe --attribute`` on fake tensors, a CPU subprocess
   started before the training);
4. the card's top scope group equals the probe's.

Rank 0 prints the exposed and hidden ms by wire class of every rank, each
card's name and power limit (``nvidia-smi --query-gpu=name,power.limit``),
one JSON line, then ``ok``; a failed check exits non-zero.  ``--device
cpu`` runs it on gloo ranks (give small ``--sp-flags``/``--lp-flags``):
there every transfer reads exposed.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.benchmarks.common import run
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.mesh import build_process_mesh, initialize_distributed

WIDTH = ("--model amoebanet --num-layers 18 --num-filters 416 --num-classes 1000 "
         "--precision bf_16 --pallas-conv --no-remat")
SP_FLAGS = WIDTH + " --image-size 2048 --batch-size 1 --num-spatial-parts 4 --halo-d2"
LP_FLAGS = WIDTH + " --image-size 1024 --batch-size 4 --parts 4 --split-size 4"
COVERAGE = 0.9
CONSERVATION = 0.01


def _probe_start(family: str, flags, rank: int, workdir: str):
    """This rank's role probed with ``--attribute`` (fake tensors, CPU) in a
    subprocess; (process, output path)."""
    out = os.path.join(workdir, f"probe_{family}_rank{rank}.json")
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.mem_probe", "--family",
           family, "--schedule", "gpipe", "--attribute", "--role", str(rank), *flags]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_WORLD_SIZE", "GROUP_RANK", "TORCHELASTIC_RUN_ID")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    with open(out, "w") as fh, open(out + ".err", "w") as eh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=eh, env=env,
                                cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                                    os.path.abspath(__file__)))))
    return proc, out


def _probe_result(started) -> dict:
    proc, out = started
    proc.wait()
    if proc.returncode != 0:
        with open(out + ".err") as f:
            raise RuntimeError(f"probe failed (rc {proc.returncode}):\n{f.read()[-2000:]}")
    with open(out) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def check_rank(family: str, flags, dev, workdir: str, rank: int, role_rank: int) -> dict:
    """Train, profile and check this rank (module docstring); its numbers."""
    from mpi4dl_tpu_torch.benchmarks.mem_probe import card_attribution, mesh_spec
    from mpi4dl_tpu_torch.config import config_from_args, get_parser
    from mpi4dl_tpu_torch.obs import kineto
    from mpi4dl_tpu_torch.obs.comm_stats import COLLECTIVE_CLASSES, collective_stats
    from mpi4dl_tpu_torch.obs.hbm import top_group
    from mpi4dl_tpu_torch.obs.overlap import ledger_from_trace, wire_events_from_trace

    probe = _probe_start(family, flags, role_rank, workdir)
    prof = os.path.join(workdir, f"{family}_profile")
    run(family, "amoebanet", list(flags) + ["--steps-per-epoch", "2", "--num-epochs", "1",
                                            "--device", dev.type, "--profile-dir", prof])
    trace = os.path.join(prof, f"rank{rank}.trace.json.gz")
    tr = kineto.Trace(trace)
    records = tr.raw["mpi4dl_collectives"]
    ledger = ledger_from_trace(tr)
    stats = collective_stats(records)
    events, _, info = wire_events_from_trace(tr)
    by_cls = {c: sum(e.bytes for e in events if e.cls == c) for c in COLLECTIVE_CLASSES}
    t = ledger["totals"]
    fails = []
    if not info["matched"]:
        fails.append(f"{info['wire_ops']} NCCL kernels against {info['units']} launch units")
    for c in COLLECTIVE_CLASSES:
        if by_cls[c] != stats[c]["bytes"]:
            fails.append(f"{c}: ledger {by_cls[c]} B, recorded {stats[c]['bytes']} B")
    if t["wire_ms"] and abs(t["hidden_ms"] + t["exposed_ms"] - t["wire_ms"]) \
            > CONSERVATION * t["wire_ms"]:
        fails.append(f"hidden {t['hidden_ms']} + exposed {t['exposed_ms']} != wire "
                     f"{t['wire_ms']} ms")
    cfg = config_from_args(get_parser().parse_args(list(flags)))
    card = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        card = card_attribution(cfg, family, dev,
                                build_process_mesh(mesh_spec(cfg, family)))["hbm"]
    got = _probe_result(probe)["hbm"]
    if got["coverage"] < COVERAGE:
        fails.append(f"probe coverage {got['coverage']}")
    if card is not None:
        if card["coverage"] < COVERAGE:
            fails.append(f"card coverage {card['coverage']}")
        if top_group(card) != top_group(got):
            fails.append(f"top scope group: card {top_group(card)!r}, probe "
                         f"{top_group(got)!r}")
    return {
        "rank": rank, "role": role_rank,
        "by_class": {k: {f: v[f] for f in ("exposed_ms", "hidden_ms", "wire_ms", "bytes",
                                          "async_pairs", "sync")}
                     for k, v in ledger["by_class"].items()},
        "totals": t, "hidden_frac": ledger["hidden_frac"],
        "simulated_step_ms": ledger["simulated_step_ms"], "match": info,
        "recorded": {c: stats[c] for c in COLLECTIVE_CLASSES},
        "probe": {"coverage": got["coverage"], "peak_bytes": got["peak_bytes_est"],
                  "top_group": top_group(got)},
        "card": None if card is None else {
            "coverage": card["coverage"], "peak_bytes": card["peak_bytes_est"],
            "reconcile": card["reconcile"], "top_group": top_group(card)},
        "fails": fails,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--workdir", default="build/instruments_check")
    p.add_argument("--sp-flags", default=SP_FLAGS)
    p.add_argument("--lp-flags", default=LP_FLAGS)
    p.add_argument("--only", choices=["sp", "lp"], default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rank = initialize_distributed("gloo" if dev.type == "cpu" else "nccl")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(args.workdir, exist_ok=True)
    out, ok = {"ranks": dist.get_world_size()}, True
    for name, flags in (("sp", args.sp_flags), ("lp", args.lp_flags)):
        if args.only not in (None, name):
            continue
        from mpi4dl_tpu_torch.benchmarks.mem_probe import mesh_spec, role_ranks
        from mpi4dl_tpu_torch.config import config_from_args, get_parser

        argv_f = shlex.split(flags)
        spec = mesh_spec(config_from_args(get_parser().parse_args(argv_f)), name)
        tiles = spec.sph * spec.spw
        role = role_ranks(spec)[(rank // tiles) % spec.stage]
        mine = check_rank(name, argv_f, dev, args.workdir, rank, role)
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, mine)
        ok = ok and not any(r["fails"] for r in rows)
        out[name] = {"flags": flags, "ranks": rows}
        if rank == 0:
            for r in rows:
                print(f"instruments check: {name} rank {r['rank']}: "
                      + "; ".join(f"{c} exposed {v['exposed_ms']:.3f} ms, hidden "
                                  f"{v['hidden_ms']:.3f} ms ({v['bytes']} B)"
                                  for c, v in r["by_class"].items())
                      + f"; step {r['simulated_step_ms']:.1f} ms, probe coverage "
                      f"{r['probe']['coverage']}"
                      + (f", card coverage {r['card']['coverage']} reconcile "
                         f"{r['card']['reconcile']['ratio_est_over_actual']}"
                         if r["card"] else "")
                      + (f"; FAIL {r['fails']}" if r["fails"] else ""), flush=True)
    if rank == 0:
        if dev.type == "cuda":
            cards = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                check=True, capture_output=True, text=True).stdout.strip().splitlines()
            out["cards"] = cards
            print("\n".join(cards), flush=True)
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    if not ok:
        raise SystemExit("instruments check: a check failed (see the FAIL lines)")
    if rank == 0:
        print("ok", flush=True)
    return out


if __name__ == "__main__":
    main()
