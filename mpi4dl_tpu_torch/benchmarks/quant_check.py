"""Quantized collectives (``--quant``) on ranks: each runner configuration
trained with the policy on and off, in one job.

    torchrun --nproc-per-node 4 --master-addr localhost --master-port 29534 \\
        -m mpi4dl_tpu_torch.benchmarks.quant_check --quant int8 --steps 6

Two configurations, each through the runners' own flow
(``benchmarks/common.run``), ``--steps`` steps with ``--quant SPEC`` and
then as many with ``--quant off``, from the same seed:

- ``sp``: the ``sp`` runner, AmoebaNet-D(18, 416) 2048² bs1 on a 2x2 grid
  of ranks, D2, the kernels on, bf16 (``--sp-flags`` replaces the flags);
- ``lp``: the ``lp`` runner, PP GPipe over 4 stages, AmoebaNet-D(18, 416)
  1024² bs4 in 4 micro-batches, bf16 (``--lp-flags``).

For each it prints the median step ms after the warm-up step (rank 0's
clock), the bytes per class per step that all ranks sent (``wire``) beside
what the raw collectives would have sent (``raw``,
``quant.collectives.WIRE_BYTES``), the largest relative gap between the
two runs' losses (the JAX gate: at most 5%, ``tests/test_quant.py:494-514``)
and every rank's peak memory.  On cards rank 0 prints each card's name and
power limit (``nvidia-smi --query-gpu=name,power.limit``), then one JSON
line, then ``ok``; a gap above 5% or a non-finite loss exits non-zero.
``--device cpu`` runs it on gloo ranks (give small ``--sp-flags`` and
``--lp-flags``).
"""

from __future__ import annotations

import argparse
import json
import math
import shlex
import statistics
import subprocess

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.benchmarks.common import run
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.mesh import initialize_distributed
from mpi4dl_tpu_torch.quant.policy import CLASSES

WIDTH = ("--model amoebanet --num-layers 18 --num-filters 416 --num-classes 1000 "
         "--precision bf_16 --pallas-conv --no-remat")
SP_FLAGS = WIDTH + " --image-size 2048 --batch-size 1 --num-spatial-parts 4 --halo-d2"
LP_FLAGS = WIDTH + " --image-size 1024 --batch-size 4 --parts 4 --split-size 4"
GAP = 0.05


def _gathered(values, dev):
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=dev)
    out = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def _one(family, flags, spec, steps, dev):
    argv = flags + ["--quant", spec, "--steps-per-epoch", str(steps),
                    "--device", dev.type]
    res = run(family, "amoebanet", argv)
    done = res["final_step"] - res["start_step"]
    per_rank = _gathered([res["wire_bytes"][c] for c in CLASSES]
                         + [res["raw_bytes"][c] for c in CLASSES]
                         + [res["peak_bytes"] or 0], dev)
    n = len(CLASSES)
    return {
        "losses": res["losses"],
        "median_step_ms": statistics.median(res["step_ms"][1:]),
        "step_ms": res["step_ms"],
        "wire_per_step": {c: sum(r[i] for r in per_rank) / done for i, c in enumerate(CLASSES)},
        "raw_per_step": {c: sum(r[n + i] for r in per_rank) / done
                         for i, c in enumerate(CLASSES)},
        "peak_gib": [r[2 * n] / 2**30 for r in per_rank],
        "launches": res["launches"],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quant", default="int8")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sp-flags", default=SP_FLAGS)
    p.add_argument("--lp-flags", default=LP_FLAGS)
    p.add_argument("--only", choices=["sp", "lp"], default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rank = initialize_distributed("gloo" if dev.type == "cpu" else "nccl")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out, ok = {"ranks": dist.get_world_size(), "quant": args.quant}, True
    for name, flags in (("sp", args.sp_flags), ("lp", args.lp_flags)):
        if args.only not in (None, name):
            continue
        runs = {spec: _one(name, shlex.split(flags), spec, args.steps, dev)
                for spec in (args.quant, "off")}
        q, e = runs[args.quant]["losses"], runs["off"]["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(q, e))
        finite = all(math.isfinite(v) for v in q + e)
        ok = ok and finite and gap <= GAP
        out[name] = {"flags": flags, "loss_gap": gap, **runs}
        if rank == 0:
            for spec, r in runs.items():
                print(f"quant check: {name} --quant {spec}: median "
                      f"{r['median_step_ms']:.1f} ms/step, wire/raw bytes a step "
                      + ", ".join(f"{c} {r['wire_per_step'][c]:.0f}/{r['raw_per_step'][c]:.0f}"
                                  for c in CLASSES)
                      + f", peak GiB {[round(v, 2) for v in r['peak_gib']]}", flush=True)
            print(f"quant check: {name}: largest relative loss gap {gap:.5f} (gate {GAP})",
                  flush=True)
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
        raise SystemExit("quant check: a loss is not finite or the quantized run "
                         f"is more than {GAP:.0%} from the exact one")
    if rank == 0:
        print("ok", flush=True)
    return out


if __name__ == "__main__":
    main()
