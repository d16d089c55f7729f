"""Multi-level spatial parallelism on ranks, one tile a rank, against the
one-process tile grid.

    torchrun --nproc-per-node 4 --master-addr localhost --master-port 29533 \\
        -m mpi4dl_tpu_torch.benchmarks.multilevel_check --model amoebanet \\
        --image-size 2048 --num-layers 18 --num-filters 416 --num-classes 1000 \\
        --batch-size 1 --precision bf_16 --halo-d2 --pallas-conv --no-remat \\
        --num-spatial-parts 4,2 --split-size 3 --spatial-size 2 --steps 4

The level chain comes from the runners' rule (``benchmarks/common.
spatial_levels``: level ``i`` covers split ``i`` of ``--split-size``
splits); the step is ``make_spatial_train_step(levels=...)`` with the
``gather`` junction, the tail after the last level replicated.  It runs
only where the ranks exist: the coarse level's ``rep``-strided halo shifts
and the coarsening between levels.

1. ``--steps`` steps at the flags' size, the first a warm-up: each step's
   loss and ms (rank 0's wall clock, ending in a read of the loss), the
   K1/K2 launches of a step and every rank's peak memory.
2. The check, at ``--check-image`` with ``--check-layers`` cells of the
   same model and the same level rule, in float64 with the kernels off:
   two steps on the ranks and, on rank 0, the same two steps on the
   one-process grid from the same weights; rank 0's losses within rtol
   1e-6 (the step reduces its metrics over the ranks in fp32) and its
   parameters' and running statistics' updates within 1e-8
   (norm-relative) of the grid's.  The cross-tile sums run in another
   order on the ranks, so the bits may differ; float64 leaves room only
   for that.

On cards rank 0 prints each card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``) before the last line, which is JSON.
``--device cpu`` runs it on gloo ranks.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import time

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.benchmarks.common import spatial_levels
from mpi4dl_tpu_torch.config import config_from_args, get_parser
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh, initialize_distributed
from mpi4dl_tpu_torch.models import build_model
from mpi4dl_tpu_torch.ops import halo_conv
from mpi4dl_tpu_torch.parallel.tiles import TileGrid
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step
from mpi4dl_tpu_torch.utils.devcheck import norm_rel


def _step(cfg, model, tiles, say, dtype=None):
    levels = spatial_levels(cfg, len(model.cells), model.in_shape, tiles, say)
    model.spatial_until = levels[-1][0]
    opt = Optimizer("sgd", lr=cfg.lr)
    step = make_spatial_train_step(model, opt, levels[0][1],
                                   compute_dtype=dtype or cfg.compute_dtype,
                                   remat=cfg.remat, levels=levels)
    return step, TrainState.create(model, opt), levels


def _batch(cfg, dev, dtype=torch.float32):
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)
    x = torch.randn((cfg.batch_size, cfg.image_size, cfg.image_size, 3), generator=gen,
                    device=dev)
    return x.to(dtype), torch.randint(0, cfg.num_classes, (cfg.batch_size,),
                                      generator=gen, device=dev)


def main(argv=None) -> dict:
    p = get_parser()
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--check-image", type=int, default=256)
    p.add_argument("--check-layers", type=int, default=3)
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    dev = resolve_device(args.device)
    rank = initialize_distributed("gloo" if dev.type == "cpu" else "nccl")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    say = print if rank == 0 else (lambda *a, **k: None)
    # --split-size only places the levels: the step is SP alone, one tile a rank.
    spec = dataclasses.replace(MeshSpec.from_config(cfg), stage=1, data=1)
    tiles = build_process_mesh(spec).tiles

    # 1. The flags' size.
    model = build_model(cfg, device=dev)
    step, state, levels = _step(cfg, model, tiles, say)
    say(f"levels: {[(stop, c.grid_h, c.grid_w, c.rep_h, c.rep_w) for stop, c in levels]}",
        flush=True)
    x, y = _batch(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times, launches = [], [], None
    for i in range(args.steps):
        halo_conv.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(halo_conv.LAUNCHES)
        say(f"step {i}: loss {losses[-1]:.6f} {times[-1]:.1f} ms  launches {launches}",
            flush=True)
        assert math.isfinite(losses[-1]), losses
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))
                         if dev.type == "cuda" else 0.0], device=dev)
    peaks = [torch.zeros_like(peak) for _ in range(dist.get_world_size())]
    dist.all_gather(peaks, peak)
    del model, step, state, x, y
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 2. Ranks against the one-process grid, float64, kernels off.
    small = dataclasses.replace(cfg, image_size=args.check_image,
                                num_layers=args.check_layers, precision="fp_32",
                                pallas_conv=False, remat=False)
    f64 = torch.float64
    small_model = build_model(small, device=dev).to(f64)
    init = {k: v.clone() for k, v in small_model.state_dict().items()}
    rk_step, rk_state, _ = _step(small, small_model, tiles, say, f64)
    xs, ys = _batch(small, dev, f64)
    got_losses = []
    for _ in range(2):
        rk_state, m = rk_step(rk_state, xs, ys)
        got_losses.append(float(m["loss"]))
    out = {"ranks": dist.get_world_size(), "levels": [
        (stop, c.grid_h, c.grid_w, c.rep_h, c.rep_w) for stop, c in levels],
        "losses": losses, "step_ms": times[1:],
        "median_step_ms": statistics.median(times[1:]) if len(times) > 1 else None,
        "launches_per_step": launches, "peak_gib": [float(t) / 2**30 for t in peaks],
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if rank == 0:
        grid_model = build_model(small, device=dev).to(f64)
        grid_model.load_state_dict(init)
        g_step, g_state, _ = _step(small, grid_model, TileGrid(tiles.grid_h, tiles.grid_w),
                                   say, f64)
        want_losses = []
        for _ in range(2):
            g_state, m = g_step(g_state, xs, ys)
            want_losses.append(float(m["loss"]))
        keys = [k for k in init if init[k].is_floating_point()]
        got, want = small_model.state_dict(), grid_model.state_dict()
        upd = norm_rel([got[k] - init[k] for k in keys], [want[k] - init[k] for k in keys])
        rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
        out.update(check_losses=got_losses, grid_losses=want_losses, check_loss_rel=rel,
                   check_update_rel=upd, check_ok=bool(rel <= 1e-6 and upd <= 1e-8))
        if dev.type == "cuda":
            cards = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                check=True, capture_output=True, text=True).stdout.strip().splitlines()
            out["cards"] = cards
            print("\n".join(cards), flush=True)
        print(json.dumps(out), flush=True)
        ok = out["check_ok"]
    else:
        ok = True
    flag = torch.tensor([1.0 if ok else 0.0], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    dist.destroy_process_group()
    if float(flag) < 1:
        raise SystemExit("multilevel check: ranks disagree with the one-process grid")
    return out


if __name__ == "__main__":
    main()
