"""The spatial-parallel runners' shared flow (counterpart of the ``sp``
family of ``benchmarks/common.py`` with ``--split-size`` 1).

Parse the JAX package's flags, join the ``torchrun`` process group (gloo
with ``--device cpu``, else NCCL with one card per rank), build the tile
grid over the ranks (one tile each), the model (random weights from
``--seed``, the same on every rank) and ``make_spatial_train_step``, then
train on a synthetic batch made from ``--seed`` and print one line per
step and the ``StepMeter`` summary (the first step is the warm-up).

Run in one process with a grid of more than one tile, it raises: the
one-process tile grid is reached only by calling the engine directly.
Telemetry, resilience and checkpoints are not ported (``--telemetry-dir``:
ROADMAP A15; ``--watchdog-secs``: A14; ``--checkpoint-dir``: A10).
"""

from __future__ import annotations

import json
import os
import time

import torch

from mpi4dl_tpu_torch.config import config_from_args, get_parser, resolve_pallas_conv
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.layer_ctx import spatial_levels_for
from mpi4dl_tpu_torch.mesh import MeshSpec, build_mesh, initialize_distributed
from mpi4dl_tpu_torch.models import build_model
from mpi4dl_tpu_torch.ops import halo_conv
from mpi4dl_tpu_torch.parallel.spatial import cell_output_shapes, choose_spatial_until
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step
from mpi4dl_tpu_torch.utils.misc import StepMeter


def resolve_spatial_until(cfg, n_cells: int, in_shape, say=print):
    """The junction cell: ``--spatial-until`` clamped to [1, n_cells - 1],
    ``auto`` from the analytical placement ledger, None (unset) = every
    cell but the head."""
    su = cfg.spatial_until
    if su is None:
        return n_cells - 1
    if su == "auto":
        shapes = cell_output_shapes(build_model(cfg, device="meta"), in_shape)
        itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
        su = choose_spatial_until(shapes, cfg.spatial_part_size, itemsize)
        say(f"note: --spatial-until auto resolved to {su}", flush=True)
    clamped = max(1, min(int(su), n_cells - 1))
    if clamped != int(su):
        say(f"note: --spatial-until {su} clamped to {clamped} "
            f"({n_cells}-cell model)", flush=True)
    return clamped


def _unported_flags(args):
    if args.telemetry_dir is not None:
        raise NotImplementedError("telemetry (--telemetry-dir) is not ported to "
                                  "PyTorch yet (ROADMAP A15)")
    if args.watchdog_secs is not None:
        raise NotImplementedError("the step watchdog (--watchdog-secs) is not "
                                  "ported to PyTorch yet (ROADMAP A14)")


def run(family: str, model: str, argv=None) -> dict:
    """Parse flags, train, print; returns the summary dict (rank 0 prints)."""
    p = get_parser()
    p.set_defaults(model=model)
    p.add_argument("--steps-per-epoch", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (NCCL, one card per rank) or cpu (gloo)")
    p.add_argument("--profile-dir", default=None,
                   help="profile one more step; per-rank device-time tables "
                        "go to this directory")
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--watchdog-secs", type=float, default=None)
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    _unported_flags(args)
    if family != "sp":
        raise NotImplementedError(f"the {family!r} family is not ported to "
                                  "PyTorch yet (ROADMAP A7-A9)")
    spec = MeshSpec.from_config(cfg)
    if spec.size < 2:
        raise ValueError("the sp runner needs --num-spatial-parts > 1 "
                         "(single device: python -m mpi4dl_tpu_torch)")
    dev = resolve_device(args.device)
    rank = initialize_distributed("gloo" if dev.type == "cpu" else "nccl")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    tiles = build_mesh(spec)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"ranks: {spec.size} x {dev.type} "
        f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}); "
        f"tiles {spec.sph}x{spec.spw}", flush=True)

    mdl = build_model(cfg, device=dev)
    su = resolve_spatial_until(cfg, len(mdl.cells), mdl.in_shape, say)
    mdl.spatial_until = su
    (sp,) = spatial_levels_for(
        cfg.slice_method, cfg.num_spatial_parts[:1], tiles=tiles,
        bn_cross_tile=cfg.bn_cross_tile, d2_mode=cfg.halo_d2,
        d2_max_fused=cfg.fused_layers if cfg.fused_layers > 0 else None,
        use_pallas_conv=resolve_pallas_conv(cfg.pallas_conv),
    )
    opt = Optimizer(cfg.optimizer, lr=cfg.lr, momentum=cfg.momentum)
    step = make_spatial_train_step(mdl, opt, sp, parts=cfg.parts,
                                   compute_dtype=cfg.compute_dtype,
                                   spatial_until=su, remat=cfg.remat)
    state = TrainState.create(mdl, opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)
    x = torch.randn((cfg.batch_size, cfg.image_size, cfg.image_size, 3),
                    generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (cfg.batch_size,), generator=gen, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    meter = StepMeter(cfg.batch_size, warmup_steps=1)
    halo_conv.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for i in range(cfg.num_epochs * args.steps_per_epoch):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))  # synchronises
        ms = (time.perf_counter() - t0) * 1e3
        meter.add(ms)
        say(f"step {i}: loss {losses[-1]:.6f}  {cfg.batch_size / ms * 1e3:.3f} "
            f"img/s ({ms:.1f} ms)", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if peak is not None:
        print(f"rank {rank}: peak {peak / 2**30:.2f} GiB", flush=True)
    if args.profile_dir:
        _profile_step(args.profile_dir, rank, lambda: step(state, x, y), dev, say)
    say(meter.summary(), flush=True)
    out = {"images_per_sec": meter.images_per_sec(), "losses": losses,
           "stats": meter.stats(), "peak_bytes": peak,
           "launches": dict(halo_conv.LAUNCHES), "ranks": spec.size,
           "spatial_until": su}
    say(json.dumps(out), flush=True)
    return out


def _profile_step(path: str, rank: int, step, dev, say) -> None:
    """One profiled step: its device time by kernel to
    ``path/rank<r>.txt`` and the device's busy share of the step."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    os.makedirs(path, exist_ok=True)
    sort = "self_cuda_time_total" if dev.type == "cuda" else "self_cpu_time_total"
    with open(os.path.join(path, f"rank{rank}.txt"), "w") as f:
        f.write(avgs.table(sort_by=sort, row_limit=40))
    say(f"profile: step {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%)", flush=True)
