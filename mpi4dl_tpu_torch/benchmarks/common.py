"""The runners' shared flow (counterpart of the ``lp``, ``gems``, ``sp`` and
``gems_sp`` families of ``benchmarks/common.py``).

Parse the JAX package's flags, join the ``torchrun`` process group (gloo
with ``--device cpu``, else NCCL with one card per rank), build the mesh
over the ranks (``mesh.build_process_mesh``: rank layout row-major over
``(data, stage, sph, spw)``), the model (random weights from ``--seed``,
the same on every rank) and the family's step, then train as the JAX
runner does (``benchmarks/common.py:449-604``): global step ``g`` takes
batch ``g % --steps-per-epoch`` of ``data.make_dataset`` (``--app`` 1 image
folder at ``--datapath``, 2 CIFAR-like, 3 synthetic from ``--seed``; a
global batch of ``--batch-size`` images per data replica) through
``prefetch_batches`` (``--num-workers`` > 0: a background thread), moved
to the device as it arrives.  With ``--checkpoint-dir`` the run restores
the newest valid checkpoint of the JAX runner's fingerprints and goes on
from its step, saves once before the first step when the directory holds
none, and at every epoch boundary (the synchronous saves of
``resilience/loop.py:186-201, 432-444``).  It prints one line per step
and the ``StepMeter`` summary (the first step is the warm-up).  The ``sp`` and
``gems_sp`` families' last line also says whether the tile ranks' tails
(this stage's cells after the junction) agree (``tail_agreement``).

- ``lp``: ``--split-size 1`` trains on one device, or DP with
  ``--data-parallel``; more stages run ``make_pipeline_train_step`` with
  one stage per rank (``--schedule gpipe|1f1b``, ``--parts``,
  ``--balance``), DP x PP with ``--data-parallel``.
- ``gems``: ``make_gems_train_step`` on the mesh ``(data, stage)``, one
  stage per rank, ``--times`` pairs of 2 x ``--parts`` micro-batches
  (``--batch-size`` divisible by 2·times·parts), DP x GEMS with
  ``--data-parallel``.  ``--enable-master-comm-opt`` is a no-op (one weight
  set: the replicas cannot diverge) and says so.
- ``sp``: one tile per rank, ``--data-parallel`` replicas of the grid,
  ``--local-DP`` the ``batch_split`` junction's degree; with
  ``--split-size`` > 1, SP x PP (the tail pipelined over that many stages,
  ``--schedule``, ``--parts``).
- ``gems_sp``: SP + GEMS, the tail's stages running GEMS's dual streams
  (``--split-size`` ≥ 2, ``--times``, ``--parts``).

Run in one process with more than one rank in the mesh, it raises: the
one-process tile grid and stage chain are reached only by calling the
engines directly.  Telemetry and the supervised loop are not ported
(``--telemetry-dir``: ROADMAP A15; ``--watchdog-secs``, the anomaly guard
and the background checkpoint writer: A14).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch import checkpoint as ckpt
from mpi4dl_tpu_torch.cells import split_even
from mpi4dl_tpu_torch.config import config_from_args, get_parser, resolve_pallas_conv
from mpi4dl_tpu_torch.data import make_dataset, prefetch_batches
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.layer_ctx import spatial_levels_for
from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh, initialize_distributed
from mpi4dl_tpu_torch.models import build_model
from mpi4dl_tpu_torch.ops import halo_conv
from mpi4dl_tpu_torch.parallel.spatial import cell_output_shapes, choose_spatial_until
from mpi4dl_tpu_torch.train import (
    Optimizer, TrainState, make_spatial_train_step, make_train_step,
)
from mpi4dl_tpu_torch.utils.misc import StepMeter


def resolve_spatial_until(cfg, n_cells: int, in_shape, say=print):
    """The junction cell: ``--spatial-until`` clamped to [1, n_cells - 1],
    ``auto`` from the analytical placement ledger; unset, every cell but
    the head, or with ``--split-size`` S > 1 (SP x PP) the end of the
    first ``--spatial-size`` of S even splits of the cells, at most S - 1
    of them (``benchmarks/common.py:78-143``)."""
    su = cfg.spatial_until
    if su is None:
        if cfg.split_size <= 1:
            return n_cells - 1
        k = min(max(cfg.spatial_size, 1), cfg.split_size - 1)
        return min(split_even(n_cells, cfg.split_size, cfg.balance)[k - 1][1], n_cells - 1)
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


def spatial_levels(cfg, n_cells: int, in_shape, tiles=None, say=print):
    """``[(stop_cell, SpatialCtx)]`` of the spatial region
    (``benchmarks/common.py:78-143``): level ``i`` covers pipeline split
    ``i`` of ``--split-size`` even splits with ``num_spatial_parts[i]``
    tiles, for the first ``--spatial-size`` splits (at most split_size - 1
    of them when the tail is pipelined); a short parts list repeats its last
    element, identical neighbouring levels merge, and no level reaches the
    head.  ``--spatial-until`` re-places the junction: the chain is cut at
    it, or its last level extended to it."""
    ranges = split_even(n_cells, max(cfg.split_size, 1), cfg.balance)
    k = min(max(cfg.spatial_size, 1), len(ranges))
    if cfg.split_size > 1 and k >= cfg.split_size:
        k = cfg.split_size - 1
        say(f"note: spatial_size clamped to {k} (split_size {cfg.split_size} "
            "needs at least one non-spatial tail split)", flush=True)
    parts = list(cfg.num_spatial_parts)
    if len(parts) > k:
        say(f"note: num_spatial_parts {parts} has more levels than the {k} spatial "
            f"split(s); using {parts[:k]} (raise --spatial-size and --split-size to "
            "use the full chain)", flush=True)
    parts = (parts + [parts[-1]] * k)[:k]
    ctxs = spatial_levels_for(
        cfg.slice_method, parts, tiles=tiles, bn_cross_tile=cfg.bn_cross_tile,
        d2_mode=cfg.halo_d2,
        d2_max_fused=cfg.fused_layers if cfg.fused_layers > 0 else None,
        use_pallas_conv=resolve_pallas_conv(cfg.pallas_conv))
    levels = []
    for i in range(k):
        stop = min(ranges[i][1], n_cells - 1)
        if levels and ctxs[i] == levels[-1][1]:
            levels[-1] = (stop, levels[-1][1])
        elif stop > (levels[-1][0] if levels else 0):
            levels.append((stop, ctxs[i]))
    if cfg.spatial_until is not None:
        su = resolve_spatial_until(cfg, n_cells, in_shape, say)
        cut = []
        for stop, c in levels:
            if cut and cut[-1][0] >= su:
                break
            cut.append((min(stop, su), c))
        cut[-1] = (su, cut[-1][1])
        levels = cut
    return levels


def _unported_flags(args):
    if args.telemetry_dir is not None:
        raise NotImplementedError("telemetry (--telemetry-dir) is not ported to "
                                  "PyTorch yet (ROADMAP A15)")
    if args.watchdog_secs is not None:
        raise NotImplementedError("the step watchdog (--watchdog-secs) is not "
                                  "ported to PyTorch yet (ROADMAP A14)")


def _build(cfg, family: str, dev, mesh, say):
    """(step, state, notes, tail cells) of the family at ``cfg`` on this
    rank; the tail cells are those whose replicas the tile ranks must agree
    on (None outside the spatial families)."""
    from mpi4dl_tpu_torch.parallel.gems import gems_local_stages, make_gems_train_step
    from mpi4dl_tpu_torch.parallel.partition import StagePartition
    from mpi4dl_tpu_torch.parallel.pipeline import (
        init_pipeline_state, make_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.sp_pipeline import (
        SPPipeline, init_sp_pipeline_state, make_sp_gems_train_step,
        make_sp_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import ProcessGroupStages, StageChain

    pallas = resolve_pallas_conv(cfg.pallas_conv)
    opt = Optimizer(cfg.optimizer, lr=cfg.lr, momentum=cfg.momentum)
    data = mesh.data if mesh is not None else None
    mdl = build_model(cfg, device=dev)
    if family == "lp" and cfg.split_size <= 1:
        step = make_train_step(mdl, opt, parts=cfg.parts,
                               compute_dtype=cfg.compute_dtype, remat=cfg.remat,
                               pallas_conv=pallas, with_data_axis=data)
        return step, TrainState.create(mdl, opt), {}, None

    def stage_backend():
        if cfg.split_size <= 1:
            return StageChain(1)  # one stage: this rank holds all of it
        return ProcessGroupStages(cfg.split_size, mesh.stage_group)

    notes = {"schedule": cfg.schedule}
    if family in ("lp", "gems"):
        groups = cfg.parts * (2 * cfg.times if family == "gems" else 1)
        if cfg.batch_size % groups:
            raise ValueError(f"--batch-size {cfg.batch_size} must divide into {groups} "
                             "micro-batches")
        part = StagePartition.build(
            mdl, max(cfg.split_size, 1),
            (cfg.batch_size // groups, cfg.image_size, cfg.image_size, 3),
            balance=cfg.balance)
        stages = stage_backend()
        kw = dict(compute_dtype=cfg.compute_dtype, remat=cfg.remat, with_data_axis=data,
                  schedule=cfg.schedule, pallas_conv=pallas)
        if family == "gems":
            part.release_others(gems_local_stages(stages))
            step = make_gems_train_step(part, opt, stages, cfg.parts, times=cfg.times, **kw)
            notes["times"] = cfg.times
        else:
            part.release_others(stages.local_stages)
            step = make_pipeline_train_step(part, opt, stages, cfg.parts, **kw)
        notes.update(stage=stages.local_stages[0], ranges=part.ranges)
        return step, init_pipeline_state(part, opt, stages), notes, None
    if cfg.stripe_bwd:
        # The stripe-wise backward is dispatched off the hatch, read at each
        # layer run (benchmarks/common.py:159-168).
        os.environ["MPI4DL_STRIPE_BWD"] = "1"
    levels = spatial_levels(cfg, len(mdl.cells), mdl.in_shape, mesh.tiles, say)
    sp, su = levels[0][1], levels[-1][0]
    mdl.spatial_until = su
    junction = "batch_split" if cfg.local_dp_lp > 1 else "gather"
    local_dp = cfg.local_dp_lp if junction == "batch_split" else None
    notes.update(spatial_until=su, junction=junction,
                 levels=[(stop, c.grid_h, c.grid_w) for stop, c in levels])
    if family == "sp" and cfg.split_size <= 1:
        step = make_spatial_train_step(
            mdl, opt, sp, parts=cfg.parts, compute_dtype=cfg.compute_dtype,
            spatial_until=su, remat=cfg.remat, junction=junction, local_dp=local_dp,
            with_data_axis=data, levels=levels)
        return step, TrainState.create(mdl, opt), notes, mdl.cells[su:]
    if cfg.split_size < 2:
        raise ValueError("the gems_sp family needs --split-size >= 2 (the tail's stages)")
    gems = family == "gems_sp"
    groups = cfg.parts * (2 * cfg.times if gems else 1)
    if cfg.batch_size % groups:
        raise ValueError(f"--batch-size {cfg.batch_size} must divide into {groups} "
                         "micro-batches")
    spp = SPPipeline.build(mdl, cfg.split_size, sp, cfg.batch_size // groups,
                           junction=junction, balance=cfg.balance, local_dp=local_dp,
                           levels=levels)
    stages = stage_backend()
    kw = dict(compute_dtype=cfg.compute_dtype, remat=cfg.remat, with_data_axis=data,
              schedule=cfg.schedule)
    if gems:
        spp.tail_part.release_others(gems_local_stages(stages))
        step = make_sp_gems_train_step(spp, opt, stages, cfg.parts, times=cfg.times, **kw)
        notes["times"] = cfg.times
    else:
        spp.tail_part.release_others(stages.local_stages)
        step = make_sp_pipeline_train_step(spp, opt, stages, cfg.parts, **kw)
    s = stages.local_stages[0]
    r0, r1 = spp.tail_part.ranges[s]
    notes.update(stage=s, ranges=spp.tail_part.ranges)
    return (step, init_sp_pipeline_state(spp, opt, stages), notes,
            spp.tail_part.model.cells[r0:r1])


def checkpoint_manager(cfg, spec, steps_per_epoch: int, group=None):
    """The runner's CheckpointManager at ``cfg.checkpoint_dir``, with the
    JAX runner's fingerprints (``benchmarks/common.py:475-520``):
    ``steps_per_epoch`` is identity (it maps global steps to batches), the
    resolved quantization policy and stripe hatch are layout."""
    identity, layout, desc = ckpt.split_config_fingerprint(
        cfg, spec,
        extra_identity={"steps_per_epoch": steps_per_epoch},
        extra_layout={
            "quant_resolved": "off",
            "stripe_bwd_resolved": os.environ.get("MPI4DL_STRIPE_BWD", "0"),
        },
    )
    return ckpt.CheckpointManager(
        cfg.checkpoint_dir,
        fingerprint=ckpt.config_fingerprint(cfg, spec, {"steps_per_epoch": steps_per_epoch}),
        identity=identity, layout=layout, layout_desc=desc, group=group)


def run(family: str, model: str, argv=None, on_restore=None) -> dict:
    """Parse flags, train, print; returns the summary dict (rank 0 prints).
    ``on_restore(state, manager)`` is called after a checkpoint restore."""
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
    if family not in ("lp", "gems", "sp", "gems_sp"):
        raise ValueError(f"unknown family {family!r}")
    if family in ("lp", "gems"):
        spec = MeshSpec(data=cfg.data_parallel, stage=max(cfg.split_size, 1))
    else:
        spec = MeshSpec.from_config(cfg)
        if spec.sph * spec.spw < 2:
            raise ValueError(f"the {family} runner needs --num-spatial-parts > 1 "
                             "(single device: python -m mpi4dl_tpu_torch)")
    dev = resolve_device(args.device)
    mesh, rank = None, 0
    if spec.size > 1:
        rank = initialize_distributed("gloo" if dev.type == "cpu" else "nccl")
        mesh = build_process_mesh(spec)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    say = print if rank == 0 else (lambda *a, **k: None)
    if cfg.enable_master_comm_opt:
        say("note: --enable-master-comm-opt is a no-op here — the one-weight-set "
            "GEMS redesign cannot diverge, so the reference's MASTER-OPT param/grad "
            "exchange (train_spatial_master.py:229-455) has nothing to synchronize.",
            flush=True)
    say(f"ranks: {spec.size} x {dev.type} "
        f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}); "
        f"mesh data {spec.data} stage {spec.stage} tiles {spec.sph}x{spec.spw}",
        flush=True)
    step, state, notes, tail = _build(cfg, family, dev, mesh, say)
    batch = cfg.batch_size * spec.data
    steps = args.steps_per_epoch
    total = cfg.num_epochs * steps

    mgr, start, saves, restore_ms = None, 0, [], None
    if cfg.checkpoint_dir:
        # The ranks agree on saves and restores over gloo, on any device.
        group = dist.new_group(backend="gloo") if spec.size > 1 else None
        mgr = checkpoint_manager(cfg, spec, steps, group)
        t0 = time.perf_counter()
        state, start = mgr.restore_latest(state)
        if mgr.last_restore is not None:
            restore_ms = (time.perf_counter() - t0) * 1e3
            if on_restore is not None:
                on_restore(state, mgr)
        if start:
            say(f"resuming from checkpoint step {start}", flush=True)
        if mgr.last_restore is not None and mgr.last_restore.elastic:
            say("note: ELASTIC restore — checkpoint was saved under a different "
                f"layout ({mgr.last_restore.saved_layout}); leaves re-placed under "
                "this run's mesh", flush=True)
        if start >= total:
            say(f"note: checkpoint step {start} already covers {cfg.num_epochs} "
                f"epoch(s) x {steps} steps — nothing to run", flush=True)

    def save(step_id: int) -> None:
        t0 = time.perf_counter()
        mgr.save(state, step_id)
        st = mgr.last_save_stats  # rank 0's: every rank's shards, the slowest's times
        saves.append({"step": step_id, "ms": (time.perf_counter() - t0) * 1e3,
                      **({"bytes": st.bytes, "gather_ms": st.gather_ms,
                          "write_ms": st.write_ms} if st is not None else {})})
        say(f"checkpoint: step {step_id} saved in {saves[-1]['ms']:.1f} ms "
            f"({saves[-1].get('bytes')} bytes; device-to-host "
            f"{saves[-1].get('gather_ms', 0):.1f} ms, CRC32 + write + fsync "
            f"{saves[-1].get('write_ms', 0):.1f} ms)", flush=True)

    if mgr is not None and mgr.latest_path() is None:
        save(start)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dataset = make_dataset(cfg)
    meter = StepMeter(batch, warmup_steps=1)
    halo_conv.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, x, y = [], None, None
    # The meter times a step from its batch in hand (the JAX runner's);
    # fetch_ms is the loop's wait for each batch (the decode when no worker
    # runs ahead), so fed img/s, over both, prices the input pipeline.
    fetch_ms = []
    # closing: an exception mid-run stops the prefetch thread at once.
    with contextlib.closing(prefetch_batches(dataset, batch, start, total,
                                             index_of=lambda g: g % steps,
                                             num_workers=cfg.num_workers)) as batches:
        t_fetch = time.perf_counter()
        for g, (xb, yb) in batches:
            fetch_ms.append((time.perf_counter() - t_fetch) * 1e3)
            sync()
            t0 = time.perf_counter()
            x = torch.from_numpy(xb).to(dev)
            y = torch.from_numpy(yb).to(dev, torch.int64)
            state, m = step(state, x, y)
            losses.append(float(m["loss"]))  # synchronises
            ms = (time.perf_counter() - t0) * 1e3
            meter.add(ms)
            say(f"step {g}: loss {losses[-1]:.6f}  {batch / ms * 1e3:.3f} "
                f"img/s ({ms:.1f} ms)", flush=True)
            if mgr is not None and (g + 1) % steps == 0:
                save(g + 1)
            t_fetch = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if peak is not None:
        print(f"rank {rank}: peak {peak / 2**30:.2f} GiB", flush=True)
    if args.profile_dir and x is not None:
        _profile_step(args.profile_dir, rank, lambda: step(state, x, y), dev, say)
    say(meter.summary(), flush=True)
    fed = [f + m for f, m in zip(fetch_ms[1:], meter.times_ms)]  # after the warm-up
    out = {"images_per_sec": meter.images_per_sec(), "losses": losses,
           "fetch_ms": fetch_ms,
           "fed_images_per_sec": batch * len(fed) / sum(fed) * 1e3 if fed else None,
           "stats": meter.stats(), "peak_bytes": peak,
           "launches": dict(halo_conv.LAUNCHES), "ranks": spec.size,
           "start_step": start, "final_step": start + len(losses),
           "elastic": bool(mgr is not None and mgr.last_restore is not None
                           and mgr.last_restore.elastic),
           "checkpoint": ({"saves": saves, "restore_ms": restore_ms}
                          if mgr is not None else None),
           **notes}
    if tail is not None:
        out.update(tail_agreement(tail, mesh.tiles.group))
    say(json.dumps(out), flush=True)
    return out


def tail_agreement(tail, group) -> dict:
    """Whether the tile ranks of ``group`` hold the same tail (the cells
    after the junction, replicated on every tile): the number of its
    parameters and running statistics whose bits differ across the ranks
    (or are not finite), and the largest difference."""
    differing, worst = 0, 0.0
    tensors = list(tail.state_dict().values())
    for t in tensors:
        hi = t.detach().float().clone()
        lo = hi.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        d = float((hi - lo).max()) if t.numel() else 0.0
        if d > 0 or not math.isfinite(d):
            differing += 1
        worst = max(worst, d)
    return {"tail_tensors": len(tensors), "tail_differing": differing,
            "tail_max_abs_diff": worst}


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
