"""The runners' shared flow (counterpart of the ``lp``, ``gems``, ``sp`` and
``gems_sp`` families of ``benchmarks/common.py``).

Parse the JAX package's flags, join the ``torchrun`` process group (gloo
with ``--device cpu``, else NCCL with one card per rank), build the mesh
over the ranks (``mesh.build_process_mesh``: rank layout row-major over
``(data, stage, sph, spw)``), the model (random weights from ``--seed``,
the same on every rank) and the family's step, then train as the JAX
runner does (``benchmarks/common.py:449-605``): under the supervised loop
(``resilience.run_supervised``: anomaly guard with rollback, preemption-
safe saves through the background writer, ``MPI4DL_FAULT`` injection, the
step watchdog ``--watchdog-secs`` / ``--watchdog-compile-secs``), global
step ``g`` taking batch ``g % --steps-per-epoch`` of ``data.make_dataset``
(``--app`` 1 image folder at ``--datapath``, 2 CIFAR-like, 3 synthetic
from ``--seed``; a global batch of ``--batch-size`` images per data
replica) through ``prefetch_batches`` (``--num-workers`` > 0: a background
thread), moved to the device inside the timed step.  With
``--checkpoint-dir`` the run restores the newest valid checkpoint of the
JAX runner's fingerprints and goes on from its step; the loop saves once
before the first step when the directory holds none, at every epoch
boundary and on preemption (a preempted run returns normally: exit 0).
``--telemetry-dir`` writes rank 0's RunLog (``obs/runlog.py``): beside the
JAX runner's records its ``cost`` record, counted on the warm-up step (the
loop's first call of the step, run under ``obs.costs.counting``: FLOPs,
bytes, arithmetic intensity, the card's peak, ``tick_scopes``, and on
ranks ``flops_by_rank``, gathered to rank 0, and ``flops`` their mean), and
at the end the ``<runlog>.prom`` OpenMetrics snapshot beside it (render
both with ``python -m mpi4dl_tpu_torch.obs``).  The ranks
of a job take every decision together over a gloo group (the loop's
"Ranks").  It prints one line per step, each save's wait and time to disk,
and the ``StepMeter`` summary (the first step is the warm-up); the last
line is the summary as JSON, with each step's ms and whether a background
write overlapped it.  The ``sp`` and ``gems_sp`` families' last line also
says whether the tile ranks' tails (this stage's cells after the junction)
agree (``tail_agreement``).  ``--quant`` (or the
``MPI4DL_QUANT_COLLECTIVES`` hatch, which wins) is resolved once
(``quant.QuantPolicy.resolve``; rank 0 prints ``note: quantized
collectives on: <spec>`` to stderr when it is on), passed to every family's
step but the single-device/DP one (JAX's ``build_train``), and recorded in
the checkpoint layout as ``quant_resolved``; the last line carries the
step's collective bytes per class (``wire_bytes``, ``raw_bytes``: this
rank's sends over the whole run, ``quant.collectives.WIRE_BYTES``).

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
engines directly.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from mpi4dl_tpu_torch import checkpoint as ckpt
from mpi4dl_tpu_torch.cells import split_even
from mpi4dl_tpu_torch.config import config_from_args, get_parser, resolve_pallas_conv
from mpi4dl_tpu_torch.data import make_dataset
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.layer_ctx import spatial_levels_for
from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh, initialize_distributed
from mpi4dl_tpu_torch.models import build_model
from mpi4dl_tpu_torch.obs.costs import arithmetic_intensity, counting, peak_flops
from mpi4dl_tpu_torch.obs.metrics import write_metrics_file
from mpi4dl_tpu_torch.obs.runlog import RunLog, read_runlog, run_device_count
from mpi4dl_tpu_torch.ops import halo_conv
from mpi4dl_tpu_torch.parallel.spatial import cell_output_shapes, choose_spatial_until
from mpi4dl_tpu_torch.quant import QuantPolicy
from mpi4dl_tpu_torch.quant import collectives as qc
from mpi4dl_tpu_torch.resilience import (
    AnomalyGuard, FaultInjector, run_supervised, watchdog_budget_from_env,
)
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


def level_ctxs(cfg, parts, tiles=None) -> list:
    """The SpatialCtx of each level of the chain ``parts`` with the runner's
    settings (slicing, cross-tile BatchNorm, D2, the kernels)."""
    return spatial_levels_for(
        cfg.slice_method, parts, tiles=tiles, bn_cross_tile=cfg.bn_cross_tile,
        d2_mode=cfg.halo_d2,
        d2_max_fused=cfg.fused_layers if cfg.fused_layers > 0 else None,
        use_pallas_conv=resolve_pallas_conv(cfg.pallas_conv))


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
    ctxs = level_ctxs(cfg, parts, tiles)
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


def _build(cfg, family: str, dev, mesh, say, quant=None, levels=None):
    """(step, state, notes, tail cells) of the family at ``cfg`` on this
    rank; the tail cells are those whose replicas the tile ranks must agree
    on (None outside the spatial families).  ``quant``: the resolved
    quantization policy.  ``levels(mdl, tiles)``: the spatial families'
    ``[(stop_cell, SpatialCtx)]`` chain in place of :func:`spatial_levels`
    (the readiness tool's even split of the region over a square chain)."""
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
                  schedule=cfg.schedule, pallas_conv=pallas, quant=quant)
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
    levels = (spatial_levels(cfg, len(mdl.cells), mdl.in_shape, mesh.tiles, say)
              if levels is None else levels(mdl, mesh.tiles))
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
            with_data_axis=data, levels=levels, quant=quant)
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
              schedule=cfg.schedule, quant=quant)
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
    quant = QuantPolicy.resolve(cfg.quant_collectives)
    identity, layout, desc = ckpt.split_config_fingerprint(
        cfg, spec,
        extra_identity={"steps_per_epoch": steps_per_epoch},
        extra_layout={
            "quant_resolved": quant.spec() if quant is not None else "off",
            "stripe_bwd_resolved": os.environ.get("MPI4DL_STRIPE_BWD", "0"),
        },
    )
    return ckpt.CheckpointManager(
        cfg.checkpoint_dir,
        fingerprint=ckpt.config_fingerprint(cfg, spec, {"steps_per_epoch": steps_per_epoch}),
        identity=identity, layout=layout, layout_desc=desc, group=group)


def run(family: str, model: str, argv=None, on_restore=None) -> dict:
    """Parse flags, train under the supervised loop, print; returns the
    summary dict (rank 0 prints).  ``on_restore(state, manager)`` is called
    after a checkpoint restore."""
    p = get_parser()
    p.set_defaults(model=model)
    p.add_argument("--steps-per-epoch", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (NCCL, one card per rank) or cpu (gloo)")
    p.add_argument("--profile-dir", default=None,
                   help="profile one more step; per-rank device-time tables and "
                        "Chrome traces go to this directory (with --telemetry-dir "
                        "also its timeline and overlap records)")
    p.add_argument("--telemetry-dir", default=None,
                   help="write a RunLog JSONL (meta, the warm-up step's cost "
                        "record: FLOPs, bytes, peak for the MFU; step, "
                        "checkpoint, anomaly, recovery, preempt, quarantine "
                        "and summary records) and its .prom metrics snapshot "
                        "under this directory (rank 0); render with `python "
                        "-m mpi4dl_tpu_torch.obs report`")
    p.add_argument("--watchdog-secs", type=float, default=None,
                   help="step wall-clock budget: a step (batch fetch + device "
                        "step) exceeding it dumps live Python stacks, the last "
                        "RunLog record and memory stats to stderr (default: "
                        "MPI4DL_WATCHDOG_SECS, else off)")
    p.add_argument("--watchdog-compile-secs", type=float, default=None,
                   help="watchdog budget for the FIRST step (default: "
                        "MPI4DL_WATCHDOG_COMPILE_SECS, else 10x the step budget)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
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
    quant = QuantPolicy.resolve(cfg.quant_collectives)
    if quant is not None and rank == 0:
        print(f"note: quantized collectives on: {quant.spec()}", file=sys.stderr,
              flush=True)
    step, state, notes, tail = _build(cfg, family, dev, mesh, say, quant)
    batch = cfg.batch_size * spec.data
    steps = args.steps_per_epoch
    total = cfg.num_epochs * steps
    # The ranks agree on saves, restores, rollbacks and preemption over gloo,
    # on any device.
    group = dist.new_group(backend="gloo") if spec.size > 1 else None
    meter, runlog = StepMeter(batch, warmup_steps=1), None
    try:
        mgr, start, restore_ms = None, 0, None
        if cfg.checkpoint_dir:
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

        runlog = None
        if args.telemetry_dir and rank == 0:
            runlog = RunLog.create(args.telemetry_dir, prefix=f"{family}-{cfg.model}")
            runlog.write_meta(config=cfg, mesh_spec=spec, family=family, device=dev,
                              argv=list(argv) if argv is not None else sys.argv[1:])
            if mgr is not None and mgr.last_restore is not None:
                runlog.write("restore", **mgr.last_restore.record())

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        # The loop times step_fn from the batch in hand (the JAX runner's): the
        # host-to-device copy, the step and the wait for the card.  With
        # --telemetry-dir its first call, the warm-up, is counted.
        last, uncounted = {}, [bool(args.telemetry_dir)]

        def step_fn(st, xb, yb):
            x = torch.from_numpy(np.asarray(xb)).to(dev)
            y = torch.from_numpy(np.asarray(yb)).to(dev, torch.int64)
            last.update(x=x, y=y)
            if uncounted[0]:
                uncounted[0] = False
                with counting() as cost:
                    st, m = step(st, x, y)
                sync()
                write_cost(runlog, cost, dev, group)
                last["cost"] = cost
                return st, m
            st, m = step(st, x, y)
            sync()
            return st, m

        losses, waits, step_ms, step_end, saves = [], [], [], [], []

        def on_step(gstep, loss, ms, fetch_ms):
            losses.append(loss)
            waits.append(fetch_ms)
            step_ms.append(ms)
            step_end.append(time.perf_counter())

        def on_checkpoint(st):
            # Rank 0's stats: every rank's shards, the slowest rank's times.
            saves.append({"step": st.step_id, "stall_ms": st.stall_ms,
                          "durable_ms": st.durable_ms, "bytes": st.bytes,
                          "gather_ms": st.gather_ms, "write_ms": st.write_ms,
                          "peak_pending_bytes": st.peak_pending_bytes,
                          "t_durable": time.perf_counter()})
            say(f"checkpoint: step {st.step_id}: the training thread waited "
                f"{st.stall_ms:.1f} ms, durable after {st.durable_ms:.1f} ms "
                f"({st.bytes} bytes; device-to-host {st.gather_ms:.1f} ms, CRC32 + "
                f"write + fsync {st.write_ms:.1f} ms; peak pending "
                f"{st.peak_pending_bytes} bytes)", flush=True)

        dataset = make_dataset(cfg)
        halo_conv.reset_launch_counts()
        qc.reset_wire_bytes()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        result = run_supervised(
            step_fn, state, dataset,
            global_batch=batch, steps_per_epoch=steps, num_epochs=cfg.num_epochs,
            num_workers=cfg.num_workers, start_step=start, ckpt=mgr,
            runlog=runlog, meter=meter, print_fn=lambda line: say(line, flush=True),
            profile=bool(args.profile_dir), guard=AnomalyGuard.from_env(),
            faults=FaultInjector.from_env(),
            watchdog_secs=watchdog_budget_from_env(args.watchdog_secs),
            watchdog_compile_secs=args.watchdog_compile_secs,
            group=group, on_step=on_step, on_checkpoint=on_checkpoint)
    finally:
        if runlog is not None:
            runlog.write("summary", **meter.stats())
            runlog.close()
            say(f"telemetry written to {runlog.path} (render: python -m "
                f"mpi4dl_tpu_torch.obs report {runlog.path})", flush=True)
            try:
                prom = os.path.splitext(runlog.path)[0] + ".prom"
                write_metrics_file(read_runlog(runlog.path), prom)
                say(f"metrics snapshot written to {prom}", flush=True)
            except Exception as e:  # noqa: BLE001 — telemetry must never kill a run
                print(f"note: metrics snapshot unavailable ({e!r})", file=sys.stderr,
                      flush=True)
        if group is not None:
            dist.destroy_process_group(group)
    state = result.state
    wire, raw = dict(qc.WIRE_BYTES), dict(qc.RAW_BYTES)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if peak is not None:
        print(f"rank {rank}: peak {peak / 2**30:.2f} GiB ({peak} bytes)", flush=True)
    if args.profile_dir and last:
        _profile_step(args.profile_dir, rank, lambda: step(state, last["x"], last["y"]),
                      dev, say, runlog_path=runlog.path if runlog is not None else None,
                      cost=last.get("cost"), cfg=cfg, family=family)
    say(meter.summary(), flush=True)
    fed = [f + m for f, m in zip(waits[1:], meter.times_ms)]  # after the warm-up
    # A step overlaps a background write when it ran between the end of a
    # save's wait on the training thread and the save being durable (the
    # step's end is taken just after the loop timed it).
    writes = [(s["t_durable"] - (s["durable_ms"] - s["stall_ms"]) / 1e3, s["t_durable"])
              for s in saves]
    overlap = [any(b - ms / 1e3 < w1 and w0 < b for w0, w1 in writes)
               for ms, b in zip(step_ms, step_end)]
    for s in saves:
        del s["t_durable"]
    out = {"images_per_sec": meter.images_per_sec(), "losses": losses,
           "loss": result.metrics.get("loss", float("nan")),
           "step_ms": step_ms, "write_overlap": overlap,
           "fetch_ms": waits,
           "fed_images_per_sec": batch * len(fed) / sum(fed) * 1e3 if fed else None,
           "stats": meter.stats(), "peak_bytes": peak,
           "launches": dict(halo_conv.LAUNCHES), "ranks": spec.size,
           "quant": quant.spec() if quant is not None else "off",
           "wire_bytes": wire, "raw_bytes": raw,
           "start_step": start, "final_step": result.final_step,
           "preempted": result.preempted, "anomalies": result.anomalies,
           "elastic": bool(mgr is not None and mgr.last_restore is not None
                           and mgr.last_restore.elastic),
           "checkpoint": ({"saves": saves, "restore_ms": restore_ms}
                          if mgr is not None else None),
           "telemetry_path": runlog.path if runlog is not None else None,
           **notes}
    if tail is not None:
        out.update(tail_agreement(tail, mesh.tiles.group))
    say(json.dumps(out), flush=True)
    return out


# The schedule scopes the report's `pipeline:` line names (the JAX runner's
# tick_scopes, benchmarks/common.py:364-369).
TICK_SCOPES = ("gpipe_scan", "pp_1f1b_scan", "gems_dual_scan", "gems_1f1b_scan",
               "tail_scan", "fwd_tick", "bwd_tick")


def write_cost(runlog, cost, dev, group) -> None:
    """The counted step's ``cost`` record (counterpart of the JAX runner's,
    ``benchmarks/common.py:339-395``): ``flops``, ``bytes_accessed``,
    ``arithmetic_intensity``, ``tick_scopes``, ``peak_flops`` and
    ``peak_source`` (this card's, or the nominal CPU peak), ``device_count``
    (the run's), and ``kernels`` (the hand kernels' launches and work).
    On ranks every rank takes part: each counts its own step, the counts
    are gathered over ``group`` to rank 0, and the record holds
    ``flops_by_rank`` and ``flops`` = their mean (one card's share, so the
    report's MFU divides by one card's peak).  ``collectives`` holds the
    counted step's collectives on this rank (``obs/comm_stats.py``: per
    class count and bytes, the JAX record's schema).
    Only ``runlog``'s holder writes; an error (in the counting, on any rank,
    or here) becomes a ``cost_error`` record and a printed note instead:
    telemetry must never kill a run, nor hide a failure."""
    try:
        flops, nbytes, err, extra = cost["flops"], cost["bytes_accessed"], cost["error"], {}
        if group is not None:
            mine = torch.tensor([flops, nbytes, err is not None], dtype=torch.int64)
            rows = [torch.zeros_like(mine) for _ in range(dist.get_world_size(group))]
            dist.all_gather(rows, mine, group=group)
            by_rank = [int(r[0]) for r in rows]
            flops = sum(by_rank) / len(rows)
            nbytes = sum(int(r[1]) for r in rows) / len(rows)
            failed = [i for i, r in enumerate(rows) if r[2]]
            if failed and err is None:
                err = f"counting failed on rank(s) {failed}"
            extra["flops_by_rank"] = by_rank
        if err is not None:
            raise RuntimeError(f"the step's counting failed: {err}")
        if runlog is None:
            return
        peak, src = peak_flops(dev, allow_cpu_nominal=True)
        runlog.write("cost", flops=flops, bytes_accessed=nbytes,
                     arithmetic_intensity=arithmetic_intensity(flops, nbytes),
                     tick_scopes=[s for s in cost["scopes"] if s in TICK_SCOPES],
                     peak_flops=peak, peak_source=src, device_count=run_device_count(),
                     kernels=cost["kernels"], collectives=cost["collectives"], **extra)
    except Exception as e:  # noqa: BLE001 — telemetry must never kill a run
        if runlog is not None:
            runlog.write("cost_error", error=repr(e))
        print(f"note: telemetry cost record unavailable ({e!r})", file=sys.stderr,
              flush=True)


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


def _profile_step(path: str, rank: int, step, dev, say, runlog_path=None, cost=None,
                  cfg=None, family=None) -> None:
    """One profiled step: its device time by kernel to ``path/rank<r>.txt``,
    its Chrome trace to ``path/rank<r>.trace.json.gz`` (with the
    collectives of one more recorded step beside it,
    ``<trace>.collectives.json``: ``obs/overlap.py`` matches them to the
    trace's NCCL kernels) and the device's busy share of the step.  With
    ``runlog_path`` (rank 0's RunLog) the measured ``timeline`` and
    ``overlap`` records of the profiled step are appended to it, and the
    analytical ``timeline`` of the counted warm-up (``cost``)."""
    from mpi4dl_tpu_torch.obs import kineto
    from mpi4dl_tpu_torch.obs.comm_stats import recording_collectives, scope_collectives
    from mpi4dl_tpu_torch.obs.costs import ici_bytes_per_s
    from mpi4dl_tpu_torch.obs.overlap import ledger_from_records, ledger_from_trace
    from mpi4dl_tpu_torch.obs.timeline import analytical_timeline, measured_timeline

    with recording_collectives() as records:
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
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
    trace_path = os.path.join(path, f"rank{rank}.trace.json.gz")
    prof.export_chrome_trace(trace_path)
    kineto.save_collectives(trace_path, records)
    say(f"profile: step {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%); trace {trace_path}",
        flush=True)
    if runlog_path is None:
        return
    tr = kineto.Trace(trace_path)
    ledger = ledger_from_trace(tr)
    records_out = [("timeline", dict(label="profile", **measured_timeline(tr))),
                   ("overlap", dict(label="profile", **ledger))]
    if cost is not None:
        peak, psrc = peak_flops(dev, allow_cpu_nominal=True)
        ici, isrc = ici_bytes_per_s(dev)
        piped = cfg is not None and cfg.split_size > 1
        rec_ledger = ledger_from_records(cost["collective_records"],
                                         compute_ms=cost["flops"] / peak * 1e3, ici_bw=ici,
                                         ici_source=isrc, peak=peak, peak_source=psrc)
        records_out.append(("timeline", dict(label="warm-up", **analytical_timeline(
            cost["by_scope"], scope_collectives(cost["collective_records"]), peak=peak,
            peak_source=psrc, ici_bw=ici, ici_source=isrc, ledger=rec_ledger,
            schedule=cfg.schedule if piped else None,
            stages=cfg.split_size if piped else None,
            parts=cfg.parts if piped else None))))
    with RunLog(runlog_path) as runlog:
        for kind, fields in records_out:
            runlog.write(kind, **fields)
