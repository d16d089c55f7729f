"""SP x PP and SP + GEMS: a spatial region on tiles, then a pipelined tail
(counterpart of ``mpi4dl_tpu/parallel/sp_pipeline.py``).

A step runs in two phases on a mesh of (data, stage, sph, spw) ranks, or
in one process on a :class:`~mpi4dl_tpu_torch.parallel.tiles.TileGrid`
and a :class:`~mpi4dl_tpu_torch.parallel.stages.StageChain`:

- **Phase 1** (``sp_pipeline.py:294-330``): stage rank ``s`` takes its
  chunk of the batch, ``x[s·B/S:(s+1)·B/S]``, cuts its tiles and runs the
  spatial region (cells ``[0, spatial_until)``) on them; the region's
  BatchNorm takes statistics over that chunk.  The junction
  (``parallel/spatial.apply_junction``: ``gather``, or ``batch_split``)
  follows, then the **stage lineup**: an all_gather over the stage group
  lines every chunk up in batch order on every stage rank
  (``:336-350``); its backward is the exact adjoint, a reduce-scatter,
  which sums the cotangents that stage 0 — and under GEMS stage S-1, where
  stream B enters — hand back.  The chain runs the region once per chunk.
- **Phase 2**: the tail's :class:`StagePartition` runs the pipeline
  schedules (GPipe, 1F1B) or GEMS's dual loops with ``grad_x=True``; the
  cotangents of the injected micro-batches flow back through the lineup,
  the junction and the region in one ``autograd.grad``.

Gradients (the lesson of C1): the region's are summed over stage x tile
ranks — under ``gather`` each holds one chunk's tile share, under
``batch_split`` the sum is divided by the tile count, as the SP step does
(``train.make_spatial_train_step``) — and averaged over ``data``: one
all-reduce over every rank, with the region's running statistics (their
mean over stage and data ranks: each chunk deposits once a step) and the
metrics.  The tail's are averaged over the tile ranks of its own stage
and over ``data``: one all-reduce over the data x tile group, with the
tail's statistics.  On the one-process grid and chain there is nothing to
reduce but the data axis.  ``labels_to_parts`` (``:352-364``) applies
phase 1's index map to the labels.  With ``levels`` (multi-level SP,
level 0 unreplicated, ``:140-150``) the region runs level by level; a
degenerate level's gradients are complete on each tile rank of a stage
under ``gather``, so they are averaged over the tiles as the tail's are.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.cells import CellModel
from mpi4dl_tpu_torch.distributed import all_reduce_scaled_
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.parallel.gems import GemsMirror, combine_streams
from mpi4dl_tpu_torch.parallel.partition import StagePartition, probe_cell
from mpi4dl_tpu_torch.parallel.pipeline import local_params
from mpi4dl_tpu_torch.parallel.spatial import (
    active_region_cells, apply_junction, apply_spatial_region, junction_degree,
    junction_shard_index,
)
from mpi4dl_tpu_torch.parallel.stage_common import gems_dual, gpipe, one_f_one_b
from mpi4dl_tpu_torch.train import Optimizer, TrainState, data_shard, merge_stat_updates


def _map(fn, x):
    return tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)


def _leaves(x) -> List[torch.Tensor]:
    return list(x) if isinstance(x, tuple) else [x]


@dataclasses.dataclass
class SPPipeline:
    """A model split into a spatial region (cells ``[0, spatial_until)``
    under ``sp``) and a pipelined tail (``tail_part``, over a CellModel of
    the remaining cells, which shares their modules); ``degree`` is the
    ``batch_split`` junction's and ``mb_tail`` the tail's micro-batch on
    one device (``sp_pipeline.py:101-197``)."""

    model: CellModel
    spatial_until: int
    sp: SpatialCtx
    tail_part: StagePartition
    junction: str
    mb_tail: int
    degree: int
    levels: Optional[list] = None

    @classmethod
    def build(cls, model: CellModel, split_size: int, sp: SpatialCtx, microbatch: int,
              junction: str = "batch_split", balance=None, levels=None,
              local_dp: Optional[int] = None) -> "SPPipeline":
        """``microbatch`` images a micro-batch before the junction; the
        tail's boundary shapes from one meta-device forward."""
        su = model.spatial_until
        if not 0 < su < len(model.cells):
            raise ValueError(f"spatial_until={su} must split the {len(model.cells)} cells")
        if levels is not None:
            if levels[-1][0] != su:
                raise ValueError(f"the last level ends at cell {levels[-1][0]}, "
                                 f"spatial_until is {su}")
            if levels[0][1] is not sp or sp.rep_h != 1 or sp.rep_w != 1:
                raise ValueError("level 0 must be sp, the unreplicated grid")
        sp_last = levels[-1][1] if levels else sp
        degree = junction_degree(sp_last, local_dp) if junction == "batch_split" else 1
        if microbatch % degree:
            raise ValueError(f"micro-batch {microbatch} not divisible by junction degree "
                             f"{degree}")
        mb_tail = microbatch // degree
        x = torch.empty((microbatch, *model.in_shape[1:]), device="meta")
        for i in range(su):
            x = probe_cell(model.cells[i], x, ApplyCtx(train=False))
        shape = _map(lambda t: (mb_tail, *t.shape[1:]), x)
        tail = CellModel(list(model.cells[su:]), model.in_shape, model.num_classes,
                         name=model.name + "_tail")
        tail_part = StagePartition.build(tail, split_size, shape, balance=balance)
        return cls(model, su, sp, tail_part, junction, mb_tail, degree, levels)

    @property
    def sp_last(self) -> SpatialCtx:
        return self.levels[-1][1] if self.levels else self.sp

    def region_params(self) -> List[torch.Tensor]:
        return [p for cell in self.model.cells[:self.spatial_until]
                for p in cell.parameters() if p.requires_grad]

    def replicated_region_params(self) -> set:
        """ids of the region's parameters on degenerate levels."""
        tiled = {id(p) for cell in active_region_cells(self.model, self.spatial_until,
                                                        self.levels)
                 for p in cell.parameters()}
        return {id(p) for p in self.region_params() if id(p) not in tiled}


def init_sp_pipeline_state(spp: SPPipeline, optimizer: Optimizer, stages) -> TrainState:
    """The model and an optimizer state over the region's parameters and
    this process's tail stages'."""
    params = spp.region_params() + local_params(spp.tail_part, stages)
    return TrainState(spp.model, optimizer.init(params), 0, params)


class _StageLineup(torch.autograd.Function):
    """Every stage rank's chunk, concatenated in stage order on every rank;
    the backward is its adjoint, the reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group), *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return None, out


def _lineup_order(spp: SPPipeline, S: int, groups: int, folded: bool, n: int):
    """Row order of the tail's micro-batches in the lined-up batch of ``n``
    rows (``S`` chunks): batch order, except on the one-process grid under
    ``batch_split``, whose micro-batch ``g`` is every shard's micro-batch
    ``g``, shard after shard (the tail normalises each with its own
    statistics, ``ApplyCtx.bn_shards``)."""
    idx = torch.arange(n)
    if not (folded and spp.junction == "batch_split" and spp.degree > 1):
        return idx
    d = spp.degree
    idx = idx.view(S, d, n // (S * d)).transpose(0, 1).reshape(d, groups, spp.mb_tail)
    return idx.transpose(0, 1).reshape(-1)


def _make_sp_step(spp: SPPipeline, optimizer: Optimizer, stages, lead, run_tail,
                  denom: int, compute_dtype, remat: bool, with_data_axis,
                  loss_scale: float, pallas_conv: Optional[bool]):
    """The steps' shared flow (``_make_sp_step``, ``sp_pipeline.py:231-470``):
    phase 1, the junction, the lineup, ``run_tail(x_groups, y_groups, ctx,
    seed) -> (loss, acc, tail grads, tail stats, grad_x groups)``, the
    region's backward, the reductions and the update.  ``lead`` shapes the
    injected micro-batches: ``(Pn,)`` or GEMS's ``(times, 2, Pn)``."""
    sp = spp.sp
    part = spp.tail_part
    S = part.num_stages
    su = spp.spatial_until
    tiles = sp.tiles
    data = with_data_axis
    ranks = stages.group is not None
    if ranks == tiles.folded:
        raise ValueError("SP x PP runs one tile and one stage a rank, or the "
                         "one-process grid with the one-process stage chain")
    groups = 1
    for d in lead:
        groups *= d
    local_dp = spp.degree if spp.junction == "batch_split" else None
    sp_ctx = ApplyCtx(train=True, spatial=sp)
    knob = sp.use_pallas_conv if pallas_conv is None else pallas_conv
    tail_ctx = ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True) if knob else None,
                        bn_shards=spp.degree if (tiles.folded and spp.junction == "batch_split")
                        else 1)
    region = spp.region_params()
    # Under gather a degenerate level's gradients are complete on every
    # tile rank of a stage (spatial.py's region rule).
    replicated = spp.replicated_region_params() if spp.junction == "gather" else set()
    params = region + local_params(part, stages)
    seed = loss_scale / denom
    t = 1 if tiles.folded else tiles.tiles
    d_size = data.size if data is not None else 1
    chunks = (stages.stage,) if ranks else tuple(range(S))

    def phase1(x):
        """The region and the junction on each of this process's chunks, the
        lineup, and the region's running-statistics deposits (mean over
        the chunks)."""
        B = x.shape[0]
        if B % S:
            raise ValueError(f"batch {B} must divide over {S} stage chunks")
        chunk = B // S
        outs, sinks = [], []
        for s in chunks:
            c = dataclasses.replace(sp_ctx, bn_sink={})
            with scope("sp_region"):
                act, sp_last = apply_spatial_region(
                    spp.model, tiles.scatter(x[s * chunk:(s + 1) * chunk]), c, su,
                    remat=remat, levels=spp.levels, junction=spp.junction)
            outs.append(apply_junction(act, sp_last, spp.junction, local_dp))
            sinks.append(c.bn_sink)
        with scope("stage_lineup"):
            if ranks:
                line = _map(lambda v: _StageLineup.apply(stages.group, v), outs[0])
            elif isinstance(outs[0], tuple):
                line = tuple(torch.cat(leaf) for leaf in zip(*outs))
            else:
                line = torch.cat(outs)
        stats = {bn: tuple(sum(sk[bn][i] for sk in sinks) / len(sinks) for i in (0, 1))
                 for bn in sinks[0]}
        return line, stats

    def labels_to_parts(labels):
        B = labels.shape[0]
        chunk = B // S
        if spp.junction == "batch_split" and ranks:
            k = junction_shard_index(spp.sp_last, spp.degree)
            labels = labels.reshape(S, spp.degree, chunk // spp.degree)[:, k].reshape(-1)
        return labels

    def grouped(rows_of):
        """Micro-batch ``rows_of(g)`` (``g`` in injection order) laid out
        as ``lead``."""
        if len(lead) == 1:
            return [rows_of(g) for g in range(groups)]
        times, two, pn = lead
        return [[[rows_of((k * two + j) * pn + p) for p in range(pn)] for j in range(two)]
                for k in range(times)]

    def step(state: TrainState, x, labels):
        x, labels = data_shard(x, data), data_shard(labels, data)
        line, sp_stats = phase1(x.to(compute_dtype))
        n = _leaves(line)[0].shape[0]
        if n % groups:
            raise ValueError(f"{n} tail rows do not make {groups} micro-batches")
        order = _lineup_order(spp, S, groups, tiles.folded, n).to(_leaves(line)[0].device)
        rows = n // groups
        x_line = _map(lambda v: v.index_select(0, order), line)
        y_line = labels_to_parts(labels).index_select(0, order.to(labels.device))
        x_groups = grouped(lambda g: _map(lambda v: v[g * rows:(g + 1) * rows], x_line))
        y_groups = grouped(lambda g: y_line[g * rows:(g + 1) * rows])
        loss, acc, tail_grads, tail_stats, gx = run_tail(x_groups, y_groups, tail_ctx,
                                                         seed)
        # The region's backward: the injected micro-batches' cotangents
        # (zero where this process holds no entering stage) through the
        # lineup, the junction and the region.
        outs, cots = [], []
        for g in range(groups):
            xg = _map(lambda v: v[g * rows:(g + 1) * rows], x_line)
            for i, leaf in enumerate(_leaves(xg)):
                outs.append(leaf)
                cots.append(torch.zeros_like(leaf) if gx[g] is None else _leaves(gx[g])[i])
        with scope("sp_region_bwd"):
            region_grads = torch.autograd.grad(outs, region, grad_outputs=cots,
                                               allow_unused=True)
        region_grads = [torch.zeros_like(p) if g is None else g
                        for p, g in zip(region, region_grads)]
        tail_stats = {bn: (m / denom, v / denom) for bn, (m, v) in tail_stats.items()}
        metrics = [loss / denom, acc / denom]
        with scope("grad_reduce"):
            if ranks:
                sp_scale = 1.0 / (d_size * (t if spp.junction == "batch_split" else 1))
                sp_st = [v for mv in sp_stats.values() for v in mv]
                all_reduce_scaled_(
                    region_grads + sp_st + metrics,
                    [(sp_scale / t if id(p) in replicated else sp_scale) / loss_scale
                     for p in region]
                    + [1.0 / (d_size * S * t)] * len(sp_st)
                    + [1.0 / (d_size * t)] * 2, dist.group.WORLD)
                tail_st = [v for mv in tail_stats.values() for v in mv]
                tail_group = (data.with_tiles if data is not None else tiles.group)
                all_reduce_scaled_(tail_grads + tail_st,
                                   [1.0 / (d_size * t * loss_scale)] * len(tail_grads)
                                   + [1.0 / (d_size * t)] * len(tail_st), tail_group)
            else:
                everything = region_grads + tail_grads
                st = [v for mv in list(sp_stats.values()) + list(tail_stats.values())
                      for v in mv]
                all_reduce_scaled_(everything + st + metrics,
                                   [1.0 / (d_size * loss_scale)] * len(everything)
                                   + [1.0 / d_size] * (len(st) + 2),
                                   None if data is None else data.group)
        with scope("optimizer_update"):
            state.opt_state = optimizer.update(params, region_grads + tail_grads,
                                               state.opt_state)
        merge_stat_updates({**sp_stats, **tail_stats})
        state.step += 1
        return state, {"loss": metrics[0], "accuracy": metrics[1]}

    return step


def make_sp_pipeline_train_step(spp: SPPipeline, optimizer: Optimizer, stages, parts: int,
                                compute_dtype=torch.float32, remat: bool = True,
                                with_data_axis=None, loss_scale: float = 1.0,
                                schedule: str = "gpipe",
                                pallas_conv: Optional[bool] = None):
    """SP x PP (``sp_pipeline.py:474-535``): ``step(state, x, labels)``, x
    the batch of one data replica, ``parts`` micro-batches of
    ``microbatch`` images; the batch must divide over the stages and, under
    ``batch_split``, each stage chunk over the junction degree.  The tail
    runs GPipe or 1F1B (``schedule``); ``pallas_conv`` (default: the
    region's knob, ``sp.use_pallas_conv``) routes the tail stages' convs
    through K1/K2."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}; use 'gpipe' or '1f1b'")
    part = spp.tail_part

    def run_tail(x_groups, y_groups, ctx, seed):
        if schedule == "1f1b":
            with scope("pp_1f1b"):
                res = one_f_one_b(part, stages, ctx, x_groups, y_groups, seed=seed,
                                  grad_x=True)
        else:
            with scope("gpipe"):
                res = gpipe(part, stages, ctx, x_groups, y_groups, seed=seed,
                            remat=remat, grad_x=True)
        grads = [g for s in stages.local_stages for g in res.grads[s]]
        return res.loss, res.accuracy, grads, res.stats, res.grad_x or [None] * parts

    return _make_sp_step(spp, optimizer, stages, (parts,), run_tail, parts, compute_dtype,
                         remat, with_data_axis, loss_scale, pallas_conv)


def make_sp_gems_train_step(spp: SPPipeline, optimizer: Optimizer, stages, parts: int,
                            times: int = 1, compute_dtype=torch.float32,
                            remat: bool = True, with_data_axis=None,
                            loss_scale: float = 1.0, schedule: str = "gpipe",
                            pallas_conv: Optional[bool] = None):
    """SP + GEMS (``sp_pipeline.py:538-602``): as
    :func:`make_sp_pipeline_train_step`, the batch being 2·times·parts
    micro-batches laid out as (times, 2, parts) (pair ``k``'s stream A,
    then its stream B), the tail running GEMS's dual loops with its mirror
    (``parallel/gems.py``).  On ranks the model must keep the weights of
    ``gems.gems_local_stages``."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}; use 'gpipe' or '1f1b'")
    part = spp.tail_part
    mirror = GemsMirror(part, stages)

    def run_tail(x_groups, y_groups, ctx, seed):
        with scope("gems_mirror"):
            mirror.pull()
        with scope("gems_1f1b_scan" if schedule == "1f1b" else "gems_dual_scan"):
            res = gems_dual(part, stages, ctx, x_groups, y_groups, seed=seed,
                            schedule=schedule, remat=remat, grad_x=True)
        grads, stats = combine_streams(res, mirror, stages.local_stages)
        gx = []
        for a, b in res.grad_x:  # per pair: stream A's then stream B's micro-batches
            gx += list(a) if a is not None else [None] * parts
            gx += list(b) if b is not None else [None] * parts
        return res.loss, res.accuracy, grads, stats, gx

    return _make_sp_step(spp, optimizer, stages, (times, 2, parts), run_tail,
                         2 * times * parts, compute_dtype, remat, with_data_axis,
                         loss_scale, pallas_conv)
