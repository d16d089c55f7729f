"""Single-device training (counterpart of ``mpi4dl_tpu/train.py``).

:func:`make_train_step` returns ``step(state, x, labels) -> (state,
metrics)``, as its JAX counterpart does; PyTorch runs eagerly, so the
step updates the model's parameters and running statistics in place.
With a data axis it trains on its replica's slice of the batch (DP).
:func:`make_spatial_train_step` is the spatial-parallel step (one level or
a multi-level chain, ``gather`` or ``batch_split`` junction, with or
without a data axis); ``remat`` takes the JAX levels (cell, "sqrt",
"fine").  The pipeline steps are ``parallel/pipeline.py``, GEMS
``parallel/gems.py`` and SP x PP / SP + GEMS ``parallel/sp_pipeline.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mpi4dl_tpu_torch.cells import CellModel
from mpi4dl_tpu_torch.distributed import all_reduce_scaled_
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.layers import BatchNorm
from mpi4dl_tpu_torch.parallel.spatial import (
    active_region_cells, apply_spatial_model, junction_degree, junction_shard_index,
)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in fp32 (float64 for
    float64 logits)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.nll_loss(torch.log_softmax(logits, dim=-1), labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """SGD(+momentum) / Adam with fp32 update arithmetic and no fp32 master
    copy (``train.py:62-130``): the state is fp32, the update is computed in
    fp32 and rounded into the parameter's own dtype, in place."""

    kind: str = "sgd"
    lr: float = 0.001
    momentum: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: List[torch.Tensor]):
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
        if self.kind == "sgd":
            return () if self.momentum == 0.0 else (zeros(),)
        if self.kind == "adam":
            return (zeros(), zeros(), 0)
        raise ValueError(self.kind)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               opt_state):
        f32 = torch.float32
        if self.kind == "sgd" and self.momentum == 0.0:
            for p, g in zip(params, grads):
                p.copy_(p.to(f32) - self.lr * g.to(f32))
            return ()
        if self.kind == "sgd":
            (vel,) = opt_state
            for p, g, v in zip(params, grads, vel):
                v.mul_(self.momentum).add_(g.to(f32))
                p.copy_(p.to(f32) - self.lr * v)
            return (vel,)
        if self.kind == "adam":
            m, v, t = opt_state
            t += 1
            bc1 = 1 - self.b1 ** t
            bc2 = 1 - self.b2 ** t
            for p, g, mm, vv in zip(params, grads, m, v):
                g32 = g.to(f32)
                mm.mul_(self.b1).add_((1 - self.b1) * g32)
                vv.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
                p.copy_(p.to(f32) - self.lr * (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps))
            return (m, v, t)
        raise ValueError(self.kind)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and running statistics live in it), the
    optimizer state and the step count.  ``params`` lists the parameters
    the optimizer state covers, in its order (None: all of the model's);
    a checkpoint finds each parameter's slots through it."""

    model: CellModel
    opt_state: Any
    step: int = 0
    params: Optional[List[torch.Tensor]] = None

    @staticmethod
    def create(model: CellModel, optimizer: Optimizer) -> "TrainState":
        params = list(model.parameters())
        return TrainState(model, optimizer.init(params), 0, params)


def merge_stat_updates(updates: Optional[Dict[BatchNorm, Tuple]]) -> None:
    """Write running-statistics updates into the BatchNorm buffers — after
    the optimizer update, as ``merge_stat_updates`` (``train.py:159-167``)."""
    if not updates:
        return
    with torch.no_grad():
        for bn, (mean, var) in updates.items():
            bn.mean.copy_(mean)
            bn.var.copy_(var)


def make_loss_fn(model: CellModel, ctx: ApplyCtx, remat=False):
    """``loss_fn(x, labels) -> (loss, (logits, stat_updates))``;
    stat_updates is the call's BatchNorm sink: {layer: (mean, var)}."""

    def loss_fn(x, labels):
        c = dataclasses.replace(ctx, bn_sink={})
        logits = model(x, c, remat=remat)
        if isinstance(logits, tuple):
            logits = logits[0]
        return cross_entropy(logits, labels), (logits, c.bn_sink)

    return loss_fn


def _accumulating_step(optimizer: Optimizer, params, grads_for, parts: int,
                       reduce=None):
    """``step(state, x, labels)``: gradients of ``grads_for(x, labels) ->
    (loss, logits, labels used, stat_updates, grads)``, averaged over
    ``parts`` micro-batches with the running-statistics updates
    (``train.py:257-286``); ``reduce(grads, stats, metrics)`` reduces all
    three across ranks in place; then the optimizer update and the running
    statistics."""

    def step(state: TrainState, x, labels):
        loss = acc = 0.0
        grads, stats = None, None
        for xx, yy in zip(x.chunk(parts), labels.chunk(parts)):
            l, logits, used, st, g = grads_for(xx, yy)
            loss, acc = loss + l, acc + accuracy(logits, used)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            stats = st if stats is None else {
                k: (stats[k][0] + m, stats[k][1] + v) for k, (m, v) in st.items()
            }
        if parts > 1:
            grads = [g / parts for g in grads]
            stats = {k: (m / parts, v / parts) for k, (m, v) in stats.items()}
            loss, acc = loss / parts, acc / parts
        metrics = {"loss": loss, "accuracy": acc}
        if reduce is not None:
            reduce(grads, stats, metrics)
        state.opt_state = optimizer.update(params, grads, state.opt_state)
        merge_stat_updates(stats)
        state.step += 1
        return state, metrics

    return step


def data_shard(t: torch.Tensor, data) -> torch.Tensor:
    """This replica's contiguous slice of the global batch (the batch
    sharded over ``data``); the whole batch without a data axis."""
    return t if data is None else t.chunk(data.size)[data.index]


def _reducer(group, grad_scales, scale: float):
    """``reduce(grads, stats, metrics)`` for :func:`_accumulating_step`:
    one all-reduce over ``group`` of everything, gradient ``i`` scaled by
    ``grad_scales[i]`` and the statistics and metrics by ``scale``."""

    def reduce(grads, stats, metrics):
        for k in metrics:
            metrics[k] = torch.as_tensor(metrics[k], dtype=torch.float32,
                                         device=grads[0].device).clone()
        rest = [t for mv in stats.values() for t in mv] + list(metrics.values())
        all_reduce_scaled_(list(grads) + rest, list(grad_scales) + [scale] * len(rest),
                           group)

    return reduce


def make_train_step(model: CellModel, optimizer: Optimizer, parts: int = 1,
                    compute_dtype=torch.float32, remat=False,
                    pallas_conv: bool = False, with_data_axis=None):
    """Single-device or DP training step.

    ``parts > 1`` accumulates gradients over micro-batches and averages the
    per-micro-batch running-statistics updates (``train.py:257-286``).
    ``remat`` True/"cell" checkpoints each cell, "sqrt" runs ~√n groups of
    per-cell checkpoints under an outer one, "fine" adds a checkpoint per
    op inside composite cells (``train.py:205-245``; ``MPI4DL_REMAT_OPS=1``
    adds those to any level).  ``pallas_conv`` routes
    eligible convs and [ReLU, Conv2d, BatchNorm] windows through the
    hand-written K1/K2 kernels (``ops/halo_conv.py``).
    ``with_data_axis`` (a :class:`~mpi4dl_tpu_torch.mesh.DataAxis`): DP —
    the step takes the global batch, trains on this replica's slice of it
    with BatchNorm statistics of that slice, and averages the gradients,
    the running statistics and the metrics over the replicas in one
    all-reduce (``train.py:303-315``).
    """
    ctx = ApplyCtx(
        train=True,
        spatial=SpatialCtx(use_pallas_conv=True) if pallas_conv else None,
        remat_ops=remat == "fine" or os.environ.get("MPI4DL_REMAT_OPS") == "1",
    )
    loss_fn = make_loss_fn(model, ctx, remat="sqrt" if remat == "sqrt" else bool(remat))
    params = [p for p in model.parameters() if p.requires_grad]
    data = with_data_axis

    def grads_for(x, labels):
        loss, (logits, stats) = loss_fn(x.to(compute_dtype), labels)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), logits.detach(), labels, stats, list(grads)

    step = _accumulating_step(
        optimizer, params, grads_for, parts,
        None if data is None else _reducer(data.group, [1.0 / data.size] * len(params),
                                           1.0 / data.size))
    if data is None:
        return step
    return lambda state, x, labels: step(state, data_shard(x, data),
                                         data_shard(labels, data))


def _spatial_until(model: CellModel, spatial_until: Optional[int],
                   levels=None) -> int:
    if levels:
        if spatial_until is not None and spatial_until != levels[-1][0]:
            raise ValueError(f"spatial_until {spatial_until} but the last level "
                             f"ends at cell {levels[-1][0]}")
        spatial_until = levels[-1][0]
    su = spatial_until or model.spatial_until or (len(model.cells) - 1)
    if not 1 <= su < len(model.cells):
        raise ValueError(f"spatial_until {su} outside [1, {len(model.cells) - 1}]")
    return su


def _shard_labels(labels, sp: SpatialCtx, junction: str, local_dp):
    """The labels of this device's batch shard under ``batch_split``
    (``train.py:390-394``); all of them otherwise and on the one-process
    grid."""
    if junction != "batch_split":
        return labels
    degree = junction_degree(sp, local_dp)
    k = junction_shard_index(sp, degree)
    return labels if k is None else labels.chunk(degree)[k]


def _sp_group(sp: SpatialCtx, data):
    """The ranks an SP step reduces over: data x tiles, the tiles, the data
    replicas (one-process grid) or none."""
    if not sp.tiles.folded:
        return data.with_tiles if data is not None else sp.tiles.group
    return data.group if data is not None else None


def make_spatial_train_step(model: CellModel, optimizer: Optimizer,
                            sp: SpatialCtx, parts: int = 1,
                            compute_dtype=torch.float32,
                            spatial_until: Optional[int] = None,
                            junction: str = "gather", remat=False,
                            local_dp: Optional[int] = None,
                            with_data_axis=None, levels=None):
    """Spatial-parallel (SP [+DP]) training step (``train.py:335-488``):
    ``step(state, x, labels)`` takes the global batch of images,
    keeps this replica's slice under ``with_data_axis``, cuts this
    process's tiles from it (``sp.tiles.scatter``), runs cells [0,
    spatial_until) on the tiles, crosses the junction (``gather``, or
    ``batch_split`` of degree ``local_dp``, default the tile count), runs
    the tail, and updates the parameters.  ``levels`` (a list of
    ``(stop_cell, SpatialCtx)``, ``sp`` its level 0) runs multi-level SP:
    the region level by level, ``spatial_until`` the last level's stop.

    Gradients, as the JAX step's pmean of every gradient over (data, sph,
    spw) (:397-402, :460):

    - ``gather``: the tail runs on the same full activation on every tile's
      rank, so its loss and gradients are complete on each, and the
      gather's backward hands each rank its own tile's cotangent (JAX
      differentiates ``pmean(loss)``, whose 1/P the all_gather's summing
      adjoint undoes).  The region's gradients hold one tile's share each
      and are summed over the tile ranks; the tail's are averaged over
      them, which forces the replicas to agree whatever the card's
      rounding.  On a replicated level the gather (and every transition)
      hands a tile's cotangent to one copy, the others seeing only their
      share through the cross-tile statistics, so the sum counts each
      tile once; a degenerate level's cells are reduced as the tail's.
    - ``batch_split``: each tile device's loss is that of its shard; the
      junction's backward is the exact adjoint (the reverse all_to_all), so
      the sum over the tile ranks of every gradient is the gradient of the
      sum of the shard losses, and the step divides it by the tile count:
      the gradient of the mean loss (a replication group's ranks compute
      one shard, each counted once per rank, as JAX's pmean does).
    - ``with_data_axis``: both are then averaged over the data replicas.

    The running statistics and the metrics are averaged over the same
    ranks, all in one all-reduce.  On the one-process grid the tiles need
    no reduction.  ``sp.use_pallas_conv`` routes the region's stride-1
    convs and K2 windows through the kernels."""
    if sp is None or not sp.active or sp.tiles is None:
        raise ValueError("make_spatial_train_step needs an active SpatialCtx with tiles")
    if levels is not None and levels[0][1] is not sp:
        raise ValueError("sp must be the levels' level 0")
    sp_last = levels[-1][1] if levels else sp
    if junction == "batch_split":
        junction_degree(sp_last, local_dp)
    su = _spatial_until(model, spatial_until, levels)
    ctx = ApplyCtx(train=True, spatial=sp)
    params = [p for p in model.parameters() if p.requires_grad]
    data = with_data_axis

    def grads_for(x, labels):
        c = dataclasses.replace(ctx, bn_sink={})
        logits = apply_spatial_model(model, sp.tiles.scatter(x.to(compute_dtype)), c,
                                     su, junction, remat=remat, local_dp=local_dp,
                                     levels=levels)
        if isinstance(logits, tuple):
            logits = logits[0]
        labels = _shard_labels(labels, sp_last, junction, local_dp)
        loss = cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), logits.detach(), labels, c.bn_sink, list(grads)

    group = _sp_group(sp, data)
    reduce = None
    if group is not None:
        d = data.size if data is not None else 1
        t = 1 if sp.tiles.folded else sp.tiles.tiles
        region_ids = {id(p) for cell in active_region_cells(model, su, levels)
                      for p in cell.parameters()}
        region_scale = 1.0 / (d * (t if junction == "batch_split" else 1))
        scales = [region_scale if id(p) in region_ids else 1.0 / (d * t) for p in params]
        reduce = _reducer(group, scales, 1.0 / (d * t))
    step = _accumulating_step(optimizer, params, grads_for, parts, reduce)
    if data is None:
        return step
    return lambda state, x, labels: step(state, data_shard(x, data),
                                         data_shard(labels, data))


def make_spatial_eval_step(model: CellModel, sp: SpatialCtx,
                           compute_dtype=torch.float32,
                           spatial_until: Optional[int] = None,
                           junction: str = "gather",
                           local_dp: Optional[int] = None,
                           with_data_axis=None, levels=None):
    """Spatial-parallel inference step ``(x, labels) -> metrics`` (the
    global batch in; BatchNorm uses the running statistics); loss and
    accuracy are averaged over the step's ranks.  ``logits`` are this
    device's (its shard's under ``batch_split`` with one tile a rank).
    ``levels`` as in :func:`make_spatial_train_step`."""
    su = _spatial_until(model, spatial_until, levels)
    sp_last = levels[-1][1] if levels else sp
    ctx = ApplyCtx(train=False, spatial=sp)
    data = with_data_axis
    group = _sp_group(sp, data)

    @torch.no_grad()
    def estep(x, labels):
        x, labels = data_shard(x, data), data_shard(labels, data)
        logits = apply_spatial_model(model, sp.tiles.scatter(x.to(compute_dtype)),
                                     ctx, su, junction, local_dp=local_dp, levels=levels)
        if isinstance(logits, tuple):
            logits = logits[0]
        labels = _shard_labels(labels, sp_last, junction, local_dp)
        metrics = {"loss": cross_entropy(logits, labels),
                   "accuracy": accuracy(logits, labels)}
        _mean_metrics(metrics, group)
        metrics["logits"] = logits
        return metrics

    return estep


def _mean_metrics(metrics: dict, group) -> None:
    if group is not None:
        vals = list(metrics.values())
        all_reduce_scaled_(vals, [1.0 / dist.get_world_size(group)] * len(vals), group)


def make_eval_step(model: CellModel, compute_dtype=torch.float32,
                   with_data_axis=None):
    """Inference step ``(x, labels) -> metrics`` (BN uses running stats);
    with a data axis, on this replica's slice of the batch, loss and
    accuracy averaged over the replicas."""
    ctx = ApplyCtx(train=False)
    data = with_data_axis

    @torch.no_grad()
    def estep(x, labels):
        x, labels = data_shard(x, data), data_shard(labels, data)
        logits = model(x.to(compute_dtype), ctx)
        if isinstance(logits, tuple):
            logits = logits[0]
        metrics = {"loss": cross_entropy(logits, labels),
                   "accuracy": accuracy(logits, labels)}
        _mean_metrics(metrics, None if data is None else data.group)
        metrics["logits"] = logits
        return metrics

    return estep
