"""The pipeline engine: LP + GPipe / 1F1B PP, with or without a data axis
(counterpart of ``mpi4dl_tpu/parallel/pipeline.py:68-266``).

The JAX engine runs the whole schedule as one ``lax.scan`` inside one
``shard_map``; here each rank runs the tick loop of
``parallel/stage_common.py`` for the stage it holds
(:class:`~mpi4dl_tpu_torch.parallel.stages.ProcessGroupStages`), or one
process runs every stage (:class:`~mpi4dl_tpu_torch.parallel.stages.StageChain`).

The loss is reduced over the stages outside autograd (the purpose of
JAX's ``metric_psum``: its backward needs no collective): the last stage
seeds its backward with 1/Pn per micro-batch, and no cotangent is
all-reduced.  With a data axis each replica trains on its slice of the
batch, and the gradients and the running statistics are averaged over
the replicas in one all-reduce (``grad_pmean``).

``quant`` (``quant.QuantPolicy``, None: off): the stage and cotangent
handoffs cross the ``handoff`` class's wire (``parallel/stages.py``) and,
under the ``grad`` class, the gradients and then the running statistics
are averaged over the data replicas through the EQuARX mean
(``pipeline.py:93-101, 220-226``); the loss reduction stays exact.
"""

from __future__ import annotations

import torch

from mpi4dl_tpu_torch.distributed import all_reduce_scaled_
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.parallel.partition import StagePartition
from mpi4dl_tpu_torch.parallel.stage_common import gpipe, one_f_one_b
from mpi4dl_tpu_torch.quant import collectives as qc
from mpi4dl_tpu_torch.quant.policy import class_mode
from mpi4dl_tpu_torch.train import (
    Optimizer, TrainState, data_shard, merge_stat_updates,
)


def local_params(part: StagePartition, stages):
    """The parameters of this process's stages, in stage order."""
    return [p for s in stages.local_stages for p in part.stage_params(s)]


def init_pipeline_state(part: StagePartition, optimizer: Optimizer, stages) -> TrainState:
    """The model (its cells are the stages) and an optimizer state over
    this process's stages' parameters only."""
    params = local_params(part, stages)
    return TrainState(part.model, optimizer.init(params), 0, params)


def make_pipeline_train_step(part: StagePartition, optimizer: Optimizer, stages,
                             parts: int, compute_dtype=torch.float32,
                             remat: bool = True, with_data_axis=None,
                             loss_scale: float = 1.0,
                             schedule: str = "gpipe", pallas_conv: bool = False,
                             quant=None):
    """``step(state, x, labels) -> (state, metrics)``: ``x`` is the global
    batch, ``parts * microbatch`` images per data replica.

    ``schedule``: ``"gpipe"`` (all forwards, then all backwards; ``remat``
    keeps only each stage's input) or ``"1f1b"`` (one forward and one
    backward a tick, stage inputs in a ring, forwards recomputed in the
    backward; ``remat`` is moot).  Both give the same parameters up to the
    order in which micro-batch gradients are summed.  ``loss_scale``
    multiplies the seed and divides the gradients (bf16 cotangents).
    ``pallas_conv`` routes the stages' stride-1 convs and [ReLU, Conv2d,
    BatchNorm] windows through the K1/K2 kernels.  ``with_data_axis`` (a
    :class:`~mpi4dl_tpu_torch.mesh.DataAxis`): DP x PP."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}; use 'gpipe' or '1f1b'")
    ctx = stage_ctx(pallas_conv)
    params = local_params(part, stages)
    data = with_data_axis
    seed = loss_scale / parts

    def step(state: TrainState, x, labels):
        x, labels = data_shard(x, data), data_shard(labels, data)
        x_parts = x.to(compute_dtype).chunk(parts)
        y_parts = labels.chunk(parts)
        if schedule == "1f1b":
            with scope("pp_1f1b"):
                res = one_f_one_b(part, stages, ctx, x_parts, y_parts, seed=seed,
                                  quant=quant)
        else:
            with scope("gpipe"):
                res = gpipe(part, stages, ctx, x_parts, y_parts, seed=seed,
                            remat=remat, quant=quant)
        grads = [g for s in stages.local_stages for g in res.grads[s]]
        return finish_step(state, optimizer, params, grads, res.stats, res.loss,
                           res.accuracy, parts, loss_scale, stages, data, quant)

    return step


def stage_ctx(pallas_conv: bool) -> ApplyCtx:
    """The stages' train-mode context; ``pallas_conv`` routes their
    stride-1 convs and [ReLU, Conv2d, BatchNorm] windows through K1/K2."""
    return ApplyCtx(train=True,
                    spatial=SpatialCtx(use_pallas_conv=True) if pallas_conv else None)


def finish_step(state: TrainState, optimizer: Optimizer, params, grads, stats, loss,
                acc, denom: int, loss_scale: float, stages, data, quant=None):
    """The end of a pipeline (or GEMS) step: the running-statistics sums
    and the metrics divided by the ``denom`` micro-batches they were summed
    over; gradients (unscaled) and statistics averaged over the data
    replicas in one all-reduce (under ``quant``'s ``grad`` class: the
    gradients, then the statistics, through the quantized mean); the
    update; the loss, which lives on the last stage, summed over the stages
    (the others hold zero) and averaged over the replicas, outside
    autograd and exact."""
    stats = {bn: (m / denom, v / denom) for bn, (m, v) in stats.items()}
    st = [t for mv in stats.values() for t in mv]
    tensors = grads + st
    inv = 1.0 / data.size if data is not None else 1.0
    grad_mode, block = class_mode(quant, "grad")
    if grad_mode and data is not None:
        wire = (data.group, (data.size,), (0,), grad_mode, block)
        with scope("grad_reduce"):
            qc.quantized_reduce_scaled_(grads, [inv / loss_scale] * len(grads), *wire)
        with scope("stats_reduce"):
            qc.quantized_reduce_scaled_(st, [inv] * len(st), *wire)
    else:
        if data is not None:
            qc.tally_all_reduce("grad", 4 * sum(t.numel() for t in tensors), data.size)
        with scope("grad_reduce"):
            all_reduce_scaled_(tensors, [inv / loss_scale] * len(grads)
                               + [inv] * (len(tensors) - len(grads)),
                               None if data is None else data.group)
    with scope("optimizer_update"):
        state.opt_state = optimizer.update(params, grads, state.opt_state)
    merge_stat_updates(stats)
    state.step += 1
    metric_group = None
    if data is not None:
        metric_group = data.with_stages if stages.group is not None else data.group
    elif stages.group is not None:
        metric_group = stages.group
    metrics = [loss / denom, acc / denom]
    with scope("loss_reduce"):
        all_reduce_scaled_(metrics, [inv, inv], metric_group)
    return state, {"loss": metrics[0], "accuracy": metrics[1]}
