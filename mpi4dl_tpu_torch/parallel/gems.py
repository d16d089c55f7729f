"""GEMS: bidirectional model parallelism with one weight set (counterpart
of ``mpi4dl_tpu/parallel/gems.py:1-193``).

Each step trains ``times`` pairs of micro-batch groups: stream A flows
through stages 0 → S-1 on ranks 0 → S-1 with the home parameters, stream B
through the same stages on ranks S-1 → 0 (rank ``d`` applies stage
``S-1-d``), both in one tick loop (``stage_common.gems_dual``: GPipe's or
1F1B's ticks), filling each other's pipeline bubbles; one update follows.

The JAX engine gets stream B's parameters from a ``ppermute`` of the
stage-sharded buffer, and AD routes B's gradients home through its
transpose.  Here the mirror is written out (:class:`GemsMirror`): before
the ticks rank ``d`` sends its stage's parameters and running statistics
to rank ``S-1-d``, which holds that stage's mirror copy; after them it
sends stream B's gradients and BatchNorm deposits back, where they are
added to A's and the statistics divided by 2·times·Pn (``gems.py:140-146``).
The middle rank of an odd chain mirrors itself and sends nothing.  On the
one-process :class:`~mpi4dl_tpu_torch.parallel.stages.StageChain` the
mirror is the home stage itself: both streams differentiate the same
tensors into separate sums, added once.

The loss and accuracy are summed over the stage group outside autograd
and divided by 2·times·Pn; each stream's last stage seeds its backward
with 1/(2·times·Pn).  ``--enable-master-comm-opt`` has nothing to do:
with one weight set the replicas cannot diverge.

``quant`` (``quant.QuantPolicy``): the handoffs and the data axis's
reductions as in ``parallel/pipeline.py``; the mirror moves parameters,
gradients and statistics home exactly, never through the quantized wire
(``stage_common.py:38-39``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from mpi4dl_tpu_torch.layers import BatchNorm
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.parallel.partition import StagePartition
from mpi4dl_tpu_torch.parallel.pipeline import finish_step, local_params, stage_ctx
from mpi4dl_tpu_torch.parallel.stage_common import GemsResult, gems_dual, mirror_stages
from mpi4dl_tpu_torch.train import Optimizer, TrainState, data_shard


def stage_state(part: StagePartition, s: int) -> List[torch.Tensor]:
    """Stage ``s``'s parameters and buffers, in module order."""
    r0, r1 = part.ranges[s]
    return [t for cell in part.model.cells[r0:r1]
            for t in cell.state_dict(keep_vars=True).values()]


def stage_bns(part: StagePartition, s: int) -> List[BatchNorm]:
    r0, r1 = part.ranges[s]
    return list(dict.fromkeys(m for cell in part.model.cells[r0:r1]
                              for m in cell.modules() if isinstance(m, BatchNorm)))


def _flat(tensors, dtype) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])


def _wire_dtype(tensors) -> torch.dtype:
    """fp32 carries fp32 and bf16 exactly; float64 stays float64."""
    return torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32


def _split_like(flat: torch.Tensor, like) -> List[torch.Tensor]:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


class GemsMirror:
    """Stream B's copy of the stages: filled from the home ranks before the
    ticks (:meth:`pull`), its gradients and statistics sent home after
    them (:meth:`push`)."""

    def __init__(self, part: StagePartition, stages):
        self.part, self.stages = part, stages
        self.remote = (stages.group is not None
                       and stages.mirror != stages.stage)

    @torch.no_grad()
    def pull(self) -> None:
        if not self.remote:
            return
        home = stage_state(self.part, self.stages.stage)
        mine = stage_state(self.part, self.stages.mirror)
        dtype = _wire_dtype(home + mine)
        recv = torch.empty(sum(t.numel() for t in mine), dtype=dtype, device=home[0].device)
        self.stages.swap_mirror(_flat(home, dtype), recv)
        for t, v in zip(mine, _split_like(recv, mine)):
            t.copy_(v)

    def push(self, res: GemsResult):
        """Stream B's gradients per home stage and its BatchNorm sums keyed
        by the home layers: ``(grads, stats)``."""
        if not self.remote:
            return res.grads_b, res.stats_b
        home, mirror = self.stages.stage, self.stages.mirror
        send = list(res.grads_b[mirror])
        for bn in stage_bns(self.part, mirror):
            send += list(res.stats_b[bn])
        like = list(self.part.stage_params(home))
        bns = stage_bns(self.part, home)
        like += [t for bn in bns for t in res.stats_a[bn]]
        dtype = _wire_dtype(send + like)
        recv = torch.empty(sum(t.numel() for t in like), dtype=dtype, device=send[0].device)
        self.stages.swap_mirror(_flat(send, dtype), recv)
        got = _split_like(recv, like)
        n = len(like) - 2 * len(bns)
        stats = {bn: (got[n + 2 * i], got[n + 2 * i + 1]) for i, bn in enumerate(bns)}
        return {home: got[:n]}, stats


def gems_local_stages(stages):
    """The stages whose weights this process keeps: its own and, for the
    mirror stream, ``S-1-d``'s."""
    return tuple(dict.fromkeys(stages.local_stages + mirror_stages(stages)))


def combine_streams(res: GemsResult, mirror: GemsMirror, local_stages):
    """A's gradients plus B's (sent home), in stage order, and the summed
    BatchNorm deposits of both streams."""
    with scope("stats_mirror"):
        grads_b, stats_b = mirror.push(res)
    grads = [a + b for s in local_stages for a, b in zip(res.grads_a[s], grads_b[s])]
    stats: Dict[object, tuple] = {
        bn: (m + stats_b[bn][0], v + stats_b[bn][1]) for bn, (m, v) in res.stats_a.items()}
    return grads, stats


def make_gems_train_step(part: StagePartition, optimizer: Optimizer, stages,
                         parts: int, times: int = 1, compute_dtype=torch.float32,
                         remat: bool = True, with_data_axis=None,
                         loss_scale: float = 1.0, schedule: str = "gpipe",
                         pallas_conv: bool = False, quant=None):
    """``step(state, x, labels) -> (state, metrics)``: ``x`` is
    ``[2·times·parts·mb, H, W, C]`` per data replica, laid out as
    ``x.reshape(times, 2, parts, mb, ...)`` (``gems.py:109-112``): pair
    ``k``'s stream A, then its stream B.  ``schedule`` ``"gpipe"`` (with
    ``remat`` keeping only each stage's input) or ``"1f1b"``;
    ``pallas_conv`` routes the stages' convs through K1/K2;
    ``with_data_axis``: DP x GEMS, one all-reduce of gradients and
    statistics over the replicas.  On a
    :class:`~mpi4dl_tpu_torch.parallel.stages.ProcessGroupStages` rank the
    model must keep the weights of :func:`gems_local_stages`."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}; use 'gpipe' or '1f1b'")
    ctx = stage_ctx(pallas_conv)
    params = local_params(part, stages)
    denom = 2 * times * parts
    seed = loss_scale / denom
    mirror = GemsMirror(part, stages)
    data = with_data_axis

    def step(state: TrainState, x, labels):
        x, labels = data_shard(x, data), data_shard(labels, data)
        if x.shape[0] % denom:
            raise ValueError(f"batch {x.shape[0]} not divisible by 2*times*parts={denom}")
        mb = x.shape[0] // denom
        xs = x.to(compute_dtype).reshape(times, 2, parts, mb, *x.shape[1:])
        ys = labels.reshape(times, 2, parts, mb)
        with scope("gems_mirror"):
            mirror.pull()
        with scope("gems_1f1b_scan" if schedule == "1f1b" else "gems_dual_scan"):
            res = gems_dual(part, stages, ctx, xs, ys, seed=seed, schedule=schedule,
                            remat=remat, quant=quant)
        grads, stats = combine_streams(res, mirror, stages.local_stages)
        return finish_step(state, optimizer, params, grads, stats, res.loss,
                           res.accuracy, denom, loss_scale, stages, data, quant)

    return step
