"""Stage handoffs of the pipeline engine, on two backends behind one
interface — what the JAX package does with ``lax.ppermute`` over its
``stage`` mesh axis.

A schedule calls :meth:`exchange` once per tick, on every rank, with what
each of its stages hands on: ``fwd[s]`` is stage ``s``'s output activation
for stage ``s + 1``, ``bwd[s]`` its input cotangent for stage ``s - 1``.
``want_fwd`` and ``want_bwd`` name the stages that expect an activation
(from ``s - 1``) or a cotangent (from ``s + 1``) this tick, with its shape
(``partition.ActShape``) and dtype.  It returns what those stages
received.

:class:`ProcessGroupStages` runs one stage per rank of a
``torch.distributed`` group (gloo on the CPU, NCCL across cards): a tick's
handoffs, both directions, are one ``batch_isend_irecv``, its operations
in one fixed order on every rank (forward send, forward receive, backward
send, backward receive), so that a send always meets its receive and
1F1B cannot deadlock.  A tuple activation travels as one packed buffer.

:class:`StageChain` holds every stage in one process, where a handoff is a
local reference.  It exists so that one card, which holds one NCCL rank,
can run the schedules; the runners never use it in place of missing ranks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.parallel.partition import numel, pack, unpack


class StageChain:
    """All ``num_stages`` stages in this process."""

    def __init__(self, num_stages: int):
        self.num_stages = int(num_stages)
        self.local_stages = tuple(range(self.num_stages))
        self.group = None

    def exchange(self, fwd: Dict[int, object], bwd: Dict[int, object],
                 want_fwd: Dict[int, Tuple], want_bwd: Dict[int, Tuple]):
        return ({s: fwd[s - 1] for s in want_fwd},
                {s: bwd[s + 1] for s in want_bwd})


class ProcessGroupStages:
    """One stage per rank of ``group`` (``None``: the default group), rank
    ``s`` of the group holding stage ``s``."""

    def __init__(self, num_stages: int, group=None):
        self.num_stages = int(num_stages)
        self.group = group if group is not None else dist.group.WORLD
        size = dist.get_world_size(self.group)
        if size != self.num_stages:
            raise ValueError(f"{num_stages} stages need {num_stages} ranks, "
                             f"the group has {size}")
        self.stage = dist.get_rank(self.group)
        self.local_stages = (self.stage,)

    def _peer(self, s: int) -> int:
        return dist.get_global_rank(self.group, s)

    def exchange(self, fwd, bwd, want_fwd, want_bwd):
        s = self.stage
        ops, recv_f, recv_b = [], None, None
        if s in fwd:
            ops.append(dist.P2POp(dist.isend, pack(fwd[s]), self._peer(s + 1), self.group))
        if s in want_fwd:
            shape, dtype, device = want_fwd[s]
            recv_f = torch.empty(numel(shape), dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, recv_f, self._peer(s - 1), self.group))
        if s in bwd:
            ops.append(dist.P2POp(dist.isend, pack(bwd[s]), self._peer(s - 1), self.group))
        if s in want_bwd:
            shape, dtype, device = want_bwd[s]
            recv_b = torch.empty(numel(shape), dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, recv_b, self._peer(s + 1), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got_f = {s: unpack(recv_f, want_fwd[s][0])} if recv_f is not None else {}
        got_b = {s: unpack(recv_b, want_bwd[s][0])} if recv_b is not None else {}
        return got_f, got_b
