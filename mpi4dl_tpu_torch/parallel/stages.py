"""Stage handoffs of the pipeline engine, on two backends behind one
interface — what the JAX package does with ``lax.ppermute`` over its
``stage`` mesh axis.

A schedule calls :meth:`exchange_streams` once per tick, on every rank,
with one entry per stream: ``(fwd, bwd, want_fwd, want_bwd)``.  ``fwd[s]``
is stage ``s``'s output activation for stage ``s + 1``, ``bwd[s]`` its
input cotangent for stage ``s - 1``; ``want_fwd`` and ``want_bwd`` name
the stages that expect an activation (from ``s - 1``) or a cotangent (from
``s + 1``) this tick, with its shape (``partition.ActShape``) and dtype.
It returns, per stream, what those stages received.  Stream 0 places
stage ``s`` on rank ``s``; stream 1, GEMS's mirror stream B, on rank ``S -
1 - s``.

:class:`ProcessGroupStages` runs one stage per rank of a
``torch.distributed`` group (gloo on the CPU, NCCL across cards): a tick's
handoffs, both streams and both directions, are one ``batch_isend_irecv``,
its operations in one fixed order on every rank (A forward, B forward, A
backward, B backward, each as send then receive), so that a send always
meets its receive and no schedule can deadlock.  A tuple activation
travels as one packed buffer.  :meth:`ProcessGroupStages.swap_mirror`
exchanges a buffer with the mirror rank (GEMS's parameters, and stream
B's gradients on their way home).

:class:`StageChain` holds every stage in one process, where a handoff is a
local reference and a stage's mirror is the stage itself.  It exists so
that one card, which holds one NCCL rank, can run the schedules; the
runners never use it in place of missing ranks.

``exchange_streams(..., mode, block)``: the handoff class of ``--quant``
(``quant/``).  Each handoff, activation or cotangent, crosses as the
per-block payload of its packed flat buffer (``pack``: the JAX flat
``[act_max]`` buffer without its padding) and f32 scales, decoded on
arrival; on :class:`StageChain` the same encode→decode is applied to the
buffer.  Every handoff is counted in ``quant.collectives.WIRE_BYTES``
under ``handoff``.  The mirror exchange moves parameters and is never
quantized.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.parallel.partition import numel, pack, unpack
from mpi4dl_tpu_torch.quant import collectives as qc
from mpi4dl_tpu_torch.quant.kernels import nblocks, payload_dim


def _shape_of(act):
    return tuple(t.shape for t in act) if isinstance(act, tuple) else act.shape


def _tally(n: int, dtype, mode, block) -> None:
    """One handoff of a packed buffer of ``n`` elements."""
    qc.tally("handoff", qc.wire_nbytes((n,), dtype, mode, block), qc.raw_nbytes((n,), dtype))


def _through_wire(act, mode, block):
    """What the receiving stage gets of ``act`` through the handoff wire
    (``act`` itself when exact)."""
    leaves = act if isinstance(act, tuple) else (act,)
    _tally(sum(t.numel() for t in leaves), leaves[0].dtype, mode, block)
    if not mode:
        return act
    buf = pack(act)
    return unpack(qc.decode(*qc.encode(buf, mode, block), mode, block, buf.numel(),
                            buf.dtype), _shape_of(act))


class StageChain:
    """All ``num_stages`` stages in this process."""

    def __init__(self, num_stages: int):
        self.num_stages = int(num_stages)
        self.local_stages = tuple(range(self.num_stages))
        self.group = None

    def exchange_streams(self, streams, mode=None, block=0):
        return [({s: _through_wire(fwd[s - 1], mode, block) for s in want_fwd},
                 {s: _through_wire(bwd[s + 1], mode, block) for s in want_bwd})
                for fwd, bwd, want_fwd, want_bwd in streams]


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

    @property
    def mirror(self) -> int:
        """The stage this rank runs for GEMS's mirror stream."""
        return self.num_stages - 1 - self.stage

    # under stage_handoff / cot_handoff (parallel/stage_common.py).
    def exchange_streams(self, streams, mode=None, block=0):  # analysis: ok(unscoped-collective)
        S = self.num_stages
        ops, recvs = [], []
        for direction in (0, 1):  # forward, then backward
            for i, (fwd, bwd, want_fwd, want_bwd) in enumerate(streams):
                s = self.stage if i == 0 else S - 1 - self.stage
                home = (lambda t: t) if i == 0 else (lambda t: S - 1 - t)
                sends, wants, step = (fwd, want_fwd, 1) if direction == 0 else (bwd, want_bwd, -1)
                # gloo matches by tag, NCCL by order; scales take tag + 8.
                tag = 2 * direction + i
                if s in sends:
                    buf = pack(sends[s])
                    _tally(buf.numel(), buf.dtype, mode, block)
                    wire = [buf] if not mode else qc.encode(buf, mode, block)
                    ops += [dist.P2POp(dist.isend, t, self._peer(home(s + step)),
                                       self.group, tag + 8 * k) for k, t in enumerate(wire)]
                if s in wants:
                    shape, dtype, device = wants[s]
                    n = numel(shape)
                    wire = ([torch.empty(n, dtype=dtype, device=device)] if not mode else
                            [torch.empty(payload_dim(n, mode), dtype=torch.uint8, device=device),
                             torch.empty(nblocks(n, block), dtype=torch.float32,
                                         device=device)])
                    ops += [dist.P2POp(dist.irecv, t, self._peer(home(s - step)),
                                       self.group, tag + 8 * k) for k, t in enumerate(wire)]
                    recvs.append((i, direction, s, wire, shape, dtype))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = [({}, {}) for _ in streams]
        for i, direction, s, wire, shape, dtype in recvs:
            buf = wire[0] if not mode else qc.decode(*wire, mode, block, numel(shape), dtype)
            out[i][direction][s] = unpack(buf, shape)
        return out

    # under gems_mirror / stats_mirror (parallel/gems.py).
    def swap_mirror(self, send: torch.Tensor,  # analysis: ok(unscoped-collective)
                    recv: torch.Tensor) -> None:
        """Send ``send`` to the mirror rank (group rank ``S - 1 - stage``)
        and receive its buffer into ``recv``; the middle rank of an odd
        chain is its own mirror and must not call this."""
        peer = self._peer(self.mirror)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send.contiguous(), peer, self.group, 4),
                dist.P2POp(dist.irecv, recv, peer, self.group, 4)]):
            req.wait()
