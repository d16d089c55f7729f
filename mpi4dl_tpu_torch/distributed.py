"""The collectives of the long-context path on ``torch.distributed`` — the
part of ``mpi4dl_tpu/mesh.py`` and ``ops/halo.py`` that the ring needs.

A ``group`` is a process group (``torch.distributed.group.WORLD`` or one
made by ``new_group``); ``None`` means one device and no communication.
The JAX package's ``lax.ppermute`` ring becomes :func:`ring_hop`, a
differentiable send to the next rank whose backward sends the gradients
back, as the transpose of ``ppermute`` does; ``psum`` of the gradients
becomes :func:`all_reduce_sum_`.  The spatial engine's tile communication
is ``parallel/tiles.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def rank_and_size(group) -> Tuple[int, int]:
    """``(rank, world size)`` in ``group``; ``(0, 1)`` for ``None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on and return what the rank
    ``step`` places back sent.  Send and receive are posted together
    before either is waited on, so no order of calls between ranks can
    deadlock the ring."""
    rank, size = rank_and_size(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    to = dist.get_global_rank(group, (rank + step) % size)
    frm = dist.get_global_rank(group, (rank - step) % size)
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to, group),
        dist.P2POp(dist.irecv, recv, frm, group),
    ]):
        req.wait()
    return recv


class _RingHop(torch.autograd.Function):
    """(k, v) from rank i to rank i+1 in one message; the backward moves
    the gradients from i+1 back to i."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        kv = _shift(torch.stack((k, v)), group, 1)
        return kv[0], kv[1]

    @staticmethod
    def backward(ctx, dk, dv):
        dkv = _shift(torch.stack((dk, dv)), ctx.group, -1)
        return None, dkv[0], dkv[1]


def ring_hop(k: torch.Tensor, v: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of the ring: every rank sends ``(k, v)`` (same shape and
    type) to the next rank and returns the pair the previous rank sent."""
    return _RingHop.apply(group, k, v)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return (dx, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.deps))


def tie(x: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """``x``, with ``deps`` made inputs of its autograd node (zero
    gradient).  A rank whose result does not depend on the last hops of a
    ring still runs their backward, so every rank takes part in every
    hop's exchange in the same order."""
    return _Tie.apply(x, *deps)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group: Optional[object]) -> None:
    """Sum each tensor over ``group`` in place, in one collective over one
    flat buffer (the tensors share a dtype and device).  No-op for
    ``None``."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_scaled_(tensors: Sequence[torch.Tensor], scales: Sequence[float],
                       group: Optional[object]) -> None:
    """``t ← scale · Σ_group t`` for each tensor, in place, in one fp32
    all-reduce over one flat buffer whatever the tensors' dtypes (float64
    when one of them is float64; no collective for ``None``, only the
    scales)."""
    if not tensors:
        return
    if group is None:
        with torch.no_grad():
            for t, s in zip(tensors, scales):
                if s != 1.0:
                    t.mul_(s)
        return
    wire = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)
    flat = torch.cat([t.detach().reshape(-1).to(wire) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    with torch.no_grad():
        for t, s in zip(tensors, scales):
            chunk = flat[offset:offset + t.numel()].view(t.shape)
            t.copy_(chunk * s if s != 1.0 else chunk)
            offset += t.numel()
