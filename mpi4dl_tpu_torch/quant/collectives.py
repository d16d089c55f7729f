"""Quantized collectives over ``torch.distributed`` (counterpart of
``mpi4dl_tpu/quant/collectives.py``).

Each wrapper keeps the semantics of the raw collective it replaces while
the wire carries a per-block payload and a small f32 scale tensor
(``quant/kernels.py``).  Payloads cross as ``uint8`` views (NCCL and gloo
take neither float8 nor packed int4), scales as f32; a value is encoded
once per wire crossing and decoded on arrival, the sender's own share
included, as the JAX gather of the quantized payload does.

- :func:`quantized_all_gather` — a tiled all_gather; the backward is the
  raw gather's exact adjoint (the reduce-scatter of the cotangent, JAX's
  ``psum_scatter``).  Rank-1 and last-dim gathers stay exact.
- :func:`quantized_all_to_all` — both directions quantized (a
  permutation: one encode a crossing, nothing accumulates).
- :func:`quantized_shift` — ``lax.ppermute``: both directions quantized, a
  rank that no pair sends to receives zeros.
- :func:`quantized_pmean` / :func:`quantized_pmean_tree` — the EQuARX
  two-shot all-reduce, one mesh axis at a time (a mean of means): pad to
  ``n·block``, quantize once, all_to_all, dequantize and sum exactly in
  f32 per shard, divide by ``n``, re-quantize, all_gather, dequantize.
  It runs outside autograd (the engines reduce finished gradients).

A mesh axis is a line of ranks inside a process group: the group's ranks
laid out row-major over ``shape`` (``mesh.py``'s order), the line of this
rank along axis ``a`` the ranks that differ from it only there.  The line
collectives are point-to-point batches inside that group, so no axis
needs a group of its own.

The engines run these: the SP x PP stage lineup is
:func:`quantized_all_gather`, the ``batch_split`` junction's all_to_all
:func:`quantized_all_to_all`; the tile junction's gather and each hop of
``respatial``'s coarsening ring, forward and back, are
:func:`all_gather_parts` and :func:`send_recv`, the collectives under
:func:`quantized_all_gather` and :func:`quantized_shift`.  The stage
handoffs (``parallel/stages.py``) and the gather path of ``respatial``
post several tensors in one batch and call :func:`encode`,
:func:`decode` and :func:`tally` themselves.  A collective that runs
exact (``mode`` None) is the raw one; with ``cls`` None it is not
counted.

:data:`WIRE_BYTES` counts, per class, the payload + scale bytes the ranks
this process plays sent through the class's collectives (the exact ones
included: an exact case moves its raw bytes), and :data:`RAW_BYTES` the
bytes the raw collectives would have sent, in the idiom of the kernels'
``LAUNCHES`` counters.  A one-process tile grid or stage chain counts what
its ranks would send.  An all-reduce counts ``2 (n - 1) / n`` of its
buffer a rank (reduce-scatter + all-gather).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mpi4dl_tpu_torch.quant import kernels
from mpi4dl_tpu_torch.quant.kernels import (
    dequantize, nblocks, payload_dim, quantize,
)
from mpi4dl_tpu_torch.quant.policy import CLASSES

WIRE_BYTES = {c: 0 for c in CLASSES}
RAW_BYTES = {c: 0 for c in CLASSES}


def reset_wire_bytes() -> None:
    for c in CLASSES:
        WIRE_BYTES[c] = RAW_BYTES[c] = 0


def tally(cls: Optional[str], wire: float, raw: float) -> None:
    """Count a crossing under ``cls`` (None: an uncounted, exact one)."""
    if cls is None:
        return
    if cls not in CLASSES:
        raise ValueError(f"unknown quant class {cls!r}; have {CLASSES}")
    WIRE_BYTES[cls] += int(round(wire))
    RAW_BYTES[cls] += int(round(raw))


def raw_nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def encoded_nbytes(shape, mode: str, block: int) -> int:
    """Payload + scale bytes of one encode of a tensor of ``shape``."""
    lead, c = math.prod(shape[:-1]), shape[-1]
    return lead * (payload_dim(c, mode) + 4 * nblocks(c, block))


def wire_nbytes(shape, dtype: torch.dtype, mode: Optional[str], block: int) -> int:
    """Bytes one crossing of a tensor moves: encoded, or raw when exact."""
    return encoded_nbytes(shape, mode, block) if mode else raw_nbytes(shape, dtype)


def tally_all_reduce(cls: str, nbytes: int, n: int) -> None:
    """An exact all-reduce of ``nbytes`` over ``n`` ranks, one rank's share."""
    if n > 1:
        b = 2 * (n - 1) / n * nbytes
        tally(cls, b, b)


def encode(x: torch.Tensor, mode: str, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(payload as uint8, f32 scales)`` of ``x``: what crosses the wire."""
    q, s = quantize(x, mode, block)
    return q.view(torch.uint8), s


def decode(payload: torch.Tensor, scales: torch.Tensor, mode: str, block: int,
           out_dim: int, dtype: torch.dtype) -> torch.Tensor:
    q = payload.view(torch.float8_e4m3fn if mode == "fp8" else torch.int8)
    return dequantize(q, scales, mode, block, out_dim, dtype)


class RoundTrip(torch.autograd.Function):
    """What a rank receives through a quantized wire, without the wire (the
    one-process tile grid and stage chain): ``x`` encoded and decoded where
    ``mask`` is true (broadcast over ``x``; None: everywhere; ``mode``
    None: nowhere).  The backward does the same to the cotangent when
    ``bwd``, else passes it exact; ``bwd_tally`` (``(cls, wire, raw)``) is
    counted when the backward runs."""

    @staticmethod
    def forward(ctx, x, mode, block, mask, bwd, bwd_tally):
        ctx.mode, ctx.block, ctx.mask, ctx.bwd = mode, block, mask, bwd
        ctx.bwd_tally = bwd_tally
        return _roundtrip(x, mode, block, mask)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_tally is not None:
            tally(*ctx.bwd_tally)
        if ctx.bwd:
            g = _roundtrip(g, ctx.mode, ctx.block, ctx.mask)
        return g, None, None, None, None, None


def _roundtrip(x, mode, block, mask):
    if not mode:
        return x.view_as(x)
    y = kernels.roundtrip(x, mode, block)
    return y if mask is None else torch.where(mask, y, x)


def roundtrip(x, mode: Optional[str], block: int, mask=None, bwd: bool = False,
              bwd_tally=None):
    if not mode and bwd_tally is None:
        return x
    return RoundTrip.apply(x, mode, block, mask, bwd, bwd_tally)


# ---------------------------------------------------------------------------
# Group collectives (no autograd: the backends call them inside their own
# autograd Functions).
# ---------------------------------------------------------------------------


def all_gather_parts(x: torch.Tensor, group, mode: Optional[str], block: int,
                     cls: str) -> List[torch.Tensor]:
    """Every rank's ``x``, in group-rank order, through the wire of ``mode``
    (exact when None); this rank's own part is decoded from its own
    encode too."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    tally(cls, (n - 1) * wire_nbytes(x.shape, x.dtype, mode, block),
          (n - 1) * raw_nbytes(x.shape, x.dtype))
    if not mode:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return parts
    q, s = encode(x, mode, block)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, s, group=group)
    return [decode(a, b, mode, block, x.shape[-1], x.dtype) for a, b in zip(qs, ss)]


def all_to_all_rows(x: torch.Tensor, group, mode: Optional[str], block: int,
                    cls: str) -> torch.Tensor:
    """``all_to_all_single`` of ``x``'s dim 0 (``n`` equal chunks, chunk
    ``j`` to rank ``j``; chunk ``j`` of the result came from rank ``j``)
    through the wire of ``mode``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    tally(cls, (n - 1) / n * wire_nbytes(x.shape, x.dtype, mode, block),
          (n - 1) / n * raw_nbytes(x.shape, x.dtype))
    if not mode:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    q, s = encode(x, mode, block)
    rq, rs = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(rq, q, group=group)
    dist.all_to_all_single(rs, s, group=group)
    return decode(rq, rs, mode, block, x.shape[-1], x.dtype)


def _wait(ops) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def send_recv(x: Optional[torch.Tensor], to: Optional[int], frm: Optional[int],
              like: torch.Tensor, group, mode: Optional[str], block: int,
              cls: str) -> torch.Tensor:
    """Send ``x`` to global rank ``to`` and return what global rank ``frm``
    sent (a tensor shaped and typed as ``like``; zeros when ``frm`` is
    None), through the wire of ``mode``; posted together on ``group``."""
    ops = []
    if to is not None:
        x = x.contiguous()
        tally(cls, wire_nbytes(x.shape, x.dtype, mode, block), raw_nbytes(x.shape, x.dtype))
    if not mode:
        recv = torch.zeros_like(like)
        if to is not None:
            ops.append(dist.P2POp(dist.isend, x, to, group))
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, recv, frm, group))
        _wait(ops)
        return recv
    c = like.shape[-1]
    if to is not None:
        q, s = encode(x, mode, block)
        ops += [dist.P2POp(dist.isend, q, to, group, 0),
                dist.P2POp(dist.isend, s, to, group, 1)]
    if frm is None:
        _wait(ops)
        return torch.zeros_like(like)
    lead = like.shape[:-1]
    rq = torch.empty((*lead, payload_dim(c, mode)), dtype=torch.uint8, device=like.device)
    rs = torch.empty((*lead, nblocks(c, block)), dtype=torch.float32, device=like.device)
    ops += [dist.P2POp(dist.irecv, rq, frm, group, 0),
            dist.P2POp(dist.irecv, rs, frm, group, 1)]
    _wait(ops)
    return decode(rq, rs, mode, block, c, like.dtype)


# ---------------------------------------------------------------------------
# The JAX wrappers' counterparts (autograd where JAX has a custom_vjp).
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, mode, block, cls):
        ctx.group, ctx.dim, ctx.cls = group, dim, cls
        return torch.cat(all_gather_parts(x, group, mode, block, cls), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g = g.movedim(ctx.dim, 0).contiguous()
        b = (n - 1) / n * raw_nbytes(g.shape, g.dtype)
        tally(ctx.cls, b, b)
        out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None, None, None


def quantized_all_gather(t: torch.Tensor, group, dim: int, mode: Optional[str],
                         block: int, cls: str = "junction") -> torch.Tensor:
    """Tiled all_gather of ``t`` over ``group`` along ``dim`` with a
    quantized payload; the backward is the raw gather's adjoint, the exact
    reduce-scatter of the cotangent.  A rank-1 tensor or a last-dim gather
    (the block axis must survive) goes through the exact wire."""
    dim = dim % t.dim()
    if t.dim() < 2 or dim == t.dim() - 1:
        mode = None
    return _AllGather.apply(t, group, dim, mode, block, cls)


def _a2a(x, group, split_axis, concat_axis, mode, block, cls):
    n = dist.get_world_size(group)
    moved = x.movedim(split_axis, 0)
    out = all_to_all_rows(moved, group, mode, block, cls)
    return torch.cat([p.movedim(0, split_axis) for p in out.chunk(n, 0)], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, mode, block, cls):
        ctx.args = (group, concat_axis, split_axis, mode, block, cls)
        return _a2a(x, group, split_axis, concat_axis, mode, block, cls)

    @staticmethod
    def backward(ctx, g):
        return (_a2a(g, *ctx.args),) + (None,) * 6


def quantized_all_to_all(t: torch.Tensor, group, split_axis: int, concat_axis: int,
                         mode: Optional[str], block: int,
                         cls: str = "junction") -> torch.Tensor:
    """Tiled all_to_all (``split_axis`` cut into one chunk a rank, the
    received chunks concatenated along ``concat_axis`` in rank order) with a
    quantized payload both ways; exact when either axis is the last."""
    nd = t.dim()
    split_axis, concat_axis = split_axis % nd, concat_axis % nd
    if nd < 2 or split_axis == nd - 1 or concat_axis == nd - 1:
        mode = None
    return _AllToAll.apply(t, group, split_axis, concat_axis, mode, block, cls)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm, mode, block, cls):
        ctx.args = (group, tuple((d, s) for s, d in perm), mode, block, cls)
        return _permute(x, group, perm, mode, block, cls)

    @staticmethod
    def backward(ctx, g):
        return (_permute(g, *ctx.args),) + (None,) * 5


def _permute(x, group, perm, mode, block, cls):
    me = dist.get_rank(group)
    to = [d for s, d in perm if s == me]
    frm = [s for s, d in perm if d == me]
    if len(to) > 1 or len(frm) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at rank {me}")
    g = lambda r: dist.get_global_rank(group, r)
    return send_recv(x if to else None, g(to[0]) if to else None,
                     g(frm[0]) if frm else None, x, group, mode, block, cls)


def quantized_shift(t: torch.Tensor, group, perm: Sequence[Tuple[int, int]],
                    mode: Optional[str], block: int, cls: str = "handoff") -> torch.Tensor:
    """``lax.ppermute`` over ``group`` (``perm``: ``(source, destination)``
    group-rank pairs) with a quantized payload; the backward sends the
    quantized cotangent back along the reversed pairs.  A rank no pair
    sends to receives zeros."""
    return _Shift.apply(t, group, tuple(perm), mode, block, cls)


# ---------------------------------------------------------------------------
# The EQuARX pmean.
# ---------------------------------------------------------------------------


def axis_line(shape: Sequence[int], rank: int, axis: int) -> Tuple[List[int], int]:
    """The group ranks along ``axis`` through ``rank`` of a group laid out
    row-major over ``shape``, and this rank's index on that line."""
    coords, r = [], rank
    for n in reversed(shape):
        coords.append(r % n)
        r //= n
    coords = coords[::-1]
    stride = math.prod(shape[axis + 1:])
    base = rank - coords[axis] * stride
    return [base + i * stride for i in range(shape[axis])], coords[axis]


def _line_exchange(group, line, me, sends, recvs) -> None:
    """Send ``sends[i]`` (a list of tensors) to line position ``i`` and
    receive ``recvs[i]`` from it, for every position but ``me``, in one
    batch (tag = the tensor's index in its list)."""
    ops = []
    for i, r in enumerate(line):
        if i == me:
            continue
        peer = dist.get_global_rank(group, r)
        ops += [dist.P2POp(dist.isend, t, peer, group, k) for k, t in enumerate(sends[i])]
        ops += [dist.P2POp(dist.irecv, t, peer, group, k) for k, t in enumerate(recvs[i])]
    _wait(ops)


def _qpmean_line(v, group, line, me, mode, block, cls):
    n = len(line)
    size = v.numel()
    padded = n * block * (-(-size // (n * block)))
    if padded != size:
        v = F.pad(v, (0, padded - size))
    q, s = encode(v, mode, block)  # 1-D: blocks along the vector
    qc, sc = q.chunk(n), s.chunk(n)
    rq = [torch.empty_like(qc[me]) for _ in range(n)]
    rs = [torch.empty_like(sc[me]) for _ in range(n)]
    rq[me], rs[me] = qc[me], sc[me]
    _line_exchange(group, line, me, [[a, b] for a, b in zip(qc, sc)],
                   [[a, b] for a, b in zip(rq, rs)])
    shard_dim = padded // n
    rows = torch.stack([decode(a, b, mode, block, shard_dim, torch.float32)
                        for a, b in zip(rq, rs)])
    shard = rows.sum(dim=0) / n  # exact f32 accumulation per shard
    q2, s2 = encode(shard, mode, block)
    gq = [torch.empty_like(q2) for _ in range(n)]
    gs = [torch.empty_like(s2) for _ in range(n)]
    gq[me], gs[me] = q2, s2
    _line_exchange(group, line, me, [[q2, s2]] * n, [[a, b] for a, b in zip(gq, gs)])
    chunk = qc[me].numel() + 4 * sc[me].numel()
    tally(cls, 2 * (n - 1) * chunk, 0)
    out = decode(torch.cat(gq), torch.cat(gs), mode, block, padded, torch.float32)
    return out[:size] if padded != size else out


def quantized_pmean(x: torch.Tensor, group, shape: Sequence[int], axes: Sequence[int],
                    mode: str, block: int, cls: str = "grad") -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` along the mesh axes
    ``axes`` of ``shape`` (the group's ranks row-major over ``shape``), one
    axis at a time in the order given, each through the EQuARX two-shot;
    returns a new tensor of ``x``'s shape and dtype.  Without autograd."""
    if math.prod(shape) != dist.get_world_size(group):
        raise ValueError(f"mesh {tuple(shape)} does not lay out a group of "
                         f"{dist.get_world_size(group)} ranks")
    rank = dist.get_rank(group)
    v = x.detach().to(torch.float32).reshape(-1)
    n_all = math.prod(shape[a] for a in axes)
    if n_all > 1:
        b = 2 * (n_all - 1) / n_all * raw_nbytes(v.shape, torch.float32)
        tally(cls, 0, b)
    for a in axes:
        if shape[a] > 1:
            line, me = axis_line(shape, rank, a)
            v = _qpmean_line(v, group, line, me, mode, block, cls)
    return v.reshape(x.shape).to(x.dtype)


def quantized_pmean_tree(tensors: Sequence[torch.Tensor], group, shape, axes, mode: str,
                         block: int, cls: str = "grad") -> List[torch.Tensor]:
    """:func:`quantized_pmean` of a list of tensors as ONE flat f32 vector
    (one collective pair an axis, not one a tensor)."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().to(torch.float32).reshape(-1) for t in tensors])
    flat = quantized_pmean(flat, group, shape, axes, mode, block, cls)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def quantized_reduce_scaled_(tensors: Sequence[torch.Tensor], scales: Sequence[float],
                             group, shape, axes, mode: str, block: int,
                             cls: str = "grad") -> None:
    """``t ← scale · Σ_group t`` in place, as ``distributed.all_reduce_scaled_``
    computes it, through :func:`quantized_pmean_tree` over ``axes``: each
    tensor is multiplied by ``scale · |group|`` and its mean taken over the
    axes (the engines' tensors agree along the axes they leave out)."""
    n = math.prod(shape)
    scaled = [t.detach().to(torch.float32) * (s * n) for t, s in zip(tensors, scales)]
    with torch.no_grad():
        for t, r in zip(tensors, quantized_pmean_tree(scaled, group, shape, axes, mode,
                                                       block, cls)):
            t.copy_(r)
