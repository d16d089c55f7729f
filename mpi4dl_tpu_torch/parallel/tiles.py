"""Tile communication of the spatial engine, on two backends behind one
interface — the collectives that ``mpi4dl_tpu`` issues inside
``shard_map`` over its ``sph``/``spw`` mesh axes.

The image is cut into a ``grid_h x grid_w`` grid of tiles; tile ``(ih,
iw)`` has index ``ih * grid_w + iw``.  A backend offers:

- :meth:`shift` — every tile receives a tensor from the tile one place
  before (``step=+1``) or after (``step=-1``) it along an axis; tiles at
  the grid's border receive zeros (``lax.ppermute`` over a non-wrapping
  permutation).  Differentiable: the backward is the reverse shift.
- :meth:`sum_stats` and :attr:`count_factor` — batch statistics summed over
  the tiles.
- :meth:`tile_mean` — per-tile values averaged over the tiles
  (``lax.pmean``), for running statistics: this rank's value on
  :class:`ProcessGroupTiles`, a ``[T, ...]`` stack on :class:`TileGrid`.
- :meth:`scatter` / :meth:`gather` — the full image to this process's
  tiles and back (the ``gather`` junction).
- :meth:`batch_split` — the ``batch_split`` junction (``--local-DP``):
  the tiles to this device's batch shard of the full image.
- :meth:`level` — the backend of a coarser level of multi-level SP (a
  ``gh x gw`` grid embedded in this one), and :func:`respatial` — an
  activation moved from one level's tile layout to another's.

:class:`ProcessGroupTiles` holds one tile per rank of a
``torch.distributed`` group (gloo on the CPU, NCCL across cards); shifts
are ``batch_isend_irecv`` pairs, sums are all-reduces.

:class:`TileGrid` holds the whole grid in one process, the tiles FOLDED
INTO THE BATCH dimension (tile-major: row ``t * N + n`` is sample ``n`` of
tile ``t``); shifts are indexing.  Every batch reduction then already
spans the tiles, so its cross-tile sum is the identity and its count
factor 1 — BatchNorm sums, K2's statistics and the loss are not counted
twice (on a replicated level, ``rep`` times in sum and count alike).
Per-tile statistics (``--per-tile-bn``) view such a tensor as
``[T, N, ...]`` (:meth:`TileGrid.per_tile`); after a ``batch_split``
junction the tail views its batch as ``[degree, N / degree, ...]`` shards
in the same way (``ApplyCtx.bn_shards``).  It exists so that one card,
which holds one NCCL rank, can run the engine; the runners never use it
in place of missing ranks.

Multi-level SP (``--num-spatial-parts 4,2``): a coarser level keeps the
ranks of level 0, each of its tiles held by ``rep_h x rep_w`` neighbouring
ranks (``ProcessGroupTiles(..., rep_h, rep_w)``: shifts stride by ``rep``,
sums count every tile ``rep`` times in numerator and denominator, the
gather keeps one copy of each tile — its backward hands the cotangent to
that copy alone).  On :class:`TileGrid` replication belongs to the mesh,
not to the values, so a coarser level holds each of its tiles ONCE (a
``TileGrid`` of the coarser grid) and a level change is a regrouping of
the folded batch; its statistics count each tile ``rep`` times, as the
mesh's do.
"""

from __future__ import annotations

from typing import Tuple

import os

import torch
import torch.distributed as dist

AXIS_SPH = "sph"
AXIS_SPW = "spw"


def _axis_index(axis: str) -> int:
    if axis == AXIS_SPH:
        return 0
    if axis == AXIS_SPW:
        return 1
    raise ValueError(f"unknown tile axis {axis!r}")


def _map_act(fn, x):
    if isinstance(x, tuple):
        return tuple(fn(t) for t in x)
    return fn(x)


class TileGrid:
    """All tiles of a ``grid_h x grid_w`` grid in one process, folded into
    the batch dimension.  ``rep``: the devices a tile spans on the mesh (a
    coarser level of multi-level SP); the cross-tile sums and their count
    take every tile ``rep`` times, as the mesh's do, so that the unbiased
    running variance (``cnt / (cnt - 1)``) comes out as the JAX package's."""

    folded = True

    def __init__(self, grid_h: int, grid_w: int, rep: int = 1):
        self.grid_h, self.grid_w = int(grid_h), int(grid_w)
        self.tiles = self.grid_h * self.grid_w
        self.rep = self.count_factor = int(rep)

    def _grid_view(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.grid_h, self.grid_w, x.shape[0] // self.tiles,
                         *x.shape[1:])

    def shift(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        g = self._grid_view(x)
        d = _axis_index(axis)
        n = g.shape[d]
        zero = torch.zeros_like(g.narrow(d, 0, 1))
        if step == 1:
            g = torch.cat([zero, g.narrow(d, 0, n - 1)], dim=d)
        elif step == -1:
            g = torch.cat([g.narrow(d, 1, n - 1), zero], dim=d)
        else:
            raise ValueError(f"step {step}")
        return g.reshape(x.shape)

    def per_tile(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` viewed as ``[T, N, ...]``."""
        return x.reshape(self.tiles, x.shape[0] // self.tiles, *x.shape[1:])

    def sum_stats(self, *stats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return stats if self.rep == 1 else tuple(s * self.rep for s in stats)

    def tile_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over the leading tile dim of a per-tile value."""
        return t.mean(dim=0)

    def scatter(self, x):
        def s(t):
            n, h, w = t.shape[0], t.shape[1] // self.grid_h, t.shape[2] // self.grid_w
            t = t.reshape(n, self.grid_h, h, self.grid_w, w, *t.shape[3:])
            t = t.permute(1, 3, 0, 2, 4, *range(5, t.dim()))
            return t.reshape(self.tiles * n, h, w, *t.shape[5:])

        return _map_act(s, x)

    def gather(self, x):
        def g(t):
            n = t.shape[0] // self.tiles
            h, w = t.shape[1], t.shape[2]
            t = t.reshape(self.grid_h, self.grid_w, n, h, w, *t.shape[3:])
            t = t.permute(2, 0, 3, 1, 4, *range(5, t.dim()))
            return t.reshape(n, self.grid_h * h, self.grid_w * w, *t.shape[5:])

        return _map_act(g, x)

    def batch_split(self, x, degree: int, shard=None):
        """The ``batch_split`` junction: the whole batch, whose ``degree``
        row blocks are the shards that the tile devices would hold (a
        replication group's identical copies are one shard here)."""
        return self.gather(x)

    def level(self, grid_h: int, grid_w: int) -> "TileGrid":
        """A coarser level's grid: each of its tiles once (see the module
        docstring)."""
        if self.grid_h % grid_h or self.grid_w % grid_w:
            raise ValueError(f"a {grid_h}x{grid_w} level does not embed in the "
                             f"{self.grid_h}x{self.grid_w} grid")
        return TileGrid(grid_h, grid_w,
                        self.rep * (self.grid_h // grid_h) * (self.grid_w // grid_w))


# ---------------------------------------------------------------------------
# One tile per rank.
# ---------------------------------------------------------------------------


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiles, axis, step, x):
        ctx.tiles, ctx.axis, ctx.step = tiles, axis, step
        return tiles._p2p_shift(x, axis, step)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, ctx.tiles._p2p_shift(g, ctx.axis, -ctx.step)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents the same way
    (the transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return None, g


class _GatherTiles(torch.autograd.Function):
    """Every rank's tile assembled into the full image on every rank.  The
    tail after the junction runs replicated on the same full activation,
    so each rank's cotangent of the full image is already complete: the
    backward keeps this rank's slice (no sum over ranks, which would count
    the replicated tail's gradient once per rank).  On a replicated level
    only the copy the gather kept gets it (``_gather_dedup``'s adjoint,
    ``spatial.py:67-85``); the others get zeros."""

    @staticmethod
    def forward(ctx, tiles, x):
        ctx.tiles = tiles
        return tiles._assemble(x)

    @staticmethod
    def backward(ctx, g):
        own = ctx.tiles._own(g).contiguous()
        return None, own if ctx.tiles.primary else torch.zeros_like(own)


class _AllToAllJunction(torch.autograd.Function):
    """Tiles to batch shards in one all_to_all (``batch_split_all_to_all``,
    degree = tile count): rank ``r`` sends its tile of batch shard ``j`` to
    rank ``j`` and assembles shard ``r`` of the full image from the tiles it
    receives.  The backward is the reverse all_to_all: with one shard a
    rank the tail is no longer replicated, so nothing is counted twice."""

    @staticmethod
    def forward(ctx, tiles, x):
        ctx.tiles = tiles
        return tiles._tiles_to_shard(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.tiles._shard_to_tiles(g)


class _GatherSlice(torch.autograd.Function):
    """Gather, then keep batch shard ``k`` (``degree`` < tile count: a
    replication group of ranks computes one shard).  The backward is the
    adjoint of both: the shard's cotangent zero-padded to the full batch,
    summed over the ranks, and this rank's tile of it."""

    @staticmethod
    def forward(ctx, tiles, k, degree, x):
        ctx.tiles, ctx.k, ctx.degree = tiles, k, degree
        full = tiles._assemble(x)
        n = full.shape[0] // degree
        return full[k * n:(k + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0]
        full = g.new_zeros((n * ctx.degree, *g.shape[1:]))
        full[ctx.k * n:(ctx.k + 1) * n] = g
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=ctx.tiles.group)
        own = ctx.tiles._own(full).contiguous()
        return None, None, None, own if ctx.tiles.primary else torch.zeros_like(own)


class ProcessGroupTiles:
    """One tile per rank of ``group`` (``None``: the default group).  The
    ranks form a ``(grid_h·rep_h) x (grid_w·rep_w)`` device grid, row-major;
    device ``(ah, aw)`` holds tile ``(ah // rep_h, aw // rep_w)``.  Level 0
    has ``rep`` 1: rank ``r`` holds tile ``r``.  ``tiles`` counts the ranks
    (each replicated tile ``rep_h·rep_w`` times), which is what the
    cross-tile sums and the gradient reduction divide by."""

    folded = False

    def __init__(self, grid_h: int, grid_w: int, group=None, rep_h: int = 1,
                 rep_w: int = 1):
        self.grid_h, self.grid_w = int(grid_h), int(grid_w)
        self.rep_h, self.rep_w = int(rep_h), int(rep_w)
        self.dev_h, self.dev_w = self.grid_h * self.rep_h, self.grid_w * self.rep_w
        self.tiles = self.dev_h * self.dev_w
        self.group = group if group is not None else dist.group.WORLD
        size = dist.get_world_size(self.group)
        if size != self.tiles:
            raise ValueError(f"a {grid_h}x{grid_w} tile grid (rep {rep_h}x{rep_w}) "
                             f"needs {self.tiles} ranks, the group has {size}")
        self.rank = dist.get_rank(self.group)
        self.ah, self.aw = divmod(self.rank, self.dev_w)
        self.ih, self.iw = self.ah // self.rep_h, self.aw // self.rep_w
        # The copy of its tile that a gather keeps.
        self.primary = self.ah % self.rep_h == 0 and self.aw % self.rep_w == 0

    @property
    def count_factor(self) -> int:
        return self.tiles

    def level(self, grid_h: int, grid_w: int) -> "ProcessGroupTiles":
        """The same ranks as a coarser ``grid_h x grid_w`` level, each tile
        replicated over the ranks it spans (``layer_ctx.py:183-202``)."""
        if self.dev_h % grid_h or self.dev_w % grid_w:
            raise ValueError(f"a {grid_h}x{grid_w} level does not embed in the "
                             f"{self.dev_h}x{self.dev_w} ranks")
        return ProcessGroupTiles(grid_h, grid_w, self.group, self.dev_h // grid_h,
                                 self.dev_w // grid_w)

    def _device_rank(self, ah: int, aw: int) -> int:
        return dist.get_global_rank(self.group, ah * self.dev_w + aw)

    def _neighbour(self, axis: str, step: int):
        """Group rank of the device holding the tile ``step`` places along
        ``axis`` at this rank's place in its replication group (``rep``
        devices a tile: ``halo.py:55-75``), or None beyond the border."""
        if _axis_index(axis) == 0:
            ah = self.ah + step * self.rep_h
            return ah * self.dev_w + self.aw if 0 <= ah < self.dev_h else None
        aw = self.aw + step * self.rep_w
        return self.ah * self.dev_w + aw if 0 <= aw < self.dev_w else None

    def _p2p_shift(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """Send ``x`` to the tile ``step`` places on, return what the tile
        ``step`` places back sent (zeros at the border).  The send and the
        receive are posted together."""
        send = x.contiguous()
        recv = torch.zeros_like(send)
        to, frm = self._neighbour(axis, step), self._neighbour(axis, -step)
        ops = []
        if to is not None:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(self.group, to), self.group))
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(self.group, frm), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv

    def shift(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        if step not in (1, -1):
            raise ValueError(f"step {step}")
        return _Shift.apply(self, axis, step, x)

    def sum_stats(self, *stats: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Cross-tile sums of local statistics, in one all-reduce (every
        replicated tile counted ``rep`` times, as its count is)."""
        flat = _AllReduceSum.apply(self.group, torch.cat([s.reshape(-1) for s in stats]))
        return tuple(flat.split([s.numel() for s in stats]))

    @torch.no_grad()
    def tile_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks of this rank's value."""
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t / self.tiles

    def _all_parts(self, x: torch.Tensor):
        parts = [torch.empty_like(x) for _ in range(self.tiles)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

    def _assemble(self, x: torch.Tensor) -> torch.Tensor:
        """Every tile, all-gathered into the full image (one copy of each
        replicated tile)."""
        parts = self._all_parts(x)
        rows = [torch.cat([parts[ah * self.dev_w + aw]
                           for aw in range(0, self.dev_w, self.rep_w)], dim=2)
                for ah in range(0, self.dev_h, self.rep_h)]
        return torch.cat(rows, dim=1)

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        h, w = t.shape[1] // self.grid_h, t.shape[2] // self.grid_w
        return t[:, self.ih * h:(self.ih + 1) * h, self.iw * w:(self.iw + 1) * w]

    def scatter(self, x):
        return _map_act(lambda t: self._own(t).contiguous(), x)

    def gather(self, x):
        return _map_act(lambda t: _GatherTiles.apply(self, t), x)

    def _tiles_to_shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's tile ``[N, h, w, ...]`` → its batch shard of the full
        image ``[N / T, H, W, ...]`` (shard r on rank r)."""
        n = t.shape[0] // self.tiles
        send = t.contiguous()
        recv = torch.empty_like(send)  # [T * n, h, w, ...]: tile r of my shard
        dist.all_to_all_single(recv, send, group=self.group)
        parts = recv.reshape(self.grid_h, self.grid_w, n, *t.shape[1:])
        h, w = t.shape[1], t.shape[2]
        parts = parts.permute(2, 0, 3, 1, 4, *range(5, parts.dim()))
        return parts.reshape(n, self.grid_h * h, self.grid_w * w, *t.shape[3:])

    def _shard_to_tiles(self, g: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`_tiles_to_shard`."""
        n = g.shape[0]
        h, w = g.shape[1] // self.grid_h, g.shape[2] // self.grid_w
        parts = g.reshape(n, self.grid_h, h, self.grid_w, w, *g.shape[3:])
        send = parts.permute(1, 3, 0, 2, 4, *range(5, parts.dim())).contiguous()
        recv = torch.empty_like(send).reshape(self.tiles * n, h, w, *g.shape[3:])
        dist.all_to_all_single(recv, send.reshape(recv.shape), group=self.group)
        return recv

    def batch_split(self, x, degree: int, shard: int):
        """The ``batch_split`` junction: batch shard ``shard`` of ``degree``
        of the full image (this rank's); one all_to_all when every rank
        takes its own shard of an unreplicated level, else gather and
        slice."""
        if degree == self.tiles and self.rep_h == self.rep_w == 1:
            return _map_act(lambda t: _AllToAllJunction.apply(self, t), x)
        return _map_act(lambda t: _GatherSlice.apply(self, shard, degree, t), x)

    def gather_exact(self, x):
        """The full image with the exact adjoint (the cotangents summed over
        the ranks): a transition into a degenerate level whose ranks each
        see a part of the loss (the ``batch_split`` tail)."""
        return _map_act(lambda t: _GatherSlice.apply(self, 0, 1, t), x)


# ---------------------------------------------------------------------------
# Level transitions (multi-level SP).
# ---------------------------------------------------------------------------


def respatial_fast_enabled() -> bool:
    """``MPI4DL_NO_RESPATIAL_FAST=1`` sends every transition through the
    gather path (``spatial.py:217-226``)."""
    return os.environ.get("MPI4DL_NO_RESPATIAL_FAST", "0") != "1"


def _axis_pos(t: ProcessGroupTiles, d: int) -> int:
    return t.ah if d == 0 else t.aw


def _axis_rank(t: ProcessGroupTiles, d: int, a: int) -> int:
    """Global rank of the device at index ``a`` along axis ``d`` in this
    rank's row (``d`` 1) or column (``d`` 0)."""
    return t._device_rank(a, t.aw) if d == 0 else t._device_rank(t.ah, a)


class _RefineSlice(torch.autograd.Function):
    """Refinement (``g_to = k·g_from``): the new tile is a slice of the
    source tile this rank holds — no communication; the backward pads the
    cotangent back (``_respatial_refine_slice``, ``spatial.py:228-237``)."""

    @staticmethod
    def forward(ctx, x, dim, off, local):
        ctx.dim, ctx.off, ctx.n = dim, off, x.shape[dim]
        return x.narrow(dim, off * local, local).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.n
        out = g.new_zeros(shape)
        out.narrow(ctx.dim, ctx.off * g.shape[ctx.dim], g.shape[ctx.dim]).copy_(g)
        return out, None, None, None


class _CoarsenRing(torch.autograd.Function):
    """Coarsening from an unreplicated level (``g_from = k·g_to``, ``r_from
    = 1``): the ``k`` ranks whose source tiles make one target tile pass
    them round in ``k - 1`` group-cyclic shifts, one ``batch_isend_irecv``
    each, every rank placing what it receives at the sender's position
    (``_respatial_coarsen_ring``, ``spatial.py:240-280``).  The backward is
    the exact adjoint: each received piece's cotangent goes back to its
    sender, and a tile's gradient is the sum of its ``k`` copies'."""

    @staticmethod
    def forward(ctx, tiles, dim, k, x):
        d = dim - 1
        a = _axis_pos(tiles, d)
        base, pos0 = (a // k) * k, a % k
        peers = [(_axis_rank(tiles, d, base + (pos0 + h) % k),
                  _axis_rank(tiles, d, base + (pos0 - h) % k)) for h in range(1, k)]
        ctx.tiles, ctx.dim, ctx.k, ctx.pos0, ctx.peers = tiles, dim, k, pos0, peers
        x = x.contiguous()
        L = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = k * L
        out = x.new_zeros(shape)
        out.narrow(dim, pos0 * L, L).copy_(x)
        for h, (to, frm) in enumerate(peers, start=1):
            recv = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, to, tiles.group),
                    dist.P2POp(dist.irecv, recv, frm, tiles.group)]):
                req.wait()
            out.narrow(dim, ((pos0 - h) % k) * L, L).copy_(recv)
        return out

    @staticmethod
    def backward(ctx, g):
        dim, k, pos0 = ctx.dim, ctx.k, ctx.pos0
        L = g.shape[dim] // k
        dx = g.narrow(dim, pos0 * L, L).contiguous().clone()
        for h, (to, frm) in enumerate(ctx.peers, start=1):
            piece = g.narrow(dim, ((pos0 - h) % k) * L, L).contiguous()
            recv = torch.empty_like(piece)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, piece, frm, ctx.tiles.group),
                    dist.P2POp(dist.irecv, recv, to, ctx.tiles.group)]):
                req.wait()
            dx += recv
        return None, None, None, dx


class _GatherAxis(torch.autograd.Function):
    """The full extent of one dim from the source level (one copy of each
    replicated tile), then this rank's target tile of it (``full[idx·local:
    (idx+1)·local]``, the whole extent when ``g_to`` is 1): the gather path
    of ``respatial`` (``spatial.py:311-318``).  Only this rank's row
    (column) of ranks takes part, in one ``batch_isend_irecv``: each kept
    copy sends its tile to the ranks of the line whose target tile it
    overlaps.  The backward is the exact adjoint, a reduce-scatter over the
    line: every rank sends each kept copy the part of its cotangent that
    falls in that copy's tile, the kept copy sums them in line order, and
    the other copies get zeros."""

    @staticmethod
    def forward(ctx, src, dim, g_to, r_to, x):
        x = x.contiguous()
        plan = _LinePlan(src, dim - 1, g_to, r_to, x.shape[dim])
        ctx.plan, ctx.dim, ctx.shape = plan, dim, x.shape
        pieces, ops = {}, []
        if plan.kept:
            for b in plan.readers(plan.own):
                ops.append(plan.op(dist.isend, x, b))
        for j in plan.overlapped(plan.a):
            if j == plan.own and plan.kept:
                pieces[j] = x
            else:
                pieces[j] = torch.empty_like(x)
                ops.append(plan.op(dist.irecv, pieces[j], j * plan.rep))
        _wait_all(ops)
        js = sorted(pieces)
        full = torch.cat([pieces[j] for j in js], dim=dim)
        return full.narrow(dim, plan.start(plan.a) - js[0] * plan.L, plan.local).contiguous()

    @staticmethod
    def backward(ctx, g):
        plan, dim = ctx.plan, ctx.dim
        L, s = plan.L, plan.start(plan.a)
        mine, ops = None, []
        for j in plan.overlapped(plan.a):
            lo, hi = max(s, j * L), min(s + plan.local, (j + 1) * L)
            if hi - lo == L:
                blk = g.narrow(dim, lo - s, L).contiguous()
            else:
                blk = g.new_zeros(ctx.shape)
                blk.narrow(dim, lo - j * L, hi - lo).copy_(g.narrow(dim, lo - s, hi - lo))
            if j == plan.own and plan.kept:
                mine = blk
            else:
                ops.append(plan.op(dist.isend, blk, j * plan.rep))
        parts = {}
        if plan.kept:
            for b in plan.readers(plan.own, with_self=True):
                if b == plan.a:
                    parts[b] = mine
                else:
                    parts[b] = g.new_empty(ctx.shape)
                    ops.append(plan.op(dist.irecv, parts[b], b))
        _wait_all(ops)
        if not plan.kept:
            return None, None, None, None, g.new_zeros(ctx.shape)
        dx = None
        for b in sorted(parts):
            dx = parts[b] if dx is None else dx + parts[b]
        return None, None, None, None, dx


class _LinePlan:
    """Who holds and who reads what along one dim ``d`` for
    :class:`_GatherAxis`: line position ``b`` is the device index along
    ``d`` in this rank's row (column); source piece ``j`` (``L`` long,
    ``[j·L, (j+1)·L)`` of the extent) is held by its kept copy at position
    ``j·rep``; position ``b``'s target tile is ``[start(b), start(b) +
    local)``."""

    def __init__(self, src: "ProcessGroupTiles", d: int, g_to: int, r_to: int, L: int):
        self.src, self.d, self.L, self.r_to = src, d, L, r_to
        self.rep = src.rep_h if d == 0 else src.rep_w
        self.grid = src.grid_h if d == 0 else src.grid_w
        self.local = self.grid * L // g_to
        self.line = _line_ranks(src, d)
        self.a = _axis_pos(src, d)
        self.kept = self.a % self.rep == 0
        self.own = self.a // self.rep

    def start(self, b: int) -> int:
        return (b // self.r_to) * self.local

    def _overlaps(self, b: int, j: int) -> bool:
        s = self.start(b)
        return j * self.L < s + self.local and s < (j + 1) * self.L

    def overlapped(self, b: int):
        """The source pieces that position ``b``'s target tile overlaps."""
        return [j for j in range(self.grid) if self._overlaps(b, j)]

    def readers(self, j: int, with_self: bool = False):
        """The positions whose target tile overlaps piece ``j``."""
        return [b for b in range(len(self.line))
                if self._overlaps(b, j) and (with_self or b != self.a)]

    def op(self, fn, t: torch.Tensor, b: int):
        return dist.P2POp(fn, t, dist.get_global_rank(self.src.group, self.line[b]),
                          self.src.group)


def _wait_all(ops) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _line_ranks(t: ProcessGroupTiles, d: int):
    """Group ranks of this rank's column (``d`` 0) or row (``d`` 1) of the
    device grid, in order."""
    if d == 0:
        return [ah * t.dev_w + t.aw for ah in range(t.dev_h)]
    return [t.ah * t.dev_w + aw for aw in range(t.dev_w)]


def respatial(x, src, dst):
    """Move an activation from level ``src``'s tile layout to level
    ``dst``'s (``respatial``, ``spatial.py:283-333``), dim by dim (H, then
    W): a refinement is a local slice, a coarsening from an unreplicated
    level the ring of ``k - 1`` shifts, anything else gathers the dim's
    full extent and slices the target tile (``MPI4DL_NO_RESPATIAL_FAST=1``:
    always).  Every path is an ``autograd.Function`` with its exact
    adjoint.  On :class:`TileGrid` the move is a regrouping of the folded
    batch: the source level's full image cut into the target's tiles."""
    if src.folded:
        full = src.gather(x)
        return full if (dst.grid_h, dst.grid_w) == (1, 1) else dst.scatter(full)
    if src.tiles != dst.tiles:
        raise ValueError(f"levels on {src.tiles} and {dst.tiles} ranks")
    fast = respatial_fast_enabled()

    def dim_pass(t, cur, d):
        """Dim ``d`` of ``t`` (laid out as ``cur``) to the target's layout;
        returns the tensor and its new layout."""
        g_from, r_from = (cur.grid_h, cur.rep_h) if d == 0 else (cur.grid_w, cur.rep_w)
        g_to, r_to = (dst.grid_h, dst.rep_h) if d == 0 else (dst.grid_w, dst.rep_w)
        if g_from == g_to:
            return t, cur
        dim = d + 1
        nxt = (ProcessGroupTiles(g_to, cur.grid_w, cur.group, r_to, cur.rep_w) if d == 0
               else ProcessGroupTiles(cur.grid_h, g_to, cur.group, cur.rep_h, r_to))
        if fast and g_to > g_from and g_to % g_from == 0:
            k = g_to // g_from
            a = _axis_pos(cur, d)
            off = a // r_to - (a // r_from) * k
            return _RefineSlice.apply(t, dim, off, t.shape[dim] // k), nxt
        if fast and g_to > 1 and r_from == 1 and g_from % g_to == 0:
            return _CoarsenRing.apply(cur, dim, g_from // g_to, t), nxt
        return _GatherAxis.apply(cur, dim, g_to, r_to, t), nxt

    def move(t):
        t, cur = dim_pass(t, src, 0)
        return dim_pass(t, cur, 1)[0]

    return _map_act(move, x)
