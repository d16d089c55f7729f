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
  tiles and back (the junction).
- :meth:`reduce_grads` — the gradient reduction over the tile group.

:class:`ProcessGroupTiles` holds one tile per rank of a
``torch.distributed`` group (gloo on the CPU, NCCL across cards); shifts
are ``batch_isend_irecv`` pairs, sums are all-reduces.

:class:`TileGrid` holds the whole grid in one process, the tiles FOLDED
INTO THE BATCH dimension (tile-major: row ``t * N + n`` is sample ``n`` of
tile ``t``); shifts are indexing.  Every batch reduction then already
spans the tiles, so its cross-tile sum is the identity and its count
factor 1 — BatchNorm sums, K2's statistics and the loss are not counted
twice.  Per-tile statistics (``--per-tile-bn``) view such a tensor as
``[T, N, ...]`` (:meth:`TileGrid.per_tile`).  It exists so that one card,
which holds one NCCL rank, can run the engine; the runners never use it
in place of missing ranks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
    the batch dimension."""

    folded = True
    count_factor = 1

    def __init__(self, grid_h: int, grid_w: int):
        self.grid_h, self.grid_w = int(grid_h), int(grid_w)
        self.tiles = self.grid_h * self.grid_w

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
        return stats

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

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Nothing to reduce: one process holds every tile."""


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
    the replicated tail's gradient once per rank)."""

    @staticmethod
    def forward(ctx, tiles, x):
        ctx.tiles = tiles
        parts = [torch.empty_like(x) for _ in range(tiles.tiles)]
        dist.all_gather(parts, x.contiguous(), group=tiles.group)
        rows = [torch.cat(parts[r * tiles.grid_w:(r + 1) * tiles.grid_w], dim=2)
                for r in range(tiles.grid_h)]
        return torch.cat(rows, dim=1)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.tiles._own(g).contiguous()


class ProcessGroupTiles:
    """One tile per rank of ``group`` (``None``: the default group), rank
    ``r`` of the group holding tile ``r``."""

    folded = False

    def __init__(self, grid_h: int, grid_w: int, group=None):
        self.grid_h, self.grid_w = int(grid_h), int(grid_w)
        self.tiles = self.grid_h * self.grid_w
        self.group = group if group is not None else dist.group.WORLD
        size = dist.get_world_size(self.group)
        if size != self.tiles:
            raise ValueError(f"a {grid_h}x{grid_w} tile grid needs {self.tiles} "
                             f"ranks, the group has {size}")
        self.rank = dist.get_rank(self.group)
        self.ih, self.iw = divmod(self.rank, self.grid_w)

    @property
    def count_factor(self) -> int:
        return self.tiles

    def _neighbour(self, axis: str, step: int):
        """Group rank of the tile ``step`` places along ``axis``, or None
        beyond the grid's border."""
        if _axis_index(axis) == 0:
            ih = self.ih + step
            return ih * self.grid_w + self.iw if 0 <= ih < self.grid_h else None
        iw = self.iw + step
        return self.ih * self.grid_w + iw if 0 <= iw < self.grid_w else None

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
        """Cross-tile sums of local statistics, in one all-reduce."""
        flat = _AllReduceSum.apply(self.group, torch.cat([s.reshape(-1) for s in stats]))
        return tuple(flat.split([s.numel() for s in stats]))

    @torch.no_grad()
    def tile_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks of this rank's value."""
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t / self.tiles

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        h, w = t.shape[1] // self.grid_h, t.shape[2] // self.grid_w
        return t[:, self.ih * h:(self.ih + 1) * h, self.iw * w:(self.iw + 1) * w]

    def scatter(self, x):
        return _map_act(lambda t: self._own(t).contiguous(), x)

    def gather(self, x):
        return _map_act(lambda t: _GatherTiles.apply(self, t), x)

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum the gradients over the ranks in place, in one all-reduce."""
        from mpi4dl_tpu_torch.distributed import all_reduce_sum_

        all_reduce_sum_(list(grads), self.group)
