"""The spatial-parallel region and its junction into the replicated tail
(counterpart of ``mpi4dl_tpu/parallel/spatial.py``).

:func:`apply_spatial_model` runs a CellModel's leading cells on tiles
(halo-exchanging convs and pools, cross-tile BatchNorm), crosses the
junction and runs the remaining cells.  The ``gather`` junction assembles
the full activation: with one tile per rank the tail runs replicated on
every rank, on the one-process grid once.  The ``batch_split`` junction
(``--local-DP``, degree ``local_dp``) hands each tile device a batch shard
of the full activation instead, one all_to_all when every device takes its
own shard; on the one-process grid the tail runs the whole batch with
per-shard BatchNorm statistics (``ApplyCtx.bn_shards``).

Multi-level SP: ``levels`` is a list of ``(stop_cell, SpatialCtx)``
(``layer_ctx.spatial_levels_for``), later levels on coarser grids of the
same ranks; between levels the activation moves by :func:`respatial`.  A
fully degenerate level (grid 1x1, e.g. the tail of a ``4,1`` chain) runs
unsharded on the whole image, like the tail: the move into it is the
junction's gather (``batch_split``: with the exact adjoint) and its
gradients are reduced as the tail's are.

``quant`` (a :class:`~mpi4dl_tpu_torch.quant.QuantPolicy`, None: off)
sends the junction and the level transitions through the quantized wire
of their classes (``junction``, ``respatial``; ``parallel/tiles.py``),
under the same scope names; every such collective is counted in
``quant.collectives.WIRE_BYTES`` whether quantized or not.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from mpi4dl_tpu_torch.cells import CellModel
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.parallel import tiles as _tiles
from mpi4dl_tpu_torch.quant.policy import QuantPolicy, class_mode

Levels = List[Tuple[int, SpatialCtx]]


def gather_spatial(x, sp: SpatialCtx, quant: Optional[QuantPolicy] = None):
    """The full (global-H/W) activation from the tiles (a tuple state
    gathers element-wise), through the junction class's wire."""
    mode, block = class_mode(quant, "junction")
    return sp.tiles.gather(x, mode, block, "junction")


def tile_device_count(sp: SpatialCtx) -> int:
    """Devices on the tile axes."""
    nh = sp.grid_h * sp.rep_h if sp.axis_h else 1
    nw = sp.grid_w * sp.rep_w if sp.axis_w else 1
    return nh * nw


def junction_degree(sp: SpatialCtx, local_dp: Optional[int]) -> int:
    """The ``batch_split`` degree: ``local_dp``, else the last level's tile
    count; it must divide the tile devices (``spatial.py:106-120, 196``)."""
    total = tile_device_count(sp)
    degree = local_dp or sp.grid_h * sp.grid_w
    if not (1 <= degree <= total and total % degree == 0):
        raise ValueError(f"--local-DP {degree} must divide the {total} tile devices")
    return degree


def junction_shard_index(sp: SpatialCtx, degree: int) -> Optional[int]:
    """This device's batch shard under a degree-``degree`` junction: the
    tile devices in row-major order, cut into ``degree`` contiguous groups
    (each group computes one shard; ``spatial.py:113-125``).  None on the
    one-process grid, which holds every shard."""
    if sp.tiles.folded:
        return None
    return sp.tiles.rank // (tile_device_count(sp) // degree)


def can_all_to_all_junction(sp: SpatialCtx, degree: int) -> bool:
    """Every tile device takes its own shard: the junction is one
    all_to_all (``spatial.py:150-158``)."""
    return sp.rep_h == 1 and sp.rep_w == 1 and degree == sp.grid_h * sp.grid_w


def apply_junction(x, sp_last: SpatialCtx, junction: str = "gather",
                   local_dp: Optional[int] = None, quant: Optional[QuantPolicy] = None):
    """The SP→LP junction: ``gather`` (the full activation everywhere) or
    ``batch_split`` (this device's batch shard, ``spatial.py:188-214``).
    After a degenerate last level the activation is already whole: the
    gather is the identity, the batch split a slice.  ``quant``: the
    junction class's payload."""
    if not sp_last.active:
        if junction == "batch_split" and not sp_last.tiles.folded:
            degree = junction_degree(sp_last, local_dp)
            k = junction_shard_index(sp_last, degree)
            return _tiles._map_act(lambda t: t.chunk(degree)[k], x)
        if junction not in ("gather", "batch_split"):
            raise ValueError(f"unknown junction {junction!r}")
        return x
    if junction == "batch_split":
        degree = junction_degree(sp_last, local_dp)
        n = (x[0] if isinstance(x, tuple) else x).shape[0]
        if n % degree:
            raise ValueError(f"batch {n} not divisible by junction degree {degree}")
        name = ("junction_batch_split_a2a" if can_all_to_all_junction(sp_last, degree)
                else "junction_batch_split")
        mode, block = class_mode(quant, "junction")
        with scope(name):
            return sp_last.tiles.batch_split(x, degree,
                                             junction_shard_index(sp_last, degree),
                                             mode, block, "junction")
    if junction != "gather":
        raise ValueError(f"unknown junction {junction!r}")
    with scope("junction_gather"):
        return gather_spatial(x, sp_last, quant)


def tail_ctx(ctx: ApplyCtx, sp_last: SpatialCtx, junction: str,
             local_dp: Optional[int]) -> ApplyCtx:
    """The tail's context: unsharded; after a ``batch_split`` junction on
    the one-process grid its batch holds ``degree`` shards, each normalised
    with its own statistics (JAX's tail ``bn_stat_axes``,
    ``spatial.py:467-478``).  With one tile per rank the step averages the
    tail's running statistics over the ranks instead."""
    c = ctx.with_spatial(None)
    if junction == "batch_split" and sp_last.tiles.folded:
        c = dataclasses.replace(c, bn_shards=junction_degree(sp_last, local_dp))
    return c


def respatial(x, sp_from: SpatialCtx, sp_to: SpatialCtx, junction: str = "gather",
              quant: Optional[QuantPolicy] = None):
    """Move an activation from level ``sp_from``'s tiles to ``sp_to``'s
    (``spatial.py:283-333``; ``parallel/tiles.respatial``).  Into a
    degenerate level the move is the gather: with ``gather``, whose ranks
    then hold the whole loss, each keeps its own tile's cotangent; with
    ``batch_split`` the cotangents are summed over the ranks.  ``quant``:
    the respatial class's payload."""
    mode, block = class_mode(quant, "respatial")
    if not sp_to.active:
        if junction == "batch_split" and not sp_from.tiles.folded:
            return sp_from.tiles.gather_exact(x, mode, block, "respatial")
        return sp_from.tiles.gather(x, mode, block, "respatial")
    return _tiles.respatial(x, sp_from.tiles, sp_to.tiles, mode, block, "respatial")


def apply_spatial_region(model: CellModel, x, ctx: ApplyCtx, stop: int,
                         remat=False, levels: Optional[Levels] = None,
                         junction: str = "gather",
                         quant: Optional[QuantPolicy] = None) -> Tuple[object, SpatialCtx]:
    """Cells [0, stop) level by level (``spatial.py:335-380``), the
    activation moved by :func:`respatial` between levels; it stays in the
    last level's layout, which is returned with it.  A degenerate level
    runs with ``spatial=None``: no halo, no kernel, whole-image
    statistics."""
    if levels is None:
        levels = [(stop, ctx.spatial)]
    if levels[-1][0] != stop:
        raise ValueError(f"the last level ends at cell {levels[-1][0]}, the region "
                         f"at {stop}")
    start, prev = 0, None
    for li, (lstop, sp_l) in enumerate(levels):
        if lstop <= start:
            raise ValueError(f"empty spatial level [{start}, {lstop})")
        if prev is not None:
            with scope(f"respatial_l{li}"):
                x = respatial(x, prev, sp_l, junction, quant)
        c = ctx.with_spatial(sp_l if sp_l.active else None)
        with scope(f"sp_level{li}"):
            x = model(x, c, remat=remat, start=start, stop=lstop)
        start, prev = lstop, sp_l
    return x, prev


def active_region_cells(model: CellModel, stop: int, levels: Optional[Levels]):
    """The cells that run on tiles: those of the active levels (the
    gradient of a degenerate level's cells is complete on every rank, like
    the tail's)."""
    if levels is None:
        return list(model.cells[:stop])
    out, start = [], 0
    for lstop, sp_l in levels:
        if sp_l.active:
            out += list(model.cells[start:lstop])
        start = lstop
    return out


@torch.no_grad()
def cell_output_shapes(model: CellModel, in_shape) -> List:
    """Each cell's global output shape (a tuple of shapes for a tuple
    state), from one forward of ``model`` on the meta device (build it with
    ``device="meta"``: no memory, no compute)."""
    x = torch.zeros(in_shape, dtype=torch.float32, device="meta")
    ctx = ApplyCtx(train=False)
    shapes = []
    for cell in model.cells:
        x = cell(x, ctx)
        shapes.append(tuple(tuple(t.shape) for t in x) if isinstance(x, tuple)
                      else tuple(x.shape))
    return shapes


def _cell_bytes(shape, itemsize: int) -> int:
    """Activation bytes of one cell's (possibly tuple) output shape."""
    shapes = shape if isinstance(shape[0], (tuple, list)) else (shape,)
    total = 0
    for s in shapes:
        n = 1
        for d in s:
            n *= int(d)
        total += n * itemsize
    return total


def spatial_cost_ledger(shapes, tiles: int, itemsize: int = 2):
    """Per-placement activation bytes per device (``spatial.py:394-419``):
    for each junction placement ``su``, the cells before it carry 1/tiles
    of their bytes and the cells from it on (the replicated tail) all of
    them; the head cell is left out.  ``shapes`` are the cells' global
    output shapes.  Returns ``{su: bytes}`` for ``1 <= su < len - 1``."""
    n_cells = len(shapes)
    b = [_cell_bytes(s, itemsize) for s in shapes]
    out = {}
    for su in range(1, n_cells - 1):
        spatial = sum(b[i] for i in range(su)) / tiles
        tail = sum(b[i] for i in range(su, n_cells - 1))
        out[su] = spatial + tail
    return out


def choose_spatial_until(shapes, tiles: int, itemsize: int = 2) -> int:
    """``--spatial-until auto``: the placement with the least activation
    bytes per device; ties go to the deeper placement."""
    ledger = spatial_cost_ledger(shapes, tiles, itemsize)
    return min(sorted(ledger), key=lambda su: (ledger[su], -su))


def apply_spatial_model(model: CellModel, x, ctx: ApplyCtx,
                        spatial_until: Optional[int] = None,
                        junction: str = "gather", remat=False,
                        local_dp: Optional[int] = None,
                        levels: Optional[Levels] = None,
                        quant: Optional[QuantPolicy] = None):
    """Spatial region (one or more levels), junction, tail.  ``x`` is this
    process's tiles (``sp.tiles.scatter`` of the image, level 0); the
    result is the model's output for the whole batch (``gather``, and
    ``batch_split`` on the one-process grid) or for this device's shard
    (``batch_split`` with one tile a rank).  ``spatial_until`` None: the
    last level's stop, else ``model.spatial_until``, else every cell but
    the head (the head pools the whole image)."""
    sp = ctx.spatial
    if sp is None or not sp.active:
        raise ValueError("apply_spatial_model needs an active SpatialCtx")
    if spatial_until is None:
        spatial_until = (levels[-1][0] if levels else
                         model.spatial_until or (len(model.cells) - 1))
    x, sp_last = apply_spatial_region(model, x, ctx, spatial_until, remat=remat,
                                      levels=levels, junction=junction, quant=quant)
    x = apply_junction(x, sp_last, junction, local_dp, quant)
    return model(x, tail_ctx(ctx, sp_last, junction, local_dp), remat=remat,
                 start=spatial_until)
