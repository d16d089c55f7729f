"""The spatial-parallel region and its junction into the replicated tail
(counterpart of ``mpi4dl_tpu/parallel/spatial.py``, one level).

:func:`apply_spatial_model` runs a CellModel's leading cells on tiles
(halo-exchanging convs and pools, cross-tile BatchNorm), crosses the
junction and runs the remaining cells.  The ``gather`` junction assembles
the full activation: with one tile per rank the tail runs replicated on
every rank, on the one-process grid once.  The ``batch_split`` junction
(``--local-DP``, degree ``local_dp``) hands each tile device a batch shard
of the full activation instead, one all_to_all when every device takes its
own shard; on the one-process grid the tail runs the whole batch with
per-shard BatchNorm statistics (``ApplyCtx.bn_shards``).  Left out
(ROADMAP A11): multi-level SP and ``respatial``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from mpi4dl_tpu_torch.cells import CellModel
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.obs.scopes import scope


def gather_spatial(x, sp: SpatialCtx):
    """The full (global-H/W) activation from the tiles (a tuple state
    gathers element-wise)."""
    return sp.tiles.gather(x)


def tile_device_count(sp: SpatialCtx) -> int:
    """Devices on the tile axes."""
    nh = sp.grid_h * sp.rep_h if sp.axis_h else 1
    nw = sp.grid_w * sp.rep_w if sp.axis_w else 1
    return nh * nw


def junction_degree(sp: SpatialCtx, local_dp: Optional[int]) -> int:
    """The ``batch_split`` degree: ``local_dp``, else the tile count; it
    must divide the tile devices (``spatial.py:106-120``)."""
    total = tile_device_count(sp)
    degree = local_dp or total
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
                   local_dp: Optional[int] = None):
    """The SP→LP junction: ``gather`` (the full activation everywhere) or
    ``batch_split`` (this device's batch shard, ``spatial.py:188-214``)."""
    if junction == "batch_split":
        degree = junction_degree(sp_last, local_dp)
        n = (x[0] if isinstance(x, tuple) else x).shape[0]
        if n % degree:
            raise ValueError(f"batch {n} not divisible by junction degree {degree}")
        name = ("junction_batch_split_a2a" if can_all_to_all_junction(sp_last, degree)
                else "junction_batch_split")
        with scope(name):
            return sp_last.tiles.batch_split(x, degree,
                                             junction_shard_index(sp_last, degree))
    if junction != "gather":
        raise ValueError(f"unknown junction {junction!r}")
    with scope("junction_gather"):
        return gather_spatial(x, sp_last)


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


def apply_spatial_region(model: CellModel, x, ctx: ApplyCtx, stop: int,
                         remat=False) -> Tuple[object, SpatialCtx]:
    """Cells [0, stop) under ``ctx.spatial``; the activation stays tiled."""
    if stop < 1:
        raise ValueError(f"empty spatial region [0, {stop})")
    with scope("sp_level0"):
        x = model(x, ctx, remat=remat, start=0, stop=stop)
    return x, ctx.spatial


@torch.no_grad()
def cell_output_shapes(model: CellModel, in_shape) -> List:
    """Each cell's global output shape (a tuple of shapes for a tuple
    state), from one forward of ``model`` on the meta device (build it with
    ``device="meta"``: no memory, no compute)."""
    x = torch.zeros(in_shape, device="meta")
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
                        local_dp: Optional[int] = None):
    """Spatial region, junction, tail.  ``x`` is this process's tiles
    (``sp.tiles.scatter`` of the image); the result is the model's output
    for the whole batch (``gather``, and ``batch_split`` on the one-process
    grid) or for this device's shard (``batch_split`` with one tile a
    rank).  ``spatial_until`` None: ``model.spatial_until``, else every
    cell but the head (the head pools the whole image)."""
    sp = ctx.spatial
    if sp is None or not sp.active:
        raise ValueError("apply_spatial_model needs an active SpatialCtx")
    if spatial_until is None:
        spatial_until = model.spatial_until or (len(model.cells) - 1)
    x, sp_last = apply_spatial_region(model, x, ctx, spatial_until, remat=remat)
    x = apply_junction(x, sp_last, junction, local_dp)
    return model(x, tail_ctx(ctx, sp_last, junction, local_dp), remat=remat,
                 start=spatial_until)
