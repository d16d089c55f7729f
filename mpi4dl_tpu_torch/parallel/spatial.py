"""The spatial-parallel region and its junction into the replicated tail
(counterpart of ``mpi4dl_tpu/parallel/spatial.py``, one level).

:func:`apply_spatial_model` runs a CellModel's leading cells on tiles
(halo-exchanging convs and pools, cross-tile BatchNorm), gathers the tiles
into the full activation (the ``gather`` junction), and runs the remaining
cells on it.  With one tile per rank the tail runs replicated on every
rank; on the one-process grid it runs once.  Left out (ROADMAP): multi-level
SP and ``respatial`` (A11), the ``batch_split`` junction and
``--local-DP`` (A7).
"""

from __future__ import annotations

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


def apply_junction(x, sp_last: SpatialCtx, junction: str = "gather"):
    """The SP→LP junction; ``gather`` only (``batch_split`` is ROADMAP A7)."""
    if junction != "gather":
        raise NotImplementedError(
            f"the {junction!r} junction (--local-DP) is not ported to PyTorch "
            "yet (ROADMAP A7)"
        )
    with scope("junction_gather"):
        return gather_spatial(x, sp_last)


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
                        junction: str = "gather", remat=False):
    """Spatial region, junction, tail.  ``x`` is this process's tiles
    (``sp.tiles.scatter`` of the image); the result is the full model's
    output, whole.  ``spatial_until`` None: ``model.spatial_until``, else
    every cell but the head (the head pools the whole image)."""
    sp = ctx.spatial
    if sp is None or not sp.active:
        raise ValueError("apply_spatial_model needs an active SpatialCtx")
    if spatial_until is None:
        spatial_until = model.spatial_until or (len(model.cells) - 1)
    x, sp_last = apply_spatial_region(model, x, ctx, spatial_until, remat=remat)
    x = apply_junction(x, sp_last, junction)
    return model(x, ctx.with_spatial(None), remat=remat, start=spatial_until)
