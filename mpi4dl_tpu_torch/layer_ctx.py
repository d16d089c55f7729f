"""Apply-time context threading for layers (counterpart of
``mpi4dl_tpu/layer_ctx.py``).

One model definition serves every execution mode: layers read an
:class:`ApplyCtx` in ``forward`` and choose their behaviour from it.  When
``ctx.spatial`` is active the image's H and/or W are cut into tiles and
convs and pools exchange halos with the neighbouring tiles through
``SpatialCtx.tiles`` (``parallel/tiles.py``); otherwise they are plain ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from mpi4dl_tpu_torch.parallel.tiles import AXIS_SPH, AXIS_SPW


@dataclasses.dataclass(frozen=True)
class SpatialCtx:
    """How the image dims are sharded, plus the fused-kernel knob.

    ``axis_h``/``axis_w`` name the tile axes sharding H and W (``"sph"``,
    ``"spw"``), or are None when the dim is unsharded; ``grid_h``/``grid_w``
    are the tile counts.  ``tiles`` is the communication backend of the
    grid (:class:`~mpi4dl_tpu_torch.parallel.tiles.ProcessGroupTiles` or
    :class:`~mpi4dl_tpu_torch.parallel.tiles.TileGrid`).  The slice methods
    map as ``horizontal``: ``axis_h`` only, ``vertical``: ``axis_w`` only,
    ``square``: both.
    """

    axis_h: Optional[str] = None
    axis_w: Optional[str] = None
    grid_h: int = 1
    grid_w: int = 1
    # Devices per tile along each axis: above 1 on the coarser levels of
    # multi-level SP (``--num-spatial-parts 4,2``), whose tiles each span
    # rep_h x rep_w ranks of level 0 (``tiles`` is that level's backend).
    rep_h: int = 1
    rep_w: int = 1
    # True: BatchNorm sums its statistics over the tile grid (single-device
    # numerics); False: per-tile statistics (--per-tile-bn, the reference's).
    bn_cross_tile: bool = True
    # Fuse maximal conv runs into one accumulated halo exchange (D2,
    # ops/d2.py); d2_max_fused caps the margin-consuming layers per run
    # (--fused-layers; None = maximal runs).
    d2_mode: bool = False
    d2_max_fused: Optional[int] = None
    # Set by the premargin run for the layers inside a run whose margin
    # is already present: convs and pools run VALID on the sharded dims.
    halo_pre_exchanged: bool = False
    # The margin (per sharded dim) the activation still carries inside such
    # a run; BatchNorm excludes it from its statistics.
    pre_margin_h: int = 0
    pre_margin_w: int = 0
    # Route stride-1 convs and [ReLU, Conv2d, BatchNorm] windows through the
    # hand-written halo-conv kernels (ops/halo_conv.py).
    use_pallas_conv: bool = False
    # The axes are a one-device fiction (the H-striped layer run,
    # ops/hstripe_conv.hstripe_layer_run): there are no tiles to talk to,
    # so BatchNorm keeps each stripe's statistics and deposits them as they
    # are (the run averages them over the stripes itself).
    stat_local: bool = False
    tiles: Any = dataclasses.field(default=None, compare=False)

    @property
    def active(self) -> bool:
        return (self.axis_h is not None and self.grid_h > 1) or (
            self.axis_w is not None and self.grid_w > 1
        )

    @property
    def sharded_h(self) -> bool:
        return bool(self.axis_h) and self.grid_h > 1

    @property
    def sharded_w(self) -> bool:
        return bool(self.axis_w) and self.grid_w > 1


@dataclasses.dataclass(frozen=True)
class ApplyCtx:
    """Context passed to every layer's ``forward``.

    ``train``:   batch-statistics BatchNorm.
    ``spatial``: sharding description / kernel knob, or None.
    ``bn_sink``: when set (a dict, fresh per step or micro-batch), train-mode
                 BatchNorm layers put their momentum-updated running
                 statistics in it, keyed by the layer.  A layer OVERWRITES
                 its entry, so the recompute of a checkpointed region writes
                 the same value again instead of applying the update twice.
                 The step writes the sink into the buffers after the
                 optimizer update.
    ``bn_shards``: the batch is this many equal row blocks, each the batch
                 shard of another device (the tail after a ``batch_split``
                 junction on the one-process grid).  BatchNorm normalises
                 each with its own statistics and its running statistics
                 take their mean — the folded form of the JAX package's
                 ``bn_stat_axes`` (``layer_ctx.py:111-115``).  Across ranks
                 (the data axis, one tile per rank) the steps average the
                 running statistics themselves.
    """

    train: bool = True
    spatial: Optional[SpatialCtx] = None
    bn_sink: Optional[dict] = None
    bn_shards: int = 1
    # Fine remat: composite cells (AmoebaNet cells, ResNet branches) also
    # checkpoint each op inside them (``make_train_step(remat="fine")``,
    # ``MPI4DL_REMAT_OPS=1``; ``layer_ctx.py:116-121``).
    remat_ops: bool = False

    def with_spatial(self, spatial: Optional[SpatialCtx]) -> "ApplyCtx":
        return dataclasses.replace(self, spatial=spatial)


def spatial_ctx_for(slice_method: str, num_spatial_parts: int, tiles=None,
                    **kw) -> SpatialCtx:
    """The SpatialCtx of a (slice_method, num_spatial_parts) config
    (``layer_ctx.py:140-157``); ``tiles`` is the grid's backend, whose
    shape must match."""
    if slice_method == "vertical":
        sp = SpatialCtx(axis_w=AXIS_SPW, grid_w=num_spatial_parts, tiles=tiles, **kw)
    elif slice_method == "horizontal":
        sp = SpatialCtx(axis_h=AXIS_SPH, grid_h=num_spatial_parts, tiles=tiles, **kw)
    elif slice_method == "square":
        g = math.isqrt(num_spatial_parts)
        if g * g != num_spatial_parts:
            raise ValueError(
                f"square slicing needs a perfect-square part count, got {num_spatial_parts}"
            )
        sp = SpatialCtx(axis_h=AXIS_SPH, axis_w=AXIS_SPW, grid_h=g, grid_w=g,
                        tiles=tiles, **kw)
    else:
        raise ValueError(f"unknown slice_method {slice_method!r}")
    if tiles is not None and (tiles.grid_h, tiles.grid_w) != (sp.grid_h, sp.grid_w):
        raise ValueError(f"{slice_method} slicing of {num_spatial_parts} parts is a "
                         f"{sp.grid_h}x{sp.grid_w} grid, the tiles are "
                         f"{tiles.grid_h}x{tiles.grid_w}")
    return sp


def _level_grid(parts: int, gh0: int, gw0: int) -> tuple:
    """``parts`` tiles as a ``(gh, gw)`` grid inside the base ``(gh0,
    gw0)`` grid (gh | gh0, gw | gw0), the most square such factorization,
    ties to the wider W (``layer_ctx.py:154-172``)."""
    best = None
    for d in range(1, parts + 1):
        if parts % d:
            continue
        e = parts // d
        if gh0 % d == 0 and gw0 % e == 0:
            score = abs(d - e)
            if best is None or score < best[0]:
                best = (score, d, e)
    if best is None:
        raise ValueError(
            f"spatial level of {parts} tiles does not embed in the base "
            f"{gh0}x{gw0} grid: need a factorization gh*gw={parts} with "
            f"gh | {gh0} and gw | {gw0}"
        )
    return best[1], best[2]


def spatial_levels_for(slice_method: str, parts_list, tiles=None, **kw) -> list:
    """The per-level SpatialCtx chain of multi-level SP (``layer_ctx.py:
    175-202``; the reference's ``num_spatial_parts="4,2"``).  Level 0
    defines the tile grid; each later level is a coarser grid on the same
    ranks, its tiles replicated ``rep = base grid / level grid`` times, with
    ``tiles.level(...)`` as its backend.  Levels must not grow, and each
    must embed in the base grid."""
    parts_list = list(parts_list)
    base = spatial_ctx_for(slice_method, parts_list[0], tiles=tiles, **kw)
    out = [base]
    gh0, gw0 = base.grid_h, base.grid_w
    for p in parts_list[1:]:
        if p > parts_list[0]:
            raise ValueError(f"spatial levels must not grow: {p} > {parts_list[0]}")
        gh, gw = _level_grid(p, gh0, gw0)
        out.append(dataclasses.replace(
            base, grid_h=gh, grid_w=gw, rep_h=gh0 // gh, rep_w=gw0 // gw,
            tiles=None if tiles is None else tiles.level(gh, gw)))
    return out
