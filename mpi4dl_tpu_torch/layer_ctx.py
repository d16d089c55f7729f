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
    # Tiles per mesh-axis device; only multi-level SP (ROADMAP A11) sets
    # them above 1, so they stay 1 here.
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
    """

    train: bool = True
    spatial: Optional[SpatialCtx] = None
    bn_sink: Optional[dict] = None

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


def spatial_levels_for(slice_method: str, parts_list, tiles=None, **kw) -> list:
    """Per-level SpatialCtx chain (``layer_ctx.py:183-202``), for one level:
    multi-level SP (a ``4,2`` parts list) is ROADMAP A11."""
    parts_list = list(parts_list)
    if len(set(parts_list)) > 1:
        raise NotImplementedError(
            "multi-level spatial parallelism (a --num-spatial-parts list) is "
            "not ported to PyTorch yet (ROADMAP A11)"
        )
    return [spatial_ctx_for(slice_method, parts_list[0], tiles=tiles, **kw)]
