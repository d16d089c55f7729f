"""Apply-time context threading for layers (counterpart of
``mpi4dl_tpu/layer_ctx.py``).

One model definition serves every execution mode: layers read an
:class:`ApplyCtx` in ``forward`` and choose their behaviour from it.  This
slice runs on one device, so :attr:`SpatialCtx.active` is always False here;
the sharding fields are kept because the single-device fused path reuses the
premargin machinery of the D2 engine (``ops/d2.py``), which reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpatialCtx:
    """How the image dims are sharded, plus the fused-kernel knob.

    ``axis_h``/``axis_w`` name the process-group axes sharding H and W, or
    are None when the dim is unsharded (always None in this slice).
    """

    axis_h: Optional[str] = None
    axis_w: Optional[str] = None
    grid_h: int = 1
    grid_w: int = 1
    # Set by the premargin run for the layers inside a run whose margin
    # is already present: convs run VALID on the sharded dims.
    halo_pre_exchanged: bool = False
    # The margin (per sharded dim) the activation still carries inside such
    # a run; BatchNorm excludes it from its statistics.
    pre_margin_h: int = 0
    pre_margin_w: int = 0
    # Route stride-1 convs and [ReLU, Conv2d, BatchNorm] windows through the
    # hand-written halo-conv kernels (ops/halo_conv.py).
    use_pallas_conv: bool = False

    @property
    def active(self) -> bool:
        return (self.axis_h is not None and self.grid_h > 1) or (
            self.axis_w is not None and self.grid_w > 1
        )


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

