"""Cells: the unit of layer-parallel splitting (counterpart of
``mpi4dl_tpu/cells.py``).

A model is an ordered list of :class:`Cell` modules.  A cell's activation is
a tensor or a tuple of tensors (AmoebaNet cells carry ``(x, skip)``).  The
JAX package's boundary lane-packing (``cells.py:199-273``) is a TPU layout
trick with no effect on values and has no counterpart here.
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.layers import Layer
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.ops.d2 import maybe_run_d2, maybe_run_fused_unsharded
from mpi4dl_tpu_torch.ops.stripe_bwd import maybe_stripe_run


class Cell(nn.Module):
    """One splittable unit: ``forward(x, ctx)`` plus a human name."""

    def __init__(self, name: str = "cell"):
        super().__init__()
        self.name = name


class LayerCell(Cell):
    """A cell made of a plain sequence of layers (single-tensor state)."""

    def __init__(self, layers: Sequence[Layer], name: str = "seq"):
        super().__init__(name)
        self.layers = nn.ModuleList(layers)

    def forward(self, x, ctx: ApplyCtx):
        # D2, then the stripe-wise backward (ops/stripe_bwd.py), then the
        # unsharded K2 windows (cells.py:56-75).
        for run in (maybe_run_d2, maybe_stripe_run, maybe_run_fused_unsharded):
            y = run(self.layers, x, ctx)
            if y is not None:
                return y
        for layer in self.layers:
            x = layer(x, ctx)
        return x


class FnCell(Cell):
    """A cell defined by an explicit ``apply_fn(parts, x, ctx)`` over named
    submodules (residual blocks, heads...)."""

    def __init__(self, apply_fn: Callable, parts: Optional[dict] = None,
                 name: str = "fn"):
        super().__init__(name)
        self.apply_fn = apply_fn
        self.parts = nn.ModuleDict(parts or {})

    def forward(self, x, ctx: ApplyCtx):
        return self.apply_fn(self.parts, x, ctx)


def checkpointed_apply(fn: Callable, x, ctx: ApplyCtx):
    """``fn(x, ctx)`` under ``torch.utils.checkpoint``: the backward
    recomputes the activations instead of keeping them.  BatchNorm layers
    inside OVERWRITE their ``ctx.bn_sink`` entry, so the recompute leaves
    the running-statistics update as the forward wrote it (also when
    checkpoints nest, as under remat "sqrt" and "fine")."""
    return checkpoint(fn, x, ctx, use_reentrant=False)


class CellModel(nn.Module):
    """A model: ordered cells + metadata.  ``spatial_until`` is the number
    of leading cells that run under spatial sharding (0: unset, which the
    spatial engine reads as every cell but the head)."""

    def __init__(self, cells: List[Cell], in_shape: Tuple[int, ...],
                 num_classes: int, name: str = "model"):
        super().__init__()
        self.cells = nn.ModuleList(cells)
        self.in_shape = tuple(in_shape)
        self.num_classes = num_classes
        self.name = name
        self.spatial_until = 0

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every layer's init from ``generator``, in module order."""
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(generator)

    def forward(self, x, ctx: ApplyCtx, remat=False, start: int = 0,
                stop: Optional[int] = None):
        """Run cells [start, stop) (``cells.py:126-175``).  ``remat`` True,
        "cell" or "fine" checkpoints each cell ("fine" adds the per-op
        checkpoints of ``ctx.remat_ops``, which ``make_train_step`` sets);
        "sqrt" runs more than 3 cells in ~√n groups, each an outer
        checkpoint over per-cell inner ones, so that the backward holds the
        group boundaries and one group's cell boundaries
        (``MPI4DL_SQRT_GROUPS`` sets the group count)."""
        if remat not in (False, True, "cell", "fine", "sqrt"):
            raise ValueError(f"unknown remat level {remat!r}")
        stop = len(self.cells) if stop is None else stop
        if remat == "sqrt" and stop - start > 3:
            n = stop - start
            g = int(os.environ.get("MPI4DL_SQRT_GROUPS", "0")) or max(2, math.isqrt(n))
            for lo, hi in split_even(n, min(n, g)):
                x = checkpointed_apply(
                    lambda t, c, _lo=start + lo, _hi=start + hi: self._cells(
                        t, c, _lo, _hi, True), x, ctx)
            return x
        return self._cells(x, ctx, start, stop, bool(remat))

    def _cells(self, x, ctx: ApplyCtx, start: int, stop: int, remat: bool):
        for i in range(start, stop):
            cell = self.cells[i]
            with scope(f"cell{i:02d}"):
                x = checkpointed_apply(cell, x, ctx) if remat else cell(x, ctx)
        return x


def split_even(n_cells: int, split_size: int,
               balance: Optional[Sequence[int]] = None) -> List[Tuple[int, int]]:
    """Partition cell indices into ``split_size`` contiguous ranges: the
    remainder goes to the earliest stages; ``balance`` (per-stage counts
    summing to ``n_cells``) overrides."""
    if balance is not None:
        assert sum(balance) == n_cells, (balance, n_cells)
        out, start = [], 0
        for b in balance:
            out.append((start, start + b))
            start += b
        return out
    base, rem = divmod(n_cells, split_size)
    out, start = [], 0
    for s in range(split_size):
        size = base + (1 if s < rem else 0)
        out.append((start, start + size))
        start += size
    return out
