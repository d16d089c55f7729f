"""Halo (ghost-region) exchange between image tiles (counterpart of
``mpi4dl_tpu/ops/halo.py``).

A halo pull is a shift: my top halo is the previous tile's bottom rows,
my bottom halo the next tile's top rows; the tiles at the image border
receive zeros, which is zero padding of the global image.  Exchanging W
first (including the fresh halo columns) and then H carries the corner
data in two hops, so the 8-neighbour square exchange is 4 shifts.  The
shifts are the tile backend's (``parallel/tiles.py``) and differentiable:
the gradient of a halo read lands on the tile that owns the pixel.
Tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.obs.scopes import scope


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Halo widths for one spatial dim: (lo, hi) = rows pulled from the
    previous / next neighbour along the axis."""

    lo: int
    hi: int

    @classmethod
    def symmetric(cls, h: int) -> "HaloSpec":
        return cls(h, h)


def _pad_dim(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    pads = [0, 0] * (x.dim() - dim - 1) + [lo, hi]
    return F.pad(x, pads)


def halo_exchange_1d(x: torch.Tensor, dim: int, axis_name: str, n: int,
                     halo: HaloSpec, tiles) -> torch.Tensor:
    """Extend the local tile ``x`` along ``dim`` with ``halo.lo`` rows of the
    previous and ``halo.hi`` rows of the next tile on axis ``axis_name``
    (``n`` tiles); the outermost tiles' missing neighbours give zeros."""
    if (halo.lo == 0 and halo.hi == 0) or n == 1:
        if halo.lo == 0 and halo.hi == 0:
            return x
        return _pad_dim(x, dim, halo.lo, halo.hi)
    if max(halo.lo, halo.hi) > x.shape[dim]:
        raise ValueError(
            f"halo {max(halo.lo, halo.hi)} exceeds local tile extent "
            f"{x.shape[dim]} along dim {dim} (axis {axis_name!r}, {n} tiles): "
            "the spatial region reaches a resolution too small for this tile "
            "grid — reduce spatial_until, the tile count, or fused halo size."
        )
    with scope(f"halo_exchange_{axis_name}"):
        parts = []
        if halo.lo > 0:
            # my top halo = the previous tile's bottom rows
            parts.append(tiles.shift(x.narrow(dim, x.shape[dim] - halo.lo, halo.lo),
                                     axis_name, 1))
        parts.append(x)
        if halo.hi > 0:
            # my bottom halo = the next tile's top rows
            parts.append(tiles.shift(x.narrow(dim, 0, halo.hi), axis_name, -1))
        return torch.cat(parts, dim=dim)


def halo_exchange_2d(x: torch.Tensor, halo_h: HaloSpec, halo_w: HaloSpec,
                     axis_h: Optional[str], axis_w: Optional[str],
                     grid_h: int, grid_w: int, tiles,
                     h_dim: int = 1, w_dim: int = 2) -> torch.Tensor:
    """2-D halo exchange on an NHWC tile: W first, then H over the widened
    tile, which carries the corners.  A dim without an axis is zero-padded."""
    if axis_w is not None and (halo_w.lo or halo_w.hi):
        x = halo_exchange_1d(x, w_dim, axis_w, grid_w, halo_w, tiles)
    elif halo_w.lo or halo_w.hi:
        x = _pad_dim(x, w_dim, halo_w.lo, halo_w.hi)
    if axis_h is not None and (halo_h.lo or halo_h.hi):
        x = halo_exchange_1d(x, h_dim, axis_h, grid_h, halo_h, tiles)
    elif halo_h.lo or halo_h.hi:
        x = _pad_dim(x, h_dim, halo_h.lo, halo_h.hi)
    return x


def halo_exchange_with_mask(x: torch.Tensor, mask: torch.Tensor,
                            halo_h: HaloSpec, halo_w: HaloSpec,
                            axis_h: Optional[str], axis_w: Optional[str],
                            grid_h: int, grid_w: int,
                            tiles) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange ``x`` and a validity mask (ones over the tile) together:
    after the exchange the mask is 1 where a real pixel arrived and 0
    beyond the image border, which pools use for ``count_include_pad=False``
    divisors and −inf max padding."""
    def ex(t):
        return halo_exchange_2d(t, halo_h, halo_w, axis_h, axis_w, grid_h,
                                grid_w, tiles)

    return ex(x), ex(mask)
