"""The device mesh on ``torch.distributed`` (counterpart of
``mpi4dl_tpu/mesh.py``).

The JAX package names four mesh axes, ``(data, stage, sph, spw)``.  Here a
mesh is a process group with one process per card: the spatial axes
``sph``/``spw`` become a :class:`~mpi4dl_tpu_torch.parallel.tiles.ProcessGroupTiles`
grid, rank ``r`` holding tile ``(r // spw, r % spw)``.  The ``data`` and
``stage`` axes stay 1 in this port (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Tuple

import torch
import torch.distributed as dist

from mpi4dl_tpu_torch.parallel.tiles import ProcessGroupTiles


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    stage: int = 1
    sph: int = 1
    spw: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.stage, self.sph, self.spw)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @classmethod
    def from_config(cls, cfg) -> "MeshSpec":
        """The mesh of a config (``mesh.py:61-76``): the spatial region's
        ``num_spatial_parts`` tiles as a square, a column or a row."""
        parts = cfg.spatial_part_size
        if cfg.spatial_size > 0 and parts > 1:
            if cfg.slice_method == "square":
                g = math.isqrt(parts)
                sph, spw = g, g
            elif cfg.slice_method == "vertical":
                sph, spw = 1, parts
            else:
                sph, spw = parts, 1
        else:
            sph, spw = 1, 1
        return cls(data=cfg.data_parallel, stage=cfg.split_size, sph=sph, spw=spw)


def build_mesh(spec: MeshSpec, group=None) -> ProcessGroupTiles:
    """The tile grid of ``spec`` over ``group`` (default: every rank), one
    tile per rank.  Raises unless the group has exactly ``spec.size``
    ranks; the first collective on the group is a barrier, so that later
    point-to-point batches never open it (NCCL asks that every rank take
    part in a group's first collective)."""
    if spec.data != 1 or spec.stage != 1:
        raise NotImplementedError(
            "data and stage mesh axes are not ported to PyTorch yet (ROADMAP A7)"
        )
    tiles = ProcessGroupTiles(spec.sph, spec.spw, group)
    dist.barrier(group=tiles.group)
    return tiles


def initialize_distributed(backend=None, timeout_s: float = 600.0) -> int:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks
    the card).  ``backend`` defaults to NCCL when CUDA is available, else
    gloo.  Returns the rank; a second call is a no-op.  Raises when the
    environment names no process group."""
    if dist.is_initialized():
        return dist.get_rank()
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"no process group: {', '.join(missing)} unset (run under torchrun)"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_rank()
