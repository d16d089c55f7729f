"""The device mesh on ``torch.distributed`` (counterpart of
``mpi4dl_tpu/mesh.py``).

The JAX package names four mesh axes, ``(data, stage, sph, spw)``.  Here a
mesh is one process per card, the ranks laid out row-major over those axes
as ``np.array(devices).reshape(spec.shape)`` lays out the JAX mesh
(``mesh.py:90``): rank ``((d * stage + s) * sph + ih) * spw + iw``.
:func:`build_process_mesh` builds the process groups of this rank: its
tile grid (a :class:`~mpi4dl_tpu_torch.parallel.tiles.ProcessGroupTiles`),
its data axis, its stage chain, and the data x tile group over which the
spatial step reduces its gradients.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The ``data`` mesh axis as process groups: ``group`` holds the ranks
    that differ only in their data index (``size`` of them; this rank is
    ``index``), ``with_tiles`` the ranks of this stage over data and tiles
    and ``with_stages`` the ranks of this tile over data and stages (None
    when the tiles or the stages are not ranks).  The steps average
    gradients and running statistics over it."""

    group: object
    size: int
    index: int
    with_tiles: Optional[object] = None
    with_stages: Optional[object] = None


@dataclasses.dataclass
class ProcessMesh:
    """This rank's place in a :class:`MeshSpec` and its process groups
    (None where an axis has size 1)."""

    spec: MeshSpec
    tiles: Optional[ProcessGroupTiles]
    data: Optional[DataAxis]
    stage_group: object


def _groups(spec: MeshSpec, vary: Tuple[int, ...]):
    """Every group of ranks that differ only along the axes ``vary``
    (indices into ``spec.shape``), each a sorted rank list."""
    shape = spec.shape
    fixed = [a for a in range(4) if a not in vary]
    out = []
    for key in itertools.product(*(range(shape[a]) for a in fixed)):
        ranks = []
        for var in itertools.product(*(range(shape[a]) for a in vary)):
            c = [0] * 4
            for a, v in zip(fixed, key):
                c[a] = v
            for a, v in zip(vary, var):
                c[a] = v
            ranks.append(((c[0] * shape[1] + c[1]) * shape[2] + c[2]) * shape[3] + c[3])
        out.append(sorted(ranks))
    return out


# The process groups of a mesh, by dimension: the axes (of ``spec.shape``)
# along which a group's ranks differ.
GROUP_AXES = (("tiles", (2, 3)), ("data", (0,)), ("stage", (1,)),
              ("data_tiles", (0, 2, 3)), ("data_stage", (0, 1)))


def group_tables(spec: MeshSpec) -> Dict[str, List[List[int]]]:
    """Every rank's groups of ``spec`` by dimension, in the order
    :func:`build_process_mesh` creates them: ``{dim: [sorted ranks, ...]}``
    (a dimension of one rank a group lists one-rank groups)."""
    return {name: _groups(spec, vary) for name, vary in GROUP_AXES}


def build_process_mesh(spec: MeshSpec) -> ProcessMesh:
    """This rank's groups of ``spec`` over the default group, which must
    have exactly ``spec.size`` ranks.  Every rank creates every group in
    one order (``new_group``'s rule), and each group's first collective is
    a barrier of all its ranks, so that no later point-to-point batch opens
    it (NCCL asks that every rank of a group take part in its first
    collective)."""
    world = dist.get_world_size()
    if world != spec.size:
        raise ValueError(f"mesh {spec} needs {spec.size} ranks, the group has {world}")
    rank = dist.get_rank()
    d = rank // (spec.stage * spec.sph * spec.spw)
    mine = {}
    for name, groups in group_tables(spec).items():
        for ranks in groups:
            if len(ranks) == world:
                g = dist.group.WORLD
            elif len(ranks) > 1:
                g = dist.new_group(ranks)
            else:
                continue
            if rank in ranks:
                mine[name] = g
    for g in dict.fromkeys(mine.values()):
        dist.barrier(group=g)
    tiles = (ProcessGroupTiles(spec.sph, spec.spw, mine["tiles"])
             if "tiles" in mine else None)
    data = (DataAxis(mine["data"], spec.data, d,
                     mine.get("data_tiles") if tiles else None,
                     mine.get("data_stage") if "stage" in mine else None)
            if "data" in mine else None)
    return ProcessMesh(spec, tiles, data, mine.get("stage"))


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
