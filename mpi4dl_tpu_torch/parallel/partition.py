"""A model split into pipeline stages (counterpart of
``mpi4dl_tpu/parallel/partition.py``).

The JAX engine keeps each stage's parameters as one flat row of an ``[S,
Pmax]`` buffer so that heterogeneous stages fit one SPMD program.  Here a
stage is its slice of ``model.cells``, run as modules on the rank (or in
the process) that holds it, and each rank's optimizer holds its own
stage's parameters; no flat parameter buffer is needed.  Only the stage
handoff keeps ``TreePack``'s job: :func:`pack` lays a tuple activation
(AmoebaNet's ``(x, skip)``) out as one contiguous buffer for one send, and
:func:`unpack` reads it back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from mpi4dl_tpu_torch.cells import CellModel, checkpointed_apply, split_even
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx

# A boundary activation's shape: one shape, or a tuple of shapes for a tuple
# activation.
ActShape = Tuple


def _is_tuple_shape(shape: ActShape) -> bool:
    return len(shape) > 0 and isinstance(shape[0], tuple)


def act_shapes_of(shape: ActShape) -> List[Tuple[int, ...]]:
    return list(shape) if _is_tuple_shape(shape) else [shape]


def pack(act) -> torch.Tensor:
    """A (tuple) activation as one contiguous 1-D buffer."""
    if isinstance(act, tuple):
        return torch.cat([t.reshape(-1) for t in act])
    return act.reshape(-1).contiguous()


def unpack(buf: torch.Tensor, shape: ActShape):
    """The inverse of :func:`pack` for an activation of ``shape``."""
    if not _is_tuple_shape(shape):
        return buf.view(shape)
    out, off = [], 0
    for s in shape:
        n = 1
        for d in s:
            n *= d
        out.append(buf[off:off + n].view(s))
        off += n
    return tuple(out)


def numel(shape: ActShape) -> int:
    total = 0
    for s in act_shapes_of(shape):
        n = 1
        for d in s:
            n *= d
        total += n
    return total


@torch.no_grad()
def probe_cell(cell, x, ctx):
    """``cell(x, ctx)`` on the meta device, whatever device the cell's
    weights are on (no copy, no memory)."""
    tensors = {**dict(cell.named_parameters()), **dict(cell.named_buffers())}
    meta = {k: torch.empty_like(v, device="meta") for k, v in tensors.items()}
    return functional_call(cell, meta, (x, ctx), strict=False)


def _shape_of(act) -> ActShape:
    if isinstance(act, tuple):
        return tuple(tuple(t.shape) for t in act)
    return tuple(act.shape)


@dataclasses.dataclass
class StagePartition:
    """``model``'s cells in ``num_stages`` contiguous ranges (``ranges``),
    and the shape of each stage boundary for one micro-batch:
    ``act_shapes[s]`` enters stage ``s``, ``act_shapes[S]`` leaves the last
    one (``partition.py:138-253``)."""

    model: CellModel
    ranges: List[Tuple[int, int]]
    act_shapes: List[ActShape]

    @property
    def num_stages(self) -> int:
        return len(self.ranges)

    @classmethod
    def build(cls, model: CellModel, split_size: int, microbatch_shape,
              balance: Optional[Sequence[int]] = None) -> "StagePartition":
        """Cell ranges from ``split_even``/``balance``; boundary shapes from
        one forward of a micro-batch of ``microbatch_shape`` (a tuple of
        shapes for a tuple activation, as an SP x PP tail takes) on the
        meta device (the reference's two-phase shape probe,
        ``mp_pipeline.py:126-168``)."""
        ranges = split_even(len(model.cells), split_size, balance)
        if any(r1 <= r0 for r0, r1 in ranges):
            raise ValueError(f"{len(model.cells)} cells cannot fill {split_size} stages")
        shape = tuple(microbatch_shape)
        x = (tuple(torch.empty(s, device="meta") for s in shape)
             if _is_tuple_shape(shape) else torch.empty(shape, device="meta"))
        ctx = ApplyCtx(train=False)
        shapes = []
        for r0, r1 in ranges:
            shapes.append(_shape_of(x))
            for i in range(r0, r1):
                x = probe_cell(model.cells[i], x, ctx)
        shapes.append(_shape_of(x))
        return cls(model, ranges, shapes)

    def stage_params(self, s: int) -> List[torch.Tensor]:
        r0, r1 = self.ranges[s]
        return [p for cell in self.model.cells[r0:r1] for p in cell.parameters()
                if p.requires_grad]

    def apply(self, s: int, act, ctx: ApplyCtx, remat: bool = False):
        """Stage ``s``'s cells on ``act``; ``remat`` checkpoints the whole
        stage (the JAX engine's ``jax.checkpoint`` of a GPipe branch)."""
        r0, r1 = self.ranges[s]
        run = lambda a, c: self.model(a, c, start=r0, stop=r1)
        return checkpointed_apply(run, act, ctx) if remat else run(act, ctx)

    def release_others(self, local_stages: Sequence[int]) -> None:
        """Move the cells of every stage not in ``local_stages`` to the
        meta device: a rank keeps only its own stage's weights."""
        for s, (r0, r1) in enumerate(self.ranges):
            if s not in local_stages:
                for cell in self.model.cells[r0:r1]:
                    cell.to("meta")
