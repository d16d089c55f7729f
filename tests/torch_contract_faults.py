"""Faults the port's contract tests seed into a contract family's step.

A role process imports this module by name (``contracts/engines.run_role``'s
``inject``), so it imports nothing but the port and torch.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


@contextlib.contextmanager
def extra_halo_all_gather():
    """Every halo shift of a tile grid also all-gathers its payload over the
    grid's group (under the exchange's own scope, ``halo_exchange_spw``)."""
    from mpi4dl_tpu_torch.parallel.tiles import ProcessGroupTiles

    orig = ProcessGroupTiles._p2p_shift

    def shift(self, x, axis, step):
        out = orig(self, x, axis, step)
        flat = x.contiguous().reshape(-1)
        gathered = torch.empty(flat.numel() * dist.get_world_size(self.group),
                               dtype=flat.dtype)
        dist.all_gather_into_tensor(gathered, flat, group=self.group)
        return out

    ProcessGroupTiles._p2p_shift = shift
    try:
        yield
    finally:
        ProcessGroupTiles._p2p_shift = orig
