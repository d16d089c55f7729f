"""Slice allocator (counterpart of ``mpi4dl_tpu/resilience/allocator.py``):
bin-pack prioritized jobs onto a shared device pool.

The fleet scheduler treats the pool as a flat list of device positions and
carves it into per-job **slices**.  Packing is the JAX package's
deterministic first-fit-decreasing:

- requests sort by (priority desc, demand desc, id) — high-priority jobs
  pick first, and among equals the bigger job goes first so fragmentation
  hits the small jobs that can still fit in the gaps;
- a request takes the lowest-numbered free devices (stable slice ids make
  the fleet RunLog readable and the drills reproducible);
- ``keep`` preserves existing placements whose devices all survived a pool
  shrink — a job whose slice lost devices is *displaced* and must re-pack.

The port's own point is what a slice means to a leg
(:func:`slice_env`): on cards a position is an index into the cards the
scheduler itself sees, and every rank of the leg sees exactly the slice's
cards through ``CUDA_VISIBLE_DEVICES`` (rank r takes the slice's card r
through ``LOCAL_RANK``); on the CPU a slice is a count of gloo ranks.
Both set ``MPI4DL_FLEET_SLICE_DEVICES`` to the slice's size, which the leg
launcher holds the leg's rank count to.

Pure data and functions, no threads and no CUDA: the scheduler serializes
all calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Slice:
    """One job's share of the pool: a fixed tuple of device indices."""

    devices: Tuple[int, ...]

    def __len__(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        d = self.devices
        if d and d == tuple(range(d[0], d[0] + len(d))):
            return f"[{d[0]}-{d[-1]}]" if len(d) > 1 else f"[{d[0]}]"
        return "[" + ",".join(str(i) for i in d) + "]"


@dataclasses.dataclass(frozen=True)
class Request:
    """One job's demand on the pool."""

    id: str
    devices: int
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class PackResult:
    """One deterministic packing: who got which slice, who did not fit,
    and what remains free."""

    placed: Dict[str, Slice]
    unplaced: List[str]
    free: Tuple[int, ...]


def pack(requests: Sequence[Request], pool: Sequence[int],
         keep: Optional[Mapping[str, Slice]] = None) -> PackResult:
    """First-fit-decreasing bin-pack of ``requests`` onto ``pool``.

    ``keep`` placements are honored verbatim when every kept device is
    still in the pool AND the kept job is among the requests; a kept slice
    with vanished devices is dropped (the job re-packs like a new arrival).
    Raises ``ValueError`` on duplicate request ids or non-positive demands:
    a malformed fleet spec is a bug, not a scheduling outcome."""
    pool_set = set(int(d) for d in pool)
    ids = [r.id for r in requests]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate request ids in {sorted(ids)}")
    for r in requests:
        if r.devices <= 0:
            raise ValueError(f"request {r.id!r}: demand must be positive, "
                             f"got {r.devices}")

    placed: Dict[str, Slice] = {}
    taken: set = set()
    for rid, sl in (keep or {}).items():
        if rid in set(ids) and all(d in pool_set for d in sl.devices):
            placed[rid] = sl
            taken |= set(sl.devices)

    order = sorted(
        (r for r in requests if r.id not in placed),
        key=lambda r: (-r.priority, -r.devices, r.id),
    )
    unplaced: List[str] = []
    for r in order:
        avail = sorted(pool_set - taken)
        if len(avail) < r.devices:
            unplaced.append(r.id)
            continue
        sl = Slice(tuple(avail[: r.devices]))
        placed[r.id] = sl
        taken |= set(sl.devices)
    return PackResult(placed=placed, unplaced=unplaced,
                      free=tuple(sorted(pool_set - taken)))


def slice_env(sl: Slice, device: str = "cuda",
              cards: Sequence[str] = ()) -> Dict[str, str]:
    """The environment a leg on ``sl`` runs under.

    On cards (``device="cuda"``) ``CUDA_VISIBLE_DEVICES`` lists the
    visible ``cards`` of the scheduler's process at the slice's positions
    (:func:`~mpi4dl_tpu_torch.resilience.fleet.visible_cards`): a parent
    ``CUDA_VISIBLE_DEVICES=4,5,6,7`` and slice ``(2, 3)`` give ``6,7``.  On
    the CPU no ``CUDA_VISIBLE_DEVICES`` is set.  Both set
    ``MPI4DL_FLEET_SLICE_DEVICES`` to the slice's size."""
    env = {"MPI4DL_FLEET_SLICE_DEVICES": str(len(sl))}
    if device != "cpu":
        if max(sl.devices, default=-1) >= len(cards):
            raise ValueError(f"slice {sl.describe()} lies outside the "
                             f"{len(cards)} visible cards {list(cards)}")
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(cards[d]) for d in sl.devices)
    return env
