"""The collectives a step issues (counterpart of ``mpi4dl_tpu/obs/
hlo_stats.py``).

The JAX package counts the collectives XLA scheduled in the compiled step.
An eager PyTorch step has no compiled program: every collective reaches the
dispatcher as a ``c10d::*`` op (``allreduce_``, ``send``, ``recv_``,
``_allgather_base_``, ...), on gloo, NCCL and the ``fake`` process group
alike, so :func:`recording_collectives` records them with a dispatch mode.
On the ``fake`` group (``torch.testing._internal.distributed.fake_pg``)
nothing moves, so a four-rank step is counted rank by rank in one CPU
process.

Each record holds the op, its class, its payload bytes, the ``obs.scope``
path open at its issue (:func:`~mpi4dl_tpu_torch.obs.scopes.current_path`),
whether it was posted async (``isend``/``irecv``/``batch_isend_irecv`` or
``async_op=True``; read from the calling ``torch.distributed`` function)
or sync, whether the payload is quantized (int8/uint8/fp8: the quant layer's
wire; its fp32 scales count as raw, as ``obs/overlap.py`` of the JAX package
counts them), its ``unit`` (the ops one ``batch_isend_irecv`` posts share a
unit: one NCCL launch) and whether it is ``counted``.

The classes are the JAX package's (:data:`COLLECTIVE_CLASSES`):
send/recv -> ``collective-permute``, ``all_reduce`` -> ``all-reduce``,
``all_gather`` -> ``all-gather``, ``reduce_scatter_tensor`` ->
``reduce-scatter``, ``all_to_all_single`` -> ``all-to-all``.  The bytes are
each op's OUTPUT, as ``hlo_collective_stats`` counts the result shape (an
all-reduce's buffer, an all-gather's gathered tensor, a reduce-scatter's
shard).  A send and its recv are one transfer: the RECEIVING side counts it,
as a collective-permute's output is what it receives; the send is recorded
with ``counted`` False.  Barriers and broadcasts are recorded and counted in
no class.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpi4dl_tpu_torch.obs import scopes

COLLECTIVE_CLASSES = (
    "collective-permute", "all-reduce", "all-gather", "reduce-scatter",
    "all-to-all",
)

# c10d op name -> class (None: recorded, in no class).
_CLASS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": None, "barrier": None, "reduce_": None, "gather_": None,
    "scatter_": None, "monitored_barrier_": None,
}
_ASYNC_CALLS = ("isend", "irecv", "batch_isend_irecv")
_QUANT_DTYPES = (torch.int8, torch.uint8, torch.float8_e4m3fn, torch.float8_e5m2)
_C10D_FILE = "distributed_c10d.py"


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _caller():
    """The outermost ``torch.distributed`` API frame on the stack (None when
    the op was dispatched directly)."""
    f, found = sys._getframe(2), None
    while f is not None:
        if f.f_code.co_filename.endswith(_C10D_FILE):
            found = f
        f = f.f_back
    return found


class CollectiveRecorder(TorchDispatchMode):
    """Records every ``c10d::*`` op dispatched inside it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.records: List[Dict[str, Any]] = []
        self._unit_frame = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            self._record(func._opname, args)
        return out

    def _record(self, op: str, args) -> None:
        cls = _CLASS.get(op)
        payload = _tensors(args[0]) if args else []
        frame = _caller()
        call = frame.f_code.co_name if frame is not None else ""
        is_async = call in _ASYNC_CALLS or bool(
            frame is not None and frame.f_locals.get("async_op"))
        # The ops one batch_isend_irecv posts are one launch.
        same = call == "batch_isend_irecv" and frame is self._unit_frame
        unit = self.records[-1]["unit"] if same and self.records else (
            self.records[-1]["unit"] + 1 if self.records else 0)
        self._unit_frame = frame if call == "batch_isend_irecv" else None
        rec = {
            "op": op, "cls": cls,
            "bytes": sum(t.numel() * t.element_size() for t in payload),
            "scope": scopes.current_path(), "async": is_async,
            "quantized": bool(payload) and all(t.dtype in _QUANT_DTYPES for t in payload),
            "unit": unit, "counted": cls is not None and op != "send",
        }
        self.records.append(rec)


@contextlib.contextmanager
def recording_collectives() -> Iterator[List[Dict[str, Any]]]:
    """Yield the list of the collectives issued inside the block (scope
    paths on: :func:`~mpi4dl_tpu_torch.obs.scopes.instrumenting`)."""
    rec = CollectiveRecorder()
    with scopes.instrumenting(), rec:
        yield rec.records


def collective_stats(records: List[Dict[str, Any]]) -> dict:
    """``hlo_collective_stats``'s schema over recorded collectives: per class
    ``{count, bytes}`` of the counted ops, ``total_count``, ``total_bytes``."""
    stats: Dict[str, Any] = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_CLASSES}
    for r in records:
        if r["counted"]:
            stats[r["cls"]]["count"] += 1
            stats[r["cls"]]["bytes"] += r["bytes"]
    stats["total_bytes"] = sum(stats[k]["bytes"] for k in COLLECTIVE_CLASSES)
    stats["total_count"] = sum(stats[k]["count"] for k in COLLECTIVE_CLASSES)
    return stats


def scope_collectives(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, int]]:
    """Per scope path: ``{collective_bytes, collective_count}`` of the
    counted ops (the timeline's collective column)."""
    out: Dict[str, Dict[str, int]] = {}
    for r in records:
        if r["counted"]:
            b = out.setdefault(r["scope"], {"collective_bytes": 0, "collective_count": 0})
            b["collective_bytes"] += r["bytes"]
            b["collective_count"] += 1
    return out


def launch_units(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The records grouped by launch unit, in issue order: ``{unit, ops,
    cls, bytes, quantized_bytes, scope, async}`` with the counted bytes
    summed over the unit (a ``batch_isend_irecv`` is one unit)."""
    units: Dict[int, Dict[str, Any]] = {}
    for r in records:
        u = units.get(r["unit"])
        if u is None:
            u = units[r["unit"]] = {"unit": r["unit"], "ops": [], "cls": r["cls"],
                                    "bytes": 0, "quantized_bytes": 0,
                                    "scope": r["scope"], "async": r["async"]}
        u["ops"].append(r["op"])
        if r["counted"]:
            u["bytes"] += r["bytes"]
            u["quantized_bytes"] += r["bytes"] if r["quantized"] else 0
            if u["cls"] is None:
                u["cls"] = r["cls"]
    return list(units.values())
