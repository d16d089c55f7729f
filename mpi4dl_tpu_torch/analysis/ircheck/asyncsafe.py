"""Async well-formedness of one rank's eager step (counterpart of
``mpi4dl_tpu/analysis/ircheck/asyncsafe.py``).

The JAX verifier pairs ``*-start``/``*-done`` halves in the scheduled HLO.
Here the halves are an async ``c10d`` op's post (``isend``, ``irecv``,
``batch_isend_irecv`` or ``async_op=True``: the records whose ``work`` is
set) and its handle's ``wait()``, which :func:`waits_reported` observes by
wrapping ``wait`` on ``torch.distributed.Work`` and each subclass that
defines its own (the ``fake`` group's ``FakeWork``):

- ``unwaited-async``: a handle the step never waited (the JAX
  ``unpaired-async``: the transfer's completion is never awaited);
- ``async-buffer-race``: between the post and the ``wait()``, an aten op
  that reads or writes the receive buffer of the op (its output, which the
  wire is still filling), or writes its send buffer (the JAX
  ``async-dma-race``'s two cases).  Buffers are compared by storage, so a
  view of a buffer counts as the buffer; storage identity needs real
  tensors, which is why the roles run on real CPU tensors.

Under NCCL's coalescing (``batch_isend_irecv`` on a group that coalesces)
the per-op handles are not the ones returned to the caller; the gate runs
on the ``fake`` group, which does not coalesce.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Set, Tuple

import torch
from torch.utils._pytree import tree_leaves

from mpi4dl_tpu_torch.analysis.ircheck import Finding
from mpi4dl_tpu_torch.obs.scopes import current_path

# Per async c10d op: (argument indices written by the wire, read by it).
_BUFFERS = {
    "send": ((), (0,)),
    "recv_": ((0,), ()),
    "recv_any_source_": ((0,), ()),
    "allreduce_": ((0,), (0,)),
    "allreduce_coalesced_": ((0,), (0,)),
    "_allgather_base_": ((0,), (1,)),
    "allgather_": ((0,), (1,)),
    "allgather_into_tensor_coalesced_": ((0,), (1,)),
    "_reduce_scatter_base_": ((0,), (1,)),
    "reduce_scatter_": ((0,), (1,)),
    "reduce_scatter_tensor_coalesced_": ((0,), (1,)),
    "alltoall_base_": ((0,), (1,)),
    "alltoall_": ((0,), (1,)),
    "broadcast_": ((0,), (0,)),
}


def _storages(obj) -> Set[int]:
    out = set()
    for t in tree_leaves(obj):
        if isinstance(t, torch.Tensor):
            try:
                out.add(t.untyped_storage()._cdata)
            except (RuntimeError, NotImplementedError):
                pass
    return out


@contextlib.contextmanager
def waits_reported(hook: Callable[[object], None]) -> Iterator[None]:
    """Call ``hook(work)`` on every ``Work.wait()`` inside the block."""
    from torch._C._distributed_c10d import Work

    classes = [Work]
    i = 0
    while i < len(classes):
        classes.extend(c for c in classes[i].__subclasses__() if c not in classes)
        i += 1
    saved = [(c, c.__dict__["wait"]) for c in classes if "wait" in c.__dict__]

    def wrap(orig):
        def wait(self, *args, **kwargs):
            hook(self)
            return orig(self, *args, **kwargs)
        return wait

    for c, orig in saved:
        c.wait = wrap(orig)
    try:
        yield
    finally:
        for c, orig in saved:
            c.wait = orig


class AsyncWatch:
    """Pending async ops of one rank and what touches their buffers.
    ``works`` is the recorder's list of handles (``obs.comm_stats``)."""

    def __init__(self, works: List[object]):
        self.works = works
        # work id -> (record, storages written by the wire, storages read)
        self.pending: Dict[int, Tuple[dict, Set[int], Set[int]]] = {}
        self.waited_ids: Set[int] = set()
        self._found: List[Tuple[str, str, str, int]] = []

    def posted(self, rec: dict, op: str, args) -> None:
        if rec["work"] is None:
            return
        written, read = _BUFFERS.get(op, ((0,), ()))
        self.pending[rec["work"]] = (
            rec, set().union(*(_storages(args[i]) for i in written if i < len(args))),
            set().union(*(_storages(args[i]) for i in read if i < len(args))))

    def waited(self, work) -> None:
        for i, w in enumerate(self.works):
            if w is work:
                self.waited_ids.add(i)
                self.pending.pop(i, None)

    def op(self, func, args, kwargs) -> None:
        if not self.pending:
            return
        touched = _storages((args, kwargs))
        writes = set()
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write and i < len(args):
                writes |= _storages(args[i])
        for rec, wired, sent in self.pending.values():
            if touched & wired:
                what = "reads or writes the buffer it is receiving into"
            elif writes & sent:
                what = "writes the buffer it is sending from"
            else:
                continue
            self._found.append((
                "async-buffer-race", current_path() or rec["scope"],
                f"{func._schema.name} {what}: {rec['op']} posted in scope "
                f"{rec['scope'] or '<unscoped>'} not yet waited", rec["bytes"]))

    def findings(self, family: str, rank: int) -> List[Finding]:
        out = [Finding(kind=k, scope=s, message=f"rank {rank}: {m}", family=family, bytes=b)
               for k, s, m, b in self._found]
        for i, (rec, _, _) in sorted(self.pending.items()):
            if i not in self.waited_ids:
                out.append(Finding(
                    kind="unwaited-async", scope=rec["scope"],
                    message=f"rank {rank}: {rec['op']} on group {rec['group']} "
                            f"(peer {rec['peer']}, tag {rec['tag']}) posted async and "
                            "never waited", family=family, bytes=rec["bytes"]))
        return out
