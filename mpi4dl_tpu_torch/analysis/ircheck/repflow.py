"""Replication flow over one rank's eager step: ``wasted-wire`` (counterpart
of ``mpi4dl_tpu/analysis/ircheck/repflow.py``).

The abstract value of a tensor is the set of process groups (sorted global
ranks) along which it is provably identical on every member.  Values live
on storages (a view shares its base's), and the lattice only underclaims:

- a collective's output over group G carries G: an all-reduce or an
  all-gather adds G to its payload's set, a broadcast sets {G}; a receive,
  a reduce-scatter and an all-to-all leave their outputs per-rank (empty);
- an aten op whose tensor inputs all carry a group passes it on to its
  outputs (the intersection of its inputs' sets); a write into a tensor
  intersects with what the tensor held, so a partial write never mints
  replication;
- ``zeros``/``ones`` and their ``_like``/``new_`` forms carry every group;
  any other op with no tensor input carries the empty set (a constant made
  from a Python value may differ by rank);
- positional ops (``slice``, ``select``, ``narrow``, ``split``, ``index``,
  ``gather``, ...) carry the empty set: which piece a rank takes may depend
  on its rank, as ``axis_index`` dereplicates in the JAX lattice.  Other
  non-tensor arguments are taken to be the same on every member.

Each rank's flow runs alone, and a pipeline's ranks run different code
(stage 0 all-reduces a zero loss that the last stage fills), so a rank's
proof speaks only for itself: :meth:`ReplicationFlow.collective` marks an
all-reduce over G whose payload already carries G (or a group that
contains G) as a candidate, and :func:`wasted_wire` reports the k-th
collective on G only when every member marked its own k-th collective on G.
Then every member already holds the reduction's operand, and the wire moves
bytes to compute a value each member could compute alone.  The byte
estimate is the op's payload.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves

from mpi4dl_tpu_torch.analysis.ircheck import Finding

Group = Tuple[int, ...]
# ``None`` is the top of the lattice: identical on every group.
Value = Optional[FrozenSet[Group]]
EMPTY: Value = frozenset()

_CONSTANT_FILLS = {"zeros", "ones", "zeros_like", "ones_like", "new_zeros", "new_ones",
                   "zero_"}
_POSITIONAL = {"slice", "select", "narrow", "split", "split_with_sizes", "chunk",
               "unbind", "as_strided", "index", "index_select", "gather", "take",
               "diagonal", "unfold", "masked_select", "tensor_split", "unsafe_split",
               "unsafe_split_with_sizes", "slice_scatter", "select_scatter",
               "index_put", "index_put_", "index_copy", "index_copy_", "scatter",
               "scatter_", "scatter_add", "scatter_add_", "_unsafe_index",
               "_unsafe_index_put", "nonzero"}
_ALL_REDUCE = ("allreduce_", "allreduce_coalesced_")


def _meet(a: Value, b: Value) -> Value:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _covers(value: Value, group: Group) -> bool:
    """Whether ``value`` proves a tensor identical across ``group``."""
    if value is None:
        return True
    members = set(group)
    return any(members <= set(g) for g in value)


def _key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _whole(t: torch.Tensor) -> bool:
    """Whether ``t`` spans its whole storage."""
    return (t.is_contiguous() and t.storage_offset() == 0
            and t.numel() * t.element_size() == t.untyped_storage().nbytes())


class ReplicationFlow:
    """The abstract values of one rank's storages (module docstring)."""

    def __init__(self):
        # storage key -> (value, the storage, kept alive so the key is not
        # reused while the step runs)
        self._val: Dict[int, Tuple[Value, object]] = {}
        self.candidates: List[dict] = []  # records of covered all-reduces

    def value(self, t: torch.Tensor) -> Value:
        k = _key(t)
        e = self._val.get(k) if k is not None else None
        return e[0] if e is not None else EMPTY

    def set(self, t: torch.Tensor, v: Value) -> None:
        k = _key(t)
        if k is None:
            return
        if v == EMPTY:
            self._val.pop(k, None)
        else:
            self._val[k] = (v, t.untyped_storage())

    def op(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for i, a in enumerate(func._schema.arguments):
            info = a.alias_info
            if info is not None and info.is_write and i < len(args):
                outs += [t for t in tree_leaves(args[i]) if isinstance(t, torch.Tensor)]
        if not outs:
            return
        if name in _CONSTANT_FILLS:
            # A fill of part of a storage leaves the rest as it was.
            for t in outs:
                self.set(t, None if _whole(t) else self.value(t))
            return
        if name in _POSITIONAL or not ins:
            v: Value = EMPTY
        else:
            v = None
            for t in ins:
                v = _meet(v, self.value(t))
                if v == EMPTY:
                    break
        for t in outs:
            self.set(t, v)

    def payload_value(self, op: str, args) -> Value:
        """The payload's value before an all-reduce (the wasted-wire test)."""
        if op not in _ALL_REDUCE or not args:
            return EMPTY
        v: Value = None
        for t in tree_leaves(args[0]):
            if isinstance(t, torch.Tensor):
                v = _meet(v, self.value(t))
        return v

    def collective(self, rec: dict, op: str, args, before: Value) -> None:
        group: Group = tuple(rec["group"])
        first = [t for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor)] if args else []
        if op in _ALL_REDUCE:
            if group and _covers(before, group):
                self.candidates.append(rec)
            after = before if before is None else before | {group}
            for t in first:
                self.set(t, after)
        elif op in ("_allgather_base_", "allgather_into_tensor_coalesced_", "allgather_"):
            src = [t for t in tree_leaves(args[1]) if isinstance(t, torch.Tensor)]
            v: Value = None if src else EMPTY
            for t in src:
                v = _meet(v, self.value(t))
            after = v if v is None else v | {group}
            for t in first:
                self.set(t, after)
        elif op == "broadcast_":
            for t in first:
                self.set(t, frozenset({group}))
        elif op != "send":
            for t in first:
                self.set(t, EMPTY)



_P2P = ("send", "recv_", "recv_any_source_")


def wasted_wire(roles: Sequence[dict], family: str = "") -> List[Finding]:
    """``wasted-wire`` where every member of a group marked its k-th
    collective on the group (each role's ``wasted``: record indices)."""
    by_rank = {r["rank"]: r for r in roles}
    seqs: Dict[Tuple[int, ...], Dict[int, List[int]]] = {}
    for rank, role in by_rank.items():
        for i, rec in enumerate(role["records"]):
            if rec["op"] not in _P2P and rec["group"]:
                seqs.setdefault(tuple(rec["group"]), {}).setdefault(rank, []).append(i)
    out: List[Finding] = []
    for group, members in sorted(seqs.items()):
        ranks = [r for r in group if r in by_rank]
        if len(ranks) < len(group):
            continue  # a member not recorded proves nothing
        marked = {r: set(by_rank[r].get("wasted", ())) for r in ranks}
        for k, i in enumerate(members.get(ranks[0], [])):
            if all(k < len(members.get(r, [])) and members[r][k] in marked[r]
                   for r in ranks):
                rec = by_rank[ranks[0]]["records"][i]
                out.append(Finding(
                    kind="wasted-wire", scope=rec["scope"],
                    message=f"collective #{k} on group {list(group)} "
                            f"({rec['dim'] or 'no mesh dimension'}): {rec['op']} of a "
                            "payload already identical on every member",
                    family=family, bytes=rec["bytes"]))
    return out
