"""Group tables and peers (counterpart of ``mpi4dl_tpu/analysis/ircheck/
collectives.py``).

:func:`_perm_problems` and :func:`_group_problems` are the JAX verifier's
pure proofs (``collectives.py:46-98`` there), copied so the port imports
nothing of the JAX package; ``tests/test_torch_ircheck.py`` holds them to
the JAX functions on the same tables.  Here they run over:

- ``nonbijective-perm``: each launch unit's point-to-point ops on one group
  and tag, as a ``(src, dst)`` table of group ranks (a send from this rank
  to its peer, a receive from the peer to this rank), split by the shift
  ``dst - src`` so that a unit posting several shifts (a send left and a
  send right) is several tables: a duplicate source in a table is one edge
  posted twice with one tag, which a receiver cannot tell apart (gloo
  matches by tag, NCCL by order);
- ``mismatched-replica-groups``: each rank's mesh group tables
  (``mesh.group_tables``), which must partition the ranks into equal
  disjoint groups and agree across ranks (every rank creates every group,
  ``new_group``'s rule);
- ``peer-out-of-group``: a peer that is not a member of the op's group, or
  is the rank itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from mpi4dl_tpu_torch.analysis.ircheck import Finding


def _perm_problems(perm: Sequence[Tuple[int, int]],
                   size: Optional[int]) -> List[str]:
    """Why ``perm`` is not an injective partial permutation of
    ``range(size)`` (empty list = it is).  ``size=None`` skips the range
    check."""
    problems: List[str] = []
    srcs = [int(s) for s, _ in perm]
    dsts = [int(d) for _, d in perm]
    dup_src = sorted({s for s in srcs if srcs.count(s) > 1})
    dup_dst = sorted({d for d in dsts if dsts.count(d) > 1})
    if dup_src:
        problems.append(f"duplicate source shard(s) {dup_src}")
    if dup_dst:
        problems.append(f"duplicate destination shard(s) {dup_dst}")
    if size is not None:
        oob = sorted({i for i in srcs + dsts if i < 0 or i >= size})
        if oob:
            problems.append(
                f"shard index(es) {oob} out of range for axis size {size}"
            )
    return problems


def _group_problems(groups: Sequence[Sequence[int]],
                    size: Optional[int]) -> List[str]:
    """Why ``groups`` is not an equal-sized disjoint partition-style group
    set over ``range(size)`` (empty list = consistent)."""
    problems: List[str] = []
    if not groups:
        return problems
    lens = {len(g) for g in groups}
    if len(lens) > 1:
        problems.append(f"unequal group sizes {sorted(lens)}")
    flat = [int(i) for g in groups for i in g]
    dup = sorted({i for i in flat if flat.count(i) > 1})
    if dup:
        problems.append(f"shard(s) {dup} appear in more than one group")
    if size is not None:
        oob = sorted({i for i in flat if i < 0 or i >= size})
        if oob:
            problems.append(
                f"shard index(es) {oob} out of range for {size} participants"
            )
        if not dup and not oob and len(lens) == 1 and len(flat) != size:
            problems.append(
                f"groups cover {len(flat)} of {size} participants"
            )
    return problems


def _p2p(rec: dict) -> bool:
    return rec["op"] in ("send", "recv_") and rec["peer"] is not None


def collective_findings(roles: Sequence[dict], family: str = "") -> List[Finding]:
    out: List[Finding] = []
    first = roles[0] if roles else None
    for role in roles:
        rank, world = role["rank"], role["world"]
        for dim, groups in sorted(role["groups"].items()):
            for problem in _group_problems(groups, world):
                out.append(Finding(
                    kind="mismatched-replica-groups", scope="",
                    message=f"rank {rank}: mesh dimension {dim}: groups {problem}",
                    family=family))
            if first is not None and groups != first["groups"].get(dim):
                out.append(Finding(
                    kind="mismatched-replica-groups", scope="",
                    message=f"rank {rank}'s {dim} groups {groups} differ from rank "
                            f"{first['rank']}'s {first['groups'].get(dim)}",
                    family=family))
        units: Dict[Tuple[int, Tuple[int, ...], Optional[int]], List[dict]] = {}
        for rec in role["records"]:
            if not _p2p(rec):
                continue
            group = list(rec["group"])
            if rec["peer"] == rank or rec["peer"] not in group:
                why = "is the rank itself" if rec["peer"] == rank else \
                    f"is not a member of the op's group {group}"
                out.append(Finding(
                    kind="peer-out-of-group", scope=rec["scope"],
                    message=f"rank {rank}: {rec['op']} with peer {rec['peer']} (tag "
                            f"{rec['tag']}), which {why}",
                    family=family, bytes=rec["bytes"]))
                continue
            units.setdefault((rec["unit"], tuple(group), rec["tag"]), []).append(rec)
        for (unit, group, tag), recs in sorted(units.items()):
            if rank not in group:
                continue
            me, size = group.index(rank), len(group)
            shifts: Dict[int, List[Tuple[int, int]]] = {}
            for rec in recs:
                peer = group.index(rec["peer"])
                pair = (me, peer) if rec["op"] == "send" else (peer, me)
                shifts.setdefault((pair[1] - pair[0]) % size, []).append(pair)
            for shift, pairs in sorted(shifts.items()):
                for problem in _perm_problems(pairs, size):
                    out.append(Finding(
                        kind="nonbijective-perm", scope=recs[0]["scope"],
                        message=f"rank {rank}: launch unit {unit} on group {list(group)} "
                                f"tag {tag}, shift {shift}: {problem} (pairs {pairs})",
                        family=family))
    return out
