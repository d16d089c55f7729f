"""The cross-rank schedule: the port's form of the hang class.

The JAX verifier proves an SPMD program's collectives well-formed; a hang
on real interconnects follows from a divergent one.  An eager step is one
program a rank, so the port matches what every rank of a family issued:

- ``mismatched-collective``: the i-th collective (every non point-to-point
  op) on a group differs across its members in op, class, bytes, dtype or
  reduce op, or a member issues fewer; the first difference on each group
  is reported (later ones follow from it);
- ``unmatched-p2p``: point-to-point ops matched in per-pair FIFO order on
  (group, source, destination, tag), gloo's rule: a send no receive
  matches, or the reverse;
- ``p2p-size-mismatch``: a matched send and receive of different bytes;
- ``deadlock``: each rank's launch units in issue order (a
  ``batch_isend_irecv`` is one unit, every other op its own), each unit
  blocking until it completes, as the port's steps ``wait()`` every unit
  at once.  A unit completes once each of its point-to-point ops is
  matched by an op whose unit its peer has reached, and each of its
  collectives has been reached by every member of the group.  When no
  rank's unit can complete while units remain, the stuck ranks, their
  units and scopes are named.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from mpi4dl_tpu_torch.analysis.ircheck import Finding

_P2P = ("send", "recv_", "recv_any_source_")


def _signature(rec: dict) -> Tuple:
    return (rec["op"], rec["cls"], rec["bytes"], rec["dtype"], rec["reduce_op"])


def _describe(rec: dict) -> str:
    bits = [rec["op"], f"{rec['bytes']} B"]
    if rec["dtype"]:
        bits.append(rec["dtype"])
    if rec["reduce_op"]:
        bits.append(rec["reduce_op"])
    return " ".join(bits) + f" in {rec['scope'] or '<unscoped>'}"


def _units(role: dict) -> List[List[int]]:
    """Record indices of each launch unit, in issue order."""
    out: List[List[int]] = []
    last = None
    for i, rec in enumerate(role["records"]):
        if out and rec["unit"] == last:
            out[-1].append(i)
        else:
            out.append([i])
        last = rec["unit"]
    return out


def schedule_findings(roles: Sequence[dict], family: str = "") -> List[Finding]:
    out: List[Finding] = []
    by_rank = {r["rank"]: r for r in roles}
    unit_of: Dict[Tuple[int, int], int] = {}  # (rank, record) -> unit position
    for rank, role in by_rank.items():
        for u, idxs in enumerate(_units(role)):
            for i in idxs:
                unit_of[(rank, i)] = u

    # Collectives per group and member, in issue order.
    seqs: Dict[Tuple[int, ...], Dict[int, List[int]]] = {}
    for rank, role in by_rank.items():
        for i, rec in enumerate(role["records"]):
            if rec["op"] in _P2P or not rec["group"]:
                continue
            seqs.setdefault(tuple(rec["group"]), {}).setdefault(rank, []).append(i)
    for group, members in sorted(seqs.items()):
        ranks = [r for r in group if r in by_rank]
        n = max(len(members.get(r, [])) for r in ranks)
        for k in range(n):
            have = {r: by_rank[r]["records"][members[r][k]]
                    for r in ranks if k < len(members.get(r, []))}
            sigs = {_signature(rec) for rec in have.values()}
            if len(sigs) == 1 and len(have) == len(ranks):
                continue
            lines = [f"rank {r}: " + (_describe(have[r]) if r in have else "none")
                     for r in ranks]
            scope = next(iter(have.values()))["scope"]
            out.append(Finding(
                kind="mismatched-collective", scope=scope,
                message=f"collective #{k} on group {list(group)}: " + "; ".join(lines),
                family=family))
            break

    # Point-to-point matching in per-pair FIFO order.
    sends: Dict[Tuple, List[Tuple[int, int]]] = {}
    recvs: Dict[Tuple, List[Tuple[int, int]]] = {}
    for rank, role in by_rank.items():
        for i, rec in enumerate(role["records"]):
            if rec["op"] not in _P2P or rec["peer"] is None:
                continue
            if rec["op"] == "send":
                sends.setdefault((tuple(rec["group"]), rank, rec["peer"], rec["tag"]),
                                 []).append((rank, i))
            else:
                recvs.setdefault((tuple(rec["group"]), rec["peer"], rank, rec["tag"]),
                                 []).append((rank, i))
    partner: Dict[Tuple[int, int], Optional[Tuple[int, int]]] = {}
    for key in sorted(set(sends) | set(recvs), key=str):
        s_list, r_list = sends.get(key, []), recvs.get(key, [])
        group, src, dst, tag = key
        for j in range(max(len(s_list), len(r_list))):
            s = s_list[j] if j < len(s_list) else None
            r = r_list[j] if j < len(r_list) else None
            if s is not None:
                partner[s] = r
            if r is not None:
                partner[r] = s
            if s is None or r is None:
                here = s or r
                rec = by_rank[here[0]]["records"][here[1]]
                what = (f"rank {src} sends {rec['bytes']} B to rank {dst} that rank {dst} "
                        "never receives" if s is not None else
                        f"rank {dst} receives {rec['bytes']} B from rank {src} that rank "
                        f"{src} never sends")
                out.append(Finding(
                    kind="unmatched-p2p", scope=rec["scope"],
                    message=f"{what} (#{j} on group {list(group)}, tag {tag}; rank "
                            f"{here[0]}'s launch unit {unit_of[here]})",
                    family=family, bytes=rec["bytes"]))
                continue
            sb = by_rank[s[0]]["records"][s[1]]["bytes"]
            rr = by_rank[r[0]]["records"][r[1]]
            if sb != rr["bytes"]:
                out.append(Finding(
                    kind="p2p-size-mismatch", scope=rr["scope"],
                    message=f"rank {src} sends {sb} B to rank {dst}, which receives "
                            f"{rr['bytes']} B (#{j} on group {list(group)}, tag {tag})",
                    family=family, bytes=abs(sb - rr["bytes"])))

    out += _deadlocks(by_rank, seqs, partner, unit_of, family)
    return out


def _deadlocks(by_rank, seqs, partner, unit_of, family) -> List[Finding]:
    units = {rank: _units(role) for rank, role in by_rank.items()}
    # (rank, record) of a collective -> the unit each member issues its match in
    waits_on: Dict[Tuple[int, int], List[Tuple[int, Optional[int]]]] = {}
    for group, members in seqs.items():
        ranks = [r for r in group if r in by_rank]
        for r in ranks:
            for k, i in enumerate(members.get(r, [])):
                waits_on[(r, i)] = [
                    (m, unit_of[(m, members[m][k])] if k < len(members.get(m, [])) else None)
                    for m in ranks]
    pc = {rank: 0 for rank in by_rank}

    def done(rank: int) -> bool:
        for i in units[rank][pc[rank]]:
            rec = by_rank[rank]["records"][i]
            if rec["op"] in _P2P:
                p = partner.get((rank, i))
                if rec["peer"] is None or p is None or pc[p[0]] < unit_of[p]:
                    return False
            else:
                for m, u in waits_on.get((rank, i), ()):
                    if u is None or pc[m] < u:
                        return False
        return True

    moved = True
    while moved:
        moved = False
        for rank in pc:
            while pc[rank] < len(units[rank]) and done(rank):
                pc[rank] += 1
                moved = True
    stuck = [r for r in sorted(pc) if pc[r] < len(units[r])]
    if not stuck:
        return []
    parts = []
    for r in stuck:
        recs = [by_rank[r]["records"][i] for i in units[r][pc[r]]]
        ops = ", ".join(f"{x['op']}" + (f"->{x['peer']}" if x["op"] == "send" else
                                        f"<-{x['peer']}" if x["op"] in _P2P else "")
                        for x in recs)
        parts.append(f"rank {r} stuck at launch unit {pc[r]} of {len(units[r])} "
                     f"({ops}) in {recs[0]['scope'] or '<unscoped>'}")
    first = by_rank[stuck[0]]["records"][units[stuck[0]][pc[stuck[0]]][0]]
    return [Finding(kind="deadlock", scope=first["scope"],
                    message="no launch unit can complete: " + "; ".join(parts),
                    family=family)]
