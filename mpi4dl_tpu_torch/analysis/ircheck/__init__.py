"""The cross-rank wire verifier (counterpart of ``mpi4dl_tpu/analysis/
ircheck``).

The JAX verifier reads one SPMD program: the closed jaxpr and the compiled
scheduled HLO.  An eager PyTorch step has neither: each rank runs its own
Python, and the wire is the sequence of ``c10d`` ops each rank issues.  So
the port verifies what every rank of a family issued in one step
(``contracts/engines.run_role``: each rank role on real CPU tensors on the
``fake`` process group, recorded by :func:`watching`), rank by rank and
across ranks.

Finding kinds (each has a violating fixture and a clean one in
``tests/test_torch_ircheck.py``):

- ``wasted-wire`` (repflow.py): an all-reduce whose payload is provably
  identical on every member of its group;
- ``nonbijective-perm`` (collectives.py): a launch unit that posts one
  edge twice with one tag (the JAX ``ppermute`` table's duplicate source or
  destination), or an index outside the group;
- ``mismatched-replica-groups`` (collectives.py): the mesh's group tables
  do not partition the ranks into equal disjoint groups, or two ranks built
  different tables;
- ``peer-out-of-group`` (collectives.py): a send or receive whose peer is
  not a member of the op's group, or is the rank itself;
- ``mismatched-collective`` (schedule.py): the i-th collective on a group
  differs across its members in class, bytes, dtype or reduce op (also the
  eager symptom of the JAX ``divergent-collective``: Python control flow is
  invisible, a rank that skips a collective shifts its sequence);
- ``unmatched-p2p`` / ``p2p-size-mismatch`` (schedule.py): a send with no
  receive or the reverse, matched in per-pair FIFO order (global source,
  destination, group and tag, gloo's rule); a matched pair whose bytes
  differ;
- ``deadlock`` (schedule.py): simulated; each stuck rank's launch unit and
  scope named;
- ``unwaited-async`` / ``async-buffer-race`` (asyncsafe.py): a work handle
  never waited; an aten op that consumes an async op's receive buffer, or
  writes its send buffer, between the post and the ``wait()``.

No eager counterpart: ``divergent-collective`` (above), and the HLO-only
``read-after-donate``, ``double-donation``, ``malformed-carry-alias`` and
``pallas-alias`` (:data:`NO_COUNTERPART`): an eager step donates no buffer,
carries no ``while`` alias and has no custom-call alias table.

Entry points: :func:`watching` (the per-rank recorder), :func:`check_roles`
(every check over a family's recorded roles), :func:`check_family`, and
``python -m mpi4dl_tpu_torch.analysis ircheck``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

FINDING_KINDS = (
    "wasted-wire",
    "nonbijective-perm",
    "mismatched-replica-groups",
    "peer-out-of-group",
    "mismatched-collective",
    "unmatched-p2p",
    "p2p-size-mismatch",
    "deadlock",
    "unwaited-async",
    "async-buffer-race",
)

# The JAX verifier's kinds that an eager step cannot show, and why.
NO_COUNTERPART = {
    "divergent-collective": "Python control flow is invisible to a dispatch "
                            "recorder; its symptom is mismatched-collective",
    "read-after-donate": "an eager step donates no buffer",
    "double-donation": "an eager step donates no buffer",
    "malformed-carry-alias": "an eager step has no while-loop carry",
    "pallas-alias": "the hand kernels take explicit output pointers; no "
                    "custom-call alias table exists",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One cross-rank verification failure, attributed to its obs.scope."""

    kind: str      # one of FINDING_KINDS
    scope: str     # owning obs.scope path ("" when unattributed)
    message: str
    family: str = ""   # engine family ("" for fixture runs)
    bytes: int = 0     # wasted or racing payload where meaningful

    @property
    def baseline_key(self) -> Tuple[str, str, str, str]:
        return (self.kind, self.family, self.scope, self.message)

    def render(self) -> str:
        where = f"{self.family}:" if self.family else ""
        scope = self.scope or "<unscoped>"
        tail = f" (~{self.bytes} bytes)" if self.bytes else ""
        return f"{where}{scope}: [{self.kind}] {self.message}{tail}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def finding_counts(findings) -> Dict[str, int]:
    """``{kind: count}`` (zero kinds omitted: a clean family pins ``{}``)."""
    out: Dict[str, int] = {}
    for f in findings:
        out[f.kind] = out.get(f.kind, 0) + 1
    return dict(sorted(out.items()))


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.kind, f.scope, f.message))


@contextlib.contextmanager
def watching(dims: Optional[Dict[Tuple[int, ...], str]] = None) -> Iterator["StepWatch"]:
    """Record one rank's collectives (``obs.comm_stats`` records), the scope
    paths it opens, the replication flow of its tensors and its async
    handles for the block.  Once the block has ended,
    ``watch.findings(family, rank)`` returns the rank-local findings
    (``unwaited-async``, ``async-buffer-race``) and ``watch.wasted()`` the
    records repflow marked (``wasted-wire`` needs every member's mark)."""
    from mpi4dl_tpu_torch.analysis.ircheck.asyncsafe import waits_reported
    from mpi4dl_tpu_torch.obs import scopes

    watch = _watch_class()(dims)
    with scopes.instrumenting(), scopes.recording_paths() as paths, \
            waits_reported(watch.asyncs.waited), watch:
        yield watch
    watch.paths = sorted(paths)


def _watch_class():
    from mpi4dl_tpu_torch.analysis.ircheck.asyncsafe import AsyncWatch
    from mpi4dl_tpu_torch.analysis.ircheck.repflow import ReplicationFlow
    from mpi4dl_tpu_torch.obs.comm_stats import CollectiveRecorder

    class StepWatch(CollectiveRecorder):
        """The recorder plus the replication flow and the async watch."""

        def __init__(self, dims):
            super().__init__(dims)
            self.flow = ReplicationFlow()
            self.asyncs = AsyncWatch(self.works)
            self.paths: List[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace == "c10d":
                before = self.flow.payload_value(func._opname, args)
                out = func(*args, **kwargs)
                rec = self._record(func._opname, args, out)
                self.flow.collective(rec, func._opname, args, before)
                self.asyncs.posted(rec, func._opname, args)
                return out
            self.asyncs.op(func, args, kwargs)
            out = func(*args, **kwargs)
            self.flow.op(func, args, kwargs, out)
            return out

        def findings(self, family: str = "", rank: int = 0) -> List[Finding]:
            """The rank-local findings (the async checks)."""
            return sort_findings(self.asyncs.findings(family, rank))

        def wasted(self) -> List[int]:
            """Indices of the records repflow marked (``wasted_wire``)."""
            marked = {id(r) for r in self.flow.candidates}
            return [i for i, r in enumerate(self.records) if id(r) in marked]

    return StepWatch


def check_roles(roles: Sequence[dict], family: str = "") -> List[Finding]:
    """Every check over a family's recorded roles (``engines.run_role``
    dicts, one per rank): the rank-local findings each role carries, then
    the group tables, the peers and the cross-rank schedule."""
    from mpi4dl_tpu_torch.analysis.ircheck.collectives import collective_findings
    from mpi4dl_tpu_torch.analysis.ircheck.repflow import wasted_wire
    from mpi4dl_tpu_torch.analysis.ircheck.schedule import schedule_findings

    out = [Finding(**f) for r in roles for f in r.get("findings", ())]
    out += wasted_wire(roles, family)
    out += collective_findings(roles, family)
    out += schedule_findings(roles, family)
    return sort_findings(out)


def check_family(family: str, quant: Optional[str] = None, roles=None,
                 jobs: Optional[int] = None) -> List[Finding]:
    """Run every rank role of ``family`` (``engines.extract_roles``; the
    ``quant`` spec as the runners' ``--quant``) and every check over them.
    ``roles`` skips the runs (the contract gate passes the roles it
    extracted)."""
    if roles is None:
        from mpi4dl_tpu_torch.analysis.contracts.engines import extract_roles

        roles = extract_roles(family, quant=quant, jobs=jobs)
    return check_roles(roles, family)
