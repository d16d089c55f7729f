"""Rule ``unscoped-collective``: collectives in the communication layers run
under a named ``obs`` scope (answers the JAX rule of the same name,
``mpi4dl_tpu/analysis/rules_scope.py``, whose collectives are ``lax``'s).

The per-scope instruments (``obs/comm_stats.py``'s recorded collectives,
``obs/timeline.py``, ``obs/overlap.py``'s exposed-wire ledger) attribute a
collective to the scope open around it: one issued outside any scope lands
in the unattributed bucket and silently decays their coverage.

Scope: ``mpi4dl_tpu_torch/parallel/``, ``mpi4dl_tpu_torch/ops/`` and
``mpi4dl_tpu_torch/quant/collectives.py``.  A ``torch.distributed``
collective, or a ``batch_isend_irecv`` of ``P2POp``s, lies lexically inside
``with scope(...)`` (``mpi4dl_tpu_torch/obs/scopes.py``), or carries
``# analysis: ok(unscoped-collective)`` with a comment naming the caller's
scope that covers it.
"""

from __future__ import annotations

import ast
from typing import List

from mpi4dl_tpu_torch.analysis.core import (
    SCOPE_CALLEES,
    Project,
    Rule,
    Violation,
    dist_call,
    package_rel,
    with_spans,
)

_TARGETS = ("mpi4dl_tpu_torch/parallel/", "mpi4dl_tpu_torch/ops/",
            "mpi4dl_tpu_torch/quant/collectives.py")


def is_target(rel: str) -> bool:
    return (package_rel(rel) or "").startswith(_TARGETS)


class UnscopedCollectiveRule(Rule):
    name = "unscoped-collective"
    description = (
        "torch.distributed collective in parallel/, ops/ or quant/collectives.py "
        "without an enclosing obs scope — per-scope collective attribution loses "
        "it; wrap it in `with scope(...)` or pragma a caller-scoped helper."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.files:
            if not is_target(src.rel):
                continue
            spans = with_spans(src, SCOPE_CALLEES)
            for node in src.nodes(ast.Call):
                what = dist_call(src, node)
                if what is None or any(a <= node.lineno <= b for a, b, _ in spans):
                    continue
                out.append(Violation(
                    self.name, src.rel, node.lineno,
                    f"dist.{what} with no enclosing obs scope — wrap in `with "
                    "scope(name):` so collective attribution keeps its owner; "
                    "helpers covered by a caller's scope take `# analysis: "
                    "ok(unscoped-collective)`",
                ))
        return out


RULE = UnscopedCollectiveRule()
