"""Rule ``unquantized-collective``: collectives on the hot wire offer the
quantized path (answers the JAX rule of the same name,
``mpi4dl_tpu/analysis/rules_quant.py``, whose collectives are ``lax``'s).

The quantized collectives (``mpi4dl_tpu_torch/quant``) shrink the wire of
the junction, respatial, gradient and handoff collectives only while every
hot call site is routed through the quant layer: a refactor that brings
back a bare ``dist.all_gather`` under ``scope("junction_gather")`` silently
restores full-precision wire with no test failing.

Scope: ``mpi4dl_tpu_torch/parallel/`` (the engines).  A ``torch.distributed``
collective lexically inside ``with scope(<literal>)``, whose literal text
matches a pattern of ``quant/policy.py``'s ``HOT_SCOPE_PATTERNS`` (parsed
from its source, never imported), shares that with-block with a reference
to the quant layer: a name or attribute containing ``quant``.  The check is
per block, so a bare collective added to an already quant-aware function
still trips it.  Exact-by-design sites carry ``# analysis:
ok(unquantized-collective)`` with the reason.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from mpi4dl_tpu_torch.analysis.core import (
    PACKAGE,
    SCOPE_CALLEES,
    Project,
    Rule,
    SourceFile,
    Violation,
    dist_call,
    package_rel,
    with_spans,
)


def hot_patterns(project: Project) -> List["re.Pattern"]:
    """The regexes of ``HOT_SCOPE_PATTERNS`` in ``quant/policy.py``."""
    src = project.source(f"{PACKAGE}/quant/policy.py", f"{PACKAGE}.quant.policy")
    if src is None:
        return []
    for node in src.tree.body:
        if (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "HOT_SCOPE_PATTERNS" for t in node.targets)
                and isinstance(node.value, ast.Dict)):
            return [re.compile(v.args[0].value) for v in node.value.values
                    if isinstance(v, ast.Call) and v.args
                    and isinstance(v.args[0], ast.Constant)]
    return []


def _literal_text(node: ast.expr) -> Optional[str]:
    """A scope name's literal text: a str constant, or the constant parts of
    an f-string (every hot scope's class-deciding token is literal)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = [v.value for v in node.values
                 if isinstance(v, ast.Constant) and isinstance(v.value, str)]
        return "".join(parts) if parts else None
    return None


def _quant_lines(src: SourceFile) -> List[int]:
    lines = [n.lineno for n in src.nodes(ast.Name) if "quant" in n.id.lower()]
    lines += [n.lineno for n in src.nodes(ast.Attribute) if "quant" in n.attr.lower()]
    return lines


class UnquantizedCollectiveRule(Rule):
    name = "unquantized-collective"
    description = (
        "bare torch.distributed collective under a hot-wire obs scope (junction/"
        "respatial/grad_reduce/stats_reduce/handoff) with no quant-layer path in "
        "the block — route through mpi4dl_tpu_torch.quant or pragma an exact site."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        patterns = hot_patterns(project)
        if not patterns:
            return out
        for src in project.files:
            if not (package_rel(src.rel) or "").startswith(f"{PACKAGE}/parallel/"):
                continue
            hot = []
            for a, b, ctx in with_spans(src, SCOPE_CALLEES):
                name = _literal_text(ctx.args[0]) if ctx.args else None
                if name and any(p.search(name) for p in patterns):
                    hot.append((a, b, name))
            if not hot:
                continue
            quant = _quant_lines(src)
            for node in src.nodes(ast.Call):
                what = dist_call(src, node)
                if what is None:
                    continue
                # the innermost hot block around the call
                span = max(((a, b, n) for a, b, n in hot if a <= node.lineno <= b),
                           default=None)
                if span is None or any(span[0] <= ln <= span[1] for ln in quant):
                    continue
                out.append(Violation(
                    self.name, src.rel, node.lineno,
                    f"dist.{what} under hot scope {span[2]!r} with no quant-layer path "
                    "in the scope block — the quantized wire silently degrades; "
                    "route through mpi4dl_tpu_torch.quant or pragma a justified "
                    "exact site with `# analysis: ok(unquantized-collective)`",
                ))
        return out


RULE = UnquantizedCollectiveRule()
