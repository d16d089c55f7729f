"""Rule ``collective-axis``: collectives name their group, group lookups
name a mesh group, and literal peer tables are bijections (answers the JAX
rule of the same name, ``mpi4dl_tpu/analysis/rules_collective.py``, which
checks the axis names of ``lax`` collectives and ``PartitionSpec``s).

The port has no axis names: a collective's reach is its process group.

(a) Every ``torch.distributed`` collective, ``dist.P2POp`` and
    ``dist.barrier`` in a package file (tools exempt) passes its group
    explicitly (``group=`` or positionally).  A missing group reduces
    silently over WORLD, the torch form of a typo'd axis name: the numbers
    are wrong only on meshes with more than one group.
    ``batch_isend_irecv`` carries its group in its ``P2POp``s.
(b) A string key that looks up a mesh group names one of the groups
    ``mesh.build_process_mesh`` creates (parsed from ``mesh.py``).  A table
    of mesh groups is a name that, in the same function, is stored into
    with a group (``dist.new_group(...)``, ``dist.group.WORLD``, or a name
    bound to one); its keys are checked in ``t[k]``, ``t.get(k)`` and
    ``k in t``.
(c) A literal peer table — the ``perm`` of ``quant.collectives.quantized_
    shift`` or any ``perm=`` keyword, a list of ``(src, dst)`` int pairs —
    is a bijection, as the JAX rule holds ``ppermute``'s.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from mpi4dl_tpu_torch.analysis.core import (
    DIST_COLLECTIVES,
    Project,
    Rule,
    SourceFile,
    Violation,
    dist_call,
    is_package_file,
)

_GROUP_MAKERS = {"torch.distributed.new_group", "torch.distributed.group.WORLD"}


class CollectiveAxisRule(Rule):
    name = "collective-axis"
    description = (
        "torch.distributed collectives/P2POp pass an explicit group; mesh-group "
        "lookups name a group of mesh.py; literal peer tables are bijections."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.files:
            if is_package_file(src.rel):
                out.extend(self._check_groups(src))
            if project.groups:
                out.extend(self._check_lookups(src, project))
            out.extend(self._check_perms(src))
        return out

    # -- (a) explicit groups ---------------------------------------------------
    def _check_groups(self, src: SourceFile) -> List[Violation]:
        out = []
        for node in src.nodes(ast.Call):
            resolved = src.resolve(node.func) or ""
            if resolved == "torch.distributed.P2POp":
                what, pos = "P2POp", 3
            else:
                what = dist_call(src, node)
                pos = DIST_COLLECTIVES.get(what) if what else None
                if pos is None:
                    continue
            if len(node.args) > pos or any(kw.arg == "group" for kw in node.keywords):
                continue
            if any(isinstance(a, ast.Starred) for a in node.args) or any(
                    kw.arg is None for kw in node.keywords):
                continue  # *args / **kwargs: not statically checkable
            out.append(Violation(
                self.name, src.rel, node.lineno,
                f"dist.{what} without an explicit group — it runs over WORLD, "
                "which differs from the intended group on any mesh with more than "
                "one group; pass group=",
            ))
        return out

    # -- (b) mesh-group lookups ------------------------------------------------
    def _check_lookups(self, src: SourceFile, project: Project) -> List[Violation]:
        out = []
        for fn in src.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            tables = _group_tables(src, fn)
            if not tables:
                continue
            for node in ast.walk(fn):
                key = table = None
                if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load)
                        and isinstance(node.value, ast.Name)):
                    table, key = node.value.id, node.slice
                elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                      and node.func.attr == "get" and isinstance(node.func.value, ast.Name)
                      and node.args):
                    table, key = node.func.value.id, node.args[0]
                elif (isinstance(node, ast.Compare) and len(node.ops) == 1
                      and isinstance(node.ops[0], (ast.In, ast.NotIn))
                      and isinstance(node.comparators[0], ast.Name)):
                    table, key = node.comparators[0].id, node.left
                if (table in tables and isinstance(key, ast.Constant)
                        and isinstance(key.value, str) and key.value not in project.groups):
                    out.append(Violation(
                        self.name, src.rel, node.lineno,
                        f"group {key.value!r} is not a mesh group "
                        f"{tuple(project.groups)}",
                    ))
        return out

    # -- (c) peer tables -------------------------------------------------------
    def _check_perms(self, src: SourceFile) -> List[Violation]:
        out = []
        for node in src.nodes(ast.Call):
            resolved = src.resolve(node.func) or ""
            perm = None
            if resolved.rsplit(".", 1)[-1] == "quantized_shift" and len(node.args) > 2:
                perm = node.args[2]
            for kw in node.keywords:
                if kw.arg == "perm":
                    perm = kw.value
            pairs = _literal_pairs(perm)
            if pairs is None:
                continue
            problems = []
            if len({p[0] for p in pairs}) != len(pairs):
                problems.append("duplicate sources")
            if len({p[1] for p in pairs}) != len(pairs):
                problems.append("duplicate destinations")
            if problems:
                out.append(Violation(
                    self.name, src.rel, node.lineno,
                    "literal peer table is not a bijection (" + ", ".join(problems)
                    + f"): {pairs}",
                ))
        return out


def _group_tables(src: SourceFile, fn: ast.AST) -> Set[str]:
    """Names in ``fn`` that are stored into with a process group."""
    groups: Set[str] = set()

    def is_group(v: ast.AST) -> bool:
        if isinstance(v, ast.Call):
            v = v.func
        if isinstance(v, ast.IfExp):
            return is_group(v.body) or is_group(v.orelse)
        return (src.resolve(v) or "") in _GROUP_MAKERS or (
            isinstance(v, ast.Name) and v.id in groups)

    assigns = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)),
                     key=lambda n: n.lineno)
    for node in assigns:
        if is_group(node.value):
            groups.update(t.id for t in node.targets if isinstance(t, ast.Name))
    tables: Set[str] = set()
    for node in assigns:
        if not is_group(node.value):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                tables.add(t.value.id)
    return tables


def _literal_pairs(node) -> Optional[list]:
    """[(src, dst), ...] when the table is fully literal, else None."""
    if not isinstance(node, (ast.List, ast.Tuple)):
        return None
    pairs = []
    for elt in node.elts:
        if not isinstance(elt, (ast.Tuple, ast.List)) or len(elt.elts) != 2:
            return None
        vals = []
        for item in elt.elts:
            if isinstance(item, ast.Constant) and isinstance(item.value, int):
                vals.append(item.value)
            else:
                return None
        pairs.append(tuple(vals))
    return pairs


RULE = CollectiveAxisRule()
