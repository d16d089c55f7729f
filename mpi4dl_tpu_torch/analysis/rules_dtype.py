"""Rule ``dtype-policy``: the port's fp32/bf16 policy, statically (answers
the JAX rule of the same name, ``mpi4dl_tpu/analysis/rules_dtype.py``).

Three checks, in ``ops/`` and ``parallel/`` for the first two:

1. ``torch.float64`` only where it follows an input's dtype.  The port keeps
   float64 exact for float64 inputs on purpose (the float64 references of
   its tests): such a site compares some ``.dtype`` in the same statement,
   as ``torch.float64 if any(t.dtype == torch.float64 for t in ts) else
   torch.float32`` does.  Any other float64 doubles memory and halves the
   card's rate behind the caller's back.  (The JAX rule bans float64
   outright: a TPU has no float64.)
2. ``torch.zeros/ones/empty/full/arange/tensor`` state ``dtype=``, and
   ``device=``: a dtype-less constructor takes the process's default dtype
   (int64 for ``arange``), and a device-less one lands on the host in the
   middle of a CUDA path.  The ``*_like`` forms follow their input and are
   not checked.
3. Functions named ``init`` build fp32 parameters: the storage dtype
   (``bf_16_all``) comes from ``config.ParallelConfig.param_dtype``.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from mpi4dl_tpu_torch.analysis.core import (
    Project,
    Rule,
    SourceFile,
    Violation,
    is_package_file,
    package_rel,
)

_CONSTRUCTORS = {f"torch.{n}" for n in ("zeros", "ones", "empty", "full", "arange", "tensor")}
_BAD_PARAM_DTYPES = {"bfloat16", "float16", "float64", "half", "double", "bf16"}
_HOT_DIRS = ("mpi4dl_tpu_torch/ops/", "mpi4dl_tpu_torch/parallel/")


class DtypePolicyRule(Rule):
    name = "dtype-policy"
    description = (
        "torch.float64 in ops/ and parallel/ only where it follows an input's "
        "dtype; constructors there state dtype= and device=; param init builds "
        "fp32."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.package_files():
            if (package_rel(src.rel) or "").startswith(_HOT_DIRS):
                out.extend(self._check_float64(src))
                out.extend(self._check_constructors(src))
            out.extend(self._check_param_init(src))
        return out

    def _check_float64(self, src: SourceFile) -> List[Violation]:
        parents: Dict[int, ast.stmt] = {}  # expression node -> its statement
        for stmt in ast.walk(src.tree):
            if isinstance(stmt, ast.stmt):
                for child in _expr_nodes(stmt):
                    parents[id(child)] = stmt
        out = []
        for node in src.nodes(ast.Attribute):
            if src.resolve(node) not in ("torch.float64", "torch.double"):
                continue
            stmt = parents.get(id(node))
            if stmt is not None and _compares_dtype(stmt):
                continue
            out.append(Violation(
                self.name, src.rel, node.lineno,
                "torch.float64 that does not follow an input's dtype in a hot path "
                "(ops/, parallel/) — state fp32, or derive it from the input "
                "(`... if x.dtype == torch.float64 else torch.float32`)",
            ))
        return out

    def _check_constructors(self, src: SourceFile) -> List[Violation]:
        out = []
        for node in src.nodes(ast.Call):
            resolved = src.resolve(node.func) or ""
            if resolved not in _CONSTRUCTORS:
                continue
            keys = {kw.arg for kw in node.keywords}
            if None in keys:
                continue  # **kwargs: not statically checkable
            missing = [k for k in ("dtype", "device") if k not in keys]
            if missing:
                out.append(Violation(
                    self.name, src.rel, node.lineno,
                    f"{resolved}() without {' or '.join(k + '=' for k in missing)} in a "
                    "hot path (ops/, parallel/): state them",
                ))
        return out

    def _check_param_init(self, src: SourceFile) -> List[Violation]:
        out = []
        for fnode in src.nodes(ast.FunctionDef):
            if fnode.name != "init":
                continue
            for node in ast.walk(fnode):
                if not isinstance(node, ast.Call):
                    continue
                resolved = src.resolve(node.func) or ""
                if not resolved.startswith("torch."):
                    continue
                for kw in node.keywords:
                    if kw.arg != "dtype":
                        continue
                    dt = kw.value
                    name = (dt.attr if isinstance(dt, ast.Attribute) else
                            dt.value if isinstance(dt, ast.Constant) else None)
                    if name in _BAD_PARAM_DTYPES:
                        out.append(Violation(
                            self.name, src.rel, node.lineno,
                            f"param init builds {name} — parameters are fp32 at init; "
                            "the storage dtype comes from config param_dtype",
                        ))
        return out


def _expr_nodes(stmt: ast.stmt):
    """The nodes of ``stmt`` outside its nested statements."""
    work = [c for c in ast.iter_child_nodes(stmt) if not isinstance(c, ast.stmt)]
    while work:
        node = work.pop()
        yield node
        work.extend(c for c in ast.iter_child_nodes(node) if not isinstance(c, ast.stmt))


def _compares_dtype(stmt: ast.stmt) -> bool:
    for node in _expr_nodes(stmt):
        if isinstance(node, ast.Compare):
            for side in [node.left, *node.comparators]:
                if isinstance(side, ast.Attribute) and side.attr == "dtype":
                    return True
    return False


RULE = DtypePolicyRule()
