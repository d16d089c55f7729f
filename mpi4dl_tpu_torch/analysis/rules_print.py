"""Rule ``print-call``: no bare ``print()`` in the port's library modules
(answers the JAX rule of the same name, ``mpi4dl_tpu/analysis/rules_print.py``).

Library output goes through the obs subsystem (``mpi4dl_tpu_torch/obs``:
RunLog records, scopes) or ``logging``: a ``print`` in library code is
output nobody can route, filter or parse.

Scope: package files (``core.is_package_file``: ``mpi4dl_tpu_torch/``
minus its tools, ``benchmarks/`` and ``bench.py``, whose product is their
output — the JAX package keeps its tools outside the package, so the JAX
rule exempts them by where they live).  Also exempt: ``__main__.py``
modules, command-line entry points whose product is stdout, and lines or
functions carrying ``# analysis: ok(print-call)``.
"""

from __future__ import annotations

import ast
from typing import List

from mpi4dl_tpu_torch.analysis.core import Project, Rule, Violation


class PrintCallRule(Rule):
    name = "print-call"
    description = (
        "bare print() in a mpi4dl_tpu_torch/ library module — emit through obs "
        "(RunLog) or logging; __main__.py CLIs and the tools are exempt."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.package_files():
            if src.rel.endswith("__main__.py"):
                continue
            for node in src.nodes(ast.Call):
                if (isinstance(node.func, ast.Name) and node.func.id == "print"
                        # a locally bound `print` (alias or parameter) is not builtin
                        and src.aliases.get("print", "print") == "print"):
                    out.append(Violation(
                        self.name, src.rel, node.lineno,
                        "bare print() in library module — route output through "
                        "mpi4dl_tpu_torch.obs (RunLog) or logging (tools and "
                        "__main__ CLIs are exempt)",
                    ))
        return out


RULE = PrintCallRule()
