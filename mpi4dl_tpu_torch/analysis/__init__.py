"""The port's source-level analyzer: an AST gate over ``mpi4dl_tpu_torch``
(counterpart of the source-level half of ``mpi4dl_tpu/analysis``).

Eleven rules retargeted at the port's PyTorch idiom: explicit process
groups, host syncs under autograd and checkpoints, the dtype policy, the
env-hatch registry (``mpi4dl_tpu_torch/config.py``), device work at import,
prints, swallowed exceptions, thread-shared state, scoped and quantized
collectives, and the kernel registry (``ops/kernel_registry.py``).  The
analyzed code is parsed, never imported.

Usage::

    python -m mpi4dl_tpu_torch.analysis              # the port's tree; exit 1 on findings
    python -m mpi4dl_tpu_torch.analysis --json some/file.py
    python -m mpi4dl_tpu_torch.analysis --rule host-sync --changed-only

Programmatic::

    from mpi4dl_tpu_torch.analysis import analyze_paths
    violations = analyze_paths(["mpi4dl_tpu_torch"])
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from mpi4dl_tpu_torch.analysis.core import (
    Project,
    Rule,
    Violation,
    apply_baseline,
    build_project,
    load_baseline,
    run_rules,
    stale_pragmas,
)
from mpi4dl_tpu_torch.analysis.rules import RULE_TABLE, RULES_BY_NAME

__all__ = [
    "Project",
    "Rule",
    "Violation",
    "RULE_TABLE",
    "RULES_BY_NAME",
    "analyze_paths",
    "apply_baseline",
    "build_project",
    "load_baseline",
    "run_rules",
    "stale_pragmas",
]


def analyze_paths(paths: Sequence[str], root: Optional[str] = None,
                  rules: Optional[Sequence[Rule]] = None) -> List[Violation]:
    project = build_project(paths, root=root)
    return run_rules(project, rules if rules is not None else RULE_TABLE)
