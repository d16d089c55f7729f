"""Rule ``env-hatch``: ``MPI4DL_*`` environment-hatch hygiene, both
directions against the port's own registry ``mpi4dl_tpu_torch/config.py``
``HATCHES`` (answers the JAX rule of the same name,
``mpi4dl_tpu/analysis/rules_env.py``; the registry is the port's, parsed
from its source):

- every environment *read* of an ``MPI4DL_*`` name references a declared
  hatch (an undeclared read is a knob nobody can discover);
- every declared hatch is read somewhere in the scanned tree (a dead flag
  documents behaviour the code no longer has).  Only on a scan that holds
  the registry itself: a partial scan trivially "never reads" every hatch.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from mpi4dl_tpu_torch.analysis.core import (
    Project,
    Rule,
    Violation,
    environ_reads,
    is_hatch_name,
)


class EnvHatchRule(Rule):
    name = "env-hatch"
    description = (
        "MPI4DL_* env reads must reference mpi4dl_tpu_torch/config.py HATCHES; "
        "every declared hatch must be read somewhere (dead-flag detection)."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        read_names: Set[str] = set()
        reads: List[Tuple[str, str, int]] = []
        for src in project.files:
            for name, line in environ_reads(src):
                if is_hatch_name(name):
                    read_names.add(name)
                    reads.append((name, src.rel, line))
        declared = project.hatches
        for name, rel, line in reads:
            if declared and name not in declared:
                out.append(Violation(
                    self.name, rel, line,
                    f"env hatch {name!r} is not declared in mpi4dl_tpu_torch/"
                    "config.py HATCHES (add a Hatch entry with a default and "
                    "one-line doc)",
                ))
        if not project.hatch_decl_in_scan:
            return out
        for name, decl_line in declared.items():
            if name not in read_names:
                out.append(Violation(
                    self.name, project.hatch_decl_path, decl_line,
                    f"declared hatch {name!r} is never read in the scanned tree "
                    "(dead flag — remove it or wire it up)",
                ))
        return out


RULE = EnvHatchRule()
