"""The Hopper kernel certifier over the kernel registry (counterpart of
``mpi4dl_tpu/analysis/pallascheck``).

The JAX certifier traces every Pallas kernel in its registry and proves
its grid, VMEM budget and DMA discipline from the jaxpr.  The port's kernels
are CUDA C++: their budget is what ptxas allocated and what each launch
requests (``resources.py``), and their grid is checked by running every
``ops/kernel_registry.py`` row on the card (``sanitize.py``).  Per row, the
symbols its call launches (the libraries' launch logs) are certified.

Finding kinds (each has an injected fixture in
``tests/test_torch_pallascheck.py``), keyed ``kernel:case:kind`` (kernel =
the launched symbol, demangled to its name and template arguments; case =
the registry row):

- ``smem-overbudget``, ``register-spill``, ``launch-bounds-unmet``
  (resources.py);
- ``untiled-output`` (sanitize.py's NaN canary).

The four ``compute-sanitizer`` kinds are not run (``sanitize.NOT_RUN``).

Entry points: :func:`check_case`, :func:`check_registry`,
:func:`kernels_contract` (``contracts/goldens/kernels.json``: per symbol
its registers, static and dynamic shared memory, stack, spill bytes,
threads, minimum blocks and blocks an SM) and ``python -m
mpi4dl_tpu_torch.analysis pallascheck``.  Everything but the ptxas parser
needs a card and the built libraries (:class:`EnvironmentProblem`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

FINDING_KINDS = (
    "smem-overbudget",
    "register-spill",
    "launch-bounds-unmet",
    "untiled-output",
)
KERNELS_CONTRACT_SCHEMA = 1


class EnvironmentProblem(RuntimeError):
    """The certifier cannot run here (no ptxas report, no card)."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One kernel-certification failure, keyed ``kernel:case:kind``."""

    kind: str     # one of FINDING_KINDS
    kernel: str   # the symbol's name and template arguments
    case: str     # the registry row
    message: str

    @property
    def key(self) -> str:
        return f"{self.kernel}:{self.case}:{self.kind}"

    @property
    def baseline_key(self) -> Tuple[str, str, str, str]:
        return (self.kind, self.kernel, self.case, self.message)

    def render(self) -> str:
        return f"{self.key}: {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def library_resources() -> Dict[str, Dict[str, object]]:
    """Per mangled symbol of every built library: ptxas's report joined with
    the library's launch table, plus ``lib`` and ``name`` (its
    :func:`~.resources.name_key`).  Raises :class:`EnvironmentProblem`
    without a report (the kernels are not built here) or without a card."""
    from mpi4dl_tpu_torch.analysis.pallascheck.resources import (
        demangle, launch_table, name_key, parse_ptxas,
    )
    from mpi4dl_tpu_torch.ops import _build

    reports = {}
    for lib in _build.SOURCES:
        path = _build.ptxas_report_path(lib)
        if not path.exists() or not _build.library_path(lib).exists():
            raise EnvironmentProblem(
                f"no ptxas report at {path}: build the kernels on a machine with nvcc "
                "(ops/_build.build_kernels keeps the report beside the library)")
        reports[lib] = parse_ptxas(path.read_text())
    import torch

    if not torch.cuda.is_available():
        raise EnvironmentProblem("the launch tables and the registry rows need a CUDA card")
    out: Dict[str, Dict[str, object]] = {}
    for lib, report in reports.items():
        # The certifier queries each library's launch table; it launches no kernel.
        table = launch_table(_build.load(lib), lib)  # analysis: ok(unregistered-kernel-launch)
        for sym, res in report.items():
            if sym not in table:
                raise EnvironmentProblem(f"{lib}: ptxas entry {sym} is missing from the "
                                         "library's launch table")
            out[sym] = {"lib": lib, "name": name_key(demangle(sym)), **res, **table[sym]}
    return out


def resource_findings(symbols: Dict[str, Dict[str, object]], case: str,
                      require_smem_frac: float = 1.0) -> List[Finding]:
    from mpi4dl_tpu_torch.analysis.pallascheck.resources import resource_problems

    return [Finding(kind, str(res["name"]), case, msg)
            for res in symbols.values()
            for kind, msg in resource_problems(res, require_smem_frac)]


def case_symbols(case, resources) -> Dict[str, Dict[str, object]]:
    """The symbols (with their resources) a row's call launches."""
    from mpi4dl_tpu_torch.analysis.pallascheck.sanitize import launched_symbols

    launched = launched_symbols(case)
    unknown = sorted(launched - set(resources))
    if unknown:
        raise EnvironmentProblem(f"{case.name}: launched {unknown}, which no ptxas report "
                                 "lists")
    if not launched:
        raise EnvironmentProblem(f"{case.name}: the call launched none of the libraries' "
                                 "kernels")
    return {sym: resources[sym] for sym in launched}


def check_case(case, resources=None, require_smem_frac: float = 1.0,
               sanitize: bool = True) -> List[Finding]:
    """Certify one registry row: the resources of each symbol it launches
    and, with ``sanitize``, the NaN canary."""
    from mpi4dl_tpu_torch.analysis.pallascheck.sanitize import canary

    resources = resources if resources is not None else library_resources()
    out = resource_findings(case_symbols(case, resources), case.name, require_smem_frac)
    if sanitize:
        out += [Finding("untiled-output", case.kernel, case.name, m) for m in canary(case)]
    return _sorted(out)


def check_registry(kernels: Optional[Sequence[str]] = None, require_smem_frac: float = 1.0,
                   sanitize: bool = True) -> List[Finding]:
    from mpi4dl_tpu_torch.ops.kernel_registry import REGISTRY, case_names

    wanted = set(case_names(kernels))
    resources = library_resources()
    out: List[Finding] = []
    for case in REGISTRY:
        if case.name in wanted:
            out += check_case(case, resources, require_smem_frac, sanitize)
    return _sorted(out)


def kernels_contract(require_smem_frac: float = 1.0) -> dict:
    """The ``kernels.json`` golden: every symbol's resources, the symbols
    each registry row and each ``KernelCase.kernel`` launch."""
    import torch

    from mpi4dl_tpu_torch.ops.kernel_registry import REGISTRY

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    resources = library_resources()
    cases: Dict[str, List[str]] = {}
    kernels: Dict[str, List[str]] = {}
    for case in REGISTRY:
        names = sorted(str(r["name"]) for r in case_symbols(case, resources).values())
        cases[case.name] = names
        kernels[case.kernel] = sorted(set(kernels.get(case.kernel, [])) | set(names))
    return {
        "schema": KERNELS_CONTRACT_SCHEMA,
        "torch": torch.__version__,
        "smem_frac": require_smem_frac,
        "symbols": {str(r["name"]): {k: v for k, v in r.items() if k != "name"}
                    for r in resources.values()},
        "cases": cases,
        "kernels": kernels,
    }


def _sorted(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.case, f.kind, f.kernel, f.message))
