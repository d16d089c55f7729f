"""Rule ``unregistered-kernel-launch``: every hand-written kernel of the port
is enrolled in ``mpi4dl_tpu_torch/ops/kernel_registry.py`` (answers the JAX
rule 12, ``unregistered-pallas-call``, ``mpi4dl_tpu/analysis/rules_pallas.py``;
the port has no ``pallas_call``: its kernels are CUDA libraries bound through
ctypes, or Triton).

The registry's rows are what ``chip_smoke.py`` holds against the plain
versions on the card: a kernel in a module the registry never imports
would ship with no such check and no test failing.

(a) A port module that loads a kernel library (``_build.load(...)``), binds
    one (an ``argtypes`` assignment) or defines a ``@triton.jit`` function,
    and that the registry does not import, is a finding at each such line.
(b) A source named in ``ops/_build.py``'s ``SOURCES`` that no registered
    module loads (``_build.load("<name>", ...)``) is a finding at the
    ``SOURCES`` line.

The registered set is the registry's imports, parsed from its source
(never executed).  Scope: the whole ``mpi4dl_tpu_torch/`` tree, tools
included; tests are exempt.  A host library bound through ctypes (no
kernel on the card) carries ``# analysis: ok(unregistered-kernel-launch)``
with the reason.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from mpi4dl_tpu_torch.analysis.core import (
    PACKAGE,
    Project,
    Rule,
    SourceFile,
    Violation,
    package_rel,
)

REGISTRY_REL = f"{PACKAGE}/ops/kernel_registry.py"
_BUILD_REL = f"{PACKAGE}/ops/_build.py"
_LOADERS = {f"{PACKAGE}.ops._build.load", "_build.load"}


def registered_modules(project: Project) -> Set[str]:
    """Dotted module names the registry imports."""
    src = project.source(REGISTRY_REL, f"{PACKAGE}.ops.kernel_registry")
    out: Set[str] = set()
    if src is None:
        return out
    for node in src.nodes(ast.ImportFrom, ast.Import):
        if isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
    return out


def module_name(rel: str) -> Optional[str]:
    rel = package_rel(rel)
    if rel is None:
        return None
    rel = rel[:-3] if rel.endswith(".py") else rel
    rel = rel[: -len("/__init__")] if rel.endswith("/__init__") else rel
    return rel.replace("/", ".")


def _loads(src: SourceFile):
    """(line, library name or None) of every kernel-library load in ``src``."""
    for node in src.nodes(ast.Call):
        if (src.resolve(node.func) or "") in _LOADERS:
            arg = node.args[0] if node.args else None
            yield node.lineno, (arg.value if isinstance(arg, ast.Constant) else None)


def _triggers(src: SourceFile):
    for line, name in _loads(src):
        yield line, f"loads kernel library {name!r}" if name else "loads a kernel library"
    for node in src.nodes(ast.Assign):
        if any(isinstance(t, ast.Attribute) and t.attr == "argtypes" for t in node.targets):
            yield node.lineno, "binds a library with ctypes argtypes"
    for fn in src.nodes(ast.FunctionDef):
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if (src.resolve(target) or "").startswith("triton.") and \
                    (src.resolve(target) or "").endswith("jit"):
                yield fn.lineno, f"defines Triton kernel {fn.name!r}"


class UnregisteredKernelLaunchRule(Rule):
    name = "unregistered-kernel-launch"
    description = (
        "kernel library load, ctypes binding or @triton.jit in a module that "
        "mpi4dl_tpu_torch/ops/kernel_registry.py does not import, or a _build "
        "SOURCES entry no registered module loads — add a KernelCase row."
    )

    def check(self, project: Project) -> List[Violation]:
        registered = registered_modules(project)
        out: List[Violation] = []
        loaded: Set[str] = set()
        for src in project.files:
            mod = module_name(src.rel)
            if mod is None or src.rel.endswith(REGISTRY_REL):
                continue
            if mod in registered:
                loaded.update(name for _, name in _loads(src) if name)
                continue
            for line, what in _triggers(src):
                out.append(Violation(
                    self.name, src.rel, line,
                    f"{mod} {what} but {REGISTRY_REL} does not import it — its "
                    "kernel has no registry row that chip_smoke.py holds against "
                    "its plain version; add a KernelCase row",
                ))
        build = next((f for f in project.files if f.rel.endswith(_BUILD_REL)), None)
        # (b) needs every registered module's loads: only on a scan holding them
        scanned = {module_name(f.rel) for f in project.files}
        if build is not None and registered & scanned:
            out.extend(self._unloaded_sources(build, loaded))
        return out

    def _unloaded_sources(self, build: SourceFile, loaded: Set[str]) -> List[Violation]:
        out = []
        for node in build.tree.body:
            if not (isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "SOURCES" for t in node.targets)):
                continue
            for elt in getattr(node.value, "elts", []):
                if isinstance(elt, ast.Constant) and elt.value not in loaded:
                    out.append(Violation(
                        self.name, build.rel, node.lineno,
                        f"source csrc/{elt.value}.cu is built but no module that "
                        f"{REGISTRY_REL} imports loads it — its kernel has no "
                        "registry row",
                    ))
        return out


RULE = UnregisteredKernelLaunchRule()
