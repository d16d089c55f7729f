"""Framework of the port's source-level analyzer (counterpart of
``mpi4dl_tpu/analysis/core.py``).

Pure ``ast`` and the standard library: the analyzed modules are parsed,
never imported, so the gate runs in seconds on any host, with no card and
without initialising CUDA.

Vocabulary:

- A :class:`SourceFile` is one parsed module: its AST (walked once into a
  by-node-type index that every rule iterates through
  :meth:`SourceFile.nodes`), its per-line pragmas, and an import-alias table
  that resolves ``torch``, ``dist`` (``torch.distributed``), ``F``
  (``torch.nn.functional``), ``ctypes`` and ``triton`` to canonical dotted
  names without executing anything.
- A :class:`Project` is the set of scanned files plus the ground truth they
  are checked against, parsed from the port's sources: the env-hatch
  registry (``config.HATCHES``) and the mesh's group names (the groups
  ``mesh.build_process_mesh`` creates).  When the scanned paths do not
  include those files (a fixture scan), they are parsed from the installed
  package's sources.
- A :class:`Rule` contributes :class:`Violation` objects; the runner applies
  pragma suppression and an optional baseline, then reports.

Package files are ``mpi4dl_tpu_torch/`` minus its tools
(``mpi4dl_tpu_torch/benchmarks/`` and ``mpi4dl_tpu_torch/bench.py``): the
JAX package keeps its tools outside the package, the port inside it.

Pragma syntax (suppresses on its own line, or the whole function when placed
on the ``def`` line)::

    n = int(t.sum())  # analysis: ok(host-sync)
    def helper():     # analysis: ok(host-sync, dtype-policy)
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PACKAGE = "mpi4dl_tpu_torch"
_TOOLS = (f"{PACKAGE}/benchmarks/", f"{PACKAGE}/bench.py")

_PRAGMA_RE = re.compile(r"#\s*analysis:\s*ok\(([^)]*)\)")
_HATCH_NAME_RE = re.compile(r"^_?MPI4DL_[A-Z0-9_]+$")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # scan-root-relative, forward slashes
    line: int
    message: str

    @property
    def baseline_key(self) -> Tuple[str, str, str]:
        # Line numbers drift with unrelated edits; baseline entries match on
        # (rule, path, message) so that an accepted finding survives them.
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed module with pragma and import-alias tables; the AST is
    walked once at construction into a by-node-type index."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.by_type: Dict[type, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            self.by_type.setdefault(type(node), []).append(node)
        self.pragmas = self._collect_pragmas(text)
        self.aliases = self._collect_aliases(self)
        self.func_spans = [(n.lineno, getattr(n, "end_lineno", n.lineno))
                           for n in self.nodes(ast.FunctionDef, ast.AsyncFunctionDef)]

    def nodes(self, *types: type) -> Iterable[ast.AST]:
        """Every node of the given type(s), in ``ast.walk`` (breadth-first)
        order: rules that need lexical structure check spans."""
        for t in types:
            yield from self.by_type.get(t, ())

    # -- pragmas -----------------------------------------------------------
    @staticmethod
    def _collect_pragmas(text: str) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA_RE.search(tok.string)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                    out.setdefault(tok.start[0], set()).update(rules or {"*"})
        except tokenize.TokenError:
            pass
        return out

    def suppressing_line(self, rule: str, line: int) -> Optional[int]:
        """The pragma line that suppresses ``rule`` at ``line``, or None."""
        def hit(rules: Set[str]) -> bool:
            return "*" in rules or rule in rules

        if line in self.pragmas and hit(self.pragmas[line]):
            return line
        for start, end in self.func_spans:  # a def-line pragma covers the body
            if start <= line <= end and start in self.pragmas and hit(self.pragmas[start]):
                return start
        return None

    # -- import aliases ----------------------------------------------------
    @staticmethod
    def _collect_aliases(src: "SourceFile") -> Dict[str, str]:
        """Local name -> dotted origin, from imports in every scope:
        ``import torch.distributed as dist`` -> {'dist': 'torch.distributed'},
        ``import torch.nn.functional as F`` -> {'F': 'torch.nn.functional'},
        ``from mpi4dl_tpu_torch.ops import _build`` ->
        {'_build': 'mpi4dl_tpu_torch.ops._build'}.  Document order, so a
        later rebinding wins."""
        out: Dict[str, str] = {}
        nodes = sorted(src.nodes(ast.Import, ast.ImportFrom),
                       key=lambda n: (n.lineno, n.col_offset))
        for node in nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif node.module:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted canonical name of a Name/Attribute chain through the alias
        table: ``dist.all_reduce`` -> 'torch.distributed.all_reduce'."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.aliases.get(node.id, node.id))
            return ".".join(reversed(parts))
        return None


def package_rel(rel: str) -> Optional[str]:
    """``rel`` from the package directory on (``mpi4dl_tpu_torch/ops/x.py``),
    or None outside it."""
    rel = f"/{rel}"
    i = rel.find(f"/{PACKAGE}/")
    return rel[i + 1:] if i >= 0 else None


def is_package_file(rel: str) -> bool:
    """A file of the port's package, its tools excluded."""
    inner = package_rel(rel)
    return inner is not None and not inner.startswith(_TOOLS)


@dataclasses.dataclass
class Project:
    files: List[SourceFile]
    groups: Tuple[str, ...]  # the mesh's group names
    hatches: Dict[str, int]  # declared hatch name -> declaration line
    hatch_decl_path: str  # rel path of the registry (for dead-flag reports)
    # True when the registry itself is part of the scan: the dead-flag
    # direction means something only on a whole-tree scan.
    hatch_decl_in_scan: bool = False

    def package_files(self) -> List[SourceFile]:
        return [f for f in self.files if is_package_file(f.rel)]

    def source(self, suffix: str, module: str) -> Optional[SourceFile]:
        """The scanned file ending in ``suffix``, else ``module``'s source
        parsed from the installed package."""
        return find_file(self.files, suffix) or parse_fallback(module)


class Rule:
    """Base class; subclasses set ``name``/``description`` and implement
    :meth:`check`.  Instances are listed in ``rules.RULE_TABLE``."""

    name: str = ""
    description: str = ""

    def check(self, project: Project) -> List[Violation]:  # pragma: no cover
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Ground truth (static: never imports the analyzed code)
# ---------------------------------------------------------------------------


def find_file(files: Sequence[SourceFile], suffix: str) -> Optional[SourceFile]:
    for f in files:
        if f.rel == suffix or f.rel.endswith("/" + suffix):
            return f
    return None


_FALLBACK: Dict[str, Optional[SourceFile]] = {}


def parse_fallback(modname: str) -> Optional[SourceFile]:
    """Parse an installed module's source without importing it (its
    package's ``__init__`` is not run either)."""
    if modname in _FALLBACK:
        return _FALLBACK[modname]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parts = modname.split(".")
    out = None
    if parts[0] == PACKAGE:
        path = os.path.join(here, *parts[1:]) + ".py"
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                out = SourceFile(path, "/".join(parts) + ".py", fh.read())
    _FALLBACK[modname] = out
    return out


def extract_groups(files: Sequence[SourceFile]) -> Tuple[str, ...]:
    """The mesh's group names: the string of each ``(name, dims)`` pair of
    ``mesh.py``'s ``GROUP_AXES``, the table ``build_process_mesh`` creates
    its groups from."""
    src = find_file(files, f"{PACKAGE}/mesh.py") or parse_fallback(f"{PACKAGE}.mesh")
    if src is None:
        return ()
    for node in src.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "GROUP_AXES"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return tuple(e.elts[0].value for e in node.value.elts
                         if isinstance(e, ast.Tuple) and e.elts
                         and isinstance(e.elts[0], ast.Constant)
                         and isinstance(e.elts[0].value, str))
    return ()


def extract_hatches(files: Sequence[SourceFile]) -> Tuple[Dict[str, int], str]:
    """Declared env hatches: every ``Hatch("NAME", ...)`` call in config.py."""
    src = find_file(files, f"{PACKAGE}/config.py") or parse_fallback(f"{PACKAGE}.config")
    out: Dict[str, int] = {}
    if src is None:
        return out, ""
    for node in src.nodes(ast.Call):
        if (isinstance(node.func, ast.Name) and node.func.id == "Hatch" and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out[node.args[0].value] = node.lineno
    return out, src.rel


# ---------------------------------------------------------------------------
# Shared AST helpers for rules
# ---------------------------------------------------------------------------


def environ_reads(src: SourceFile) -> Iterable[Tuple[str, int]]:
    """(name, line) for every env *read* of a string-literal key:
    ``os.environ.get/pop/setdefault(K)``, ``os.environ[K]`` (load) and
    ``getenv(K)``."""
    for node in src.nodes(ast.Call):
        key = None
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in ("get", "pop", "setdefault")
                and isinstance(f.value, ast.Attribute) and f.value.attr == "environ"):
            key = node.args[0] if node.args else None
        elif isinstance(f, ast.Attribute) and f.attr == "getenv":
            key = node.args[0] if node.args else None
        elif isinstance(f, ast.Name) and f.id == "getenv":
            key = node.args[0] if node.args else None
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            yield key.value, node.lineno
    for node in src.nodes(ast.Subscript):
        if (isinstance(node.ctx, ast.Load) and isinstance(node.value, ast.Attribute)
                and node.value.attr == "environ" and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            yield node.slice.value, node.lineno


def is_hatch_name(name: str) -> bool:
    return bool(_HATCH_NAME_RE.match(name))


def own_body(fnode: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested defs."""
    work = list(ast.iter_child_nodes(fnode))
    while work:
        node = work.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            work.extend(ast.iter_child_nodes(node))


# torch.distributed calls that move data between ranks or wait for them.
# ``batch_isend_irecv`` carries its group in its ``P2POp``s.
DIST_COLLECTIVES = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "all_gather_object": 2, "reduce_scatter": 3, "reduce_scatter_tensor": 3,
    "all_to_all": 2, "all_to_all_single": 4, "broadcast": 2,
    "broadcast_object_list": 2, "reduce": 3, "gather": 3, "gather_object": 3,
    "scatter": 3, "scatter_object_list": 3, "barrier": 0, "send": 2,
    "recv": 2, "isend": 2, "irecv": 2, "monitored_barrier": 0,
    "batch_isend_irecv": None,
}  # name -> index of the positional ``group`` argument (None: no group)


def dist_call(src: SourceFile, node: ast.Call) -> Optional[str]:
    """The ``torch.distributed`` collective a call makes (its bare name),
    else None."""
    resolved = src.resolve(node.func) or ""
    head, _, tail = resolved.rpartition(".")
    if head == "torch.distributed" and tail in DIST_COLLECTIVES:
        return tail
    return None


def with_spans(src: SourceFile, callees: Sequence[str]) -> List[Tuple[int, int, ast.Call]]:
    """(first line, last line, context call) of every ``with`` block whose
    context manager is a call resolving to one of ``callees``."""
    out = []
    for w in src.nodes(ast.With, ast.AsyncWith):
        for item in w.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call) and (src.resolve(ctx.func) or "") in callees:
                out.append((w.lineno, getattr(w, "end_lineno", w.lineno), ctx))
                break
    return out


# The port's named scope (obs/scopes.py), under the spellings its modules
# import it by.
SCOPE_CALLEES = (f"{PACKAGE}.obs.scopes.scope", f"{PACKAGE}.obs.scope")


# ---------------------------------------------------------------------------
# File discovery + runner
# ---------------------------------------------------------------------------

_SKIP_DIRS = {".git", "__pycache__", ".claude", "node_modules", ".github"}


def discover(paths: Sequence[str], root: Optional[str] = None) -> List[SourceFile]:
    root = os.path.abspath(root or os.getcwd())
    found: List[str] = []
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            found.append(ap)
        elif os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
                found.extend(os.path.join(dirpath, fn) for fn in sorted(filenames)
                             if fn.endswith(".py"))
    files: List[SourceFile] = []
    for ap in sorted(set(found)):
        rel = os.path.relpath(ap, root)
        with open(ap, "r", encoding="utf-8") as fh:
            text = fh.read()
        try:
            files.append(SourceFile(ap, rel, text))
        except SyntaxError as e:
            # a file that cannot be parsed cannot be checked: surface it
            raise SystemExit(f"analysis: cannot parse {rel}: {e}")
    return files


def build_project(paths: Sequence[str], root: Optional[str] = None) -> Project:
    files = discover(paths, root)
    hatches, decl_path = extract_hatches(files)
    return Project(
        files=files,
        groups=extract_groups(files),
        hatches=hatches,
        hatch_decl_path=decl_path,
        hatch_decl_in_scan=any(f.rel == decl_path for f in files),
    )


def run_rules(project: Project, rules: Sequence[Rule],
              used_pragmas: Optional[Set[Tuple[str, int]]] = None) -> List[Violation]:
    """Run rules with pragma suppression.  ``used_pragmas``, when given,
    collects ``(rel_path, pragma_line)`` of every pragma that suppressed a
    finding, which :func:`stale_pragmas` subtracts from the declared set."""
    by_path = {f.rel: f for f in project.files}
    out: List[Violation] = []
    for rule in rules:
        for v in rule.check(project):
            src = by_path.get(v.path)
            if src is not None:
                pline = src.suppressing_line(v.rule, v.line)
                if pline is not None:
                    if used_pragmas is not None:
                        used_pragmas.add((src.rel, pline))
                    continue
            out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def stale_pragmas(project: Project, used_pragmas: Set[Tuple[str, int]]) -> List[Violation]:
    """A ``stale-pragma`` finding for every pragma in a package file that
    suppressed nothing on this run; meaningful only on a whole-tree
    all-rules scan."""
    out: List[Violation] = []
    for src in project.package_files():
        for line, rules in sorted(src.pragmas.items()):
            if (src.rel, line) in used_pragmas:
                continue
            out.append(Violation(
                rule="stale-pragma", path=src.rel, line=line,
                message=(f"pragma ok({', '.join(sorted(rules))}) no longer suppresses "
                         "any finding — remove it (or it will mask the next real "
                         "finding on this line)"),
            ))
    return out


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, list):
        raise SystemExit(f"baseline {path}: expected a JSON list")
    return data


def apply_baseline(violations: Sequence[Violation],
                   baseline: Sequence[dict]) -> Tuple[List[Violation], List[dict]]:
    """Split into (new violations, stale baseline entries)."""
    def key(e: dict) -> Tuple[str, str, str]:
        return (e.get("rule", ""), e.get("path", ""), e.get("message", ""))

    keys = {key(e) for e in baseline}
    new = [v for v in violations if v.baseline_key not in keys]
    seen = {v.baseline_key for v in violations}
    return new, [e for e in baseline if key(e) not in seen]
