"""Rule ``import-time-tensor``: work on the device at import, and cache keys
that cannot hash (answers the JAX rule ``retrace``,
``mpi4dl_tpu/analysis/rules_retrace.py``; renamed because torch compiles
no traces).

Two checks over package files:

1. A module-level binding of a ``torch`` tensor (``X = torch.tensor(...)``,
   or a tuple/list/dict literal of them), or any ``torch.cuda.*`` call that
   runs at import (module level or a class body).  Either touches the
   device runtime before the data workers and the supervisor's legs fork,
   and pins a device at import; the JAX rule's counterpart is a device
   array baked into every trace.  A binding built FROM tensors but holding
   plain numbers (``float(torch.tensor(...))``) is fine.
2. The counterpart of the static-argument check: a ``functools.lru_cache``
   / ``functools.cache`` function whose parameter defaults to a mutable
   literal (list/dict/set): the cache hashes its arguments, so the first
   call that takes the default raises.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from mpi4dl_tpu_torch.analysis.core import Project, Rule, SourceFile, Violation

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)
_FACTORIES = {f"torch.{n}" for n in (
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full", "arange",
    "linspace", "logspace", "eye", "rand", "randn", "randint", "randperm", "zeros_like",
    "ones_like", "empty_like", "full_like", "rand_like", "randn_like", "Tensor")}
_CACHES = {"functools.lru_cache", "functools.cache"}


def _import_time_nodes(tree: ast.Module) -> Iterable[ast.AST]:
    """Nodes that run at import: the module body and class bodies, not
    function bodies or lambdas."""
    work = list(tree.body)
    while work:
        node = work.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # decorators and defaults run at import; the body does not
            work.extend(node.decorator_list if not isinstance(node, ast.Lambda) else [])
            work.extend(d for d in node.args.defaults + node.args.kw_defaults if d)
            continue
        work.extend(ast.iter_child_nodes(node))


class ImportTimeTensorRule(Rule):
    name = "import-time-tensor"
    description = (
        "No module-level torch tensors and no torch.cuda calls at import "
        "(CUDA before the workers fork); lru_cache/cache functions take no "
        "mutable-literal defaults."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.package_files():
            out.extend(self._check_import_time(src))
            out.extend(self._check_cache_defaults(src))
        return out

    def _is_tensor(self, src: SourceFile, value: ast.AST) -> bool:
        if isinstance(value, ast.Call):
            return (src.resolve(value.func) or "") in _FACTORIES
        if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
            return any(self._is_tensor(src, e) for e in value.elts)
        if isinstance(value, ast.Dict):
            return any(self._is_tensor(src, v) for v in value.values)
        if isinstance(value, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._is_tensor(src, value.elt)
        if isinstance(value, ast.DictComp):
            return self._is_tensor(src, value.value)
        return False

    def _check_import_time(self, src: SourceFile) -> List[Violation]:
        out = []
        for node in src.tree.body:
            value = node.value if isinstance(node, (ast.Assign, ast.AnnAssign)) else None
            if value is not None and self._is_tensor(src, value):
                out.append(Violation(
                    self.name, src.rel, node.lineno,
                    "module-level torch tensor: built at import, before any worker "
                    "or leg forks — build it inside the function that uses it (or "
                    "keep plain numbers)",
                ))
        for node in _import_time_nodes(src.tree):
            if isinstance(node, ast.Call) and (src.resolve(node.func) or "").startswith(
                    "torch.cuda."):
                out.append(Violation(
                    self.name, src.rel, node.lineno,
                    f"{src.resolve(node.func)}() at import touches the CUDA runtime "
                    "before workers fork — call it inside a function",
                ))
        return out

    def _check_cache_defaults(self, src: SourceFile) -> List[Violation]:
        out = []
        for fdef in src.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            cached = any((src.resolve(d.func if isinstance(d, ast.Call) else d) or "")
                         in _CACHES for d in fdef.decorator_list)
            if not cached:
                continue
            params = fdef.args.posonlyargs + fdef.args.args
            pairs = list(zip(params[len(params) - len(fdef.args.defaults):],
                             fdef.args.defaults))
            pairs += [(a, d) for a, d in zip(fdef.args.kwonlyargs, fdef.args.kw_defaults)
                      if d is not None]
            for arg, default in pairs:
                if isinstance(default, _MUTABLE_LITERALS):
                    out.append(Violation(
                        self.name, src.rel, fdef.lineno,
                        f"cached argument {arg.arg!r} of {fdef.name!r} defaults to a "
                        "mutable literal — unhashable for the cache; use a tuple/"
                        "frozenset or require the argument",
                    ))
        return out


RULE = ImportTimeTensorRule()
