"""Rule ``host-sync``: host synchronisations and host-impure values inside
functions that autograd, activation checkpointing or a CUDA-graph capture
run (answers the JAX rule ``tracer-leak``,
``mpi4dl_tpu/analysis/rules_tracer.py``; renamed because torch has no
tracers).

What changes under torch: nothing is traced, so ``float(x)`` does not
abort — it blocks the host until the card has caught up, a sync per call
inside the step, and inside a ``torch.cuda.graph`` capture it fails.  A
checkpointed function runs twice (forward, then the recompute of the
backward): ``time.time()``, ``random.*`` or ``np.random.*`` there gives the
recompute other host values than the forward had.

Flagged inside a reachable function:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
  ``torch.cuda.synchronize()``;
- ``float()``/``int()``/``bool()`` of a tensor expression: a call of a
  ``torch.*`` function that makes a tensor, or of a tensor reduction method
  (``.sum()``, ``.max()``, ``.any()``, ...).  ``int(q_off)`` of a plain
  argument is not flagged: the rule cannot know its type;
- ``if``/``while`` on such a tensor expression;
- in functions reachable from a checkpoint root only: ``time.time()``,
  ``time.perf_counter()``, ``time.monotonic()``, ``random.*`` and
  ``numpy.random.*``.

Roots: the ``forward``/``backward`` methods of ``torch.autograd.Function``
subclasses; functions passed to ``torch.utils.checkpoint.checkpoint``; and
functions called inside a ``with torch.cuda.graph(...)`` block (whose own
lines are scanned too).  Reachability is the JAX rule's module-level,
scope-aware call graph (a bare name resolves lexically: the caller's own
nested defs first, then enclosing scopes, then module level); nested defs
of a reachable function are reachable.  Attribute calls (``self.f()``) and
calls into other modules are not followed, so a sync in an engine's tick
loop reached through ``self.`` is not seen.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from mpi4dl_tpu_torch.analysis.core import Project, Rule, SourceFile, Violation, own_body

_CHECKPOINT = {"torch.utils.checkpoint.checkpoint", "torch.utils.checkpoint"}
_AUTOGRAD_FUNCTION = {"torch.autograd.Function", "torch.autograd.function.Function"}
_GRAPH = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_REDUCTIONS = {"sum", "mean", "max", "min", "amax", "amin", "norm", "abs", "any",
               "all", "prod", "std", "var", "count_nonzero", "isfinite", "isnan"}
# torch.* callables that do not make a tensor
_NOT_TENSOR = ("torch.Size", "torch.finfo", "torch.iinfo", "torch.device", "torch.dtype",
               "torch.is_tensor", "torch.is_floating_point", "torch.get_default_dtype",
               "torch.cuda.", "torch.distributed.", "torch.backends.", "torch.utils.",
               "torch.autograd.", "torch.profiler.", "torch.nn.Module", "torch.no_grad",
               "torch.enable_grad", "torch.Generator", "torch._")
_IMPURE = ("time.time", "time.perf_counter", "time.monotonic")


def _is_tensor_expr(src: SourceFile, node: ast.AST) -> bool:
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        resolved = src.resolve(n.func) or ""
        if (resolved.startswith("torch.") and not resolved.startswith(_NOT_TENSOR)
                and not resolved.rsplit(".", 1)[-1].startswith("is_")):
            return True
        if isinstance(n.func, ast.Attribute) and n.func.attr in _REDUCTIONS:
            return True
    return False


class _FuncInfo:
    """One function definition; ``children`` maps a bare name to the defs
    nested directly in this scope, so that same-named closures stay apart."""

    def __init__(self, node: Optional[ast.AST], parent: "Optional[_FuncInfo]"):
        self.node = node  # None for the module scope and for class bodies
        self.parent = parent
        self.children: Dict[str, List["_FuncInfo"]] = {}
        self.calls: Set[str] = set()

    def resolve(self, name: str) -> List["_FuncInfo"]:
        scope: Optional[_FuncInfo] = self
        while scope is not None:
            if name in scope.children:
                return scope.children[name]
            scope = scope.parent
        return []


class HostSyncRule(Rule):
    name = "host-sync"
    description = (
        ".item()/.tolist()/.cpu()/.numpy()/float()/int()/bool() of a tensor, "
        "torch.cuda.synchronize() or tensor-valued if/while inside functions "
        "reachable from an autograd.Function, a checkpoint or a CUDA-graph "
        "capture; host clocks/random inside checkpointed functions."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.files:
            out.extend(self._check_file(src))
        return out

    def _check_file(self, src: SourceFile) -> List[Violation]:
        roots, ckpt_roots, graph_blocks = self._collect(src)
        reachable = self._reach(roots + ckpt_roots)
        impure = {id(i) for i in self._reach(ckpt_roots)}
        out: List[Violation] = []
        for info in reachable:
            out.extend(self._scan(src, own_body(info.node), info.node.name, id(info) in impure))
        for block in graph_blocks:
            out.extend(self._scan(src, own_body(block), "<torch.cuda.graph capture>", False))
        return out

    # -- collection --------------------------------------------------------
    def _collect(self, src: SourceFile):
        module = _FuncInfo(None, None)
        roots: List[_FuncInfo] = []
        ckpt_refs: List[Tuple[_FuncInfo, str]] = []
        graph_refs: List[Tuple[_FuncInfo, str]] = []
        graph_blocks: List[ast.With] = []

        class V(ast.NodeVisitor):
            def __init__(self):
                self.stack: List[_FuncInfo] = [module]
                self.autograd: List[bool] = [False]

            def visit_ClassDef(self, node: ast.ClassDef):
                is_fn = any((src.resolve(b) or "") in _AUTOGRAD_FUNCTION for b in node.bases)
                # methods are not name-visible: a scope of their own
                self.stack.append(_FuncInfo(None, self.stack[-1]))
                self.autograd.append(is_fn)
                self.generic_visit(node)
                self.autograd.pop()
                self.stack.pop()

            def visit_FunctionDef(self, node):
                parent = self.stack[-1]
                info = _FuncInfo(node, parent)
                parent.children.setdefault(node.name, []).append(info)
                parent.calls.add(node.name)  # a nested def runs when called
                if self.autograd[-1] and parent.node is None and node.name in (
                        "forward", "backward"):
                    roots.append(info)
                self.stack.append(info)
                self.autograd.append(False)
                self.generic_visit(node)
                self.autograd.pop()
                self.stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_With(self, node: ast.With):
                if any(isinstance(i.context_expr, ast.Call)
                       and (src.resolve(i.context_expr.func) or "") in _GRAPH
                       for i in node.items):
                    graph_blocks.append(node)
                    graph_refs.extend((self.stack[-1], n.func.id) for n in own_body(node)
                                      if isinstance(n, ast.Call) and isinstance(n.func, ast.Name))
                self.generic_visit(node)

            def visit_Call(self, node: ast.Call):
                cur = self.stack[-1]
                if isinstance(node.func, ast.Name):
                    cur.calls.add(node.func.id)
                if (src.resolve(node.func) or "") in _CHECKPOINT:
                    for arg in list(node.args[:1]) + [k.value for k in node.keywords
                                                      if k.arg == "function"]:
                        if isinstance(arg, ast.Name):
                            ckpt_refs.append((cur, arg.id))
                self.generic_visit(node)

        V().visit(src.tree)
        ckpt_roots = [i for scope, name in ckpt_refs for i in scope.resolve(name)]
        roots += [i for scope, name in graph_refs for i in scope.resolve(name)]
        return roots, ckpt_roots, graph_blocks

    @staticmethod
    def _reach(roots: List[_FuncInfo]) -> List[_FuncInfo]:
        seen: Dict[int, _FuncInfo] = {}
        work = list(roots)
        while work:
            info = work.pop()
            if id(info) in seen or info.node is None:
                continue
            seen[id(info)] = info
            for name in info.calls:
                work.extend(c for c in info.resolve(name) if id(c) not in seen)
        return list(seen.values())

    # -- body scan ---------------------------------------------------------
    def _scan(self, src: SourceFile, nodes, where: str, impure: bool) -> List[Violation]:
        out: List[Violation] = []

        def flag(node: ast.AST, what: str):
            out.append(Violation(self.name, src.rel, node.lineno,
                                 f"{what} inside {where!r}, which autograd, a checkpoint "
                                 "or a CUDA-graph capture runs"))

        for node in nodes:
            if isinstance(node, ast.Call):
                f = node.func
                resolved = src.resolve(f) or ""
                if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS and not node.args \
                        and not resolved.startswith(("torch.", "numpy.")):
                    flag(node, f".{f.attr}() host sync")
                elif resolved == "torch.cuda.synchronize":
                    flag(node, "torch.cuda.synchronize() host sync")
                elif (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
                      and node.args and _is_tensor_expr(src, node.args[0])):
                    flag(node, f"{f.id}() of a tensor: host sync")
                elif impure and (resolved in _IMPURE or resolved.startswith(
                        ("random.", "numpy.random."))):
                    flag(node, f"{resolved}() in a checkpointed function gives the "
                               "recompute other values than the forward")
            elif isinstance(node, (ast.If, ast.While)) and _is_tensor_expr(src, node.test):
                kind = "if" if isinstance(node, ast.If) else "while"
                flag(node, f"`{kind}` on a tensor value forces a host sync")
        return out


RULE = HostSyncRule()
