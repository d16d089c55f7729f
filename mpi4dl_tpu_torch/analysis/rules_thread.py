"""Rule ``thread-shared-state``: shared mutable state written from a thread
body needs synchronization machinery in scope (answers the JAX rule of the
same name, ``mpi4dl_tpu/analysis/rules_thread.py``; unchanged).

The port runs background threads on its hot path: the checkpoint writer,
the step watchdog, the batch prefetch producer and the fleet scheduler's
leg threads.  A data race there corrupts exactly the state the thread exists
to protect.  The GIL makes single attribute stores atomic, but nothing
composes: check-then-set and read-modify-write sequences interleave freely.

Flagged: a mutation of shared state inside a thread body — an assignment or
augmented assignment to ``self.<attr>``, to a ``global``-declared name, or a
subscript store / mutating method call (``append``/``update``/...) on a
module-level name — when the *owning scope* (the class for methods, the
enclosing function for closure targets, else the module) constructs none of
the standard synchronization primitives (``threading.Lock``/``RLock``/
``Condition``/``Event``/``Semaphore``/``Barrier``, the ``queue.Queue``
family).

Thread bodies are functions passed as ``target=`` to ``threading.Thread``
(by name, closure or ``self.method``) and ``run`` methods of
``threading.Thread`` subclasses.  The presence of a primitive is trusted:
whether every mutation holds the lock is beyond static reach.  Scope:
package files; ``# analysis: ok(thread-shared-state)`` applies.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from mpi4dl_tpu_torch.analysis.core import Project, Rule, SourceFile, Violation

_SYNC_PRIMITIVES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Event", "threading.Semaphore", "threading.BoundedSemaphore",
    "threading.Barrier",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue",
    "multiprocessing.Lock", "multiprocessing.Queue",
}

_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "clear", "add",
    "update", "setdefault", "popitem", "discard", "appendleft", "popleft",
}


def _scope_has_sync(src: SourceFile, scope: ast.AST) -> bool:
    """Does this class/function/module construct a synchronization
    primitive anywhere in its body?"""
    for node in ast.walk(scope):
        if isinstance(node, ast.Call):
            resolved = src.resolve(node.func)
            if resolved in _SYNC_PRIMITIVES:
                return True
    return False


def _enclosing(src: SourceFile, target: ast.AST,
               kinds: tuple) -> Optional[ast.AST]:
    """Innermost node of the given kinds whose span contains ``target``
    (line-based; good enough for whole-def containment)."""
    best: Optional[ast.AST] = None
    t_line = getattr(target, "lineno", None)
    if t_line is None:
        return None
    for node in src.nodes(*kinds):
        start = node.lineno
        end = getattr(node, "end_lineno", start)
        if start <= t_line <= end and node is not target:
            if best is None or node.lineno > best.lineno:
                best = node
    return best


def _own_body(fnode: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested defs."""
    work = list(ast.iter_child_nodes(fnode))
    while work:
        node = work.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            work.extend(ast.iter_child_nodes(node))


class ThreadSharedStateRule(Rule):
    name = "thread-shared-state"
    description = (
        "shared mutable state written in a threading.Thread target/run() "
        "whose owning scope has no Lock/Event/Queue — add synchronization "
        "or route through a queue."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.package_files():
            out.extend(self._check_file(src))
        return out

    # -- thread-body discovery ---------------------------------------------
    def _thread_bodies(
        self, src: SourceFile
    ) -> List[Tuple[ast.AST, Optional[ast.AST]]]:
        """(function node, owning scope node or None=module) for every
        thread body in the file."""
        bodies: List[Tuple[ast.AST, Optional[ast.AST]]] = []
        func_kinds = (ast.FunctionDef, ast.AsyncFunctionDef)

        # threading.Thread(target=...) call sites
        for call in src.nodes(ast.Call):
            if src.resolve(call.func) != "threading.Thread":
                continue
            target = None
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None:
                continue
            if isinstance(target, ast.Name):
                fnode = self._resolve_local_func(src, call, target.id)
                if fnode is not None:
                    owner = _enclosing(src, fnode,
                                       (ast.ClassDef,) + func_kinds)
                    bodies.append((fnode, owner))
            elif (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                cls = _enclosing(src, call, (ast.ClassDef,))
                if cls is not None:
                    for node in cls.body:
                        if isinstance(node, func_kinds) and \
                                node.name == target.attr:
                            bodies.append((node, cls))

        # class X(threading.Thread): def run(self)
        for cls in src.nodes(ast.ClassDef):
            if not any(src.resolve(b) == "threading.Thread"
                       for b in cls.bases):
                continue
            for node in cls.body:
                if isinstance(node, func_kinds) and node.name == "run":
                    bodies.append((node, cls))
        # one body per function regardless of spawn-site count — N call
        # sites must not report each mutation N times
        seen: Set[int] = set()
        unique = []
        for fnode, owner in bodies:
            if id(fnode) not in seen:
                seen.add(id(fnode))
                unique.append((fnode, owner))
        return unique

    @staticmethod
    def _resolve_local_func(
        src: SourceFile, call: ast.Call, name: str
    ) -> Optional[ast.AST]:
        """The def the target name lexically refers to at the call site:
        the innermost *visible* definition — a def whose enclosing function
        scope also encloses the call (closure sibling), else a module-level
        def.  Methods (defs owned by a ClassDef) are never name-visible;
        same-named defs in unrelated scopes do not shadow the target.  The
        defined-before-the-call requirement only applies when the call
        executes at module level — inside a function, a module-level target
        defined further down the file is fully legal."""
        func_kinds = (ast.FunctionDef, ast.AsyncFunctionDef)
        call_line = call.lineno
        call_at_module_level = _enclosing(src, call, func_kinds) is None
        best: Optional[ast.AST] = None
        best_depth = -1
        for n in src.nodes(*func_kinds):
            if n.name != name:
                continue
            owner = _enclosing(src, n, (ast.ClassDef,) + func_kinds)
            if owner is None:
                # module-level def: visible to any call inside a function
                # regardless of order; a module-level call still needs it
                # bound first
                if call_at_module_level and n.lineno > call_line:
                    continue
                depth = 0
            elif isinstance(owner, ast.ClassDef):
                continue  # a method is not name-visible
            elif owner.lineno <= call_line <= getattr(
                owner, "end_lineno", owner.lineno
            ) and n.lineno <= call_line:
                depth = owner.lineno  # shared enclosing scope; inner wins
            else:
                continue  # defined in a scope the call cannot see
            if depth > best_depth or (depth == best_depth and (
                best is None or n.lineno > best.lineno
            )):
                best, best_depth = n, depth
        return best

    # -- mutation scan -----------------------------------------------------
    def _check_file(self, src: SourceFile) -> List[Violation]:
        out: List[Violation] = []
        module_names = self._module_level_names(src)
        for fnode, owner in self._thread_bodies(src):
            scope = owner if owner is not None else src.tree
            if _scope_has_sync(src, scope):
                continue
            is_method = isinstance(owner, ast.ClassDef)
            for what, node in self._mutations(src, fnode, is_method,
                                              module_names):
                out.append(
                    Violation(
                        self.name,
                        src.rel,
                        node.lineno,
                        f"thread body {fnode.name!r} mutates {what} with no "
                        "Lock/Event/Queue in its owning scope — add a "
                        "synchronization primitive or hand the result over "
                        "a queue.Queue",
                    )
                )
        return out

    @staticmethod
    def _module_level_names(src: SourceFile) -> Set[str]:
        names: Set[str] = set()
        for node in src.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
            elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name
            ):
                names.add(node.target.id)
        return names

    def _mutations(
        self,
        src: SourceFile,
        fnode: ast.AST,
        is_method: bool,
        module_names: Set[str],
    ) -> List[Tuple[str, ast.AST]]:
        shared: Set[str] = set()
        for node in _own_body(fnode):
            if isinstance(node, ast.Global):
                shared.update(node.names)

        out: List[Tuple[str, ast.AST]] = []

        def is_self_attr(node: ast.AST) -> bool:
            return (
                is_method
                and isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            )

        for node in _own_body(fnode):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if isinstance(node, ast.AnnAssign) and node.value is None:
                    continue  # bare annotation: no store at runtime
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    if is_self_attr(tgt):
                        out.append((f"instance state 'self.{tgt.attr}'", tgt))
                    elif isinstance(tgt, ast.Name) and tgt.id in shared:
                        out.append((f"global {tgt.id!r}", tgt))
                    elif isinstance(tgt, ast.Subscript):
                        base = tgt.value
                        if isinstance(base, ast.Name) and (
                            base.id in module_names or base.id in shared
                        ):
                            out.append(
                                (f"module-level container {base.id!r}", tgt)
                            )
                        elif is_self_attr(base):
                            out.append(
                                (f"instance state 'self.{base.attr}'", tgt)
                            )
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in _MUTATING_METHODS:
                base = node.func.value
                if isinstance(base, ast.Name) and (
                    base.id in module_names or base.id in shared
                ):
                    out.append(
                        (f"module-level container {base.id!r}", node)
                    )
                elif is_self_attr(base):
                    out.append((f"instance state 'self.{base.attr}'", node))
        return out


RULE = ThreadSharedStateRule()
