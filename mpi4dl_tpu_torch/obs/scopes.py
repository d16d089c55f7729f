"""Named trace scopes (counterpart of ``mpi4dl_tpu/obs/scopes.py``).

:func:`scope` opens a ``torch.profiler.record_function`` range, so a
profiler trace of a step reads ``cell03/...`` instead of anonymous kernels.
The names are the JAX package's (``cellNN`` per cell).  Outside a profiler
session ``record_function`` is a cheap no-op.

:func:`step_annotation` is the host-side step marker: one range around one
optimizer step's dispatch, named ``<name>#<step>`` (the supervised loop
wraps each step in it while a profile is being taken).

:func:`recording_scopes` collects the names that :func:`scope` opens
inside it, from any thread (the cost record's ``tick_scopes``).

**The scope path.**  The JAX package reads each op's scope from the
compiled program's ``op_name`` metadata, where a backward op carries the
path of the forward op it transposes.  The port has no compiled program, so
inside :func:`instrumenting` (and only there: timed steps pay nothing)
:func:`scope` also keeps a per-thread stack of the open names, and
:func:`current_path` reads it.  Backward ops run on autograd's threads,
where no forward range is open; the carry gives them their forward scope:

- while instrumenting, a ``TorchFunctionMode`` stores the open path in
  ``grad_fn.metadata["scope"]`` of every output made under a scope, and
  ``torch.autograd.Function.apply`` is wrapped to do the same for the hand
  kernels' autograd Functions (``apply`` does not pass through the mode);
- in backward, :func:`current_path` reads the metadata of
  ``torch._C._current_autograd_node()`` and adds the names opened while
  that node runs: a checkpointed region's recompute re-opens its scopes,
  which replace the node's own from the first of the same kind (a stage's
  recompute under ``stage0/cell17`` reads ``stage0/cell00`` ...).  A node
  without a stored path falls back to the thread's stack.

:func:`clean_scope_component` and :func:`clean_scope_path` are the JAX
package's (``mpi4dl_tpu/obs/hlo_stats.py:168-191``), so that op-name paths
of both packages compare; the port's paths are already clean.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import ContextManager, Iterator, List, Optional, Set, Tuple

import torch
from torch.overrides import TorchFunctionMode

_SEEN: Optional[Set[str]] = None
_KEY = "scope"
_TLS = threading.local()
_ACTIVE = [0]  # nesting depth of instrumenting()


def scope(name: str) -> ContextManager[None]:
    """Named profiler range for the work done inside the ``with`` block."""
    if _SEEN is not None:
        _SEEN.add(name)
    if _ACTIVE[0]:
        return _stacked(name)
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _stacked(name: str) -> Iterator[None]:
    stack = _stack()
    stack.append((name, torch._C._current_autograd_node()))
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()


def _stack() -> List[Tuple[str, object]]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def current_path() -> str:
    """The scope path open here ("" outside every scope): the thread's stack
    in forward; in backward the forward path stored on the running autograd
    node plus the names opened while it runs."""
    stack = getattr(_TLS, "stack", None) or ()
    node = torch._C._current_autograd_node()
    if node is not None:
        path = recompute_path(node.metadata.get(_KEY, ""),
                              [n for n, owner in stack if owner is not None and owner == node])
        if path:
            return path
    return "/".join(n for n, _ in stack)


def recompute_path(base: str, inner: List[str]) -> str:
    """A backward op's path: its node's forward ``base`` path and the
    ``inner`` scopes opened while the node runs.  A checkpointed region's
    recompute re-opens its scopes: they replace the node's own from the
    first of the same kind (``stage0/cell17`` + ``cell00`` ->
    ``stage0/cell00``), as the recomputed op's forward path reads."""
    comps = [p for p in base.split("/") if p]
    if inner:
        kind = _kind(inner[0])
        comps = comps[:next((i for i, p in enumerate(comps) if _kind(p) == kind), len(comps))]
    return "/".join(comps + list(inner))


def _kind(name: str) -> str:
    return name.rstrip("0123456789")


def _tag(out) -> None:
    """Store the open path on the nodes the call just made: the outputs'
    ``grad_fn`` and, for a composite op (``matmul`` = view, ``mm``, view),
    the nodes behind it back to the first node already tagged (an output
    made outside every scope is tagged "" so that no later walk passes
    it)."""
    path = current_path()
    todo = [t.grad_fn for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    if not path:
        for node in todo:
            node.metadata.setdefault(_KEY, "")
        return
    while todo:
        node = todo.pop()
        meta = node.metadata
        if _KEY in meta:
            continue
        meta[_KEY] = path
        todo.extend(n for n, _ in node.next_functions
                    if n is not None and type(n).__name__ != "AccumulateGrad")


class _Carry(TorchFunctionMode):
    """Stores the open scope path on the autograd node of each output."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        _tag(out)
        return out


@contextlib.contextmanager
def instrumenting() -> Iterator[None]:
    """Turn on the scope stack and the backward carry (module docstring)
    for the block; nests."""
    if _ACTIVE[0]:
        _ACTIVE[0] += 1
        try:
            yield
        finally:
            _ACTIVE[0] -= 1
        return
    fn = torch.autograd.Function
    apply = fn.__dict__["apply"]

    def tagged_apply(cls, *args, **kwargs):
        out = apply.__func__(cls, *args, **kwargs)
        _tag(out)
        return out

    _ACTIVE[0] = 1
    fn.apply = classmethod(tagged_apply)
    try:
        with _Carry():
            yield
    finally:
        fn.apply = apply
        _ACTIVE[0] = 0


_WORK: List[Optional[dict]] = [None]  # FLOPs by scope path while charging()


def charge(flops: float) -> None:
    """Add ``flops`` to the open scope's count inside :func:`charging`
    (``obs.costs.counting`` and the hand kernels' tallies call it)."""
    work = _WORK[0]
    if work is not None:
        path = current_path()
        work[path] = work.get(path, 0) + flops


@contextlib.contextmanager
def charging() -> Iterator[dict]:
    """Yield ``{scope path: FLOPs}`` of what :func:`charge` counted inside
    the block (with the scope stack on)."""
    prev, _WORK[0] = _WORK[0], {}
    try:
        with instrumenting():
            yield _WORK[0]
    finally:
        _WORK[0] = prev


@contextlib.contextmanager
def recording_scopes() -> Iterator[Set[str]]:
    """Yield the set of names :func:`scope` opens inside the block."""
    global _SEEN
    prev, _SEEN = _SEEN, set()
    try:
        yield _SEEN
    finally:
        _SEEN = prev


def step_annotation(step_num: int, name: str = "train") -> ContextManager[None]:
    """Profiler range marking ONE optimizer step (``train#<step_num>``)."""
    return torch.profiler.record_function(f"{name}#{int(step_num)}")


# The JAX package's op-name cleaning (mpi4dl_tpu/obs/hlo_stats.py:146-191).
_WRAPPER_RE = re.compile(
    r"^(?:jvp|vjp|transpose|vmap|pmap|custom_jvp|custom_vjp|checkpoint|"
    r"remat|rematted_computation)\((.*)\)$"
)
_FRAMING_COMPONENTS = re.compile(
    r"^(?:checkpoint|rematted_computation|remat|while|body|cond|"
    r"branch_\d+(?:_fun)?|None)$"
)


def clean_scope_component(comp: str) -> Optional[str]:
    """One op-name path component reduced to its semantic scope name:
    ``jvp(sp_level0)`` -> ``sp_level0``; jit/shmap framing -> None."""
    while True:
        m = _WRAPPER_RE.match(comp)
        if m is None:
            break
        comp = m.group(1)
    if not comp or comp.startswith(("jit(", "shmap", "pjit(")):
        return None
    if _FRAMING_COMPONENTS.match(comp):
        return None
    return comp


def clean_scope_path(op_name_path: str) -> str:
    """Scope key for one op-name path: wrapper/framing components cleaned,
    the trailing primitive name dropped (it is the op, not a scope)."""
    comps = [clean_scope_component(c) for c in op_name_path.split("/")[:-1]]
    return "/".join(c for c in comps if c)
