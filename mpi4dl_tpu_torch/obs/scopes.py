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
"""

from __future__ import annotations

import contextlib
from typing import ContextManager, Iterator, Optional, Set

import torch

_SEEN: Optional[Set[str]] = None


def scope(name: str) -> ContextManager[None]:
    """Named profiler range for the work done inside the ``with`` block."""
    if _SEEN is not None:
        _SEEN.add(name)
    return torch.profiler.record_function(name)


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
