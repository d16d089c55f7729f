"""Named trace scopes (counterpart of ``mpi4dl_tpu/obs/scopes.py``).

:func:`scope` opens a ``torch.profiler.record_function`` range, so a
profiler trace of a step reads ``cell03/...`` instead of anonymous kernels.
The names are the JAX package's (``cellNN`` per cell).  Outside a profiler
session ``record_function`` is a cheap no-op.
"""

from __future__ import annotations

from typing import ContextManager

import torch


def scope(name: str) -> ContextManager[None]:
    """Named profiler range for the work done inside the ``with`` block."""
    return torch.profiler.record_function(name)
