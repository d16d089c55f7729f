"""Bounded retry with exponential backoff for transient I/O (counterpart of
``mpi4dl_tpu/utils/retry.py``).

The data pipeline and the checkpoint layer share this one discipline: NFS
blips, eviction races and stale handles are transient and worth a couple
of bounded retries; every other error propagates at once.  When the budget
is spent, the ORIGINAL exception is re-raised: the first failure is the
evidence, later ones usually echo it.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple, Type, TypeVar

T = TypeVar("T")


def retry_io(
    fn: Callable[[], T],
    *,
    retries: int = 2,
    backoff: float = 0.05,
    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
    no_retry: Tuple[Type[BaseException], ...] = (),
    _sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` with up to ``retries`` retries around ``exceptions``,
    sleeping ``backoff`` seconds (doubling each time) between attempts;
    re-raise the ORIGINAL exception when the budget is spent.

    ``no_retry`` carves deterministic subclasses out of ``exceptions``
    (``FileNotFoundError`` out of ``OSError``): those raise at once."""
    delay = backoff
    first = None
    for remaining in range(retries, -1, -1):
        try:
            return fn()
        except exceptions as e:
            if no_retry and isinstance(e, no_retry):
                raise
            if first is None:
                first = e
            if remaining == 0:
                raise first
            _sleep(delay)
            delay *= 2.0
    raise AssertionError("unreachable")  # the loop returns or raises
