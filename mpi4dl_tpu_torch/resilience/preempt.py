"""Preemption-safe shutdown (counterpart of
``mpi4dl_tpu/resilience/preempt.py``).

Cloud preemption (and any batch scheduler worth the name) delivers SIGTERM
with a grace window.  The handler here only sets a flag; the supervised
loop checks it AFTER each completed step, saves a checkpoint, and returns
cleanly — so the process finishes the in-flight step, persists, and exits
0 instead of dying mid-write.  A second signal restores the original
disposition and re-raises it: an operator mashing Ctrl-C (or a scheduler
escalating) still gets an immediate kill.

Installation degrades gracefully off the main thread (``signal.signal``
raises there): the loop simply runs unsupervised — important for pytest
workers and embedded use.  Under ``torchrun`` the ranks do not see a
signal at the same moment; the loop agrees on the flag across its process
group once the step is done (:mod:`mpi4dl_tpu_torch.resilience.loop`).
"""

from __future__ import annotations

import os
import signal
from typing import Callable, Dict, Optional, Tuple


class PreemptionHandler:
    """Context manager latching SIGTERM/SIGINT into a ``requested`` flag.

    ``on_signal`` (optional) fires once when the FIRST signal latches —
    inside the signal handler, so it must be async-signal-tolerant (the
    flight recorder's in-memory note qualifies; anything blocking does not).
    """

    def __init__(self, signums: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
                 on_signal: Optional[Callable[[int], None]] = None):
        self.signums = tuple(signums)
        self.on_signal = on_signal
        self.requested = False
        self.signum: Optional[int] = None
        self.active = False
        self._old: Dict[int, object] = {}

    def __enter__(self) -> "PreemptionHandler":
        try:
            for s in self.signums:
                self._old[s] = signal.signal(s, self._handle)
            self.active = bool(self.signums)
        except ValueError:  # not the main thread — run without the net
            self._restore()
        return self

    def __exit__(self, *exc) -> None:
        self._restore()

    def _handle(self, signum, frame) -> None:
        if self.requested:
            # Second signal: give the signal its original meaning back and
            # redeliver — escalation must still kill a wedged process.
            self._restore()
            os.kill(os.getpid(), signum)
            return
        self.requested = True
        self.signum = signum
        if self.on_signal is not None:
            try:
                self.on_signal(signum)
            except Exception:  # noqa: BLE001  # analysis: ok(swallow-except)
                pass  # deliberate: a notify hook must not break the latch

    def _restore(self) -> None:
        for s, h in self._old.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                continue  # torn down off-thread / at interpreter exit
        self._old = {}
        self.active = False
