"""Deterministic fault injection (counterpart of
``mpi4dl_tpu/resilience/faults.py``; the same kinds, hatch and hooks).

One hatch drives everything: ``MPI4DL_FAULT=<kind>@<step>[:arg]``.  The
supervised loop calls the injector at fixed,
documented points, so a fault fires at exactly one global step and the same
spec reproduces the same failure in pytest, in the CI drill jobs, and in a
by-hand run.  Kinds:

===================  ========================================================
``nan_loss``         replace the observed loss at step k with NaN (guard
                     path without touching device state)
``nan_batch``        poison the input batch at step k with NaN (device state
                     genuinely corrupts — the full rollback path)
``raise``            raise :class:`FaultInjected` before step k (crash path)
``sigterm``          deliver SIGTERM to this process before step k
                     (preemption path: finish the step, checkpoint, exit 0)
``corrupt_ckpt``     flip bytes mid-file in the first checkpoint written at
                     or after step k (restore must fall back to an older
                     file); on a sharded checkpoint the largest shard file
                     is corrupted
``lost_shard_files`` a host's shard files vanish: delete alternate shard
                     files from the first checkpoint written at or after
                     step k (cheap validation must reject it and restore
                     must fall back)
``reshape``          deliver SIGTERM before step k like ``sigterm``, but
                     declare that the RESUME must run under a different
                     geometry — ``arg`` is a free-form spec (e.g.
                     ``slice-method=horizontal,parts=2``) the drill runner
                     applies to the resume leg's flags; the loop itself
                     treats it as a preemption
``stall_data``       the data producer sleeps ``arg`` seconds (default 2.0)
                     before batch k (watchdog path)
``oom_compile``      raise a synthetic ``RESOURCE_EXHAUSTED`` out-of-memory
                     error on the process's FIRST step once the step count
                     reaches k — the phase where a first-call OOM lands
                     (allocator warm-up, kernel builds), so the supervisor
                     classifies it ``oom_compile``
``oom_step``         raise the same synthetic ``RESOURCE_EXHAUSTED`` error
                     before step k (any step — a mid-run allocator OOM)
``mesh_shrunk``      raise :class:`MeshShrunk` before step k; ``arg`` is a
                     free-form spec (e.g. ``devices=4``) naming the
                     surviving device set the planner must re-plan within
``slow_step``        the training thread sleeps ``arg`` seconds (default
                     2.0) inside the armed watchdog window before step k —
                     the straggler the watchdog must ESCALATE on, not just
                     dump (``MPI4DL_WATCHDOG_ESCALATE``)
``io_error``         raise ``OSError`` before step k (the transient-I/O
                     class: the supervisor retries with backoff, no
                     geometry change)
===================  ========================================================

Every injector fires at most once per process — deterministic single-shot
semantics, so "exactly one rollback" is a meaningful assertion.

Ranks (the port's addition): ``MPI4DL_FAULT_RANKS`` (a comma-separated
list) confines the fault to those ranks of a job; unset, every rank
injects it.  One rank's ``oom_step`` is how a rank set's failure evidence
is tested: the supervisor must report that rank's class, not the stuck
peers'.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Optional

FAULT_KINDS = (
    "nan_loss", "nan_batch", "raise", "sigterm", "corrupt_ckpt",
    "lost_shard_files", "reshape", "stall_data",
    "oom_compile", "oom_step", "mesh_shrunk", "slow_step", "io_error",
)

# Kinds whose effect is applied to the just-written checkpoint (after_save).
CKPT_FAULT_KINDS = ("corrupt_ckpt", "lost_shard_files")

# Kinds whose ``:arg`` is free text, not a number.
_TEXT_ARG_KINDS = ("reshape", "mesh_shrunk")


class FaultInjected(RuntimeError):
    """The injected crash for ``MPI4DL_FAULT=raise@<step>``."""


class MeshShrunk(RuntimeError):
    """The device set shrank under the run (``MPI4DL_FAULT=mesh_shrunk@k``,
    or — on real hardware — a slice losing chips).  ``spec`` is the
    free-form surviving-geometry description (e.g. ``devices=4``) the
    supervisor's planner re-plans within."""

    def __init__(self, spec: str = ""):
        super().__init__(
            f"mesh shrank under the run ({spec or 'no surviving spec'})"
        )
        self.spec = spec


def synthetic_oom(kind: str, gstep: int) -> BaseException:
    """A ``torch.OutOfMemoryError`` (what the CUDA caching allocator raises,
    so ``except torch.OutOfMemoryError`` handlers see a device OOM) carrying
    the JAX package's message word for word: the supervisor's classifier
    keys on the ``RESOURCE_EXHAUSTED`` text in either package."""
    import torch

    msg = (
        f"RESOURCE_EXHAUSTED: injected {kind} at step {gstep}: Out of "
        "memory while trying to allocate synthetic fault payload "
        "(MPI4DL_FAULT)"
    )
    return torch.OutOfMemoryError(msg)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    step: int
    arg: float = 0.0
    opts: str = ""  # non-numeric arg text (the reshape geometry spec)


def parse_fault(text: Optional[str]) -> Optional[FaultSpec]:
    """Parse ``<kind>@<step>[:arg]``; empty/None means no fault.  A numeric
    ``arg`` lands in ``FaultSpec.arg``; anything else (the reshape spec) in
    ``FaultSpec.opts``."""
    if not text:
        return None
    head, _, arg = text.partition(":")
    kind, sep, step = head.partition("@")
    if kind not in FAULT_KINDS or not sep or not step.lstrip("-").isdigit():
        raise ValueError(
            f"MPI4DL_FAULT={text!r}: expected <kind>@<step>[:arg] with kind "
            f"in {FAULT_KINDS}"
        )
    num, opts = 0.0, ""
    if arg:
        if kind in _TEXT_ARG_KINDS:  # free-text arg (geometry specs)
            opts = arg
        else:
            try:
                num = float(arg)
            except ValueError:
                raise ValueError(
                    f"MPI4DL_FAULT={text!r}: {kind} takes a numeric arg, "
                    f"got {arg!r}"
                ) from None
    return FaultSpec(kind, int(step), num, opts)


def fault_from_env() -> Optional[FaultSpec]:
    """``MPI4DL_FAULT``, or None on a rank that ``MPI4DL_FAULT_RANKS``
    leaves out."""
    spec = parse_fault(os.environ.get("MPI4DL_FAULT", ""))
    ranks = os.environ.get("MPI4DL_FAULT_RANKS", "").strip()
    if spec is not None and ranks:
        from mpi4dl_tpu_torch.resilience.supervisor import process_rank

        if process_rank() not in {int(t) for t in ranks.split(",") if t.strip()}:
            return None
    return spec


def _dir_shard_files(path: str):
    """Shard payload files of a sharded checkpoint dir, largest first."""
    out = []
    for fn in os.listdir(path):
        if fn.endswith(".bin"):
            p = os.path.join(path, fn)
            out.append((os.path.getsize(p), p))
    return [p for _sz, p in sorted(out, reverse=True)]


def corrupt_file(path: str, nbytes: int = 64) -> None:
    """Flip ``nbytes`` in the middle of ``path`` — simulates on-disk
    corruption the container layer may not even notice (the manifest CRC
    does).  On a sharded checkpoint DIRECTORY the largest shard file is
    corrupted (its size is unchanged, so only the CRC pass can tell)."""
    if os.path.isdir(path):
        shards = _dir_shard_files(path)
        assert shards, f"{path}: no shard files to corrupt"
        path = shards[0]
    size = os.path.getsize(path)
    off = size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(min(nbytes, max(size - off, 1)))
        f.seek(off)
        f.write(bytes((~b) & 0xFF for b in chunk))
        f.flush()
        os.fsync(f.fileno())


def lose_shard_files(path: str) -> None:
    """Make a host's shard files vanish: delete alternate shard files (at
    least one) from a sharded checkpoint dir, manifest left intact — the
    manifest-first cheap validation must reject the checkpoint on a stat
    pass.  On a v1 file the whole checkpoint vanishes (one file IS the
    host's shard set there)."""
    if os.path.isdir(path):
        shards = _dir_shard_files(path)
        assert shards, f"{path}: no shard files to lose"
        for p in shards[::2]:
            os.unlink(p)
    else:
        os.unlink(path)


class FaultInjector:
    """Single-shot injectors for the supervised loop's fixed points."""

    def __init__(self, spec: Optional[FaultSpec] = None):
        self.spec = spec
        self.fired = False
        self._steps_seen = 0  # before_step calls — first call = first step

    @classmethod
    def from_env(cls) -> "FaultInjector":
        return cls(fault_from_env())

    def _fire(self, kind: str, gstep: int) -> bool:
        if self.spec is None or self.fired:
            return False
        if self.spec.kind != kind or gstep != self.spec.step:
            return False
        self.fired = True
        return True

    # -- loop hook points --------------------------------------------------

    def before_step(self, gstep: int) -> None:
        """Crash/preemption faults, delivered before the step runs.  A
        ``reshape`` fault is a preemption here — the geometry change it
        declares happens at RESUME time (the drill runner applies
        ``spec.opts`` to the resume leg's flags).  ``oom_compile`` fires on
        the process's FIRST step once ``gstep >= k`` (at-or-after, so a
        resumed leg starting past k still exercises the compile phase);
        every other kind fires exactly at step k."""
        self._steps_seen += 1
        if (
            self.spec is not None and not self.fired
            and self.spec.kind == "oom_compile"
            and self._steps_seen == 1 and gstep >= self.spec.step
        ):
            self.fired = True
            raise synthetic_oom("oom_compile", gstep)
        if self._fire("raise", gstep):
            raise FaultInjected(f"injected crash before step {gstep}")
        if self._fire("oom_step", gstep):
            raise synthetic_oom("oom_step", gstep)
        if self._fire("mesh_shrunk", gstep):
            raise MeshShrunk(self.spec.opts)
        if self._fire("io_error", gstep):
            raise OSError(
                f"injected transient I/O failure before step {gstep} "
                "(MPI4DL_FAULT=io_error)"
            )
        if self._fire("slow_step", gstep):
            time.sleep(self.spec.arg or 2.0)
        if self._fire("sigterm", gstep) or self._fire("reshape", gstep):
            os.kill(os.getpid(), signal.SIGTERM)

    def poison_batch(self, gstep: int, x: Any) -> Any:
        if self._fire("nan_batch", gstep):
            import numpy as np

            x = np.asarray(x).copy()
            x[...] = np.nan
        return x

    def poison_loss(self, gstep: int, loss: float) -> float:
        if self._fire("nan_loss", gstep):
            return float("nan")
        return loss

    def after_save(self, step_id: int, path: Optional[str]) -> None:
        """``corrupt_ckpt`` / ``lost_shard_files``: fires on the first save
        at or after the spec step (saves land on epoch boundaries, not
        every step)."""
        if (
            self.spec is not None
            and self.spec.kind in CKPT_FAULT_KINDS
            and not self.fired
            and step_id >= self.spec.step
            and path is not None
            and os.path.exists(path)
        ):
            self.fired = True
            if self.spec.kind == "corrupt_ckpt":
                corrupt_file(path)
            else:
                lose_shard_files(path)

    def stall_seconds(self, gstep: int) -> float:
        """Called by the data producer for each batch index; nonzero means
        sleep that long before producing (the watchdog's test stimulus)."""
        if self._fire("stall_data", gstep):
            return self.spec.arg or 2.0
        return 0.0
