"""Background checkpoint writer (counterpart of
``mpi4dl_tpu/resilience/writer.py``).

A synchronous ``CheckpointManager.save`` stalls the training loop for the
full device-to-host copy, CRC32, write and fsync of every leaf.  The split:
the device-to-host copies MUST happen on the training thread (the very
next step updates the parameters in place), but the CRC32, shard writes,
fsync and the atomic rename are pure host work — they move to one worker
thread.

The handoff is PER SHARD: the training thread copies one shard at a time
to the host and enqueues it; the worker writes and frees it.  A byte
budget (``max_pending_bytes``, default the ``MPI4DL_CKPT_HOST_BYTES``
hatch, 1 GiB) bounds how many copied-but-unwritten bytes may exist at once
— the training thread blocks (backpressure) instead of holding the full
state on the host, so peak host memory during a save is O(budget + largest
shard), not O(full state).  ``peak_pending_bytes`` records the realized
watermark.  Each save's :class:`~mpi4dl_tpu_torch.checkpoint.SaveStats`
carries ``stall_ms`` (how long ``save`` held the training thread) and
``durable_ms`` (from the start of ``save`` until the checkpoint was
published).

Ranks.  With a process group on the manager, a save is collective
(``CheckpointManager.plan_save`` / ``commit_save``).  The training thread
runs the first half on the manager's group (who writes which leaf, the
temporary directory), copies its own leaves and enqueues them; the commit
exchange (errors and manifest entries to rank 0, rank 0 publishes, the
outcome back to every rank) runs on the worker, over a second gloo group
that the writer creates in its constructor on every rank and that only its
worker uses.  No collective of the training thread's groups ever runs on
the worker, and every rank queues its saves in the same order, so the
workers' exchanges pair up.  The on-disk layout is ``CheckpointManager.save``'s,
byte for byte.

Failure semantics: a worker-side error aborts the in-flight transaction
(its hidden temporary directory is removed — never a torn published
checkpoint), is latched, and is raised again on the NEXT
``save``/``flush``/``close`` on the training thread — checkpoint loss must
fail the run loudly, never silently.  On ranks the failing rank reports
its error through the commit exchange, so every rank aborts and latches
that save's failure; an error latched on one rank alone (``on_saved``
raising after the commit) is agreed by a MAX all-reduce over the
manager's group at the top of every ``save`` and ``flush``, so every rank
raises there together instead of the others waiting in the next save's
collectives.  ``flush()`` blocks until every queued write is on disk (the
loop calls it before a rollback's restore, before a preemption exit and
at the end of the run, so "saved" always means durable at those points);
``close()`` waits for the worker however long the last write takes, and
destroys the writer's group.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

from mpi4dl_tpu_torch.checkpoint import CheckpointManager, SaveStats, state_to_arrays

# Default copied-but-unwritten byte budget when the hatch is unset.
DEFAULT_PENDING_BYTES = 1 << 30


def pending_bytes_budget(flag_value: Optional[int] = None) -> int:
    """Resolve the host-byte budget: explicit value wins, then the
    ``MPI4DL_CKPT_HOST_BYTES`` hatch, then 1 GiB."""
    if flag_value is not None:
        return int(flag_value)
    val = int(os.environ.get("MPI4DL_CKPT_HOST_BYTES", "0") or 0)
    return val if val > 0 else DEFAULT_PENDING_BYTES


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed (original error chained)."""


class _ByteBudget:
    """Counting semaphore over bytes with a watermark.  A single item larger
    than the whole budget is admitted alone (otherwise it could never be
    saved); everything else blocks until the worker drains."""

    def __init__(self, limit: int):
        self.limit = max(1, int(limit))
        self.used = 0
        self.peak = 0
        self._cond = threading.Condition()

    def acquire(self, n: int) -> int:
        """Admit ``n`` bytes; returns the post-acquire outstanding total (the
        caller's per-save watermark sample)."""
        with self._cond:
            while self.used > 0 and self.used + n > self.limit:
                self._cond.wait()
            self.used += n
            self.peak = max(self.peak, self.used)
            return self.used

    def release(self, n: int) -> None:
        with self._cond:
            self.used -= n
            self._cond.notify_all()


class AsyncCheckpointWriter:
    """Two-phase async saves over a :class:`CheckpointManager`.

    ``on_saved`` (optional) is called on the worker thread with the final
    :class:`SaveStats` after each checkpoint is durably committed — the
    supervised loop uses it to emit the ``checkpoint`` RunLog record."""

    _SENTINEL = object()

    def __init__(self, manager: CheckpointManager,
                 max_pending_bytes: Optional[int] = None,
                 on_saved: Optional[Callable[[SaveStats], None]] = None):
        self.manager = manager
        self.on_saved = on_saved
        self.budget = _ByteBudget(pending_bytes_budget(max_pending_bytes))
        # The byte budget is the only backpressure, for BOTH formats (npz
        # whole-state payloads acquire their full size).  The queue is not
        # bounded by items: a state of many small leaves (AmoebaNet's 1382)
        # under an item bound would throttle the training thread to the
        # worker's write rate far below the byte budget.
        self._q: "queue.Queue" = queue.Queue()
        self._group = None
        if manager.group is not None:
            import torch.distributed as dist

            # The worker's own group: created here, on the training thread,
            # by every rank in the same order; used by the worker alone.
            self._group = dist.new_group(
                ranks=dist.get_process_group_ranks(manager.group), backend="gloo")
        self._error: Optional[BaseException] = None
        # Dead transactions are tracked by a per-save sequence number, NOT
        # id(txn): an aborted txn is garbage-collected and a later one can
        # reuse its address.  Sequence numbers are never reused.  On ranks
        # a dead save's error waits for its commit exchange.
        self._seq = itertools.count()
        self._dead_txns: set = set()
        self._txn_errors: Dict[int, str] = {}
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name="mpi4dl-ckpt-writer", daemon=True
        )
        self._thread.start()

    @property
    def peak_pending_bytes(self) -> int:
        """Writer-lifetime watermark of copied-but-unwritten host bytes."""
        return self.budget.peak

    def save(self, state: Any, step_id: int) -> str:
        """Copy to the host on the calling thread (shard by shard under the
        byte budget for sharded managers; the whole state for npz), enqueue
        the writes; returns the path the checkpoint WILL land at."""
        self._check(agree=True)
        if self._closed:
            raise CheckpointWriteError("writer is closed")
        t0 = time.perf_counter()
        if self.manager.format != "sharded":
            arrays = state_to_arrays(state, step_id)
            nbytes = sum(a.numel() * a.element_size() for a in arrays.values())
            self.budget.acquire(nbytes)
            self._q.put(("npz", arrays, step_id, nbytes, t0,
                         (time.perf_counter() - t0) * 1e3))
            return self.manager.path_for(step_id)
        txn, leaves, ids = self.manager.plan_save(state, step_id)
        seq = next(self._seq)
        try:
            for leaf_id in ids:
                leaf = leaves[leaf_id]
                txn.add_leaf(leaf_id, {"shape": list(leaf.shape), "dtype": leaf.dtype})
                for offset, gather in leaf.shards:
                    if self._group is None:
                        self._check()  # on ranks only the exchange decides
                    t = time.perf_counter()
                    arr = gather()
                    txn.stats.gather_ms += (time.perf_counter() - t) * 1e3
                    nbytes = arr.numel() * arr.element_size()
                    outstanding = self.budget.acquire(nbytes)
                    txn.stats.peak_pending_bytes = max(
                        txn.stats.peak_pending_bytes, outstanding
                    )
                    self._q.put(("shard", seq, txn, leaf_id, offset, arr,
                                 nbytes))
                    del arr
        except BaseException as e:
            # The worker may hold queued shards of this txn; mark it dead so
            # they are skipped (and their budget released).  Alone, abort
            # now; on ranks the commit exchange must still run (the other
            # ranks' workers wait in it) and carries this rank's error.
            self._dead_txns.add(seq)
            if self._group is None:
                txn.abort()
            else:
                self._q.put(("commit", seq, txn, f"rank {self.manager.rank}: {e!r}",
                             t0))
            raise
        txn.stats.stall_ms = (time.perf_counter() - t0) * 1e3
        self._q.put(("commit", seq, txn, None, t0))
        return txn.path

    def flush(self) -> None:
        """Block until every queued write is durable; raise on any failure
        (on ranks: on any rank's, on every rank)."""
        self._q.join()
        self._check(agree=True)

    def close(self) -> None:
        """Drain, stop the worker, surface this rank's pending error."""
        if not self._closed:
            self._closed = True
            self._q.put(self._SENTINEL)
            self._thread.join()
            if self._group is not None:
                import torch.distributed as dist

                dist.destroy_process_group(self._group)
                self._group = None
        self._check()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals ---------------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._SENTINEL:
                    return
                kind = item[0]
                if kind == "npz":
                    _, arrays, step_id, nbytes, t0, stall_ms = item
                    try:
                        self.manager.save_arrays(arrays, step_id)
                    finally:
                        self.budget.release(nbytes)
                    stats = self.manager.last_save_stats
                    stats.stall_ms = stall_ms
                    stats.durable_ms = (time.perf_counter() - t0) * 1e3
                    if self.on_saved:
                        self.on_saved(stats)
                elif kind == "shard":
                    _, seq, txn, leaf_id, offset, arr, nbytes = item
                    try:
                        if seq not in self._dead_txns:
                            try:
                                txn.add_shard(leaf_id, offset, arr)
                            except BaseException as e:
                                self._dead_txns.add(seq)
                                if self._group is None:
                                    txn.abort()
                                    raise
                                self._txn_errors[seq] = f"rank {self.manager.rank}: {e!r}"
                    finally:
                        self.budget.release(nbytes)
                elif kind == "commit":
                    _, seq, txn, error, t0 = item
                    if self._group is not None:
                        self._dead_txns.discard(seq)
                        error = error or self._txn_errors.pop(seq, None)
                        stats = self.manager.commit_save(txn, error, self._group)
                    elif seq in self._dead_txns:
                        self._dead_txns.discard(seq)
                        continue
                    else:
                        stats = self.manager.finish_save(txn)
                    stats.durable_ms = (time.perf_counter() - t0) * 1e3
                    if self.on_saved:
                        self.on_saved(stats)
            except BaseException as e:  # latched for the training thread
                self._error = e
            finally:
                self._q.task_done()

    def _check(self, agree: bool = False) -> None:
        """Raise the latched worker error.  ``agree`` (training thread, on
        ranks): first take the MAX of "an error is latched" over the
        manager's group, and raise on every rank if any rank has one."""
        err = self._error
        if agree and self.manager.group is not None:
            import torch
            import torch.distributed as dist

            t = torch.tensor([int(err is not None)], dtype=torch.int32)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.manager.group)
            if t.item() and err is None:
                raise CheckpointWriteError(
                    "background checkpoint write failed on another rank")
        if err is not None:
            self._error = None
            raise CheckpointWriteError(
                f"background checkpoint write failed: {err!r}"
            ) from err
