"""Per-scope attribution of the bytes live at a step's peak (counterpart of
``mpi4dl_tpu/obs/hbm.py``).

The JAX package runs interval liveness over the scheduled compiled module
and reads each buffer's ``obs.scope`` from its ``op_name``.  An eager step
has no compiled module, so :func:`peak_tracker` follows the step itself:
``MemTracker``'s storage accounting (every storage an op returns, rounded as
the caching allocator rounds it on a card, freed when the storage dies)
without its module tracking.  With ``attribute=True`` each storage is also
tagged with the scope path open at its allocation
(:func:`~mpi4dl_tpu_torch.obs.scopes.current_path`: backward allocations
take their forward scope through the carry of ``obs/scopes.py``), every
allocation, resize and free is logged, and the live set at the device's
high-water mark is rebuilt from the log once the step is done.  The entry
tensors (parameters, optimizer state, the batch) are labelled
``"(args) <name>"`` (:data:`ARGS_SCOPE`); a storage made outside every
scope goes under :data:`UNATTRIBUTED`.

The tracker's ``breakdown(device)`` returns ``attribute_hlo``'s dict with the same
keys (``peak_bytes_est``, ``by_scope``, ``top_buffers``, ``coverage``,
``scoped_temp_coverage``, ``live_buffers``).  Its peak IS the tracker's (the
memory probe's, ``benchmarks/mem_probe.py``): no estimate stands between
the two, so on fake tensors ``reconcile`` holds the tracker's own peak
(ratio 1), and on the card ``torch.cuda.max_memory_allocated`` of the same
step (:func:`reconcile`).  The helpers over a breakdown (:func:`top_scope`,
:func:`scope_group_bytes`, :func:`compare_breakdowns`,
:func:`format_breakdown`, :func:`format_delta`, and the ``--delta-parts``
growth groups :func:`growth_groups` / :func:`top_growth_group`) are the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from mpi4dl_tpu_torch.obs import scopes

ARGS_SCOPE = "(args)"
UNATTRIBUTED = "(unattributed)"


def named_tensors(obj, name: str) -> List[Tuple[str, torch.Tensor]]:
    """``(label, tensor)`` of every tensor in ``obj`` (tensors, modules,
    dicts, lists, dataclasses), labelled by ``name`` and the first level of
    field or key below it (``state.params``, ``state.opt``)."""
    def leaves(o) -> List[torch.Tensor]:
        if isinstance(o, torch.Tensor):
            return [o]
        if isinstance(o, torch.nn.Module):
            return list(o.parameters()) + list(o.buffers())
        if isinstance(o, dict):
            return [t for v in o.values() for t in leaves(v)]
        if isinstance(o, (list, tuple)):
            return [t for v in o for t in leaves(v)]
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return [t for f in dataclasses.fields(o) for t in leaves(getattr(o, f.name))]
        return []

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f"{name}.{f.name}", t) for f in dataclasses.fields(obj)
                for t in leaves(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [(f"{name}.{k}", t) for k, v in obj.items() for t in leaves(v)]
    return [(name, t) for t in leaves(obj)]


def peak_tracker(attribute: bool = False):
    """A ``MemTracker`` that keeps only the step's peak (no module tracking,
    which the probe does not read and which cannot follow the engines: its
    hooks refuse a module called twice in one step, its backward hooks fail
    under ``autograd.grad``, and its per-module peaks walk every module at
    every op); with ``attribute`` it logs each storage's scope (module
    docstring).  Built on call: ``torch.distributed._tools`` is imported
    only where a tracker is made."""
    from torch.distributed._tools.mem_tracker import MemTracker, _UpdateType
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Tracker(MemTracker):
        def __init__(self):
            super().__init__()
            self.attribute = attribute
            self._log: List[list] = []  # [device, alloc, free, bytes, scope, desc, cat]
            self._live: Dict[int, int] = {}  # id(winfo) -> log index
            self._ev = 0
            self._peak_ev: Dict[Any, int] = {}
            self._label: Optional[str] = None
            self._desc = ""

        def __enter__(self):
            from torch._guards import active_fake_mode

            self._fake_mode_on_entry = active_fake_mode()
            self._track_resize()
            self._peak_mem_snap = self.get_tracker_snapshot()
            self._peak_mem = {d: s["Total"] for d, s in self._peak_mem_snap.items()}
            self._peak_ev = {d: self._ev for d in self._peak_mem}
            TorchDispatchMode.__enter__(self)
            return self

        def __exit__(self, *args):
            self._restore_resize()
            TorchDispatchMode.__exit__(self, *args)

        def label_external(self, named: List[Tuple[str, torch.Tensor]]) -> None:
            """``track_external`` with each tensor's ``(args)`` label."""
            for name, t in named:
                self._label = f"{ARGS_SCOPE} {name}"
                try:
                    self.track_external(t)
                finally:
                    self._label = None

        def _track(self, reftype, t):
            if self.attribute:
                self._desc = f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
            return super()._track(reftype, t)

        def _update_snap(self, u_type, winfo, old_mem_consumed=None, old_reftype=None):
            super()._update_snap(u_type, winfo, old_mem_consumed, old_reftype)
            if not self.attribute or u_type == _UpdateType.REF:
                return
            self._ev += 1
            key = id(winfo)
            if u_type in (_UpdateType.DEL, _UpdateType.SIZE) and key in self._live:
                old = self._log[self._live.pop(key)]
                old[2] = self._ev
                if u_type == _UpdateType.SIZE:
                    self._open(key, winfo, old[4], old[5], old[6])
            elif u_type == _UpdateType.ADD:
                if self._label is not None:
                    self._open(key, winfo, self._label, self._desc, "argument")
                else:
                    self._open(key, winfo, scopes.current_path(), self._desc, "temp")

        def _open(self, key, winfo, scope, desc, cat):
            self._live[key] = len(self._log)
            self._log.append([winfo.device, self._ev, None, winfo.mem_consumed,
                              scope, desc, cat])

        def _update_peak_stats(self, peak_state) -> None:
            for dev, snap in self._curr_mem_snap.items():
                if self._peak_mem.get(dev, 0) < snap["Total"]:
                    self._peak_mem[dev] = snap["Total"]
                    self._peak_mem_snap[dev] = dict(snap)
                    self._peak_ev[dev] = self._ev

        def breakdown(self, device, top: int = 20) -> dict:
            """``attribute_hlo``'s dict for ``device``'s peak (module
            docstring)."""
            peak = int(self._peak_mem.get(device, 0))
            at = self._peak_ev.get(device, self._ev)
            live = [r for r in self._log if r[0] == device and r[1] <= at
                    and (r[2] is None or r[2] > at)]
            by_scope: Dict[str, int] = {}
            temp_total = temp_scoped = attributed = 0
            for r in live:
                key = r[4] or UNATTRIBUTED
                by_scope[key] = by_scope.get(key, 0) + r[3]
                if r[6] == "temp":
                    temp_total += r[3]
                    temp_scoped += r[3] if r[4] else 0
                attributed += r[3] if r[4] else 0
            live.sort(key=lambda r: -r[3])
            return {
                "peak_bytes_est": peak,
                "by_scope": dict(sorted(by_scope.items(), key=lambda kv: -kv[1])),
                "top_buffers": [{"name": f"storage{i}", "bytes": r[3], "shape": r[5],
                                 "scope": r[4] or UNATTRIBUTED, "category": r[6]}
                                for i, r in enumerate(live[:top])],
                "coverage": round(attributed / peak, 4) if peak else 1.0,
                "scoped_temp_coverage": (round(temp_scoped / temp_total, 4)
                                         if temp_total else 1.0),
                "live_buffers": len(live),
            }

    return _Tracker()


def reconcile(breakdown: dict, actual_bytes: Optional[int], source: str) -> dict:
    """``breakdown`` with its ``reconcile`` sub-dict: the peak it is held
    against (the tracker's own on fake tensors, ``"tracker"``; the card's
    ``torch.cuda.max_memory_allocated``, ``"max_memory_allocated"``) and
    the ratio."""
    breakdown["reconcile"] = {
        "memory_analysis_peak_bytes": actual_bytes,
        "source": source,
        "ratio_est_over_actual": (round(breakdown["peak_bytes_est"] / actual_bytes, 3)
                                  if actual_bytes else None),
    }
    return breakdown


def top_scope(breakdown: dict, prefixes: Optional[Tuple[str, ...]] = None
              ) -> Optional[str]:
    """The scope owning the most peak bytes (arguments and unattributed
    excluded — the question is which *phase* owns the working set).  With
    ``prefixes``, restricted to scopes starting with one of them."""
    best_key, best_val = None, -1
    for k, v in breakdown.get("by_scope", {}).items():
        if k == UNATTRIBUTED or k.startswith(ARGS_SCOPE):
            continue
        if prefixes and not any(k.startswith(p) for p in prefixes):
            continue
        if v > best_val:
            best_key, best_val = k, v
    return best_key


def scope_group_bytes(breakdown: dict, depth: int = 1) -> Dict[str, int]:
    """``by_scope`` rolled up to the first ``depth`` path components
    (``sp_region/sp_level0/cell03`` -> ``sp_region``)."""
    out: Dict[str, int] = {}
    for k, v in breakdown.get("by_scope", {}).items():
        if k == UNATTRIBUTED or k.startswith(ARGS_SCOPE):
            key = k
        else:
            key = "/".join(k.split("/")[:depth])
        out[key] = out.get(key, 0) + v
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def top_group(breakdown: dict) -> Optional[str]:
    """The phase group (:func:`scope_group_bytes`) owning the most peak
    bytes, arguments and unattributed excluded (the probe's
    ``--require-attrib-top`` reading)."""
    return next((k for k in scope_group_bytes(breakdown)
                 if k != UNATTRIBUTED and not k.startswith(ARGS_SCOPE)), None)


def compare_breakdowns(a: dict, b: dict) -> dict:
    """A/B delta of two breakdowns: per-scope byte deltas (B minus A),
    sorted by absolute delta, plus the peak delta."""
    sa, sb = a.get("by_scope", {}), b.get("by_scope", {})
    deltas = {
        k: sb.get(k, 0) - sa.get(k, 0)
        for k in set(sa) | set(sb)
        if sb.get(k, 0) != sa.get(k, 0)
    }
    return {
        "peak_delta_bytes": a and b and (
            b.get("peak_bytes_est", 0) - a.get("peak_bytes_est", 0)
        ),
        "by_scope_delta": dict(
            sorted(deltas.items(), key=lambda kv: -abs(kv[1]))
        ),
    }


def growth_groups(bd_a: dict, bd_b: dict, parts_a: int, parts_b: int) -> dict:
    """Per-phase-group byte growth between two breakdowns of the same config
    at different part counts, normalized per part: ``{group: bytes/part}``
    sorted by growth."""
    ga, gb = scope_group_bytes(bd_a), scope_group_bytes(bd_b)
    dparts = parts_b - parts_a
    if dparts <= 0:
        raise ValueError(f"need parts_b > parts_a, got {parts_a}->{parts_b}")
    out = {
        k: (gb.get(k, 0) - ga.get(k, 0)) / dparts
        for k in set(ga) | set(gb)
        if gb.get(k, 0) != ga.get(k, 0)
    }
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def top_growth_group(growth: dict) -> Optional[str]:
    """The phase group with the largest positive per-part growth (arguments
    and unattributed excluded)."""
    for k, v in growth.items():  # sorted descending
        if k == UNATTRIBUTED or k.startswith(ARGS_SCOPE):
            continue
        return k if v > 0 else None
    return None


def _gb(n: int) -> str:
    if abs(n) >= 2**30:
        return f"{n / 2**30:.2f} GB"
    if abs(n) >= 2**20:
        return f"{n / 2**20:.1f} MB"
    return f"{n / 2**10:.1f} KB"


def format_breakdown(breakdown: dict, top: int = 12) -> str:
    """Human-readable table of one breakdown (the JAX package's text)."""
    peak = breakdown["peak_bytes_est"]
    lines = [
        f"peak (analytical liveness over the schedule): {_gb(peak)}  "
        f"coverage {breakdown['coverage']:.1%} "
        f"(scoped temps {breakdown['scoped_temp_coverage']:.1%})"
    ]
    rec = breakdown.get("reconcile")
    if rec and rec.get("memory_analysis_peak_bytes") is not None:
        lines.append(
            f"memory_analysis peak: {_gb(rec['memory_analysis_peak_bytes'])} "
            f"(est/actual {rec['ratio_est_over_actual']})"
        )
    lines.append("per-scope peak bytes:")
    for k, v in list(breakdown["by_scope"].items())[:top]:
        lines.append(f"  {_gb(v):>10}  {100 * v / peak:5.1f}%  {k}")
    lines.append("largest live buffers at peak:")
    for b in breakdown["top_buffers"][:top]:
        lines.append(
            f"  {_gb(b['bytes']):>10}  {b['category']:<8} "
            f"{b['shape'][:40]:<40} {b['scope']}"
        )
    return "\n".join(lines)


def format_delta(delta: dict, top: int = 12) -> str:
    lines = [f"peak delta: {_gb(delta.get('peak_delta_bytes') or 0)} (B - A)"]
    for k, v in list(delta["by_scope_delta"].items())[:top]:
        lines.append(f"  {'+' if v >= 0 else ''}{_gb(v):>10}  {k}")
    return "\n".join(lines)
