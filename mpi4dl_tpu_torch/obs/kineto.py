"""Reading a ``torch.profiler`` Chrome trace (Kineto's JSON) scope by scope.

The JAX package reads per-op scopes from the compiled HLO's metadata.  In a
profiled eager step the ``obs.scope`` names are ``record_function`` ranges
on the host thread that issued the work, so a device op's scope is found
through the trace's own links:

- a kernel, copy or memset on the card carries the ``correlation`` id of
  the runtime (or driver) call that launched it; that call sits on a host
  thread, inside the ranges open there.  A device op whose launch the trace
  does not hold takes the scope of the op before it on its stream, and is
  counted in ``by_neighbour``;
- backward work runs on autograd's threads, where no forward range is open.
  There the enclosing ``autograd::engine::evaluate_function`` op carries the
  ``Sequence number`` of its node and the profiler's ``Fwd thread id``; the
  forward op with that sequence number sits inside the forward scopes, and
  its path is the backward op's (a checkpointed region's recompute re-opens
  its scopes: ``obs.scopes.recompute_path``).  This is the link ``obs/scopes.py``'s
  carry makes for the memory instruments, read from the trace alone;
- a CPU-only trace has no device ops: its "device" ops are the host's leaf
  ops (aten ops with no op inside them) on their own threads' time.

Range names that are not scope names (``train#3``, ``ProfilerStep#1``,
``nccl:all_reduce``) are no scopes.  :data:`UNSCOPED` holds what no scope
covers; nothing is dropped.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Tuple

from mpi4dl_tpu_torch.obs.scopes import recompute_path

UNSCOPED = "<unscoped>"
_SCOPE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation") + _LAUNCH_CATS
_EVAL = "autograd::engine::evaluate_function"
_EPS = 1e-3  # µs: Kineto rounds nested timestamps


COLLECTIVES_SUFFIX = ".collectives.json"


def load(path_or_trace) -> Dict[str, Any]:
    """A trace dict from a path (``.json`` or ``.json.gz``) or a dict; a
    path's collectives (:func:`save_collectives`) under
    ``"mpi4dl_collectives"``."""
    if isinstance(path_or_trace, dict):
        return path_or_trace
    opener = gzip.open if str(path_or_trace).endswith(".gz") else open
    with opener(path_or_trace, "rt", encoding="utf-8") as fh:
        raw = json.load(fh)
    side = str(path_or_trace) + COLLECTIVES_SUFFIX
    if "mpi4dl_collectives" not in raw and os.path.exists(side):
        with open(side, encoding="utf-8") as fh:
            raw["mpi4dl_collectives"] = json.load(fh)
    return raw


def save_collectives(trace_path: str, records: List[dict]) -> None:
    """Keep the collectives recorded for a traced step beside its trace
    (``obs/comm_stats.py``'s records; :func:`load` reads them back)."""
    with open(str(trace_path) + COLLECTIVES_SUFFIX, "w", encoding="utf-8") as fh:
        json.dump(records, fh)


class Trace:
    """One rank's profiled step: host events with their scope paths, device
    events, and the links between them (module docstring)."""

    def __init__(self, trace):
        self.raw = load(trace)
        xs = [e for e in self.raw.get("traceEvents", ()) if e.get("ph") == "X"]
        self.host = [e for e in xs if e.get("cat") in _HOST_CATS]
        self.device = sorted((e for e in xs if e.get("cat") in _DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.has_device = bool(self.device)
        self._paths: Dict[int, str] = {}
        self._backward: set = set()
        self._scope_host()

    # -- host side: ranges, ops and their paths ------------------------------

    def _scope_host(self) -> None:
        by_tid: Dict[Any, List[dict]] = {}
        for e in self.host:
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        fwd: Dict[Tuple[Any, int], str] = {}
        pending = []  # backward events: (event, seq, fwd_tid, inner, outer)
        self.leaves: List[dict] = []
        for key, evs in by_tid.items():
            evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
            stack: List[dict] = []
            for e in evs:
                while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"] + _EPS:
                    stack.pop()
                names, node, inner = [], None, []
                for a in stack:
                    if a.get("cat") == "cpu_op" and a["name"].startswith(_EVAL):
                        if node is None:
                            node, inner = a, []
                    elif a.get("cat") == "user_annotation" and _SCOPE_NAME.match(a["name"]):
                        (inner if node is not None else names).append(a["name"])
                outer = "/".join(names)
                args = e.get("args") or {}
                if node is None:
                    self._paths[id(e)] = outer
                    seq = args.get("Sequence number")
                    if (e.get("cat") == "cpu_op" and seq is not None
                            and not args.get("Fwd thread id")):
                        fwd.setdefault((key, int(seq)), outer)
                else:
                    na = node.get("args") or {}
                    pending.append((e, na.get("Sequence number"), na.get("Fwd thread id"),
                                    inner, names))
                    self._backward.add(id(e))
                if e.get("cat") == "cpu_op":
                    for a in stack:
                        if a.get("cat") == "cpu_op":
                            a["_inner"] = True
                stack.append(e)
        # The profiler's forward-thread ids are its own; map each to a host
        # thread by the sequence numbers only one thread has.
        votes: Dict[Any, Counter] = {}
        for _, seq, ftid, _, _ in pending:
            if seq is None:
                continue
            owners = [k for k in by_tid if (k, int(seq)) in fwd]
            if len(owners) == 1:
                votes.setdefault(ftid, Counter())[owners[0]] += 1
        owner_of = {f: c.most_common(1)[0][0] for f, c in votes.items()}
        for e, seq, ftid, inner, outer in pending:
            base = ""
            if seq is not None:
                owner = owner_of.get(ftid)
                if owner is None:
                    owners = [k for k in by_tid if (k, int(seq)) in fwd]
                    owner = owners[0] if owners else None
                base = fwd.get((owner, int(seq)), "") if owner is not None else ""
            self._paths[id(e)] = recompute_path(base, inner) or "/".join(outer)
        self.leaves = [e for e in self.host
                       if e.get("cat") == "cpu_op" and not e.get("_inner")]

    def in_backward(self, host_event: dict) -> bool:
        """Whether a host event ran inside an autograd node's evaluation."""
        return id(host_event) in self._backward

    def path_of(self, host_event: dict) -> str:
        """The scope path of a host event ("" outside every scope)."""
        return self._paths.get(id(host_event), "")

    def host_ops(self, prefixes: Tuple[str, ...]) -> List[Dict[str, Any]]:
        """Host ops whose names start with one of ``prefixes``, leaf or not,
        as :meth:`device_ops` gives ops."""
        return [{"name": e["name"], "cat": "cpu_op", "ts": e["ts"],
                 "dur": e.get("dur", 0.0), "stream": e.get("tid"),
                 "scope": self.path_of(e) or UNSCOPED, "linked": True,
                 "backward": self.in_backward(e), "launch_ts": e["ts"]}
                for e in self.host
                if e.get("cat") not in _LAUNCH_CATS and e["name"].startswith(prefixes)]

    # -- device side ---------------------------------------------------------

    def device_ops(self) -> List[Dict[str, Any]]:
        """``{name, cat, ts, dur, stream, scope, linked, backward}`` of every
        device op (a CPU-only trace: every leaf host op), in time order;
        ``scope`` is a path or :data:`UNSCOPED`, ``backward`` whether its
        launch ran in an autograd node (None where unlinked)."""
        if not self.has_device:
            return [{"name": e["name"], "cat": "cpu_op", "ts": e["ts"],
                     "dur": e.get("dur", 0.0), "stream": e.get("tid"),
                     "scope": self.path_of(e) or UNSCOPED, "linked": True,
                     "backward": self.in_backward(e), "launch_ts": e["ts"]}
                    for e in sorted(self.leaves, key=lambda e: e["ts"])]
        launch = {}
        for e in self.host:
            if e.get("cat") in _LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch[c] = e
        out, last_on = [], {}
        for e in self.device:
            args = e.get("args") or {}
            stream = (e.get("pid"), e.get("tid"))
            src = launch.get(args.get("correlation"))
            if src is not None:
                scope, linked = self.path_of(src) or UNSCOPED, True
            else:
                scope, linked = last_on.get(stream, UNSCOPED), False
            last_on[stream] = scope
            out.append({"name": e["name"], "cat": e.get("cat"), "ts": e["ts"],
                        "dur": e.get("dur", 0.0), "stream": stream, "scope": scope,
                        "linked": linked, "launch_ts": src["ts"] if src else None,
                        "backward": self.in_backward(src) if src else None})
        return out


def is_wire(op: Dict[str, Any]) -> bool:
    """A collective's device op: an NCCL kernel on the card, a ``c10d``,
    gloo or NCCL op of the host in a CPU-only trace."""
    name = op["name"]
    if op.get("cat") == "cpu_op":
        return name.startswith(("c10d::", "gloo:", "nccl:"))
    return "nccl" in name.lower()


def busy_intervals(ops: Iterable[Dict[str, Any]]) -> List[Tuple[float, float]]:
    """The union of the ops' ``[ts, ts + dur]`` intervals, merged (µs)."""
    spans = sorted((o["ts"], o["ts"] + o["dur"]) for o in ops)
    out: List[List[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(a: float, b: float, spans: List[Tuple[float, float]]) -> float:
    """Length of ``[a, b]`` covered by the merged ``spans``."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in spans if x < b and y > a)


def span_of(ops: List[Dict[str, Any]]) -> Optional[Tuple[float, float]]:
    if not ops:
        return None
    return min(o["ts"] for o in ops), max(o["ts"] + o["dur"] for o in ops)
