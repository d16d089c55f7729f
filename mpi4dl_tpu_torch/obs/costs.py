"""Derived cost metrics: FLOPs, bytes, MFU, arithmetic intensity
(counterpart of ``mpi4dl_tpu/obs/costs.py``).

The JAX package reads XLA's cost model of the compiled step.  An eager
PyTorch step has no compiled program, so :func:`counting` counts one step
as it runs:

- **FLOPs**: as ``torch.utils.flop_counter.FlopCounterMode`` counts them
  (its formulas, applied by this module's dispatch mode so that an error in
  a formula is reported instead of failing the step): matmuls,
  convolutions (their backward too) and attention, and no elementwise op
  or reduction.  XLA's cost model counts those as well, so
  the two counts differ: at AmoebaNet-D(3, 16) 128² bs2, kernels off, the
  port's is 0.469 of the JAX package's, the BatchNorms and pools being half
  of XLA's count at that width.
- **Bytes**: Σ over the aten ops the step dispatches of the tensors each
  reads and writes (views and ``empty`` move none): every output is a
  write; every tensor argument is a read except those the op only writes
  (``out=`` arguments, and the ``self`` of ``copy_``, ``fill_`` and
  ``zero_``), so ``copy_`` moves its source and destination
  once each and an in-place ``add_`` reads and writes ``self``.  In eager
  mode every op reads its inputs from and writes its outputs to device
  memory, so this is the eager step's traffic, not the least a fused
  program would need.
- **The hand kernels** (K1/K2 ``ops/halo_conv.py``, K3 ``ops/
  flash_attention.py``) launch through ctypes and dispatch no aten op, so
  neither mode sees them.  Each wrapper adds its launch and the launch's
  work to its ``TALLY`` where it launches (a shape formula: conv FLOPs as
  ``FlopCounterMode`` counts the plain version, inputs read and outputs
  written once), and :func:`counting` adds the tallies' growth.  A tally
  is never reset, so ``reset_launch_counts`` inside a counted block loses
  no work.  On CPU
  tensors the wrappers take the plain versions, which ``FlopCounterMode``
  counts and which tally nothing, so the card and the CPU give one FLOP
  count for one step.

MFU is achieved FLOP/s over the card's published dense bf16 peak
(:data:`PEAK_BF16_FLOPS`, keyed by a substring of
``torch.cuda.get_device_name``).  On the CPU there is no defensible peak:
:func:`peak_flops` returns ``(None, None)`` unless asked for
:data:`CPU_NOMINAL_PEAK_FLOPS`, labeled ``"nominal-cpu"`` (a fixed
reference point for smoke runs, not a utilization claim).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# Dense bf16 peak FLOP/s by card, matched by substring of the lowercased
# torch.cuda.get_device_name (first match wins).  H100 SXM5: 989 TFLOP/s
# (NVIDIA H100 data sheet); the card reads "NVIDIA H100 80GB HBM3".
PEAK_BF16_FLOPS = [
    ("h100 80gb hbm3", 989e12),
]

# Labeled reference peak for CPU smoke runs — a nominal 100 GFLOP/s core,
# not a measured host capability.
CPU_NOMINAL_PEAK_FLOPS = 1e11

# Aggregate interconnect bytes/s a card, matched like PEAK_BF16_FLOPS:
# NVLink 4 on the H100 SXM5, 900 GB/s (NVIDIA H100 data sheet).
ICI_BYTES_PER_S = [
    ("h100 80gb hbm3", 9.0e11),
]

# Labeled nominal interconnect for CPU runs (a fixed 10 GB/s reference,
# not a host measurement; the contract of the nominal peak).
DEFAULT_ICI_BYTES_PER_S = 1e10


def ici_bytes_per_s(device) -> Tuple[float, str]:
    """(aggregate interconnect bytes/s, source) for a torch device; source
    as :func:`peak_flops`: ``"table"``, ``"assumed-max"``, ``"nominal-cpu"``."""
    if device is None or torch.device(device).type == "cpu":
        return DEFAULT_ICI_BYTES_PER_S, "nominal-cpu"
    kind = torch.cuda.get_device_name(torch.device(device)).lower()
    for sub, bw in ICI_BYTES_PER_S:
        if sub in kind:
            return bw, "table"
    return max(b for _, b in ICI_BYTES_PER_S), "assumed-max"


def peak_flops(device, allow_cpu_nominal: bool = False) -> Tuple[Optional[float], Optional[str]]:
    """(peak FLOP/s, source) for a torch device.

    source: ``"table"`` (known card), ``"assumed-max"`` (unknown card —
    the largest entry, so an mfu>1 impossibility check stays sound),
    ``"nominal-cpu"`` (only with ``allow_cpu_nominal``), or None."""
    if torch.device(device).type == "cpu":
        if allow_cpu_nominal:
            return CPU_NOMINAL_PEAK_FLOPS, "nominal-cpu"
        return None, None
    kind = torch.cuda.get_device_name(torch.device(device)).lower()
    for sub, peak in PEAK_BF16_FLOPS:
        if sub in kind:
            return peak, "table"
    return max(p for _, p in PEAK_BF16_FLOPS), "assumed-max"


# Ops that move no bytes: views and allocations.
_FREE = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                   "new_empty_strided", "_unsafe_view", "lift_fresh"))
# In-place ops that overwrite ``self`` without reading it.
_OVERWRITES = frozenset(("copy_", "fill_", "zero_"))
_IMPLICIT = torch._C.DispatchKey.CompositeImplicitAutograd


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


class _Counter(TorchDispatchMode):
    """FLOPs and bytes of every aten op dispatched inside it.  FLOPs by
    ``FlopCounterMode``'s rules: its formula registry, and an op without a
    formula decomposed where it can be.  An error in the counting is kept
    (:attr:`error`), never raised into the step."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.error: Optional[BaseException] = None
        self._plans: Dict[Any, Tuple[Any, bool, bool, frozenset]] = {}

    def _plan(self, func) -> Tuple[Any, bool, bool, frozenset]:
        """(FLOP formula or None, decomposes, moves bytes, the arguments it
        only writes, by position and by name) of one op."""
        plan = self._plans.get(func)
        if plan is None:
            formula = flop_registry.get(func._overloadpacket)
            decomposes = formula is None and func is not torch.ops.prim.device.default and (
                _IMPLICIT in func.py_kernels
                or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _IMPLICIT))
            overwrites = func._opname in _OVERWRITES
            unread = frozenset(key for i, a in enumerate(func._schema.arguments)
                               if a.is_out or (overwrites and a.alias_info is not None
                                               and a.alias_info.is_write)
                               for key in (i, a.name))
            plan = self._plans[func] = (formula, decomposes,
                                        not (func.is_view or func._opname in _FREE), unread)
        return plan

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula, decomposes, moves, unread = self._plan(func)
        if decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        try:
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if moves:
                self.bytes += (sum(_tensor_bytes(a) for i, a in enumerate(args) if i not in unread)
                               + sum(_tensor_bytes(v) for k, v in kwargs.items()
                                     if k not in unread)
                               + _tensor_bytes(out))
        except Exception as e:  # noqa: BLE001 — counting must not fail the step
            if self.error is None:
                self.error = e
        return out


def _tallies() -> Dict[str, Dict[str, int]]:
    from mpi4dl_tpu_torch.ops import flash_attention, halo_conv

    return {name: dict(t) for mod in (halo_conv, flash_attention)
            for name, t in mod.TALLY.items()}


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, Any]]:
    """Count the work done inside the block (module docstring).  Yields a
    dict filled when the block exits: ``flops``, ``bytes_accessed`` (aten
    ops plus the hand kernels), ``kernels`` ({name: launches, flops,
    bytes, and vector_flops where the kernel has them} of the kernels that
    launched), ``scopes`` (the sorted names ``obs.scope`` opened) and
    ``error`` (None, or the repr of the first error in the counting; the
    block itself runs on)."""
    from mpi4dl_tpu_torch.obs.scopes import recording_scopes

    out: Dict[str, Any] = {}
    before = _tallies()
    counter = _Counter()
    with recording_scopes() as seen, counter:
        yield out
    kernels = {}
    for name, t in _tallies().items():
        if t["launches"] > before[name]["launches"]:
            kernels[name] = {k: v - before[name][k] for k, v in t.items()}
    out.update(
        flops=counter.flops + sum(k["flops"] for k in kernels.values()),
        bytes_accessed=counter.bytes + sum(k["bytes"] for k in kernels.values()),
        kernels=kernels, scopes=sorted(seen),
        error=None if counter.error is None else repr(counter.error))


def step_cost(step_fn, *args) -> Dict[str, Any]:
    """Run ``step_fn(*args)`` once under :func:`counting`; its counts."""
    with counting() as cost:
        step_fn(*args)
    return cost


def mfu(flops_per_step: Optional[float], step_ms: Optional[float],
        peak: Optional[float], n_devices: int = 1) -> Optional[float]:
    """Model FLOP utilization: (flops/step) / (step seconds) / (peak x N).

    The runners' cost record holds the flops of one device's share of the
    step (a rank's mean on ranks), so the usual call passes those with
    ``n_devices=1``; pass aggregate flops with the device count only when
    you summed shards yourself."""
    if not flops_per_step or not step_ms or not peak or step_ms <= 0:
        return None
    return (flops_per_step / (step_ms / 1e3)) / (peak * max(n_devices, 1))


def arithmetic_intensity(flops: Optional[float],
                         bytes_accessed: Optional[float]) -> Optional[float]:
    """FLOPs per device-memory byte — the roofline abscissa; low values say
    the step is bandwidth-bound and more MFU needs fusion or layout work,
    not schedule work."""
    if not flops or not bytes_accessed:
        return None
    return flops / bytes_accessed
