"""The Hopper kernels' resources (counterpart of ``mpi4dl_tpu/analysis/
pallascheck/vmem.py`` and ``trace.py``).

The JAX certifier re-derives each Pallas kernel's VMEM footprint from its
BlockSpecs.  A hand CUDA kernel's footprint is what ptxas allocated and
what its launch requests:

- ptxas's report (``-Xptxas -v``), which ``ops/_build.build_kernels`` keeps
  beside each library (``lib<name>-<hash>.ptxas.txt``): per entry symbol its
  registers, stack frame, spill stores and loads, static shared memory;
- the library's exported launch table (``<name>_launch_table``, one query
  per ``.cu``; ``csrc/sm90_mma.cuh``'s ``LaunchRow``): per kernel its
  threads and minimum blocks of ``__launch_bounds__``, the dynamic shared
  memory its launch requests (read from the library, not from a Python copy
  of ``SMEM_BYTES`` / ``C::SMEM`` / ``Dims<KD>::*_SMEM``) and the blocks an
  SM holds at that request (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
  the query needs a card);
- the library's launch log (``<name>_launch_log``): the kernels its launch
  sites launched since the log was cleared, which tells the certifier what
  one registry row's call launches.

The findings over one kernel symbol:

- ``smem-overbudget``: static + dynamic shared memory over
  ``--require-smem-frac`` x 227 KiB, the per-block opt-in limit of sm_90;
- ``register-spill``: spill stores or loads, or a stack frame, over 0;
- ``launch-bounds-unmet``: a ``__launch_bounds__(T, minBlocks)`` whose
  registers x T x minBlocks exceed the SM's 65,536 registers, or whose
  shared memory x minBlocks exceeds the SM's 228 KiB.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import re
from typing import Dict, List, Optional, Set

SMEM_PER_BLOCK = 227 * 1024   # sm_90 per-block opt-in limit
SMEM_PER_SM = 228 * 1024      # sm_90 shared memory an SM
REGS_PER_SM = 65536

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """Per entry symbol of a ptxas ``-v`` report: ``regs``, ``stack``,
    ``spill_stores``, ``spill_loads``, ``smem_static``."""
    out: Dict[str, Dict[str, int]] = {}
    current: Optional[str] = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            out[current] = {"regs": 0, "stack": 0, "spill_stores": 0, "spill_loads": 0,
                            "smem_static": 0}
            continue
        if current is None:
            continue
        m = _PROPS.search(line)
        if m:
            out[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m:
            out[current]["regs"] = int(m.group(1))
            s = _SMEM.search(line)
            out[current]["smem_static"] = int(s.group(1)) if s else 0
            current = None
    return out


def launch_table(lib: ctypes.CDLL, name: str) -> Dict[str, Dict[str, int]]:
    """Per mangled symbol of the library's ``<name>_launch_table`` query:
    ``threads``, ``min_blocks``, ``smem_dynamic``, ``blocks_per_sm``."""
    query = getattr(lib, f"{name}_launch_table")
    query.restype = ctypes.c_int
    # a host query of the library's table: it launches no kernel
    ints = [ctypes.POINTER(ctypes.c_int)] * 4
    query.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + ints  # analysis: ok(unregistered-kernel-launch)
    sym = ctypes.c_char_p()
    vals = [ctypes.c_int() for _ in range(4)]
    n = query(-1, ctypes.byref(sym), *map(ctypes.byref, vals))
    out: Dict[str, Dict[str, int]] = {}
    for i in range(n):
        err = query(i, ctypes.byref(sym), *map(ctypes.byref, vals))
        if err != 0:
            raise RuntimeError(f"{name}_launch_table({i}): CUDA error {err}")
        threads, min_blocks, dyn, per_sm = (v.value for v in vals)
        out[sym.value.decode()] = {"threads": threads, "min_blocks": min_blocks,
                                   "smem_dynamic": dyn, "blocks_per_sm": per_sm}
    return out


def launch_log(lib: ctypes.CDLL, name: str) -> Set[str]:
    """Mangled symbols of the kernels the library launched since
    :func:`clear_launch_log` (its ``<name>_launch_log`` query)."""
    query = getattr(lib, f"{name}_launch_log")
    query.restype = ctypes.c_int
    # a host query of the library's log: it launches no kernel
    query.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]  # analysis: ok(unregistered-kernel-launch)
    sym = ctypes.c_char_p()
    out: Set[str] = set()
    for i in range(query(-1, ctypes.byref(sym))):
        err = query(i, ctypes.byref(sym))
        if err != 0:
            raise RuntimeError(f"{name}_launch_log({i}): CUDA error {err}")
        out.add(sym.value.decode())
    return out


def clear_launch_log(lib: ctypes.CDLL, name: str) -> None:
    getattr(lib, f"{name}_launch_log_clear")()


def resource_problems(res: Dict[str, int], smem_frac: float = 1.0) -> List[tuple]:
    """``(kind, message)`` of each finding over one symbol's joined resources
    (``parse_ptxas`` + ``launch_table`` fields)."""
    out = []
    smem = res["smem_static"] + res["smem_dynamic"]
    if smem > smem_frac * SMEM_PER_BLOCK:
        out.append(("smem-overbudget",
                    f"{res['smem_static']} B static + {res['smem_dynamic']} B dynamic shared "
                    f"memory = {smem} B > {smem_frac:g} x {SMEM_PER_BLOCK} B a block"))
    if res["spill_stores"] or res["spill_loads"] or res["stack"]:
        out.append(("register-spill",
                    f"{res['stack']} B stack frame, {res['spill_stores']} B spill stores, "
                    f"{res['spill_loads']} B spill loads at {res['regs']} registers"))
    mb = res["min_blocks"]
    if mb > 0:
        regs = res["regs"] * res["threads"] * mb
        if regs > REGS_PER_SM or smem * mb > SMEM_PER_SM:
            out.append(("launch-bounds-unmet",
                        f"__launch_bounds__({res['threads']}, {mb}): {res['regs']} registers "
                        f"x {res['threads']} threads x {mb} = {regs} (SM {REGS_PER_SM}), "
                        f"{smem} B shared x {mb} = {smem * mb} B (SM {SMEM_PER_SM})"))
    return out


def demangle(symbol: str) -> str:
    """The C++ demangling of ``symbol`` (libstdc++'s, as a profiler's
    kernel names read); the symbol itself when it does not demangle."""
    lib = ctypes.CDLL(ctypes.util.find_library("stdc++") or "libstdc++.so.6")
    fn = lib.__cxa_demangle
    fn.restype = ctypes.c_void_p
    # libstdc++'s demangler, not a kernel library
    fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,  # analysis: ok(unregistered-kernel-launch)
                   ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int()
    p = fn(symbol.encode(), None, None, ctypes.byref(status))
    if not p:
        return symbol
    try:
        return ctypes.string_at(p).decode()
    finally:
        ctypes.CDLL(None).free(ctypes.c_void_p(p))


def name_key(name: str) -> str:
    """A kernel's qualified name and template arguments, without its return
    type and parameter list: the key that joins a demangled ptxas symbol to
    a profiler's kernel name."""
    name = name.replace("(anonymous namespace)", "{anon}").strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(", 1)[0].replace(" ", "")
