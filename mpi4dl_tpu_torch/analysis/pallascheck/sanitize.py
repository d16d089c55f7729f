"""Each registry row run on the card (counterpart of ``mpi4dl_tpu/analysis/
pallascheck/grid.py`` and ``interp.py``, which the JAX certifier runs on
the kernel's jaxpr; a CUDA kernel's grid is checked by running it).

- :func:`launched_symbols`: the kernels a row's call launches, read from
  the libraries' launch logs (``resources.launch_log``; the resources of
  exactly those symbols are certified for the row);
- :func:`canary` (``untiled-output``, the JAX finding of that name): every
  buffer the wrapper allocates for its outputs (``empty``, ``empty_like``,
  ``empty_strided``) is filled with NaN before the launch, through a
  dispatch mode; an output element that still holds a NaN after the call
  is one that no block of the grid wrote.

Not run: the four ``compute-sanitizer`` kinds, ``oob-access`` (memcheck),
``smem-race`` (racecheck), ``uninit-read`` (initcheck) and
``barrier-hazard`` (synccheck) (:data:`NOT_RUN`): the card's machine has
the tool, which answers "Device not supported" for its H100 and fails every
CUDA call of the program under it.  The CLI names them as not run on every
report; they wait in ``ROADMAP.md`` C for a machine where the tool works.
"""

from __future__ import annotations

from typing import List, Set

NOT_RUN = {
    "oob-access": "compute-sanitizer memcheck",
    "smem-race": "compute-sanitizer racecheck",
    "uninit-read": "compute-sanitizer initcheck",
    "barrier-hazard": "compute-sanitizer synccheck",
}
NOT_RUN_REASON = ("compute-sanitizer answers 'Device not supported' for the card on the "
                  "machine the port is measured on (ROADMAP C5)")

_ALLOCATORS = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def launched_symbols(case, device="cuda") -> Set[str]:
    """Mangled symbols of the kernels one call of the registry row ``case``
    launches, from every library's launch log."""
    import torch

    from mpi4dl_tpu_torch.analysis.pallascheck.resources import clear_launch_log, launch_log
    from mpi4dl_tpu_torch.ops import _build

    # Host queries and clears of each library's log: they launch no kernel.
    libs = {name: _build.load(name) for name in _build.SOURCES}  # analysis: ok(unregistered-kernel-launch)
    call, _, args = case.build(torch.device(device))
    torch.cuda.synchronize()
    for name, lib in libs.items():
        clear_launch_log(lib, name)
    call(*args)
    torch.cuda.synchronize()
    return set().union(*(launch_log(lib, name) for name, lib in libs.items()))


def canary(case, device="cuda") -> List[str]:
    """Messages of the row's outputs that keep a NaN of the fill (empty:
    every output element was written)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class NanFill(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func._schema.name.split("::")[-1] in _ALLOCATORS
                    and isinstance(out, torch.Tensor) and out.is_floating_point()):
                out.fill_(float("nan"))
            return out

    call, _, args = case.build(torch.device(device))
    with NanFill():
        got = call(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out = []
    for i, t in enumerate(tree_leaves(got)):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            bad = int(torch.isnan(t).sum())
            if bad:
                out.append(f"output {i} {tuple(t.shape)}: {bad} of {t.numel()} elements "
                           "never written (NaN of the fill)")
    return out
