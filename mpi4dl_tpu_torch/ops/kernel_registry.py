"""Kernel registry — the enrollment point of the port's hand-written kernels
(counterpart of ``mpi4dl_tpu/ops/kernel_registry.py``).

Every kernel variant the engines dispatch has one :class:`KernelCase` row:
its ``build(device)`` makes small inputs from a seed (shapes with interior
and edge tiles: ragged pixel, channel and key tails) and returns the
wrapper's call and the kernel's plain PyTorch version on them.  On the card
the call launches the kernel; on CPU tensors it runs the plain version, as
the wrappers do (nothing falls back).  :meth:`KernelCase.run` holds the two
against each other with the tolerances ``chip_smoke.py``'s kernel phases
use, and returns the largest absolute difference.

Two things key off this module being the single registry:

- ``chip_smoke.py`` runs every row on the card, and fails a run in which a
  kernel launched whose name no row's :attr:`KernelCase.kernel` enrolls;
- the analyzer's rule ``unregistered-kernel-launch``
  (``mpi4dl_tpu_torch/analysis/rules_pallas.py``) parses THIS file's
  imports: a port module that loads a kernel library, binds one with
  ``argtypes`` or defines a Triton kernel, and that is not imported here, is
  a finding; so is a source of ``ops/_build.py``'s ``SOURCES`` that no
  imported module loads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

# Imports below double as the analyzer's registration mark: a module whose
# kernels are enrolled must be imported here (parsed from source, never
# executed by the analyzer).
from mpi4dl_tpu_torch.ops import flash_attention as fa
from mpi4dl_tpu_torch.ops import halo_conv as hc

# (call, plain, args): call(*args) is the wrapper, plain(*args) its plain
# version, both returning a tensor or a tuple of tensors.
Built = Tuple[Callable, Callable, tuple]


def _max_abs(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def _check_conv(name: str, got, ref) -> float:
    """fp32: within 8 scaled ULP of max|ref| (y, sum, sumsq).  bf16: |Δy| <=
    2^-7·max|y|, |Δsum| <= 2^-7·Σ|y|, |Δsumsq| <= 2^-6·Σy² (one bf16
    rounding of each side's fp32 accumulation)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    y = ref[0]
    err = 0.0
    if y.dtype == torch.float32:
        for part, g, r in zip(("y", "sum", "sumsq"), got, ref):
            e = _max_abs(g, r)
            bound = 8 * 2.0 ** -23 * float(r.abs().max())
            assert e <= bound, f"{name} {part}: |err| {e} > {bound} (8 scaled ULP)"
            err = max(err, e)
        return err
    yf = y.float()
    bounds = [2.0 ** -7 * float(yf.abs().max())]
    if len(ref) == 3:
        bounds += [2.0 ** -7 * float(yf.abs().sum(dim=(0, 1, 2)).max()),
                   2.0 ** -6 * float((yf * yf).sum(dim=(0, 1, 2)).max())]
    for part, g, r, bound in zip(("y", "sum", "sumsq"), got, ref, bounds):
        e = _max_abs(g, r)
        assert e <= bound, f"{name} {part}: |err| {e} > {bound}"
        err = max(err, e)
    return err


def _check_flash(name: str, got, ref, bound: float = 1e-5) -> float:
    """m and o_hat/l within bound·max(1, max|ref|) on live rows, l within
    rtol bound, masked rows exactly (0, NEG_INF, 0); returns max|Δ(o/l)|."""
    (o, m, l), (ro, rm, rl) = got, ref
    live = rm > fa.NEG_INF * 0.5
    assert torch.equal(live, m > fa.NEG_INF * 0.5), f"{name}: masked rows differ"
    dead = ~live
    assert bool(torch.all(m[dead] == fa.NEG_INF) and torch.all(l[dead] == 0)
                and torch.all(o[dead] == 0)), f"{name}: masked rows not (0, NEG_INF, 0)"
    if not bool(live.any()):
        return 0.0
    dm = float((m[live] - rm[live]).abs().max())
    assert dm <= bound * max(1.0, float(rm[live].abs().max())), f"{name}: |dm| {dm}"
    dl = float(((l - rl).abs() / rl)[live].max())
    assert dl <= bound, f"{name}: l rel {dl}"
    on = o / l.clamp_min(1e-30)[..., None]
    ron = ro / rl.clamp_min(1e-30)[..., None]
    do = float((on - ron).abs().max())
    assert do <= bound * max(1.0, float(ron.abs().max())), f"{name}: |d(o/l)| {do}"
    return do


def _check_flash_bwd(name: str, got, ref) -> float:
    """dq, dk, dv within rtol 1e-4 / atol 1e-5·max|ref|; a zero reference
    exactly."""
    err = 0.0
    for part, g, r in zip(("dq", "dk", "dv"), got, ref):
        big = float(r.abs().max())
        if big == 0.0:
            assert bool((g == 0).all()), f"{name} {part}: not zero"
            continue
        diff = (g.float() - r.float()).abs()
        used = float((diff / (1e-5 * big + 1e-4 * r.float().abs())).max())
        assert used <= 1.0, f"{name} {part}: {used:.3g} of the allowance"
        err = max(err, float(diff.max()))
    return err


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One enrolled kernel variant.

    ``kernel`` is the name the wrapper counts its launches under
    (``halo_conv.LAUNCHES`` / ``flash_attention.LAUNCHES``); ``build(device)``
    returns ``(call, plain, args)``; ``check(name, got, ref)`` raises when
    ``got`` is outside the tolerance of ``ref`` and returns max|Δ|.
    """

    name: str
    kernel: str
    build: Callable[[torch.device], Built]
    check: Callable[[str, object, object], float]

    def run(self, device="cuda") -> float:
        """Build on ``device``, run the call and the plain version, hold one
        against the other; max|Δ|."""
        call, plain, args = self.build(torch.device(device))
        return self.check(self.name, call(*args), plain(*args))


def _randn(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * scale).to(
        device=device, dtype=dtype)


def _conv_case(dtype: torch.dtype, fused: bool) -> KernelCase:
    def build(device: torch.device) -> Built:
        gen = torch.Generator().manual_seed(0)
        # 24x40 outputs: 960 pixels, 7.5 of the 128-pixel tiles and 15 of
        # the 64-pixel ones; Cout 72 leaves a ragged channel tile.
        x = _randn(gen, (1, 26, 42, 8), 1.0, dtype, device)
        w = _randn(gen, (3, 3, 8, 72), 1.0 / 9, dtype, device)
        # A margin-excluding window, as the D2 dispatch passes it.
        kw = dict(fuse_relu=True, stat_window=(1, 23, 2, 38)) if fused else {}
        return (lambda x, w: hc.halo_conv2d(x, w, **kw),
                lambda x, w: hc.halo_conv2d_plain(x, w, **kw), (x, w))

    name = "halo_conv2d:" + ("fused_stats:" if fused else "") + str(dtype).split(".")[1]
    return KernelCase(name, "halo_conv2d_stats" if fused else "halo_conv2d", build, _check_conv)


_FLASH_SCALE = 0.125


def _flash_inputs(gen, dtype, device):
    # Tk 300 leaves a ragged key tile; Tq 48 a ragged query tile.
    return tuple(_randn(gen, s, 1.0, dtype, device)
                 for s in ((2, 48, 64), (2, 300, 64), (2, 300, 64)))


def _flash_case(dtype: torch.dtype, causal: bool) -> KernelCase:
    def build(device: torch.device) -> Built:
        q, k, v = _flash_inputs(torch.Generator().manual_seed(1), dtype, device)
        args = (q, k, v, 0, 0, causal, _FLASH_SCALE)
        return fa.block_flash, fa.block_flash_plain, args

    name = "block_flash:" + ("causal:" if causal else "") + str(dtype).split(".")[1]
    return KernelCase(name, "block_flash", build, _check_flash)


def _flash_bwd_build(device: torch.device) -> Built:
    gen = torch.Generator().manual_seed(2)
    q, k, v = _flash_inputs(gen, torch.bfloat16, device)
    # A causal hop whose first query rows see no key: zero gradients there.
    q_off, k_off = 0, 16
    _, m, _ = fa.block_flash_plain(q, k, v, q_off, k_off, True, _FLASH_SCALE)
    do = _randn(gen, q.shape, 1.0, torch.float32, device)
    dl = _randn(gen, q.shape[:2], 1.0, torch.float32, device)
    args = (q, k, v, m, do, dl, q_off, k_off, True, _FLASH_SCALE)
    return fa.block_flash_bwd, fa.block_flash_bwd_plain, args


# The fp32 and bf16 paths of K1 and K2 the engines dispatch, K3 as the
# registry of the JAX package enrolls it (fp32, and bf16 causal), and K3's
# backward kernel, which takes bf16 only.
REGISTRY: Tuple[KernelCase, ...] = (
    _conv_case(torch.float32, fused=False),
    _conv_case(torch.bfloat16, fused=False),
    _conv_case(torch.float32, fused=True),
    _conv_case(torch.bfloat16, fused=True),
    _flash_case(torch.float32, causal=False),
    _flash_case(torch.bfloat16, causal=True),
    KernelCase("block_flash_bwd:causal:bfloat16", "block_flash_bwd", _flash_bwd_build,
               _check_flash_bwd),
)


def registry_case(name: str) -> KernelCase:
    for case in REGISTRY:
        if case.name == name:
            return case
    raise KeyError(f"no registered kernel case {name!r}; have {[c.name for c in REGISTRY]}")


def case_names(kernels: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
    """Registered case names, optionally filtered by kernel prefix (the
    part before the first ``:``) or exact case name."""
    names = tuple(c.name for c in REGISTRY)
    if kernels is None:
        return names
    wanted = set(kernels)
    return tuple(n for n in names if n in wanted or n.split(":", 1)[0] in wanted)


def enrolled_kernels() -> Tuple[str, ...]:
    """The launch-count names the rows enroll."""
    return tuple(dict.fromkeys(c.kernel for c in REGISTRY))
