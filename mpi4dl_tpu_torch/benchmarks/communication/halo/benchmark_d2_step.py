"""Step-level A/B of the halo-conv kernels in a D2-shaped run — the
counterpart of ``benchmarks/communication/halo/benchmark_d2_step.py``.

The kernel wins or loses as an op (``benchmark_pallas_conv.py``); what owns
the ``--pallas-conv`` default is the STEP.  One step here is the forward,
the gradients and an SGD update of a fused run of ``--fused`` [ReLU, Conv2d
3x3, BatchNorm] ops (the AmoebaNet op body) on one tile that carries the
run's accumulated margin, through ``ops/d2.apply_layers_premargin`` — the
dispatch the distributed D2 path takes (a SpatialCtx whose margins are
pre-exchanged; per-tile statistics, so no collectives).  A/B =
``SpatialCtx.use_pallas_conv``: on, each window takes K2 and its backward's
dx takes K1; off, the library conv.  The two are timed in turns (off, on,
on, off) on the device (CUDA events).  The loss, a mean of squared
BatchNorm outputs, is about 1 whatever the convs compute, so besides the JAX
tool's check (first losses within 5%) ``validation`` holds the kernels-on
arm against the kernels-off arm where a wrong conv shows, under one random
cotangent of the output, on the same weights before any update: every
conv's weight gradient, the output and the input's gradient, each within
2^-7 (about one bf16 rounding) in relative L2 norm.  Not elementwise: these
are bf16 values a few roundings deep, and single elements differ by a ULP
or two: 0.0109 of the largest magnitude, over 2^-7, at the example shapes
on an NVIDIA H100 80GB HBM3 (700 W).  One JSON line with the JAX tool's keys.

Example (one card):
  python mpi4dl_tpu_torch/benchmarks/communication/halo/benchmark_d2_step.py \\
      --tile 512 --channels 208 --fused 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 4)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi4dl_tpu_torch.benchmarks.communication.halo._timing import platform, timed_ms  # noqa: E402
from mpi4dl_tpu_torch.device import resolve_device  # noqa: E402
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx  # noqa: E402
from mpi4dl_tpu_torch.layers import BatchNorm, Conv2d, ReLU  # noqa: E402
from mpi4dl_tpu_torch.ops import halo_conv  # noqa: E402
from mpi4dl_tpu_torch.ops.d2 import accumulated_halo, apply_layers_premargin  # noqa: E402
from mpi4dl_tpu_torch.parallel.tiles import TileGrid  # noqa: E402


def build_layers(channels: int, fused: int, dev) -> list:
    layers = []
    for _ in range(fused):
        layers += [ReLU(), Conv2d(channels, channels, 3, bias=False, device=dev),
                   BatchNorm(channels, device=dev)]
    gen = torch.Generator(device=dev).manual_seed(0)
    for layer in layers:
        if hasattr(layer, "reset_parameters"):
            layer.reset_parameters(gen)
    return layers


# The arms agree within this relative L2 difference (about one bf16 rounding).
CHECK_TOL = 2.0 ** -7


def _ctx(use_kernels: bool) -> ApplyCtx:
    sp = SpatialCtx(axis_h="sph", axis_w="spw", grid_h=2, grid_w=2, bn_cross_tile=False,
                    d2_mode=True, use_pallas_conv=use_kernels, tiles=TileGrid(1, 1))
    return ApplyCtx(train=True, spatial=sp)


def arm_tensors(layers, use_kernels: bool, margin, x, cot) -> list:
    """Each conv's weight gradient, the input's gradient and the output of
    ``<y, cot>`` (fp32), without an update."""
    x = x.detach().requires_grad_(True)
    y, _, _ = apply_layers_premargin(layers, x, _ctx(use_kernels), *margin)
    kernels = [layer.kernel for layer in layers if isinstance(layer, Conv2d)]
    grads = torch.autograd.grad((y.float() * cot).sum(), kernels + [x])
    return [g.float() for g in grads] + [y.detach().float()]


def arms_rel_l2(on: list, off: list) -> list:
    """||on - off|| / ||off|| of each compared tensor."""
    return [float(torch.linalg.vector_norm(a - b))
            / max(float(torch.linalg.vector_norm(b)), 1e-30) for a, b in zip(on, off)]


def make_step(layers, use_kernels: bool, margin, lr: float = 1e-3):
    """``step(x) -> loss``: forward, grads and SGD in fp32 on the layers."""
    ctx = _ctx(use_kernels)
    params = [p for layer in layers for p in layer.parameters()]

    def step(x):
        y, mh, mw = apply_layers_premargin(layers, x, ctx, *margin)
        if (mh, mw) != (0, 0):
            raise AssertionError(f"margin left over: {(mh, mw)}")
        loss = y.float().square().mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_(p.float() - lr * g.float())
        return loss.detach()

    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tile", type=int, default=512,
                   help="local tile extent (512 = a 1024² image on a 2x2 grid)")
    p.add_argument("--channels", type=int, default=208)
    p.add_argument("--fused", type=int, default=3,
                   help="number of relu-conv-bn ops in the fused run")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    c, t, bs = args.channels, args.tile, args.batch
    probe = build_layers(c, args.fused, "cpu")
    hh, hw = accumulated_halo(probe)
    rng = np.random.default_rng(1)
    # A margin-carrying tile (a zero margin is a global-border tile of the
    # pad-once semantics: the same compute as any interior tile).
    x = torch.from_numpy(rng.standard_normal((bs, t + 2 * hh, t + 2 * hw, c)).astype(
        np.float32)).to(dev, torch.bfloat16)

    # One layer set per arm, from one seed: each arm trains its own copy.
    layer_sets = {on: build_layers(c, args.fused, dev) for on in (False, True)}
    cot = torch.from_numpy(rng.standard_normal((bs, t, t, c)).astype(np.float32)).to(dev)
    each = arms_rel_l2(*(arm_tensors(layer_sets[on], on, (hh, hw), x, cot)
                         for on in (True, False)))
    agree = max(each)
    arms = {on: make_step(layer_sets[on], on, (hh, hw)) for on in (False, True)}
    first = {on: float(arms[on](x)) for on in (False, True)}
    halo_conv.reset_launch_counts()
    arms[True](x)
    launches = dict(halo_conv.LAUNCHES)
    ms = {False: [], True: []}
    for on in (False, True, True, False):
        ms[on].append(timed_ms(lambda: arms[on](x), dev, args.warmup, args.iterations))
    dt_off, dt_on = (sum(ms[o]) / len(ms[o]) for o in (False, True))
    rel = abs(first[True] - first[False]) / max(abs(first[False]), 1e-9)
    ok = rel < 0.05 and agree <= CHECK_TOL
    out = {
        "metric": "d2_step_pallas_speedup",
        "value": round(dt_off / dt_on, 4),
        "unit": "x (xla_step_ms / pallas_step_ms)",
        "config": {"tile": t, "channels": c, "fused_convs": args.fused, "batch": bs,
                   "margin": [hh, hw]},
        "xla_step_ms": round(dt_off, 3),
        "pallas_step_ms": round(dt_on, 3),
        "step_ms_turns": {"off": ms[False], "on": ms[True]},
        "launches_per_step": launches,
        "validation": "pass" if ok else f"FAIL loss rel={rel:.3g} arms={agree:.3g}",
        "arms_rel_l2": agree,
        "arms_rel_l2_each": {"weight_grads": each[:-2], "input_grad": each[-2],
                             "output": each[-1]},
        "arms_tolerance": CHECK_TOL,
        "platform": platform(dev),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
