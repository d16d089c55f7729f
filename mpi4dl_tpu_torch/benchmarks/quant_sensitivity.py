"""How far a quantized step's first gradients lie from the exact step's,
beside how far the exact step's own move when its input moves a little.

    python -m mpi4dl_tpu_torch.benchmarks.quant_sensitivity --engine sp_pp \\
        --image-size 128 --num-filters 32 --dtype float64 --device cpu

Builds AmoebaNet-D(``--num-layers``, ``--num-filters``), 1000 classes,
weights from seed 0, on the one-process 2x2 tile grid (halo-D2, the
``gather`` junction, the kernels on a card): the SP step (``--engine sp``)
or SP x PP over 2 tail stages from cell 12 (``sp_pp``), SGD lr 1e-3, on
the runners' synthetic batch for ``--seed 0``.  It trains ``--steps``
steps exact, then as many under each ``--spec`` and under each
``--probe`` (the exact step on the batch moved by that much of itself,
Gaussian), and prints one JSON line a run: the losses and the first step's
gradients against the exact run's (``grad_gap``: relative L2 norm of the
difference and norm ratio, over all parameters and over the first cell's,
which sit behind every quantized wire of the backward).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import List, Optional, Sequence

import torch

from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.train import Optimizer

SP_UNTIL, SP_SPLIT = 12, 2  # the SP x PP split of chip_smoke.py's phase 15


@dataclasses.dataclass(frozen=True)
class FirstGrads(Optimizer):
    """An optimizer that keeps, as ``grads``, an fp32 copy of the first
    gradients it applies beside their parameters' ids."""

    grads: list = dataclasses.field(default_factory=list)

    def update(self, params, grads, opt_state):
        if not self.grads:
            self.grads.extend((id(p), g.detach().float().clone())
                              for p, g in zip(params, grads))
        return super().update(params, grads, opt_state)


def grad_gap(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor],
             pos: Optional[Sequence[int]] = None):
    """(relative L2 norm of ``got - want``, ``|got| / |want|``) over the
    tensors at the positions ``pos`` (None: all)."""
    pos = range(len(want)) if pos is None else pos
    d2 = sum(float((got[i] - want[i]).double().square().sum()) for i in pos)
    g2 = sum(float(got[i].double().square().sum()) for i in pos)
    w2 = sum(float(want[i].double().square().sum()) for i in pos)
    return math.sqrt(d2 / w2), math.sqrt(g2 / w2)


def first_cell_positions(model, opt: FirstGrads) -> List[int]:
    """Positions in ``opt.grads`` of the model's first cell's parameters."""
    first = {id(p) for p in model.cells[0].parameters()}
    return [i for i, (k, _) in enumerate(opt.grads) if k in first]


def build(engine: str, image: int, layers: int, filters: int, batch: int, dtype,
          device, quant: Optional[str], opt: Optimizer):
    """(model, step, state) of the configuration (module docstring)."""
    from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for
    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.sp_pipeline import (
        SPPipeline, init_sp_pipeline_state, make_sp_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.quant import QuantPolicy
    from mpi4dl_tpu_torch.train import TrainState, make_spatial_train_step

    params = torch.float64 if dtype == torch.float64 else torch.float32
    model = amoebanetd((batch, image, image, 3), num_classes=1000, num_layers=layers,
                       num_filters=filters, device=device, seed=0, dtype=params)
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=True,
                         use_pallas_conv=device.type == "cuda")
    policy = QuantPolicy.parse(quant)
    if engine == "sp":
        step = make_spatial_train_step(model, opt, sp, compute_dtype=dtype, quant=policy)
        return model, step, TrainState.create(model, opt)
    model.spatial_until = SP_UNTIL
    spp = SPPipeline.build(model, SP_SPLIT, sp, batch // 2, junction="gather")
    chain = StageChain(SP_SPLIT)
    step = make_sp_pipeline_train_step(spp, opt, chain, 2, compute_dtype=dtype, remat=False,
                                       quant=policy)
    return model, step, init_sp_pipeline_state(spp, opt, chain)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("sp", "sp_pp"), default="sp_pp")
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--num-layers", type=int, default=18)
    ap.add_argument("--num-filters", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--dtype", choices=("float64", "float32", "bfloat16"), default="float64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--spec", action="append",
                    help="a --quant spec (repeatable; default junction=int8,handoff=int8,"
                         "grad=int8, junction=int8 and handoff=int8)")
    ap.add_argument("--probe", type=float, action="append",
                    help="a relative input perturbation (repeatable; default 1e-6, 2^-8)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    specs = args.spec or ["junction=int8,handoff=int8,grad=int8", "junction=int8",
                          "handoff=int8"]
    probes = args.probe or [1e-6, 2.0 ** -8]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)  # the runners' synthetic batch (chip_smoke.sp_batch)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    x = torch.randn(shape, generator=gen, device=device)
    y = torch.randint(0, 1000, (args.batch_size,), generator=gen, device=device)
    x = x.to(torch.float64 if dtype == torch.float64 else torch.float32)
    noise = torch.randn(shape, generator=gen, device=device).to(x.dtype)

    def run(spec, eps):
        opt = FirstGrads("sgd", lr=1e-3)
        model, step, state = build(args.engine, args.image_size, args.num_layers,
                                   args.num_filters, args.batch_size, dtype, device, spec, opt)
        xs = x * (1 + eps * noise) if eps else x
        losses = [float(step(state, xs, y)[1]["loss"]) for _ in range(args.steps)]
        return losses, [g for _, g in opt.grads], first_cell_positions(model, opt)

    exact, want, cell0 = run(None, 0.0)
    print(json.dumps({"run": "exact", "losses": exact}), flush=True)
    for label, spec, eps in ([(s, s, 0.0) for s in specs]
                             + [(f"exact, input moved by {e:.4g}", None, e) for e in probes]):
        losses, got, _ = run(spec, eps)
        rel, ratio = grad_gap(got, want)
        rel0, ratio0 = grad_gap(got, want, cell0)
        print(json.dumps({
            "run": label, "losses": losses,
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, exact)),
            "grad_rel_l2": rel, "grad_norm_ratio": ratio,
            "first_cell_rel_l2": rel0, "first_cell_norm_ratio": ratio0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
