"""Compare a card's gradients with the CPU's.

Two checks of a training step, run on one device and on the CPU from the
same weights and batch:

* :func:`sp_step_run` computes a reduced-depth spatial step's loss and
  gradient.  In float64, with the kernels off, the whole step is
  continuous at rounding scale: rounding cannot flip a max-pool or ReLU
  tie, so the card's whole gradient (halo exchanges, tile scatter and
  gather, the junction's arms and their adjoints) must agree with the
  CPU's to far below fp32 precision.
* :func:`replay_units` holds the fp32 step with the kernels on unit by
  unit: every layer call and fused [ReLU, Conv2d, BatchNorm] window is
  replayed on its recorded input on both devices.  A unit's VJP is
  continuous in its input, where the fp32 step's whole gradient is not
  (AmoebaNet routes it through max-pool ties that fp32 rounding flips).

Two more hold engines against the single-card step on one device:
:func:`engine_run` trains GEMS on the stage chain, or SP x PP / SP + GEMS
on the tile grid and stage chain, or the single-card step accumulated
over the same micro-batches; :func:`hstripe_run` is the striped ResNet
branch's step with its size gates lowered, for card against CPU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math


import torch


def norm_rel(got, ref) -> float:
    """‖got − ref‖ / ‖ref‖ over lists of tensors, in float64 on the host."""
    diff = sum(float(((a.detach().cpu() - b.detach().cpu()).double() ** 2).sum())
               for a, b in zip(got, ref))
    return (diff / sum(float((b.detach().cpu().double() ** 2).sum()) for b in ref)) ** 0.5


def sp_step_run(dev, state_dict, d2, local_dp=None, eps=0.0, model=None,
                dtype=torch.float32, batch=4):
    """A reduced-depth SP step's loss and gradient: AmoebaNet-D(3, 32),
    ``batch`` (at most 4) at 256², the one-process 2x2 grid, the gather
    junction or ``batch_split`` of degree ``local_dp`` after cell 5 (a
    tail of three cells, with BatchNorm, and the head).  fp32 runs the kernels;
    float64 runs the model in float64 with the kernels off (they take fp32
    and bf16).  ``eps`` scales a relative perturbation of the input;
    ``model`` is built unless given.  Returns (loss, grads, model)."""
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, spatial_ctx_for
    from mpi4dl_tpu_torch.models import amoebanetd
    from mpi4dl_tpu_torch.parallel.spatial import apply_spatial_model
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import cross_entropy

    shape = (batch, 256, 256, 3)
    if model is None:
        model = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=32, device=dev)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(dtype)
    g = torch.Generator().manual_seed(2)
    x, y = torch.randn(shape, generator=g).to(dtype), torch.tensor([1, 4, 7, 9])[:batch]
    x = x * (1 + eps * torch.randn(shape, generator=torch.Generator().manual_seed(9),
                                   dtype=dtype))
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=d2,
                         use_pallas_conv=dtype != torch.float64)
    ctx = ApplyCtx(train=True, spatial=sp, bn_sink={})
    logits = apply_spatial_model(model, sp.tiles.scatter(x.to(dev)), ctx, spatial_until=5,
                                 junction="batch_split" if local_dp else "gather",
                                 local_dp=local_dp)
    loss = cross_entropy(logits, y.to(dev))
    return float(loss), torch.autograd.grad(loss, list(model.parameters())), model


def replay_units(model, run, dev):
    """Every unit that ``run()`` (a forward of ``model`` on the CPU) computes — each
    Layer call and each fused [ReLU, Conv2d, BatchNorm] window (K2) — is
    recorded with its input and context, then replayed on ``dev`` and on
    the CPU with one random cotangent.  Returns the number of units and
    the worst norm-relative difference of their outputs and of their
    VJPs (input and parameters), device against CPU."""
    from mpi4dl_tpu_torch.layers import Layer
    from mpi4dl_tpu_torch.ops import d2

    calls = []
    real = d2._apply_fused_triple

    def fused(cv, bn, x, ctx, sub, mh, mw):
        calls.append(("fused", (cv, bn), x.detach().clone(), ctx, (sub, mh, mw)))
        return real(cv, bn, x, ctx, sub, mh, mw)

    mods = [m for m in model.modules() if isinstance(m, Layer)]
    hooks = [m.register_forward_hook(
        lambda mod, args, out: calls.append(("layer", (mod,), args[0].detach().clone(),
                                             args[1], ())))
        for m in mods]
    d2._apply_fused_triple = fused
    try:
        run()
    finally:
        d2._apply_fused_triple = real
        for h in hooks:
            h.remove()
    gen = torch.Generator().manual_seed(5)
    worst_y = worst_g = 0.0
    for kind, parts, x, ctx, extra in calls:
        ctx = dataclasses.replace(ctx, bn_sink=None)
        outs = []
        for d in ("cpu", dev):
            mods_d = [copy.deepcopy(m).to(d) for m in parts]
            xd = x.to(d).requires_grad_()
            if kind == "layer":
                y = mods_d[0](xd, ctx)
            else:
                y = real(*mods_d, xd, ctx, *extra)[0]
            if not outs:
                ct = torch.randn(y.shape, generator=gen)
            params = [p for m in mods_d for p in m.parameters()]
            got = torch.autograd.grad(y, [xd] + params, grad_outputs=ct.to(d),
                                      allow_unused=True)
            outs.append((y, got))
        (y0, g0), (y1, g1) = outs
        worst_y = max(worst_y, norm_rel([y1], [y0]))
        worst_g = max([worst_g] + [norm_rel([b], [a]) for a, b in zip(g0, g1)
                                   if a is not None and float(a.abs().max()) > 0])
    return len(calls), worst_y, worst_g


def engine_run(dev, engine, *, arch="resnet", image=32, batch=4, micro=1, split=2,
               times=1, parts=1, schedule="gpipe", dtype=torch.float32, pallas=False,
               spatial_until=2, steps=2, levels=None, kernel_cells=None):
    """``steps`` SGD steps (lr 0.01) from seed-0 weights on a seeded batch of
    ``batch`` images, ``micro`` a micro-batch: ``engine`` ``"single"`` (the
    single-card step accumulated over ``batch // micro`` micro-batches),
    ``"gems"`` (``split`` stages on the chain, ``times`` x 2 x ``parts``),
    ``"sp_pp"`` or ``"sp_gems"`` (a 1x2 grid, D1, the gather junction after
    cell ``spatial_until``, ``split`` tail stages), ``"sp"`` (the SP step
    over ``batch // micro`` micro-batches).  ``levels`` ``(slice method,
    parts list, stops)`` runs the spatial engines multi-level on the
    one-process grid of ``parts[0]`` tiles (the junction after the last
    stop).  ResNet-11 v2, or AmoebaNet-D(3, 32); ``dtype`` float64 runs the
    model in float64 (the kernels off).  ``kernel_cells`` (``"single"``
    with ``pallas``): only the cells before it take the kernels, the rest
    run unsharded without them, as an SP step's degenerate levels and tail
    do.  Returns (losses, state dict on the host)."""
    from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for, spatial_levels_for
    from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
    from mpi4dl_tpu_torch.parallel.gems import make_gems_train_step
    from mpi4dl_tpu_torch.parallel.partition import StagePartition
    from mpi4dl_tpu_torch.parallel.pipeline import init_pipeline_state
    from mpi4dl_tpu_torch.parallel.sp_pipeline import (
        SPPipeline, init_sp_pipeline_state, make_sp_gems_train_step,
        make_sp_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.parallel.tiles import TileGrid
    from mpi4dl_tpu_torch.train import (
        Optimizer, TrainState, make_spatial_train_step, make_train_step,
    )

    shape = (batch, image, image, 3)
    if arch == "resnet":
        model = get_resnet_v2(shape, 11, 10, device="cpu", seed=0)
    else:
        model = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=32,
                           device="cpu")
    model.to(device=dev, dtype=dtype)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=g).to(dev, dtype)
    y = (torch.arange(batch) * 3 % 10).to(dev)
    opt = Optimizer("sgd", lr=0.01)
    kw = dict(compute_dtype=dtype, remat=False, schedule=schedule)
    if engine == "single":
        step = make_train_step(model, opt, parts=batch // micro, compute_dtype=dtype,
                               pallas_conv=pallas)
        state = TrainState.create(model, opt)
        for cell in model.cells[len(model.cells) if kernel_cells is None else kernel_cells:]:
            cell.register_forward_pre_hook(
                lambda mod, args: (args[0], args[1].with_spatial(None)))
    elif engine == "gems":
        part = StagePartition.build(model, split, (micro, *shape[1:]))
        step = make_gems_train_step(part, opt, StageChain(split), parts, times=times,
                                    pallas_conv=pallas, **kw)
        state = init_pipeline_state(part, opt, StageChain(split))
    elif levels is not None or engine == "sp":
        method, counts, stops = levels
        g = math.isqrt(counts[0])
        grid = {"square": (g, g), "vertical": (1, counts[0]),
                "horizontal": (counts[0], 1)}[method]
        ctxs = spatial_levels_for(method, counts, tiles=TileGrid(*grid),
                                  use_pallas_conv=pallas)
        chain = list(zip(stops, ctxs))
        model.spatial_until = stops[-1]
        if engine == "sp":
            step = make_spatial_train_step(model, opt, ctxs[0], parts=batch // micro,
                                           compute_dtype=dtype, levels=chain)
            state = TrainState.create(model, opt)
        else:
            spp = SPPipeline.build(model, split, ctxs[0], micro, junction="gather",
                                   levels=chain)
            if engine == "sp_gems":
                step = make_sp_gems_train_step(spp, opt, StageChain(split), parts,
                                               times=times, **kw)
            else:
                step = make_sp_pipeline_train_step(spp, opt, StageChain(split), parts,
                                                   **kw)
            state = init_sp_pipeline_state(spp, opt, StageChain(split))
    else:
        model.spatial_until = spatial_until
        sp = spatial_ctx_for("vertical", 2, tiles=TileGrid(1, 2), use_pallas_conv=pallas)
        spp = SPPipeline.build(model, split, sp, micro, junction="gather")
        if engine == "sp_gems":
            step = make_sp_gems_train_step(spp, opt, StageChain(split), parts,
                                           times=times, **kw)
        else:
            step = make_sp_pipeline_train_step(spp, opt, StageChain(split), parts, **kw)
        state = init_sp_pipeline_state(spp, opt, StageChain(split))
    losses = [float(step(state, x, y)[1]["loss"]) for _ in range(steps)]
    return losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def hstripe_gates(min_pixels=1, budget=40000):
    """Lower the striped run's size gates (``ops/hstripe_conv.py``) so that
    a small input is striped, as the CPU tests do (the default budget cuts
    :func:`hstripe_run`'s 32² input into 4 stripes)."""
    from mpi4dl_tpu_torch.ops import hstripe_conv as hc

    old = hc._RUN_MIN_PIXELS, hc._RUN_STRIPE_BUDGET
    hc._RUN_MIN_PIXELS, hc._RUN_STRIPE_BUDGET = min_pixels, budget
    try:
        yield
    finally:
        hc._RUN_MIN_PIXELS, hc._RUN_STRIPE_BUDGET = old


def hstripe_run(dev, state_dict=None, size=32):
    """A striped v2 bottleneck block (16 → 8 → 16 channels, stride 1) and
    a global-pool head on a seeded batch of 2 at ``size``², in train mode:
    (loss, gradients, running statistics, model).  Call it under
    :func:`hstripe_gates` to stripe."""
    from mpi4dl_tpu_torch.cells import CellModel, LayerCell
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
    from mpi4dl_tpu_torch.layers import Dense, GlobalAvgPool
    from mpi4dl_tpu_torch.models.resnet import ResBlockV2
    from mpi4dl_tpu_torch.train import cross_entropy

    shape = (2, size, size, 16)
    model = CellModel([ResBlockV2(16, 8, 16, 1, first_block=False, pre_activation=True),
                       LayerCell([GlobalAvgPool(), Dense(16, 10)], name="head")], shape, 10)
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    model.to(dev)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(6)).to(dev)
    ctx = ApplyCtx(train=True, bn_sink={})
    loss = cross_entropy(model(x, ctx), torch.tensor([2, 5], device=dev))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    stats = [t for mv in ctx.bn_sink.values() for t in mv]
    return float(loss.detach()), grads, stats, model
