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
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F


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
    if dtype == torch.float64:  # cross_entropy computes in fp32
        loss = F.nll_loss(torch.log_softmax(logits, dim=-1), y.to(dev))
    else:
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
