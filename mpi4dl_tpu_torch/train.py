"""Single-device training (counterpart of ``mpi4dl_tpu/train.py``).

:func:`make_train_step` returns ``step(state, x, labels) -> (state,
metrics)``, as its JAX counterpart does; PyTorch runs eagerly, so the
step updates the model's parameters and running statistics in place.
:func:`make_spatial_train_step` is the spatial-parallel step (one level,
``gather`` junction); the pipeline and GEMS steps are later slices
(ROADMAP A7-A9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.cells import CellModel
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.layers import BatchNorm
from mpi4dl_tpu_torch.parallel.spatial import apply_spatial_model


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in fp32."""
    return F.nll_loss(torch.log_softmax(logits.float(), dim=-1), labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """SGD(+momentum) / Adam with fp32 update arithmetic and no fp32 master
    copy (``train.py:62-130``): the state is fp32, the update is computed in
    fp32 and rounded into the parameter's own dtype, in place."""

    kind: str = "sgd"
    lr: float = 0.001
    momentum: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: List[torch.Tensor]):
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
        if self.kind == "sgd":
            return () if self.momentum == 0.0 else (zeros(),)
        if self.kind == "adam":
            return (zeros(), zeros(), 0)
        raise ValueError(self.kind)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               opt_state):
        f32 = torch.float32
        if self.kind == "sgd" and self.momentum == 0.0:
            for p, g in zip(params, grads):
                p.copy_(p.to(f32) - self.lr * g.to(f32))
            return ()
        if self.kind == "sgd":
            (vel,) = opt_state
            for p, g, v in zip(params, grads, vel):
                v.mul_(self.momentum).add_(g.to(f32))
                p.copy_(p.to(f32) - self.lr * v)
            return (vel,)
        if self.kind == "adam":
            m, v, t = opt_state
            t += 1
            bc1 = 1 - self.b1 ** t
            bc2 = 1 - self.b2 ** t
            for p, g, mm, vv in zip(params, grads, m, v):
                g32 = g.to(f32)
                mm.mul_(self.b1).add_((1 - self.b1) * g32)
                vv.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
                p.copy_(p.to(f32) - self.lr * (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps))
            return (m, v, t)
        raise ValueError(self.kind)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and running statistics live in it), the
    optimizer state and the step count."""

    model: CellModel
    opt_state: Any
    step: int = 0

    @staticmethod
    def create(model: CellModel, optimizer: Optimizer) -> "TrainState":
        return TrainState(model, optimizer.init(list(model.parameters())), 0)


def merge_stat_updates(updates: Optional[Dict[BatchNorm, Tuple]]) -> None:
    """Write running-statistics updates into the BatchNorm buffers — after
    the optimizer update, as ``merge_stat_updates`` (``train.py:159-167``)."""
    if not updates:
        return
    with torch.no_grad():
        for bn, (mean, var) in updates.items():
            bn.mean.copy_(mean)
            bn.var.copy_(var)


def make_loss_fn(model: CellModel, ctx: ApplyCtx, remat=False):
    """``loss_fn(x, labels) -> (loss, (logits, stat_updates))``;
    stat_updates is the call's BatchNorm sink: {layer: (mean, var)}."""

    def loss_fn(x, labels):
        c = dataclasses.replace(ctx, bn_sink={})
        logits = model(x, c, remat=remat)
        if isinstance(logits, tuple):
            logits = logits[0]
        return cross_entropy(logits, labels), (logits, c.bn_sink)

    return loss_fn


def _accumulating_step(optimizer: Optimizer, params, grads_for, parts: int,
                       reduce_grads=None):
    """``step(state, x, labels)``: gradients of ``grads_for(x, labels) ->
    (loss, logits, stat_updates, grads)``, averaged over ``parts``
    micro-batches with the running-statistics updates (``train.py:257-286``),
    reduced by ``reduce_grads`` (in place), then the optimizer update and
    the running statistics."""

    def step(state: TrainState, x, labels):
        if parts == 1:
            loss, logits, stats, grads = grads_for(x, labels)
            acc = accuracy(logits, labels)
        else:
            mb_x, mb_y = x.chunk(parts), labels.chunk(parts)
            loss = acc = 0.0
            grads, stats = None, None
            for xx, yy in zip(mb_x, mb_y):
                l, logits, st, g = grads_for(xx, yy)
                loss, acc = loss + l, acc + accuracy(logits, yy)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                stats = st if stats is None else {
                    k: (stats[k][0] + m, stats[k][1] + v) for k, (m, v) in st.items()
                }
            grads = [g / parts for g in grads]
            stats = {k: (m / parts, v / parts) for k, (m, v) in stats.items()}
            loss, acc = loss / parts, acc / parts
        if reduce_grads is not None:
            reduce_grads(grads)
        state.opt_state = optimizer.update(params, grads, state.opt_state)
        merge_stat_updates(stats)
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    return step


def make_train_step(model: CellModel, optimizer: Optimizer, parts: int = 1,
                    compute_dtype=torch.float32, remat=False,
                    pallas_conv: bool = False):
    """Single-device training step.

    ``parts > 1`` accumulates gradients over micro-batches and averages the
    per-micro-batch running-statistics updates (``train.py:257-286``).
    ``remat`` True/"cell" checkpoints each cell.  ``pallas_conv`` routes
    eligible convs and [ReLU, Conv2d, BatchNorm] windows through the
    hand-written K1/K2 kernels (``ops/halo_conv.py``).
    """
    ctx = ApplyCtx(
        train=True,
        spatial=SpatialCtx(use_pallas_conv=True) if pallas_conv else None,
    )
    loss_fn = make_loss_fn(model, ctx, remat=remat)
    params = [p for p in model.parameters() if p.requires_grad]

    def grads_for(x, labels):
        loss, (logits, stats) = loss_fn(x.to(compute_dtype), labels)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), logits.detach(), stats, list(grads)

    return _accumulating_step(optimizer, params, grads_for, parts)


def _spatial_until(model: CellModel, spatial_until: Optional[int]) -> int:
    su = spatial_until or model.spatial_until or (len(model.cells) - 1)
    if not 1 <= su < len(model.cells):
        raise ValueError(f"spatial_until {su} outside [1, {len(model.cells) - 1}]")
    return su


def make_spatial_train_step(model: CellModel, optimizer: Optimizer,
                            sp: SpatialCtx, parts: int = 1,
                            compute_dtype=torch.float32,
                            spatial_until: Optional[int] = None,
                            junction: str = "gather", remat=False):
    """Spatial-parallel training step (``train.py:335-488``, one level):
    ``step(state, x, labels)`` takes the FULL batch of images, cuts this
    process's tiles from it (``sp.tiles.scatter``), runs cells [0,
    spatial_until) on the tiles, gathers, runs the tail on the full
    activation, and updates the parameters.

    Gradients: the tail runs on the same full activation on every tile's
    rank, so its loss and its gradients are complete on each, and the
    gather's backward hands each rank its own tile's cotangent (JAX
    differentiates ``pmean(loss)``, whose 1/P the all_gather's summing
    adjoint undoes).  The spatial region's gradients hold one tile's share
    each and are summed over the ranks (``sp.tiles.reduce_grads``; nothing
    to sum on the one-process grid); cross-tile BatchNorm's all-reduce
    sums its cotangents likewise.  ``sp.use_pallas_conv`` routes the
    region's stride-1 convs and K2 windows through the kernels."""
    if sp is None or not sp.active or sp.tiles is None:
        raise ValueError("make_spatial_train_step needs an active SpatialCtx with tiles")
    su = _spatial_until(model, spatial_until)
    ctx = ApplyCtx(train=True, spatial=sp)
    params = [p for p in model.parameters() if p.requires_grad]
    region_ids = {id(p) for cell in model.cells[:su] for p in cell.parameters()}
    region = [i for i, p in enumerate(params) if id(p) in region_ids]

    def grads_for(x, labels):
        c = dataclasses.replace(ctx, bn_sink={})
        logits = apply_spatial_model(model, sp.tiles.scatter(x.to(compute_dtype)), c,
                                     su, junction, remat=remat)
        if isinstance(logits, tuple):
            logits = logits[0]
        loss = cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), logits.detach(), c.bn_sink, list(grads)

    def reduce_grads(grads):
        sp.tiles.reduce_grads([grads[i] for i in region])

    return _accumulating_step(optimizer, params, grads_for, parts, reduce_grads)


def make_spatial_eval_step(model: CellModel, sp: SpatialCtx,
                           compute_dtype=torch.float32,
                           spatial_until: Optional[int] = None,
                           junction: str = "gather"):
    """Spatial-parallel inference step ``(x, labels) -> metrics`` (full
    images in; BatchNorm uses the running statistics)."""
    su = _spatial_until(model, spatial_until)
    ctx = ApplyCtx(train=False, spatial=sp)

    @torch.no_grad()
    def estep(x, labels):
        logits = apply_spatial_model(model, sp.tiles.scatter(x.to(compute_dtype)),
                                     ctx, su, junction)
        if isinstance(logits, tuple):
            logits = logits[0]
        return {"loss": cross_entropy(logits, labels),
                "accuracy": accuracy(logits, labels), "logits": logits}

    return estep


def make_eval_step(model: CellModel, compute_dtype=torch.float32):
    """Inference step ``(x, labels) -> metrics`` (BN uses running stats)."""
    ctx = ApplyCtx(train=False)

    @torch.no_grad()
    def estep(x, labels):
        logits = model(x.to(compute_dtype), ctx)
        if isinstance(logits, tuple):
            logits = logits[0]
        return {
            "loss": cross_entropy(logits, labels),
            "accuracy": accuracy(logits, labels),
            "logits": logits,
        }

    return estep
