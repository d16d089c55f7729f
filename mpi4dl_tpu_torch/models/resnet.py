"""ResNet v1 (6n+2) and v2 bottleneck (9n+2) as cell lists (counterpart of
``mpi4dl_tpu/models/resnet.py``).

The reference's topology: a flat sequence of coarse cells ending in an
avg-pool + FC head.  One definition serves single-device and spatial
execution; under D2 each residual block's branch is one fused run
(:func:`~mpi4dl_tpu_torch.ops.d2.maybe_run_d2`), its shortcut tapping the
pre-exchange input.  The convs carry a bias, so no window is a K2 window;
stride-1 3x3 convs take K1 when the kernel knob is on.  On one device a
stride-1 v2 branch of 2^22 pixels or more with ≤ 64 channels runs H
stripe by H stripe, as in the JAX package
(:func:`~mpi4dl_tpu_torch.ops.hstripe_conv.hstripe_layer_run`: pad-once
borders, per-stripe BatchNorm statistics).  With ``--stripe-bwd`` a
stride-1 branch runs through the stripe-wise backward first
(:func:`~mpi4dl_tpu_torch.ops.stripe_bwd.maybe_stripe_run`,
``resnet.py:136-142, 214-221``), and under fine remat (``ctx.remat_ops``)
each sub-cell of a branch is its own checkpoint (``resnet.py:71-85``).

``softmax_in_model`` reproduces the reference's softmax inside the model
(followed by its cross-entropy, a double softmax).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from mpi4dl_tpu_torch.cells import Cell, CellModel, LayerCell, checkpointed_apply
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.layers import (
    BatchNorm, Conv2d, Dense, Flatten, Layer, Pool2d, ReLU, Softmax,
)
from mpi4dl_tpu_torch.ops.d2 import maybe_run_d2
from mpi4dl_tpu_torch.ops.hstripe_conv import (
    hstripe_enabled, hstripe_layer_run, hstripe_run_eligible,
)
from mpi4dl_tpu_torch.ops.stripe_bwd import maybe_stripe_run


def _resnet_layer(in_f: int, out_f: int, kernel: int = 3, stride: int = 1,
                  activation: bool = True, batch_norm: bool = True,
                  conv_first: bool = True) -> List[Layer]:
    """conv-bn-act (conv_first) or bn-act-conv (pre-activation)."""
    conv = Conv2d(in_f, out_f, kernel_size=kernel, stride=stride)
    if conv_first:
        seq: List[Layer] = [conv]
        if batch_norm:
            seq.append(BatchNorm(out_f))
        if activation:
            seq.append(ReLU())
        return seq
    seq = []
    if batch_norm:
        seq.append(BatchNorm(in_f))
    if activation:
        seq.append(ReLU())
    seq.append(conv)
    return seq


def _apply_branch(sub_cells, x, ctx: ApplyCtx):
    """A residual branch's sub-cells in order, each its own checkpoint
    under fine remat."""
    for cell in sub_cells:
        x = checkpointed_apply(cell, x, ctx) if ctx.remat_ops else cell(x, ctx)
    return x


class ResBlockV1(Cell):
    """v1 basic residual cell: relu(shortcut(x) + r2(r1(x)))."""

    def __init__(self, in_f: int, out_f: int, stride: int, shortcut_conv: bool,
                 name: str = "res_v1"):
        super().__init__(name)
        self.stride = stride
        self.r1 = LayerCell(_resnet_layer(in_f, out_f, stride=stride))
        self.r2 = LayerCell(_resnet_layer(out_f, out_f, activation=False))
        self.r3 = (LayerCell(_resnet_layer(in_f, out_f, kernel=1, stride=stride,
                                           activation=False, batch_norm=False))
                   if shortcut_conv else None)

    def forward(self, x, ctx: ApplyCtx):
        branch = list(self.r1.layers) + list(self.r2.layers)
        y = maybe_run_d2(branch, x, ctx)
        if y is None and self.stride == 1:
            y = maybe_stripe_run(branch, x, ctx)
        if y is None:
            y = _apply_branch((self.r1, self.r2), x, ctx)
        if self.r3 is not None:
            x = self.r3(x, ctx)
        return torch.relu(x + y)


class ResBlockV2(Cell):
    """v2 pre-activation bottleneck cell: shortcut(x) + r3(r2(r1(x))), r1
    and r2 3x3, r3 the 1x1 expansion, no ReLU after the add."""

    def __init__(self, in_f: int, f1: int, f2: int, stride: int,
                 first_block: bool, pre_activation: bool, name: str = "res_v2"):
        super().__init__(name)
        self.stride = stride
        self.r1 = LayerCell(_resnet_layer(
            in_f, f1, stride=stride, activation=pre_activation,
            batch_norm=pre_activation, conv_first=False))
        self.r2 = LayerCell(_resnet_layer(f1, f1, conv_first=False))
        self.r3 = LayerCell(_resnet_layer(f1, f2, kernel=1, conv_first=False))
        self.r4 = (LayerCell(_resnet_layer(in_f, f2, kernel=1, stride=stride,
                                           activation=False, batch_norm=False))
                   if first_block else None)

    def forward(self, x, ctx: ApplyCtx):
        branch = list(self.r1.layers) + list(self.r2.layers) + list(self.r3.layers)
        # D2: one halo exchange for the whole bottleneck.
        y = maybe_run_d2(branch, x, ctx)
        if y is None and self.stride == 1:
            # The whole bottleneck stripe-wise, one accumulated halo.
            y = maybe_stripe_run(branch, x, ctx)
        if (y is None and self.stride == 1 and hstripe_enabled()
                and hstripe_run_eligible(branch, x.shape, ctx)):
            # One device, huge spatial: the branch H stripe by H stripe.
            y = hstripe_layer_run(branch, x, ctx)
        if y is None:
            y = _apply_branch((self.r1, self.r2, self.r3), x, ctx)
        if self.r4 is not None:
            x = self.r4(x, ctx)
        return x + y


def _head(num_filters: int, num_classes: int, pool_kernel: int, with_bn: bool,
          softmax_in_model: bool, feature_hw: int) -> LayerCell:
    """avg-pool + flatten + FC head."""
    seq: List[Layer] = []
    if with_bn:
        seq += [BatchNorm(num_filters), ReLU()]
    seq.append(Pool2d("avg", pool_kernel))
    seq.append(Flatten())
    flat = num_filters * (feature_hw // pool_kernel) ** 2
    seq.append(Dense(flat, num_classes))
    if softmax_in_model:
        seq.append(Softmax())
    return LayerCell(seq, name="head")


def _finish(cells, in_shape, num_classes, name, device, seed, dtype) -> CellModel:
    dev = resolve_device(device)
    model = CellModel(cells, in_shape, num_classes, name=name)
    model.to(device=dev, dtype=dtype)
    if dev.type != "meta":  # a meta model has shapes only
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model.reset_parameters(gen)
    return model


def get_resnet_v1(in_shape: Tuple[int, int, int, int], depth: int,
                  num_classes: int = 10, softmax_in_model: bool = False,
                  device="cuda", seed: int = 0, dtype=torch.float32) -> CellModel:
    if (depth - 2) % 6 != 0:
        raise ValueError("depth should be 6n+2 (e.g. 20, 32, 44)")
    n_blocks = (depth - 2) // 6
    cells: List[Cell] = [LayerCell(_resnet_layer(3, 16), name="stem")]
    in_f, f = 16, 16
    for stack in range(3):
        for block in range(n_blocks):
            stride = 2 if (stack > 0 and block == 0) else 1
            cells.append(ResBlockV1(in_f, f, stride,
                                    shortcut_conv=(block == 0 and stack > 0),
                                    name=f"s{stack}b{block}"))
            in_f = f
        f *= 2
    feature_hw = in_shape[1] // 4  # two stride-2 stages
    cells.append(_head(in_f, num_classes, 8, False, softmax_in_model, feature_hw))
    return _finish(cells, in_shape, num_classes, f"resnet{depth}_v1", device,
                   seed, dtype)


def get_resnet_v2(in_shape: Tuple[int, int, int, int], depth: int,
                  num_classes: int = 10, softmax_in_model: bool = False,
                  device="cuda", seed: int = 0, dtype=torch.float32) -> CellModel:
    if (depth - 2) % 9 != 0:
        raise ValueError("depth should be 9n+2 (e.g. 56, 110)")
    n_blocks = (depth - 2) // 9
    cells: List[Cell] = [LayerCell(_resnet_layer(3, 16), name="stem")]
    in_f, f_in = 16, 16
    for stage in range(3):
        for block in range(n_blocks):
            stride, pre_act = 1, True
            if stage == 0:
                f_out = f_in * 4
                pre_act = block != 0
            else:
                f_out = f_in * 2
                stride = 2 if block == 0 else 1
            cells.append(ResBlockV2(in_f, f_in, f_out, stride,
                                    first_block=(block == 0), pre_activation=pre_act,
                                    name=f"s{stage}b{block}"))
            in_f = f_out
        f_in = f_out
    feature_hw = in_shape[1] // 4
    cells.append(_head(in_f, num_classes, 8, True, softmax_in_model, feature_hw))
    return _finish(cells, in_shape, num_classes, f"resnet{depth}_v2", device,
                   seed, dtype)


def get_resnet(in_shape, depth: int, num_classes: int = 10, version: int = 2,
               softmax_in_model: bool = False, device="cuda", seed: int = 0,
               dtype=torch.float32) -> CellModel:
    fn = get_resnet_v1 if version == 1 else get_resnet_v2
    return fn(in_shape, depth, num_classes, softmax_in_model, device=device,
              seed=seed, dtype=dtype)
