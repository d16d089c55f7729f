"""AmoebaNet-D as a cell list (counterpart of
``mpi4dl_tpu/models/amoebanet.py``).

A Stem, two reduction stem cells, three groups of normal cells separated by
reduction cells, and a Classify head; each NAS cell carries ``(x, skip)``.
The reference's ``max_pool_3x3`` builds an AvgPool; here, as in the JAX
package, it is a real max pool.  The ``MPI4DL_LANE_PAD`` lane padding is a
TPU layout lever and is left out.  Under D2 a normal cell exchanges each
of its two input states once, by the margin its consumers need
(:meth:`AmoebaCell.d2_plan`), and runs its ops margin-consuming.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch import nn

from mpi4dl_tpu_torch.cells import Cell, CellModel, LayerCell
from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.layers import (
    BatchNorm, Conv2d, Dense, GlobalAvgPool, Identity, Layer, Pool2d, ReLU,
)
from mpi4dl_tpu_torch.ops.d2 import accumulated_halo, apply_layers_premargin
from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_2d


def _relu_conv_bn(in_c: int, out_c: int, kernel=1, stride=1,
                  padding=0) -> List[Layer]:
    return [
        ReLU(),
        Conv2d(in_c, out_c, kernel_size=kernel, stride=stride, padding=padding,
               bias=False),
        BatchNorm(out_c),
    ]


class FactorizedReduce(Cell):
    """relu → concat(conv1(x), conv2(x)) → bn, both 1x1 stride-2 halves on
    the same input (the reference's shifted second path is commented out)."""

    def __init__(self, in_c: int, out_c: int, name: str = "fact_reduce"):
        super().__init__(name)
        self.conv1 = Conv2d(in_c, out_c // 2, kernel_size=1, stride=2,
                            padding=0, bias=False)
        self.conv2 = Conv2d(in_c, out_c // 2, kernel_size=1, stride=2,
                            padding=0, bias=False)
        self.bn = BatchNorm(out_c)

    def forward(self, x, ctx):
        x = torch.relu(x)
        y = torch.cat([self.conv1(x, ctx), self.conv2(x, ctx)], dim=-1)
        return self.bn(y, ctx)


def op_none(c: int, stride: int) -> Cell:
    if stride == 1:
        return LayerCell([Identity()], name="none")
    return FactorizedReduce(c, c)


def op_avg_pool_3x3(c: int, stride: int) -> Cell:
    return LayerCell([Pool2d("avg", 3, stride, 1, count_include_pad=False)],
                     name="avg_pool_3x3")


def op_max_pool_3x3(c: int, stride: int) -> Cell:
    return LayerCell([Pool2d("max", 3, stride, 1)], name="max_pool_3x3")


def op_max_pool_2x2(c: int, stride: int) -> Cell:
    return LayerCell([Pool2d("max", 2, stride, 0)], name="max_pool_2x2")


def op_conv_1x1(c: int, stride: int) -> Cell:
    return LayerCell(_relu_conv_bn(c, c, 1, stride, 0), name="conv_1x1")


def op_conv_3x3(c: int, stride: int) -> Cell:
    m = c // 4  # bottleneck c → c/4 → c
    return LayerCell(
        _relu_conv_bn(c, m, 1, 1, 0)
        + _relu_conv_bn(m, m, 3, stride, 1)
        + _relu_conv_bn(m, c, 1, 1, 0),
        name="conv_3x3",
    )


def op_conv_1x7_7x1(c: int, stride: int) -> Cell:
    m = c // 4  # c → c/4 → (1,7) → (7,1) → c, stride once per image dim
    return LayerCell(
        _relu_conv_bn(c, m, 1, 1, 0)
        + _relu_conv_bn(m, m, (1, 7), (1, stride), (0, 3))
        + _relu_conv_bn(m, m, (7, 1), (stride, 1), (3, 0))
        + _relu_conv_bn(m, c, 1, 1, 0),
        name="conv_1x7_7x1",
    )


# Genotype: (input state index, op constructor) pairs.
NORMAL_OPERATIONS: List[Tuple[int, Callable[[int, int], Cell]]] = [
    (1, op_conv_1x1),
    (1, op_max_pool_3x3),
    (1, op_none),
    (0, op_conv_1x7_7x1),
    (0, op_conv_1x1),
    (0, op_conv_1x7_7x1),
    (2, op_max_pool_3x3),
    (2, op_none),
    (1, op_avg_pool_3x3),
    (5, op_conv_1x1),
]
NORMAL_CONCAT = [0, 3, 4, 6]

REDUCTION_OPERATIONS: List[Tuple[int, Callable[[int, int], Cell]]] = [
    (0, op_max_pool_2x2),
    (0, op_max_pool_3x3),
    (2, op_none),
    (1, op_conv_3x3),
    (2, op_conv_1x7_7x1),
    (2, op_max_pool_3x3),
    (3, op_none),
    (1, op_max_pool_2x2),
    (2, op_avg_pool_3x3),
    (3, op_conv_1x1),
]
REDUCTION_CONCAT = [4, 5, 6]


class Stem(Cell):
    """relu → conv3x3 s2 → bn (the ReLU on the raw input is the
    reference's)."""

    def __init__(self, channels: int, name: str = "stem"):
        super().__init__(name)
        self.conv = Conv2d(3, channels, 3, stride=2, padding=1, bias=False)
        self.bn = BatchNorm(channels)

    def forward(self, x, ctx):
        return self.bn(self.conv(torch.relu(x), ctx), ctx)


class AmoebaCell(Cell):
    """One NAS cell: state in/out is (x, skip); a lone tensor is both."""

    def __init__(self, channels_prev_prev: int, channels_prev: int,
                 channels: int, reduction: bool, reduction_prev: bool,
                 name: str = "amoeba_cell"):
        super().__init__(name)
        c = channels
        self.reduction = reduction
        self.reduce1 = LayerCell(_relu_conv_bn(channels_prev, c), name="reduce1")
        if reduction_prev:
            self.reduce2: Cell = FactorizedReduce(channels_prev_prev, c)
        elif channels_prev_prev != c:
            self.reduce2 = LayerCell(_relu_conv_bn(channels_prev_prev, c),
                                     name="reduce2")
        else:
            self.reduce2 = LayerCell([Identity()], name="reduce2_id")
        spec = REDUCTION_OPERATIONS if reduction else NORMAL_OPERATIONS
        self.concat = REDUCTION_CONCAT if reduction else NORMAL_CONCAT
        self.indices = [i for i, _ in spec]
        self.ops = nn.ModuleList(
            ctor(c, 2 if (reduction and i < 2) else 1) for i, ctor in spec
        )

    def forward(self, x, ctx: ApplyCtx):
        sp = ctx.spatial
        if (sp is not None and sp.active and sp.d2_mode
                and not sp.halo_pre_exchanged and not self.reduction):
            plan = self.d2_plan()
            if plan is not None:
                return self._apply_d2(x, ctx, plan)
        s1, s2 = x if isinstance(x, tuple) else (x, x)
        states = [self.reduce1(s1, ctx), self.reduce2(s2, ctx)]
        for j in range(0, len(self.ops), 2):
            y1 = self.ops[j](states[self.indices[j]], ctx)
            y2 = self.ops[j + 1](states[self.indices[j + 1]], ctx)
            states.append(y1 + y2)
        return torch.cat([states[i] for i in self.concat], dim=-1), s1

    def d2_plan(self):
        """Static margin plan of cell-level D2 (``amoebanet.py:348-383``):
        ``need[s]`` = max over the ops reading state s of (the op's
        accumulated halo + need[the op's output state]), found by a
        backward pass over the genotype; intermediate states take leftover
        margin by cropping.  The normal cell gives need[s1] = 3 and
        need[s2] = 2, the reference Cell_D2's constants.  None when an op
        cannot take part."""
        margins = []
        for op in self.ops:
            acc = accumulated_halo(op.layers) if isinstance(op, LayerCell) else None
            if acc is None:
                return None
            margins.append(acc)
        need = [(0, 0)] * (2 + len(self.ops) // 2)
        for j in reversed(range(0, len(self.ops), 2)):
            out_state = 2 + j // 2
            for jj in (j, j + 1):
                s_in = self.indices[jj]
                ch, cw = margins[jj]
                need[s_in] = (max(need[s_in][0], ch + need[out_state][0]),
                              max(need[s_in][1], cw + need[out_state][1]))
        return {"need": need, "margins": margins}

    def _apply_d2(self, x, ctx: ApplyCtx, plan):
        """One halo exchange per input state; the ops run margin-consuming;
        intermediate states realign by cropping leftover margin."""
        sp = ctx.spatial
        need = plan["need"]

        def dims(nh, nw):
            return (nh if sp.sharded_h else 0, nw if sp.sharded_w else 0)

        def crop(t, ch, cw):
            if ch == 0 and cw == 0:
                return t
            return t[:, ch:t.shape[1] - ch, cw:t.shape[2] - cw, :]

        s1_in, s2_in = x if isinstance(x, tuple) else (x, x)
        states = []
        for t, (nh, nw) in ((self.reduce1(s1_in, ctx), need[0]),
                            (self.reduce2(s2_in, ctx), need[1])):
            mh, mw = dims(nh, nw)
            t = halo_exchange_2d(t, HaloSpec.symmetric(mh), HaloSpec.symmetric(mw),
                                 sp.axis_h, sp.axis_w, sp.grid_h, sp.grid_w, sp.tiles)
            states.append((t, mh, mw))
        for j in range(0, len(self.ops), 2):
            tnh, tnw = dims(*need[2 + j // 2])
            outs = []
            for jj in (j, j + 1):
                t, mh, mw = states[self.indices[jj]]
                y, mho, mwo = apply_layers_premargin(self.ops[jj].layers, t, ctx, mh, mw)
                outs.append(crop(y, mho - tnh, mwo - tnw))
            states.append((outs[0] + outs[1], tnh, tnw))
        out = torch.cat([crop(*states[i]) for i in self.concat], dim=-1)
        return out, s1_in


class Classify(Cell):
    """(x, skip) → global average pool → FC."""

    def __init__(self, channels_prev: int, num_classes: int,
                 name: str = "classify"):
        super().__init__(name)
        self.pool = GlobalAvgPool()
        self.fc = Dense(channels_prev, num_classes)

    def forward(self, x, ctx):
        if isinstance(x, tuple):
            x = x[0]
        return self.fc(self.pool(x, ctx), ctx)


def amoebanetd(in_shape: Tuple[int, int, int, int], num_classes: int = 10,
               num_layers: int = 4, num_filters: int = 512, device="cuda",
               seed: int = 0, dtype=torch.float32) -> CellModel:
    """Build AmoebaNet-D on ``device`` with parameters in ``dtype``, drawn
    from a ``torch.Generator`` seeded with ``seed`` (the JAX package's
    bounds, not its random bits)."""
    assert num_layers % 3 == 0, "num_layers must be divisible by 3"
    dev = resolve_device(device)
    repeat_normal = num_layers // 3
    channels = num_filters // 4
    channels_prev_prev = channels_prev = channels
    reduction_prev = False
    cells: List[Cell] = [Stem(channels)]

    def add_cell(reduction: bool, scale: int, name: str):
        nonlocal channels, channels_prev, channels_prev_prev, reduction_prev
        channels *= scale
        cell = AmoebaCell(channels_prev_prev, channels_prev, channels,
                          reduction, reduction_prev, name=name)
        cells.append(cell)
        channels_prev_prev = channels_prev
        channels_prev = channels * len(cell.concat)
        reduction_prev = reduction

    add_cell(True, 2, "stem2")
    add_cell(True, 2, "stem3")
    for i in range(repeat_normal):
        add_cell(False, 1, f"cell1_normal{i + 1}")
    add_cell(True, 2, "cell2_reduction")
    for i in range(repeat_normal):
        add_cell(False, 1, f"cell3_normal{i + 1}")
    add_cell(True, 2, "cell4_reduction")
    for i in range(repeat_normal):
        add_cell(False, 1, f"cell5_normal{i + 1}")
    cells.append(Classify(channels_prev, num_classes))

    model = CellModel(cells, in_shape, num_classes,
                      name=f"amoebanetd_l{num_layers}_f{num_filters}")
    model.to(device=dev, dtype=dtype)
    if dev.type != "meta":  # a meta model has shapes only
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model.reset_parameters(gen)
    return model
