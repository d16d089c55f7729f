"""NHWC layer library (counterpart of ``mpi4dl_tpu/layers.py``).

Each layer is an ``nn.Module`` whose ``forward(x, ctx)`` reads an
:class:`~mpi4dl_tpu_torch.layer_ctx.ApplyCtx`.  Layouts are the JAX
package's, so the two compare like with like: NHWC activations, HWIO conv
kernels, Dense ``(in, out)``; parameter and buffer names are the JAX
pytree's keys (``kernel``, ``bias``, ``scale``, ``mean``, ``var``).
Parameters are stored in ``param_dtype`` and cast to the activation's dtype
at use.  Library convs and pools see an NHWC tensor through a zero-copy
``permute(0, 3, 1, 2)``: an NCHW tensor in ``channels_last`` memory.

Left out of this port, because they do not change values: the TPU lane
padding (``MPI4DL_LANE_PAD``), the H-striped conv (``ops/hstripe_conv.py``,
a TPU memory lever), the phase-decomposed strided dx (``ops/conv_phase.py``,
value-identical to the library conv's backward) and the ``MPI4DL_*``
environment hatches.  Under an active :class:`SpatialCtx` convs and pools
exchange halos with the neighbouring tiles (``ops/halo.py``), BatchNorm
sums its statistics over the tiles and GlobalAvgPool averages over them,
as ``layers.py:223-249, 353-425, 646-728`` do.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_2d, halo_exchange_with_mask
from mpi4dl_tpu_torch.ops.halo_conv import halo_conv2d_t, pad_hw


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """U(-bound, bound), the JAX package's ``_uniform`` (layers.py:75)."""
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, device=generator.device)
        t.copy_((u * 2.0 - 1.0) * bound)


def _tiled(ctx: ApplyCtx):
    """The active SpatialCtx of ``ctx``, or None."""
    sp = ctx.spatial
    if sp is None or not sp.active:
        return None
    if sp.tiles is None:
        raise ValueError("an active SpatialCtx needs its tile backend (tiles=)")
    return sp


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Layer(nn.Module):
    """Base: ``forward(x, ctx)``; ``reset_parameters(generator)`` draws the
    JAX package's init (a no-op for layers without parameters)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass


class Conv2d(Layer):
    """2-D convolution, NHWC/HWIO, symmetric padding ((k-1)//2 by default).

    Dispatch order (``layers.py:213-301``): under spatial sharding the conv
    first pulls a halo of its padding width on the sharded dims (D1; not
    inside a D2 run, whose margin is already present) and runs VALID there,
    padding the other dims.  A conv that :meth:`_pallas_dispatchable`
    admits then runs as explicit pad + the margin-consuming K1 kernel
    (``ops/halo_conv.halo_conv2d_t``) — on any sharded tile, and unsharded
    only for the axis-free knob carrier; every other conv is the library
    conv, as the JAX package leaves it to XLA.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Any = 3,
                 stride: Any = 1, padding: Any = None, bias: bool = True,
                 feature_group_count: int = 1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.feature_group_count = feature_group_count
        kh, kw = _pair(kernel_size)
        self.kernel = nn.Parameter(torch.empty(
            (kh, kw, in_channels // feature_group_count, out_channels),
            device=device, dtype=dtype,
        ))
        self.bias = (
            nn.Parameter(torch.empty((out_channels,), device=device, dtype=dtype))
            if bias else None
        )

    def _geometry(self):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        if self.padding is None:
            ph, pw = (kh - 1) // 2, (kw - 1) // 2
        else:
            ph, pw = _pair(self.padding)
        return kh, kw, sh, sw, ph, pw

    def reset_parameters(self, generator):
        kh, kw = _pair(self.kernel_size)
        bound = 1.0 / math.sqrt(self.in_channels // self.feature_group_count * kh * kw)
        _uniform_(self.kernel, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    @staticmethod
    def _pallas_dispatchable(sp, kh, kw, sh, sw, groups) -> bool:
        """Route this conv through K1?  Stride 1, not 1x1 (a matmul the
        library handles), ungrouped.  There is no capacity test: the kernel
        streams Cin through a fixed shared-memory footprint
        (``csrc/halo_conv.cu``), so every such conv fits."""
        if not (sp is not None and sp.use_pallas_conv):
            return False
        return (sh, sw) == (1, 1) and (kh, kw) != (1, 1) and groups == 1

    def forward(self, x, ctx: ApplyCtx):
        kh, kw, sh, sw, ph, pw = self._geometry()
        kernel = self.kernel.to(x.dtype)
        sp = ctx.spatial
        if _tiled(ctx) is not None:
            halo_h = HaloSpec.symmetric(ph if sp.sharded_h else 0)
            halo_w = HaloSpec.symmetric(pw if sp.sharded_w else 0)
            if not sp.halo_pre_exchanged and (halo_h.lo or halo_w.lo):
                x = halo_exchange_2d(x, halo_h, halo_w, sp.axis_h, sp.axis_w,
                                     sp.grid_h, sp.grid_w, sp.tiles)
            # A dim whose margin came from the exchange needs no padding.
            ph = 0 if halo_h.lo else ph
            pw = 0 if halo_w.lo else pw
            use_pallas = True
        else:
            # Unsharded dispatch only for an axis-free knob carrier, the
            # make_train_step(pallas_conv=True) route (layers.py:257-259).
            use_pallas = sp is not None and sp.axis_h is None and sp.axis_w is None
        if use_pallas and self._pallas_dispatchable(
            sp, kh, kw, sh, sw, self.feature_group_count
        ):
            y = halo_conv2d_t(pad_hw(x, ph, pw), kernel)
        elif (kh, kw, ph, pw, self.feature_group_count) == (1, 1, 0, 0, 1):
            # An unpadded 1x1 conv is a channel matmul of the strided pixels.
            # (Also sidesteps a oneDNN fault: the CPU backward of two strided
            # 1x1 convs sharing a ReLU'd channels_last input corrupts memory
            # in torch 2.13.)
            y = x[:, ::sh, ::sw, :] @ kernel[0, 0]
        else:
            # OIHW weight made contiguous: a strided conv's CPU backward
            # corrupts memory on a permuted weight (torch 2.13, oneDNN).
            y = _nhwc(F.conv2d(
                _nchw(x), kernel.permute(3, 2, 0, 1).contiguous(), stride=(sh, sw),
                padding=(ph, pw), groups=self.feature_group_count,
            ))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class _BNStats(torch.autograd.Function):
    """(Σx, Σx²) over all but the channel dim and the first ``lead`` dims,
    accumulated in fp32 from the input dtype without keeping an fp32 copy
    of x for the backward; the gradient is JAX's: each term cast to x's
    dtype, then added."""

    @staticmethod
    def forward(ctx, x, lead):
        ctx.save_for_backward(x)
        dims = tuple(range(lead, x.dim() - 1))
        return (torch.sum(x, dim=dims, dtype=torch.float32),
                torch.sum(torch.square(x.float()), dim=dims))

    @staticmethod
    def backward(ctx, ct_s, ct_ss):
        (x,) = ctx.saved_tensors
        shape = ct_s.shape[:-1] + (1,) * (x.dim() - ct_s.dim()) + ct_s.shape[-1:]
        ct_s, ct_ss = ct_s.reshape(shape), ct_ss.reshape(shape)
        return ct_s.to(x.dtype) + (2.0 * x.float() * ct_ss).to(x.dtype), None


def per_tile_view(x: torch.Tensor, sp):
    """``x`` as ``[T, N, ...]`` when it holds every tile of the grid folded
    into its batch and the statistics are per tile; else None."""
    if sp is None or not sp.active or sp.bn_cross_tile or not sp.tiles.folded:
        return None
    return sp.tiles.per_tile(x)


def _fold(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x·a + b`` per channel; ``a``/``b`` of shape ``[T, C]`` apply per
    tile of a tile-folded ``x``."""
    if a.dim() == 1:
        return x * a + b
    t = a.shape[0]
    xt = x.reshape(t, x.shape[0] // t, *x.shape[1:])
    shape = (t,) + (1,) * (x.dim() - 1) + (a.shape[-1],)
    return (xt * a.reshape(shape) + b.reshape(shape)).reshape(x.shape)


class BatchNorm(Layer):
    """BatchNorm over (N, H, W) per channel, computed as ``layers.py:353-441``.

    Train: one sum/sumsq pair accumulated in fp32, ``var = max(ss/cnt −
    mean², 0)``, the normalisation folded to ``x·a + b`` with ``a, b`` cast
    to the compute dtype.  Under spatial sharding the sums are summed over
    the tiles (``bn_cross_tile``, single-device numerics) or kept per tile;
    inside a D2 run the margin not yet consumed is left out of them.  With
    ``ctx.bn_sink`` set, the momentum-updated running statistics (unbiased
    variance, torch semantics; per-tile statistics averaged over the tiles)
    are put in the sink, keyed by this layer.  Eval normalises with the
    running statistics in fp32.  ``F.batch_norm`` is not used: its bf16
    rounding differs.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, device=None, dtype=torch.float32):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        kw = dict(device=device, dtype=dtype)
        self.scale = nn.Parameter(torch.ones((num_features,), **kw))
        self.bias = nn.Parameter(torch.zeros((num_features,), **kw))
        self.register_buffer("mean", torch.zeros((num_features,), **kw))
        self.register_buffer("var", torch.ones((num_features,), **kw))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.fill_(0.0)
            self.mean.fill_(0.0)
            self.var.fill_(1.0)

    def forward(self, x, ctx: ApplyCtx):
        if not ctx.train:
            inv = torch.rsqrt(self.var.float() + self.eps) * self.scale.float()
            y = x.float() * inv + (self.bias.float() - self.mean.float() * inv)
            return y.to(x.dtype)
        sp = _tiled(ctx)
        stat_x = x
        if sp is not None and sp.halo_pre_exchanged and (
            sp.pre_margin_h or sp.pre_margin_w
        ):
            # Inside a D2 run the tile still carries margin rows not yet
            # consumed (neighbour copies, border zeros): the statistics come
            # from the true tile only (layers.py:381-391).
            mh = sp.pre_margin_h if sp.sharded_h else 0
            mw = sp.pre_margin_w if sp.sharded_w else 0
            stat_x = x[:, mh:x.shape[1] - mh, mw:x.shape[2] - mw, :]
        per_tile = per_tile_view(stat_x, sp)
        if per_tile is not None:
            s, ss = _BNStats.apply(per_tile, 1)
            cnt = float(per_tile[0].numel() // x.shape[-1])
        else:
            s, ss = _BNStats.apply(stat_x, 0)
            cnt = float(stat_x.numel() // x.shape[-1])
            if sp is not None and sp.bn_cross_tile:
                s, ss = sp.tiles.sum_stats(s, ss)
                cnt *= sp.tiles.count_factor
        mean = s / cnt
        var = torch.clamp(ss / cnt - mean * mean, min=0.0)
        return self.normalize_with_stats(x, mean, var, cnt, ctx)

    def normalize_with_stats(self, x, mean, var, cnt: float, ctx: ApplyCtx):
        """Train-mode normalisation with batch statistics computed outside
        (the fused K2 path; ``[T, C]`` statistics are per tile of a
        tile-folded ``x``); deposit and folded fma as :meth:`forward`."""
        if ctx.bn_sink is not None:
            self._deposit_running(mean, var, cnt, ctx)
        inv = torch.rsqrt(var + self.eps) * self.scale.float()
        a = inv.to(x.dtype)
        b = (self.bias.float() - mean * inv).to(x.dtype)
        return _fold(x, a, b)

    def _deposit_running(self, mean, var, cnt: float, ctx: ApplyCtx) -> None:
        mean, var = mean.detach(), var.detach()
        sp = _tiled(ctx)
        if sp is not None and not sp.bn_cross_tile:
            # Per-tile statistics vary over the tiles; the running buffers
            # take their mean (layers.py:443-461).
            mean, var = sp.tiles.tile_mean(mean), sp.tiles.tile_mean(var)
        m = self.momentum
        unbiased = var * (cnt / max(cnt - 1.0, 1.0))
        ctx.bn_sink[self] = (
            (1 - m) * self.mean.float() + m * mean,
            (1 - m) * self.var.float() + m * unbiased,
        )


class ReLU(Layer):
    def forward(self, x, ctx):
        return torch.relu(x)


class Identity(Layer):
    def forward(self, x, ctx):
        return x


class Dense(Layer):
    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, dtype=dtype)
        self.kernel = nn.Parameter(torch.empty((in_features, out_features), **kw))
        self.bias = nn.Parameter(torch.empty((out_features,), **kw))

    def reset_parameters(self, generator):
        bound = 1.0 / math.sqrt(self.in_features)
        _uniform_(self.kernel, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x, ctx):
        y = x @ self.kernel.to(x.dtype)
        return y + self.bias.to(y.dtype)


class Flatten(Layer):
    def forward(self, x, ctx):
        return x.reshape(x.shape[0], -1)


def _window_reduce(x, kh, kw, sh, sw, ph, pw, op: str):
    """Max or sum over windows, NHWC, padded with −inf (max) or 0 (sum) —
    the JAX package's ``_window_reduce`` (``layers.py:540-610``): the taps
    in row-major order, combined by a chain of ``maximum`` or ``+``.  That
    fixes where a max's gradient goes at ties: a reshaped ``amax`` splits
    it evenly over the tied elements (non-overlapping unpadded windows),
    and the ``maximum`` chain halves it at each tied pair.  The library
    pool sends it all to one element instead, and AmoebaNet's pools do see
    ties (BN outputs of all-zero ReLU pixels)."""
    n, h, w, c = x.shape
    if ph == 0 and pw == 0 and (kh, kw) == (sh, sw) and h % kh == 0 and w % kw == 0:
        r = x.reshape(n, h // kh, kh, w // kw, kw, c)
        return r.amax(dim=(2, 4)) if op == "max" else r.sum(dim=(2, 4))
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph),
                  value=float("-inf") if op == "max" else 0.0)
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    acc = None
    for i in range(kh):
        for j in range(kw):
            piece = x[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :]
            if acc is None:
                acc = piece
            elif op == "max":
                acc = torch.maximum(acc, piece)
            else:
                acc = acc + piece
    return acc


class Pool2d(Layer):
    """Max/avg pooling with the JAX package's border semantics
    (``layers.py:613-709``): max pads with −inf (:func:`_window_reduce`),
    and avg with ``count_include_pad=False`` divides the window sum by the
    in-bounds count.

    Under spatial sharding (D1) the pool exchanges a halo of its padding
    width together with a validity mask, so that max sees −inf and avg
    counts only in-bounds pixels beyond the image border: exact global
    semantics.  Inside a D2 run the margin is already present and the pool
    runs VALID on the sharded dims over pad-once zeros (``ops/d2.py``)."""

    def __init__(self, op: str, kernel_size: Any, stride: Any = None,
                 padding: Any = 0, count_include_pad: bool = True):
        super().__init__()
        assert op in ("max", "avg"), op
        self.op = op
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.count_include_pad = count_include_pad

    def _geometry(self):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride if self.stride is not None else self.kernel_size)
        ph, pw = _pair(self.padding)
        return kh, kw, sh, sw, ph, pw

    def forward(self, x, ctx: ApplyCtx):
        kh, kw, sh, sw, ph, pw = self._geometry()
        sp = _tiled(ctx)
        sharded_h = sp is not None and sp.sharded_h and ph > 0
        sharded_w = sp is not None and sp.sharded_w and pw > 0
        if not (sharded_h or sharded_w):
            if self.op == "max":
                return _window_reduce(x, kh, kw, sh, sw, ph, pw, "max")
            # The window sum over the in-bounds count, as the JAX package
            # computes it.  Not F.avg_pool2d: on CUDA its backward of a
            # padded window with count_include_pad=False on this
            # channels-last view gives wrong gradients (torch 2.11+cu128;
            # tests/test_torch_cuda.py holds it against the CPU).
            y = _window_reduce(x, kh, kw, sh, sw, ph, pw, "add")
            if self.count_include_pad or (ph == 0 and pw == 0):
                return y / (kh * kw)
            mask = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
            return y / torch.clamp(_window_reduce(mask, kh, kw, sh, sw, ph, pw, "add"), min=1)
        rem_ph = 0 if sp.sharded_h else ph
        rem_pw = 0 if sp.sharded_w else pw
        if sp.halo_pre_exchanged:
            # Pad-once D2 semantics: the margin rows beyond the border are
            # zeros (no −inf, no in-bounds divisor on the sharded dims).
            y = _window_reduce(x, kh, kw, sh, sw, rem_ph, rem_pw, self.op)
            return y if self.op == "max" else y / (kh * kw)
        halo_h = HaloSpec.symmetric(ph if sp.sharded_h else 0)
        halo_w = HaloSpec.symmetric(pw if sp.sharded_w else 0)
        mask = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        x, mask = halo_exchange_with_mask(x, mask, halo_h, halo_w, sp.axis_h,
                                          sp.axis_w, sp.grid_h, sp.grid_w, sp.tiles)
        if self.op == "max":
            x = torch.where(mask > 0, x, float("-inf"))
            return _window_reduce(x, kh, kw, sh, sw, rem_ph, rem_pw, "max")
        y = _window_reduce(x, kh, kw, sh, sw, rem_ph, rem_pw, "add")
        if self.count_include_pad:
            return y / (kh * kw)
        div = _window_reduce(mask, kh, kw, sh, sw, rem_ph, rem_pw, "add")
        return y / torch.clamp(div, min=1)


class GlobalAvgPool(Layer):
    """AdaptiveAvgPool2d((1, 1)) + flatten: the mean over H and W.  Under
    spatial sharding, the tile means averaged over the tiles
    (``layers.py:713-728``), which is the global mean since tiles are of
    one size; the result is the same on every tile."""

    def forward(self, x, ctx: ApplyCtx):
        y = x.mean(dim=(1, 2))
        sp = _tiled(ctx)
        if sp is None:
            return y
        if sp.tiles.folded:
            return sp.tiles.per_tile(y).mean(dim=0)
        return sp.tiles.sum_stats(y)[0] / sp.tiles.tiles


class Softmax(Layer):
    """Channel softmax, for the reference's softmax-in-model head
    (``layers.py:492-502``, ``--softmax-in-model``)."""

    def forward(self, x, ctx):
        return torch.softmax(x, dim=-1)
