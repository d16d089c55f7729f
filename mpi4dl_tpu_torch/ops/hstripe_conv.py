"""H-striped convolution and the H-striped layer run of a stride-1
residual branch (counterpart of ``mpi4dl_tpu/ops/hstripe_conv.py``).

:func:`hstripe_conv2d` (``hstripe_conv.py:42-128``) is one stride-1 conv
computed H stripe by H stripe, so that the conv's working set is one
stripe's: each stripe is a VALID conv of ``sh + kh - 1`` padded input rows,
and the backward builds dx and dw stripe by stripe into one buffer.  The
same function, another summation order; the stripe count keeps one
stripe's im2col patch within ``_PATCH_BUDGET`` (one stripe: the plain
conv).  The JAX package dispatches it from ``Conv2d`` for tiny-channel
huge-spatial convs, a TPU memory lever (``layers.py:182-200``); no layer of
this port does: on an H100 it saved no memory and was slower
(``chip_smoke.py``'s memory-lever phase, PERF.md §6).

The layer run (``hstripe_conv.py:140-386``: ``hstripe_run_eligible``,
``hstripe_layer_run`` and their exact-statistics mode): on one device, a
huge-spatial tiny-channel ResNet branch runs H stripe by H stripe: the
run's accumulated H margin is zero-padded once and each stripe goes
through :func:`~mpi4dl_tpu_torch.ops.d2.apply_layers_premargin` under a
fake H-sharded :class:`SpatialCtx` with no collectives (``stat_local``),
each stripe checkpointed so that the backward recomputes it.  That changes
the numbers, as it does in the JAX package, and the port follows it there:

- borders are pad-once zeros on H (the halo-D2 semantics); W keeps each
  conv's own SAME padding;
- train-mode BatchNorm takes each stripe's statistics (the margin rows
  left out), and its running statistics are the mean of the stripes'
  updates.  ``MPI4DL_HSTRIPE_EXACT=1`` fixes every BatchNorm's batch
  statistics to the whole input's instead, by one stripewise pass per
  BatchNorm (the prefix run with the earlier ones fixed), so that the
  striped run equals the unstriped pad-once run.

The run engages (:func:`hstripe_run_eligible`) only without a
``SpatialCtx`` — which ``--pallas-conv``'s knob carrier also is — on
inputs of at least ``_RUN_MIN_PIXELS`` = 2^22 pixels with at most 64
channels, and only where ``_RUN_STRIPE_BUDGET`` asks for more than one
stripe; an H with no reasonable divisor falls back to the plain branch
(:func:`hstripe_layer_run` returns None).  ``MPI4DL_HSTRIPE_RUN``: ``0``
never, ``1`` engage without the one-time warning, unset (auto) engage and
warn once.  ``MPI4DL_NO_HSTRIPE=1`` turns it off as well.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
from torch.utils.checkpoint import checkpoint

from mpi4dl_tpu_torch.layer_ctx import SpatialCtx
from mpi4dl_tpu_torch.layers import BatchNorm
from mpi4dl_tpu_torch.ops.d2 import (
    accumulated_halo, apply_layers_premargin, layer_d2_geometry,
)
from mpi4dl_tpu_torch.parallel.tiles import AXIS_SPH

_log = logging.getLogger("mpi4dl_tpu_torch")

# Bytes of a stripe's widest intermediate, and the input size below which a
# branch is not striped (hstripe_conv.py:159-160).
_RUN_STRIPE_BUDGET = 64 * 1024 * 1024
_RUN_MIN_PIXELS = 1 << 22

_RUN_WARNED = False


def hstripe_enabled() -> bool:
    """``MPI4DL_NO_HSTRIPE=1`` turns striping off (``layers.py:51-54``)."""
    return os.environ.get("MPI4DL_NO_HSTRIPE") != "1"


def _run_mode() -> str:
    return os.environ.get("MPI4DL_HSTRIPE_RUN", "auto")


def _exact_stats() -> bool:
    return os.environ.get("MPI4DL_HSTRIPE_EXACT") == "1"


# Bytes of one stripe's im2col patch (hstripe_conv.py:39).
_PATCH_BUDGET = 192 * 1024 * 1024
def _pick_stripes(h: int, wid: int, cin: int, kh: int, kw: int, itemsize: int) -> int:
    patch = h * wid * cin * kh * kw * itemsize
    if patch <= _PATCH_BUDGET:
        return 1
    return min(h, -(-patch // _PATCH_BUDGET))


def _nchw_w(w):
    return w.permute(3, 2, 0, 1).contiguous()


class _HStripeConv(torch.autograd.Function):
    """VALID conv of the padded ``xp`` [N, S·sh + kh - 1, Wp, Cin], stripe
    by stripe; the backward likewise (dx accumulated into one buffer, dw
    summed over the stripes)."""

    @staticmethod
    def forward(ctx, xp, w, stripes, sh):
        ctx.save_for_backward(xp, w)
        ctx.stripes, ctx.sh = stripes, sh
        kh = w.shape[0]
        wo = _nchw_w(w)
        ys = [torch.nn.functional.conv2d(
            xp[:, i * sh:i * sh + sh + kh - 1].permute(0, 3, 1, 2), wo).permute(0, 2, 3, 1)
            for i in range(stripes)]
        return torch.cat(ys, dim=1)

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        stripes, sh = ctx.stripes, ctx.sh
        kh, kw, cin, cout = w.shape
        wo = _nchw_w(w)
        dx = torch.zeros_like(xp)
        dw = torch.zeros(wo.shape, dtype=torch.float32 if w.dtype != torch.float64
                         else w.dtype, device=w.device)
        for i in range(stripes):
            xs = xp[:, i * sh:i * sh + sh + kh - 1].permute(0, 3, 1, 2)
            gs = g[:, i * sh:(i + 1) * sh].permute(0, 3, 1, 2).contiguous()
            dx[:, i * sh:i * sh + sh + kh - 1] += torch.nn.grad.conv2d_input(
                xs.shape, wo, gs).permute(0, 2, 3, 1)
            dw += torch.nn.grad.conv2d_weight(xs.contiguous(), wo.shape, gs)
        return dx, dw.permute(2, 3, 1, 0).to(w.dtype), None, None


def hstripe_conv2d(x, w, pad_h=(0, 0), pad_w=(0, 0)):
    """Stride-1 conv of ``x`` [N, H, W, Cin] with ``w`` [kh, kw, Cin,
    Cout] and explicit (lo, hi) padding, H stripe by H stripe
    (``hstripe_conv.py:62-128``): the stripe count keeps a stripe's patch
    within ``_PATCH_BUDGET``; a ragged last stripe runs over zero rows
    whose outputs are dropped.  One stripe: the plain conv."""
    n, h, wid, cin = x.shape
    kh, kw, _, _ = w.shape
    (phl, phh), (pwl, pwh) = pad_h, pad_w
    oh = h + phl + phh - (kh - 1)
    stripes = _pick_stripes(oh, wid + pwl + pwh, cin, kh, kw, x.element_size())
    if stripes == 1:
        xp = torch.nn.functional.pad(x, (0, 0, pwl, pwh, phl, phh))
        return torch.nn.functional.conv2d(xp.permute(0, 3, 1, 2), _nchw_w(w)).permute(0, 2, 3, 1)
    sh = -(-oh // stripes)
    stripes = -(-oh // sh)
    extra = stripes * sh - oh
    xp = torch.nn.functional.pad(x, (0, 0, pwl, pwh, phl, phh + extra))
    y = _HStripeConv.apply(xp, w, stripes, sh)
    return y[:, :oh] if extra else y


def _smallest_divisor_at_least(n: int, want: int) -> int:
    for s in range(max(1, want), n + 1):
        if n % s == 0:
            return s
    return n


def hstripe_run_eligible(layers, x_shape, ctx) -> bool:
    """Stripe this run?  One device (no ``SpatialCtx``), at most 64
    channels over at least 2^22 pixels, a positive accumulated H margin,
    every layer premargin-capable and of stride 1."""
    if _run_mode() == "0":
        return False
    if ctx.spatial is not None:
        return False
    n, h, w, c = x_shape
    if c > 64 or h * w < _RUN_MIN_PIXELS:
        return False
    acc = accumulated_halo(layers)
    if acc is None or acc[0] <= 0:
        return False
    for layer in layers:
        g = layer_d2_geometry(layer)
        if g is None or g[2] != 1 or g[3] != 1:
            return False
    return True


def _warn_engaged(pixels: int, exact: bool, train: bool) -> None:
    """The one-time notice that a train-mode run is striped (not in eval,
    which has no statistics to change; not under ``MPI4DL_HSTRIPE_RUN=1``)."""
    global _RUN_WARNED
    if not train or _run_mode() == "1" or _RUN_WARNED:
        return
    _RUN_WARNED = True
    bn_note = ("train-mode BN uses GLOBAL batch statistics (MPI4DL_HSTRIPE_EXACT)"
               if exact else "train-mode BN uses per-stripe statistics")
    _log.warning(
        "H-striped block execution engaged for %s-pixel input (%s; conv "
        "borders are pad-once zeros — the halo-D2 semantics).  Set "
        "MPI4DL_HSTRIPE_RUN=0 to disable, =1 to silence this.", pixels, bn_note)


class _FixedStatsBN:
    """A BatchNorm that normalises with batch statistics fixed outside (the
    whole input's), so that every stripe uses the same ones."""

    d2_identity = True  # consumes no margin (ops/d2.layer_d2_geometry)

    def __init__(self, bn: BatchNorm, mean, var, cnt: float):
        self.bn, self.mean, self.var, self.cnt = bn, mean, var, cnt

    def __call__(self, x, ctx):
        return self.bn.normalize_with_stats(x, self.mean, self.var, self.cnt, ctx)


def _sums(t: torch.Tensor, shards: int):
    """Per-channel (Σt, Σt²) in fp32 (float64 for float64), per batch shard
    when the batch holds ``shards`` of them (``ApplyCtx.bn_shards``)."""
    acc = torch.promote_types(t.dtype, torch.float32)
    if shards > 1:
        t = t.reshape(shards, t.shape[0] // shards, *t.shape[1:])
    dims = tuple(range(t.dim() - 4, t.dim() - 1))
    return t.sum(dim=dims, dtype=acc), t.to(acc).square().sum(dim=dims)


def _margin_at(layers, upto: int, m: int) -> int:
    for layer in layers[:upto]:
        m -= layer_d2_geometry(layer)[0]
    return m


def hstripe_layer_run(layers, x, ctx):
    """``layers`` (a stride-1 run) on ``x`` [N, H, W, C], stripe by stripe
    over H; None when H has no reasonable stripe divisor (the caller then
    takes its plain path)."""
    n, h, w, c = x.shape
    m = accumulated_halo(layers)[0]
    # Stripes sized by the run's widest intermediate, not its input.
    cmax = c
    for layer in layers:
        cmax = max(cmax, getattr(layer, "out_channels", 0),
                   getattr(layer, "num_features", 0))
    per_row = w * cmax * x.element_size() * n
    want = max(1, -(-(h * per_row) // _RUN_STRIPE_BUDGET))
    stripes = _smallest_divisor_at_least(h, want)
    sh = h // stripes
    if stripes == 1 or sh < m + 1 or stripes > 4 * want:
        # A near-prime H: a ragged stripe would put padding rows into the
        # per-stripe statistics, so the plain path runs instead.
        return None
    sctx = ctx.with_spatial(SpatialCtx(axis_h=AXIS_SPH, grid_h=stripes,
                                       bn_cross_tile=False, stat_local=True))
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, m, m))

    def stripe(i):
        return xp[:, i * sh:i * sh + sh + 2 * m]

    eff = list(layers)
    exact = _exact_stats() and ctx.train
    _warn_engaged(h * w, exact, ctx.train)
    if exact:
        nostat = dataclasses.replace(sctx, bn_sink=None)
        shards = ctx.bn_shards
        for j, layer in enumerate(layers):
            if not isinstance(layer, BatchNorm):
                continue
            if j == 0:
                s, ss = _sums(x, shards)
            else:
                mh_j = _margin_at(eff, j, m)
                s = ss = 0
                for i in range(stripes):
                    y, mh_out, _ = apply_layers_premargin(eff[:j], stripe(i), nostat, m, 0)
                    assert mh_out == mh_j, (mh_out, mh_j)
                    a, b = _sums(y[:, mh_j:mh_j + sh], shards)
                    s, ss = s + a, ss + b
            cnt = float(n // shards * h * w)
            mean = s / cnt
            var = torch.clamp(ss / cnt - mean * mean, min=0.0)
            eff[j] = _FixedStatsBN(layer, mean, var, cnt)

    sinks = []

    def piece(xs):
        inner = {} if ctx.bn_sink is not None else None
        y, mh, mw = apply_layers_premargin(
            eff, xs, dataclasses.replace(sctx, bn_sink=inner), m, 0)
        assert mh == 0 and mw == 0 and y.shape[2] == w, (mh, mw, y.shape)
        if inner is not None and len(sinks) < stripes:  # not again in the recompute
            sinks.append(inner)
        return y

    grad = torch.is_grad_enabled()
    ys = [checkpoint(piece, stripe(i), use_reentrant=False) if grad else piece(stripe(i))
          for i in range(stripes)]
    if ctx.bn_sink is not None:
        for bn in sinks[0]:
            ctx.bn_sink[bn] = tuple(sum(s[bn][k] for s in sinks) / stripes for k in (0, 1))
    return torch.cat(ys, dim=1)
