"""Stripe-wise backward through spatial-region blocks (counterpart of
``mpi4dl_tpu/ops/stripe_bwd.py``; ``--stripe-bwd``).

A stride-1 run of layers (a ResNet branch, a layer cell) runs — forward and
backward — one H stripe at a time, so that its backward holds one stripe's
internals instead of the whole tile's intermediate trail:

- the run's accumulated halo (``ops/d2.accumulated_halo``) is realized
  ONCE: a halo exchange on the spatially sharded dims (zeros at the image
  border), a zero pad on an unsharded H — the halo-D2 pad-once borders;
- each H stripe of the margined tile then goes through
  :func:`~mpi4dl_tpu_torch.ops.d2.apply_layers_premargin` under its own
  ``torch.utils.checkpoint``, so the backward recomputes and transposes one
  stripe at a time.

Train-mode BatchNorm takes per-stripe statistics of each tile (the margin
rows left out); ``MPI4DL_HSTRIPE_EXACT=1`` fixes every BatchNorm's
statistics to the whole run's instead (one checkpointed stripewise pass
per BatchNorm, summed over the tiles where the statistics are
cross-tile), which makes the striped run equal the unstriped pad-once run.
The running statistics are the mean of the stripes' updates, averaged over
the tiles.  The kernels are off inside a stripe (``stripe_bwd.py:323``).

Off unless ``MPI4DL_STRIPE_BWD`` is ``1`` (spatially sharded blocks — the
runners' ``--stripe-bwd`` sets it) or ``all`` (every eligible block);
``MPI4DL_STRIPE_BUDGET`` sets the bytes of one stripe's widest
intermediate (64 MiB).  A run engages only where more than one stripe is
needed and the tile's H has a reasonable divisor (:func:`_stripe_plan`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from mpi4dl_tpu_torch.layer_ctx import SpatialCtx
from mpi4dl_tpu_torch.layers import BatchNorm, Conv2d, Pool2d
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.ops.d2 import accumulated_halo, apply_layers_premargin, layer_d2_geometry
from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_2d
from mpi4dl_tpu_torch.ops.hstripe_conv import _FixedStatsBN, _smallest_divisor_at_least, _sums
from mpi4dl_tpu_torch.parallel.tiles import AXIS_SPH

_STRIPE_BUDGET_DEFAULT = 64 * 1024 * 1024


def stripe_bwd_mode() -> str:
    """``MPI4DL_STRIPE_BWD``: ``0``/unset off, ``1`` spatially sharded
    blocks, ``all`` every eligible block (``stripe_bwd.py:60-82``)."""
    return os.environ.get("MPI4DL_STRIPE_BWD", "0")


def stripe_bwd_enabled() -> bool:
    return stripe_bwd_mode() in ("1", "all")


def _stripe_budget() -> int:
    try:
        v = int(os.environ.get("MPI4DL_STRIPE_BUDGET", "0"))
    except ValueError:
        v = 0
    return v if v > 0 else _STRIPE_BUDGET_DEFAULT


def _exact_stats() -> bool:
    return os.environ.get("MPI4DL_HSTRIPE_EXACT") == "1"


def _run_halo(layers) -> Optional[Tuple[int, int]]:
    """(hh, hw) of a stride-1 premargin-capable run with a Conv2d,
    BatchNorm or pool in it; else None (``stripe_bwd.py:103-124``)."""
    acc = accumulated_halo(layers)
    if acc is None:
        return None
    if any(layer_d2_geometry(l)[2:] != (1, 1) for l in layers):
        return None
    if not any(isinstance(l, (Conv2d, BatchNorm, Pool2d)) for l in layers):
        return None
    return acc


def _widest_row_bytes(layers, x_shape, itemsize: int, tiles: int = 1) -> int:
    """Bytes of one H row of the run's widest intermediate on one device
    (``tiles``: the tiles folded into the batch of the one-process grid)."""
    n, h, w, c = x_shape
    n //= tiles
    cmax = c
    for layer in layers:
        cmax = max(cmax, getattr(layer, "out_channels", 0), getattr(layer, "num_features", 0))
    return n * w * cmax * itemsize


def _pick_stripes(h: int, row_bytes: int) -> Optional[Tuple[int, int]]:
    """(stripes, stripe height), or None: one stripe suffices, or ``h`` has
    no reasonable divisor (``stripe_bwd.py:141-157``)."""
    want = max(1, -(-(h * row_bytes) // _stripe_budget()))
    if want <= 1:
        return None
    stripes = _smallest_divisor_at_least(h, want)
    if stripes == 1 or stripes == h or stripes > 4 * want:
        return None
    return stripes, h // stripes


def _stripe_plan(layers, x_shape, ctx, itemsize: int):
    """The dispatch gate (``stripe_bwd.py:174-204``): ``(acc_halo, (stripes,
    stripe_h))`` or None."""
    if not stripe_bwd_enabled():
        return None
    sp = ctx.spatial
    if sp is not None and (sp.halo_pre_exchanged or sp.stat_local):
        return None
    if stripe_bwd_mode() != "all" and not (sp is not None and sp.active):
        return None
    if len(x_shape) != 4:
        return None
    acc = _run_halo(layers)
    if acc is None:
        return None
    sharded_h = sp is not None and sp.active and sp.sharded_h
    sharded_w = sp is not None and sp.active and sp.sharded_w
    if (sharded_h and acc[0] > x_shape[1]) or (sharded_w and acc[1] > x_shape[2]):
        return None
    folded = sp.tiles.tiles if sp is not None and sp.active and sp.tiles.folded else 1
    plan = _pick_stripes(x_shape[1], _widest_row_bytes(layers, x_shape, itemsize, folded))
    return None if plan is None else (acc, plan)


def stripe_run_eligible(layers, x_shape, ctx, itemsize: int = 4) -> bool:
    return _stripe_plan(layers, x_shape, ctx, itemsize) is not None


def maybe_stripe_run(layers, x, ctx):
    """``layers`` stripe-wise when eligible, else None (the caller's path)."""
    if not isinstance(x, torch.Tensor):
        return None
    got = _stripe_plan(layers, x.shape, ctx, x.element_size())
    if got is None:
        return None
    return stripe_layer_run(layers, x, ctx, *got)


def _margins_at(layers, upto: int, mh: int, mw: int) -> Tuple[int, int]:
    """The (H, W) margin left at the input of ``layers[upto]``; W decays
    only where a margin was realized."""
    for layer in layers[:upto]:
        ph, pw, _, _ = layer_d2_geometry(layer)
        mh -= ph
        if mw:
            mw -= pw
    return mh, mw


def stripe_layer_run(layers, x, ctx, acc=None, plan=None):
    """``layers`` (a stride-1 run) on the tile ``x`` [N, H, W, C], stripe by
    stripe over H with a stripe-bounded backward (``stripe_bwd.py:
    235-421``); None when no stripe plan exists."""
    sp = ctx.spatial
    active = sp is not None and sp.active
    sharded_h, sharded_w = active and sp.sharded_h, active and sp.sharded_w
    acc = acc or _run_halo(layers)
    mh, mw = acc[0], (acc[1] if sharded_w else 0)
    n, h, w, c = x.shape
    plan = plan or _pick_stripes(h, _widest_row_bytes(
        layers, x.shape, x.element_size(), sp.tiles.tiles if active and sp.tiles.folded else 1))
    if plan is None:
        return None
    stripes, sh = plan

    with scope("stripe_bwd_halo"):
        if sharded_h or sharded_w:
            xp = halo_exchange_2d(x, HaloSpec.symmetric(mh if sharded_h else 0),
                                  HaloSpec.symmetric(mw), sp.axis_h, sp.axis_w,
                                  sp.grid_h, sp.grid_w, sp.tiles)
            if not sharded_h and mh:
                xp = torch.nn.functional.pad(xp, (0, 0, 0, 0, mh, mh))
        elif mh:
            xp = torch.nn.functional.pad(x, (0, 0, 0, 0, mh, mh))
        else:
            xp = x

    exact = _exact_stats() and ctx.train
    folded = active and sp.tiles.folded
    # Per-tile statistics of a tile-folded batch need the grid's per-tile
    # view; elsewhere each stripe's statistics are this device's.
    per_tile = folded and (not exact or not sp.bn_cross_tile)
    base = sp if sp is not None else SpatialCtx()
    inner_sp = dataclasses.replace(
        base,
        axis_h=base.axis_h if sharded_h else AXIS_SPH,
        grid_h=base.grid_h if sharded_h else max(stripes, 2),
        rep_h=base.rep_h if sharded_h else 1,
        bn_cross_tile=False, stat_local=not per_tile, d2_mode=False,
        use_pallas_conv=False,
    )
    inner_ctx = dataclasses.replace(ctx, spatial=inner_sp, bn_sink=None, remat_ops=False)

    def stripe(i):
        return xp[:, i * sh:i * sh + sh + 2 * mh]

    eff = list(layers)
    if exact:
        shards = ctx.bn_shards if ctx.bn_shards > 1 else (
            sp.tiles.tiles if folded and not sp.bn_cross_tile else 1)
        for j, layer in enumerate(layers):
            if not isinstance(layer, BatchNorm):
                continue
            if j == 0:
                s, ss = _sums(x, shards)
            else:
                mh_j, mw_j = _margins_at(eff, j, mh, mw)

                def stat_piece(xs, _j=j, _mh=mh_j, _mw=mw_j):
                    y, mho, mwo = apply_layers_premargin(eff[:_j], xs, inner_ctx, mh, mw)
                    assert (mho, mwo) == (_mh, _mw), ((mho, mwo), (_mh, _mw))
                    return _sums(y[:, _mh:_mh + sh, _mw:y.shape[2] - _mw], shards)

                s = ss = 0
                with scope("stripe_bwd_stats"):
                    for i in range(stripes):
                        a, b = (checkpoint(stat_piece, stripe(i), use_reentrant=False)
                                if torch.is_grad_enabled() else stat_piece(stripe(i)))
                        s, ss = s + a, ss + b
            cnt = float(n // shards * h * w)
            if active and sp.bn_cross_tile:
                with scope("stripe_bwd_stats"):
                    s, ss = sp.tiles.sum_stats(s, ss)
                cnt *= sp.tiles.count_factor
            mean = s / cnt
            var = torch.clamp(ss / cnt - mean * mean, min=0.0)
            eff[j] = _FixedStatsBN(layer, mean, var, cnt)

    sinks = []

    def piece(xs):
        inner = {} if ctx.bn_sink is not None else None
        y, mho, mwo = apply_layers_premargin(
            eff, xs, dataclasses.replace(inner_ctx, bn_sink=inner), mh, mw)
        assert mho == 0 and mwo == 0 and y.shape[1:3] == (sh, w), (mho, mwo, y.shape)
        if inner is not None and len(sinks) < stripes:  # not again in the recompute
            sinks.append(inner)
        return y

    grad = torch.is_grad_enabled()
    with scope("stripe_bwd_scan"):
        ys = [checkpoint(piece, stripe(i), use_reentrant=False) if grad
              else piece(stripe(i)) for i in range(stripes)]
    if ctx.bn_sink is not None:
        for bn in sinks[0]:
            mv = tuple(sum(sk[bn][k] for sk in sinks) / stripes for k in (0, 1))
            if active and not folded and not exact:
                # Per-stripe statistics vary over the tile ranks.
                with scope("stripe_bwd_stats"):
                    mv = tuple(sp.tiles.tile_mean(v) for v in mv)
            ctx.bn_sink[bn] = mv
    return torch.cat(ys, dim=1)
