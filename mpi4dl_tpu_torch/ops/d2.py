"""D2 fused halo exchange: one accumulated exchange per layer run
(counterpart of ``mpi4dl_tpu/ops/d2.py``).

The reference's "Design-2" replaces per-conv halo exchange with one larger
exchange per run of layers, the convs then running halo-free and
shrinking the tile.  It is an apply-time mode (``SpatialCtx.d2_mode``) of
the same models:

- :func:`accumulated_halo` is the input-space margin ``H = Σ_i p_i ·
  Π_{j<i} s_j`` of a run (its receptive-field overlap).
- :func:`run_layers_d2` exchanges that margin ONCE, then
  :func:`apply_layers_premargin` applies each layer with
  ``halo_pre_exchanged`` set and the layer's current margin in
  ``pre_margin_h/w``: convs and pools run VALID on the sharded dims and
  consume ``p_i`` each (``m_{i+1} = (m_i − p_i) / s_i``).
- ``d2_max_fused`` caps the margin-consuming layers per exchange
  (``--fused-layers``, :func:`_chunk_runs`).

The global image is zero-padded ONCE by H instead of at every conv, so the
border numerics of convs and pools differ from the per-conv D1 path
(:func:`run_layers_d2` warns about padded pools).  BatchNorm inside a run
is exact: it leaves the margin not yet consumed out of its statistics.

[ReLU, Conv2d, BatchNorm] windows of a premargin run take the fused K2
kernel (``ops/halo_conv.fused_relu_conv_bn_t``) when ``use_pallas_conv``
is on, with a statistics window that leaves the remaining margin out —
on a sharded tile as on one device, where a run is the degenerate
premargin run (margins 0, SAME = pad + VALID, :func:`maybe_run_fused_unsharded`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import torch

from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.layers import (
    BatchNorm, Conv2d, Identity, Pool2d, ReLU, Softmax, per_tile_view,
)
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_2d
from mpi4dl_tpu_torch.ops.halo_conv import fused_relu_conv_bn_t, pad_hw


def layer_d2_geometry(layer) -> Optional[Tuple[int, int, int, int]]:
    """(ph, pw, sh, sw) of a layer inside a premargin run, or None when it
    cannot take part (dense / flatten / head layers)."""
    if isinstance(layer, (Conv2d, Pool2d)):
        _, _, sh, sw, ph, pw = layer._geometry()
        return (ph, pw, sh, sw)
    if isinstance(layer, (BatchNorm, ReLU, Identity, Softmax)):
        return (0, 0, 1, 1)
    return None


def accumulated_halo(layers: Sequence) -> Optional[Tuple[int, int]]:
    """Input-space halo (H_h, H_w) of a run, ``H = Σ p_i · Π_{j<i} s_j``,
    or None if any layer is unsupported."""
    hh = hw = 0
    fh = fw = 1
    for layer in layers:
        g = layer_d2_geometry(layer)
        if g is None:
            return None
        ph, pw, sh, sw = g
        hh += ph * fh
        hw += pw * fw
        fh *= sh
        fw *= sw
    return hh, hw


def can_fuse(layers: Sequence, sp) -> bool:
    """A run is fusable when every layer is supported and there is a halo
    to fuse on at least one sharded dim."""
    acc = accumulated_halo(layers)
    if acc is None:
        return False
    hh, hw = acc
    return (sp.sharded_h and hh > 0) or (sp.sharded_w and hw > 0)


def _fusable_triple(layers: Sequence, i: int, train: bool,
                    x_shape=None) -> bool:
    """[ReLU, Conv2d, BatchNorm] starting at i, eligible for K2: train mode,
    stride-1 non-1x1 ungrouped unbiased conv feeding a BN of its width.
    There is no capacity test (the kernel's shared-memory footprint is
    fixed).  The JAX gate's tiny-channel huge-spatial exclusion
    (``d2.py:105-107``) is kept, so both packages fuse the same windows."""
    if i + 2 >= len(layers) or not train:
        return False
    if (x_shape is not None and len(x_shape) == 4
            and x_shape[-1] <= 64 and x_shape[1] * x_shape[2] >= (1 << 20)):
        return False
    r, cv, bn = layers[i], layers[i + 1], layers[i + 2]
    if not (type(r) is ReLU and type(cv) is Conv2d and type(bn) is BatchNorm):
        return False
    kh, kw, sh, sw, _, _ = cv._geometry()
    if (sh, sw) != (1, 1) or (kh, kw) == (1, 1) or cv.feature_group_count != 1:
        return False
    return cv.bias is None and bn.num_features == cv.out_channels


def _apply_fused_triple(cv: Conv2d, bn: BatchNorm, x, ctx: ApplyCtx, sub,
                        mh: int, mw: int):
    """relu → conv → bn through K2 (``d2.py:125-165``).  The conv consumes
    (ph, pw) of margin on the sharded dims and pads the others (SAME
    there); K2's statistics window ``(mh2, h_out − mh2, mw2, w_out − mw2)``
    leaves out the margin that remains, and its sums are summed over the
    tiles (or kept per tile) as the unfused BatchNorm does.  Returns
    ``(y, mh2, mw2)``."""
    kh, kw, _, _, ph, pw = cv._geometry()
    w = cv.kernel.to(x.dtype)
    sh_, sw_ = sub.sharded_h, sub.sharded_w
    x = pad_hw(x, 0 if sh_ else ph, 0 if sw_ else pw)
    h_out = x.shape[1] - (kh - 1)
    w_out = x.shape[2] - (kw - 1)
    mh2 = (mh - ph) if sh_ else mh
    mw2 = (mw - pw) if sw_ else mw
    win = (mh2, h_out - mh2, mw2, w_out - mw2)
    per_tile = per_tile_view(x, sub)
    if per_tile is not None:
        # Per-tile statistics of a tile-folded batch: one launch per tile.
        outs = [fused_relu_conv_bn_t(t, w, win) for t in per_tile]
        y = torch.cat([o[0] for o in outs])
        s = torch.stack([o[1] for o in outs])
        ss = torch.stack([o[2] for o in outs])
        cnt = float(per_tile.shape[1] * (win[1] - win[0]) * (win[3] - win[2]))
    else:
        y, s, ss = fused_relu_conv_bn_t(x, w, win)
        cnt = float(y.shape[0] * (win[1] - win[0]) * (win[3] - win[2]))
        if sub.active and sub.bn_cross_tile:
            with scope("bn_cross_tile"):
                s, ss = sub.tiles.sum_stats(s, ss)
            cnt *= sub.tiles.count_factor
    mean = s / cnt
    var = (ss / cnt - mean * mean).clamp(min=0.0)
    y = bn.normalize_with_stats(y, mean, var, cnt, ctx.with_spatial(sub))
    return y, mh2, mw2


def apply_layers_premargin(layers: Sequence, x, ctx: ApplyCtx, mh: int = 0,
                           mw: int = 0):
    """Apply ``layers`` to an activation that already carries margin (mh,
    mw) on the sharded dims, consuming it layer by layer; returns ``(y,
    mh_out, mw_out)``.  With ``use_pallas_conv`` on, [ReLU, Conv2d,
    BatchNorm] windows take K2.  Each stride must divide both the remaining
    margin and the true local extent, else the tile would de-phase from the
    global conv grid: that raises (``d2.py:225-245``)."""
    sp = ctx.spatial
    sharded_h, sharded_w = sp.sharded_h, sp.sharded_w
    idx = 0
    while idx < len(layers):
        if sp.use_pallas_conv and _fusable_triple(layers, idx, ctx.train, x.shape):
            cv, bn = layers[idx + 1], layers[idx + 2]
            ph, pw, *_ = layer_d2_geometry(cv)
            # Stride 1 by the gate: the misalignment checks below hold.
            sub = dataclasses.replace(
                sp, halo_pre_exchanged=True,
                pre_margin_h=(mh - ph) if sharded_h else mh,
                pre_margin_w=(mw - pw) if sharded_w else mw,
            )
            x, mh, mw = _apply_fused_triple(cv, bn, x, ctx, sub, mh, mw)
            idx += 3
            continue
        layer = layers[idx]
        ph, pw, sh, sw = layer_d2_geometry(layer)
        sub = dataclasses.replace(
            sp, halo_pre_exchanged=True, pre_margin_h=mh, pre_margin_w=mw
        )
        if sharded_h and ((mh - ph) % sh or (x.shape[1] - 2 * mh) % sh):
            raise ValueError(
                f"D2 stride misalignment on H: margin {mh}, pad {ph}, "
                f"stride {sh}, local extent {x.shape[1] - 2 * mh} — the "
                "tile would de-phase from the global conv grid; adjust "
                "tile grid / image size / fused run boundaries."
            )
        if sharded_w and ((mw - pw) % sw or (x.shape[2] - 2 * mw) % sw):
            raise ValueError(
                f"D2 stride misalignment on W: margin {mw}, pad {pw}, "
                f"stride {sw}, local extent {x.shape[2] - 2 * mw}."
            )
        x = layer(x, ctx.with_spatial(sub))
        if sharded_h:
            mh = (mh - ph) // sh
        if sharded_w:
            mw = (mw - pw) // sw
        idx += 1
    return x, mh, mw


def premargin_out(layers: Sequence, ctx: ApplyCtx, mh: int, mw: int):
    """The (mh_out, mw_out) that :func:`apply_layers_premargin` returns —
    margin arithmetic only, no compute."""
    sp = ctx.spatial
    for layer in layers:
        ph, pw, sh, sw = layer_d2_geometry(layer)
        if sp.sharded_h:
            mh = (mh - ph) // sh
        if sp.sharded_w:
            mw = (mw - pw) // sw
    return mh, mw


def run_layers_d2(layers: Sequence, x, ctx: ApplyCtx):
    """One fused run: one accumulated halo exchange, then every layer in
    premargin (margin-consuming) mode."""
    sp = ctx.spatial
    assert sp is not None and sp.active
    for layer in layers:
        if isinstance(layer, Pool2d):
            ph, pw, *_ = layer_d2_geometry(layer)
            if (ph and sp.sharded_h) or (pw and sp.sharded_w):
                warnings.warn(
                    "halo-D2 fused run contains a padded pooling layer: "
                    "image-border pooling windows see pad-once zeros instead "
                    "of the D1 path's exact mask/-inf semantics (numerics "
                    "differ at tile borders from a non-D2 run; see ops/d2.py)",
                    stacklevel=2,
                )
                break
    hh, hw = accumulated_halo(layers)
    mh = hh if sp.sharded_h else 0
    mw = hw if sp.sharded_w else 0
    with scope(f"halo_d2_fused_h{mh}w{mw}"):
        x = halo_exchange_2d(x, HaloSpec.symmetric(mh), HaloSpec.symmetric(mw),
                             sp.axis_h, sp.axis_w, sp.grid_h, sp.grid_w, sp.tiles)
    with scope("d2_run"):
        y, mh_out, mw_out = apply_layers_premargin(layers, x, ctx, mh, mw)
    assert mh_out == 0 and mw_out == 0, (mh_out, mw_out)
    return y


def _chunk_runs(layers: Sequence, max_fused: Optional[int]) -> List[Tuple[int, int]]:
    """Split [0, len) into runs of at most ``max_fused`` margin-consuming
    (padded) layers each; None = one run."""
    n = len(layers)
    if max_fused is None or max_fused <= 0:
        return [(0, n)]
    runs, start, used = [], 0, 0
    for i, layer in enumerate(layers):
        ph, pw, *_ = layer_d2_geometry(layer)
        consumes = (ph > 0) or (pw > 0)
        if consumes and used >= max_fused:
            runs.append((start, i))
            start, used = i, 0
        used += 1 if consumes else 0
    runs.append((start, n))
    return [r for r in runs if r[0] < r[1]]


def maybe_run_d2(layers: Sequence, x, ctx: ApplyCtx):
    """The layers as fused D2 runs when D2 mode is on and the run
    qualifies; else None, and the caller takes its per-layer path."""
    sp = ctx.spatial
    if not (sp is not None and sp.active and sp.d2_mode
            and not sp.halo_pre_exchanged and can_fuse(layers, sp)):
        return None
    for r0, r1 in _chunk_runs(layers, sp.d2_max_fused):
        sub_layers = layers[r0:r1]
        if can_fuse(sub_layers, sp):
            x = run_layers_d2(sub_layers, x, ctx)
        else:
            for layer in sub_layers:
                x = layer(x, ctx)
    return x


def maybe_run_fused_unsharded(layers: Sequence, x, ctx: ApplyCtx):
    """Fused dispatch for a plain layer cell on one device; None (no
    change) unless the knob is on, every layer is premargin-capable and at
    least one window is fusable."""
    sp = ctx.spatial
    if (sp is None or not sp.use_pallas_conv or sp.active
            or sp.axis_h is not None or sp.axis_w is not None):
        return None
    if any(layer_d2_geometry(l) is None for l in layers):
        return None
    if not any(_fusable_triple(layers, i, ctx.train, x.shape)
               for i in range(len(layers))):
        return None
    return apply_layers_premargin(layers, x, ctx)[0]
