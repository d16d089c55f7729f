"""The single-device subset of the D2 premargin machinery (counterpart of
``mpi4dl_tpu/ops/d2.py``).

On one device a run of layers is the degenerate premargin run: no margins,
SAME padding = explicit pad + margin-consuming VALID conv.  Its
[ReLU, Conv2d, BatchNorm] windows therefore take the fused K2 kernel
(``ops/halo_conv.fused_relu_conv_bn_t``) exactly where the JAX package
takes its Pallas kernel, gated on the axis-free ``use_pallas_conv`` knob
that ``make_train_step(pallas_conv=True)`` sets.  The sharded D2 engine
(one accumulated halo exchange per run) is later work (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.layers import BatchNorm, Conv2d, Identity, Pool2d, ReLU
from mpi4dl_tpu_torch.ops.halo_conv import fused_relu_conv_bn_t, pad_hw


def layer_d2_geometry(layer) -> Optional[Tuple[int, int, int, int]]:
    """(ph, pw, sh, sw) of a layer inside a premargin run, or None when it
    cannot take part (dense / flatten / head layers)."""
    if isinstance(layer, (Conv2d, Pool2d)):
        _, _, sh, sw, ph, pw = layer._geometry()
        return (ph, pw, sh, sw)
    if isinstance(layer, (BatchNorm, ReLU, Identity)):
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


def _apply_fused_triple(cv: Conv2d, bn: BatchNorm, x, ctx: ApplyCtx):
    """relu → conv → bn through K2: pad, conv with the statistics of the
    whole output (no margin left on one device), normalise with them."""
    kh, kw, _, _, ph, pw = cv._geometry()
    x = pad_hw(x, ph, pw)
    h_out = x.shape[1] - (kh - 1)
    w_out = x.shape[2] - (kw - 1)
    y, s, ss = fused_relu_conv_bn_t(x, cv.kernel.to(x.dtype), (0, h_out, 0, w_out))
    cnt = float(y.shape[0] * h_out * w_out)
    mean = s / cnt
    var = (ss / cnt - mean * mean).clamp(min=0.0)
    return bn.normalize_with_stats(y, mean, var, cnt, ctx)


def apply_layers_premargin(layers: Sequence, x, ctx: ApplyCtx):
    """Apply ``layers`` as a premargin run on one device (margins are 0):
    fusable windows take K2, every other layer its own forward."""
    sp = ctx.spatial
    sub = ctx.with_spatial(dataclasses.replace(sp, halo_pre_exchanged=True))
    idx = 0
    while idx < len(layers):
        if sp.use_pallas_conv and _fusable_triple(layers, idx, ctx.train, x.shape):
            x = _apply_fused_triple(layers[idx + 1], layers[idx + 2], x, sub)
            idx += 3
            continue
        x = layers[idx](x, sub)
        idx += 1
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
    return apply_layers_premargin(layers, x, ctx)


def maybe_run_d2(layers: Sequence, x, ctx: ApplyCtx):
    """The sharded D2 run; None when nothing is sharded (always, in this
    slice — a sharded context raises)."""
    sp = ctx.spatial
    if sp is not None and sp.active:
        raise NotImplementedError("D2 fused halo runs: ROADMAP A6")
    return None
