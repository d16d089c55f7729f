"""The strided convolution whose input gradient is built phase by phase
(counterpart of ``mpi4dl_tpu/ops/conv_phase.py``).

The input gradient of a stride-``s`` conv is usually a conv of the
cotangent dilated with ``s - 1`` zeros between its rows.  Writing padded
input row ``b = s·q + φ`` (phase ``φ`` in ``[0, s)``), phase ``φ`` of the
gradient is instead the stride-1 correlation of the undilated cotangent
with the ``φ``-subsampled, flipped, io-swapped kernel:

    dx_pad[s·q + φ] = Σ_m w[s·m + φ] · ct[q − m]

so ``s_h·s_w`` stride-1 VALID convs build it, interleaved by one reshape;
no zero-stuffed tensor exists.  The same FLOPs, another summation order,
the same function.  The weight gradient is the library's.  The JAX package
dispatches it from ``Conv2d`` for strided ungrouped convs, for XLA's TPU
lowering of the dilated dx (``layers.py:282-290``); no layer of this port
does: on an H100 its backward is slower than the library's
(``chip_smoke.py``'s memory-lever phase, PERF.md §6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _conv_nhwc(x, w, strides=(1, 1), padding=((0, 0), (0, 0))):
    """NHWC/HWIO conv with explicit (lo, hi) padding; a 1x1 unpadded conv
    is a channel matmul of the strided pixels (the layer's own route)."""
    (phl, phh), (pwl, pwh) = padding
    sh, sw = strides
    if w.shape[:2] == (1, 1) and not (phl or phh or pwl or pwh):
        return x[:, ::sh, ::sw, :] @ w[0, 0]
    if phl != phh or pwl != pwh:
        x = F.pad(x, (0, 0, pwl, pwh, phl, phh))
        phl = pwl = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(),
                 stride=(sh, sw), padding=(phl, pwl))
    return y.permute(0, 2, 3, 1)


def phase_dx(ct, w, strides, padding, x_shape):
    """dx of ``y = conv(x, w, strides, padding)`` for the cotangent ``ct``
    [N, OH, OW, Cout], by phases (``conv_phase.py:54-99``)."""
    n = ct.shape[0]
    kh, kw, cin, _ = w.shape
    sh, sw = strides
    (phl, phh), (pwl, pwh) = padding
    h, wid = x_shape[1], x_shape[2]
    hp, wp = h + phl + phh, wid + pwl + pwh
    hr, wr = _ceil_div(hp, sh), _ceil_div(wp, sw)
    wf = w.to(ct.dtype)
    rows = []
    for fh in range(sh):
        cols = []
        lh = len(range(fh, kh, sh))
        hq = _ceil_div(hp - fh, sh) if hp > fh else 0
        for fw in range(sw):
            lw = len(range(fw, kw, sw))
            wq = _ceil_div(wp - fw, sw) if wp > fw else 0
            if lh == 0 or lw == 0 or hq <= 0 or wq <= 0:
                cols.append(ct.new_zeros((n, hr, wr, cin)))
                continue
            wt = torch.flip(wf[fh::sh, fw::sw], dims=(0, 1)).transpose(2, 3)
            d = _conv_nhwc(ct, wt, padding=((lh - 1, lh - 1), (lw - 1, lw - 1)))
            # The phase's valid rows, then zeros up to the uniform grid:
            # trailing input rows that no window reads get no gradient.
            d = d[:, :min(hq, d.shape[1]), :min(wq, d.shape[2]), :]
            cols.append(F.pad(d, (0, 0, 0, wr - d.shape[2], 0, hr - d.shape[1])))
        rows.append(torch.stack(cols, dim=3))            # [n, hr, wr, sw, cin]
    dxp = torch.stack(rows, dim=2).reshape(n, hr * sh, wr * sw, cin)
    return dxp[:, phl:phl + h, pwl:pwl + wid, :]


def _dw(x, ct, w_shape, strides, padding):
    """The weight gradient, the library's backprop-filter (a matmul for an
    unpadded 1x1 kernel)."""
    kh, kw, cin, cout = w_shape
    (phl, phh), (pwl, pwh) = padding
    sh, sw = strides
    if (kh, kw) == (1, 1) and not (phl or phh or pwl or pwh):
        xs = x[:, ::sh, ::sw, :][:, :ct.shape[1], :ct.shape[2], :]
        return (xs.reshape(-1, cin).transpose(0, 1) @ ct.reshape(-1, cout)).reshape(w_shape)
    if phl != phh or pwl != pwh:
        x = F.pad(x, (0, 0, pwl, pwh, phl, phh))
        phl = pwl = 0
    dw = torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2).contiguous(), (cout, cin, kh, kw),
        ct.permute(0, 3, 1, 2).contiguous(), stride=(sh, sw), padding=(phl, pwl))
    return dw.permute(2, 3, 1, 0)


class _ConvPhase(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, strides, padding):
        ctx.save_for_backward(x, w)
        ctx.strides, ctx.padding = strides, padding
        return _conv_nhwc(x, w, strides, padding)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = phase_dx(ct, w, ctx.strides, ctx.padding, x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, ct.to(x.dtype), w.shape, ctx.strides, ctx.padding).to(w.dtype)
        return dx, dw, None, None


def conv2d_strided_t(x, w, strides, padding):
    """NHWC/HWIO conv (groups 1), ``strides`` (sh, sw), ``padding`` ((lo,
    hi), (lo, hi)), whose input gradient is :func:`phase_dx`
    (``conv2d_strided_t``, ``conv_phase.py:102-137``)."""
    return _ConvPhase.apply(x, w, tuple(strides), tuple(tuple(p) for p in padding))
