"""Halo-consuming convolution: kernels K1 and K2 — the counterpart of
``mpi4dl_tpu/ops/pallas_conv.py``.

The op is a stride-1 VALID conv that consumes a margin present in advance
(halo-exchanged under spatial parallelism, ``F.pad`` on one device):
``x [N, H+kh-1, W+kw-1, Cin]``, ``w [kh, kw, Cin, Cout]`` → ``[N, H, W, Cout]``,

    out[n, y, x, :] = Σ_{dy, dx} X[n, y+dy, x+dx, :] @ W[dy, dx]

- **K1**, :func:`halo_conv2d` — replaces ``pallas_conv.py::_kernel`` (:41,
  ``pallas_call`` :346).  fp32 or bf16 in, fp32 accumulation, cast to
  ``out_dtype``; ``fuse_relu`` applies ReLU to the input as it loads.
- **K2**, :func:`halo_conv2d` with ``stat_window=(h0, h1, w0, w1)`` —
  replaces ``pallas_conv.py::_kernel_stats`` (:106, ``pallas_call`` :364):
  K1 plus fp32 per-channel sum and sum of squares of the output AFTER its
  cast, over the static window in output coordinates.

Both are one CUDA source for ``sm_90a`` (``csrc/halo_conv.cu``, built by
``ops/_build.py``, bound through ctypes).  Bound on an H100 SXM at the main
path's shapes (1x7/7x1, m ∈ {52, 104, 208, 416}, bf16): 2.48 GFLOP a call,
2.5 µs at the 989 TFLOP/s bf16 peak; 4-14 MB a call, 1.3-4.1 µs at 3.35
TB/s.  bf16 inputs (the main path) take an implicit GEMM on the tensor
cores: ``mma.sync`` m16n8k16 with fp32 accumulation over 64-deep slices of
the flattened (dy, dx, Cin) depth, bf16 operands in a 3-stage ``cp.async``
ring, ReLU applied to the A fragments in registers.  The library picks
one of four tiles per launch (128x64, 128x128, 64x64 or 64x32 pixels x
channels, two blocks an SM) by the number of whole waves its grid takes
on the card's SMs.  Copies are 16 bytes where Cin, Cout and the pointers
are 16-byte aligned, 8 bytes where they are 8-byte aligned (m = 52:
104-byte rows), else one element; ragged depth, pixels and channels are
zero-filled in both operands.  K2's statistics are folded in a fixed order
into one partial per (pixel tile, channel), summed here; the library
reports the row count of each launch's scratch (:func:`stat_rows`) and
refuses a launch given another.  Two launches are bitwise equal.  fp32
inputs keep exact fp32 arithmetic on the CUDA cores (TF32 would break the
8-scaled-ULP contract).
Shared memory does not grow with the conv's channels or kernel size, so
every stride-1 conv fits (no counterpart of the TPU VMEM caps in
``pallas_conv_eligible``); the source says more.

Beside the kernel, :func:`halo_conv2d_plain` computes the same function in
plain PyTorch.  The wrapper takes it only for CPU tensors; for a CUDA tensor
it launches the kernel or raises.  :data:`LAUNCHES` counts the launches of
each kernel.

:func:`halo_conv2d_t` and :func:`fused_relu_conv_bn_t` are the trainable
forms (``torch.autograd.Function``), whose backward follows
``pallas_conv.py:426-448`` and ``:487-515``: dx is K1 on the padded
cotangent with the flipped, io-swapped kernel; dw is the library's
backprop-filter (``torch.nn.grad.conv2d_weight``), as the JAX package
leaves dw to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Launches of each kernel, counted by the wrapper where it launches and
# nowhere else (CPU tensors never launch).
LAUNCHES = {"halo_conv2d": 0, "halo_conv2d_stats": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Zero-pad H and W of an NHWC tensor symmetrically (contiguous out)."""
    if ph == 0 and pw == 0:
        return x.contiguous()
    return F.pad(x, (0, 0, pw, pw, ph, ph)).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def _check_window(stat_window, h: int, wd: int) -> Tuple[int, int, int, int]:
    h0, h1, w0, w1 = (int(v) for v in stat_window)
    if not (0 <= h0 <= h1 <= h and 0 <= w0 <= w1 <= wd):
        raise ValueError(f"stat_window {stat_window} outside the {h}x{wd} output")
    return h0, h1, w0, w1


def _window_stats(y: torch.Tensor, win) -> Tuple[torch.Tensor, torch.Tensor]:
    h0, h1, w0, w1 = win
    yw = y[:, h0:h1, w0:w1, :].float()
    return yw.sum(dim=(0, 1, 2)), (yw * yw).sum(dim=(0, 1, 2))


def halo_conv2d_plain(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                      fuse_relu: bool = False, stat_window=None):
    """Plain PyTorch version of K1/K2: the conv in fp32, then the cast and
    the windowed statistics of the cast output."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    if fuse_relu:
        xf = torch.relu(xf)
    y = F.conv2d(_nchw(xf), _oihw(w.float())).permute(0, 2, 3, 1)
    y = y.to(out_dtype).contiguous()
    if stat_window is None:
        return y
    win = _check_window(stat_window, y.shape[1], y.shape[2])
    return (y, *_window_stats(y, win))


_SMS = {}  # SM count by device index


def _sms(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def _library(defines: Tuple[str, ...] = ()):
    from mpi4dl_tpu_torch.ops import _build

    lib = _build.load("halo_conv", defines)
    if lib.halo_conv2d_launch.argtypes is None:
        lib.halo_conv2d_launch.argtypes = ([_VP] * 5 + [_I] * 14
                                           + [ctypes.c_longlong, _I, _VP])
        lib.halo_conv2d_launch.restype = _I
        lib.halo_conv2d_stat_rows.argtypes = [_I] * 8
        lib.halo_conv2d_stat_rows.restype = ctypes.c_longlong
        lib.halo_conv2d_error_string.argtypes = [_I]
        lib.halo_conv2d_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w, out_dtype):
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"halo_conv2d takes fp32 or bf16 x and w of one type, "
                        f"got {x.dtype} and {w.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"halo_conv2d writes fp32 or bf16, not {out_dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("halo_conv2d takes contiguous NHWC x and HWIO w")
    if x.shape[1] < w.shape[0] or x.shape[2] < w.shape[1]:
        raise ValueError(f"input {tuple(x.shape)} smaller than kernel "
                         f"{w.shape[0]}x{w.shape[1]}")


def stat_rows(x: torch.Tensor, w: torch.Tensor) -> int:
    """Rows of K2's partial-statistics scratch for a launch on CUDA ``x``
    and ``w``: one per pixel tile of the tile the library takes for it."""
    n, hp, wp, _ = x.shape
    kh, kw, _, cout = w.shape
    return _library().halo_conv2d_stat_rows(
        n, hp, wp, kh, kw, cout, int(x.dtype == torch.bfloat16), _sms(x.device))


def _launch(x, w, out_dtype, fuse_relu, stat_window):
    _check(x, w, out_dtype)
    n, hp, wp, cin = x.shape
    kh, kw, _, cout = w.shape
    h, wd = hp - kh + 1, wp - kw + 1
    lib = _library()
    y = torch.empty((n, h, wd, cout), dtype=out_dtype, device=x.device)
    win = (0, 0, 0, 0)
    rows, part = 0, None
    if stat_window is not None:
        win = _check_window(stat_window, h, wd)
        # One partial sum and sum of squares per (pixel tile of this launch,
        # channel), in one buffer so that one reduction folds both.
        rows = stat_rows(x, w)
        part = torch.empty((2, rows, cout), dtype=torch.float32, device=x.device)
    err = lib.halo_conv2d_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        part[0].data_ptr() if part is not None else None,
        part[1].data_ptr() if part is not None else None,
        n, hp, wp, cin, kh, kw, cout,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], int(fuse_relu),
        *win, rows, _sms(x.device), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "halo_conv2d kernel launch failed: "
            + lib.halo_conv2d_error_string(err).decode()
        )
    if part is None:
        LAUNCHES["halo_conv2d"] += 1
        return y
    LAUNCHES["halo_conv2d_stats"] += 1
    s, ss = part.sum(dim=1)
    return y, s, ss


def halo_conv2d(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None,
                fuse_relu: bool = False, stat_window=None):
    """K1 (``stat_window=None``) or K2.  Returns ``y``, or ``(y, sum,
    sumsq)`` with fp32 ``[Cout]`` statistics of the cast ``y`` over the
    window.  CPU tensors take :func:`halo_conv2d_plain`; CUDA tensors launch
    the kernel (or raise)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and w.device.type == "cpu":
        return halo_conv2d_plain(x, w, out_dtype, fuse_relu, stat_window)
    if x.device.type != "cuda":
        raise RuntimeError(f"halo_conv2d: no kernel for device {x.device}")
    if x.device.index == torch.cuda.current_device():
        return _launch(x, w, out_dtype, fuse_relu, stat_window)
    with torch.cuda.device(x.device):
        return _launch(x, w, out_dtype, fuse_relu, stat_window)


# ---------------------------------------------------------------------------
# Trainable forms.
#
#   dx[n,a,b,ci] = Σ ct[n,a-dy,b-dx,co] · w[dy,dx,ci,co]
#                = VALID conv of ct zero-padded by (kh-1, kw-1) with the
#                  spatially flipped, io-swapped kernel — K1 again.
# ---------------------------------------------------------------------------


def _flip_swap(w: torch.Tensor) -> torch.Tensor:
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _dx(ct: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    kh, kw = w.shape[0], w.shape[1]
    return halo_conv2d(pad_hw(ct, kh - 1, kw - 1),
                       _flip_swap(w).to(ct.dtype), out_dtype=out_dtype)


def _dw(x: torch.Tensor, ct: torch.Tensor, w_shape) -> torch.Tensor:
    kh, kw, cin, cout = w_shape
    dw = torch.nn.grad.conv2d_weight(
        _nchw(x), (cout, cin, kh, kw), _nchw(ct.to(x.dtype))
    )
    return dw.permute(2, 3, 1, 0)


class _HaloConv2dFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return halo_conv2d(x, w)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        return _dx(ct, w, x.dtype), _dw(x, ct, w.shape)


def halo_conv2d_t(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Trainable K1 (counterpart of ``pallas_conv.halo_conv2d_t``)."""
    return _HaloConv2dFn.apply(x, w)


class _FusedReluConvBnFn(torch.autograd.Function):
    """(y, s, ss) = (conv(relu(x), w), Σ_win cast(y), Σ_win cast(y)²).

    Backward, without recomputing the forward:
      dy = ct_y + 1_win·(ct_s + 2·y·ct_ss)    (fp32, then ct_y's dtype)
      dx = relu'(x) ⊙ K1(pad(dy), flip+swap(w))
      dw = conv2d_weight(relu(x), dy)
    """

    @staticmethod
    def forward(ctx, x, w, stat_window):
        y, s, ss = halo_conv2d(x, w, fuse_relu=True, stat_window=stat_window)
        ctx.save_for_backward(x, w, y)
        ctx.win = tuple(stat_window)
        return y, s, ss

    @staticmethod
    def backward(ctx, ct_y, ct_s, ct_ss):
        x, w, y = ctx.saved_tensors
        h0, h1, w0, w1 = ctx.win
        dy = ct_y.to(torch.float32, copy=True)
        dy[:, h0:h1, w0:w1, :] += ct_s + 2.0 * y[:, h0:h1, w0:w1, :].float() * ct_ss
        dy = dy.to(ct_y.dtype)
        dx = torch.where(x > 0, _dx(dy, w, x.dtype), 0.0)
        return dx, _dw(torch.relu(x), dy, w.shape), None


def fused_relu_conv_bn_t(x: torch.Tensor, w: torch.Tensor, stat_window):
    """Trainable K2 (counterpart of ``pallas_conv.fused_relu_conv_bn_t``):
    returns ``(y, sum, sumsq)`` with y = conv(relu(x), w), VALID and
    margin-consuming, and fp32 statistics of the cast y over
    ``stat_window`` = (h0, h1, w0, w1) in output coordinates."""
    return _FusedReluConvBnFn.apply(x, w, tuple(stat_window))
