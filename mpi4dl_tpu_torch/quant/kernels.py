"""Per-block quantize / dequantize (counterpart of
``mpi4dl_tpu/quant/kernels.py``, which is plain ``jnp``: these are PyTorch
ops, run on whatever device the tensor is on).

The unit every quantized collective moves is ``(payload, scales)``:

- blocks of ``block`` consecutive elements along the LAST axis share one
  f32 scale (``absmax / qmax``, computed as the jitted JAX code computes
  it; 1 for an all-zero block), so a collective
  that gathers, splits or permutes over any other axis treats payload and
  scales alike.  In the port's NHWC activations the last axis is C; the
  handoffs and the gradient reductions quantize a flat 1-D buffer;
- ``int8``: symmetric round-half-to-even into [-127, 127], 1 byte an
  element;
- ``fp8``: ``torch.float8_e4m3fn`` of the same per-block pre-scaled values
  (qmax 448), 1 byte an element;
- ``int4``: symmetric into [-7, 7], two nibbles packed in one int8 byte
  along the last axis (one pad nibble when the extent is odd).

No other padding crosses the wire: a ragged last block takes the absmax
of its partial extent.  A NaN or Inf element poisons its whole block: the
scale goes non-finite and the block decodes to NaN, so the anomaly guard
still sees it.  Error bound: half a quantization step of the element's
block (``absmax / (2 qmax)``) on the int grids; for fp8, half an ulp of
the element (``|x| 2^-4``), at most ``absmax 2^-4``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MODES: Tuple[str, ...] = ("int8", "fp8", "int4")

_QMAX = {"int8": 127.0, "fp8": 448.0, "int4": 7.0}
_RECIP = {m: float(torch.tensor(1.0 / q, dtype=torch.float32)) for m, q in _QMAX.items()}


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}; have {MODES}")


def quant_error_bound(mode: str) -> float:
    """Worst-case absolute error of an element as a fraction of its block's
    absmax."""
    _check_mode(mode)
    if mode == "fp8":
        return 2.0 ** -4
    return 0.5 / _QMAX[mode]


def nblocks(n: int, block: int) -> int:
    return -(-n // block)


def payload_dim(c: int, mode: str) -> int:
    """Last-axis extent of the payload of a tensor whose last dim is ``c``."""
    return (c + 1) // 2 if mode == "int4" else c


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` (f32) as ``[..., nblocks, block]``, its last dim zero-padded to
    whole blocks."""
    c = x.shape[-1]
    pad = nblocks(c, block) * block - c
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, block)


def block_scales(x: torch.Tensor, mode: str, block: int) -> torch.Tensor:
    """f32 per-block scales, shape ``x.shape[:-1] + (ceil(C / block),)``."""
    _check_mode(mode)
    amax = _blocked(x.to(torch.float32).abs(), block).amax(dim=-1)
    # `amax == 0` (not `> 0`): a NaN/Inf absmax keeps its non-finite scale.
    # JAX writes `amax / qmax`; under jit, where its engines run, XLA
    # computes that as `amax * f32(1 / qmax)`, and so does the port.
    return torch.where(amax == 0, torch.ones_like(amax), amax * _RECIP[mode])


def _scaled(x32: torch.Tensor, scales: torch.Tensor, block: int, c: int, op) -> torch.Tensor:
    """``op(x32, scale of its block)`` elementwise, back at last dim ``c``."""
    y = op(_blocked(x32, block), scales.unsqueeze(-1))
    return y.reshape(*y.shape[:-2], -1)[..., :c]


def quantize(x: torch.Tensor, mode: str, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x -> (payload, scales)``.  Payload: int8 (int8, int4 packed) or
    float8_e4m3fn (fp8); scales f32."""
    _check_mode(mode)
    c = x.shape[-1]
    scales = block_scales(x, mode, block)
    xf = _scaled(x.to(torch.float32), scales, block, c, torch.div)
    if mode == "fp8":
        return xf.to(torch.float8_e4m3fn), scales
    qmax = _QMAX[mode]
    # A poisoned block's NaNs cast to 0, as XLA's float-to-int conversion
    # does; the block still decodes to NaN through its scale.
    q = torch.round(xf).nan_to_num_(0.0).clamp_(-qmax, qmax).to(torch.int8)
    if mode == "int4":
        if c % 2:
            q = F.pad(q, (0, 1))
        lo, hi = q[..., 0::2], q[..., 1::2]
        q = (lo & 0x0F) | (hi << 4)
    return q, scales


def dequantize(payload: torch.Tensor, scales: torch.Tensor, mode: str, block: int,
               out_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`quantize`; ``out_dim`` is the original last-axis
    extent (int4's pad nibble and the scales' tail are cut to it)."""
    _check_mode(mode)
    if mode == "int4":
        lo = (payload << 4) >> 4  # int8 shifts: << wraps, >> sign-extends
        hi = payload >> 4
        q = torch.stack([lo, hi], dim=-1).reshape(
            *payload.shape[:-1], 2 * payload.shape[-1])[..., :out_dim]
    else:
        q = payload
    return _scaled(q.to(torch.float32), scales, block, out_dim, torch.mul).to(dtype)


def roundtrip(x: torch.Tensor, mode: str, block: int) -> torch.Tensor:
    """``dequantize(quantize(x))`` in ``x``'s dtype: what a rank receives
    when ``x`` crosses a quantized wire."""
    q, s = quantize(x, mode, block)
    return dequantize(q, s, mode, block, x.shape[-1], x.dtype)
