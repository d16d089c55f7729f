"""Block flash attention: kernel K3 — the counterpart of
``mpi4dl_tpu/ops/pallas_attention.py``.

:func:`block_flash` returns the UNNORMALISED flash state of one attention
block, all fp32: ``o_hat = exp(s - m) @ v`` ``[BH, Tq, D]``, ``m =
rowmax(s)`` and ``l = rowsum(exp(s - m))`` ``[BH, Tq]``, with ``s = (q ·
scale) @ kᵀ``.  Under ``causal`` a key is visible where its GLOBAL position
``k_off + j`` is at most the query's ``q_off + i``; masked scores are
:data:`NEG_INF` (never ``-inf``), and a score counts only where it exceeds
``NEG_INF / 2``, so a fully masked row gives ``(0, NEG_INF, 0)`` — the
identity of :func:`mlo_merge`, which the ring relies on.

- **K3**, :func:`block_flash` on CUDA tensors — replaces
  ``pallas_attention.py::_kernel`` (:76, ``pallas_call`` :165): one CUDA
  kernel for ``sm_90a`` (``csrc/block_flash.cu``, built by ``ops/_build.py``,
  bound through ctypes), fp32 arithmetic on the CUDA cores, bf16 k/v
  converted exactly on load, ``q_off``/``k_off`` runtime arguments so one
  build serves every ring hop, any Tq/Tk and D ≤ 128.  On an H100 SXM the
  bound is the fp32 peak (67 TFLOP/s): at the long-context shapes the work
  is operations, not bytes; the source says more.
- :func:`block_flash_plain` is its plain PyTorch version (the counterpart
  of ``_reference_mlo`` :202-215).  The wrapper takes it only for CPU
  tensors; for a CUDA tensor it launches the kernel or raises.
  :data:`LAUNCHES` counts the kernel's launches.
- :func:`block_flash_t` is the trainable form.  Its backward is
  ``_block_flash_bwd`` (:243-311): one loop over Tk tiles split evenly,
  never building the ``[Tq, Tk]`` score matrix, in PyTorch ops (the JAX
  package's backward is not a Pallas kernel either).  It ignores the
  cotangent of ``m``, as the JAX backward does.
- :func:`mlo_merge` (:317-328) combines two states; :func:`flash_attention_local`
  (:331-347) is exact single-device attention through the block kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # large-negative, not -inf: exp() of it is exactly 0 and
                 # max() never makes nan from (-inf) - (-inf).
BWD_TILE = 512   # key tile of the backward: the tk that flash_attention_local
                 # and the ring pass (pallas_attention.py:343, ring.py:211)

# Launches of the kernel, counted by the wrapper where it launches and
# nowhere else (CPU tensors never launch).
LAUNCHES = {"block_flash": 0}

_KV_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_I = ctypes.c_int

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _causal_mask(t_q: int, t_k: int, q_off: int, k_off: int, device) -> torch.Tensor:
    """[Tq, Tk] True where key ``k_off + j`` is visible to query ``q_off + i``."""
    q_pos = q_off + torch.arange(t_q, device=device)
    k_pos = k_off + torch.arange(t_k, device=device)
    return q_pos[:, None] >= k_pos[None, :]


@torch.no_grad()
def block_flash_plain(q, k, v, q_off: int = 0, k_off: int = 0,
                      causal: bool = False, scale: float = 1.0) -> State:
    """Plain PyTorch version of K3: the whole ``[BH, Tq, Tk]`` score block
    in fp32 (updated in place to halve its peak memory at long T)."""
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    if causal:
        s.masked_fill_(~_causal_mask(q.shape[1], k.shape[1], q_off, k_off, s.device),
                       NEG_INF)
    m = s.amax(dim=-1)
    valid = s > NEG_INF * 0.5
    p = s.sub_(m[..., None]).exp_().masked_fill_(valid.logical_not_(), 0.0)
    return torch.matmul(p, v.float()), m, p.sum(dim=-1)


def _library():
    from mpi4dl_tpu_torch.ops import _build

    lib = _build.load("block_flash")
    if lib.block_flash_launch.argtypes is None:
        lib.block_flash_launch.argtypes = [_VP] * 6 + [_I] * 8 + [_VP]
        lib.block_flash_launch.restype = _I
        lib.block_flash_max_d.restype = _I
        lib.block_flash_error_string.argtypes = [_I]
        lib.block_flash_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, q_off, k_off, causal, scale) -> State:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if k.dtype not in _KV_CODE or v.dtype != k.dtype:
        raise TypeError(f"block_flash takes fp32 or bf16 k and v of one type, "
                        f"got {k.dtype} and {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or (
            q.shape[0], q.shape[2]) != (k.shape[0], k.shape[2]):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    bh, t_q, d = q.shape
    lib = _library()
    if d > lib.block_flash_max_d() or bh > 65535:
        raise ValueError(f"block_flash kernel takes D <= {lib.block_flash_max_d()} "
                         f"and BH <= 65535, got D={d}, BH={bh}")
    for off in (q_off, k_off):
        if not -2**31 <= off < 2**31:
            raise ValueError(f"offset {off} outside int32")
    qf = (q.float() * scale).contiguous()   # pallas_attention.py:155
    k, v = k.contiguous(), v.contiguous()
    o = torch.empty((bh, t_q, d), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.block_flash_launch(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), bh, t_q, k.shape[1], d,
            _KV_CODE[k.dtype], int(causal), int(q_off), int(k_off), stream,
        )
    if err != 0:
        raise RuntimeError("block_flash kernel launch failed: "
                           + lib.block_flash_error_string(err).decode())
    LAUNCHES["block_flash"] += 1
    return o, m, l


def block_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_off: int = 0, k_off: int = 0, causal: bool = False,
                scale: float = 1.0) -> State:
    """K3: the flash state ``(o_hat, m, l)`` of one block.  q ``[BH, Tq,
    D]`` (any float type; scaled in fp32), k and v ``[BH, Tk, D]`` fp32 or
    bf16, ``q_off``/``k_off`` the blocks' global positions.  CPU tensors
    take :func:`block_flash_plain`; CUDA tensors launch the kernel (or
    raise)."""
    q_off, k_off = int(q_off), int(k_off)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return block_flash_plain(q, k, v, q_off, k_off, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"block_flash: no kernel for device {q.device}")
    return _launch(q, k, v, q_off, k_off, causal, scale)


def _block_flash_bwd(q, k, v, m, do, dl, q_off, k_off, causal, scale,
                     tk: int = BWD_TILE):
    """Backward of one block (``pallas_attention.py:243-311``), a loop over
    Tk tiles split evenly.  With P = exp(s - m) and m held constant:
        dP = dô Vᵀ + dl 1ᵀ;  ds = P ⊙ dP
        dq = ds K · scale;  dk = dsᵀ (q · scale);  dv = Pᵀ dô
    """
    t_q, t_k = q.shape[1], k.shape[1]
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    do, dl = do.float(), dl.float()
    nk = max(1, -(-t_k // tk))
    tk_c = -(-t_k // nk)          # the even split of pallas_attention.py:262-267
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for j0 in range(0, t_k, tk_c):
        j1 = min(j0 + tk_c, t_k)
        kt, vt = kf[:, j0:j1], vf[:, j0:j1]
        s = torch.matmul(qf, kt.transpose(1, 2))
        if causal:
            s = s.masked_fill(~_causal_mask(t_q, j1 - j0, q_off, k_off + j0, s.device),
                              NEG_INF)
        p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m[..., None]), 0.0)
        ds = p * (torch.matmul(do, vt.transpose(1, 2)) + dl[..., None])
        dq += torch.matmul(ds, kt)
        dk[:, j0:j1] = torch.matmul(ds.transpose(1, 2), qf)
        dv[:, j0:j1] = torch.matmul(p.transpose(1, 2), do)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockFlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, causal, scale):
        o, m, l = block_flash(q, k, v, q_off, k_off, causal, scale)
        ctx.save_for_backward(q, k, v, m)
        ctx.args = (int(q_off), int(k_off), causal, scale)
        return o, m, l

    @staticmethod
    def backward(ctx, do, dm, dl):
        del dm  # zero almost everywhere; the JAX backward drops it too
        q, k, v, m = ctx.saved_tensors
        return (*_block_flash_bwd(q, k, v, m, do, dl, *ctx.args),
                None, None, None, None)


def block_flash_t(q, k, v, q_off: int = 0, k_off: int = 0,
                  causal: bool = False, scale: float = 1.0) -> State:
    """Trainable :func:`block_flash` (counterpart of the ``custom_vjp`` of
    ``pallas_attention.block_flash``): gradients for q, k and v."""
    return _BlockFlashFn.apply(q, k, v, q_off, k_off, causal, scale)


def mlo_merge(state_a: State, state_b: State) -> State:
    """Associative combine of two flash states ``(o, m, l)``."""
    o1, m1, l1 = state_a
    o2, m2, l2 = state_b
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return o1 * c1[..., None] + o2 * c2[..., None], m, l1 * c1 + l2 * c2


def fold_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, D]`` → ``[B·H, T, D]``."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d)


def flash_attention_local(q, k, v, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Exact single-device attention through the block kernel.  q, k, v
    ``[B, T, H, D]`` (the ring's layout); returns ``[B, T, H, D]`` in
    q's dtype, never building the ``[T, T]`` scores in the forward."""
    b, t, h, d = q.shape
    sc = scale if scale is not None else float(1.0 / (d ** 0.5))
    o, _, l = block_flash_t(fold_heads(q), fold_heads(k), fold_heads(v),
                            0, 0, causal, sc)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, t, d).transpose(1, 2).to(q.dtype)
