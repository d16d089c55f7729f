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
  ``pallas_attention.py::_kernel`` (:76, ``pallas_call`` :165): CUDA
  kernels for ``sm_90a`` (``csrc/block_flash.cu``, built by
  ``ops/_build.py``, bound through ctypes), ``q_off``/``k_off`` runtime
  arguments so one build serves every ring hop, any Tq/Tk and D ≤ 128.
  The type chooses the kernel (never a failure): bf16 q, k and v (the
  long-context slice) take the tensor-core kernel (``mma.sync``, q
  unscaled, ``scale`` applied to the fp32 scores, P split into bf16 hi and
  lo parts for P·V; within 1e-5·max(1, max|ref|) of the plain version on m
  and o/l, rtol 1e-5 on l); anything else takes the fp32 CUDA-core kernel
  with q scaled in fp32 and the same bound.  The source says more.
- :func:`block_flash_plain` is its plain PyTorch version (the counterpart
  of ``_reference_mlo`` :202-215).  The wrapper takes it only for CPU
  tensors; for a CUDA tensor it launches the kernel or raises.
  :data:`LAUNCHES` counts the kernels' launches.
- :func:`block_flash_t` is the trainable form; it ignores the cotangent of
  ``m``, as the JAX backward does (:243-311).  Its backward,
  :func:`block_flash_bwd`, launches K3's backward kernel for bf16 q, k and
  v on the card (deterministic, two passes; P, dS and dô split into bf16
  hi/lo parts; within rtol 1e-4 / atol 1e-5·max|ref| of the plain
  version, the JAX gradient test's tolerance).  Its plain version
  :func:`block_flash_bwd_plain` is the JAX backward in PyTorch ops: one
  loop over Tk tiles split evenly, never building the ``[Tq, Tk]`` score
  matrix.  It serves CPU tensors and, by choice, fp32 on the card: the JAX
  package's backward is not a Pallas kernel either, and fp32 is not the
  slice's path.
- Inside :func:`fake_launches`, fake tensors (``FakeTensorMode``) given to
  :func:`block_flash` or :func:`block_flash_bwd` allocate what a launch
  allocates and launch nothing (the memory probe's dry run of the card
  path, ``benchmarks/mem_probe.py``).
- :func:`mlo_merge` (:317-328) combines two states; :func:`flash_attention_local`
  (:331-347) is exact single-device attention through the block kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from mpi4dl_tpu_torch.obs import scopes

NEG_INF = -1e30  # large-negative, not -inf: exp() of it is exactly 0 and
                 # max() never makes nan from (-inf) - (-inf).
BWD_TILE = 512   # key tile of the backward: the tk that flash_attention_local
                 # and the ring pass (pallas_attention.py:343, ring.py:211)

# Launches of the kernels, counted by the wrappers where they launch and
# nowhere else (CPU tensors never launch).  One backward call counts once
# (it splits dô and runs the dK/dV and dQ passes).
LAUNCHES = {"block_flash": 0, "block_flash_bwd": 0}
# The launches again with their work, added beside each count
# (obs/costs.py reads it: a ctypes launch dispatches no aten op, so
# FlopCounterMode cannot see it); never reset, so that a reset of LAUNCHES
# loses no counted work.  FLOPs as the plain versions' matmuls count them,
# the whole Tq x Tk block even where a causal mask hides part of it.
TALLY = {k: {"launches": 0, "flops": 0, "bytes": 0} for k in LAUNCHES}

_KV_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TC = 2   # the launcher's code for bf16 q, k and v (tensor cores)
_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flops(bh: int, t_q: int, t_k: int, d: int, backward: bool = False) -> int:
    """FLOPs of one call as ``FlopCounterMode`` counts its plain version:
    2 matmuls of 2·BH·Tq·Tk·D forward (scores, P·V), 5 backward (scores,
    dP, dV, dK, dQ)."""
    return (10 if backward else 4) * bh * t_q * t_k * d


def nbytes(bh: int, t_q: int, t_k: int, d: int, q_itemsize: int, kv_itemsize: int,
           backward: bool = False) -> int:
    """Bytes one launch moves, each input read once and each output written
    once.  Forward: q, k, v in; fp32 o_hat, m, l out.  Backward: q, k, v,
    fp32 dô, m, dl in; fp32 dq, dk, dv out."""
    qkv = bh * t_q * d * q_itemsize + 2 * bh * t_k * d * kv_itemsize
    if backward:
        return qkv + bh * t_q * (d + 2) * 4 + (bh * t_q * d + 2 * bh * t_k * d) * 4
    return qkv + bh * t_q * (d + 2) * 4


def _tally(name: str, q, k, backward: bool = False) -> None:
    bh, t_q, d = q.shape
    LAUNCHES[name] += 1
    TALLY[name]["launches"] += 1
    TALLY[name]["flops"] += flops(bh, t_q, k.shape[1], d, backward)
    scopes.charge(flops(bh, t_q, k.shape[1], d, backward))
    TALLY[name]["bytes"] += nbytes(bh, t_q, k.shape[1], d, q.element_size(),
                                   k.element_size(), backward)


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
        lib.block_flash_launch.argtypes = [_VP] * 6 + [_I] * 8 + [_F, _VP]
        lib.block_flash_launch.restype = _I
        lib.block_flash_bwd_launch.argtypes = [_VP] * 11 + [_I] * 7 + [_F, _VP]
        lib.block_flash_bwd_launch.restype = _I
        lib.block_flash_max_d.restype = _I
        lib.block_flash_error_string.argtypes = [_I]
        lib.block_flash_error_string.restype = ctypes.c_char_p
    return lib


def _all_bf16(*xs) -> bool:
    return all(x.dtype == torch.bfloat16 for x in xs)


def _check(q, k, v, lib) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or (
            q.shape[0], q.shape[2]) != (k.shape[0], k.shape[2]):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.shape[2] > lib.block_flash_max_d():
        raise ValueError(f"block_flash kernel takes D <= {lib.block_flash_max_d()}, "
                         f"got D={q.shape[2]}")


def _offsets(q_off, k_off) -> None:
    for off in (q_off, k_off):
        if not -2**31 <= off < 2**31:
            raise ValueError(f"offset {off} outside int32")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.block_flash_error_string(err).decode())


def _launch(q, k, v, q_off, k_off, causal, scale) -> State:
    lib = _library()
    _check(q, k, v, lib)
    _offsets(q_off, k_off)
    if k.dtype not in _KV_CODE or v.dtype != k.dtype:
        raise TypeError(f"block_flash takes fp32 or bf16 k and v of one type, "
                        f"got {k.dtype} and {v.dtype}")
    bh, t_q, d = q.shape
    if _all_bf16(q, k, v):
        kind, qk = _TC, q.contiguous()          # scale applied to the scores
    else:
        if bh > 65535:
            raise ValueError(f"the fp32 block_flash kernel takes BH <= 65535, got {bh}")
        kind, qk = _KV_CODE[k.dtype], (q.float() * scale).contiguous()  # :155
    k, v = k.contiguous(), v.contiguous()
    o = torch.empty((bh, t_q, d), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.block_flash_launch(
            qk.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), bh, t_q, k.shape[1], d, kind,
            int(causal), int(q_off), int(k_off), float(scale), stream,
        )
    _raise_on(lib, err, "block_flash")
    _tally("block_flash", qk, k)
    return o, m, l


_FAKE_LAUNCHES = [False]


@contextlib.contextmanager
def fake_launches():
    """Inside the block, K3 and its backward given fake tensors
    (``FakeTensorMode``) allocate what their launches on the card allocate
    (:func:`_fake_launch`, :func:`_fake_launch_bwd`) instead of running
    their plain versions: launches nothing, counts nothing, needs no
    card."""
    prev = _FAKE_LAUNCHES[0]
    _FAKE_LAUNCHES[0] = True
    try:
        yield
    finally:
        _FAKE_LAUNCHES[0] = prev


def _fake_launch(q, k, v) -> State:
    """What :func:`_launch` allocates: q (scaled to fp32 unless q, k and v
    are bf16), k and v made contiguous, and the fp32 o, m and l."""
    bh, t_q, d = q.shape
    inputs = (q.contiguous() if _all_bf16(q, k, v) else q.float().contiguous(),
              k.contiguous(), v.contiguous())
    o = torch.empty((bh, t_q, d), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    out = o, m, torch.empty_like(m)
    del inputs  # held, as the launch holds them, until the outputs exist
    return out


def _fake_launch_bwd(q, k, v, m, do, dl) -> Grads:
    """What :func:`_launch_bwd` allocates: fp32 copies of m, dô and dl,
    dô's bf16 hi and lo parts and the fp32 dq, dk and dv."""
    inputs = [x.contiguous() for x in (q, k, v)]
    inputs += [x.float().contiguous() for x in (m, do, dl)]
    inputs += [torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
               for _ in range(2)]
    out = (torch.empty(q.shape, dtype=torch.float32, device=q.device),
           torch.empty(k.shape, dtype=torch.float32, device=q.device),
           torch.empty(k.shape, dtype=torch.float32, device=q.device))
    del inputs  # held, as the launch holds them, until the outputs exist
    return out


def block_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_off: int = 0, k_off: int = 0, causal: bool = False,
                scale: float = 1.0) -> State:
    """K3: the flash state ``(o_hat, m, l)`` of one block.  q ``[BH, Tq,
    D]`` (any float type), k and v ``[BH, Tk, D]`` fp32 or bf16 (all three
    bf16: the tensor-core kernel), ``q_off``/``k_off`` the blocks' global
    positions.  CPU tensors take :func:`block_flash_plain`; CUDA tensors
    launch the kernel (or raise); fake tensors inside :func:`fake_launches`
    take :func:`_fake_launch`."""
    q_off, k_off = int(q_off), int(k_off)
    if _FAKE_LAUNCHES[0] and is_fake(q):
        return _fake_launch(q, k, v)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return block_flash_plain(q, k, v, q_off, k_off, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"block_flash: no kernel for device {q.device}")
    return _launch(q, k, v, q_off, k_off, causal, scale)


Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.no_grad()
def block_flash_bwd_plain(q, k, v, m, do, dl, q_off: int = 0, k_off: int = 0,
                          causal: bool = False, scale: float = 1.0,
                          tk: int = BWD_TILE) -> Grads:
    """Plain version of K3's backward (``pallas_attention.py:243-311``), a
    loop over Tk tiles split evenly; fp32 ``(dq, dk, dv)``.  With P =
    exp(s - m) and m held constant:
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
    return dq * scale, dk, dv


def _launch_bwd(q, k, v, m, do, dl, q_off, k_off, causal, scale) -> Grads:
    lib = _library()
    _check(q, k, v, lib)
    _offsets(q_off, k_off)
    if not _all_bf16(q, k, v):
        raise TypeError(f"the block_flash backward kernel takes bf16 q, k and v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    bh, t_q, d = q.shape
    if any(x.device != q.device for x in (m, do, dl)):
        raise ValueError(f"m on {m.device}, dô on {do.device}, dl on {dl.device}; "
                         f"q on {q.device}")
    if m.shape != (bh, t_q) or dl.shape != (bh, t_q) or do.shape != q.shape:
        raise ValueError(f"m {tuple(m.shape)}, dl {tuple(dl.shape)}, dô "
                         f"{tuple(do.shape)} for q {tuple(q.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    m, do, dl = (x.float().contiguous() for x in (m, do, dl))
    do_hi = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    do_lo = torch.empty_like(do_hi)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.block_flash_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
            dl.data_ptr(), do_hi.data_ptr(), do_lo.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, t_q, k.shape[1], d, int(causal),
            int(q_off), int(k_off), float(scale), stream,
        )
    _raise_on(lib, err, "block_flash backward")
    _tally("block_flash_bwd", q, k, backward=True)
    return dq, dk, dv


def block_flash_bwd(q, k, v, m, do, dl, q_off: int = 0, k_off: int = 0,
                    causal: bool = False, scale: float = 1.0) -> Grads:
    """K3's backward: fp32 ``(dq, dk, dv)`` of one block given its forward
    ``m`` and the cotangents ``do`` of ``o_hat`` and ``dl`` of ``l``.  CPU
    tensors take :func:`block_flash_bwd_plain`; CUDA tensors launch the
    kernel, which takes bf16 q, k and v (or raise); bf16 fake tensors
    inside :func:`fake_launches` take :func:`_fake_launch_bwd`."""
    q_off, k_off = int(q_off), int(k_off)
    if _FAKE_LAUNCHES[0] and is_fake(q) and _all_bf16(q, k, v):
        return _fake_launch_bwd(q, k, v, m, do, dl)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return block_flash_bwd_plain(q, k, v, m, do, dl, q_off, k_off, causal, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"block_flash_bwd: no kernel for device {q.device}")
    return _launch_bwd(q, k, v, m, do, dl, q_off, k_off, causal, scale)


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
        if q.is_cuda and not _all_bf16(q, k, v):
            # fp32 on the card keeps the PyTorch-op backward, by type: the
            # JAX package's backward is not a Pallas kernel, and fp32 is not
            # the slice's path.
            grads = block_flash_bwd_plain(q, k, v, m, do, dl, *ctx.args)
        else:
            grads = block_flash_bwd(q, k, v, m, do, dl, *ctx.args)
        dq, dk, dv = grads
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
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
