"""Exact ring attention over a sequence-sharded axis — the counterpart of
``mpi4dl_tpu/ops/ring.py``.

Each rank of ``group`` holds a ``[B, T_local, H, D]`` shard of q, k and v.
K/V blocks rotate around the ring (:func:`mpi4dl_tpu_torch.distributed.ring_hop`)
while each rank folds every block into its queries' output with the online
softmax, so the result equals single-device softmax(QKᵀ)V up to fp
accumulation order.  ``causal`` masks by GLOBAL token position.  Two local
computes, as in the JAX package:

- the einsum path (``ring.py:149-182``), which builds each hop's
  ``[B, H, Tq, Tk]`` scores; the validation oracle and the CPU default;
- the flash path (``ring.py:185-244``): each hop's block state comes from
  the K3 kernel (:func:`~mpi4dl_tpu_torch.ops.flash_attention.block_flash_t`)
  and folds in with ``mlo_merge``.  Under ``causal`` a rank skips the
  kernel for blocks wholly in its future (an exact ``mlo_merge`` identity)
  but still takes part in every hop.

``use_flash=None`` picks the flash path for CUDA tensors and the einsum
path for CPU tensors (``_resolve_flash`` :82-89 picks by backend).

:func:`seq_ghost_exchange` and :func:`ghost_conv1d` (``ring.py:41-79``)
are the 1-D ghost-cell instance of the halo exchange over the same
sequence-sharded ``group``: the ranks form a 1 x n tile row
(:class:`~mpi4dl_tpu_torch.parallel.tiles.ProcessGroupTiles`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mpi4dl_tpu_torch.distributed import rank_and_size, ring_hop, tie
from mpi4dl_tpu_torch.ops.flash_attention import (
    NEG_INF, block_flash_t, flash_attention_local, fold_heads, mlo_merge,
)


def seq_ghost_exchange(x: torch.Tensor, group, n: int, lo: int, hi: int,
                       dim: int = 1) -> torch.Tensor:
    """Extend this rank's sequence shard with ``lo`` trailing tokens of the
    previous shard and ``hi`` leading tokens of the next (zeros at the
    global sequence boundary, the conv halo's zero padding).  With
    ``group`` None: the zero-padded sequence of one device."""
    from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_1d
    from mpi4dl_tpu_torch.parallel.tiles import ProcessGroupTiles

    tiles = None if group is None else ProcessGroupTiles(1, n, group)
    return halo_exchange_1d(x, dim, "spw", 1 if group is None else n,
                            HaloSpec(lo, hi), tiles)


def ghost_conv1d(x: torch.Tensor, kernel: torch.Tensor, group, n: int,
                 stride: int = 1) -> torch.Tensor:
    """1-D "same" convolution of a sequence-sharded ``[B, T, C]`` tensor
    with ``kernel`` ``[K, C_in, C_out]``.  With ``group`` None a plain
    padded conv; sharded, the (K-1)//2 overlap is ghost-exchanged and the
    conv runs VALID, which equals the unsharded op."""
    k = kernel.shape[0]
    lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
    x = seq_ghost_exchange(x, group, n, lo, hi)
    y = F.conv1d(x.transpose(1, 2), kernel.to(x.dtype).permute(2, 1, 0).contiguous(),
                 stride=stride)
    return y.transpose(1, 2)


def _einsum_local(q, k, v, causal: bool, sc) -> torch.Tensor:
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * sc, k.float())
    if causal:
        pos = torch.arange(t, dtype=torch.int64, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, n: int = 1, causal: bool = False,
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``group`` (``n`` ranks,
    ``[B, T_local, H, D]`` each).  With ``group`` None: plain (optionally
    causal) attention on one device.  Returns q's dtype."""
    b, t, h, d = q.shape
    flash = q.is_cuda if use_flash is None else use_flash
    my, size = rank_and_size(group)
    if size != n:
        raise ValueError(f"n={n} but the group has {size} ranks")
    if flash:
        sc = float(scale) if scale is not None else 1.0 / float(d) ** 0.5
        if group is None:
            return flash_attention_local(q, k, v, causal=causal, scale=sc)
        return _ring_flash(q, k, v, group, n, my, causal, sc)
    # ring.py:116: 1/sqrt(d) in fp32.
    sc = scale if scale is not None else float(
        1.0 / torch.tensor(float(d), dtype=torch.float32, device="cpu").sqrt())
    if group is None:
        return _einsum_local(q, k, v, causal, sc)

    qf = q.float() * sc
    q_pos = my * t + torch.arange(t, dtype=torch.int64, device=q.device)
    m = torch.full((b, h, t), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    kblk, vblk = k, v
    for hop in range(n):
        src = (my - hop) % n
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk.float())
        if causal:
            k_pos = src * t + torch.arange(t, dtype=torch.int64, device=q.device)
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # exp(-inf - -inf) guard: rows with no valid keys yet keep m = -inf.
        c = torch.exp(torch.where(torch.isfinite(m), m - m_new, float("-inf")))
        p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]), 0.0)
        l = l * c + p.sum(dim=-1)
        o = o * c[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk.float())
        m = m_new
        if hop < n - 1:   # the JAX ring's last hop returns blocks home, unused
            kblk, vblk = ring_hop(kblk, vblk, group)
    out = o / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _ring_flash(q, k, v, group, n: int, my: int, causal: bool, sc: float):
    b, t, h, d = q.shape
    qf = fold_heads(q)
    m = torch.full((b * h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b * h, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((b * h, t, d), dtype=torch.float32, device=q.device)
    kblk, vblk = k, v
    for hop in range(n):
        src = (my - hop) % n
        # A block wholly in this rank's future (src > my) would give
        # (0, NEG_INF, 0), an mlo_merge identity: skip the kernel.
        if not causal or src <= my:
            blk = block_flash_t(qf, fold_heads(kblk), fold_heads(vblk),
                                my * t, src * t, causal, sc)
            o, m, l = mlo_merge((o, m, l), blk)
        if hop < n - 1:
            kblk, vblk = ring_hop(kblk, vblk, group)
    if causal and n > 1:
        # Ranks that skipped the last blocks still run every hop's backward.
        o = tie(o, kblk, vblk)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, t, d).transpose(1, 2).to(q.dtype)


def emulated_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int,
                  causal: bool) -> torch.Tensor:
    """The flash ring's schedule for ``n`` ranks, run one rank after another
    in one process (``tests/flash_ring_check.py:30-66``): full ``[B, T, H,
    D]`` tensors in, ring attention out, every block through
    :func:`block_flash_t` with its hop's offsets and no causal skip."""
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"T={t} does not split over {n} ranks")
    tl = t // n
    sc = 1.0 / float(d) ** 0.5
    kb = [fold_heads(k[:, i * tl:(i + 1) * tl]) for i in range(n)]
    vb = [fold_heads(v[:, i * tl:(i + 1) * tl]) for i in range(n)]
    outs = []
    for dev in range(n):
        qf = fold_heads(q[:, dev * tl:(dev + 1) * tl])
        state = (torch.zeros((b * h, tl, d), dtype=torch.float32, device=q.device),
                 torch.full((b * h, tl), NEG_INF, dtype=torch.float32, device=q.device),
                 torch.zeros((b * h, tl), dtype=torch.float32, device=q.device))
        for hop in range(n):
            src = (dev + hop) % n
            blk = block_flash_t(qf, kb[src], vb[src], dev * tl, src * tl, causal, sc)
            state = mlo_merge(state, blk)
        o, _, l = state
        out = o / l.clamp_min(1e-30)[..., None]
        outs.append(out.reshape(b, h, tl, d).transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)
