"""Sequence-parallel transformer block — the long-context model family, the
counterpart of ``mpi4dl_tpu/models/seqblock.py``.

:class:`SeqBlock` is a pre-norm transformer block whose attention is exact
ring attention over a sequence-sharded process group (``ops/ring.py``:
the K3 flash kernel on the card) and whose other ops are token-local, so
the block trains with only the attention communicating.  Its parameters
carry the JAX names and layouts (``wqkv [d, 3d]`` used as ``x @ W``, not
``nn.Linear``'s ``[out, in]``), so ``params.from_jax_params`` carries
weights across.  Layout ``[B, T_local, D_model]``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpi4dl_tpu_torch.device import resolve_device
from mpi4dl_tpu_torch.distributed import all_reduce_sum_, rank_and_size
from mpi4dl_tpu_torch.ops.ring import ring_attention


def _layer_norm(x, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 with biased variance, cast once to x's dtype
    (``seqblock.py:30-35``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


class SeqBlock(nn.Module):
    """Pre-norm transformer block: LN → ring attention → +res → LN → MLP
    (tanh GELU, as ``jax.nn.gelu``) → +res.  ``heads`` divides ``d_model``;
    the MLP is ``mlp_ratio · d_model`` wide.  Parameters are made from
    ``seed`` with the JAX package's init scales, in fp32 on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, d_model: int, heads: int, mlp_ratio: int = 4,
                 causal: bool = True, device="cuda", seed: int = 0):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"heads={heads} does not divide d_model={d_model}")
        dev = resolve_device(device)
        self.d_model, self.heads = d_model, heads
        self.d_head = d_model // heads
        self.causal = causal
        d, dm = d_model, mlp_ratio * d_model
        gen = torch.Generator().manual_seed(seed)

        def param(t):
            return nn.Parameter(t.to(dev))

        def normal(shape, std):
            return param(torch.randn(shape, generator=gen) * std)

        self.ln1_scale = param(torch.ones(d))
        self.ln1_bias = param(torch.zeros(d))
        self.wqkv = normal((d, 3 * d), 1.0 / math.sqrt(d))
        self.wo = normal((d, d), 1.0 / math.sqrt(d))
        self.ln2_scale = param(torch.ones(d))
        self.ln2_bias = param(torch.zeros(d))
        self.w1 = normal((d, dm), 1.0 / math.sqrt(d))
        self.b1 = param(torch.zeros(dm))
        self.w2 = normal((dm, d), 1.0 / math.sqrt(dm))
        self.b2 = param(torch.zeros(d))

    def forward(self, x: torch.Tensor, group=None, n: int = 1,
                use_flash: Optional[bool] = None) -> torch.Tensor:
        """x ``[B, T_local, D]``; with ``group`` the sequence is sharded over
        its ``n`` ranks and attention is the only cross-rank op."""
        b, t, d = x.shape
        h = _layer_norm(x, self.ln1_scale, self.ln1_bias)
        q, k, v = (h @ self.wqkv.to(h.dtype)).split(d, dim=-1)
        shp = (b, t, self.heads, self.d_head)
        att = ring_attention(q.reshape(shp), k.reshape(shp), v.reshape(shp),
                             group, n, causal=self.causal,
                             use_flash=use_flash).reshape(b, t, d)
        x = x + att @ self.wo.to(att.dtype)
        h = _layer_norm(x, self.ln2_scale, self.ln2_bias)
        h = F.gelu(h @ self.w1.to(h.dtype) + self.b1.to(h.dtype), approximate="tanh")
        return x + h @ self.w2.to(h.dtype) + self.b2.to(x.dtype)


def make_seq_cp_train_step(blocks: Sequence[SeqBlock], group, n: int, lr: float,
                           use_flash: Optional[bool] = None, device="cuda"):
    """SGD step for a stack of SeqBlocks under sequence (context)
    parallelism (``seqblock.py:93-136``): each rank holds ``[B, T/n, D]``
    shards of the inputs and targets and a replica of the parameters.
    ``step(x, y)`` updates the blocks' parameters in place and returns the
    loss, the global mean of the shards' MSEs.

    Gradient scaling: each rank backprops ``local_mean / n`` and the
    gradients are summed over the group — the transpose of the JAX step's
    ``pmean`` of the loss.  (Summing the gradients of the unscaled local
    mean would make them n times too large, the error the JAX docstring at
    ``seqblock.py:102-110`` warns of.)  With ``group`` None it is the
    single-device step (``n`` = 1).  ``device`` names where the blocks
    live (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if rank_and_size(group)[1] != n:
        raise ValueError(f"n={n} but the group has {rank_and_size(group)[1]} ranks")
    params = [p for blk in blocks for p in blk.parameters()]
    if any(p.device.type != dev.type for p in params):
        raise ValueError(f"the blocks' parameters are not on {dev}")

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = x
        for blk in blocks:
            h = blk(h, group, n, use_flash)
        err = (h - y).float()
        local = (err * err).mean() / n
        grads = list(torch.autograd.grad(local, params))
        loss = local.detach().reshape(1)
        all_reduce_sum_(grads + [loss], group)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_((p.float() - lr * g).to(p.dtype))
        return loss[0]

    return step
