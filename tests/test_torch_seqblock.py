"""SeqBlock of the PyTorch port (mpi4dl_tpu_torch/models/seqblock.py)
against the JAX package's (mpi4dl_tpu/models/seqblock.py), on one device.

Weights are carried from the JAX init by ``params.from_jax_params``; inputs
are made with numpy from a seed.  Tolerances are the JAX tests'
(tests/test_seqblock.py): forward rtol/atol 2e-5, losses rtol 1e-5, params
rtol 1e-4 / atol 1e-6.  The JAX package's forward runs its einsum path on
the CPU; the port runs its einsum path or, with ``use_flash=True``, the K3
plain version through the autograd Function.  The sharded step is held
against JAX on four gloo ranks in tests/test_torch_ring.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.models import seqblock as jsb
from mpi4dl_tpu_torch import params as tparams
from mpi4dl_tpu_torch.models.seqblock import SeqBlock, make_seq_cp_train_step


def _data(b=2, t=32, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, d)).astype(np.float32),
            rng.standard_normal((b, t, d)).astype(np.float32))


def _blocks(n_blocks, d, heads, causal=True, seed=0):
    """JAX blocks, their params (numpy), and port blocks carrying them."""
    jblocks = [jsb.SeqBlock(d, heads, causal=causal) for _ in range(n_blocks)]
    jparams = [jax.tree.map(np.asarray, b.init(jax.random.key(seed + i)))
               for i, b in enumerate(jblocks)]
    port = torch.nn.ModuleList(SeqBlock(d, heads, causal=causal, device="cpu", seed=99)
                               for _ in range(n_blocks))
    tparams.from_jax_params(jparams, port)
    return jblocks, jparams, port


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_jax(causal, use_flash):
    (jblk,), (jp,), (blk,) = _blocks(1, 16, 2, causal)
    x, _ = _data()
    want = jblk.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_bf16_forward_within_twice_the_jax_bf16_error():
    """bf16 activations over fp32 params: the port's output is no further
    from its fp32 output than 2x the JAX package's bf16 output is from
    JAX's fp32 output."""
    (jblk,), (jp,), (blk,) = _blocks(1, 32, 4, True)
    x, _ = _data(t=64, d=32)
    jparams = jax.tree.map(jnp.asarray, jp)
    j32 = np.asarray(jblk.apply(jparams, jnp.asarray(x)))
    j16 = np.asarray(jblk.apply(jparams, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        t32 = blk(torch.from_numpy(x)).numpy()
        out16 = blk(torch.from_numpy(x).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16
    t16 = out16.float().numpy()
    np.testing.assert_allclose(t32, j32, rtol=2e-5, atol=2e-5)
    jerr = np.abs(j16 - j32).max()
    terr = np.abs(t16 - t32).max()
    assert 0 < jerr and terr <= 2 * jerr, (terr, jerr)


def test_params_round_trip():
    _, jparams, port = _blocks(2, 16, 2)
    back = tparams.to_jax_layout(port)
    assert len(back) == 2
    for got, want in zip(back, jparams):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert tuple(port[0].wqkv.shape) == (16, 48) and tuple(port[0].w2.shape) == (64, 16)


@pytest.mark.parametrize("use_flash", [False, True])
def test_single_device_step_matches_jax_sgd(use_flash):
    """Three SGD steps of the single-device step (group None) against
    JAX's value_and_grad SGD (test_seqblock.py:48-79)."""
    jblocks, jparams, port = _blocks(2, 16, 2)
    x, y = _data()
    lr = 0.05

    def ref_loss(params_list, x, y):
        h = x
        for blk, p in zip(jblocks, params_list):
            h = blk.apply(p, h)
        err = (h - y).astype(jnp.float32)
        return jnp.mean(err * err)

    ref = jax.tree.map(jnp.asarray, jparams)
    step = make_seq_cp_train_step(port, None, 1, lr, use_flash=use_flash, device="cpu")
    losses_ref, losses = [], []
    for _ in range(3):
        loss_r, grads = jax.value_and_grad(ref_loss)(ref, jnp.asarray(x), jnp.asarray(y))
        ref = jax.tree.map(lambda p, g: p - lr * g, ref, grads)
        losses_ref.append(float(loss_r))
        losses.append(float(step(torch.from_numpy(x), torch.from_numpy(y))))
    np.testing.assert_allclose(losses, losses_ref, rtol=1e-5)
    for got, want in zip(tparams.to_jax_layout(port), ref):
        for key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-4, atol=1e-6)
    assert losses[-1] < losses[0]
