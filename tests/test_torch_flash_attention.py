"""K3 of the PyTorch port (mpi4dl_tpu_torch/ops/flash_attention.py) against
the JAX package's Pallas block-flash kernel (mpi4dl_tpu/ops/pallas_attention.py).

On the CPU the port's wrapper runs its plain version and the JAX kernel runs
in interpret mode, as tests/test_pallas_attention.py runs it.  Inputs are
made with numpy from a seed.  Tolerances are the JAX tests': values
rtol/atol 1e-5 (test_pallas_attention.py:35-74), exact zeros for fully
masked rows (:77-89), gradients rtol 1e-4 / atol 1e-5 (:92-108).  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.ops import pallas_attention as jpa
from mpi4dl_tpu_torch.ops import flash_attention as fa


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _close(got, want, rtol=1e-5, atol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol, atol=atol)


# The kernel registry's two cases (mpi4dl_tpu/ops/kernel_registry.py:76-106),
# and a causal ring hop with offsets: (dtype, causal, q_off, k_off).
@pytest.mark.parametrize("dtype,causal,q_off,k_off", [
    ("float32", False, 0, 0),
    ("bfloat16", True, 0, 0),
    ("float32", True, 256, 100),
])
def test_block_flash_plain_matches_pallas(dtype, causal, q_off, k_off):
    q, k, v = _arrays((2, 48, 64), (2, 300, 64), (2, 300, 64))
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = jpa.block_flash(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                           jnp.asarray(q_off, jnp.int32), jnp.asarray(k_off, jnp.int32),
                           causal, 0.125, 16, 128, True)
    before = dict(fa.LAUNCHES)
    got = fa.block_flash(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                         q_off, k_off, causal, 0.125)
    assert fa.LAUNCHES == before  # CPU tensors take the plain version
    assert [tuple(g.shape) for g in got] == [(2, 48, 64), (2, 48), (2, 48)]
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want)


def test_fully_masked_rows_are_exact_zeros():
    """A causal block whose keys all lie in the future gives l = o = 0 and
    m = NEG_INF exactly (the guard the ring merge relies on)."""
    q, k, v = _arrays((1, 16, 8), (1, 16, 8), (1, 16, 8))
    args = (0, 1000, True, 1.0 / 8 ** 0.5)
    o, m, l = fa.block_flash(_torch(q), _torch(k), _torch(v), *args)
    jo, jm, jl = jpa.block_flash(_jax(q), _jax(k), _jax(v), jnp.asarray(0),
                                 jnp.asarray(1000), True, args[3], 256, 512, True)
    np.testing.assert_array_equal(l.numpy(), 0.0)
    np.testing.assert_array_equal(o.numpy(), 0.0)
    np.testing.assert_array_equal(m.numpy(), np.float32(fa.NEG_INF))
    np.testing.assert_array_equal(np.asarray(jl), 0.0)
    np.testing.assert_array_equal(np.asarray(jm), m.numpy())


def test_merge_of_two_halves_equals_the_full_block():
    b, t, h, d = 2, 32, 2, 16
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(b * h, t, d)
               for x in _arrays(*[(b, t, h, d)] * 3))
    sc = 1.0 / d ** 0.5
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    full = fa.block_flash(tq, tk, tv, 0, 0, False, sc)
    merged = fa.mlo_merge(fa.block_flash(tq, tk[:, :t // 2], tv[:, :t // 2], 0, 0, False, sc),
                          fa.block_flash(tq, tk[:, t // 2:], tv[:, t // 2:], 0, t // 2,
                                         False, sc))
    _close(merged, full)
    z = jnp.zeros((), jnp.int32)
    jmerged = jpa.mlo_merge(
        jpa.block_flash(_jax(q), _jax(k[:, :t // 2]), _jax(v[:, :t // 2]), z, z,
                        False, sc, 256, 512, True),
        jpa.block_flash(_jax(q), _jax(k[:, t // 2:]), _jax(v[:, t // 2:]), z,
                        jnp.asarray(t // 2), False, sc, 256, 512, True))
    _close(merged, jmerged)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_local_matches_pallas(causal):
    q, k, v = _arrays(*[(2, 48, 2, 32)] * 3)
    want = jpa.flash_attention_local(_jax(q), _jax(k), _jax(v), causal=causal,
                                     interpret=True)
    got = fa.flash_attention_local(_torch(q), _torch(k), _torch(v), causal=causal)
    assert got.shape == (2, 48, 2, 32) and got.dtype == torch.float32
    _close([got], [want])


def test_flash_attention_local_unaligned_shapes():
    """T and D off every tile grid (test_pallas_attention.py:45-53)."""
    q, k, v = _arrays(*[(2, 50, 2, 24)] * 3)
    want = jpa.flash_attention_local(_jax(q), _jax(k), _jax(v), interpret=True)
    _close([fa.flash_attention_local(_torch(q), _torch(k), _torch(v))], [want])


@pytest.mark.parametrize("t_k", [40, 1100])
def test_gradients_match_jax(t_k):
    """Grads through the autograd Function against JAX's custom VJP; at
    Tk = 1100 the backward splits the keys into three even tiles."""
    q, k, v = _arrays((2, 40, 16), (2, t_k, 16), (2, t_k, 16), seed=1)
    args = (7, 3, True, 0.25)   # a causal hop with offsets

    def loss_jax(q, k, v):
        o, m, l = jpa.block_flash(q, k, v, jnp.asarray(args[0]), jnp.asarray(args[1]),
                                  args[2], args[3], 256, 512, True)
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(l))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_torch(x).requires_grad_() for x in (q, k, v))
    o, m, l = fa.block_flash_t(tq, tk, tv, *args)
    ((o ** 2).sum() + torch.sin(l).sum()).backward()
    _close([tq.grad, tk.grad, tv.grad], want, rtol=1e-4, atol=1e-5)


def test_flash_attention_local_gradients_match_jax():
    q, k, v = _arrays(*[(2, 40, 2, 16)] * 3)

    def loss_jax(q, k, v):
        return jnp.sum(jpa.flash_attention_local(q, k, v, causal=True, interpret=True) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    ts = [_torch(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_attention_local(*ts, causal=True) ** 2).sum().backward()
    _close([t.grad for t in ts], want, rtol=1e-4, atol=1e-5)


def test_no_kernel_for_other_devices():
    q = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.block_flash(q, q, q)
    fa.reset_launch_counts()
    assert fa.LAUNCHES == {"block_flash": 0}
