"""K1/K2 of the PyTorch port (mpi4dl_tpu_torch/ops/halo_conv.py) against the
JAX package's Pallas kernels (mpi4dl_tpu/ops/pallas_conv.py).

On the CPU the port's wrappers run their plain versions and the JAX kernels
run in interpret mode, as tests/test_pallas_conv.py runs them.  Inputs are
made with numpy from a seed.  Tolerances are the JAX tests': K1 atol 2e-4
(test_pallas_conv.py:38), K2 rtol/atol 1e-4 and <= 8 scaled ULP (:291,
:452), dx atol 2e-4 / dw atol 2e-3 (:157-158), fused VJP rtol/atol 1e-4
(:304-307).  The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.ops import pallas_conv as jpc
from mpi4dl_tpu_torch.ops import _build
from mpi4dl_tpu_torch.ops import halo_conv as hc

# (kh, kw, cin, cout, h, w): 3x3, AmoebaNet's 1x7 and 7x1, ragged tails.
SHAPES = [
    (3, 3, 16, 24, 12, 10),
    (1, 7, 16, 16, 16, 20),
    (7, 1, 8, 16, 20, 12),
    (3, 3, 24, 40, 33, 50),
]
WINDOWS = {  # a margin-excluding stat window per shape (output coords)
    (12, 10): (1, 11, 2, 8),
    (16, 20): (0, 16, 3, 17),
    (20, 12): (3, 17, 0, 12),
    (33, 50): (1, 32, 2, 48),
}


def _data(kh, kw, cin, cout, h, w, seed=0, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h + kh - 1, w + kw - 1, cin)).astype(np.float32)
    wk = (rng.standard_normal((kh, kw, cin, cout)) * 0.1).astype(np.float32)
    return x, wk


def _scaled_ulp(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = float(np.max(np.abs(ref)))
    assert scale > 0
    return float(np.max(np.abs(got - ref)) / (np.float32(2.0) ** -23 * scale))


@pytest.mark.parametrize("kh,kw,cin,cout,h,w", SHAPES)
def test_k1_plain_matches_pallas(kh, kw, cin, cout, h, w):
    x, wk = _data(kh, kw, cin, cout, h, w)
    want = jpc.halo_conv2d(jnp.asarray(x), jnp.asarray(wk), interpret=True)
    got = hc.halo_conv2d(torch.from_numpy(x), torch.from_numpy(wk))
    assert tuple(got.shape) == want.shape == (2, h, w, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("kh,kw,cin,cout,h,w", SHAPES)
def test_k2_plain_matches_pallas(kh, kw, cin, cout, h, w):
    x, wk = _data(kh, kw, cin, cout, h, w, seed=1)
    win = WINDOWS[(h, w)]
    want = jpc.halo_conv2d(jnp.asarray(x), jnp.asarray(wk), fuse_relu=True,
                           stat_window=win, interpret=True)
    got = hc.halo_conv2d(torch.from_numpy(x), torch.from_numpy(wk),
                         fuse_relu=True, stat_window=win)
    for name, g, r in zip(("y", "sum", "sumsq"), got, want):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        assert _scaled_ulp(g.numpy(), r) <= 8.0, name


def test_k1_bf16_plain_matches_pallas():
    """bf16 in and out, fp32 accumulation on both sides: equal up to one
    bf16 rounding of the fp32 sum (2^-7 of the largest output)."""
    x, wk = _data(1, 7, 16, 16, 16, 20, seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(wk, jnp.bfloat16)
    want = np.asarray(jpc.halo_conv2d(xb, wb, interpret=True), np.float32)
    got = hc.halo_conv2d(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(wk).bfloat16())
    assert got.dtype == torch.bfloat16
    err = np.max(np.abs(got.float().numpy() - want))
    assert err <= 2.0 ** -7 * np.max(np.abs(want))


@pytest.mark.parametrize("kh,kw,cin,cout,h,w", SHAPES[:3])
def test_halo_conv2d_t_grads_match_jax(kh, kw, cin, cout, h, w):
    x, wk = _data(kh, kw, cin, cout, h, w, seed=3)
    t = np.random.default_rng(4).standard_normal((2, h, w, cout)).astype(np.float32)
    gx_j, gw_j = jax.grad(
        lambda a, b: jnp.sum(jpc.halo_conv2d_t(a, b, True) * t), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(wk))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(wk).requires_grad_()
    (hc.halo_conv2d_t(xt, wt) * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=2e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=2e-3)


@pytest.mark.parametrize("kh,kw,cin,cout,h,w", SHAPES[:3])
def test_fused_relu_conv_bn_t_grads_match_jax(kh, kw, cin, cout, h, w):
    """An arbitrary scalarization touching y, sum and sumsq (the JAX test's,
    test_pallas_conv.py:294-307)."""
    x, wk = _data(kh, kw, cin, cout, h, w, seed=5)
    win = WINDOWS[(h, w)]

    def jscal(a, b):
        y, s, ss = jpc.fused_relu_conv_bn_t(a, b, win, True)
        return jnp.sum(y * 0.3) + jnp.sum(s * 0.7) + jnp.sum(ss * 0.11)

    gx_j, gw_j = jax.grad(jscal, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(wk).requires_grad_()
    y, s, ss = hc.fused_relu_conv_bn_t(xt, wt, win)
    ((y * 0.3).sum() + (s * 0.7).sum() + (ss * 0.11).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_never_launch(monkeypatch):
    """CPU tensors take the plain versions only: no library is built or
    loaded and the launch counters stay at 0, forward and backward."""
    def no_load(name):
        raise AssertionError(f"kernel library {name} loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_load)
    hc.reset_launch_counts()
    x, wk = _data(3, 3, 8, 8, 6, 6)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(wk).requires_grad_()
    y, s, ss = hc.fused_relu_conv_bn_t(xt, wt, (0, 6, 0, 6))
    z = hc.halo_conv2d_t(hc.pad_hw(y, 1, 1), wt)
    (z.sum() + s.sum() + ss.sum()).backward()
    assert hc.LAUNCHES == {"halo_conv2d": 0, "halo_conv2d_stats": 0}


def test_other_devices_raise():
    x = torch.zeros((1, 4, 4, 2), device="meta")
    w = torch.zeros((3, 3, 2, 2), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        hc.halo_conv2d(x, w)


# The bf16 traps of the tensor-core kernel at small sizes, (kh, kw, cin,
# cout, n, h, w): m = 52 (104-byte rows, a partial k16 chunk), 104 and 416;
# Cout 300 over Cin 8 (the kernel registry's case, a ragged n8 tile); 5x5;
# channel counts that are not a multiple of 4.  On the CPU the port runs its
# plain version; the card tests run the kernel at the same traps.
BF16_TRAPS = [
    (1, 7, 52, 52, 1, 10, 12),
    (7, 1, 52, 52, 2, 9, 7),
    (1, 7, 104, 104, 1, 8, 8),
    (7, 1, 416, 416, 1, 4, 5),
    (3, 3, 8, 300, 1, 6, 10),
    (5, 5, 24, 40, 2, 7, 9),
    (3, 3, 6, 10, 1, 9, 7),
]


@pytest.mark.parametrize("stats", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("kh,kw,cin,cout,n,h,w", BF16_TRAPS)
def test_bf16_plain_matches_pallas_at_trap_shapes(kh, kw, cin, cout, n, h, w, stats):
    """bf16 in and out with fp32 accumulation on both sides: y within one
    bf16 rounding (2^-7 of the largest output); K2 on x shifted by -1 (ReLU
    zeroes most of it) over a window that leaves out a margin, its fp32
    statistics within 2^-7 of Σ|y| and 2^-6 of Σy² (chip_smoke.py's
    bounds)."""
    x, wk = _data(kh, kw, cin, cout, h, w, seed=6, n=n)
    if stats:
        x = x - 1.0
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(wk).bfloat16()
    win = (1, h - 1, 2, w - 2)
    kw_args = dict(fuse_relu=True, stat_window=win) if stats else {}
    want = jpc.halo_conv2d(xb, wb, interpret=True, **kw_args)
    got = hc.halo_conv2d(xt, wt, **kw_args)
    want, got = (want, got) if stats else ((want,), (got,))
    y_ref = np.asarray(want[0], np.float32)
    assert got[0].dtype == torch.bfloat16 and tuple(got[0].shape) == y_ref.shape == (n, h, w, cout)
    assert np.max(np.abs(got[0].float().numpy() - y_ref)) <= 2.0 ** -7 * np.max(np.abs(y_ref))
    if stats:
        yw = y_ref[:, win[0]:win[1], win[2]:win[3], :]
        s_err = np.max(np.abs(got[1].numpy() - np.asarray(want[1])))
        ss_err = np.max(np.abs(got[2].numpy() - np.asarray(want[2])))
        assert s_err <= 2.0 ** -7 * np.max(np.abs(yw).sum(axis=(0, 1, 2)))
        assert ss_err <= 2.0 ** -6 * np.max((yw * yw).sum(axis=(0, 1, 2)))
