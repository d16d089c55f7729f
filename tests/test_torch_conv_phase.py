"""The phase-decomposed strided conv of the PyTorch port
(``ops/conv_phase.py``) against the JAX package's ``conv2d_strided_t`` on
the CPU (``tests/test_conv_phase.py``'s cases): values atol 1e-5, input
and weight gradients atol 1e-4; ``Conv2d`` never dispatching it, and the
op giving the layer's values and gradients (rtol / atol 1e-5)."""

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import layers as L
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.ops import conv_phase as cp


@pytest.mark.parametrize("h,w,kh,kw,sh,sw,pad", [
    (16, 16, 3, 3, 2, 2, ((1, 1), (1, 1))),
    (16, 16, 1, 1, 2, 2, ((0, 0), (0, 0))),
    (17, 15, 3, 3, 2, 2, ((1, 1), (1, 1))),
    (16, 16, 1, 7, 1, 2, ((0, 0), (3, 3))),
    (16, 16, 7, 1, 2, 1, ((3, 3), (0, 0))),
    (15, 15, 5, 5, 3, 3, ((2, 2), (2, 2))),
    (16, 16, 2, 2, 2, 2, ((0, 0), (0, 0))),
    (14, 14, 3, 3, 2, 2, ((0, 0), (0, 0))),
    (13, 11, 3, 3, 2, 2, ((1, 2), (0, 1))),  # asymmetric padding
])
def test_conv2d_strided_t_matches_jax(h, w, kh, kw, sh, sw, pad):
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.ops.conv_phase import conv2d_strided_t as j_conv

    rng = np.random.default_rng(h * 7 + kh)
    cin, cout = 8, 12
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((kh, kw, cin, cout)) / (kh * kw)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a, b: j_conv(a, b, (sh, sw), pad), jnp.asarray(x),
                       jnp.asarray(wk))
    t = rng.standard_normal(y_j.shape).astype(np.float32)
    gx_j, gw_j = vjp(jnp.asarray(t))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(wk).requires_grad_(True)
    y = cp.conv2d_strided_t(xt, wt, (sh, sw), pad)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(t))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), atol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), atol=1e-4)


@pytest.mark.parametrize("k,stride,groups", [(3, 2, 1), (1, 2, 1), (3, 1, 1), (3, 2, 2)])
def test_conv2d_dispatch(monkeypatch, k, stride, groups):
    """``Conv2d`` never takes the phase dx (the JAX package dispatches it
    for strided ungrouped convs, ``layers.py:282-290``; on an H100 it is
    slower than the library's backward); for an ungrouped conv
    ``conv2d_strided_t`` gives the layer's values and gradients."""
    conv = L.Conv2d(8, 8, k, stride=stride, feature_group_count=groups)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 16, 8, generator=torch.Generator().manual_seed(1))
    calls = []
    real = cp._ConvPhase.apply
    monkeypatch.setattr(cp._ConvPhase, "apply",
                        staticmethod(lambda *a: calls.append(1) or real(*a)))
    xt = x.clone().requires_grad_(True)
    y = conv(xt, ApplyCtx(train=True))
    want = [y] + list(torch.autograd.grad((y * y).sum(), [xt, conv.kernel]))
    assert not calls
    if groups != 1:
        return
    xt = x.clone().requires_grad_(True)
    p = (k - 1) // 2
    y = cp.conv2d_strided_t(xt, conv.kernel, (stride, stride), ((p, p), (p, p))) + conv.bias
    got = [y] + list(torch.autograd.grad((y * y).sum(), [xt, conv.kernel]))
    assert calls
    for a, b in zip(got, want):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5, atol=1e-5)
