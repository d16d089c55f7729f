"""The port's layers (mpi4dl_tpu_torch/layers.py) against the JAX package's
(mpi4dl_tpu/layers.py) at fp32: values and gradients from the same numpy
inputs and the same parameters (JAX init, crossed with from_jax_params)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu import layers as jl
from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, SpatialCtx as JSpatialCtx
from mpi4dl_tpu_torch import layers as tl
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.params import from_jax_params


def _run_both(jlayer, tlayer, shape, jctx=JApplyCtx(train=True),
              tctx=ApplyCtx(train=True), x=None, seed=0):
    """Forward and grads (w.r.t. input and params) of sum(layer(x) * t) on
    both sides; returns ((y_j, gx_j, gp_j), (y_t, gx_t, tlayer))."""
    params, out_shape = jlayer.init(jax.random.key(seed), shape)
    from_jax_params(jax.tree.map(np.asarray, params), tlayer)
    rng = np.random.default_rng(seed + 1)
    if x is None:
        x = rng.standard_normal(shape).astype(np.float32)
    t = rng.standard_normal(out_shape).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jlayer.apply(p, xx, jctx) * t)

    y_j = jlayer.apply(params, jnp.asarray(x), jctx)
    gp_j, gx_j = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y_t = tlayer(xt, tctx)
    (y_t * torch.from_numpy(t)).sum().backward()
    return (np.asarray(y_j), np.asarray(gx_j), gp_j), (y_t.detach().numpy(), xt.grad.numpy(), tlayer)


def _assert_param_grads(gp_j, tlayer, **tol):
    for name, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_j[name]),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("kwargs,shape", [
    (dict(in_channels=8, out_channels=16, kernel_size=3), (2, 12, 10, 8)),  # SAME
    (dict(in_channels=8, out_channels=16, kernel_size=3, stride=2, padding=1,
          bias=False), (2, 12, 10, 8)),                                       # strided
    (dict(in_channels=8, out_channels=16, kernel_size=1, padding=0), (2, 12, 10, 8)),
    (dict(in_channels=8, out_channels=16, kernel_size=1, stride=2, padding=0,
          bias=False), (2, 12, 10, 8)),                                       # strided 1x1
    (dict(in_channels=8, out_channels=8, kernel_size=(1, 7), padding=(0, 3),
          bias=False), (2, 9, 11, 8)),                                        # AmoebaNet 1x7
])
def test_conv2d_matches_jax(kwargs, shape):
    (yj, gxj, gpj), (yt, gxt, layer) = _run_both(jl.Conv2d(**kwargs), tl.Conv2d(**kwargs), shape)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gxt, gxj, rtol=1e-5, atol=1e-5)
    _assert_param_grads(gpj, layer, rtol=1e-4, atol=1e-4)


def test_conv2d_k1_dispatch_matches_jax():
    """use_pallas_conv routes a stride-1 3x3 conv through K1 (plain version
    on the CPU) on both sides — Pallas interpret on the JAX side."""
    kw = dict(in_channels=8, out_channels=12, kernel_size=3)
    (yj, gxj, gpj), (yt, gxt, layer) = _run_both(
        jl.Conv2d(**kw), tl.Conv2d(**kw), (2, 10, 9, 8),
        jctx=JApplyCtx(train=True, spatial=JSpatialCtx(use_pallas_conv=True)),
        tctx=ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True)),
    )
    np.testing.assert_allclose(yt, yj, atol=2e-4)
    np.testing.assert_allclose(gxt, gxj, atol=2e-4)
    _assert_param_grads(gpj, layer, atol=2e-3)


def test_batchnorm_train_values_grads_and_running_stats():
    bn_j, bn_t = jl.BatchNorm(6), tl.BatchNorm(6)
    shape = (2, 5, 7, 6)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    (yj, gxj, gpj), (yt, gxt, layer) = _run_both(bn_j, bn_t, shape, x=x)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gxt, gxj, rtol=1e-4, atol=1e-5)
    _assert_param_grads(gpj, layer, rtol=1e-4, atol=1e-5)
    # Running-stat deposit: momentum update, unbiased variance.
    params, _ = bn_j.init(jax.random.key(0), shape)
    sink_j = {}
    bn_j.apply(params, jnp.asarray(x), JApplyCtx(train=True, bn_sink=sink_j))
    sink_t = {}
    layer(torch.from_numpy(x), ApplyCtx(train=True, bn_sink=sink_t))
    mean_t, var_t = sink_t[layer]
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(sink_j[id(params["mean"])]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(sink_j[id(params["var"])]),
                               rtol=1e-5, atol=1e-6)


def test_batchnorm_eval_uses_running_stats():
    bn_j, bn_t = jl.BatchNorm(4), tl.BatchNorm(4)
    params, _ = bn_j.init(jax.random.key(0), (1, 3, 3, 4))
    rng = np.random.default_rng(5)
    params = dict(params, mean=jnp.asarray(rng.standard_normal(4), jnp.float32),
                  var=jnp.asarray(rng.uniform(0.5, 2.0, 4), jnp.float32),
                  scale=jnp.asarray(rng.standard_normal(4), jnp.float32))
    from_jax_params(jax.tree.map(np.asarray, params), bn_t)
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    yj = bn_j.apply(params, jnp.asarray(x), JApplyCtx(train=False))
    with torch.no_grad():
        yt = bn_t(torch.from_numpy(x), ApplyCtx(train=False))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("args,kwargs", [
    (("max", 3, 2, 1), {}),                            # padded: -inf border
    (("max", 2, 2, 0), {}),                            # non-overlapping
    (("max", 3, 1, 1), {}),
    (("avg", 3, 1, 1), dict(count_include_pad=False)),  # in-bounds divisor
    (("avg", 3, 2, 1), dict(count_include_pad=False)),
    (("avg", 3, 2, 1), {}),
])
def test_pool2d_matches_jax(args, kwargs):
    shape = (2, 8, 10, 3)
    (yj, gxj, _), (yt, gxt, _) = _run_both(
        jl.Pool2d(*args, **kwargs), tl.Pool2d(*args, **kwargs), shape)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gxt, gxj, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("args", [("max", 3, 2, 1), ("max", 2, 2, 0)])
def test_max_pool_ties_split_like_jax(args):
    """Tied maxima (BN outputs of all-zero ReLU pixels) receive the JAX
    package's share of the gradient, not the library pool's argmax."""
    x = np.round(np.random.default_rng(7).standard_normal((2, 8, 8, 3))).astype(np.float32)
    (yj, gxj, _), (yt, gxt, _) = _run_both(
        jl.Pool2d(*args), tl.Pool2d(*args), x.shape, x=x)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(gxt, gxj, rtol=1e-6, atol=1e-6)


def test_dense_and_global_avg_pool_match_jax():
    (yj, gxj, gpj), (yt, gxt, layer) = _run_both(jl.Dense(12, 5), tl.Dense(12, 5), (3, 12))
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gxt, gxj, rtol=1e-5, atol=1e-6)
    _assert_param_grads(gpj, layer, rtol=1e-5, atol=1e-6)
    (yj, gxj, _), (yt, gxt, _) = _run_both(jl.GlobalAvgPool(), tl.GlobalAvgPool(), (2, 5, 6, 4))
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gxt, gxj, rtol=1e-6, atol=1e-7)


def test_init_bounds_match_jax():
    """The port's own init draws from the JAX package's bounds."""
    g = torch.Generator().manual_seed(0)
    conv = tl.Conv2d(8, 16, 3)
    conv.reset_parameters(g)
    bound = 1.0 / np.sqrt(8 * 9)
    assert float(conv.kernel.detach().abs().max()) <= bound
    assert float(conv.kernel.detach().abs().max()) > 0.9 * bound
    dense = tl.Dense(50, 3)
    dense.reset_parameters(g)
    assert float(dense.kernel.detach().abs().max()) <= 1.0 / np.sqrt(50)
