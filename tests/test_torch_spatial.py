"""Spatial-parallel D1 execution of the port (one halo exchange per conv
or pool, cross-tile BatchNorm, the gather junction) on the one-process
tile grid, against the port's own single-device execution and against the
JAX package in ``shard_map`` on the virtual CPU mesh
(``tests/test_spatial.py``).  The same numpy parameters and inputs go to
both sides.

Tolerances are the JAX test's: layers rtol/atol 1e-5 (BatchNorm rtol 1e-4
/ atol 1e-5), ResNet forward 5e-4, AmoebaNet forward 2e-3, train step
losses rtol 1e-4 and parameters rtol 1e-3 / atol 1e-4 after two SGD steps.
The port's K1/K2 dispatches in the step are counted (CPU tensors take the
plain versions) and must equal the JAX step's ``pallas_call`` count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi4dl_tpu import layers as jl
from mpi4dl_tpu.compat import shard_map
from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, spatial_ctx_for as j_spatial_ctx_for
from mpi4dl_tpu.mesh import MeshSpec, build_mesh
from mpi4dl_tpu.models.amoebanet import amoebanetd as j_amoebanetd
from mpi4dl_tpu.models.resnet import get_resnet_v2 as j_resnet_v2
from mpi4dl_tpu.parallel.spatial import apply_spatial_model as j_apply_spatial_model
from mpi4dl_tpu.train import (
    Optimizer as JOptimizer, TrainState as JTrainState,
    make_spatial_train_step as j_make_spatial_train_step,
)
from mpi4dl_tpu_torch import layers as tl
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, spatial_ctx_for
from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
from mpi4dl_tpu_torch.ops import halo_conv
from mpi4dl_tpu_torch.parallel.spatial import apply_spatial_model
from mpi4dl_tpu_torch.parallel.tiles import TileGrid
from mpi4dl_tpu_torch.params import from_jax_params, to_jax_layout
from mpi4dl_tpu_torch.train import (
    Optimizer, TrainState, make_spatial_eval_step, make_spatial_train_step,
    make_train_step, make_eval_step,
)

GRIDS = {"square": (2, 2), "horizontal": (4, 1), "vertical": (1, 4)}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _randn(seed, shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift
            ).astype(np.float32)


def _port_sp(slice_method, **kw):
    return spatial_ctx_for(slice_method, 4, tiles=TileGrid(*GRIDS[slice_method]), **kw)


def _jax_sharded(fn, slice_method, in_specs_extra, out_spec, *args):
    sp = j_spatial_ctx_for(slice_method, 4)
    mesh = build_mesh(MeshSpec(sph=sp.grid_h, spw=sp.grid_w), jax.devices()[:4])
    spec = P(None, sp.axis_h, sp.axis_w, None)
    out_spec = spec if out_spec == "tiled" else out_spec
    return np.asarray(jax.jit(shard_map(
        lambda *a: fn(sp, *a), mesh=mesh, in_specs=in_specs_extra + (spec,),
        out_specs=out_spec, check_vma=False))(*args))


def _layer_case(jlayer, tlayer, x, slice_method, sp_kw=None):
    """(port single device, port SP, JAX SP) outputs of one layer."""
    sp_kw = sp_kw or {}
    params, _ = jlayer.init(jax.random.key(0), x.shape)
    from_jax_params(_np_tree(params), tlayer)
    xt = torch.from_numpy(x)
    ref = tlayer(xt, ApplyCtx(train=True)).detach().numpy()
    sp = _port_sp(slice_method, **sp_kw)
    got = sp.tiles.gather(tlayer(sp.tiles.scatter(xt), ApplyCtx(train=True, spatial=sp)))
    jax_out = _jax_sharded(
        lambda jsp, p, t: jlayer.apply(
            p, t, JApplyCtx(train=True, spatial=dataclasses.replace(jsp, **sp_kw))),
        slice_method, (P(),), "tiled", params, jnp.asarray(x))
    return ref, got.detach().numpy(), jax_out


@pytest.mark.parametrize("slice_method", ["vertical", "horizontal", "square"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_spatial_equals_single_device_and_jax(devices8, slice_method, stride):
    x = _randn(1, (2, 16, 16, 3))
    ref, got, want = _layer_case(jl.Conv2d(3, 8, kernel_size=3, stride=stride),
                                 tl.Conv2d(3, 8, kernel_size=3, stride=stride), x,
                                 slice_method)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", [(1, 7), (7, 1)])
def test_conv_asymmetric_kernel_spatial(devices8, kernel):
    pad = ((kernel[0] - 1) // 2, (kernel[1] - 1) // 2)
    x = _randn(1, (1, 16, 16, 4))
    ref, got, want = _layer_case(
        jl.Conv2d(4, 4, kernel_size=kernel, padding=pad, bias=False),
        tl.Conv2d(4, 4, kernel_size=kernel, padding=pad, bias=False), x, "square")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op,count_include_pad", [("max", True), ("avg", False)])
def test_pool_spatial_equals_single_device_and_jax(devices8, op, count_include_pad):
    x = _randn(2, (2, 16, 16, 4))
    ref, got, want = _layer_case(jl.Pool2d(op, 3, 2, 1, count_include_pad=count_include_pad),
                                 tl.Pool2d(op, 3, 2, 1, count_include_pad=count_include_pad),
                                 x, "square")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batchnorm_cross_tile_stats(devices8):
    x = _randn(3, (2, 8, 8, 4), scale=2.0, shift=1.0)
    ref, got, want = _layer_case(jl.BatchNorm(4), tl.BatchNorm(4), x, "square")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_batchnorm_per_tile_stats_match_jax(devices8):
    """``--per-tile-bn``: each tile normalised with its own statistics,
    also when the grid is folded into the batch."""
    x = _randn(3, (2, 8, 8, 4), scale=2.0, shift=1.0)
    x[:, :4] += 3.0  # tiles with different statistics
    ref, got, want = _layer_case(jl.BatchNorm(4), tl.BatchNorm(4), x, "square",
                                 {"bn_cross_tile": False})
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(got - ref).max() > 1e-2  # not the global statistics


def test_global_avg_pool_averages_over_tiles(devices8):
    x = _randn(4, (2, 8, 8, 4))
    sp = _port_sp("square")
    got = tl.GlobalAvgPool()(sp.tiles.scatter(torch.from_numpy(x)),
                             ApplyCtx(train=True, spatial=sp)).numpy()
    want = _jax_sharded(
        lambda jsp, t: jl.GlobalAvgPool().apply({}, t, JApplyCtx(train=True, spatial=jsp)),
        "square", (), P(), jnp.asarray(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, x.mean(axis=(1, 2)), rtol=1e-5, atol=1e-6)


def _model_pair(jmodel, tmodel):
    params, _ = jmodel.init(jax.random.key(0))
    from_jax_params(_np_tree(params), tmodel)
    return params


@pytest.mark.parametrize("slice_method", ["vertical", "square"])
def test_resnet_spatial_forward_equals_single_device_and_jax(devices8, slice_method):
    shape = (2, 32, 32, 3)
    jmodel = j_resnet_v2(shape, depth=11)
    tmodel = get_resnet_v2(shape, 11, device="cpu")
    params = _model_pair(jmodel, tmodel)
    x = _randn(4, shape)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(x), ApplyCtx(train=True)).numpy()
        sp = _port_sp(slice_method)
        got = apply_spatial_model(tmodel, sp.tiles.scatter(torch.from_numpy(x)),
                                  ApplyCtx(train=True, spatial=sp)).numpy()
    want = _jax_sharded(
        lambda jsp, p, t: j_apply_spatial_model(jmodel, p, t, JApplyCtx(train=True, spatial=jsp)),
        slice_method, (P(),), P(None, None), params, jnp.asarray(x))
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_amoebanet_spatial_forward_equals_single_device_and_jax(devices8):
    shape = (1, 64, 64, 3)
    jmodel = j_amoebanetd(shape, num_classes=10, num_layers=3, num_filters=64)
    tmodel = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=64, device="cpu")
    params = _model_pair(jmodel, tmodel)
    x = _randn(5, shape)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(x), ApplyCtx(train=True)).numpy()
        sp = _port_sp("square")
        got = apply_spatial_model(tmodel, sp.tiles.scatter(torch.from_numpy(x)),
                                  ApplyCtx(train=True, spatial=sp), spatial_until=4).numpy()
    want = _jax_sharded(
        lambda jsp, p, t: j_apply_spatial_model(
            jmodel, p, t, JApplyCtx(train=True, spatial=jsp), spatial_until=4),
        "square", (P(),), P(None, None), params, jnp.asarray(x))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _resnet_step_setup():
    shape = (4, 32, 32, 3)
    jmodel = j_resnet_v2(shape, depth=11)
    params, _ = jmodel.init(jax.random.key(0))
    return shape, jmodel, params, _randn(6, shape), np.array([0, 1, 2, 3], np.int32)


@pytest.mark.parametrize("bn_cross_tile", [True, False])
def test_spatial_train_step_matches_jax(devices8, bn_cross_tile):
    """Two SGD steps of the port's SP step (square, D1) against the JAX
    package's, cross-tile and per-tile BatchNorm: losses, parameters and
    running statistics."""
    shape, jmodel, params, x, y = _resnet_step_setup()
    jsp = j_spatial_ctx_for("square", 4, bn_cross_tile=bn_cross_tile)
    mesh = build_mesh(MeshSpec(sph=2, spw=2), jax.devices()[:4])
    jopt = JOptimizer("sgd", lr=0.01)
    jstep = j_make_spatial_train_step(jmodel, jopt, mesh, jsp)
    jstate = JTrainState.create(params, jopt)
    tmodel = get_resnet_v2(shape, 11, device="cpu")
    from_jax_params(_np_tree(params), tmodel)
    opt = Optimizer("sgd", lr=0.01)
    step = make_spatial_train_step(tmodel, opt, _port_sp("square", bn_cross_tile=bn_cross_tile))
    state = TrainState.create(tmodel, opt)
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    got = jax.tree.leaves(to_jax_layout(tmodel))
    want = jax.tree.leaves(_np_tree(jstate.params))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_spatial_train_step_matches_single_device(remat):
    """The single-device step is the oracle of every engine; remat threads
    per-cell checkpoints through the region and the tail."""
    shape, jmodel, params, x, y = _resnet_step_setup()
    models = [get_resnet_v2(shape, 11, device="cpu") for _ in range(2)]
    for mdl in models:
        from_jax_params(_np_tree(params), mdl)
    opt = Optimizer("sgd", lr=0.01)
    steps = [make_train_step(models[0], opt),
             make_spatial_train_step(models[1], opt, _port_sp("square"), remat=remat)]
    states = [TrainState.create(mdl, opt) for mdl in models]
    for _ in range(2):
        losses = []
        for i in range(2):
            states[i], m = steps[i](states[i], torch.from_numpy(x), torch.from_numpy(y))
            losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    for a, b in zip(jax.tree.leaves(to_jax_layout(models[0])),
                    jax.tree.leaves(to_jax_layout(models[1]))):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
    got = make_spatial_eval_step(models[1], _port_sp("square"))(
        torch.from_numpy(x), torch.from_numpy(y))
    want = make_eval_step(models[1])(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"].numpy(),
                               rtol=1e-4, atol=1e-5)


def count_pallas_calls(jaxpr) -> dict:
    """``pallas_call`` equations in a jaxpr by kernel, counting each
    sub-jaxpr every time an equation uses it: K2 (``_kernel_stats``) has
    three outputs (y and the two statistics partials), K1 one."""
    n = {"halo_conv2d": 0, "halo_conv2d_stats": 0}
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            n["halo_conv2d_stats" if len(eqn.outvars) == 3 else "halo_conv2d"] += 1
            continue
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = sub if hasattr(sub, "eqns") else getattr(sub, "jaxpr", None)
                if hasattr(inner, "eqns"):
                    for k, c in count_pallas_calls(inner).items():
                        n[k] += c
    return n


def jax_step_pallas_calls(jmodel, params, shape, **sp_kw) -> dict:
    jsp = j_spatial_ctx_for("square", 4, use_pallas_conv=True, **sp_kw)
    mesh = build_mesh(MeshSpec(sph=2, spw=2), jax.devices()[:4])
    jopt = JOptimizer("sgd", lr=0.01)
    jstep = j_make_spatial_train_step(jmodel, jopt, mesh, jsp,
                                      spatial_until=jmodel.spatial_until or None)
    jaxpr = jax.make_jaxpr(jstep)(JTrainState.create(params, jopt),
                                  jnp.zeros(shape), jnp.zeros(shape[:1], jnp.int32))
    return count_pallas_calls(jaxpr.jaxpr)


def port_step_dispatches(tmodel, shape, **sp_kw):
    """{kernel: calls} of the port's K1/K2 wrappers in one SP step on the
    CPU (each call is one launch on the card)."""
    opt = Optimizer("sgd", lr=0.01)
    step = make_spatial_train_step(tmodel, opt,
                                   _port_sp("square", use_pallas_conv=True, **sp_kw))
    with halo_conv.count_dispatches() as seen:
        step(TrainState.create(tmodel, opt), torch.zeros(shape),
             torch.zeros(shape[:1], dtype=torch.long))
    return seen.counts


def test_d1_dispatch_count_matches_jax(devices8):
    shape, jmodel, params, _, _ = _resnet_step_setup()
    tmodel = get_resnet_v2(shape, 11, device="cpu")
    counts = port_step_dispatches(tmodel, shape)
    # ResNet-11 v2: five stride-1 3x3 convs in the region, K1 forward + dx.
    assert counts == {"halo_conv2d": 10, "halo_conv2d_stats": 0}
    assert jax_step_pallas_calls(jmodel, params, shape) == counts


def test_spatial_train_step_microbatches_match_single_device():
    """``parts=2``: gradients and running statistics averaged over two
    micro-batches, each cut into tiles, as on one device."""
    shape, jmodel, params, x, y = _resnet_step_setup()
    models = [get_resnet_v2(shape, 11, device="cpu") for _ in range(2)]
    for mdl in models:
        from_jax_params(_np_tree(params), mdl)
    opt = Optimizer("sgd", lr=0.01)
    steps = [make_train_step(models[0], opt, parts=2),
             make_spatial_train_step(models[1], opt, _port_sp("vertical"), parts=2)]
    losses = [float(st(TrainState.create(m, opt), torch.from_numpy(x),
                       torch.from_numpy(y))[1]["loss"]) for st, m in zip(steps, models)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    for a, b in zip(jax.tree.leaves(to_jax_layout(models[0])),
                    jax.tree.leaves(to_jax_layout(models[1]))):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)


def test_spatial_until_auto_matches_jax():
    """``--spatial-until auto``: the port's per-placement ledger, from
    cell shapes found on the meta device, equals the JAX package's, from
    its init, and both choose the same junction."""
    from mpi4dl_tpu.parallel.spatial import (
        choose_spatial_until as j_choose, spatial_cost_ledger as j_ledger,
    )
    from mpi4dl_tpu_torch.parallel.spatial import (
        cell_output_shapes, choose_spatial_until, spatial_cost_ledger, tile_device_count,
    )

    shape = (1, 64, 64, 3)
    for jm, tm in ((j_amoebanetd(shape, num_classes=10, num_layers=3, num_filters=16),
                    amoebanetd(shape, num_classes=10, num_layers=3, num_filters=16,
                               device="meta")),
                   (j_resnet_v2(shape, depth=20), get_resnet_v2(shape, 20, device="meta"))):
        box = {}
        jax.eval_shape(lambda k, m=jm: box.setdefault("s", m.init(k))[0],
                       jax.random.key(0))
        jshapes = box["s"][1]
        shapes = cell_output_shapes(tm, shape)
        assert spatial_cost_ledger(shapes, 4) == j_ledger(jshapes, 4)
        assert choose_spatial_until(shapes, 4) == j_choose(jshapes, 4)
    assert tile_device_count(_port_sp("square")) == tile_device_count(_port_sp("vertical")) == 4
