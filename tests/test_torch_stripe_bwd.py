"""The stripe-wise backward of the PyTorch port (``ops/stripe_bwd.py``,
``--stripe-bwd``) against the JAX package's on the CPU
(``tests/test_stripe_bwd.py``, where it is green).

- The unsharded run (``MPI4DL_STRIPE_BWD=all``) against JAX
  ``maybe_stripe_run``: values, running-statistics deposits and input
  gradients, with exact (``MPI4DL_HSTRIPE_EXACT=1``) and per-stripe
  statistics (atol 1e-5 values and deposits, 1e-4 gradients, the JAX
  test's); exact mode also against the pad-once emulation.
- Stripe-count invariance (2 against 4 stripes, exact statistics).
- The gates, case by case as JAX's.
- A spatially sharded block on the 2x2 one-process grid against JAX's
  under ``shard_map``, both statistics modes (per-stripe statistics are
  per tile: the grid views its folded batch per tile), values and
  gradients at the JAX test's rtol 2e-4 / atol 5e-4.
- The SP step with striping on and exact statistics against JAX's and
  against the port's D2 step (losses rtol 2e-5, parameters rtol 2e-4 /
  atol 1e-5).
- Inside a stripe the kernels are off: a striped block with
  ``use_pallas_conv`` makes no K1/K2 call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import layers as L
from mpi4dl_tpu_torch.cells import LayerCell
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.ops import stripe_bwd as sb
from mpi4dl_tpu_torch.ops.d2 import accumulated_halo, apply_layers_premargin
from mpi4dl_tpu_torch.params import from_jax_params
from mpi4dl_tpu_torch.parallel.tiles import TileGrid


def _stack(cin=4, cmid=8, shape=(2, 16, 12, 4)):
    """``_bn_conv_stack`` of both packages, the port's holding the JAX
    weights."""
    from mpi4dl_tpu import layers as jl

    jlayers = [jl.BatchNorm(cin), jl.ReLU(), jl.Conv2d(cin, cmid, 3, bias=False),
               jl.BatchNorm(cmid), jl.ReLU(), jl.Conv2d(cmid, cmid, 3, bias=False)]
    params = []
    s = shape
    for i, l in enumerate(jlayers):
        pp, s = l.init(jax.random.fold_in(jax.random.key(0), i), s)
        params.append(pp)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    cell = LayerCell([L.BatchNorm(cin), L.ReLU(), L.Conv2d(cin, cmid, 3, bias=False),
                      L.BatchNorm(cmid), L.ReLU(), L.Conv2d(cmid, cmid, 3, bias=False)])
    from_jax_params(params, cell)
    return jlayers, params, list(cell.layers)


def _jax_sink(sink, jlayers, params):
    """JAX's sink (keyed by leaf id) as {BatchNorm index: (mean, var)}."""
    out = {}
    for i, (l, p) in enumerate(zip(jlayers, params)):
        if "mean" in p:
            out[i] = (np.asarray(sink[id(p["mean"])]), np.asarray(sink[id(p["var"])]))
    return out


@pytest.mark.parametrize("exact", ["1", "0"])
def test_stripe_run_matches_jax(monkeypatch, exact):
    """Unsharded (``all``), budget 4000 B: values, deposits and input
    gradients as JAX's; exact statistics also equal the pad-once run."""
    from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx
    from mpi4dl_tpu.ops import stripe_bwd as jsb

    monkeypatch.setenv("MPI4DL_STRIPE_BWD", "all")
    monkeypatch.setenv("MPI4DL_STRIPE_BUDGET", "4000")
    monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", exact)
    jlayers, params, layers = _stack()
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 16, 12, 4)))
    jparams = jax.tree.map(jnp.asarray, params)

    def jrun(xx, sink=None):
        y = jsb.maybe_stripe_run(jlayers, jparams, xx, JApplyCtx(train=True, bn_sink=sink))
        assert y is not None
        return y

    jsink = {}
    y_j = np.asarray(jrun(jnp.asarray(x), jsink))
    g_j = np.asarray(jax.grad(lambda xx: jnp.sum(jrun(xx) ** 2))(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    sink = {}
    y = sb.maybe_stripe_run(layers, xt, ApplyCtx(train=True, bn_sink=sink))
    assert y is not None, "stripe run did not engage"
    (g,) = torch.autograd.grad((y ** 2).sum(), xt)
    np.testing.assert_allclose(y.detach().numpy(), y_j, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, atol=1e-4)
    want = _jax_sink(jsink, jlayers, jparams)
    assert len(sink) == len(want) == 2
    for i, (m, v) in want.items():
        np.testing.assert_allclose(sink[layers[i]][0].numpy(), m, atol=1e-5)
        np.testing.assert_allclose(sink[layers[i]][1].numpy(), v, atol=1e-5)
    m = accumulated_halo(layers)[0]
    emu = SpatialCtx(axis_h="sph", grid_h=4, bn_cross_tile=False, stat_local=True)
    with torch.no_grad():
        y_e = apply_layers_premargin(layers, torch.nn.functional.pad(
            torch.from_numpy(x.copy()), (0, 0, 0, 0, m, m)), ApplyCtx(train=True, spatial=emu),
            m, 0)[0].numpy()
    close = np.allclose(y.detach().numpy(), y_e, atol=1e-5)
    assert close == (exact == "1")


def test_stripe_count_invariance(monkeypatch):
    """2 and 4 stripes (budgets 6144 and 3072 B over the 12288-B widest
    intermediate) give the same values and gradients under exact
    statistics."""
    monkeypatch.setenv("MPI4DL_STRIPE_BWD", "all")
    monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", "1")
    _, _, layers = _stack()
    x = np.asarray(jax.random.normal(jax.random.key(2), (2, 16, 12, 4)))
    outs = []
    for budget, want in ((6144, 2), (3072, 4)):
        monkeypatch.setenv("MPI4DL_STRIPE_BUDGET", str(budget))
        plan = sb._pick_stripes(16, sb._widest_row_bytes(layers, x.shape, 4))
        assert plan is not None and plan[0] == want
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y = sb.maybe_stripe_run(layers, xt, ApplyCtx(train=True))
        (g,) = torch.autograd.grad((y ** 2).sum(), xt)
        outs.append((y.detach().numpy(), g.numpy()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-5)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=1e-4)


def test_stripe_gates(monkeypatch):
    """Off without the hatch; ``1`` stripes sharded blocks only; a budget
    that one stripe meets, trivial or strided runs, a margin-carrying or
    striped context and a non-4-D activation stay on the plain path — the
    JAX gate's answers, case by case."""
    from mpi4dl_tpu import layers as jl
    from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, SpatialCtx as JSpatialCtx
    from mpi4dl_tpu.ops import stripe_bwd as jsb

    jlayers, _, layers = _stack()
    shape = (2, 16, 12, 4)

    def both(env, spatial=None, jspatial=None, run=None, jrun=None, shp=shape):
        for k, v in env.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        got = sb.stripe_run_eligible(run or layers, shp, ApplyCtx(train=True, spatial=spatial))
        want = jsb.stripe_run_eligible(jrun or jlayers, shp,
                                       JApplyCtx(train=True, spatial=jspatial))
        assert got == want, (env, spatial)
        return got

    assert not both({"MPI4DL_STRIPE_BWD": None})
    assert not both({"MPI4DL_STRIPE_BWD": "1", "MPI4DL_STRIPE_BUDGET": "4000"})
    assert both({}, SpatialCtx(axis_w="spw", grid_w=2, tiles=TileGrid(1, 2)),
                JSpatialCtx(axis_w="spw", grid_w=2))
    assert both({"MPI4DL_STRIPE_BWD": "all"})
    assert not both({"MPI4DL_STRIPE_BUDGET": str(1 << 30)})
    monkeypatch.setenv("MPI4DL_STRIPE_BUDGET", "4000")
    assert not both({}, run=[L.Identity()], jrun=[jl.Identity()])
    assert not both({}, run=[L.ReLU()], jrun=[jl.ReLU()])
    assert not both({}, run=[L.Pool2d("max", 3, 2, 1)], jrun=[jl.Pool2d("max", 3, 2, 1)])
    assert not both({}, SpatialCtx(axis_h="sph", grid_h=2, halo_pre_exchanged=True,
                                   tiles=TileGrid(2, 1)),
                    JSpatialCtx(axis_h="sph", grid_h=2, halo_pre_exchanged=True))
    assert not both({}, SpatialCtx(axis_h="sph", grid_h=2, stat_local=True),
                    JSpatialCtx(axis_h="sph", grid_h=2, stat_local=True))
    assert not both({}, shp=(2, 16, 12))
    assert sb.maybe_stripe_run(layers, (torch.ones(shape),), ApplyCtx(train=True)) is None


@pytest.mark.parametrize("exact", ["1", "0"])
def test_stripe_run_sharded_matches_jax(monkeypatch, devices8, exact):
    """A block on the 2x2 grid, striped (budget 2000 B): values and
    gradients (input and parameters) as JAX's under ``shard_map``."""
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, SpatialCtx as JSpatialCtx
    from mpi4dl_tpu.mesh import MeshSpec, build_mesh
    from mpi4dl_tpu.ops import stripe_bwd as jsb

    monkeypatch.setenv("MPI4DL_STRIPE_BWD", "1")
    monkeypatch.setenv("MPI4DL_STRIPE_BUDGET", "2000")
    monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", exact)
    jlayers, params, layers = _stack(shape=(2, 16, 16, 4))
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 16, 16, 4)))
    jsp = JSpatialCtx(axis_h="sph", axis_w="spw", grid_h=2, grid_w=2)
    mesh = build_mesh(MeshSpec(sph=2, spw=2), devices8[:4])
    spec = P(None, "sph", "spw", None)
    jparams = jax.tree.map(jnp.asarray, params)

    def f(ps, xt):
        y = jsb.maybe_stripe_run(jlayers, ps, xt, JApplyCtx(train=True, spatial=jsp))
        assert y is not None
        return y

    sm = shard_map(f, mesh=mesh, in_specs=(P(), spec), out_specs=spec)
    y_j = np.asarray(jax.jit(sm)(jparams, jnp.asarray(x)))
    gp_j, gx_j = jax.jit(jax.grad(lambda ps, xx: jnp.sum(sm(ps, xx) ** 2),
                                  argnums=(0, 1)))(jparams, jnp.asarray(x))
    grid = TileGrid(2, 2)
    sp = SpatialCtx(axis_h="sph", axis_w="spw", grid_h=2, grid_w=2, tiles=grid)
    xt = grid.scatter(torch.from_numpy(x.copy())).requires_grad_(True)
    y = sb.maybe_stripe_run(layers, xt, ApplyCtx(train=True, spatial=sp))
    assert y is not None, "stripe run did not engage"
    full = grid.gather(y)
    tparams = [p for l in layers for p in l.parameters()]
    grads = torch.autograd.grad((full ** 2).sum(), [xt] + tparams)
    np.testing.assert_allclose(full.detach().numpy(), y_j, atol=1e-5)
    np.testing.assert_allclose(grid.gather(grads[0]).numpy(), np.asarray(gx_j),
                               rtol=2e-4, atol=5e-4)
    # The port's parameters in module order: BatchNorm scale, bias; conv kernel.
    want = [np.asarray(p[k]) for p in gp_j for k in ("scale", "bias", "kernel") if k in p]
    assert len(grads) - 1 == len(want)
    for g, b in zip(grads[1:], want):
        np.testing.assert_allclose(g.numpy(), b, rtol=2e-4, atol=5e-4)


def _stripe_model(batch=4):
    """``test_sp_engine_stripe_matches_d2``'s model: a stem, one stride-1
    v2 bottleneck, a pool head; junction after cell 2."""
    from mpi4dl_tpu.cells import CellModel as JCellModel, LayerCell as JLayerCell
    from mpi4dl_tpu import layers as jl
    from mpi4dl_tpu.models.resnet import ResBlockV2 as JResBlockV2
    from mpi4dl_tpu_torch.cells import CellModel
    from mpi4dl_tpu_torch.models.resnet import ResBlockV2

    jm = JCellModel([
        JLayerCell([jl.Conv2d(3, 16, 3, padding=1, bias=False), jl.BatchNorm(16),
                    jl.ReLU()], name="stem"),
        JResBlockV2(16, 8, 16, 1, first_block=True, pre_activation=True),
        JLayerCell([jl.Pool2d("avg", 8), jl.Flatten(), jl.Dense(16 * 4 * 4, 10)],
                   name="head")], (batch, 32, 32, 3), 10, spatial_until=2)
    params, _ = jm.init(jax.random.key(0))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    m = CellModel([
        LayerCell([L.Conv2d(3, 16, 3, padding=1, bias=False), L.BatchNorm(16), L.ReLU()],
                  name="stem"),
        ResBlockV2(16, 8, 16, 1, first_block=True, pre_activation=True),
        LayerCell([L.Pool2d("avg", 8), L.Flatten(), L.Dense(16 * 4 * 4, 10)],
                  name="head")], (batch, 32, 32, 3), 10)
    from_jax_params(params, m)
    m.spatial_until = 2
    return jm, params, m


def test_sp_engine_stripe_matches_jax_and_d2(monkeypatch, devices8):
    """The SP step (2x2 grid, junction before the head, cell remat) with
    striping on and exact statistics: two SGD steps as JAX's striped step,
    and as the port's D2 step (the pad-once oracle)."""
    from mpi4dl_tpu.layer_ctx import SpatialCtx as JSpatialCtx
    from mpi4dl_tpu.mesh import MeshSpec, build_mesh
    from mpi4dl_tpu.train import (
        Optimizer as JOptimizer, TrainState as JTrainState, make_spatial_train_step as j_step,
    )
    from mpi4dl_tpu_torch.params import to_jax_layout
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

    monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", "1")
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, 32, 32, 3)))
    y = np.arange(4) % 10

    def port(d2):
        _, _, m = _stripe_model()
        sp = SpatialCtx(axis_h="sph", axis_w="spw", grid_h=2, grid_w=2, d2_mode=d2,
                        tiles=TileGrid(2, 2))
        opt = Optimizer("sgd", lr=0.01)
        step = make_spatial_train_step(m, opt, sp, remat=True)
        state = TrainState.create(m, opt)
        losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))[1]["loss"])
                  for _ in range(2)]
        return losses, jax.tree.leaves(to_jax_layout(m))

    monkeypatch.delenv("MPI4DL_STRIPE_BWD", raising=False)
    l_d2, p_d2 = port(True)
    monkeypatch.setenv("MPI4DL_STRIPE_BWD", "1")
    monkeypatch.setenv("MPI4DL_STRIPE_BUDGET", "16384")
    l_st, p_st = port(False)
    jm, params, _ = _stripe_model()
    jopt = JOptimizer("sgd", lr=0.01)
    mesh = build_mesh(MeshSpec(sph=2, spw=2), devices8[:4])
    jstep = j_step(jm, jopt, mesh, JSpatialCtx(axis_h="sph", axis_w="spw", grid_h=2, grid_w=2),
                   spatial_until=2, remat=True)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, params), jopt)
    l_j = []
    for _ in range(2):
        jstate, mm = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        l_j.append(float(mm["loss"]))
    np.testing.assert_allclose(l_st, l_j, rtol=2e-5)
    np.testing.assert_allclose(l_st, l_d2, rtol=2e-5)
    for a, b, c in zip(p_st, jax.tree.leaves(jax.tree.map(np.asarray, jstate.params)), p_d2):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(a, c, rtol=2e-4, atol=1e-5)
    assert l_st[-1] < l_st[0]


def test_kernels_off_inside_stripes(monkeypatch):
    """With the kernels on, the block's stride-1 convs take K1 on the plain
    path and none inside a stripe (``stripe_bwd.py:323``)."""
    from mpi4dl_tpu_torch.ops import halo_conv

    _, _, layers = _stack(shape=(2, 16, 16, 4))
    sp = SpatialCtx(axis_h="sph", axis_w="spw", grid_h=2, grid_w=2, tiles=TileGrid(2, 2),
                    use_pallas_conv=True)
    x = torch.randn(4 * 2, 8, 8, 4)
    counts = []
    for mode in ("0", "1"):
        monkeypatch.setenv("MPI4DL_STRIPE_BWD", mode)
        monkeypatch.setenv("MPI4DL_STRIPE_BUDGET", "2000")
        with halo_conv.count_dispatches() as seen:
            LayerCell(layers)(x, ApplyCtx(train=True, spatial=sp))
        counts.append(seen.counts["halo_conv2d"] + seen.counts["halo_conv2d_stats"])
    assert counts == [2, 0]
