"""The H-striped layer run of the PyTorch port (``ops/hstripe_conv.py``,
dispatched from ``models/resnet.ResBlockV2``) against the JAX package's
``hstripe_layer_run`` and v2 residual block on the CPU.

As ``tests/test_hstripe.py`` does, ``_RUN_MIN_PIXELS`` and
``_RUN_STRIPE_BUDGET`` are lowered (in both modules) so that a small input
is striped.  Per-stripe and exact (``MPI4DL_HSTRIPE_EXACT=1``) statistics,
train and eval: outputs within atol 1e-5, gradients rtol 1e-4 / atol
1e-5, running statistics atol 1e-6; two training steps of a one-block
model within the JAX GEMS tests' bounds (loss rtol 1e-4, parameters rtol
2e-3 / atol 1e-5).  The gate's decision agrees with the JAX gate at the
real thresholds (shapes only), and a near-prime height falls back.

The striped conv ``hstripe_conv2d`` (``tests/test_hstripe.py``'s cases,
``_PATCH_BUDGET`` lowered in both packages): values atol 1e-5 and VJPs
atol 1e-4 against JAX's ``hstripe_conv2d``.  No layer of the port
dispatches it (slower on an H100, PERF.md §6).
"""

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import layers as L
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
from mpi4dl_tpu_torch.ops import hstripe_conv as hc

X_SHAPE = (2, 16, 12, 4)


def _small(monkeypatch, budget):
    """Stripe small inputs, in both packages."""
    from mpi4dl_tpu.ops import hstripe_conv as jhc

    for mod in (hc, jhc):
        monkeypatch.setattr(mod, "_RUN_MIN_PIXELS", 1)
        monkeypatch.setattr(mod, "_RUN_STRIPE_BUDGET", budget)
    return jhc


def _run_layers():
    """The JAX run (layers, params) and its port twin with the same
    weights: BN → ReLU → 3x3 → BN → ReLU → 3x3 (the JAX exact test's)."""
    import jax

    from mpi4dl_tpu import layers as JL

    jl = [JL.BatchNorm(4), JL.ReLU(), JL.Conv2d(4, 8, 3, bias=False),
          JL.BatchNorm(8), JL.ReLU(), JL.Conv2d(8, 8, 3)]
    pl = [L.BatchNorm(4), L.ReLU(), L.Conv2d(4, 8, 3, bias=False),
          L.BatchNorm(8), L.ReLU(), L.Conv2d(8, 8, 3)]
    params, shape = [], X_SHAPE
    for i, layer in enumerate(jl):
        p, shape = layer.init(jax.random.fold_in(jax.random.key(0), i), shape)
        if "mean" in p:  # running statistics away from their init
            rng = np.random.default_rng(i)
            p = dict(p, mean=rng.standard_normal(p["mean"].shape).astype(np.float32),
                     var=rng.uniform(0.5, 2.0, p["var"].shape).astype(np.float32))
        params.append(p)
    with torch.no_grad():
        for p, layer in zip(params, pl):
            for k, v in p.items():
                getattr(layer, k).copy_(torch.from_numpy(np.array(v)))
    return jl, params, pl


@pytest.mark.parametrize("train,exact", [(True, False), (True, True), (False, False)])
def test_layer_run_matches_jax(monkeypatch, train, exact):
    """``hstripe_layer_run``: outputs, the gradients of a random projection
    for the input and every parameter, and the running statistics."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.layer_ctx import ApplyCtx as JCtx

    jhc = _small(monkeypatch, 4000)
    if exact:
        monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", "1")
    jl, params, pl = _run_layers()
    rng = np.random.default_rng(1)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    t = rng.standard_normal((2, 16, 12, 8)).astype(np.float32)

    def jax_run(x, ps, sink=None):
        y = jhc.hstripe_layer_run(jl, ps, x, JCtx(train=train, bn_sink=sink))
        assert y is not None
        return jnp.sum(y * t), y

    (_, jy), (jgx, jgp) = jax.value_and_grad(jax_run, (0, 1), has_aux=True)(
        jnp.asarray(x), params)
    jsink = {}  # keyed by the id of each running-statistics array
    if train:
        jax_run(jnp.asarray(x), params, jsink)
    xt = torch.from_numpy(x).requires_grad_()
    sink = {} if train else None
    y = hc.hstripe_layer_run(pl, xt, ApplyCtx(train=train, bn_sink=sink))
    assert y is not None
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    wrt = [xt] + [p for layer in pl for p in layer.parameters()]
    got = torch.autograd.grad((y * torch.from_numpy(t)).sum(), wrt)
    want = [np.asarray(jgx)] + [np.asarray(g[k]) for g, layer in zip(jgp, pl)
                                for k, _ in layer.named_parameters()]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
    if train:
        bns = [i for i, layer in enumerate(pl) if isinstance(layer, L.BatchNorm)]
        assert set(sink) == {pl[i] for i in bns}
        for i in bns:
            for k, v in zip(("mean", "var"), sink[pl[i]]):
                np.testing.assert_allclose(v.numpy(), np.asarray(jsink[id(params[i][k])]),
                                           atol=1e-6)


def test_exact_mode_differs_from_per_stripe(monkeypatch):
    """The two statistics modes give different train-mode outputs on this
    fixture, so each test above holds what it names."""
    _small(monkeypatch, 4000)
    _, _, pl = _run_layers()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(X_SHAPE).astype(np.float32))
    ys = []
    for exact in ("0", "1"):
        monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", exact)
        with torch.no_grad():
            ys.append(hc.hstripe_layer_run(pl, x, ApplyCtx(train=True)))
    assert not torch.allclose(ys[0], ys[1], atol=1e-5)


def _block_models(batch=2, size=16):
    """A stride-1 v2 bottleneck block and a dense head, in both packages,
    with the same weights."""
    import jax

    from mpi4dl_tpu.cells import CellModel as JCellModel, LayerCell as JLayerCell
    from mpi4dl_tpu.layers import Dense as JDense, Flatten as JFlatten
    from mpi4dl_tpu.models.resnet import ResBlockV2 as JBlock
    from mpi4dl_tpu_torch.cells import CellModel, LayerCell
    from mpi4dl_tpu_torch.models.resnet import ResBlockV2
    from mpi4dl_tpu_torch.params import from_jax_params

    shape = (batch, size, size, 8)
    jm = JCellModel([JBlock(8, 4, 8, 1, first_block=False, pre_activation=True),
                     JLayerCell([JFlatten(), JDense(8 * size * size, 10)], name="head")],
                    shape, 10)
    params, _ = jm.init(jax.random.key(2))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    pm = CellModel([ResBlockV2(8, 4, 8, 1, first_block=False, pre_activation=True),
                    LayerCell([L.Flatten(), L.Dense(8 * size * size, 10)], name="head")],
                   shape, 10)
    from_jax_params(params, pm)
    return jm, params, pm


@pytest.mark.parametrize("exact", [False, True])
def test_resblock_v2_striped_trains_as_jax(monkeypatch, exact):
    """Two SGD steps of a striped v2 block + head against the JAX
    single-device step: losses rtol 1e-4; parameters and running
    statistics rtol 2e-3 / atol 1e-5.  The striped run really engages (the
    unstriped block gives another first loss)."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.train import Optimizer as JOpt, TrainState as JState
    from mpi4dl_tpu.train import make_train_step as j_make_train_step
    from mpi4dl_tpu_torch.params import to_jax_layout
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    _small(monkeypatch, 8000)
    if exact:
        monkeypatch.setenv("MPI4DL_HSTRIPE_EXACT", "1")
    jm, params, pm = _block_models()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    y = np.array([1, 7], np.int64)
    jstep = j_make_train_step(jm, JOpt("sgd", lr=0.05))
    jstate = JState.create(jax.tree.map(jnp.asarray, params), JOpt("sgd", lr=0.05))
    step = make_train_step(pm, Optimizer("sgd", lr=0.05))
    state = TrainState.create(pm, Optimizer("sgd", lr=0.05))
    for _ in range(2):
        jstate, jm_ = jstep(jstate, jnp.asarray(x), jnp.asarray(y, np.int32))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-4)
    got = jax.tree.leaves(to_jax_layout(pm))
    want = jax.tree.leaves(jstate.params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3, atol=1e-5)

    _, _, plain = _block_models()
    monkeypatch.setenv("MPI4DL_NO_HSTRIPE", "1")
    with torch.no_grad():
        ctx = ApplyCtx(train=True)
        a = plain(torch.from_numpy(x), ctx)
        monkeypatch.delenv("MPI4DL_NO_HSTRIPE")
        _, _, again = _block_models()
        b = again(torch.from_numpy(x), ctx)
    assert not torch.allclose(a, b, atol=1e-4)


def test_resblock_v2_striped_eval_matches_jax(monkeypatch):
    """Eval mode (running statistics, no statistics deviation): the block's
    output equals the JAX block's."""
    import jax.numpy as jnp

    from mpi4dl_tpu.layer_ctx import ApplyCtx as JCtx

    _small(monkeypatch, 8000)
    jm, params, pm = _block_models(batch=1)
    x = np.random.default_rng(4).standard_normal((1, 16, 16, 8)).astype(np.float32)
    want = jm.cells[0].apply(params[0], jnp.asarray(x), JCtx(train=False))
    with torch.no_grad():
        got = pm.cells[0](torch.from_numpy(x), ApplyCtx(train=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_near_prime_height_falls_back(monkeypatch):
    """H = 59 has no reasonable stripe divisor: None, as in JAX."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.layer_ctx import ApplyCtx as JCtx
    from mpi4dl_tpu.layers import Conv2d as JConv

    jhc = _small(monkeypatch, 2000)
    jconv = JConv(4, 4, kernel_size=3, padding=1)
    params, _ = jconv.init(jax.random.key(3), (1, 59, 8, 4))
    assert jhc.hstripe_layer_run([jconv], [params], jnp.ones((1, 59, 8, 4)),
                                 JCtx(train=True)) is None
    conv = L.Conv2d(4, 4, kernel_size=3, padding=1)
    assert hc.hstripe_layer_run([conv], torch.ones((1, 59, 8, 4)),
                                ApplyCtx(train=True)) is None


@pytest.mark.parametrize("env", [{}, {"MPI4DL_HSTRIPE_RUN": "0"}, {"MPI4DL_HSTRIPE_RUN": "1"}])
def test_gate_agrees_with_jax_at_the_real_thresholds(monkeypatch, env):
    """``hstripe_run_eligible`` at 2^22 pixels / 64 channels, shapes only:
    the v2 branches of ResNet (stride 1 and 2) over inputs either side of
    the gates, with no context, the kernel knob's context and a real
    spatial one."""
    from mpi4dl_tpu.layer_ctx import ApplyCtx as JCtx, SpatialCtx as JSp
    from mpi4dl_tpu.models.resnet import ResBlockV2 as JBlock
    from mpi4dl_tpu.ops import hstripe_conv as jhc
    from mpi4dl_tpu_torch.models.resnet import ResBlockV2

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ctxs = [(ApplyCtx(train=True), JCtx(train=True)),
            (ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True)),
             JCtx(train=True, spatial=JSp(use_pallas_conv=True))),
            (ApplyCtx(train=False), JCtx(train=False))]
    shapes = [(1, 2048, 2048, 16), (1, 2048, 2048, 64), (1, 2048, 2048, 65),
              (2, 1024, 1024, 16), (1, 4096, 1024, 64), (1, 2048, 2047, 16),
              (1, 8192, 8192, 3)]
    decided = []
    for args in ((64, 16, 64, 1, False, True), (64, 16, 64, 2, True, True),
                 (16, 16, 64, 1, True, False)):
        blk, jblk = ResBlockV2(*args), JBlock(*args)
        branch = list(blk.r1.layers) + list(blk.r2.layers) + list(blk.r3.layers)
        jbranch = list(jblk.r1.layers) + list(jblk.r2.layers) + list(jblk.r3.layers)
        for shape in shapes:
            for ctx, jctx in ctxs:
                want = jhc.hstripe_run_eligible(jbranch, shape, jctx)
                assert hc.hstripe_run_eligible(branch, shape, ctx) == want, (args, shape)
                decided.append(want)
    assert any(decided) == (env.get("MPI4DL_HSTRIPE_RUN") != "0")
    assert not all(decided)


# ---------------------------------------------------------------------------
# hstripe_conv2d: one conv, H stripe by H stripe.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kh,kw,h,w,cin,cout,ph,pw", [
    (3, 3, 16, 12, 4, 6, (1, 1), (1, 1)),
    (1, 1, 16, 12, 4, 6, (0, 0), (0, 0)),
    (3, 1, 18, 10, 3, 5, (1, 1), (0, 0)),
    (5, 5, 20, 16, 2, 4, (2, 2), (2, 2)),
    (3, 3, 17, 11, 4, 6, (1, 2), (0, 1)),
    (3, 3, 18, 12, 4, 6, (0, 0), (0, 0)),
    (3, 3, 61, 8, 4, 4, (0, 0), (0, 0)),  # oh 59, prime: a ragged last stripe
])
def test_hstripe_conv2d_matches_jax(monkeypatch, kh, kw, h, w, cin, cout, ph, pw):
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.ops import hstripe_conv as jhc

    for mod in (hc, jhc):
        monkeypatch.setattr(mod, "_PATCH_BUDGET", 4000)
    rng = np.random.default_rng(kh * 100 + h)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((kh, kw, cin, cout)) / (kh * kw)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a, b: jhc.hstripe_conv2d(a, b, ph, pw), jnp.asarray(x),
                       jnp.asarray(wk))
    t = rng.standard_normal(y_j.shape).astype(np.float32)
    gx_j, gw_j = vjp(jnp.asarray(t))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(wk).requires_grad_(True)
    y = hc.hstripe_conv2d(xt, wt, ph, pw)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(t))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), atol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), atol=1e-4)
