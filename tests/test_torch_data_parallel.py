"""The data axis, the ``batch_split`` junction (``--local-DP``) and the
tail-gradient reduction (C1) of the PyTorch port, against the JAX package
on the CPU.

- SP with the ``batch_split`` junction at degree 2 (gather and slice) and
  4 (one all_to_all) on a 2x2 grid, BatchNorm in the tail (each shard
  normalised with its own statistics), against the JAX
  ``make_spatial_train_step(junction="batch_split")`` in ``shard_map`` on
  the virtual CPU mesh, on the one-process grid and on four gloo ranks;
  and with a data axis (2 replicas x 1x2 tiles on four ranks) against the
  JAX step with ``with_data_axis=True``.  Two SGD steps: losses rtol 1e-4,
  parameters rtol 2e-3 / atol 1e-5 (``tests/test_multilevel.py``'s
  ``_run_pair``).
- DP on the single-device step (four gloo ranks, one slice of the batch
  each, BatchNorm statistics of the slice) against the JAX single-device
  step accumulated over the same four micro-batches: the same tolerances.
- C1: on four gloo ranks with a replicated tail (``gather``), rank 1's
  tail gradients get a perturbation (``torch.autograd.grad`` wrapped on
  that rank); after two steps the tail's parameters and running statistics
  are bitwise equal on every rank, because the step averages the tail's
  gradients over the tile ranks.

The ranks are this file run as a script (``test_torch_ring.py``'s
launcher); JAX is imported inside the tests only.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import cells as tc, layers as tl
from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for
from mpi4dl_tpu_torch.parallel.tiles import TileGrid
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

LR = 0.01
SHAPE = (4, 32, 32, 3)
SU = 2  # the spatial region: cells 0-1; cell 2 (conv, BN, ReLU) and the head are the tail
WORLD = 4


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _layers(lib):
    return [
        [lib.Conv2d(3, 8, 3), lib.BatchNorm(8), lib.ReLU()],
        [lib.Conv2d(8, 8, 3, stride=2), lib.BatchNorm(8), lib.ReLU()],
        [lib.Conv2d(8, 8, 3), lib.BatchNorm(8), lib.ReLU()],
        [lib.Flatten(), lib.Dense(8 * 16 * 16, 10)],
    ]


def _port_model(shape=SHAPE):
    cells = [tc.LayerCell(ls, name=f"c{i}") for i, ls in enumerate(_layers(tl))]
    model = tc.CellModel(cells, shape, 10)
    model.spatial_until = SU
    return model


def _jax_model(shape=SHAPE):
    from mpi4dl_tpu import cells as jc, layers as jl

    cells = [jc.LayerCell(ls, name=f"c{i}") for i, ls in enumerate(_layers(jl))]
    return jc.CellModel(cells, shape, 10, spatial_until=SU)


def _params():
    import jax

    params, _ = _jax_model().init(jax.random.key(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _inputs(batch=4):
    return _randn(1, (batch, 32, 32, 3)), np.arange(batch, dtype=np.int64) % 10


def _port(params, shape=SHAPE):
    from mpi4dl_tpu_torch.params import from_jax_params

    model = _port_model(shape)
    from_jax_params(params, model)
    return model


def _train(step, state, x, y, steps=2):
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    return [float(step(state, x, y)[1]["loss"]) for _ in range(steps)]


def _jax_sp(params, local_dp, data=1, grid=(2, 2), junction="batch_split", batch=4):
    """Two steps of the JAX SP step: losses and the parameter leaves."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.layer_ctx import SpatialCtx
    from mpi4dl_tpu.mesh import MeshSpec, build_mesh
    from mpi4dl_tpu.train import (
        Optimizer as JOptimizer, TrainState as JTrainState, make_spatial_train_step as j_step,
    )

    gh, gw = grid
    sp = SpatialCtx(axis_h="sph" if gh > 1 else None, axis_w="spw", grid_h=gh, grid_w=gw)
    mesh = build_mesh(MeshSpec(data=data, sph=gh, spw=gw), jax.devices()[:data * gh * gw])
    opt = JOptimizer("sgd", lr=LR)
    step = j_step(_jax_model(), opt, mesh, sp, junction=junction, spatial_until=SU,
                  local_dp=local_dp, with_data_axis=data > 1)
    state = JTrainState.create(jax.tree.map(jnp.asarray, params), opt)
    x, y = _inputs(batch)
    losses = []
    for _ in range(2):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        losses.append(float(m["loss"]))
    return np.asarray(losses), [np.asarray(a) for a in jax.tree.leaves(state.params)]


def _check(losses, leaves, want):
    want_losses, want_leaves = want
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert len(leaves) == len(want_leaves)
    for a, b in zip(leaves, want_leaves):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5)


def _leaves(model):
    import jax

    from mpi4dl_tpu_torch.params import to_jax_layout

    return jax.tree.leaves(to_jax_layout(model))


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def jax_refs(params):
    """The JAX references every test of this file compares with."""
    refs = {f"bs{d}": _jax_sp(params, d) for d in (2, 4)}
    refs["data_bs2"] = _jax_sp(params, 2, data=2, grid=(1, 2), batch=8)
    refs["data_gather"] = _jax_sp(params, None, data=2, grid=(1, 2), junction="gather",
                                  batch=8)
    refs["dp"] = _jax_accumulated(params, 4)
    return refs


def _jax_accumulated(params, parts):
    """The JAX single-device step over the batch of 8 accumulated over
    ``parts`` micro-batches: DP's arithmetic with per-replica BatchNorm."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.train import Optimizer as JOptimizer, TrainState as JTrainState
    from mpi4dl_tpu.train import make_train_step

    opt = JOptimizer("sgd", lr=LR)
    step = make_train_step(_jax_model((8, 32, 32, 3)), opt, parts=parts)
    state = JTrainState.create(jax.tree.map(jnp.asarray, params), opt)
    x, y = _inputs(8)
    losses = []
    for _ in range(2):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        losses.append(float(m["loss"]))
    return np.asarray(losses), [np.asarray(a) for a in jax.tree.leaves(state.params)]


@pytest.mark.parametrize("degree", [2, 4])
def test_batch_split_on_grid_matches_jax(devices8, params, jax_refs, degree):
    """The one-process grid: the tail runs the whole batch with one set of
    BatchNorm statistics per shard."""
    model = _port(params)
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2))
    opt = Optimizer("sgd", lr=LR)
    step = make_spatial_train_step(model, opt, sp, spatial_until=SU,
                                   junction="batch_split", local_dp=degree)
    losses = _train(step, TrainState.create(model, opt), *_inputs())
    _check(losses, _leaves(model), jax_refs[f"bs{degree}"])


def test_batch_split_shard_statistics_differ_from_whole_batch(params):
    """Per-shard statistics are not the whole batch's: the degree changes
    the step (a fold that computed batch-wide statistics would not)."""
    losses = []
    for degree in (1, 4):
        model = _port(params)
        sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2))
        opt = Optimizer("sgd", lr=LR)
        step = make_spatial_train_step(model, opt, sp, spatial_until=SU,
                                       junction="batch_split", local_dp=degree)
        losses.append(_train(step, TrainState.create(model, opt), *_inputs(), steps=1))
    assert abs(losses[0][0] - losses[1][0]) > 1e-4


# ---------------------------------------------------------------------------
# Four gloo ranks.
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from mpi4dl_tpu_torch import train as ttrain
    from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh
    from mpi4dl_tpu_torch.models import get_resnet_v2
    from mpi4dl_tpu_torch.train import make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    init = {k: torch.from_numpy(v) for k, v in np.load(workdir / "init.npz").items()}
    out = {}

    def fresh(shape=SHAPE):
        m = _port_model(shape)
        m.load_state_dict(init)
        return m

    def state_of(model):
        return [t.detach().numpy().copy() for t in model.state_dict().values()]

    opt = Optimizer("sgd", lr=LR)
    grid = build_process_mesh(MeshSpec(sph=2, spw=2))
    for degree in (2, 4):
        m = fresh()
        sp = spatial_ctx_for("square", 4, tiles=grid.tiles)
        step = make_spatial_train_step(m, opt, sp, spatial_until=SU,
                                       junction="batch_split", local_dp=degree)
        out[f"bs{degree}_losses"] = _train(step, TrainState.create(m, opt), *_inputs())
        for i, t in enumerate(state_of(m)):
            out[f"bs{degree}_{i}"] = t

    mesh = build_process_mesh(MeshSpec(data=2, spw=2))
    for name, junction, local_dp in (("data_bs2", "batch_split", 2),
                                     ("data_gather", "gather", None)):
        m = fresh((8, 32, 32, 3))
        sp = spatial_ctx_for("vertical", 2, tiles=mesh.tiles)
        step = make_spatial_train_step(m, opt, sp, spatial_until=SU, junction=junction,
                                       local_dp=local_dp, with_data_axis=mesh.data)
        out[f"{name}_losses"] = _train(step, TrainState.create(m, opt), *_inputs(8))
        for i, t in enumerate(state_of(m)):
            out[f"{name}_{i}"] = t

    dp = build_process_mesh(MeshSpec(data=4))
    m = fresh((8, 32, 32, 3))
    step = make_train_step(m, opt, with_data_axis=dp.data)
    out["dp_losses"] = _train(step, TrainState.create(m, opt), *_inputs(8))
    for i, t in enumerate(state_of(m)):
        out[f"dp_{i}"] = t

    # C1: a replicated tail whose gradients differ on one rank.
    model = get_resnet_v2((2, 32, 32, 3), 11, 10, device="cpu", seed=3)
    su = 3
    tail = {id(p) for cell in model.cells[su:] for p in cell.parameters()}
    params = [p for p in model.parameters() if p.requires_grad]
    real_grad = torch.autograd.grad

    def perturbed(outputs, inputs, *a, **k):
        grads = real_grad(outputs, inputs, *a, **k)
        if rank == 1 and len(inputs) == len(params) and all(
                a is b for a, b in zip(inputs, params)):
            grads = tuple(g + 1e-3 if id(p) in tail else g for g, p in zip(grads, inputs))
        return grads

    ttrain.torch.autograd.grad = perturbed
    try:
        sp = spatial_ctx_for("square", 4, tiles=grid.tiles)
        step = make_spatial_train_step(model, opt, sp, spatial_until=su)
        _train(step, TrainState.create(model, opt), _randn(5, (2, 32, 32, 3)),
               np.arange(2, dtype=np.int64))
    finally:
        ttrain.torch.autograd.grad = real_grad
    for i, (k, t) in enumerate(model.cells[su:].state_dict().items()):
        out[f"c1_{i}"] = t.detach().numpy().copy()
    np.savez(workdir / f"out{rank}.npz", **out)
    dist.destroy_process_group()


def test_gloo_ranks_match_jax_and_agree_on_the_tail(tmp_path, devices8, params, jax_refs):
    """Four gloo ranks: ``batch_split`` at degrees 2 and 4 on one tile a
    rank; the data axis with ``batch_split`` and ``gather``; DP on the
    single-device step; and C1's perturbed tail, bitwise equal on every
    rank after two steps."""
    from test_torch_ring import launch_gloo_ranks

    model = _port(params)
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    launch_gloo_ranks("dp", tmp_path, world=WORLD, script=__file__)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    n = len(model.state_dict())
    ref = _port_model()
    for name in ("bs2", "bs4", "data_bs2", "data_gather", "dp"):
        for r, out in enumerate(outs):
            ref.load_state_dict({k: torch.from_numpy(out[f"{name}_{i}"])
                                 for i, k in enumerate(model.state_dict())})
            assert n == len([k for k in out.files if k.startswith(f"{name}_")]) - 1
            _check(np.asarray(out[f"{name}_losses"]), _leaves(ref), jax_refs[name])
    keys = sorted(k for k in outs[0].files if k.startswith("c1_"))
    assert keys
    for k in keys:
        for r in range(1, WORLD):
            np.testing.assert_array_equal(outs[r][k], outs[0][k], err_msg=f"{k} rank {r}")


if __name__ == "__main__":
    _job, _rank, _world, _dir = sys.argv[1:5]
    _rank_main(int(_rank), int(_world), Path(_dir))
