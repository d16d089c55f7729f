"""D2 fused halo runs of the port (mpi4dl_tpu_torch/ops/d2.py, the
AmoebaNet cell plan) against a single-device pad-once emulation, the
per-conv D1 path and the JAX package (``tests/test_d2.py``); and the
process-group backend on four gloo ranks against the one-process grid.

Tolerances are the JAX test's: the conv-run emulation atol 2e-6, D2 == D1
where the margin is consumed before any normalisation and under a
one-layer cap exactly, mid-run BatchNorm atol 1e-5, the AmoebaNet cell
atol 1e-4, the fused K2 triple against the unfused path loss rtol 1e-5
and grads rtol 2e-4 / atol 1e-5; against JAX the test_spatial
tolerances.  The gloo ranks run this file as a script
(``python tests/test_torch_d2.py <job> <rank> <world> <dir>``, as
``tests/test_torch_ring.py`` does) and never import JAX; their D2
AmoebaNet step must agree with the one-process grid's, their halo
exchange on the arange image exactly.  The two run their reductions in
another order, and the toy AmoebaNet's gradients cancel (the D1 grid and
one device differ by 5e-4 of a tensor's largest update), so the step is
held to loss rtol 1e-5 and each tensor's update (parameters and running
statistics) within 1e-3 of its largest element, plus 1e-7.
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, SpatialCtx as JSpatialCtx
    from mpi4dl_tpu.mesh import MeshSpec, build_mesh
    from mpi4dl_tpu.models.amoebanet import AmoebaCell as JAmoebaCell
    from mpi4dl_tpu.models.amoebanet import amoebanetd as j_amoebanetd
    from mpi4dl_tpu.models.resnet import get_resnet_v2 as j_resnet_v2
    from mpi4dl_tpu.train import (
        Optimizer as JOptimizer, TrainState as JTrainState,
        make_spatial_train_step as j_make_spatial_train_step,
    )

from mpi4dl_tpu_torch.cells import LayerCell
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx, spatial_ctx_for
from mpi4dl_tpu_torch.layers import BatchNorm, Conv2d, Pool2d, ReLU
from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
from mpi4dl_tpu_torch.models.amoebanet import AmoebaCell
from mpi4dl_tpu_torch.ops.d2 import (
    accumulated_halo, apply_layers_premargin, can_fuse, premargin_out,
)
from mpi4dl_tpu_torch.parallel.tiles import TileGrid
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

WORLD = 4
GLOO_SHAPE = (2, 64, 64, 3)
GLOO_STEPS = 1


def _init_cell(cell, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for m in cell.modules():
        if hasattr(m, "reset_parameters") and m is not cell:
            m.reset_parameters(gen)
    return cell


def _randn(seed, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape)
                             * scale + shift).astype(np.float32))


def _sharded_apply(cell, x, sp):
    with torch.no_grad():
        return sp.tiles.gather(cell(sp.tiles.scatter(x), ApplyCtx(train=True, spatial=sp)))


def _vertical(**kw):
    return SpatialCtx(axis_w="spw", grid_w=4, tiles=TileGrid(1, 4), **kw)


def _emulate_d2(layers, x, hh, hw, sharded_h, sharded_w):
    """Single-device D2 semantics: pad the GLOBAL image once by the
    accumulated halo on the sharded dims, then run convs VALID there."""
    x = F.pad(x, (0, 0, hw if sharded_w else 0, hw if sharded_w else 0,
                  hh if sharded_h else 0, hh if sharded_h else 0))
    with torch.no_grad():
        for layer in layers:
            if isinstance(layer, Conv2d):
                kh, kw, sh, sw, ph, pw = layer._geometry()
                y = F.conv2d(x.permute(0, 3, 1, 2),
                             layer.kernel.permute(3, 2, 0, 1).contiguous(), stride=(sh, sw),
                             padding=(0 if sharded_h else ph, 0 if sharded_w else pw))
                x = y.permute(0, 2, 3, 1)
                if layer.bias is not None:
                    x = x + layer.bias
            elif isinstance(layer, ReLU):
                x = torch.relu(x)
            else:
                raise AssertionError(f"emulation does not support {layer}")
    return x


def _emulation_ctx():
    """An active context whose one "tile" is the whole padded image: the
    layers run margin-consuming and keep their statistics local."""
    return ApplyCtx(train=True, spatial=SpatialCtx(
        axis_w="spw", grid_w=4, bn_cross_tile=False, d2_mode=True, tiles=TileGrid(1, 1)))


@pytest.mark.parametrize("stride", [1, 2])
def test_d2_conv_run_semantics_exact(stride):
    cell = _init_cell(LayerCell([Conv2d(3, 8, 3, stride=stride), ReLU(),
                                 Conv2d(8, 8, 3), ReLU()]))
    x = _randn(1, (2, 32, 32, 3))
    sp = _vertical(d2_mode=True)
    assert can_fuse(cell.layers, sp)
    hh, hw = accumulated_halo(cell.layers)
    assert (hh, hw) == (1 + stride, 1 + stride)
    got = _sharded_apply(cell, x, sp)
    want = _emulate_d2(cell.layers, x, hh, hw, False, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


def test_d2_square_grid_semantics_exact():
    cell = _init_cell(LayerCell([Conv2d(3, 4, 3), ReLU(), Conv2d(4, 4, 3), ReLU()]))
    x = _randn(1, (1, 16, 16, 3))
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=True)
    got = _sharded_apply(cell, x, sp)
    want = _emulate_d2(cell.layers, x, 2, 2, True, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


def test_d2_equals_d1_when_conv_consumes_first():
    cell = _init_cell(LayerCell([Conv2d(3, 8, 3), BatchNorm(8), ReLU()]))
    x = _randn(1, (2, 32, 32, 3))
    out1 = _sharded_apply(cell, x, _vertical(d2_mode=False))
    out2 = _sharded_apply(cell, x, _vertical(d2_mode=True))
    assert torch.equal(out1, out2)


def test_d2_fused_layers_cap_equals_d1():
    cell = _init_cell(LayerCell([Conv2d(3, 8, 3), ReLU(), Conv2d(8, 8, 3), ReLU()]))
    x = _randn(1, (2, 32, 32, 3))
    out_d1 = _sharded_apply(cell, x, _vertical(d2_mode=False))
    out_cap = _sharded_apply(cell, x, _vertical(d2_mode=True, d2_max_fused=1))
    out_d2 = _sharded_apply(cell, x, _vertical(d2_mode=True))
    assert torch.equal(out_d1, out_cap)
    assert not torch.equal(out_d1, out_d2)  # the cap changed the exchange


def test_d2_bn_mid_run_stats_exact():
    """BatchNorm inside a fused run leaves the margin not yet consumed out
    of its statistics, so cross-tile statistics equal the pad-once global
    ones."""
    cell = _init_cell(LayerCell([Conv2d(3, 8, 3, bias=False), BatchNorm(8), ReLU(),
                                 Conv2d(8, 8, 3)]))
    x = _randn(1, (2, 32, 32, 3), scale=2.0, shift=0.5)
    got = _sharded_apply(cell, x, _vertical(d2_mode=True))
    hh, hw = accumulated_halo(cell.layers)
    with torch.no_grad():
        want, mh, mw = apply_layers_premargin(
            cell.layers, F.pad(x, (0, 0, hw, hw)), _emulation_ctx(), 0, hw)
    assert (mh, mw) == (0, 0) == premargin_out(cell.layers, _emulation_ctx(), 0, hw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_amoeba_cell_d2_plan_reproduces_reference_constants():
    """s1 margin 3, s2 margin 2 — the reference Cell_D2's constants — and
    the JAX package's whole plan."""
    cell = AmoebaCell(32, 32, 32, reduction=False, reduction_prev=False)
    plan = cell.d2_plan()
    assert plan["need"][0] == (3, 3)
    assert plan["need"][1] == (2, 2)
    jplan = JAmoebaCell(32, 32, 32, reduction=False, reduction_prev=False).d2_plan()
    assert plan["need"] == jplan["need"] and plan["margins"] == jplan["margins"]


def _emulate_cell_d2(cell, x):
    """Single-device mirror of AmoebaCell._apply_d2 (vertical sharding):
    pad each input state once by its planned margin, run the ops
    margin-consuming, realign by cropping."""
    need = cell.d2_plan()["need"]
    ctx = _emulation_ctx()

    def crop(t, cw):
        return t[:, :, cw:t.shape[2] - cw, :] if cw else t

    base = ApplyCtx(train=True)
    states = []
    for t, (_, nw) in ((cell.reduce1(x, base), need[0]), (cell.reduce2(x, base), need[1])):
        states.append((F.pad(t, (0, 0, nw, nw)), nw))
    for j in range(0, len(cell.ops), 2):
        tnw = need[2 + j // 2][1]
        outs = []
        for jj in (j, j + 1):
            t, mw = states[cell.indices[jj]]
            y, _, mwo = apply_layers_premargin(cell.ops[jj].layers, t, ctx, 0, mw)
            outs.append(crop(y, mwo - tnw))
        states.append((outs[0] + outs[1], tnw))
    return torch.cat([crop(*states[i]) for i in cell.concat], dim=-1)


def test_amoeba_cell_d2_matches_emulation():
    cell = _init_cell(AmoebaCell(32, 32, 32, reduction=False, reduction_prev=False))
    x = _randn(1, (1, 32, 32, 32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sp = _vertical(d2_mode=True)
        with torch.no_grad():
            out, skip = cell(sp.tiles.scatter(x), ApplyCtx(train=True, spatial=sp))
            got = sp.tiles.gather(out)
            want = _emulate_cell_d2(cell, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    assert torch.equal(sp.tiles.gather(skip), x)


def test_d2_pool_warning():
    sp = _vertical(d2_mode=True)
    x = torch.zeros((1, 32, 32, 8))

    def run(cell):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _sharded_apply(_init_cell(cell), x, sp)
        return [str(m.message) for m in w]

    assert any("pad-once" in m for m in run(LayerCell(
        [Conv2d(8, 8, 3), ReLU(), Pool2d("max", 3, stride=1, padding=1)])))
    assert not any("pad-once" in m for m in run(LayerCell(
        [Conv2d(8, 8, 3), ReLU(), Conv2d(8, 8, 3)])))


def test_d2_fused_triple_sharded_matches_unfused():
    """The K2 window under a sharded D2 run: the margin-excluding window
    and the cross-tile sum of its statistics give the unfused path's values
    and gradients."""
    cell = _init_cell(LayerCell([ReLU(), Conv2d(8, 8, 3, bias=False), BatchNorm(8),
                                 ReLU(), Conv2d(8, 8, 3, bias=False), BatchNorm(8)]))
    x = _randn(1, (2, 16, 16, 8))
    results = []
    for use_pallas in (False, True):
        sp = _vertical(d2_mode=True, use_pallas_conv=use_pallas)
        y = sp.tiles.gather(cell(sp.tiles.scatter(x), ApplyCtx(train=True, spatial=sp)))
        loss = (y * y).mean()
        results.append((float(loss.detach()), torch.autograd.grad(loss, list(cell.parameters()))))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_resnet_d2_train_step_matches_jax(devices8):
    """Two SGD steps of a D2 ResNet-11 v2 (vertical 4 tiles), port against
    JAX: the pad-once semantics are the same on both sides."""
    from mpi4dl_tpu_torch.params import from_jax_params, to_jax_layout

    shape = (4, 32, 32, 3)
    jmodel = j_resnet_v2(shape, depth=11)
    params, _ = jmodel.init(jax.random.key(0))
    x = _randn(2, shape).numpy()
    y = np.array([0, 1, 2, 3], np.int32)
    jsp = JSpatialCtx(axis_w="spw", grid_w=4, d2_mode=True)
    mesh = build_mesh(MeshSpec(spw=4), jax.devices()[:4])
    jopt = JOptimizer("sgd", lr=0.01)
    jstep = j_make_spatial_train_step(jmodel, jopt, mesh, jsp)
    jstate = JTrainState.create(params, jopt)
    tmodel = get_resnet_v2(shape, 11, device="cpu")
    from_jax_params(_np_tree(params), tmodel)
    opt = Optimizer("sgd", lr=0.01)
    step = make_spatial_train_step(tmodel, opt, _vertical(d2_mode=True))
    state = TrainState.create(tmodel, opt)
    losses = []
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        losses.append(float(m["loss"]))
    assert losses[1] < losses[0]
    for a, b in zip(jax.tree.leaves(to_jax_layout(tmodel)),
                    jax.tree.leaves(_np_tree(jstate.params))):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_amoebanet_d2_forward_matches_jax(devices8):
    from mpi4dl_tpu.parallel.spatial import apply_spatial_model as j_apply_spatial_model
    from mpi4dl_tpu_torch.parallel.spatial import apply_spatial_model
    from mpi4dl_tpu_torch.params import from_jax_params

    shape = (1, 64, 64, 3)
    jmodel = j_amoebanetd(shape, num_classes=10, num_layers=3, num_filters=64)
    params, _ = jmodel.init(jax.random.key(0))
    tmodel = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=64, device="cpu")
    from_jax_params(_np_tree(params), tmodel)
    x = _randn(5, shape)
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), d2_mode=True)
    jsp = JSpatialCtx(axis_h="sph", axis_w="spw", grid_h=2, grid_w=2, d2_mode=True)
    mesh = build_mesh(MeshSpec(sph=2, spw=2), jax.devices()[:4])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.no_grad():
            got = apply_spatial_model(tmodel, sp.tiles.scatter(x),
                                      ApplyCtx(train=True, spatial=sp), spatial_until=4)
        want = jax.jit(shard_map(
            lambda p, t: j_apply_spatial_model(jmodel, p, t, JApplyCtx(train=True, spatial=jsp),
                                               spatial_until=4),
            mesh=mesh, in_specs=(P(), P(None, "sph", "spw", None)),
            out_specs=P(None, None), check_vma=False))(params, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_d2_dispatch_counts_match_jax(devices8):
    """K1/K2 dispatches of the port's D2 step equal the JAX step's
    ``pallas_call`` count: ResNet (K1 on every stride-1 3x3 conv and its
    dx) and AmoebaNet (K2 on the [ReLU, Conv2d, BatchNorm] windows of the
    premargin runs, K1 as their dx)."""
    from test_torch_spatial import jax_step_pallas_calls, port_step_dispatches

    shape = (2, 32, 32, 3)
    jmodel = j_resnet_v2(shape, depth=11)
    params, _ = jmodel.init(jax.random.key(0))
    counts = port_step_dispatches(get_resnet_v2(shape, 11, device="cpu"), shape,
                                  d2_mode=True)
    assert counts == {"halo_conv2d": 10, "halo_conv2d_stats": 0}
    assert jax_step_pallas_calls(jmodel, params, shape, d2_mode=True) == counts

    shape = (1, 64, 64, 3)
    jmodel = j_amoebanetd(shape, num_classes=10, num_layers=3, num_filters=32)
    jmodel.spatial_until = 4
    params, _ = jmodel.init(jax.random.key(0))
    tmodel = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=32, device="cpu")
    tmodel.spatial_until = 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        counts = port_step_dispatches(tmodel, shape, d2_mode=True)
        n_jax = jax_step_pallas_calls(jmodel, params, shape, d2_mode=True)
    assert counts["halo_conv2d_stats"] > 0
    assert counts == n_jax


# ---------------------------------------------------------------------------
# Four gloo ranks: the process-group backend against the one-process grid.
# ---------------------------------------------------------------------------


def _gloo_d2_step(sp, model_seed=0):
    model = amoebanetd(GLOO_SHAPE, num_classes=10, num_layers=3, num_filters=16,
                       device="cpu", seed=model_seed)
    opt = Optimizer("sgd", lr=0.05)
    step = make_spatial_train_step(model, opt, sp, spatial_until=4)
    state = TrainState.create(model, opt)
    x = _randn(7, GLOO_SHAPE)
    y = torch.arange(GLOO_SHAPE[0]) % 10
    losses = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(GLOO_STEPS):
            state, m = step(state, x, y)
            losses.append(float(m["loss"]))
    return np.asarray(losses), {k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()}


def _d2_sp(tiles):
    return spatial_ctx_for("square", 4, tiles=tiles, d2_mode=True, use_pallas_conv=True)


GLOO_GRIDS = {"square": (2, 2), "vertical": (1, 4), "horizontal": (4, 1)}
HALO_IMG = np.arange(1, 2 * 16 * 16 * 2 + 1, dtype=np.float32).reshape(2, 16, 16, 2)


def _gloo_d1_per_tile_step(sp):
    """Two SGD steps of ResNet-11 v2 with D1 and per-tile BatchNorm."""
    model = get_resnet_v2((4, 32, 32, 3), 11, 10, device="cpu", seed=1)
    opt = Optimizer("sgd", lr=0.01)
    step = make_spatial_train_step(model, opt, sp)
    state = TrainState.create(model, opt)
    x, y = _randn(8, (4, 32, 32, 3)), torch.arange(4)
    losses = [float(step(state, x, y)[1]["loss"]) for _ in range(2)]
    return np.asarray(losses), {k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()}


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from mpi4dl_tpu_torch.mesh import MeshSpec as TMeshSpec, build_process_mesh
    from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_2d
    from mpi4dl_tpu_torch.parallel.tiles import ProcessGroupTiles

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    tiles = build_process_mesh(TMeshSpec(sph=2, spw=2)).tiles
    out = {}
    for method, (gh, gw) in GLOO_GRIDS.items():
        t = tiles if method == "square" else ProcessGroupTiles(gh, gw)
        ext = halo_exchange_2d(
            t.scatter(torch.from_numpy(HALO_IMG)), HaloSpec.symmetric(2 if gh > 1 else 0),
            HaloSpec.symmetric(2 if gw > 1 else 0), "sph" if gh > 1 else None,
            "spw" if gw > 1 else None, gh, gw, t)
        out[f"halo_{method}"] = ext.numpy()
    out["losses"], params = _gloo_d2_step(_d2_sp(tiles))
    out.update({f"p_{k}": v for k, v in params.items()})
    out["d1_losses"], params = _gloo_d1_per_tile_step(
        spatial_ctx_for("square", 4, tiles=tiles, bn_cross_tile=False))
    out.update({f"d1_{k}": v for k, v in params.items()})
    np.savez(workdir / f"out{rank}.npz", **out)
    dist.destroy_process_group()


def test_process_group_d2_step_matches_one_process_grid(tmp_path):
    """Four gloo ranks, one tile each: the arange halo exchange of every
    slice method exactly; the D2 AmoebaNet step (K2 windows, cell plan,
    cross-tile BN) and a D1 ResNet step with per-tile BatchNorm against
    the one-process grid."""
    from test_torch_ring import launch_gloo_ranks

    launch_gloo_ranks("d2", tmp_path, script=__file__)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    for method, (gh, gw) in GLOO_GRIDS.items():
        ph, pw = (2 if gh > 1 else 0), (2 if gw > 1 else 0)
        padded = np.pad(HALO_IMG, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
        th, tw = 16 // gh, 16 // gw
        for r, out in enumerate(outs):
            ih, iw = divmod(r, gw)
            np.testing.assert_array_equal(
                out[f"halo_{method}"],
                padded[:, ih * th:(ih + 1) * th + 2 * ph, iw * tw:(iw + 1) * tw + 2 * pw],
                err_msg=f"{method} rank {r}")
    d1_losses, d1_params = _gloo_d1_per_tile_step(
        spatial_ctx_for("square", 4, tiles=TileGrid(2, 2), bn_cross_tile=False))
    for out in outs:
        np.testing.assert_allclose(out["d1_losses"], d1_losses, rtol=1e-5)
        for k, v in d1_params.items():
            np.testing.assert_allclose(out[f"d1_{k}"], v, rtol=1e-4, atol=1e-6, err_msg=k)
    before = {k: v.numpy() for k, v in amoebanetd(
        GLOO_SHAPE, num_classes=10, num_layers=3, num_filters=16,
        device="cpu").state_dict().items()}
    losses, params = _gloo_d2_step(_d2_sp(TileGrid(2, 2)))
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        for k, v in params.items():
            want, got = v - before[k], out[f"p_{k}"] - before[k]
            err = np.abs(got - want).max()
            assert err <= 1e-3 * np.abs(want).max() + 1e-7, (k, err, np.abs(want).max())


if __name__ == "__main__":
    _job, _rank, _world, _dir = sys.argv[1:5]
    _rank_main(int(_rank), int(_world), Path(_dir))
