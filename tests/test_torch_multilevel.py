"""Multi-level spatial parallelism in the PyTorch port (``--num-spatial-parts
4,2``) against the JAX package on the CPU (``tests/test_multilevel.py``).

- ``spatial_levels_for``: the level grids, replication factors and errors.
- ``respatial``: each path (refine, ring coarsen, gather + dedup, into a
  degenerate level, ``MPI4DL_NO_RESPATIAL_FAST=1``) forward and adjoint,
  on the one-process grid (each replicated tile held once) and on four
  gloo ranks (one device each), against JAX ``respatial`` under
  ``shard_map``: bitwise, it is data movement (integer-valued cotangents,
  so that the adjoint's sums are exact in any order).
- The multi-level steps (square 4→2, vertical 4→2, cross-tile BatchNorm,
  local-DP with levels) against JAX ``make_spatial_train_step(levels=)``
  at ``test_multilevel.py``'s models, shapes and tolerances (losses rtol
  1e-4, parameters rtol 2e-3 / atol 1e-5), and a degenerate ``4,1`` chain.
- D2 on a replicated level against the single-level run (atol 2e-5) and
  the AmoebaNet cell's D2 on a ``rep_w = 2`` layout against the fine grid
  (atol 3e-4), both also against JAX.
- SP x PP and SP + GEMS with levels against the JAX single-device step
  accumulated over the same micro-batches (the JAX engines are red on this
  jax), in float64 as ``test_torch_sp_pipeline.py`` runs it.
- K1/K2 dispatch counts on a replicated level and on a degenerate one
  against the JAX step's ``pallas_call`` count (a degenerate level runs
  unsharded: no kernel), and the single-card reference of the card's
  checks taking the kernels on the same cells.
- Four gloo ranks against the one-process grid, multi-level steps in
  float64 (this file run as the ranks' script): losses rtol 1e-6 (the
  metrics are reduced in fp32), every tensor within 1e-8.
"""

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import layers as L
from mpi4dl_tpu_torch.cells import CellModel, LayerCell
from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx, spatial_levels_for
from mpi4dl_tpu_torch.parallel import tiles as T
from mpi4dl_tpu_torch.parallel.tiles import TileGrid
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

WORLD = 4
GRIDS = {"square": (2, 2), "vertical": (1, 4), "horizontal": (4, 1)}
TOL = dict(rtol=2e-3, atol=1e-5)


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_model(kind, batch, dtype=torch.float32):
    """``test_multilevel.py``'s BN-free (``bnfree``) and BatchNorm'd
    (``bn``) nets, junction after cell 3."""
    bn = (lambda c: [L.BatchNorm(c)]) if kind == "bn" else (lambda c: [])
    tail = ([L.Conv2d(8, 8, 3), *bn(8), L.ReLU(), L.Pool2d("max", 2)] if kind == "bnfree"
            else [L.Conv2d(8, 8, 3), *bn(8), L.ReLU()])
    flat = 8 * 8 * 8 if kind == "bnfree" else 8 * 16 * 16
    m = CellModel([LayerCell([L.Conv2d(3, 8, 3), *bn(8), L.ReLU()], name="c0"),
                   LayerCell([L.Conv2d(8, 8, 3, stride=2), *bn(8), L.ReLU()], name="c1"),
                   LayerCell(tail, name="c2"),
                   LayerCell([L.Flatten(), L.Dense(flat, 10)], name="head")],
                  (batch, 32, 32, 3), 10)
    m.to(dtype)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.spatial_until = 3
    return m


def _jax_model(kind, batch):
    import jax

    from mpi4dl_tpu.cells import CellModel as JCellModel, LayerCell as JLayerCell
    from mpi4dl_tpu.layers import BatchNorm, Conv2d, Dense, Flatten, Pool2d, ReLU

    bn = (lambda c: [BatchNorm(c)]) if kind == "bn" else (lambda c: [])
    tail = ([Conv2d(8, 8, 3), *bn(8), ReLU(), Pool2d("max", 2)] if kind == "bnfree"
            else [Conv2d(8, 8, 3), *bn(8), ReLU()])
    flat = 8 * 8 * 8 if kind == "bnfree" else 8 * 16 * 16
    jm = JCellModel([JLayerCell([Conv2d(3, 8, 3), *bn(8), ReLU()], name="c0"),
                     JLayerCell([Conv2d(8, 8, 3, stride=2), *bn(8), ReLU()], name="c1"),
                     JLayerCell(tail, name="c2"),
                     JLayerCell([Flatten(), Dense(flat, 10)], name="head")],
                    (batch, 32, 32, 3), 10, spatial_until=3)
    params, _ = jm.init(jax.random.key(0))
    return jm, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _jmesh(slice_method):
    import jax

    from mpi4dl_tpu.mesh import MeshSpec, build_mesh

    gh, gw = GRIDS[slice_method]
    return build_mesh(MeshSpec(sph=gh, spw=gw), jax.devices()[:WORLD])


# ---------------------------------------------------------------------------
# The level chain.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,parts", [
    ("square", [4, 2]), ("square", [4, 1]), ("square", [4, 2, 1]),
    ("vertical", [4, 2, 1]), ("horizontal", [4, 2]), ("square", [16, 4, 2]),
])
def test_spatial_levels_for_grids(method, parts):
    """Grids and replication factors as JAX's (``_level_grid``: the most
    square factorization embedded in the base grid, ties to W), each level
    on its own backend of the same ranks."""
    from mpi4dl_tpu.layer_ctx import spatial_levels_for as j_levels

    g = int(np.sqrt(parts[0])) if method == "square" else parts[0]
    grid = {"square": (g, g), "vertical": (1, g), "horizontal": (g, 1)}[method]
    got = spatial_levels_for(method, parts, tiles=TileGrid(*grid))
    want = j_levels(method, parts)
    assert [(c.grid_h, c.grid_w, c.rep_h, c.rep_w) for c in got] == \
        [(c.grid_h, c.grid_w, c.rep_h, c.rep_w) for c in want]
    for c in got:
        assert (c.tiles.grid_h, c.tiles.grid_w, c.tiles.count_factor) == \
            (c.grid_h, c.grid_w, c.rep_h * c.rep_w)


@pytest.mark.parametrize("parts", [[4, 3], [4, 8]])
def test_spatial_levels_for_errors(parts):
    """A level that grows or does not embed in the base grid is refused,
    as JAX refuses it."""
    from mpi4dl_tpu.layer_ctx import spatial_levels_for as j_levels

    with pytest.raises(ValueError):
        j_levels("vertical", parts)
    with pytest.raises(ValueError):
        spatial_levels_for("vertical", parts, tiles=TileGrid(1, 4))


# ---------------------------------------------------------------------------
# respatial.
# ---------------------------------------------------------------------------

# name: (slice method, source (grid_h, grid_w), target (grid_h, grid_w),
# MPI4DL_NO_RESPATIAL_FAST).  Grids embed in the 4-device axis (or 2x2).
RESPATIAL = {
    "refine": ("vertical", (1, 2), (1, 4), "0"),
    "ring": ("vertical", (1, 4), (1, 2), "0"),
    "ring_no_fast": ("vertical", (1, 4), (1, 2), "1"),
    "refine_no_fast": ("vertical", (1, 2), (1, 4), "1"),
    "gather_dedup": ("vertical", (1, 2), (1, 1), "0"),
    "square_4_to_2": ("square", (2, 2), (1, 2), "0"),
    "square_2_to_4": ("square", (1, 2), (2, 2), "0"),
    "square_4_to_1": ("square", (2, 2), (1, 1), "0"),
    "square_2_to_1": ("square", (1, 2), (1, 1), "0"),
}
RESPATIAL_X = (1, 8, 16, 3)


def _ctx(method, grid):
    base = GRIDS[method]
    sp = SpatialCtx(axis_h="sph" if base[0] > 1 else None, axis_w="spw" if base[1] > 1 else None,
                    grid_h=grid[0], grid_w=grid[1], rep_h=base[0] // grid[0],
                    rep_w=base[1] // grid[1])
    return sp


def _device_blocks(x, sp, base):
    """The (dev_h, dev_w) grid of per-device blocks of ``x`` under level
    ``sp`` (device (ah, aw) holds tile (ah // rep_h, aw // rep_w))."""
    h, w = x.shape[1] // sp.grid_h, x.shape[2] // sp.grid_w
    return [[x[:, (ah // sp.rep_h) * h:(ah // sp.rep_h + 1) * h,
               (aw // sp.rep_w) * w:(aw // sp.rep_w + 1) * w]
             for aw in range(base[1])] for ah in range(base[0])]


def _stack(blocks):
    return np.concatenate([np.concatenate(row, axis=2) for row in blocks], axis=1)


def _unstack(arr, base):
    h, w = arr.shape[1] // base[0], arr.shape[2] // base[1]
    return [[arr[:, ah * h:(ah + 1) * h, aw * w:(aw + 1) * w] for aw in range(base[1])]
            for ah in range(base[0])]


@functools.lru_cache(maxsize=None)
def _jax_respatial(name):
    """JAX respatial of the case: the per-device outputs and the per-device
    input cotangents for per-device integer cotangents (a (dev_h, dev_w)
    grid of blocks each)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.layer_ctx import SpatialCtx as JSpatialCtx
    from mpi4dl_tpu.parallel.spatial import respatial as j_respatial

    method, src, dst, no_fast = RESPATIAL[name]
    base = GRIDS[method]
    s, d = _ctx(method, src), _ctx(method, dst)
    js = JSpatialCtx(axis_h=s.axis_h, axis_w=s.axis_w, grid_h=s.grid_h, grid_w=s.grid_w,
                     rep_h=s.rep_h, rep_w=s.rep_w)
    jd = JSpatialCtx(axis_h=d.axis_h, axis_w=d.axis_w, grid_h=d.grid_h, grid_w=d.grid_w,
                     rep_h=d.rep_h, rep_w=d.rep_w)
    x = np.arange(np.prod(RESPATIAL_X), dtype=np.float32).reshape(RESPATIAL_X)
    spec = P(None, "sph" if base[0] > 1 else None, "spw" if base[1] > 1 else None, None)
    old = os.environ.get("MPI4DL_NO_RESPATIAL_FAST")
    os.environ["MPI4DL_NO_RESPATIAL_FAST"] = no_fast
    try:
        f = jax.jit(shard_map(lambda t: j_respatial(t, js, jd), mesh=_jmesh(method),
                              in_specs=spec, out_specs=spec, check_vma=False))
        xin = _stack(_device_blocks(x, s, base))
        y, vjp = jax.vjp(f, xin)
        ct = np.random.default_rng(3).integers(-8, 8, y.shape).astype(np.float32)
        (gx,) = vjp(ct)
    finally:
        if old is None:
            del os.environ["MPI4DL_NO_RESPATIAL_FAST"]
        else:
            os.environ["MPI4DL_NO_RESPATIAL_FAST"] = old
    return x, _unstack(np.asarray(y), base), _unstack(ct, base), _unstack(np.asarray(gx), base)


def _primary(sp, ah, aw):
    return ah % sp.rep_h == 0 and aw % sp.rep_w == 0


@pytest.mark.parametrize("name", sorted(RESPATIAL))
def test_respatial_tile_grid_matches_jax(devices8, name, monkeypatch):
    """The one-process grid holds each replicated tile once: its output
    tiles equal JAX's on the tiles' kept devices, and with the cotangent
    given to those devices alone its input gradient equals JAX's summed
    over each source tile's copies — bitwise."""
    method, src, dst, no_fast = RESPATIAL[name]
    monkeypatch.setenv("MPI4DL_NO_RESPATIAL_FAST", no_fast)
    base = GRIDS[method]
    s, d = _ctx(method, src), _ctx(method, dst)
    x, y_j, _, _ = _jax_respatial(name)
    ts, td = TileGrid(*base).level(*src), TileGrid(*base).level(*dst)
    xt = ts.scatter(torch.from_numpy(x)).requires_grad_(True)
    y = T.respatial(xt, ts, td)
    full = td.gather(y) if dst != (1, 1) else y
    for ah in range(base[0]):
        for aw in range(base[1]):
            if _primary(d, ah, aw):
                np.testing.assert_array_equal(
                    _device_blocks(full.detach().numpy(), d, base)[ah][aw], y_j[ah][aw])
    # Adjoint: JAX with the cotangent on the target's kept devices only.
    import jax
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.layer_ctx import SpatialCtx as JSpatialCtx
    from mpi4dl_tpu.parallel.spatial import respatial as j_respatial

    js = JSpatialCtx(axis_h=s.axis_h, axis_w=s.axis_w, grid_h=s.grid_h, grid_w=s.grid_w,
                     rep_h=s.rep_h, rep_w=s.rep_w)
    jd = JSpatialCtx(axis_h=d.axis_h, axis_w=d.axis_w, grid_h=d.grid_h, grid_w=d.grid_w,
                     rep_h=d.rep_h, rep_w=d.rep_w)
    spec = P(None, "sph" if base[0] > 1 else None, "spw" if base[1] > 1 else None, None)
    f = jax.jit(shard_map(lambda t: j_respatial(t, js, jd), mesh=_jmesh(method),
                          in_specs=spec, out_specs=spec, check_vma=False))
    ct_full = np.random.default_rng(4).integers(-8, 8, full.shape).astype(np.float32)
    blocks = _device_blocks(ct_full, d, base)
    blocks = [[b if _primary(d, ah, aw) else np.zeros_like(b) for aw, b in enumerate(row)]
              for ah, row in enumerate(blocks)]
    _, vjp = jax.vjp(f, _stack(_device_blocks(x, s, base)))
    (gx_j,) = vjp(_stack(blocks))
    ct = torch.from_numpy(ct_full) if dst == (1, 1) else td.scatter(torch.from_numpy(ct_full))
    (gx,) = torch.autograd.grad(full if dst == (1, 1) else y, xt, ct)
    gfull = ts.gather(gx).numpy()
    gx_blocks = _unstack(np.asarray(gx_j), base)
    for ah in range(0, base[0], s.rep_h):
        for aw in range(0, base[1], s.rep_w):
            # A replicated source tile's gradient: the sum over its copies.
            want = sum(gx_blocks[ah + i][aw + j] for i in range(s.rep_h)
                       for j in range(s.rep_w))
            np.testing.assert_array_equal(_device_blocks(gfull, s, base)[ah][aw], want)


# ---------------------------------------------------------------------------
# Multi-level steps against JAX.
# ---------------------------------------------------------------------------

STEPS = {  # name: (model, method, parts, stops, junction, local_dp, batch)
    "square_4_to_2_exact": ("bnfree", "square", [4, 2], [2, 3], "gather", None, 2),
    "vertical_4_to_2_exact": ("bnfree", "vertical", [4, 2], [2, 3], "gather", None, 2),
    "bn_cross_tile_exact": ("bn", "square", [4, 2], [2, 3], "gather", None, 2),
    "with_local_dp_full_devices": ("bnfree", "square", [4, 2], [2, 3], "batch_split", 4, 4),
    "degenerate_square_4_to_1": ("bn", "square", [4, 1], [2, 3], "gather", None, 2),
}


def _port_step(name, tiles=None, dtype=torch.float32, lr=0.01):
    kind, method, parts, stops, junction, local_dp, batch = STEPS[name]
    model = _port_model(kind, batch, dtype)
    ctxs = spatial_levels_for(method, parts, tiles=tiles or TileGrid(*GRIDS[method]))
    opt = Optimizer("sgd", lr=lr)
    step = make_spatial_train_step(model, opt, ctxs[0], junction=junction, local_dp=local_dp,
                                   levels=list(zip(stops, ctxs)), compute_dtype=dtype)
    return model, step, TrainState.create(model, opt)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_multilevel_step_matches_jax(devices8, name):
    """Two SGD steps of the port's multi-level step on the one-process grid
    against JAX's on the CPU mesh (``test_multilevel.py``'s cases)."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.layer_ctx import spatial_levels_for as j_levels
    from mpi4dl_tpu.train import (
        Optimizer as JOptimizer, TrainState as JTrainState, make_spatial_train_step as j_step,
    )
    from mpi4dl_tpu_torch.params import from_jax_params, to_jax_layout

    kind, method, parts, stops, junction, local_dp, batch = STEPS[name]
    jm, params = _jax_model(kind, batch)
    jctx = j_levels(method, parts)
    jopt = JOptimizer("sgd", lr=0.01)
    jstep = j_step(jm, jopt, _jmesh(method), jctx[0], junction=junction, spatial_until=3,
                   levels=list(zip(stops, jctx)), local_dp=local_dp)
    jstate = JTrainState.create(params, jopt)
    model, step, state = _port_step(name)
    from_jax_params(params, model)
    x = _randn(1, (batch, 32, 32, 3))
    y = np.arange(batch) % 10
    for _ in range(2):
        jstate, jm_ = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(to_jax_layout(model)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, b, **TOL)


def test_multilevel_d2_forward_matches_single_level(devices8):
    """D2 fused runs on a replicated level (vertical 4→2) equal the same
    pad-once computation on the fine grid (atol 2e-5), and JAX's."""
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, spatial_levels_for as j_levels
    from mpi4dl_tpu.parallel.spatial import apply_spatial_region as j_region, gather_spatial

    ctxs = spatial_levels_for("vertical", [4, 2], tiles=TileGrid(1, 4), d2_mode=True)
    jm, params = _jax_model("bnfree", 2)
    x, (fine, multi) = _d2_region(params, [[(3, ctxs[0])], [(2, ctxs[0]), (3, ctxs[1])]])
    np.testing.assert_allclose(multi, fine, atol=2e-5)
    jctx = j_levels("vertical", [4, 2], d2_mode=True)

    def f(ps, t):
        act, last = j_region(jm, ps, t, JApplyCtx(train=True, spatial=jctx[0]),
                             [(2, jctx[0]), (3, jctx[1])])
        return lax.pmean(gather_spatial(act, last), ("spw",))

    want = jax.jit(shard_map(f, mesh=_jmesh("vertical"), in_specs=(P(), P(None, None, "spw")),
                             out_specs=P()))(params, x.numpy())
    np.testing.assert_allclose(multi, np.asarray(want), atol=2e-5)


def _d2_region(params, levels_of):
    """The input and, per level chain, the BN-free net's region gathered."""
    from mpi4dl_tpu_torch.parallel.spatial import apply_spatial_region
    from mpi4dl_tpu_torch.params import from_jax_params

    model = _port_model("bnfree", 2)
    from_jax_params(params, model)
    x = torch.from_numpy(_randn(7, (2, 32, 32, 3)))
    outs = []
    for levels in levels_of:
        sp0 = levels[0][1]
        with torch.no_grad():
            act, last = apply_spatial_region(model, sp0.tiles.scatter(x),
                                             ApplyCtx(train=True, spatial=sp0), 3,
                                             levels=levels)
        outs.append(last.tiles.gather(act).numpy())
    return x, outs


def test_amoeba_cell_d2_rep_layout_matches_fine_grid(devices8):
    """The AmoebaNet cell's cell-level D2 exchange on a ``rep_w = 2`` level
    equals the fine grid's (atol 3e-4) and JAX's: the halo pull strides
    over replication groups."""
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from mpi4dl_tpu.compat import shard_map
    from mpi4dl_tpu.layer_ctx import ApplyCtx as JApplyCtx, SpatialCtx as JSpatialCtx
    from mpi4dl_tpu.models.amoebanet import AmoebaCell as JAmoebaCell
    from mpi4dl_tpu.parallel.spatial import gather_spatial, respatial as j_respatial
    from mpi4dl_tpu_torch.models.amoebanet import AmoebaCell
    from mpi4dl_tpu_torch.params import from_jax_params

    jcell = JAmoebaCell(32, 32, 32, reduction=False, reduction_prev=False)
    params, _ = jcell.init(jax.random.key(0), (1, 32, 32, 32))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    x = np.asarray(jax.random.normal(jax.random.key(1), (1, 32, 32, 32)))
    cell = AmoebaCell(32, 32, 32, reduction=False, reduction_prev=False)
    from_jax_params(params, cell)
    grid4 = TileGrid(1, 4)
    sp4 = SpatialCtx(axis_w="spw", grid_w=4, d2_mode=True, tiles=grid4)
    sp2 = SpatialCtx(axis_w="spw", grid_w=2, rep_w=2, d2_mode=True, tiles=grid4.level(1, 2))
    outs = []
    with torch.no_grad():
        for sp in (sp4, sp2):
            t = sp4.tiles.scatter(torch.from_numpy(x.copy()))
            if sp is sp2:
                t = T.respatial(t, sp4.tiles, sp2.tiles)
            outs.append(sp.tiles.gather(cell(t, ApplyCtx(train=True, spatial=sp))[0]).numpy())
    np.testing.assert_allclose(outs[1], outs[0], atol=3e-4)
    j4 = JSpatialCtx(axis_w="spw", grid_w=4, d2_mode=True)
    j2 = JSpatialCtx(axis_w="spw", grid_w=2, rep_w=2, d2_mode=True)

    def f(t):
        t = j_respatial(t, j4, j2)
        y = jcell.apply(params, t, JApplyCtx(train=True, spatial=j2))[0]
        return lax.pmean(gather_spatial(y, j2), ("spw",))

    want = jax.jit(shard_map(f, mesh=_jmesh("vertical"), in_specs=P(None, None, "spw"),
                             out_specs=P()))(x)
    np.testing.assert_allclose(outs[1], np.asarray(want), atol=3e-4)


# ---------------------------------------------------------------------------
# SP x PP and SP + GEMS with levels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,schedule", [("sp_pp", "gpipe"), ("sp_pp", "1f1b"),
                                             ("sp_gems", "gpipe")])
def test_multilevel_sp_pipeline_matches_jax_accumulation(engine, schedule):
    """SP x PP (``test_multilevel_sp_pipeline_exact``'s model, square 4→2,
    the junction after cell 2 so that each of the two tail stages holds a
    cell, 2 micro-batches of 2) and SP + GEMS (times 1, parts 2)
    against the JAX single-device step accumulated over the same
    micro-batches, in float64: losses rtol 1e-4, parameters rtol 2e-3 /
    atol 1e-5."""
    import jax

    from mpi4dl_tpu_torch.parallel.sp_pipeline import (
        SPPipeline, init_sp_pipeline_state, make_sp_gems_train_step,
        make_sp_pipeline_train_step,
    )
    from mpi4dl_tpu_torch.parallel.stages import StageChain
    from mpi4dl_tpu_torch.params import from_jax_params, to_jax_layout
    from test_torch_pipeline import LR, _jax_accumulated_reference

    gems = engine == "sp_gems"
    batch = 8 if gems else 4
    jm, params = _jax_model("bnfree", batch)
    x = _randn(3, (batch, 32, 32, 3))
    y = np.arange(batch, dtype=np.int64) % 10
    losses_j, params_j = _jax_accumulated_reference(jm, params, x, y, 4 if gems else 2)
    model = _port_model("bnfree", batch, torch.float64)
    from_jax_params(params, model)
    model.spatial_until = 2
    ctxs = spatial_levels_for("square", [4, 2], tiles=TileGrid(2, 2))
    spp = SPPipeline.build(model, 2, ctxs[0], 2, junction="gather",
                           levels=[(1, ctxs[0]), (2, ctxs[1])])
    chain = StageChain(2)
    opt = Optimizer("sgd", lr=LR)
    kw = dict(schedule=schedule, compute_dtype=torch.float64)
    step = (make_sp_gems_train_step(spp, opt, chain, 2, times=1, **kw) if gems
            else make_sp_pipeline_train_step(spp, opt, chain, 2, **kw))
    state = init_sp_pipeline_state(spp, opt, chain)
    losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))[1]["loss"])
              for _ in range(2)]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(to_jax_layout(model)), jax.tree.leaves(params_j)):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# Kernel dispatch on replicated and degenerate levels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,parts,want", [
    # Level 0 runs c0 (a stride-1 3x3 conv) and c1 (strided, no kernel);
    # level 1 runs c2's stride-1 conv: K1 forward and dx for each.
    ("square", [4, 2], {"halo_conv2d": 4, "halo_conv2d_stats": 0}),
    # A degenerate level runs unsharded, with no kernel (layers.py:250-258).
    ("square", [4, 1], {"halo_conv2d": 2, "halo_conv2d_stats": 0}),
    ("vertical", [4, 2, 1], {"halo_conv2d": 2, "halo_conv2d_stats": 0}),
])
def test_multilevel_dispatch_count_matches_jax(devices8, method, parts, want):
    """K1/K2 calls of a multi-level step with the kernels on, counted on the
    CPU (each is one launch on the card), against the JAX step's
    ``pallas_call`` count."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.layer_ctx import spatial_levels_for as j_levels
    from mpi4dl_tpu.train import (
        Optimizer as JOptimizer, TrainState as JTrainState, make_spatial_train_step as j_step,
    )
    from mpi4dl_tpu_torch.ops import halo_conv
    from test_torch_spatial import count_pallas_calls

    stops = [2, 3] if len(parts) == 2 else [1, 2, 3]
    model = _port_model("bn", 2)
    ctxs = spatial_levels_for(method, parts, tiles=TileGrid(*GRIDS[method]),
                              use_pallas_conv=True)
    opt = Optimizer("sgd", lr=0.01)
    step = make_spatial_train_step(model, opt, ctxs[0], levels=list(zip(stops, ctxs)))
    with halo_conv.count_dispatches() as seen:
        step(TrainState.create(model, opt), torch.zeros((2, 32, 32, 3)),
             torch.zeros((2,), dtype=torch.long))
    assert seen.counts == want
    jm, params = _jax_model("bn", 2)
    jctx = j_levels(method, parts, use_pallas_conv=True)
    jopt = JOptimizer("sgd", lr=0.01)
    jstep = j_step(jm, jopt, _jmesh(method), jctx[0], spatial_until=3,
                   levels=list(zip(stops, jctx)))
    jaxpr = jax.make_jaxpr(jstep)(JTrainState.create(params, jopt), jnp.zeros((2, 32, 32, 3)),
                                  jnp.zeros((2,), jnp.int32))
    assert count_pallas_calls(jaxpr.jaxpr) == want


@pytest.mark.parametrize("method,parts,kernel_cells", [("square", [4, 2], 3),
                                                     ("vertical", [2, 1], 1)])
def test_single_card_reference_takes_the_kernels_where_the_chain_does(method, parts,
                                                                      kernel_cells):
    """``utils/devcheck.engine_run``'s single-card step with
    ``kernel_cells`` (the stop of the last level with a sharded axis: a
    degenerate level and the SP tail run without the kernels) makes as many
    K1/K2 calls as the multi-level ResNet-11 step with the kernels on, and
    agrees with it at the multi-level checks' bounds (losses rtol 1e-4,
    parameters rtol 2e-3 / atol 1e-5).  The card's fp32 checks build their
    references with it."""
    from mpi4dl_tpu_torch.ops import halo_conv
    from mpi4dl_tpu_torch.utils.devcheck import engine_run

    runs = []
    for engine, kw in (("sp", dict(levels=(method, parts, [1, 3]))),
                       ("single", dict(kernel_cells=kernel_cells))):
        with halo_conv.count_dispatches() as seen:
            losses, state = engine_run("cpu", engine, pallas=True, micro=4, **kw)
        runs.append((dict(seen.counts), losses, state))
    (c_sp, l_sp, s_sp), (c_one, l_one, s_one) = runs
    assert c_sp == c_one and c_sp["halo_conv2d"] > 0, (c_sp, c_one)
    np.testing.assert_allclose(l_sp, l_one, rtol=1e-4)
    for k, v in s_one.items():
        if v.is_floating_point():
            torch.testing.assert_close(s_sp[k], v, rtol=2e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# Gloo ranks: one device each.
# ---------------------------------------------------------------------------

RANK_STEPS = ["square_4_to_2_exact", "bn_cross_tile_exact", "with_local_dp_full_devices",
              "degenerate_square_4_to_1"]


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel.tiles import ProcessGroupTiles

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    out = {}
    for name, (method, src, dst, no_fast) in RESPATIAL.items():
        os.environ["MPI4DL_NO_RESPATIAL_FAST"] = no_fast
        base = ProcessGroupTiles(*GRIDS[method])
        ts, td = base.level(*src), base.level(*dst)
        blocks = np.load(workdir / f"r{rank}" / f"in_{name}.npz")
        xt = torch.from_numpy(blocks["x"]).requires_grad_(True)
        y = T.respatial(xt, ts, td)
        (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(blocks["ct"]))
        out[f"y_{name}"], out[f"gx_{name}"] = y.detach().numpy(), gx.numpy()
    os.environ["MPI4DL_NO_RESPATIAL_FAST"] = "0"
    for name in RANK_STEPS:
        method = STEPS[name][1]
        model, step, state = _port_step(name, ProcessGroupTiles(*GRIDS[method]),
                                        torch.float64)
        kind, _, _, _, _, _, batch = STEPS[name]
        x, y = torch.from_numpy(_randn(1, (batch, 32, 32, 3))).double(), \
            torch.arange(batch) % 10
        out[f"loss_{name}"] = np.array([float(step(state, x, y)[1]["loss"])
                                        for _ in range(2)])
        out.update({f"p_{name}_{k}": v.numpy() for k, v in model.state_dict().items()})
    np.savez(workdir / f"out{rank}.npz", **out)
    dist.destroy_process_group()


def test_process_group_multilevel_matches_jax_and_grid(devices8, tmp_path):
    """Four gloo ranks, one device each: every respatial path's per-rank
    output and input gradient bitwise equal to JAX's per-device ones (each
    rank its own integer cotangent, replicas included); the multi-level
    steps in float64 equal to the one-process grid."""
    from test_torch_ring import launch_gloo_ranks

    for r in range(WORLD):
        (tmp_path / f"r{r}").mkdir()
        for name, (method, src, dst, no_fast) in RESPATIAL.items():
            x, _, ct, _ = _jax_respatial(name)
            base = GRIDS[method]
            ah, aw = divmod(r, base[1])
            np.savez(tmp_path / f"r{r}" / f"in_{name}.npz",
                     x=_device_blocks(x, _ctx(method, src), base)[ah][aw], ct=ct[ah][aw])
    launch_gloo_ranks("multilevel", tmp_path, script=__file__)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    for name, (method, src, dst, no_fast) in RESPATIAL.items():
        _, y_j, _, gx_j = _jax_respatial(name)
        base = GRIDS[method]
        for r, out in enumerate(outs):
            ah, aw = divmod(r, base[1])
            np.testing.assert_array_equal(out[f"y_{name}"], y_j[ah][aw], err_msg=f"{name} {r}")
            np.testing.assert_array_equal(out[f"gx_{name}"], gx_j[ah][aw],
                                          err_msg=f"{name} {r}")
    for name in RANK_STEPS:
        model, step, state = _port_step(name, dtype=torch.float64)
        batch = STEPS[name][-1]
        x, y = torch.from_numpy(_randn(1, (batch, 32, 32, 3))).double(), \
            torch.arange(batch) % 10
        losses = [float(step(state, x, y)[1]["loss"]) for _ in range(2)]
        for out in outs:
            np.testing.assert_allclose(out[f"loss_{name}"], losses, rtol=1e-6)
            for k, v in model.state_dict().items():
                np.testing.assert_allclose(out[f"p_{name}_{k}"], v.numpy(), rtol=0,
                                           atol=1e-8, err_msg=f"{name} {k}")


if __name__ == "__main__":
    _job, _rank, _world, _dir = sys.argv[1:5]
    _rank_main(int(_rank), int(_world), Path(_dir))
