"""SP x PP and SP + GEMS in the PyTorch port (``parallel/sp_pipeline.py``)
against the JAX package on the CPU.

The JAX engines are red on this jax (``tests/test_sp_pipeline.py`` and
``tests/test_sp_gems.py`` fail at their ``custom_vjp``), so the port is
held, at those tests' models and shapes, to the JAX single-device step
accumulated over the same micro-batches (``make_train_step(parts=...)``,
in float64 as ``tests/test_torch_pipeline.py`` runs it), on the
one-process tile grid and stage chain, two stages: losses rtol 1e-4,
parameters rtol 2e-3 / atol 1e-5.

- SP x PP: ResNet-11 v2 with BatchNorm on a 1x2 grid under ``gather``
  (parts == stages, so each stage chunk is one micro-batch); the BN-free
  conv net on a 2x2 grid under both junctions; GPipe and 1F1B.
- SP + GEMS: the BN-free conv net with a global-pool head, (times,
  parts) ∈ {(1,1), (2,1), (1,2)}, ``gather``; the BN-free flatten net
  under ``batch_split``; "bn_aligned" ResNet (2·times·parts == S); both
  schedules.
- AmoebaNet's (x, skip) tuple across the junction, the lineup and the
  stage handoffs: 1F1B against GPipe (losses rtol 1e-5, parameters rtol
  2e-3 / atol 5e-5, ``tests/test_1f1b.py``'s).
- ``batch_split`` with BatchNorm has no exact anchor (the tail normalises
  each shard alone): finite, falling losses.
- Four gloo ranks, 2 stages x 2 tiles (this file run as the ranks'
  script): SP x PP (``gather`` and ``batch_split``) and SP + GEMS against
  the one-process grid, three steps.  Every step sums over ranks
  (cross-tile BatchNorm, the region's gradient over stage x tile ranks) in
  another order than the grid, so they are held as ``test_torch_d2.py``
  holds its ranks: losses rtol 1e-5, each tensor's update within 1e-3 of
  its largest element plus 1e-7 — in float64.  In fp32 the second step's update of
  ResNet's BatchNorm'd convs already moves by ~0.5% between thread counts
  of the single-device step itself (its gradient cancels), so fp32 would
  hold rounding, not the engine.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import layers as L
from mpi4dl_tpu_torch.cells import CellModel, LayerCell
from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for, spatial_levels_for
from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
from mpi4dl_tpu_torch.parallel.sp_pipeline import (
    SPPipeline, init_sp_pipeline_state, make_sp_gems_train_step, make_sp_pipeline_train_step,
)
from mpi4dl_tpu_torch.parallel.stages import StageChain
from mpi4dl_tpu_torch.parallel.tiles import TileGrid
from mpi4dl_tpu_torch.train import Optimizer
from test_torch_pipeline import LR, _jax_accumulated_reference, _leaves, _randn

TOL = dict(rtol=2e-3, atol=1e-5)
WORLD = 4
GRIDS = {"vertical": (1, 2), "square": (2, 2)}


def _port(name, batch):
    """The port's model: ``resnet`` (ResNet-11 v2), ``flat`` (the BN-free
    conv net with a dense head, ``test_sp_pipeline.py:98-104``) or ``gap``
    (its global-pool twin, ``test_sp_gems.py:25-34``); junction after
    cell 2."""
    if name == "resnet":
        m = get_resnet_v2((batch, 32, 32, 3), 11, 10, device="cpu", seed=0)
    else:
        head = ([L.Flatten(), L.Dense(8 * 16 * 16, 10)] if name == "flat"
                else [L.GlobalAvgPool(), L.Dense(16, 10)])
        last = 8 if name == "flat" else 16
        m = CellModel([LayerCell([L.Conv2d(3, 8, 3), L.ReLU()], name="c1"),
                       LayerCell([L.Conv2d(8, 8, 3, stride=2), L.ReLU()], name="c2"),
                       LayerCell([L.Conv2d(8, last, 3), L.ReLU()], name="c3"),
                       LayerCell(head, name="head")], (batch, 32, 32, 3), 10)
        m.reset_parameters(torch.Generator().manual_seed(0))
    m.spatial_until = 2
    return m


def _jax(name, batch):
    """The JAX twin of :func:`_port` and its weights (numpy fp32)."""
    import jax

    from mpi4dl_tpu.cells import CellModel as JCellModel, LayerCell as JLayerCell
    from mpi4dl_tpu.layers import Conv2d, Dense, Flatten, GlobalAvgPool, ReLU
    from mpi4dl_tpu.models.resnet import get_resnet_v2 as j_resnet

    if name == "resnet":
        jm = j_resnet((batch, 32, 32, 3), depth=11, num_classes=10)
    else:
        head = ([Flatten(), Dense(8 * 16 * 16, 10)] if name == "flat"
                else [GlobalAvgPool(), Dense(16, 10)])
        last = 8 if name == "flat" else 16
        jm = JCellModel([JLayerCell([Conv2d(3, 8, 3), ReLU()], name="c1"),
                         JLayerCell([Conv2d(8, 8, 3, stride=2), ReLU()], name="c2"),
                         JLayerCell([Conv2d(8, last, 3), ReLU()], name="c3"),
                         JLayerCell(head, name="head")], (batch, 32, 32, 3), 10)
    params, _ = jm.init(jax.random.key(0))
    return jm, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _sp_step(model, slice_method, mb, parts, junction, schedule, times=None,
             stages=None, tiles=None):
    sp = spatial_ctx_for(slice_method, 4 if slice_method == "square" else 2,
                         tiles=tiles or TileGrid(*GRIDS[slice_method]))
    dtype = next(model.parameters()).dtype
    spp = SPPipeline.build(model, 2, sp, mb, junction=junction)
    stages = stages or StageChain(2)
    opt = Optimizer("sgd", lr=LR)
    if times is None:
        step = make_sp_pipeline_train_step(spp, opt, stages, parts, schedule=schedule,
                                           compute_dtype=dtype)
    else:
        step = make_sp_gems_train_step(spp, opt, stages, parts, times=times,
                                       schedule=schedule, compute_dtype=dtype)
    return spp, step, init_sp_pipeline_state(spp, opt, stages)


def _train(step, state, x, y, steps=2):
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    return [float(step(state, x, y)[1]["loss"]) for _ in range(steps)]


@functools.lru_cache(maxsize=None)
def _reference(name, batch, groups):
    """JAX weights, a batch and two JAX steps accumulated over ``groups``
    micro-batches (shared by the cases that differ only in the port's
    schedule or engine)."""
    jm, params = _jax(name, batch)
    x = _randn(1, (batch, 32, 32, 3))
    y = np.arange(batch, dtype=np.int64) % 10
    return (params, x, y) + tuple(_jax_accumulated_reference(jm, params, x, y, groups))


def _against_jax(name, slice_method, mb, parts, junction, schedule, times=None):
    import jax

    from mpi4dl_tpu_torch.params import from_jax_params

    groups = parts if times is None else 2 * times * parts
    batch = groups * mb
    params, x, y, want_losses, want = _reference(name, batch, groups)
    m = _port(name, batch)
    from_jax_params(params, m)
    _, step, state = _sp_step(m, slice_method, mb, parts, junction, schedule, times)
    np.testing.assert_allclose(_train(step, state, x, y), want_losses, rtol=1e-4)
    got, want = _leaves(m), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("name,slice_method,mb,junction", [
    ("resnet", "vertical", 2, "gather"),
    ("flat", "square", 4, "batch_split"),
    ("flat", "square", 4, "gather"),
])
def test_sp_pipeline_matches_jax_accumulation(name, slice_method, mb, junction, schedule):
    _against_jax(name, slice_method, mb, 2, junction, schedule)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("name,slice_method,mb,junction,times,parts", [
    ("gap", "vertical", 2, "gather", 1, 1),
    ("gap", "vertical", 2, "gather", 2, 1),
    ("gap", "vertical", 2, "gather", 1, 2),
    ("flat", "square", 4, "batch_split", 1, 1),
    ("resnet", "vertical", 2, "gather", 1, 1),  # bn_aligned: 2·times·parts == S
])
def test_sp_gems_matches_jax_accumulation(name, slice_method, mb, junction, times, parts,
                                          schedule):
    _against_jax(name, slice_method, mb, parts, junction, schedule, times)


@pytest.mark.parametrize("gems", [False, True])
def test_amoebanet_tuple_junction_1f1b_matches_gpipe(gems):
    """AmoebaNet-D(3, 16)'s (x, skip) state crosses the junction, the
    lineup and the handoffs; 1F1B equals GPipe."""
    x = _randn(3, (4 if gems else 2, 64, 64, 3))
    y = np.arange(x.shape[0], dtype=np.int64)
    results = []
    for schedule in ("gpipe", "1f1b"):
        m = amoebanetd((1, 64, 64, 3), num_classes=10, num_layers=3, num_filters=16,
                       device="cpu")
        m.spatial_until = 4
        spp, step, state = _sp_step(m, "square", 1, 1 if gems else 2, "gather", schedule,
                                    times=1 if gems else None)
        assert isinstance(spp.tail_part.act_shapes[0][0], tuple)
        results.append((_train(step, state, x, y), _leaves(m)))
    (lg, pg), (lf, pf) = results
    np.testing.assert_allclose(lf, lg, rtol=1e-5)
    for a, b in zip(pf, pg):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=5e-5)


@pytest.mark.parametrize("gems", [False, True])
def test_batch_split_with_batchnorm_trains(gems):
    """ResNet on the 2x2 grid, ``batch_split`` of degree 4: no exact anchor
    (each shard normalised alone); finite, falling losses."""
    m = _port("resnet", 8)
    _, step, state = _sp_step(m, "square", 4, 1 if gems else 2, "batch_split", "gpipe",
                              times=1 if gems else None)
    losses = _train(step, state, _randn(2, (8, 32, 32, 3)),
                    np.arange(8, dtype=np.int64) % 10, steps=3)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_sp_pipeline_refuses_multi_level_and_mixed_backends():
    """Multi-level SP is ported: a level chain that does not end at the
    junction, or whose level 0 is not ``sp``, is refused; so is a mix of
    rank and one-process backends."""
    from mpi4dl_tpu_torch.parallel.stages import ProcessGroupStages

    m = _port("flat", 4)
    sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2))
    with pytest.raises(ValueError, match="ends at cell"):
        SPPipeline.build(m, 2, sp, 4, levels=[(1, sp), (3, sp)])
    lv = spatial_levels_for("square", [4, 2], tiles=TileGrid(2, 2))
    with pytest.raises(ValueError, match="level 0"):
        SPPipeline.build(m, 2, sp, 4, levels=[(1, lv[0]), (2, lv[1])])
    assert SPPipeline.build(m, 2, lv[0], 4, levels=[(1, lv[0]), (2, lv[1])]).levels
    spp = SPPipeline.build(m, 2, sp, 4)
    fake = ProcessGroupStages.__new__(ProcessGroupStages)
    fake.group, fake.num_stages, fake.stage, fake.local_stages = object(), 2, 0, (0,)
    with pytest.raises(ValueError, match="one tile and one stage a rank"):
        make_sp_pipeline_train_step(spp, Optimizer("sgd", lr=LR), fake, 2)


# ---------------------------------------------------------------------------
# Gloo ranks: 2 stages x 2 tiles.
# ---------------------------------------------------------------------------

RANK_JOBS = {  # name: (model, mb, parts, junction, schedule, times)
    "pp_gather": ("resnet", 2, 2, "gather", "gpipe", None),
    "pp_gather_1f1b": ("resnet", 2, 2, "gather", "1f1b", None),
    "pp_batch_split": ("resnet", 2, 2, "batch_split", "gpipe", None),
    "gems_gather": ("gap", 2, 1, "gather", "gpipe", 1),
    "gems_batch_split_1f1b": ("resnet", 2, 1, "batch_split", "1f1b", 1),
}


def _state_of(model):
    return [t.detach().numpy().copy() for t in model.state_dict().values()]


def _local_state(m, spp, stages):
    """This rank's tensors by state-dict index: the region's and its own
    tail stage's (the other stages' cells are released to meta)."""
    su = spp.spatial_until
    keep = set(range(su)) | {su + c for s in stages.local_stages
                             for c in range(*spp.tail_part.ranges[s])}
    return {i: t.detach().numpy().copy() for i, (k, t) in enumerate(m.state_dict().items())
            if int(k.split(".")[1]) in keep}


def _data_rank_main(rank, workdir: Path) -> None:
    """DP2 x 2 stages x 2 tiles: SP x PP (GPipe) and SP + GEMS (1F1B) from
    the JAX weights, two steps."""
    from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh
    from mpi4dl_tpu_torch.parallel.gems import gems_local_stages
    from mpi4dl_tpu_torch.parallel.stages import ProcessGroupStages

    mesh = build_process_mesh(MeshSpec(data=2, stage=2, spw=2))
    stages = ProcessGroupStages(2, mesh.stage_group)
    init = {k: torch.from_numpy(v) for k, v in np.load(workdir / "init.npz").items()}
    inputs = np.load(workdir / "inputs.npz")
    out = {}
    for job, parts, schedule, times in (("pp", 2, "gpipe", None), ("gems", 1, "1f1b", 1)):
        m = _port("resnet", 4)
        m.load_state_dict(init)
        sp = spatial_ctx_for("vertical", 2, tiles=mesh.tiles)
        spp = SPPipeline.build(m, 2, sp, 2, junction="gather")
        opt = Optimizer("sgd", lr=LR)
        kw = dict(schedule=schedule, with_data_axis=mesh.data)
        step = (make_sp_gems_train_step(spp, opt, stages, parts, times=times, **kw) if times
                else make_sp_pipeline_train_step(spp, opt, stages, parts, **kw))
        spp.tail_part.release_others(gems_local_stages(stages) if times
                                     else stages.local_stages)
        out[f"{job}_losses"] = _train(step, init_sp_pipeline_state(spp, opt, stages),
                                      inputs["x"], inputs["y"])
        for i, t in _local_state(m, spp, stages).items():
            out[f"{job}_{i}"] = t
    np.savez(workdir / f"out{rank}.npz", **out)


def _rank_main(job: str, rank: int, world: int, workdir: Path) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh
    from mpi4dl_tpu_torch.parallel.gems import gems_local_stages
    from mpi4dl_tpu_torch.parallel.stages import ProcessGroupStages

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    if job == "dp_sp_pp":
        _data_rank_main(rank, workdir)
        dist.destroy_process_group()
        return
    mesh = build_process_mesh(MeshSpec(stage=2, spw=2))
    stages = ProcessGroupStages(2, mesh.stage_group)
    inputs = np.load(workdir / "inputs.npz")
    out = {}
    for job, (name, mb, parts, junction, schedule, times) in RANK_JOBS.items():
        m = _port(name, 4).double()
        spp, step, state = _sp_step(m, "vertical", mb, parts, junction, schedule, times,
                                    stages=stages, tiles=mesh.tiles)
        spp.tail_part.release_others(gems_local_stages(stages) if times
                                     else stages.local_stages)
        out[f"{job}_losses"] = _train(step, state, inputs["x"], inputs["y"], steps=3)
        for i, t in _local_state(m, spp, stages).items():
            out[f"{job}_{i}"] = t
        if rank == 0:  # the one-process grid and chain
            m = _port(name, 4).double()
            _, step, state = _sp_step(m, "vertical", mb, parts, junction, schedule, times)
            out[f"{job}_grid_losses"] = _train(step, state, inputs["x"], inputs["y"], steps=3)
            for i, t in enumerate(_state_of(m)):
                out[f"{job}_grid_{i}"] = t
    np.savez(workdir / f"out{rank}.npz", **out)
    dist.destroy_process_group()


def test_gloo_ranks_match_the_one_process_grid(tmp_path):
    """2 stages x 2 tiles on four gloo ranks against the grid and chain:
    SP x PP under ``gather`` (GPipe, 1F1B) and ``batch_split``, SP + GEMS
    under both; three steps."""
    from test_torch_ring import launch_gloo_ranks

    np.savez(tmp_path / "inputs.npz", x=_randn(7, (4, 32, 32, 3)).astype(np.float64),
             y=np.arange(4, dtype=np.int64))
    launch_gloo_ranks("sp_pp", tmp_path, world=WORLD, script=__file__)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    for job, (name, *_) in RANK_JOBS.items():
        init = _state_of(_port(name, 4).double())
        keys = list(_port(name, 4).state_dict())
        grid = [outs[0][f"{job}_grid_{i}"] for i in range(len(init))]
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out[f"{job}_losses"], outs[0][f"{job}_grid_losses"],
                                       rtol=1e-5, err_msg=f"{job} rank {r}")
            checked = 0
            for i, k in enumerate(keys):
                if f"{job}_{i}" not in out.files:
                    continue  # another stage's tail cell (released to meta)
                upd, want = out[f"{job}_{i}"] - init[i], grid[i] - init[i]
                bound = 1e-3 * np.abs(want).max() + 1e-7
                assert np.abs(upd - want).max() <= bound, (job, r, k)
                checked += 1
            assert checked > len(keys) // 3, (job, r, checked)


def test_data_axis_on_eight_gloo_ranks_matches_jax(tmp_path):
    """DP2 x 2 stages x 2 tiles on eight gloo ranks (the setup of
    ``test_sp_pipeline.py::test_sp_pipeline_with_data_parallel``, red on
    this jax): SP x PP under GPipe and SP + GEMS under 1F1B against the JAX
    single-device step accumulated over the global batch's 4 micro-batches
    of 2, losses rtol 1e-4, parameters rtol 2e-3 / atol 1e-5."""
    from mpi4dl_tpu_torch.params import from_jax_params
    from test_torch_ring import launch_gloo_ranks

    params, x, y, want_losses, want = _reference("resnet", 8, 4)
    model = _port("resnet", 4)
    from_jax_params(params, model)
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    np.savez(tmp_path / "inputs.npz", x=x, y=y)
    launch_gloo_ranks("dp_sp_pp", tmp_path, world=8, script=__file__)
    ref = _port("resnet", 4)
    from_jax_params(want, ref)  # the JAX result in the port's tensor order
    ref_state = [t.numpy() for t in ref.state_dict().values()]
    for r in range(8):
        out = np.load(tmp_path / f"out{r}.npz")
        for job in ("pp", "gems"):
            np.testing.assert_allclose(out[f"{job}_losses"], want_losses, rtol=1e-4)
            got = [k for k in out.files if k.startswith(f"{job}_") and k[-1].isdigit()]
            assert len(got) > len(ref_state) // 3
            for k in got:
                np.testing.assert_allclose(out[k], ref_state[int(k.rsplit("_", 1)[1])],
                                           rtol=2e-3, atol=1e-5, err_msg=f"rank {r} {k}")


if __name__ == "__main__":
    _job, _rank, _world, _dir = sys.argv[1:5]
    _rank_main(_job, int(_rank), int(_world), Path(_dir))
