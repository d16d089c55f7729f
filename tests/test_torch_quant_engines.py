"""The engines of the PyTorch port under ``--quant`` (mpi4dl_tpu_torch/quant
wired into parallel/ and train.py), held to the JAX package's gates.

JAX's engine tests of the policy (``test_quant.py:494-568``) are red on
jax 0.9, so the port is held to their gates on its own exact runs: the
quantized step's losses finite, descending and within 5% of the exact
run's (the A/B convergence gate), for the SP step, SP x PP, GPipe, GEMS;
``None`` and a spec that parses to off build the same engine, losses
bitwise; ``benchmarks/quant_sensitivity.py`` holds a quantized step's
first gradients to the exact step's.  On four gloo ranks (one launch; the
ranks run this file as their script and never import JAX):

- the SP step with every class on against its exact run, and with the
  junction and respatial classes on against the one-process grid in
  float64 at the port's rank-vs-grid tolerance (losses rtol 1e-6, the
  parameters' updates atol 1e-8): one level under ``gather`` and
  ``batch_split`` (the all_to_all), two levels through the coarsening ring
  (vertical 4 → 2) and the gather path (square 4 → 2);
- GPipe over four stages with ``handoff=int8`` bitwise equal to the
  one-process chain's; DP2 x PP2 and SP x PP with every class on within 5%
  of their exact runs;
- GEMS over four stages with every class on: the mirror copies pulled at a
  step's start equal the home parameters bitwise, and the handoff bytes
  are the activations' alone (no mirror bytes in ``WIRE_BYTES``);
- the ``sp`` runner with ``--quant int8`` writes the resolved spec into its
  checkpoint layout.
"""

import json
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch import layers as L
from mpi4dl_tpu_torch.cells import CellModel, LayerCell
from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for, spatial_levels_for
from mpi4dl_tpu_torch.parallel.gems import make_gems_train_step
from mpi4dl_tpu_torch.parallel.partition import StagePartition
from mpi4dl_tpu_torch.parallel.pipeline import init_pipeline_state, make_pipeline_train_step
from mpi4dl_tpu_torch.parallel.sp_pipeline import (
    SPPipeline, init_sp_pipeline_state, make_sp_pipeline_train_step,
)
from mpi4dl_tpu_torch.parallel.stages import StageChain
from mpi4dl_tpu_torch.parallel.tiles import TileGrid
from mpi4dl_tpu_torch.quant import QuantPolicy
from mpi4dl_tpu_torch.quant import collectives as qc
from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_spatial_train_step

WORLD = 4
LR = 0.02
GAP = 0.05  # the JAX gate: |quantized - exact| <= 5% of the exact loss
INT8 = "int8"
ACT = "junction=int8,respatial=int8"
GRIDS = {"square": (2, 2), "vertical": (1, 4)}


def _model(batch, bn=True, dtype=torch.float32, until=3):
    norm = (lambda c: [L.BatchNorm(c)]) if bn else (lambda c: [])
    m = CellModel([LayerCell([L.Conv2d(3, 16, 3), *norm(16), L.ReLU()], name="c0"),
                   LayerCell([L.Conv2d(16, 16, 3, stride=2), *norm(16), L.ReLU()],
                             name="c1"),
                   LayerCell([L.Conv2d(16, 16, 3), *norm(16), L.ReLU()], name="c2"),
                   LayerCell([L.GlobalAvgPool(), L.Dense(16, 10)], name="head")],
                  (batch, 32, 32, 3), 10)
    m.to(dtype)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.spatial_until = until
    return m


def _batch(n, dtype=torch.float32):
    x = np.random.default_rng(3).standard_normal((n, 32, 32, 3)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.arange(n) % 10


def _losses(step, state, x, y, steps):
    return [float(step(state, x, y)[1]["loss"]) for _ in range(steps)]


def _sp(spec, tiles=None, method="square", parts=(4,), stops=(3,), junction="gather",
        local_dp=None, bn=True, dtype=torch.float32, batch=4):
    model = _model(batch, bn, dtype)
    ctxs = spatial_levels_for(method, list(parts), tiles=tiles or TileGrid(*GRIDS[method]))
    opt = Optimizer("sgd", lr=LR)
    step = make_spatial_train_step(model, opt, ctxs[0], junction=junction,
                                   local_dp=local_dp, levels=list(zip(stops, ctxs)),
                                   compute_dtype=dtype, quant=QuantPolicy.parse(spec))
    return model, step, TrainState.create(model, opt)


def _pipe(spec, split, parts, batch, stages=None, data=None, gems=False):
    model = _model(batch)
    groups = parts * (2 if gems else 1) * (data.size if data is not None else 1)
    part = StagePartition.build(model, split, (batch // groups, 32, 32, 3))
    stages = stages or StageChain(split)
    opt = Optimizer("sgd", lr=LR)
    make = make_gems_train_step if gems else make_pipeline_train_step
    step = make(part, opt, stages, parts, with_data_axis=data,
                quant=QuantPolicy.parse(spec))
    return part, step, init_pipeline_state(part, opt, stages)


def _sppp(spec, stages=None, tiles=None, batch=4):
    model = _model(batch, until=2)
    sp = spatial_ctx_for("vertical", 2, tiles=tiles or TileGrid(1, 2))
    spp = SPPipeline.build(model, 2, sp, batch // 2, junction="gather")
    stages = stages or StageChain(2)
    opt = Optimizer("sgd", lr=LR)
    step = make_sp_pipeline_train_step(spp, opt, stages, 2, quant=QuantPolicy.parse(spec))
    return spp, step, init_sp_pipeline_state(spp, opt, stages)


def _gate(q, exact):
    assert all(np.isfinite(q)), q
    assert q[-1] < q[0], f"quantized run did not descend: {q}"
    for a, b in zip(exact, q):
        assert abs(a - b) <= GAP * max(abs(a), 1e-6), (exact, q)


# ---------------------------------------------------------------------------
# One process.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["sp", "gpipe"])
def test_off_builds_todays_engine_bitwise(engine):
    """``quant=None``, a spec that parses to off and no ``quant`` at all
    give the same losses, bit for bit."""
    x, y = _batch(4)
    runs = []
    for spec in (None, "off", "junction=off", "absent"):
        if engine == "sp":
            model = _model(4)
            sp = spatial_ctx_for("square", 4, tiles=TileGrid(2, 2))
            opt = Optimizer("sgd", lr=LR)
            kw = {} if spec == "absent" else {"quant": QuantPolicy.parse(spec)}
            step = make_spatial_train_step(model, opt, sp, **kw)
            state = TrainState.create(model, opt)
        else:
            model = _model(4)
            part = StagePartition.build(model, 2, (2, 32, 32, 3))
            opt = Optimizer("sgd", lr=LR)
            kw = {} if spec == "absent" else {"quant": QuantPolicy.parse(spec)}
            step = make_pipeline_train_step(part, opt, StageChain(2), 2, **kw)
            state = init_pipeline_state(part, opt, StageChain(2))
        runs.append(_losses(step, state, x, y, 2))
    assert all(r == runs[0] for r in runs), runs


@pytest.mark.parametrize("junction,local_dp", [("gather", None), ("batch_split", 4)])
def test_sp_step_int8_tracks_the_exact_step_on_the_grid(junction, local_dp):
    """The SP step on the one-process 2x2 grid, every class int8 (the grid
    has no tile reduction for the grad class), four steps."""
    x, y = _batch(4)
    exact = _losses(*_sp(None, junction=junction, local_dp=local_dp)[1:], x, y, 4)
    qc.reset_wire_bytes()
    q = _losses(*_sp(INT8, junction=junction, local_dp=local_dp)[1:], x, y, 4)
    _gate(q, exact)
    assert 0 < qc.WIRE_BYTES["junction"] < 0.55 * qc.RAW_BYTES["junction"]
    assert qc.WIRE_BYTES["grad"] == qc.RAW_BYTES["grad"] == 0


def test_multilevel_step_int8_tracks_the_exact_step_on_the_grid():
    x, y = _batch(4)
    kw = dict(method="vertical", parts=(4, 2), stops=(2, 3))
    exact = _losses(*_sp(None, **kw)[1:], x, y, 4)
    qc.reset_wire_bytes()
    q = _losses(*_sp(INT8, **kw)[1:], x, y, 4)
    _gate(q, exact)
    assert 0 < qc.WIRE_BYTES["respatial"] < 0.55 * qc.RAW_BYTES["respatial"]


def test_gpipe_handoff_int8_descends_on_the_chain():
    """``test_quant.py:531-568``: the handoff class alone, GPipe over two
    stages, both directions quantized."""
    x, y = _batch(4)
    exact = _losses(*_pipe(None, 2, 2, 4)[1:], x, y, 3)
    qc.reset_wire_bytes()
    q = _losses(*_pipe("handoff=int8", 2, 2, 4)[1:], x, y, 3)
    _gate(q, exact)
    assert 0 < qc.WIRE_BYTES["handoff"] < 0.3 * qc.RAW_BYTES["handoff"]


def test_sp_pipeline_and_gems_int8_track_the_exact_steps_on_the_chain():
    x, y = _batch(4)
    _gate(_losses(*_sppp(INT8)[1:], x, y, 3), _losses(*_sppp(None)[1:], x, y, 3))
    _gate(_losses(*_pipe(INT8, 2, 1, 4, gems=True)[1:], x, y, 3),
          _losses(*_pipe(None, 2, 1, 4, gems=True)[1:], x, y, 3))


def test_grid_respatial_ring_is_the_kept_copys_view():
    """On the grid a replicated target tile is held once, as the copy the
    gather keeps sees it: its own source piece exact, the other decoded
    from its encode (the ranks' ring, bitwise per device in
    ``test_torch_quant.py``)."""
    from mpi4dl_tpu_torch.parallel import tiles as T
    from mpi4dl_tpu_torch.quant.kernels import roundtrip

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, 16, 8))
                         .astype(np.float32))
    base = TileGrid(1, 4)
    got = T.respatial(base.scatter(x), base, base.level(1, 2), INT8, 256, "respatial")
    full = base.level(1, 2).gather(got)
    want = torch.cat([x[:, :, 0:4], roundtrip(x[:, :, 4:8], INT8, 256),
                      x[:, :, 8:12], roundtrip(x[:, :, 12:16], INT8, 256)], dim=2)
    assert torch.equal(full, want)


def test_sensitivity_tool_holds_the_first_gradients_to_the_exact_steps(capsys):
    """``benchmarks/quant_sensitivity.py`` on the CPU at a shallow
    AmoebaNet-D(3, 8) 256² bs1 SP step, which is not chaotic: one JSON line
    a run; the int8 step's first gradients within 2% of the exact step's in
    relative L2 and 1e-3 in norm, as is the exact step on an input moved
    by 1e-6; on the card by default."""
    from mpi4dl_tpu_torch.benchmarks import quant_sensitivity as tool

    argv = ["--engine", "sp", "--image-size", "256", "--num-layers", "3",
            "--num-filters", "8", "--batch-size", "1", "--steps", "2", "--spec", INT8,
            "--probe", "1e-6"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(argv)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: one thread beats many on a loaded host
    try:
        assert tool.main(argv + ["--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(v) for v in capsys.readouterr().out.splitlines()]
    assert [v["run"] for v in lines] == ["exact", INT8, "exact, input moved by 1e-06"]
    for v in lines[1:]:
        assert np.isfinite(v["losses"]).all() and v["loss_gap"] < 1e-3
        assert 0 < v["grad_rel_l2"] < 0.02 and 0 < v["first_cell_rel_l2"] < 0.02
        assert abs(v["grad_norm_ratio"] - 1) < 1e-3
        assert abs(v["first_cell_norm_ratio"] - 1) < 1e-3


# ---------------------------------------------------------------------------
# Four gloo ranks: the rank side (no JAX).
# ---------------------------------------------------------------------------

RANK_SP = {  # name: _sp keywords (float64 runs against the grid)
    "gather": dict(),
    "a2a": dict(junction="batch_split", local_dp=4, bn=False),
    "ring": dict(method="vertical", parts=(4, 2), stops=(2, 3), bn=False),
    "gather_path": dict(parts=(4, 2), stops=(2, 3), bn=False),
}


def _tensors(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    import torch.distributed as dist

    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh
    from mpi4dl_tpu_torch.parallel.stages import ProcessGroupStages
    from mpi4dl_tpu_torch.parallel.tiles import ProcessGroupTiles

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    out = {}
    x, y = _batch(4)
    for spec in (None, INT8):
        out[f"sp_{spec}"] = _losses(*_sp(spec, ProcessGroupTiles(2, 2))[1:], x, y, 4)
    x64 = x.double()
    for name, kw in RANK_SP.items():
        tiles = ProcessGroupTiles(*GRIDS[kw.get("method", "square")])
        model, step, state = _sp(ACT, tiles, dtype=torch.float64, **kw)
        out[f"act_{name}_losses"] = _losses(step, state, x64, y, 2)
        out.update({f"act_{name}_{k}": v for k, v in _tensors(model).items()})

    stages = ProcessGroupStages(4)
    part, step, state = _pipe("handoff=int8", 4, 2, 4, stages=stages)
    out["pp_losses"] = _losses(step, state, x, y, 2)
    r0, r1 = part.ranges[rank]
    out.update({f"pp_{i}": t.detach().numpy() for i, t in
                enumerate(p for c in part.model.cells[r0:r1] for p in c.state_dict().values())})
    if rank == 0:
        part, step, state = _pipe("handoff=int8", 4, 2, 4)
        out["chain_losses"] = _losses(step, state, x, y, 2)
        for s in range(4):
            r0, r1 = part.ranges[s]
            out.update({f"chain_{s}_{i}": t.detach().numpy() for i, t in enumerate(
                p for c in part.model.cells[r0:r1] for p in c.state_dict().values())})

    # GEMS: record what the mirror moves during a quantized step.
    part, step, state = _pipe(INT8, 4, 1, 4, stages=stages, gems=True)
    sent, got = [], []
    swap = stages.swap_mirror

    def recording_swap(send, recv):
        swap(send, recv)
        sent.append(send.clone())
        got.append(recv.clone())

    stages.swap_mirror = recording_swap
    _losses(step, state, x, y, 1)
    home = [t.detach().clone() for c in part.model.cells[rank:rank + 1]
            for t in c.state_dict().values()]
    out["gems_home"] = torch.cat([t.reshape(-1).double() for t in home]).numpy()
    sent.clear(), got.clear()
    qc.reset_wire_bytes()
    _losses(step, state, x, y, 1)
    stages.swap_mirror = swap
    out["gems_pulled"] = got[0].double().numpy()  # the first swap is the pull
    out["gems_wire"] = np.array([qc.WIRE_BYTES[c] for c in qc.CLASSES])
    out["gems_raw"] = np.array([qc.RAW_BYTES[c] for c in qc.CLASSES])
    out["gems_act"] = np.array([t for t in part.act_shapes[rank + 1]]
                               if rank < 3 else [0])

    mesh = build_process_mesh(MeshSpec(data=2, stage=2))
    dpp = ProcessGroupStages(2, mesh.stage_group)
    for spec in (None, INT8):
        _, step, state = _pipe(spec, 2, 2, 8, stages=dpp, data=mesh.data)
        out[f"dp_{spec}"] = _losses(step, state, *_batch(8), 3)
    mesh = build_process_mesh(MeshSpec(stage=2, spw=2))
    sstages = ProcessGroupStages(2, mesh.stage_group)
    for spec in (None, INT8):
        spp, step, state = _sppp(spec, sstages, mesh.tiles)
        spp.tail_part.release_others(sstages.local_stages)
        out[f"sppp_{spec}"] = _losses(step, state, x, y, 3)

    flags = ["--device", "cpu", "--image-size", "32", "--num-layers", "1",
             "--batch-size", "2", "--steps-per-epoch", "2", "--num-spatial-parts", "4",
             "--quant", "int8", "--checkpoint-dir", str(workdir / "ckpt")]
    res = run("sp", "resnet", flags)
    out["runner_wire"] = np.array([res["wire_bytes"][c] for c in qc.CLASSES])
    out["runner_raw"] = np.array([res["raw_bytes"][c] for c in qc.CLASSES])
    out = {k: np.asarray(v) for k, v in out.items()}
    np.savez(workdir / f"out{rank}.npz", **out)
    if rank == 0:
        (workdir / "runner.json").write_text(json.dumps({"quant": res["quant"]}))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_ring import launch_gloo_ranks

    workdir = tmp_path_factory.mktemp("quant_engines")
    launch_gloo_ranks("engines", workdir, script=__file__)
    return workdir, [np.load(workdir / f"out{r}.npz") for r in range(WORLD)]


def test_sp_step_int8_on_ranks_tracks_the_exact_step(ranks):
    _, outs = ranks
    for out in outs:
        _gate(list(out["sp_int8"]), list(out["sp_None"]))
        np.testing.assert_array_equal(out["sp_int8"], outs[0]["sp_int8"])


@pytest.mark.parametrize("name", sorted(RANK_SP))
def test_ranks_match_the_grid_with_junction_and_respatial_on(ranks, name):
    _, outs = ranks
    x, y = _batch(4, torch.float64)
    model, step, state = _sp(ACT, dtype=torch.float64, **RANK_SP[name])
    init = _tensors(_model(4, RANK_SP[name].get("bn", True), torch.float64))
    losses = _losses(step, state, x, y, 2)
    grid = _tensors(model)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"act_{name}_losses"], losses, rtol=1e-6)
        for k, v in grid.items():
            np.testing.assert_allclose(out[f"act_{name}_{k}"] - init[k], v - init[k],
                                       rtol=0, atol=1e-8, err_msg=f"{name} {r} {k}")


def test_gpipe_handoff_int8_on_ranks_is_the_chains_bitwise(ranks):
    _, outs = ranks
    chain = outs[0]
    for s, out in enumerate(outs):
        np.testing.assert_array_equal(out["pp_losses"], chain["chain_losses"])
        keys = sorted(k for k in out.files if k.startswith("pp_") and k[3:].isdigit())
        assert keys
        for k in keys:
            np.testing.assert_array_equal(out[k], chain[f"chain_{s}_{k[3:]}"])


def test_dp_pp_and_sp_pp_int8_on_ranks_track_the_exact_steps(ranks):
    _, outs = ranks
    for out in outs:
        _gate(list(out["dp_int8"]), list(out["dp_None"]))
        _gate(list(out["sppp_int8"]), list(out["sppp_None"]))


def test_gems_mirror_moves_parameters_exactly(ranks):
    """The mirror copy of stage S-1-d pulled at the start of a step with
    every class int8 equals that stage's home parameters bitwise, and the
    step's bytes are its handoffs alone: each stage boundary's activation
    and cotangent of both streams, fp32; no mirror bytes, no gradient bytes
    (no data axis)."""
    _, outs = ranks
    for d, out in enumerate(outs):
        np.testing.assert_array_equal(out["gems_pulled"], outs[3 - d]["gems_home"])
    raw = sum(o["gems_raw"] for o in outs)
    wire = sum(o["gems_wire"] for o in outs)
    cls = list(qc.CLASSES)
    acts = sum(int(np.prod(o["gems_act"])) for o in outs[:3])
    # Two streams x forward and backward, one micro-batch each, fp32.
    assert raw[cls.index("handoff")] == 2 * 2 * acts * 4
    assert 0 < wire[cls.index("handoff")] < 0.3 * raw[cls.index("handoff")]
    for c in ("junction", "respatial", "grad"):
        assert raw[cls.index(c)] == wire[cls.index(c)] == 0


def test_runner_records_the_resolved_spec_in_its_checkpoint_layout(ranks):
    workdir, outs = ranks
    want = "junction=int8,respatial=int8,grad=int8,handoff=int8"
    assert json.loads((workdir / "runner.json").read_text())["quant"] == want
    manifests = sorted((workdir / "ckpt").glob("ckpt_*/manifest.json"))
    assert manifests
    for m in manifests:
        assert json.loads(m.read_text())["layout_desc"]["quant_resolved"] == want
    cls = list(qc.CLASSES)
    for out in outs:
        for c in ("junction", "grad"):
            assert 0 < out["runner_wire"][cls.index(c)] < 0.55 * out["runner_raw"][cls.index(c)]


if __name__ == "__main__":
    _job, _rank, _world, _dir = sys.argv[1:5]
    _rank_main(int(_rank), int(_world), Path(_dir))
