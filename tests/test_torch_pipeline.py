"""The pipeline engine of the PyTorch port (``parallel/partition.py``,
``stages.py``, ``stage_common.py``, ``pipeline.py``): GPipe and 1F1B on
one process (``StageChain``) and on gloo ranks (``ProcessGroupStages``),
against the JAX package on the CPU.

- GPipe against the JAX single-device step accumulated over the same
  micro-batches (``make_train_step(parts=...)``), as
  ``tests/test_pipeline.py`` holds the JAX pipeline (its engine is red on
  this jax: ``metric_psum``'s backward), at that test's cases (ResNet-11
  v2, 32², batch 4) and with AmoebaNet-D(3, 16)'s (x, skip) tuple state and
  BatchNorm at ``tests/test_torch_train.py``'s size (128², batch 2).  The
  reference runs in float64, as ``test_torch_train.py``'s does, for the
  reason it gives.  Losses rtol 1e-4, parameters rtol 2e-3 / atol 5e-5
  (``test_pipeline.py``'s tolerances).
- 1F1B against GPipe: losses rtol 1e-5, parameters ``TOL`` of
  ``tests/test_1f1b.py:54`` (rtol 2e-3 / atol 5e-5).
- Four gloo ranks (this file run as the ranks' script, as
  ``test_torch_ring.py`` spawns them): one stage a rank, GPipe and 1F1B,
  bitwise equal to ``StageChain``; DP2 x PP2 against the JAX single-device
  step accumulated over the whole batch's micro-batches (the setup of
  ``test_1f1b.py::test_1f1b_matches_gpipe_lp_dp``; its JAX engine is red
  here), the same tolerances.
- ``resid_depth`` against the JAX function, and the dry run's launch
  counts of a 1F1B step (``halo_conv.count_dispatches``).

The port runs its plain kernels on CPU tensors.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.models import amoebanetd, get_resnet_v2
from mpi4dl_tpu_torch.parallel.partition import StagePartition
from mpi4dl_tpu_torch.parallel.pipeline import init_pipeline_state, make_pipeline_train_step
from mpi4dl_tpu_torch.parallel.stages import StageChain
from mpi4dl_tpu_torch.train import Optimizer

LR = 0.01
TOL = dict(rtol=2e-3, atol=5e-5)
RESNET = (4, 32, 32, 3)
WORLD = 4


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _resnet(batch=4):
    return get_resnet_v2((batch, 32, 32, 3), 11, 10, device="cpu", seed=0)


def _pipeline(model, split, parts, batch, schedule="gpipe", stages=None,
              data=None, remat=True, **kw):
    mb = batch // parts // (data.size if data is not None else 1)
    part = StagePartition.build(model, split, (mb, *model.in_shape[1:]), **kw)
    stages = stages or StageChain(split)
    opt = Optimizer("sgd", lr=LR)
    step = make_pipeline_train_step(part, opt, stages, parts, schedule=schedule,
                                    with_data_axis=data, remat=remat)
    return part, step, init_pipeline_state(part, opt, stages)


def _train(step, state, x, y, steps=2):
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    return [float(step(state, x, y)[1]["loss"]) for _ in range(steps)]


def _jax_params(model_fn):
    import jax

    params, _ = model_fn().init(jax.random.key(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _leaves(model):
    import jax

    from mpi4dl_tpu_torch.params import to_jax_layout

    return jax.tree.leaves(to_jax_layout(model))


AMOEBA = (2, 128, 128, 3)


def _amoeba():
    return amoebanetd(AMOEBA, num_classes=10, num_layers=3, num_filters=16,
                      device="cpu")


def _jax_model(name, batch):
    from mpi4dl_tpu.models.amoebanet import amoebanetd as j_amoebanetd
    from mpi4dl_tpu.models.resnet import get_resnet_v2 as j_resnet_v2

    if name == "resnet":
        return j_resnet_v2((batch, 32, 32, 3), depth=11, num_classes=10)
    return j_amoebanetd(AMOEBA, num_classes=10, num_layers=3, num_filters=16)


def _jax_accumulated_reference(jmodel, params32, x, y, parts, steps=2):
    """``steps`` steps of the JAX single-device step accumulated over
    ``parts`` micro-batches (``make_train_step(parts=...)``), in float64;
    the losses and the final parameters."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.train import (
        Optimizer as JOptimizer, TrainState as JTrainState, make_train_step,
    )

    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params32)
        opt = JOptimizer("sgd", lr=LR)
        step = make_train_step(jmodel, opt, parts=parts, compute_dtype=jnp.float64)
        state = JTrainState.create(params, opt)
        xx, yy = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.int32)
        losses = []
        for _ in range(steps):
            state, m = step(state, xx, yy)
            losses.append(float(m["loss"]))
        return losses, jax.tree.map(lambda a: np.asarray(a, np.float32), state.params)


@pytest.mark.parametrize("model,parts,split", [
    ("resnet", 1, 2), ("resnet", 2, 4), ("resnet", 4, 2), ("amoebanet", 2, 4),
])
def test_gpipe_matches_jax_accumulation(model, parts, split):
    """GPipe against the JAX single-device step accumulated over the same
    micro-batches, two steps (the cases of ``test_pipeline.py``; AmoebaNet
    carries its (x, skip) tuple over the stage boundaries)."""
    import jax

    from mpi4dl_tpu_torch.params import from_jax_params

    batch = 4 if model == "resnet" else 2
    jmodel = _jax_model(model, batch)
    params = _jax_params(lambda: jmodel)
    x = _randn(1, RESNET if model == "resnet" else AMOEBA)
    y = np.arange(batch, dtype=np.int64)
    want_losses, want = _jax_accumulated_reference(jmodel, params, x, y, parts)
    m = _resnet() if model == "resnet" else _amoeba()
    from_jax_params(params, m)
    part, step, state = _pipeline(m, split, parts, batch)
    if model == "amoebanet":
        assert any(isinstance(s[0], tuple) for s in part.act_shapes[1:-1])
    np.testing.assert_allclose(_train(step, state, x, y), want_losses, rtol=1e-4)
    got = _leaves(m)
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("model,parts,split", [
    ("resnet", 2, 4), ("resnet", 4, 2), ("resnet", 4, 4), ("amoebanet", 2, 4),
])
def test_1f1b_matches_gpipe(model, parts, split):
    batch = 4 if model == "resnet" else 2
    x = _randn(3, RESNET if model == "resnet" else AMOEBA)
    y = np.arange(batch, dtype=np.int64)
    results = []
    for schedule in ("gpipe", "1f1b"):
        m = _resnet() if model == "resnet" else _amoeba()
        _, step, state = _pipeline(m, split, parts, batch, schedule=schedule)
        results.append((_train(step, state, x, y), _leaves(m)))
    (lg, pg), (lf, pf) = results
    np.testing.assert_allclose(lf, lg, rtol=1e-5)
    for a, b in zip(pf, pg):
        np.testing.assert_allclose(a, b, **TOL)


def test_schedules_return_the_input_cotangent_and_undo_the_loss_scale():
    """Both schedules' ``grad_x`` (stage 0's input cotangent per
    micro-batch, which SP x PP needs) equals autograd's gradient of the
    mean micro-batch loss of the whole model; ``loss_scale`` leaves the
    step's parameters unchanged (rtol 1e-6 / atol 1e-9)."""
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
    from mpi4dl_tpu_torch.parallel.stage_common import gpipe, one_f_one_b
    from mpi4dl_tpu_torch.train import make_loss_fn

    x = torch.from_numpy(_randn(6, RESNET))
    y = torch.arange(4)
    model = _resnet()
    part = StagePartition.build(model, 4, (2, 32, 32, 3))
    ctx = ApplyCtx(train=True)
    xs = x.detach().requires_grad_()
    loss_fn = make_loss_fn(model, ctx)
    loss = sum(loss_fn(a, b)[0] for a, b in zip(xs.chunk(2), y.chunk(2))) / 2
    (want,) = torch.autograd.grad(loss, [xs])
    for schedule in (gpipe, one_f_one_b):
        res = schedule(part, StageChain(4), ctx, x.chunk(2), y.chunk(2), seed=0.5,
                       grad_x=True)
        np.testing.assert_allclose(torch.cat(res.grad_x).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-8)
    leaves = []
    for scale in (1.0, 128.0):
        m = _resnet()
        part = StagePartition.build(m, 4, (2, 32, 32, 3))
        step = make_pipeline_train_step(part, Optimizer("sgd", lr=LR), StageChain(4), 2,
                                        loss_scale=scale, schedule="1f1b")
        step(init_pipeline_state(part, Optimizer("sgd", lr=LR), StageChain(4)), x, y)
        leaves.append(_leaves(m))
    for a, b in zip(*leaves):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)


def test_resid_depth_matches_jax():
    from mpi4dl_tpu.parallel.stage_common import resid_depth as j_resid_depth
    from mpi4dl_tpu_torch.parallel.stage_common import resid_depth

    assert [resid_depth(s) for s in range(1, 9)] == [j_resid_depth(s) for s in range(1, 9)]


def test_1f1b_dry_run_counts_the_recompute():
    """The dry run (kernels on, each call counted and run as its plain
    version; here on small CPU tensors, as it runs on the meta device at
    full size): GPipe without remat makes one K2 per fused window and
    micro-batch and one K1 (its dx) per K2; 1F1B adds one K2 per window of
    every stage but the last (its recompute) and no K1; GPipe with remat
    recomputes every stage."""
    from mpi4dl_tpu_torch.layer_ctx import ApplyCtx, SpatialCtx
    from mpi4dl_tpu_torch.ops import halo_conv as hc

    shape = (4, 64, 64, 3)
    model = amoebanetd(shape, num_classes=10, num_layers=3, num_filters=16, device="cpu")
    part = StagePartition.build(model, 4, (1, 64, 64, 3))
    windows = []  # K2 windows of each stage for one micro-batch
    a = torch.zeros((1, 64, 64, 3))
    ctx = ApplyCtx(train=True, spatial=SpatialCtx(use_pallas_conv=True))
    with torch.no_grad():
        for s in range(4):
            with hc.count_dispatches() as seen:
                a = part.apply(s, a, ctx)
            windows.append(seen.counts["halo_conv2d_stats"])
    x, y = torch.from_numpy(_randn(5, shape)), torch.arange(4)
    opt = Optimizer("sgd", lr=LR)
    counts = {}
    for name, schedule, remat in (("gpipe", "gpipe", False), ("remat", "gpipe", True),
                                  ("1f1b", "1f1b", False)):
        step = make_pipeline_train_step(part, opt, StageChain(4), 4, schedule=schedule,
                                        remat=remat, pallas_conv=True)
        with hc.count_dispatches() as seen:
            step(init_pipeline_state(part, opt, StageChain(4)), x, y)
        counts[name] = seen.counts
    k2 = 4 * sum(windows)
    assert k2 > 0 and all(windows)
    assert counts["gpipe"] == {"halo_conv2d_stats": k2, "halo_conv2d": k2}
    assert counts["1f1b"] == {"halo_conv2d_stats": k2 + 4 * sum(windows[:-1]),
                              "halo_conv2d": k2}
    assert counts["remat"] == {"halo_conv2d_stats": 2 * k2, "halo_conv2d": k2}


# ---------------------------------------------------------------------------
# Four gloo ranks.
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, workdir: Path) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from mpi4dl_tpu_torch.mesh import MeshSpec, build_process_mesh
    from mpi4dl_tpu_torch.parallel.stages import ProcessGroupStages

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    init = {k: torch.from_numpy(v) for k, v in np.load(workdir / "init.npz").items()}
    inputs = np.load(workdir / "inputs.npz")
    out = {}

    def fresh(batch):
        m = _resnet(batch)
        m.load_state_dict(init)
        return m

    stages = ProcessGroupStages(4)
    for schedule in ("gpipe", "1f1b"):
        m = fresh(4)
        part, step, state = _pipeline(m, 4, 4, 4, schedule=schedule, stages=stages)
        out[f"{schedule}_losses"] = _train(step, state, inputs["x4"], inputs["y4"])
        for i, t in enumerate(_stage_tensors(part, stages.stage)):
            out[f"{schedule}_p{i}"] = t
        if rank == 0:  # the one-process chain, on the ranks' thread count
            m = fresh(4)
            part, step, state = _pipeline(m, 4, 4, 4, schedule=schedule)
            out[f"{schedule}_chain_losses"] = _train(step, state, inputs["x4"],
                                                     inputs["y4"])
            for s in range(4):
                for i, t in enumerate(_stage_tensors(part, s)):
                    out[f"{schedule}_chain_s{s}_p{i}"] = t
    mesh = build_process_mesh(MeshSpec(data=2, stage=2))
    dpp = ProcessGroupStages(2, mesh.stage_group)
    for schedule in ("gpipe", "1f1b"):
        m = fresh(8)
        part, step, state = _pipeline(m, 2, 2, 8, schedule=schedule, stages=dpp,
                                      data=mesh.data)
        out[f"dp_{schedule}_losses"] = _train(step, state, inputs["x8"], inputs["y8"])
        for i, t in enumerate(_stage_tensors(part, dpp.stage)):
            out[f"dp_{schedule}_p{i}"] = t
    np.savez(workdir / f"out{rank}.npz", **out)
    dist.destroy_process_group()


def _stage_tensors(part, s):
    r0, r1 = part.ranges[s]
    return [t.detach().numpy().copy() for cell in part.model.cells[r0:r1]
            for t in cell.state_dict().values()]


def test_process_group_stages_match_chain_and_jax(tmp_path):
    """One stage a rank on four gloo ranks: GPipe and 1F1B bitwise equal to
    the one-process chain; DP2 x PP2 against the JAX single-device step
    accumulated over the batch's four micro-batches."""
    from mpi4dl_tpu_torch.params import from_jax_params
    from test_torch_ring import launch_gloo_ranks

    jmodel = _jax_model("resnet", 8)
    params = _jax_params(lambda: jmodel)
    model = _resnet()
    from_jax_params(params, model)
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    x8, y8 = _randn(4, (8, 32, 32, 3)), np.arange(8, dtype=np.int64) % 10
    np.savez(tmp_path / "inputs.npz", x4=x8[:4], y4=y8[:4], x8=x8, y8=y8)
    launch_gloo_ranks("pp", tmp_path, world=WORLD, script=__file__)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    chain = outs[0]
    for schedule in ("gpipe", "1f1b"):
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out[f"{schedule}_losses"],
                                          chain[f"{schedule}_chain_losses"])
            keys = sorted(k for k in out.files if k.startswith(f"{schedule}_p"))
            assert keys
            for k in keys:
                np.testing.assert_array_equal(
                    out[k], chain[k.replace(f"{schedule}_p", f"{schedule}_chain_s{r}_p")],
                    err_msg=f"{schedule} stage {r} {k}")

    want_losses, want = _jax_accumulated_reference(jmodel, params, x8, y8, 4)
    ref = _resnet()
    from_jax_params(want, ref)  # the JAX result in the port's tensor order
    ref_part = StagePartition.build(ref, 2, (2, 32, 32, 3))
    for schedule in ("gpipe", "1f1b"):
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out[f"dp_{schedule}_losses"], want_losses, rtol=1e-4)
            want_stage = _stage_tensors(ref_part, r % 2)  # rank r holds stage r % 2
            assert len(want_stage) == sum(k.startswith(f"dp_{schedule}_p") for k in out.files)
            for i, b in enumerate(want_stage):
                np.testing.assert_allclose(out[f"dp_{schedule}_p{i}"], b, **TOL)


if __name__ == "__main__":
    _job, _rank, _world, _dir = sys.argv[1:5]
    _rank_main(int(_rank), int(_world), Path(_dir))
