"""GEMS in the PyTorch port (``parallel/gems.py``, the dual-stream tick
loops of ``parallel/stage_common.py``, the mirror exchange of
``parallel/stages.py``) against the JAX package on the CPU.

- The one-process stage chain against the JAX single-device step
  accumulated over all 2·times·parts micro-batches
  (``make_train_step(parts=...)``, in float64 as
  ``tests/test_torch_pipeline.py`` runs it), ResNet-11 v2 at 32², one
  image a micro-batch, at ``tests/test_gems.py``'s cases (its JAX engine
  is red on this jax): (times, parts) ∈ {(1,1), (1,2), (2,1)} over 4
  stages and (1, 2) over 3 (the middle stage mirrors itself), GPipe and
  1F1B.  Losses rtol 1e-4; parameters rtol 2e-3 / atol 1e-5.
- Gloo ranks (this file run as the ranks' script): one stage a rank, 4
  stages on four ranks and 3 on three (the self-mirrored middle rank),
  GPipe and 1F1B, bitwise equal to the chain, with the mirror stage's
  weights zeroed before the first step so that only the mirror exchange
  can fill them; DP2 x GEMS over 2 stages against the JAX accumulation
  over the whole batch's 8 micro-batches, the bounds above.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.parallel.gems import gems_local_stages, make_gems_train_step, stage_state
from mpi4dl_tpu_torch.parallel.partition import StagePartition
from mpi4dl_tpu_torch.parallel.pipeline import init_pipeline_state
from mpi4dl_tpu_torch.parallel.stages import StageChain
from mpi4dl_tpu_torch.train import Optimizer
from test_torch_pipeline import (
    LR, _jax_accumulated_reference, _jax_model, _jax_params, _leaves, _randn, _resnet,
    _stage_tensors,
)

TOL = dict(rtol=2e-3, atol=1e-5)
WORLD = 4


@functools.lru_cache(maxsize=None)
def _reference(groups):
    """JAX weights, a batch of ``groups`` images and two accumulated JAX
    steps over its ``groups`` micro-batches."""
    jmodel = _jax_model("resnet", groups)
    params = _jax_params(lambda: jmodel)
    x = _randn(11, (groups, 32, 32, 3))
    y = np.arange(groups, dtype=np.int64) % 10
    losses, want = _jax_accumulated_reference(jmodel, params, x, y, groups)
    return params, x, y, losses, want


def _gems(model, split, parts, times, schedule, stages=None, data=None):
    part = StagePartition.build(model, split, (1, 32, 32, 3))
    stages = stages or StageChain(split)
    opt = Optimizer("sgd", lr=LR)
    step = make_gems_train_step(part, opt, stages, parts, times=times, schedule=schedule,
                                with_data_axis=data)
    return part, step, init_pipeline_state(part, opt, stages)


def _train(step, state, x, y, steps=2):
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    return [float(step(state, x, y)[1]["loss"]) for _ in range(steps)]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("times,parts,split", [(1, 1, 4), (1, 2, 4), (2, 1, 4), (1, 2, 3)])
def test_gems_matches_jax_accumulation(schedule, times, parts, split):
    import jax

    from mpi4dl_tpu_torch.params import from_jax_params

    params, x, y, want_losses, want = _reference(2 * times * parts)
    m = _resnet(1)
    from_jax_params(params, m)
    _, step, state = _gems(m, split, parts, times, schedule)
    np.testing.assert_allclose(_train(step, state, x, y), want_losses, rtol=1e-4)
    got, want = _leaves(m), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_gems_rejects_a_batch_it_cannot_pair():
    _, step, state = _gems(_resnet(1), 2, 2, 1, "gpipe")
    with pytest.raises(ValueError, match="2\\*times\\*parts=4"):
        step(state, torch.zeros((6, 32, 32, 3)), torch.zeros(6, dtype=torch.long))


# ---------------------------------------------------------------------------
# Gloo ranks.
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

    def fresh():
        m = _resnet(1)
        m.load_state_dict(init)
        return m

    three = dist.new_group([0, 1, 2])
    for split, group in ((4, None), (3, three)):
        if split == 3 and rank == 3:
            continue
        stages = ProcessGroupStages(split, group)
        for schedule in ("gpipe", "1f1b"):
            m = fresh()
            part, step, state = _gems(m, split, 2, 1, schedule, stages=stages)
            part.release_others(gems_local_stages(stages))
            if stages.mirror != stages.stage:
                with torch.no_grad():  # only the mirror exchange may fill it
                    for t in stage_state(part, stages.mirror):
                        t.zero_()
            key = f"s{split}_{schedule}"
            out[f"{key}_losses"] = _train(step, state, inputs["x4"], inputs["y4"])
            for i, t in enumerate(_stage_tensors(part, stages.stage)):
                out[f"{key}_p{i}"] = t
            if rank == 0:  # the one-process chain, on the ranks' thread count
                m = fresh()
                part, step, state = _gems(m, split, 2, 1, schedule)
                out[f"{key}_chain_losses"] = _train(step, state, inputs["x4"], inputs["y4"])
                for s in range(split):
                    for i, t in enumerate(_stage_tensors(part, s)):
                        out[f"{key}_chain_s{s}_p{i}"] = t
    mesh = build_process_mesh(MeshSpec(data=2, stage=2))
    dpp = ProcessGroupStages(2, mesh.stage_group)
    for schedule in ("gpipe", "1f1b"):
        part, step, state = _gems(fresh(), 2, 2, 1, schedule, stages=dpp, data=mesh.data)
        part.release_others(gems_local_stages(dpp))
        out[f"dp_{schedule}_losses"] = _train(step, state, inputs["x8"], inputs["y8"])
        for i, t in enumerate(_stage_tensors(part, dpp.stage)):
            out[f"dp_{schedule}_p{i}"] = t
    np.savez(workdir / f"out{rank}.npz", **out)
    dist.destroy_process_group()


def test_gems_on_gloo_ranks_matches_chain_and_jax(tmp_path):
    """One stage a rank: 4 and 3 stages, GPipe and 1F1B, bitwise equal to
    the one-process chain; DP2 x GEMS over 2 stages against the JAX
    accumulation over the batch's 8 micro-batches."""
    from mpi4dl_tpu_torch.params import from_jax_params
    from test_torch_ring import launch_gloo_ranks

    params, x8, y8, want_losses, want = _reference(8)
    model = _resnet(1)
    from_jax_params(params, model)
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    np.savez(tmp_path / "inputs.npz", x4=x8[:4], y4=y8[:4], x8=x8, y8=y8)
    launch_gloo_ranks("gems", tmp_path, world=WORLD, script=__file__)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    chain = outs[0]
    for split in (4, 3):
        for schedule in ("gpipe", "1f1b"):
            key = f"s{split}_{schedule}"
            for r in range(split):
                out = outs[r]
                np.testing.assert_array_equal(out[f"{key}_losses"],
                                              chain[f"{key}_chain_losses"])
                keys = sorted(k for k in out.files if k.startswith(f"{key}_p"))
                assert keys
                for k in keys:
                    np.testing.assert_array_equal(
                        out[k], chain[k.replace(f"{key}_p", f"{key}_chain_s{r}_p")],
                        err_msg=f"{key} stage {r} {k}")

    ref = _resnet(1)
    from_jax_params(want, ref)  # the JAX result in the port's tensor order
    ref_part = StagePartition.build(ref, 2, (1, 32, 32, 3))
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
