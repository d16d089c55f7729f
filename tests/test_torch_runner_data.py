"""The runners' data and checkpoint flow (mpi4dl_tpu_torch/benchmarks/
common.py) against the JAX runner (benchmarks/common.py).

- The batches: under ``--app 3`` global step ``g`` trains on
  ``SyntheticDataset(seed).batch(g % steps_per_epoch, global_batch)`` of the
  JAX package, as the JAX runner does (an earlier port trained every step
  on one fixed ``torch.randn`` batch); ``--app 1`` feeds the image folder's
  batches likewise.
- Runner against runner: the JAX runner writes ``ckpt_0`` (before its first
  step) and ``ckpt_2``; the port's runner resumes a copy of ``ckpt_0`` and
  trains the same two steps.  Model and tolerances of
  tests/test_torch_train.py: AmoebaNet-D(3, 16), 128², batch 2, SGD; the
  first step's loss within rtol 1e-4, the second's within rtol 5e-3.  The
  parameters are not compared: the JAX runner computes in fp32, and XLA's
  fp32 gradient of this model is off from float64 by up to 4.4% near the
  input (tests/test_torch_train.py holds them against float64 instead).
- Resume: a run stopped at an epoch boundary and resumed ends with the
  same checkpoint, bit for bit, as an uninterrupted run, for the ``lp``
  family on one process and for ``sp`` (2x2 tiles), ``gems`` (4 stages) and
  the ``lp`` pipeline (4 stages) on four gloo ranks, which run this file as
  their script (``tests/test_torch_ring.py``'s launcher).  Every leaf is
  written once, by one rank; each rank checkpoint then restores elastically
  into the one-process ``lp`` runner, bitwise equal to the saved leaves.
"""

import json
import os
import shutil
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_torch_ring import launch_gloo_ranks  # noqa: E402

SMALL = ["--device", "cpu", "--image-size", "32", "--num-layers", "1",
         "--batch-size", "2", "--steps-per-epoch", "2"]
# The rank families: (name, runner family, flags besides SMALL).
RANK_RUNS = [
    ("sp", "sp", ["--num-spatial-parts", "4", "--halo-d2"]),
    ("gems", "gems", ["--split-size", "4", "--parts", "1"]),
    ("pp", "lp", ["--split-size", "4", "--parts", "2"]),
]


def _recording_build(monkeypatch, seen):
    """Wrap the runner's step to record each batch it is fed."""
    from mpi4dl_tpu_torch.benchmarks import common

    real = common._build

    def build(*a, **k):
        step, state, notes, tail = real(*a, **k)

        def rec(state, x, y):
            seen.append((x.numpy().copy(), y.numpy().copy()))
            return step(state, x, y)

        return rec, state, notes, tail

    monkeypatch.setattr(common, "_build", build)


@pytest.mark.parametrize("workers", [0, 2])
def test_runner_feeds_the_jax_runners_batches(monkeypatch, workers):
    from mpi4dl_tpu.data import SyntheticDataset
    from mpi4dl_tpu_torch.benchmarks.common import run

    seen = []
    _recording_build(monkeypatch, seen)
    out = run("lp", "resnet", SMALL + ["--num-epochs", "2", "--seed", "3",
                                       "--num-workers", str(workers)])
    assert len(seen) == 4 and len(out["losses"]) == 4
    ds = SyntheticDataset(32, 10, seed=3)
    for g, (x, y) in enumerate(seen):
        wx, wy = ds.batch(g % 2, 2)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy.astype(np.int64))


def test_runner_trains_on_an_image_folder(monkeypatch, tmp_path):
    from mpi4dl_tpu.data import ImageFolderDataset
    from mpi4dl_tpu_torch.benchmarks.common import run

    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(tmp_path / f"class{c}")
        for i in range(3):
            img = rng.integers(0, 256, size=(40, 40, 3), dtype=np.uint8)
            with open(tmp_path / f"class{c}" / f"{i}.ppm", "wb") as f:
                f.write(b"P6\n40 40\n255\n" + img.tobytes())
    seen = []
    _recording_build(monkeypatch, seen)
    out = run("lp", "resnet", SMALL + ["--app", "1", "--datapath", str(tmp_path),
                                       "--num-classes", "2", "--num-workers", "1"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    ds = ImageFolderDataset(str(tmp_path), 32, 2)
    for g, (x, y) in enumerate(seen):
        wx, wy = ds.batch(g, 2)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


def test_runner_times_its_wait_for_each_batch(monkeypatch):
    """A batch that takes 0.2 s to make, with no worker ahead: the loop's
    wait for it (``fetch_ms``) holds that time, the step meter (the JAX
    runner's, from the batch in hand) does not, and fed img/s counts both."""
    import time

    from mpi4dl_tpu_torch import data
    from mpi4dl_tpu_torch.benchmarks.common import run

    real = data.SyntheticDataset.batch

    def slow(self, idx, batch_size):
        time.sleep(0.2)
        return real(self, idx, batch_size)

    monkeypatch.setattr(data.SyntheticDataset, "batch", slow)
    out = run("lp", "resnet", SMALL + ["--num-epochs", "2", "--num-workers", "0"])
    assert len(out["fetch_ms"]) == 4 and min(out["fetch_ms"]) >= 200.0
    steps = out["stats"]["mean_ms"]
    fed = 2 / ((steps + sum(out["fetch_ms"][1:]) / 3) / 1e3)
    assert out["fed_images_per_sec"] == pytest.approx(fed, rel=1e-9)
    assert out["fed_images_per_sec"] < out["images_per_sec"]


def test_lp_resume_equals_uninterrupted(tmp_path, capsys):
    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.checkpoint import load_arrays

    a = SMALL + ["--checkpoint-dir", str(tmp_path / "a")]
    first = run("lp", "resnet", a)
    assert first["start_step"] == 0 and first["final_step"] == 2
    resumed = run("lp", "resnet", a + ["--num-epochs", "2"])
    assert "resuming from checkpoint step 2" in capsys.readouterr().out
    assert resumed["start_step"] == 2 and resumed["final_step"] == 4
    assert not resumed["elastic"] and len(resumed["losses"]) == 2
    whole = run("lp", "resnet", SMALL + ["--num-epochs", "2", "--checkpoint-dir",
                                         str(tmp_path / "b")])
    assert resumed["losses"] == whole["losses"][2:]
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt_0", "ckpt_2", "ckpt_4"]
    got, _ = load_arrays(str(tmp_path / "a" / "ckpt_4"))
    want, _ = load_arrays(str(tmp_path / "b" / "ckpt_4"))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_runner_resumes_the_jax_runners_checkpoint(tmp_path, monkeypatch):
    import benchmarks.common as jcommon
    from mpi4dl_tpu.checkpoint import load_arrays as jload
    from mpi4dl_tpu_torch.benchmarks.common import run

    flags = ["--model", "amoebanet", "--image-size", "128", "--num-layers", "3",
             "--num-filters", "16", "--num-classes", "10", "--batch-size", "2",
             "--lr", "0.01", "--no-remat", "--steps-per-epoch", "2", "--seed", "2"]
    jlosses = []
    real = jcommon.build_train

    def build_train(*a, **k):
        step, *rest = real(*a, **k)

        def rec(state, x, y):
            state, m = step(state, x, y)
            jlosses.append(float(m["loss"]))
            return state, m

        return (rec, *rest)

    monkeypatch.setattr(jcommon, "build_train", build_train)
    jout = jcommon.run("lp", "amoebanet", flags + ["--checkpoint-dir", str(tmp_path / "j")])
    assert jout["final_step"] == 2 and len(jlosses) == 2
    os.makedirs(tmp_path / "t")
    shutil.copytree(tmp_path / "j" / "ckpt_0", tmp_path / "t" / "ckpt_0")
    out = run("lp", "amoebanet", flags + ["--device", "cpu", "--checkpoint-dir",
                                          str(tmp_path / "t")])
    assert out["start_step"] == 0 and out["final_step"] == 2 and not out["elastic"]
    np.testing.assert_allclose(out["losses"][0], jlosses[0], rtol=1e-4)
    np.testing.assert_allclose(out["losses"][1], jlosses[1], rtol=5e-3)
    want, _ = jload(str(tmp_path / "j" / "ckpt_2"))
    from mpi4dl_tpu_torch.checkpoint import load_arrays

    got, _ = load_arrays(str(tmp_path / "t" / "ckpt_2"))
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape and str(got[k].dtype)[6:] == str(want[k].dtype)


# ---------------------------------------------------------------------------
# Rank side (the spawned processes; no JAX).
# ---------------------------------------------------------------------------


def _rank_main(job: str, rank: int, world: int, workdir: Path) -> None:
    import torch.distributed as dist

    from mpi4dl_tpu_torch.benchmarks.common import run

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    results = {}
    for name, family, flags in RANK_RUNS:
        a = SMALL + flags + ["--checkpoint-dir", str(workdir / f"{name}_a")]
        run(family, "resnet", a)
        resumed = run(family, "resnet", a + ["--num-epochs", "2"])
        whole = run(family, "resnet", SMALL + flags + [
            "--num-epochs", "2", "--checkpoint-dir", str(workdir / f"{name}_b")])
        results[name] = {"resumed": resumed["losses"], "whole": whole["losses"],
                         "start": resumed["start_step"]}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        (workdir / "results.json").write_text(json.dumps(results))


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("runner_ranks")
    launch_gloo_ranks("checkpoints", workdir, script=__file__)
    return workdir, json.loads((workdir / "results.json").read_text())


@pytest.mark.parametrize("name", [r[0] for r in RANK_RUNS])
def test_rank_resume_equals_uninterrupted(rank_runs, name):
    from mpi4dl_tpu_torch.checkpoint import SHARD_MANIFEST, load_arrays

    workdir, results = rank_runs
    r = results[name]
    assert r["start"] == 2 and r["resumed"] == r["whole"][2:]
    got, _ = load_arrays(str(workdir / f"{name}_a" / "ckpt_4"))
    want, _ = load_arrays(str(workdir / f"{name}_b" / "ckpt_4"))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # Each leaf written once, by one rank, as one shard.
    path = workdir / f"{name}_a" / "ckpt_4"
    manifest = json.loads((path / SHARD_MANIFEST).read_text())
    assert all(len(leaf["shards"]) == 1 for leaf in manifest["leaves"])
    assert len(list(path.glob("*.bin"))) == len(manifest["leaves"])


@pytest.mark.parametrize("name", [r[0] for r in RANK_RUNS])
def test_rank_checkpoint_restores_elastically_on_one_process(rank_runs, tmp_path, name):
    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.checkpoint import load_arrays, state_leaves

    workdir, _ = rank_runs
    shutil.copytree(workdir / f"{name}_a", tmp_path / "ck")
    checked = []

    def on_restore(state, mgr):
        saved, step_id = load_arrays(mgr.last_restore.path)
        leaves = state_leaves(state)
        assert step_id == 4 and len(leaves) == len(saved)
        for i, leaf in enumerate(leaves):
            assert torch.equal(leaf.full(), saved[f"leaf_{i}"]), i
        checked.append(len(leaves))

    out = run("lp", "resnet", SMALL + ["--num-epochs", "2", "--checkpoint-dir",
                                       str(tmp_path / "ck")], on_restore=on_restore)
    assert out["elastic"] and out["start_step"] == 4 and out["losses"] == []
    assert checked and checked[0] > 0


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
