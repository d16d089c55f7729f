"""The runners under the supervised loop (mpi4dl_tpu_torch/benchmarks/
common.py over resilience/loop.py), on the CPU at a small size (ResNet-11
v2, 32², batch 2), against the JAX runner's resilience contract
(tests/test_resilience.py:184-222).

- Kill and resume: ``MPI4DL_FAULT=sigterm@2`` stops the run after step 2
  (``preempted``, ``final_step`` 3, ``ckpt_3`` saved, the runner returns);
  the resume's final loss equals an uninterrupted run's bitwise, and so
  does the last ``step`` record of the RunLog (``--telemetry-dir``).
- ``nan_batch@2`` with a checkpoint directory: one ``anomaly`` and one
  ``recovery`` record, the poison batch skipped, finite losses.
- ``--watchdog-secs`` with ``stall_data``: one stack dump with the memory
  lines on stderr; the run completes.
- On 2 and 4 gloo ranks (this file run as the ranks' script,
  tests/test_torch_ring.py's launcher): rank 1 alone delivers SIGTERM to
  itself before step 2 (``MPI4DL_FAULT`` set on rank 1 only); every rank
  reports the same ``final_step`` 3 and ``preempted``, ``ckpt_3`` passes
  ``cheap_validate``, and the resume ends bitwise where the uninterrupted
  run does, on every rank.  Four ranks: the ``sp`` runner (2x2 tiles, D2);
  two: the ``lp`` pipeline (2 stages).  On four ranks an async save of a
  runner's state has the manifest (CRCs, offsets, shapes, files) of the
  synchronous save of the same state.  A background-writer error latched
  on rank 0 alone (its ``on_saved`` raising after a commit) fails the next
  ``flush`` and the next ``save`` on every rank, instead of leaving the
  other ranks waiting in the save's collectives.
"""

import json
import math
import os
import sys
from datetime import timedelta
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_torch_ring import launch_gloo_ranks  # noqa: E402

SMALL = ["--device", "cpu", "--image-size", "32", "--num-layers", "1",
         "--batch-size", "2", "--steps-per-epoch", "4"]
# The rank jobs: world size -> (runner family, flags besides SMALL).
RANK_JOBS = {
    2: ("lp", ["--split-size", "2", "--parts", "2"]),
    4: ("sp", ["--num-spatial-parts", "4", "--halo-d2"]),
}


def _steps(tele):
    from mpi4dl_tpu_torch.obs import read_runlog

    recs = [r for p in sorted(Path(tele).glob("*.jsonl")) for r in read_runlog(str(p))]
    return recs, sorted((r for r in recs if r["kind"] == "step"), key=lambda r: r["t"])


def test_runner_kill_and_resume_bit_identical(tmp_path, monkeypatch):
    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.checkpoint import cheap_validate

    def argv(ck, tele):
        return SMALL + ["--checkpoint-dir", str(tmp_path / ck),
                        "--telemetry-dir", str(tmp_path / tele)]

    control = run("lp", "resnet", argv("ck_a", "tele_a"))
    monkeypatch.setenv("MPI4DL_FAULT", "sigterm@2")
    killed = run("lp", "resnet", argv("ck_b", "tele_b"))
    monkeypatch.delenv("MPI4DL_FAULT")
    assert killed["preempted"] and killed["final_step"] == 3
    assert len(killed["losses"]) == 3
    cheap_validate(str(tmp_path / "ck_b" / "ckpt_3"))
    resumed = run("lp", "resnet", argv("ck_b", "tele_b"))
    assert not resumed["preempted"] and resumed["start_step"] == 3
    assert resumed["final_step"] == 4 and resumed["loss"] == control["loss"]
    assert killed["losses"] + resumed["losses"] == control["losses"]
    recs, steps = _steps(tmp_path / "tele_b")
    assert steps[-1]["loss"] == control["loss"]
    kinds = [r["kind"] for r in recs]
    assert kinds.count("meta") == 2 and kinds.count("preempt") == 1
    assert kinds.count("restore") == 1 and kinds.count("summary") == 2
    (pre,) = [r for r in recs if r["kind"] == "preempt"]
    assert pre["gstep"] == 3 and pre["saved"]
    meta = recs[0]
    assert meta["backend"] == "cpu" and meta["torch_version"] == torch.__version__
    saves = control["checkpoint"]["saves"]
    assert [s["step"] for s in saves] == [0, 4]
    assert all(s["durable_ms"] >= s["stall_ms"] > 0 for s in saves)
    assert len(control["write_overlap"]) == len(control["step_ms"]) == 4


def test_runner_nan_batch_rolls_back(tmp_path, monkeypatch):
    from mpi4dl_tpu_torch.benchmarks.common import run

    monkeypatch.setenv("MPI4DL_FAULT", "nan_batch@2")
    out = run("lp", "resnet", SMALL + ["--checkpoint-dir", str(tmp_path / "ck"),
                                       "--telemetry-dir", str(tmp_path / "tele")])
    assert out["anomalies"] == 1 and out["final_step"] == 4 and not out["preempted"]
    assert len(out["losses"]) == 3 and all(math.isfinite(v) for v in out["losses"])
    recs, steps = _steps(tmp_path / "tele")
    (anomaly,) = [r for r in recs if r["kind"] == "anomaly"]
    (recovery,) = [r for r in recs if r["kind"] == "recovery"]
    assert anomaly["gstep"] == 2 and recovery["resumed_from"] == 0
    assert recovery["skipped_step"] == 2 and recovery["next_step"] == 3
    assert [r["gstep"] for r in steps] == [0, 1, 3]


def test_runner_watchdog_dumps_on_a_data_stall(tmp_path, monkeypatch, capfd):
    from mpi4dl_tpu_torch.benchmarks.common import run

    monkeypatch.setenv("MPI4DL_FAULT", "stall_data@2:0.6")
    out = run("lp", "resnet", SMALL + ["--watchdog-secs", "0.3",
                                       "--watchdog-compile-secs", "5"])
    assert out["final_step"] == 4 and len(out["losses"]) == 4
    err = capfd.readouterr().err
    assert err.count("watchdog: step 2 exceeded the 0.3s") == 1, err
    assert "memory: host rss peak" in err and "--- thread MainThread" in err


# ---------------------------------------------------------------------------
# Rank side (the spawned processes; no JAX).
# ---------------------------------------------------------------------------


def _rank_main(job: str, rank: int, world: int, workdir: Path) -> None:
    import torch.distributed as dist

    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.checkpoint import CheckpointManager, cheap_validate
    from mpi4dl_tpu_torch.resilience import AsyncCheckpointWriter

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    family, flags = RANK_JOBS[world]

    def argv(ck):
        return SMALL + flags + ["--checkpoint-dir", str(workdir / ck)]

    control = run(family, "resnet", argv("ck_a"))
    if rank == 1:
        os.environ["MPI4DL_FAULT"] = "sigterm@2"
    killed = run(family, "resnet", argv("ck_b"))
    os.environ.pop("MPI4DL_FAULT", None)
    dist.barrier()
    manifest, _ = cheap_validate(str(workdir / "ck_b" / "ckpt_3"))
    resumed = run(family, "resnet", argv("ck_b"))
    result = {"control": control["losses"], "loss": control["loss"],
              "killed": [killed["final_step"], killed["preempted"], killed["losses"]],
              "resumed": [resumed["start_step"], resumed["final_step"], resumed["loss"],
                          resumed["losses"]],
              "ckpt_3_leaves": len(manifest["leaves"])}
    if world == 4:
        # The uninterrupted run's state (restored), saved synchronously and
        # through the background writer on all four ranks.
        def on_restore(state, mgr):
            def twin(name):
                return CheckpointManager(str(workdir / name), fingerprint=mgr.fingerprint,
                                         identity=mgr.identity, layout=mgr.layout,
                                         layout_desc=mgr.layout_desc, group=mgr.group)

            twin("sync").save(state, 4)
            with AsyncCheckpointWriter(twin("async")) as w:
                w.save(state, 4)

        run(family, "resnet", argv("ck_a"), on_restore=on_restore)
    result["writer_errors"] = _latched_error_on_rank_0(rank, workdir)
    (workdir / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def _latched_error_on_rank_0(rank: int, workdir: Path) -> list:
    """Saves through the background writer whose ``on_saved`` raises on
    rank 0 alone; returns the errors this rank's flush and save raised."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch.checkpoint import CheckpointManager
    from mpi4dl_tpu_torch.resilience import AsyncCheckpointWriter, CheckpointWriteError

    def on_saved(stats):
        if rank == 0:
            raise OSError(f"telemetry disk full after step {stats.step_id}")

    group = dist.new_group(backend="gloo")
    w = AsyncCheckpointWriter(CheckpointManager(str(workdir / "ck_err"), group=group),
                              on_saved=on_saved)
    state, seen = {"w": torch.arange(8.0)}, []
    w.save(state, 1)
    try:
        w.flush()
    except CheckpointWriteError as e:
        seen.append(str(e))
    w.save(state, 2)
    w._q.join()  # rank 0's worker has latched step 2's error
    try:
        w.save(state, 3)
    except CheckpointWriteError as e:
        seen.append(str(e))
    w.close()
    dist.destroy_process_group(group)
    return seen


@pytest.fixture(scope="module", params=sorted(RANK_JOBS))
def rank_job(request, tmp_path_factory):
    world = request.param
    workdir = tmp_path_factory.mktemp(f"resilience_ranks{world}")
    launch_gloo_ranks("resilience", workdir, world=world, script=__file__)
    return world, workdir, [json.loads((workdir / f"rank{r}.json").read_text())
                            for r in range(world)]


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(rank_job):
    world, workdir, results = rank_job
    for r in results:
        final_step, preempted, losses = r["killed"]
        assert final_step == 3 and preempted and len(losses) == 3, r
        assert r["ckpt_3_leaves"] > 0
    assert sorted(os.listdir(workdir / "ck_b")) == ["ckpt_0", "ckpt_3", "ckpt_4"]


def test_rank_resume_after_sigterm_equals_uninterrupted(rank_job):
    world, _, results = rank_job
    for r in results:
        start, final, loss, losses = r["resumed"]
        assert start == 3 and final == 4
        assert loss == r["loss"] and r["killed"][2] + losses == r["control"]
    assert len({r["loss"] for r in results}) == 1


def test_writer_error_on_one_rank_fails_every_rank(rank_job):
    world, workdir, results = rank_job
    for r, res in enumerate(results):
        flushed, saved = res["writer_errors"]
        if r == 0:
            assert "telemetry disk full after step 1" in flushed
            assert "telemetry disk full after step 2" in saved
        else:
            assert flushed == saved == "background checkpoint write failed on another rank"
    assert sorted(os.listdir(workdir / "ck_err")) == ["ckpt_1", "ckpt_2"]


@pytest.mark.parametrize("rank_job", [4], indirect=True)
def test_async_rank_save_has_the_sync_manifest(rank_job):
    world, workdir, _ = rank_job
    sync = json.loads((workdir / "sync" / "ckpt_4" / "manifest.json").read_text())
    asyn = json.loads((workdir / "async" / "ckpt_4" / "manifest.json").read_text())
    assert len(sync["leaves"]) > 0 and asyn == sync


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
