"""The port's memory probe (mpi4dl_tpu_torch/benchmarks/mem_probe.py, the
counterpart of benchmarks/mem_probe.py) and the kernels' fake launches.

- A runner's step on fake tensors (``FakeTensorMode``) has exactly the
  tracked peak of the same step run for real on the CPU (the plain
  versions; no tolerance: the same storages are allocated and freed in the
  same order).
- With the card's kernels (``--kernels card``: K1/K2 allocate what their
  launches allocate), the fake peak is not above the plain versions'.
- On four fake ranks of the ``lp`` runner (4 stages, parts 4), 1F1B's
  peak is below GPipe's: the JAX package's CI gate
  (``--require-1f1b-win``); the CLI tabulates the roles and applies it.
- K1/K2's and K3's fake launches return what the kernels return; K2's
  partial-statistics rows are as many as the smallest tile of the
  library's plans gives, never fewer than a launch on the card takes.
- The planner's ``compile_probe`` runs the probe in a subprocess: a peak
  for a buildable config, ``INFEASIBLE`` for one that fails or times out.
"""

from __future__ import annotations

import json
import subprocess

import pytest
import torch

from mpi4dl_tpu_torch.benchmarks import mem_probe as mp
from mpi4dl_tpu_torch.config import config_from_args, get_parser
from mpi4dl_tpu_torch.ops import flash_attention as fa
from mpi4dl_tpu_torch.ops import halo_conv as hc
from mpi4dl_tpu_torch.resilience import INFEASIBLE, compile_probe

RESNET = "--model resnet --image-size 32 --num-layers 1".split()


def _cfg(argv):
    return config_from_args(get_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [
    ["--batch-size", "2", "--parts", "2"],
    ["--batch-size", "2", "--pallas-conv", "--precision", "bf_16"],
])
def test_fake_peak_equals_the_real_cpu_peak(argv):
    cfg = _cfg(RESNET + argv)
    fake = mp.probe_role(cfg, "lp", kernels="plain")
    real = mp.probe_role(cfg, "lp", kernels="plain", real=True)
    assert fake["peak_bytes"] == real["peak_bytes"] > 0
    assert fake["by_category"] == real["by_category"]


def test_card_kernels_fake_peak_not_above_the_plain_one():
    cfg = _cfg(RESNET + ["--batch-size", "2", "--pallas-conv", "--precision", "bf_16"])
    card = mp.probe_role(cfg, "lp", kernels="card")
    plain = mp.probe_role(cfg, "lp", kernels="plain")
    assert 0 < card["peak_bytes"] <= plain["peak_bytes"]
    assert not torch.cuda.is_initialized()


LP4 = RESNET + ["--batch-size", "4", "--split-size", "4", "--parts", "4"]


def test_four_fake_ranks_1f1b_below_gpipe():
    """The JAX package's CI gate, each of the four roles probed in this
    process as rank r of 4 on the fake process group."""
    peaks = {s: [mp.probe_role(mp._runner_cfg(LP4, s), "lp", r)["peak_bytes"]
                 for r in range(4)] for s in ("gpipe", "1f1b")}
    assert max(peaks["1f1b"]) < max(peaks["gpipe"])
    # Every stage counts its own step: the last holds its 4 micro-batches'
    # inputs under GPipe and 1 under 1F1B (the other stages' weights, moved
    # to the meta device, are not this rank's bytes).
    assert peaks["gpipe"][3] > peaks["1f1b"][3] > 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("win", [True, False])
def test_family_cli_tabulates_the_roles(tmp_path, monkeypatch, win):
    """``--family lp --schedule both --require-1f1b-win``: a role a stage
    and schedule (stubbed: the subprocess path is ``compile_probe``'s
    test's), the largest role's peak a schedule, the win, the table, the
    RunLog record, and exit 1 when 1F1B does not win."""
    seen = []

    def role(argv, schedule, rank):
        seen.append((schedule, rank))
        assert "--schedule" not in argv and "--parts" in argv
        big = 3 * 2**30 if schedule == "gpipe" or not win else 2**30
        return {"rank": rank, "peak_bytes": big + rank, "by_category": {}}

    monkeypatch.setattr(mp, "_role_in_subprocess", role)
    out = tmp_path / "probe.json"
    rc = mp.main(["--family", "lp", "--schedule", "both", "--require-1f1b-win", "--out",
                  str(out), "--telemetry-dir", str(tmp_path / "tele"), *LP4])
    assert rc == (0 if win else 1)
    assert sorted(seen) == [(s, r) for s in ("1f1b", "gpipe") for r in range(4)]
    data = json.loads(out.read_text())
    rows = data["schedules"]
    assert data["ranks"] == 4
    assert [r["rank"] for r in rows["gpipe"]["roles"]] == [0, 1, 2, 3]
    for s in ("gpipe", "1f1b"):
        assert rows[s]["peak_bytes"] == max(r["peak_bytes"] for r in rows[s]["roles"])
        assert rows[s]["peak_gb_est"] == round(rows[s]["peak_bytes"] / 2**30, 3)
    assert data["win_1f1b_bytes"] == rows["gpipe"]["peak_bytes"] - rows["1f1b"]["peak_bytes"]
    assert data["win_1f1b_bytes"] == (2 * 2**30 if win else 0)
    assert "1f1b win" in data["table"]
    from mpi4dl_tpu_torch.obs import read_runlog

    recs = read_runlog(str(next((tmp_path / "tele").glob("*.jsonl"))))
    assert [r["kind"] for r in recs] == ["meta", "mem_probe"]
    assert recs[1]["schedules"]["1f1b"]["peak_bytes"] == rows["1f1b"]["peak_bytes"]


@pytest.mark.parametrize("argv, code, says", [
    pytest.param(["--min-coverage", "0.9"], 2, "need --attribute", id="argv0-2-A15"),
    pytest.param(["--sweep-junction"], 2, "probes the sp family", id="argv1-2-A15"),
    (["--family", "lp", "--schedule", "gpipe", "--require-1f1b-win"], 2, "both"),
])
def test_cli_refuses_what_it_cannot_do(argv, code, says, capsys):
    assert mp.main(argv) == code
    assert says in capsys.readouterr().err


def test_role_ranks_are_one_a_stage():
    from mpi4dl_tpu_torch.mesh import MeshSpec

    assert mp.role_ranks(MeshSpec(stage=4)) == [0, 1, 2, 3]
    assert mp.role_ranks(MeshSpec(data=2, stage=2, sph=2, spw=2)) == [0, 4]
    assert mp.role_ranks(MeshSpec(sph=2, spw=2)) == [0]


@pytest.mark.parametrize("dtype, stats", [(torch.bfloat16, True), (torch.float32, True),
                                          (torch.bfloat16, False)])
def test_fake_launches_return_what_the_kernels_return(dtype, stats):
    from torch._subclasses.fake_tensor import FakeTensorMode

    win = (1, 5, 0, 6) if stats else None
    with FakeTensorMode(), hc.fake_launches():
        x = torch.empty(2, 8, 12, 16, dtype=dtype)
        w = torch.empty(3, 7, 16, 24, dtype=dtype)
        out = hc.halo_conv2d(x, w, fuse_relu=True, stat_window=win)
        q = torch.empty(4, 32, 64, dtype=dtype)
        o, m, l = fa.block_flash(q, q, q, causal=True)
        grads = fa.block_flash_bwd(q, q, q, m, o, l)
    ref = hc.halo_conv2d_plain(torch.zeros(2, 8, 12, 16, dtype=dtype),
                               torch.zeros(3, 7, 16, 24, dtype=dtype),
                               fuse_relu=True, stat_window=win)
    for got, want in zip(out if stats else [out], ref if stats else [ref]):
        assert got.shape == want.shape and got.dtype == want.dtype
    assert (o.shape, m.shape, l.shape) == ((4, 32, 64), (4, 32), (4, 32))
    assert all(g.dtype == torch.float32 and g.shape == (4, 32, 64) for g in grads)
    assert hc.LAUNCHES == {"halo_conv2d": 0, "halo_conv2d_stats": 0}
    assert fa.LAUNCHES == {"block_flash": 0, "block_flash_bwd": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_k2_scratch_covers_every_tile_plan(dtype):
    """K2's fake launch allocates ``[2, ceil(m / 64), Cout]`` fp32 partials:
    one row a 64-pixel tile, the smallest any plan of ``halo_conv.cu``
    takes, so never fewer rows than the card's launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class Empties(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.empty and out.dtype == torch.float32:
                self.shapes.append(tuple(out.shape))
            return out

    with FakeTensorMode(), hc.fake_launches():
        x = torch.empty(1, 130, 134, 16, dtype=dtype)  # m = 128 x 128 pixels
        w = torch.empty(3, 7, 16, 416, dtype=dtype)
        with Empties() as seen:
            hc.halo_conv2d(x, w, stat_window=(0, 128, 0, 128))
    assert seen.shapes[-1] == (2, 16384 // hc.FAKE_TILE_M, 416)
    assert hc.FAKE_TILE_M == 64


def test_compile_probe_runs_the_port_probe(tmp_path, monkeypatch):
    """One real probe subprocess (its peak read from the JSON it writes);
    a probe that exits non-zero or times out is ``INFEASIBLE``, one that
    cannot start is None (the subprocess stubbed)."""
    from mpi4dl_tpu_torch.resilience import planner

    monkeypatch.setenv("MPI4DL_FAULT", "oom_step@0")
    probe = compile_probe("lp", "resnet", timeout=300)
    flags = {"image-size": 32, "num-layers": 1, "batch-size": 2, "parts": 2,
             "device": "cpu", "checkpoint-dir": str(tmp_path)}
    peak = probe(flags, {})
    assert isinstance(peak, float) and 0 <= peak < 0.1

    def failing(cmd, **kw):
        assert cmd[1:3] == ["-m", "mpi4dl_tpu_torch.benchmarks.mem_probe"]
        assert "MPI4DL_FAULT" not in kw["env"]  # a probe never re-fires a fault
        assert kw["env"]["MPI4DL_STRIPE_BWD"] == "1"  # the plan's hatches reach it
        return subprocess.CompletedProcess(cmd, 1, b"", b"ValueError: 3 images in 2 parts")

    def timing_out(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    for stub, want in ((failing, INFEASIBLE), (timing_out, INFEASIBLE), (missing, None)):
        monkeypatch.setattr(planner.subprocess, "run", stub)
        assert probe({**flags, "batch-size": 3}, {"MPI4DL_STRIPE_BWD": "1"}) == want
