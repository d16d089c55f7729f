"""Package rules of the PyTorch port: no JAX and nothing of mpi4dl_tpu
inside it, no silent drop to the CPU, and unported engines refused by
name."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpi4dl_tpu_torch.config import config_from_args, get_parser
from mpi4dl_tpu_torch.models import amoebanetd, build_model

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "mpi4dl_tpu"}


def _port_files():
    files = sorted((ROOT / "mpi4dl_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), r) for f in files
           for r in _imported_roots(f) if r in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys, mpi4dl_tpu_torch, mpi4dl_tpu_torch.__main__, "
            "mpi4dl_tpu_torch.params, mpi4dl_tpu_torch.distributed, "
            "mpi4dl_tpu_torch.ops.flash_attention, mpi4dl_tpu_torch.ops.ring, "
            "mpi4dl_tpu_torch.models.seqblock, mpi4dl_tpu_torch.mesh, "
            "mpi4dl_tpu_torch.benchmarks.common, "
            "mpi4dl_tpu_torch.benchmarks.communication.ring.benchmark_ring_attention; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mpi4dl_tpu')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amoebanetd((1, 32, 32, 3), num_layers=3, num_filters=16)
    cfg = config_from_args(get_parser().parse_args(
        ["--model", "amoebanet", "--num-layers", "3", "--num-filters", "16"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    from mpi4dl_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--num-layers", "3", "--num-filters", "16", "--steps", "1"])
    assert build_model(cfg, device="cpu").cells[0].conv.kernel.device.type == "cpu"


def test_long_context_entry_points_raise_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from mpi4dl_tpu_torch.benchmarks.communication.ring import (
        benchmark_ring_attention as tool,
    )
    from mpi4dl_tpu_torch.models.seqblock import SeqBlock, make_seq_cp_train_step

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeqBlock(16, 2)
    blocks = torch.nn.ModuleList([SeqBlock(16, 2, device="cpu")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_seq_cp_train_step(blocks, None, 1, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--seq-len", "32", "--heads", "2", "--dim", "8"])
    step = make_seq_cp_train_step(blocks, None, 1, 0.1, device="cpu")
    assert step(torch.zeros((1, 8, 16)), torch.ones((1, 8, 16))).item() > 0
    assert tool.main(["--seq-len", "32", "--heads", "2", "--dim", "8", "--iterations",
                      "1", "--warmup", "0", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["validation"] == "pass" and out["platform"] == "cpu"
    assert set(out["variants"]) == {"flash", "einsum"}


def test_main_runs_on_cpu_when_asked(capsys):
    from mpi4dl_tpu_torch.__main__ import main

    main(["--model", "amoebanet", "--image-size", "32", "--num-layers", "3",
          "--num-filters", "16", "--batch-size", "2", "--pallas-conv", "--steps", "1",
          "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step 0: loss")
    assert '"launches"' in out[-1]


# Items ported since the flags were first refused: their flags now parse.
PORTED = {"A5", "A6", "A7", "A8", "A10", "A11"}


@pytest.mark.parametrize("flags,item", [
    (["--num-spatial-parts", "4"], "A5"),
    (["--spatial-until", "3"], "A5"),
    (["--halo-d2"], "A6"),
    (["--split-size", "2"], "A7"),
    (["--data-parallel", "2"], "A7"),
    (["--enable-gems"], "A8"),
    (["--times", "2"], "A8"),
    (["--app", "1"], "A10"),
    (["--checkpoint-dir", "ckpt"], "A10"),
    (["--stripe-bwd"], "A11"),
    (["--quant", "int8"], "A13"),
    (["--num-spatial-parts", "4,2"], "A11"),
    (["--local-DP", "2"], "A7"),
])
def test_unported_flags_raise(flags, item):
    """A flag of an engine not ported yet raises and names its ROADMAP
    item; the flags of the ported engines (A5-A8, A10 and A11: spatial
    parallelism, the data axis, the pipelines, GEMS, data loading and
    checkpoints, multi-level SP and the stripe-wise backward) parse."""
    if item in PORTED:
        cfg = config_from_args(get_parser().parse_args(flags))
        assert cfg.enable_gems == ("--enable-gems" in flags)
        assert cfg.times == (2 if "--times" in flags else 1)
        assert cfg.num_spatial_parts == ((4, 2) if "4,2" in flags else (4,))
        assert cfg.stripe_bwd == ("--stripe-bwd" in flags)
        assert cfg.spatial_until in (None, 3) and cfg.halo_d2 == ("--halo-d2" in flags)
        assert cfg.split_size == (2 if "--split-size" in flags else 1)
        assert cfg.data_parallel == (2 if "--data-parallel" in flags else 1)
        assert cfg.local_dp_lp == (2 if "--local-DP" in flags else 1)
        assert cfg.app == (1 if "--app" in flags else 3)
        assert cfg.checkpoint_dir == ("ckpt" if "--checkpoint-dir" in flags else None)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        config_from_args(get_parser().parse_args(flags))


def test_resnet_is_refused_by_name():
    """ResNet was refused by name before it was ported; ``--model resnet``
    (the JAX package's default) now builds ResNet-(9n+2) v2, and an
    unknown model name is refused."""
    cfg = config_from_args(get_parser().parse_args(
        ["--model", "resnet", "--num-layers", "1"]))
    assert build_model(cfg, device="cpu").name == "resnet11_v2"
    cfg.model = "vgg"
    with pytest.raises(ValueError, match="unknown model 'vgg'"):
        build_model(cfg, device="cpu")


def test_sp_runner_needs_its_ranks():
    """The runners never fall back to the one-process grid or stage chain:
    without the ranks of the mesh they raise (SP x PP, GEMS and SP + GEMS
    too)."""
    from mpi4dl_tpu_torch.benchmarks.common import run

    with pytest.raises(RuntimeError, match="torchrun"):
        run("sp", "resnet", ["--device", "cpu", "--num-layers", "1"])
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        run("sp", "resnet", ["--device", "cpu", "--telemetry-dir", "t"])
    with pytest.raises(RuntimeError, match="torchrun"):
        run("sp", "resnet", ["--device", "cpu", "--local-DP", "2"])
    with pytest.raises(RuntimeError, match="torchrun"):
        run("sp", "resnet", ["--device", "cpu", "--split-size", "2"])
    with pytest.raises(RuntimeError, match="torchrun"):
        run("lp", "resnet", ["--device", "cpu", "--split-size", "2"])
    with pytest.raises(RuntimeError, match="torchrun"):
        run("gems", "resnet", ["--device", "cpu", "--split-size", "2"])
    with pytest.raises(RuntimeError, match="torchrun"):
        run("gems_sp", "resnet", ["--device", "cpu", "--split-size", "2"])


def test_sp_runner_trains_on_four_gloo_ranks():
    """``benchmark_amoebanet_sp`` under torchrun: four gloo ranks, one tile
    each, D2 with the kernel knob (the plain versions on the CPU); the
    ranks' tails agree bitwise."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m",
           "mpi4dl_tpu_torch.benchmarks.spatial_parallelism.benchmark_amoebanet_sp",
           "--device", "cpu", "--image-size", "64", "--num-layers", "3",
           "--num-filters", "16", "--batch-size", "2", "--steps-per-epoch", "2",
           "--halo-d2", "--pallas-conv", "--spatial-until", "4"]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ranks"] == 4 and summary["spatial_until"] == 4
    assert len(summary["losses"]) == 2 and all(v > 0 for v in summary["losses"])
    assert summary["tail_tensors"] > 0 and summary["tail_differing"] == 0


@pytest.mark.parametrize("flags", [
    ["--split-size", "4", "--schedule", "gpipe"],
    ["--split-size", "2", "--data-parallel", "2", "--schedule", "1f1b"],
])
def test_lp_runner_trains_on_four_gloo_ranks(flags):
    """``benchmark_resnet_lp`` under torchrun: one stage a rank (GPipe), and
    DP2 x PP2 under 1F1B; three steps on one batch (an epoch of one step,
    so global step g trains on batch g % 1 = 0), and the losses fall."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m",
           "mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_resnet_lp",
           "--device", "cpu", "--image-size", "32", "--num-layers", "1",
           "--batch-size", "4", "--parts", "2", "--steps-per-epoch", "1",
           "--num-epochs", "3", "--lr", "0.01", *flags]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ranks"] == 4 and summary["schedule"] == flags[-1]
    losses = summary["losses"]
    assert len(losses) == 3 and losses[2] < losses[0]


@pytest.mark.parametrize("family,module,flags", [
    ("gems", "gems_master_model.benchmark_resnet_gems_master",
     ["--split-size", "4", "--parts", "1", "--batch-size", "2"]),
    ("gems", "gems_master_model.benchmark_resnet_gems_master",
     ["--split-size", "2", "--data-parallel", "2", "--parts", "2", "--batch-size", "4",
      "--schedule", "1f1b", "--enable-master-comm-opt"]),
    ("gems_sp", "gems_master_with_spatial_parallelism.benchmark_resnet_gems_master_with_sp",
     ["--num-spatial-parts", "2", "--slice-method", "vertical", "--split-size", "2",
      "--spatial-until", "2", "--parts", "1", "--batch-size", "4"]),
    ("sp", "spatial_parallelism.benchmark_resnet_sp",
     ["--num-spatial-parts", "2", "--slice-method", "vertical", "--split-size", "2",
      "--spatial-until", "2", "--parts", "2", "--batch-size", "4", "--schedule", "1f1b"]),
])
def test_gems_and_sp_pipeline_runners_train_on_four_gloo_ranks(family, module, flags):
    """The ``gems`` runner (one stage a rank; DP2 x GEMS2 under 1F1B), the
    ``gems_sp`` runner and the ``sp`` runner with ``--split-size 2`` (stage
    2 x 2 tiles) under torchrun on four gloo ranks: three steps on one batch
    (an epoch of one step), the losses fall, and under SP the tile ranks
    hold the same tail."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", f"mpi4dl_tpu_torch.benchmarks.{module}",
           "--device", "cpu", "--image-size", "32", "--num-layers", "1",
           "--steps-per-epoch", "1", "--num-epochs", "3", "--lr", "0.01", *flags]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["ranks"] == 4
    assert ("--enable-master-comm-opt" in flags) == any("is a no-op" in l for l in lines)
    losses = summary["losses"]
    assert len(losses) == 3 and losses[2] < losses[0]
    if family != "gems":
        assert summary["tail_tensors"] > 0 and summary["tail_differing"] == 0
