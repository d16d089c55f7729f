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
            "mpi4dl_tpu_torch.models.seqblock, "
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
        ["--num-layers", "3", "--num-filters", "16"]))
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

    main(["--image-size", "32", "--num-layers", "3", "--num-filters", "16",
          "--batch-size", "2", "--pallas-conv", "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step 0: loss")
    assert '"launches"' in out[-1]


@pytest.mark.parametrize("flags,item", [
    (["--num-spatial-parts", "4"], "A5"),
    (["--spatial-until", "3"], "A5"),
    (["--halo-d2"], "A6"),
    (["--split-size", "2"], "A7"),
    (["--data-parallel", "2"], "A7"),
    (["--enable-gems"], "A8"),
    (["--times", "2"], "A8"),
    (["--app", "1"], "A10"),
    (["--stripe-bwd"], "A11"),
    (["--quant", "int8"], "A13"),
])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        config_from_args(get_parser().parse_args(flags))


def test_resnet_is_refused_by_name():
    cfg = config_from_args(get_parser().parse_args(["--model", "resnet"]))
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        build_model(cfg, device="cpu")
