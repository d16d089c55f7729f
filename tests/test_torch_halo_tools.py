"""The port's halo tools (mpi4dl_tpu_torch/benchmarks/communication/halo/)
on the CPU at small shapes: each runs, validates and prints the JSON keys
of its JAX counterpart (benchmarks/communication/halo/).  On the CPU they
run the kernels' plain versions; the card runs them in chip_smoke.py."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOLS = "mpi4dl_tpu_torch.benchmarks.communication.halo"

PALLAS_CONV_KEYS = {"metric", "value", "unit", "config", "variants", "pallas_speedup_vs_xla",
                    "flops_per_call", "validation", "platform"}
D2_STEP_KEYS = {"metric", "value", "unit", "config", "xla_step_ms", "pallas_step_ms",
                "validation", "platform"}
EXCHANGE_KEYS = {"metric", "value", "platform", "config", "validation", "reference_ms"}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype,kernel", [("bf16", 3), ("f32", 5)])
def test_pallas_conv_tool(capsys, dtype, kernel):
    from mpi4dl_tpu_torch.benchmarks.communication.halo import benchmark_pallas_conv as tool

    rc = tool.main(["--height", "24", "--width", "16", "--cin", "8", "--cout", "12",
                    "--kernel", str(kernel), "--dtype", dtype, "--device", "cpu",
                    "--warmup", "1", "--iterations", "2"])
    out = _last_json(capsys)
    assert rc == 0 and out["validation"] == "pass" and PALLAS_CONV_KEYS <= out.keys()
    assert set(out["variants"]) == {"xla_valid", "pallas", "xla_same"}
    assert out["flops_per_call"] == 2 * 24 * 16 * 8 * 12 * kernel * kernel


def test_d2_step_tool(capsys):
    from mpi4dl_tpu_torch.benchmarks.communication.halo import benchmark_d2_step as tool

    rc = tool.main(["--tile", "16", "--channels", "8", "--fused", "3", "--device", "cpu",
                    "--warmup", "1", "--iterations", "1"])
    out = _last_json(capsys)
    assert rc == 0 and out["validation"] == "pass" and D2_STEP_KEYS <= out.keys()
    assert out["config"]["margin"] == [3, 3]
    assert out["arms_rel_l2"] <= out["arms_tolerance"]


@pytest.mark.parametrize("wrong", ["k2_forward", "k1_dx"])
def test_d2_step_tool_fails_on_a_wrong_kernel(capsys, monkeypatch, wrong):
    """A K2 forward or a K1 dx that drops the last output row: the loss (a
    mean of squared BatchNorm outputs) hardly moves, the arms' gradients
    do, and the tool reports the failure."""
    from mpi4dl_tpu_torch.benchmarks.communication.halo import benchmark_d2_step as tool
    from mpi4dl_tpu_torch.ops import halo_conv

    plain = halo_conv.halo_conv2d_plain

    def broken(x, w, out_dtype=None, fuse_relu=False, stat_window=None):
        out = plain(x, w, out_dtype, fuse_relu, stat_window)
        if (stat_window is not None) == (wrong == "k2_forward"):
            y = out[0] if stat_window is not None else out
            y[:, -1] = 0
        return out

    monkeypatch.setattr(halo_conv, "halo_conv2d_plain", broken)
    rc = tool.main(["--tile", "16", "--channels", "8", "--fused", "3", "--device", "cpu",
                    "--warmup", "1", "--iterations", "1"])
    out = _last_json(capsys)
    assert rc == 1 and out["validation"].startswith("FAIL")
    assert out["arms_rel_l2"] > out["arms_tolerance"]


@pytest.mark.parametrize("slice_method", ["vertical", "horizontal", "square"])
def test_sp_halo_exchange_tool_one_process(capsys, slice_method):
    from mpi4dl_tpu_torch.benchmarks.communication.halo import (
        benchmark_sp_halo_exchange as tool,
    )

    rc = tool.main(["--image-size", "32", "--num-spatial-parts", "4", "--slice-method",
                    slice_method, "--with-compute", "--device", "cpu", "--warmup", "1",
                    "--iterations", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert rc == 0 and lines.count("validation: PASSED") == 1
    assert lines.count("conv validation: PASSED") == 1
    assert out["validation"] == "pass" and EXCHANGE_KEYS <= out.keys()
    assert out["with_compute"]["conv_validation"] == "pass"


def test_sp_halo_exchange_tool_on_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", f"{TOOLS}.benchmark_sp_halo_exchange",
           "--device", "cpu", "--image-size", "32", "--num-spatial-parts", "4",
           "--slice-method", "square", "--with-compute", "--warmup", "1",
           "--iterations", "2"]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines.count("validation: PASSED") == 1 and lines.count("conv validation: PASSED") == 1
    summary = json.loads(lines[-1])
    assert summary["backend"] == "ranks" and summary["validation"] == "pass"
