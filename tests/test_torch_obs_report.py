"""The port's report and CLI (mpi4dl_tpu_torch/obs/report.py,
obs/__main__.py) against the JAX package's (mpi4dl_tpu/obs/report.py,
obs/__main__.py) on the same RunLog files.

- ``render_run`` gives JAX's text line for line, but the ``devices:`` line
  (torch and CUDA versions where JAX prints its jax version): on
  ``tests/test_obs.py``'s synthetic RunLog, on RunLogs holding every record
  kind the report renders (those the port does not write yet too), with
  and without a pipeline, and on a RunLog the port's runner wrote on the
  CPU (``--device cpu``, 3 steps, ``--telemetry-dir``).
- ``compare_runs`` gives the same text and breach count.
- ``main([...])`` gives JAX's exit codes; ``--hlo`` (a compiled-HLO dump,
  which a PyTorch step has none of) exits 2 and says so.
- JAX's ``obs report`` renders the port's RunLog, cost record included.
"""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_obs import _synthetic_runlog  # noqa: E402

from mpi4dl_tpu.obs import report as jreport  # noqa: E402
from mpi4dl_tpu.obs.__main__ import main as jmain  # noqa: E402
from mpi4dl_tpu_torch.obs import report  # noqa: E402
from mpi4dl_tpu_torch.obs.__main__ import main  # noqa: E402

SMALL = ["--device", "cpu", "--image-size", "32", "--num-layers", "1",
         "--batch-size", "2", "--steps-per-epoch", "3"]


def every_kind_records(t0=1000.0, ms=(90.0, 100.0, 50.0), pipeline=True):
    """One record of every kind ``render_run`` reads, with every optional
    field its lines print."""
    steps = [{"kind": "step", "t": t0 + 1 + i, "epoch": 0, "step": i, "gstep": i, "ms": m,
              "images_per_sec": 4000.0 / m, "loss": 2.3 - 0.1 * i, "accuracy": 0.1,
              "measured": i > 0, "memory_peak_bytes": (3 + i) * 2**30,
              "hbm_skew": i * 2**20, "host_rss_peak_bytes": 2**31,
              "jit_cache_size": 1 + i}
             for i, m in enumerate(ms)]
    cfg = {"model": "amoebanet", "image_size": 1024, "batch_size": 4, "split_size": 2,
           "spatial_size": 1, "parts": 4, "precision": "bf_16", "schedule": "1f1b"}
    if not pipeline:
        cfg["split_size"] = 1
    return [
        {"kind": "meta", "t": t0, "config": cfg, "mesh": {"stage": 2}, "family": "lp",
         "device_count": 2, "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
         "torch_version": "2.11.0+cu128", "cuda_version": "12.8",
         "hatches": {"MPI4DL_FAULT": "nan_batch@5", "MPI4DL_NO_PACK": "1"}},
        {"kind": "cost", "t": t0 + 0.5, "flops": 5.0e12, "bytes_accessed": 2.6e11,
         "arithmetic_intensity": 19.23, "tick_scopes": ["bwd_tick", "fwd_tick"],
         "peak_flops": 989e12, "peak_source": "table", "device_count": 2,
         "flops_by_rank": [5.1e12, 4.9e12],
         "collectives": {"collective-permute": {"count": 8, "bytes": 1024},
                         "all-reduce": {"count": 2, "bytes": 2 * 2**20},
                         "total_count": 10, "total_bytes": 2 * 2**20 + 1024}},
        *steps,
        {"kind": "anomaly", "t": t0 + 5, "gstep": 5, "reason": "non-finite loss"},
        {"kind": "recovery", "t": t0 + 6, "gstep": 5, "resumed_from": 4, "skipped_step": 5},
        {"kind": "preempt", "t": t0 + 7, "gstep": 7, "signum": 15, "saved": True},
        {"kind": "quarantine", "t": t0 + 8, "skipped_step": 9},
        {"kind": "supervisor", "t": t0 + 9, "attempt": 1, "failure_class": "oom_step",
         "policy": "shrink", "config_delta": {"parts": 8, "remat": "sqrt"},
         "probe": {"probe_peak_gb": 61.5, "budget_gb": 76.0}, "backoff_s": 2.5,
         "quarantined": [3]},
        {"kind": "supervisor", "t": t0 + 10, "attempt": 2, "failure_class": "hang",
         "policy": "retry"},
        {"kind": "supervisor_summary", "t": t0 + 11, "ok": False, "attempts": 3,
         "incidents": 2, "reason": "budget exhausted"},
        {"kind": "checkpoint", "t": t0 + 12, "step_id": 4, "bytes": 1277 * 2**20,
         "gather_ms": 812.5, "write_ms": 2790.25, "peak_pending_bytes": 2**30},
        {"kind": "checkpoint", "t": t0 + 13, "step_id": 8, "bytes": 1277 * 2**20,
         "gather_ms": 799.0, "write_ms": 2800.0, "peak_pending_bytes": 2**29},
        {"kind": "restore", "t": t0 + 14, "step_id": 4, "path": "/ck/ckpt_4", "elastic": True},
        {"kind": "drill", "t": t0 + 15, "scenario": "sigterm", "verdict": "resumed",
         "passed": True},
        {"kind": "drill", "t": t0 + 16, "scenario": "nan", "verdict": "lost",
         "passed": False, "reason": "no recovery"},
        {"kind": "fleet", "t": 17, "event": "admit", "job": "alpha", "state": "running",
         "slice": "0-3"},
        {"kind": "fleet", "t": 18, "event": "preempt", "job": "beta", "victim": "alpha",
         "reason": "priority"},
        {"kind": "fleet_summary", "t": t0 + 19, "ok": True, "pool": 8, "events": 2,
         "jobs": {"alpha": "done", "beta": "preempted"}},
        {"kind": "overlap", "t": t0 + 20, "label": "lp",
         "totals": {"bytes": 3 * 2**20, "quantized_bytes": 2**20, "exposed_ms": 1.25,
                    "hidden_ms": 4.5, "async_pairs": 6, "sync": 1},
         "hidden_frac": 0.7826, "simulated_step_ms": 120.5,
         "rows": [{"scope": "stage0/handoff", "exposed_ms": 1.0, "bytes": 2**20},
                  {"scope": "grad_reduce", "exposed_ms": 0.25, "bytes": 2**21},
                  {"scope": "hidden", "exposed_ms": 0.0, "bytes": 4}]},
        {"kind": "mem_probe", "t": t0 + 21, "table": "sched  peak\ngpipe  30.1\n1f1b   12.4",
         "schedules": {"gpipe": {"peak_gb_est": 30.1}, "1f1b": {"peak_gb_est": 12.4}},
         "parts_delta": {"parts_a": 4, "parts_b": 8, "per_schedule": {
             "gpipe": {"top_growth_group": "stage0",
                       "growth_bytes_per_part": {"stage0/act": 2**26, "stage1/act": 2**25}}}}},
        {"kind": "hbm", "t": t0 + 22, "label": "step",
         "breakdown": {"peak_bytes_est": 40 * 2**30, "coverage": 0.875,
                       "by_scope": {"cell00": 2**33, "cell01": 2**32}}},
        {"kind": "timeline", "t": t0 + 23, "serialized_ms": 310.0, "compute_ms": 250.0,
         "collective_ms": 60.0, "overlapped_ms": 255.0, "overlap_headroom_ms": 55.0,
         "schedule_aware": {"exposed_wire_ms": 12.5}},
        {"kind": "junction_sweep", "t": t0 + 24, "placements": [
            {"spatial_until": 12, "peak_gb_est": 41.2},
            {"spatial_until": 16, "peak_gb_est": 38.0, "best": True}]},
        {"kind": "summary", "t": t0 + 25, "steps": 2},
    ]


def _write(path, records):
    with open(path, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return str(path)


def _same_but_devices(got: str, want: str) -> None:
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), (got, want)
    for a, b in zip(g, w):
        if b.startswith("devices: "):
            assert a.startswith("devices: ") and "torch " in a and "jax " not in a
            assert a.split("mesh=")[0] == b.split("mesh=")[0]
        else:
            assert a == b


@pytest.fixture(scope="module")
def port_runlog(tmp_path_factory):
    from mpi4dl_tpu_torch.benchmarks.common import run

    tele = tmp_path_factory.mktemp("port_tele")
    return run("lp", "resnet", SMALL + ["--telemetry-dir", str(tele)])["telemetry_path"]


@pytest.fixture(scope="module")
def runlogs(tmp_path_factory, port_runlog):
    d = tmp_path_factory.mktemp("runlogs")
    return {
        "synthetic": _synthetic_runlog(d),
        "every_kind": _write(d / "every.jsonl", every_kind_records()),
        "every_kind_slower": _write(d / "slower.jsonl",
                                    every_kind_records(ms=(90.0, 140.0, 70.0))),
        "no_pipeline": _write(d / "nopp.jsonl", every_kind_records(pipeline=False)),
        "steps_only": _write(d / "steps.jsonl", every_kind_records()[2:5]),
        "empty": _write(d / "empty.jsonl", []),
        "port_runner": port_runlog,
    }


@pytest.mark.parametrize("name", ["synthetic", "every_kind", "no_pipeline", "steps_only",
                                  "empty", "port_runner"])
def test_render_run_is_jaxs_but_the_devices_line(runlogs, name):
    path = runlogs[name]
    _same_but_devices(report.render_run(path), jreport.render_run(path))


def test_render_of_every_kind_and_the_devices_line(runlogs):
    out = report.render_run(runlogs["every_kind"])
    assert "devices: 2 x gpu (NVIDIA H100 80GB HBM3)  mesh={'stage': 2}  torch " \
           "2.11.0+cu128 cuda 12.8" in out
    for needle in ("pipeline: schedule=1f1b  stages=2  parts=4  ticks/step=6  "
                   "bubble=0.333  scopes: bwd_tick,fwd_tick",
                   "mfu estimate: 0.0674", "supervisor: FAILED after 3 leg(s)",
                   "fleet: OK", "drills: 1/2 verified", "junction placement frontier",
                   "wire [lp]: 3.0 MiB/step (1.0 MiB quantized)"):
        assert needle in out, (needle, out)
    assert report.render([runlogs["synthetic"], runlogs["every_kind"]]).count("== ") == 2


def test_pipeline_arithmetic_is_jaxs():
    from mpi4dl_tpu.obs.hlo_stats import COLLECTIVE_CLASSES
    from mpi4dl_tpu.obs.timeline import bubble_fraction, pipeline_ticks

    assert report.COLLECTIVE_CLASSES == COLLECTIVE_CLASSES
    for sched in ("gpipe", "1f1b", "both"):
        for stages in (1, 2, 4):
            for parts in (0, 1, 4, 8):
                assert report.pipeline_ticks(sched, stages, parts) == \
                    pipeline_ticks(sched, stages, parts)
                assert report.bubble_fraction(sched, stages, parts) == \
                    bubble_fraction(sched, stages, parts)


@pytest.mark.parametrize("a,b,threshold", [
    ("every_kind", "every_kind_slower", 5.0), ("every_kind_slower", "every_kind", 5.0),
    ("every_kind", "every_kind_slower", 90.0), ("synthetic", "every_kind", 5.0),
    ("port_runner", "synthetic", 5.0), ("empty", "steps_only", 5.0),
])
def test_compare_runs_is_jaxs(runlogs, a, b, threshold):
    got = report.compare_runs(runlogs[a], runlogs[b], threshold)
    assert got == jreport.compare_runs(runlogs[a], runlogs[b], threshold)
    assert [n for n, _, _ in report._COMPARE_METRICS] == \
        [n for n, _, _ in jreport._COMPARE_METRICS]


@pytest.mark.parametrize("argv", [
    ["report", "{every_kind}"],
    ["report", "{every_kind}", "{synthetic}"],
    ["report", "{missing}"],
    ["report"],
    ["report", "--compare", "{every_kind}", "{every_kind_slower}"],
    ["report", "--compare", "{every_kind_slower}", "{every_kind}"],
    ["report", "--compare", "{every_kind}", "{missing}"],
    ["report", "--compare", "{every_kind}", "{synthetic}", "{every_kind}"],
    ["report", "--trend", "{dir}", "{every_kind}"],
    ["report", "--trend", "{missing}"],
])
def test_cli_exit_codes_and_text_are_jaxs(runlogs, argv, capsys):
    fill = dict(runlogs, missing=str(Path(runlogs["every_kind"]).parent / "missing.jsonl"),
                dir=str(Path(runlogs["every_kind"]).parent))
    argv = [a.format(**fill) for a in argv]
    rc = main(argv)
    out = capsys.readouterr()
    want = jmain(argv)
    ref = capsys.readouterr()
    assert rc == want
    _same_but_devices(out.out, ref.out)
    assert out.err == ref.err


def test_cli_rejects_the_compiled_program_half(tmp_path, capsys):
    """A PyTorch step compiles no HLO: ``--hlo`` is refused (``--profile``
    and ``--families`` are its counterparts,
    tests/test_torch_obs_instruments.py)."""
    assert main(["overlap", "--hlo", "x.hlo"]) == 2
    assert "compiles no HLO" in capsys.readouterr().err
    out = str(tmp_path / "t.json")
    assert main(["trace", "--hlo", "x.hlo", "--out", out]) == 2
    assert "compiles no HLO" in capsys.readouterr().err
    assert not os.path.exists(out)
    with pytest.raises(SystemExit) as e:
        main(["report", "--bogus"])
    assert e.value.code == 2


def test_jax_report_renders_the_port_runlog(runlogs):
    out = jreport.render_run(runlogs["port_runner"])
    assert "run: family=lp model=resnet image_size=32 batch_size=2" in out
    assert "steps: 2 measured, 1 warmup dropped" in out
    assert "cost model: flops/step " in out and "arithmetic intensity " in out
    assert "peak source: nominal-cpu)" in out and "mfu estimate: 0." in out
