"""The port's one-line bench (``mpi4dl_tpu_torch/bench.py``) against the
JAX package's ``bench.py``: the resolution ladder, the failure gist and the
rung summary on the same inputs, the JAX ladder tests that apply to a
card, the line printed without a card, and the CPU smoke rung.  The JAX
module is imported here only; its evidence file is redirected to
``tmp_path``, as ``tests/test_bench_logic.py`` does."""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def tbench(monkeypatch):
    from mpi4dl_tpu_torch import bench

    monkeypatch.setattr(bench, "_time_left", lambda: 10_000.0)
    monkeypatch.setattr(bench, "MEASURED_PATH", None)
    return bench


@pytest.fixture()
def jbench(monkeypatch, tmp_path):
    monkeypatch.syspath_prepend(_REPO)
    mod = importlib.import_module("bench")
    monkeypatch.setattr(mod, "_time_left", lambda: 10_000.0)
    monkeypatch.setattr(mod, "MEASURED_PATH", str(tmp_path / "measured.json"))
    return mod


def _fake_runner(fits_px):
    """A ``_run_sub`` stand-in: a probe succeeds iff px <= fits_px."""
    calls = []

    def run(argv_tail, timeout_s, platform="gpu"):
        assert argv_tail[0] == "--probe"
        px = int(argv_tail[1])
        calls.append(px)
        if px <= fits_px:
            return {"ok": True, "image_size": px, "first_step_s": 1.0}, None
        return None, "rc=1; stderr: torch.OutOfMemoryError: CUDA out of memory."

    run.calls = calls
    return run


_CASES = np.random.default_rng(17)
LADDER_CASES = [
    (int(_CASES.choice([0, 900, 2048, 3500, 5000, 6144, 7000, 8192, 12000])
         if i % 3 else _CASES.integers(512, 12000)),
     int(_CASES.choice([1024, 2048, 4096])), int(_CASES.choice([4096, 8192, 16384])),
     int(_CASES.choice([0, 1024, 2048, 3072, 3584, 5120])),
     float(_CASES.choice([10.0, 150.0, 190.0, 10_000.0])))
    for i in range(50)
]


@pytest.mark.parametrize("fits_px,start,cap,known_fit,left", LADDER_CASES)
def test_max_trainable_px_is_the_jax_ladder(tbench, jbench, monkeypatch, fits_px, start,
                                            cap, known_fit, left):
    """The same fake runner and deadline: the same best resolution and the
    same probes in the same order."""
    got = {}
    for name, mod in (("port", tbench), ("jax", jbench)):
        runner = _fake_runner(fits_px)
        monkeypatch.setattr(mod, "_run_sub", runner)
        monkeypatch.setattr(mod, "_time_left", lambda: left)
        best, attempts = mod._max_trainable_px(start=start, cap=cap, known_fit=known_fit)
        got[name] = (best, list(attempts), runner.calls,
                     [a["ok"] for a in attempts.values()])
    assert got["port"] == got["jax"]


GISTS = [
    "WARNING: something\nE0000 XLA:TPU compile permanent error. Ran out of memory in hbm.\n"
    "For simplicity, JAX has removed its internal frames from the traceback of the "
    "following exception.\n",
    "noise\nValueError: tile H not divisible by stride\ntail\n",
    "",
    "just\nsome\nlines without a failure\n",
    "Traceback (most recent call last):\n  File \"x.py\", line 3\nRuntimeError: boom\n  hint\n",
    "error: nvcc exited 1\nmore\n",
]


@pytest.mark.parametrize("log", GISTS)
def test_stderr_gist_is_the_jax_gist(tbench, jbench, log):
    assert tbench._stderr_gist(log) == jbench._stderr_gist(log)


def test_stderr_gist_names_the_cards_oom(tbench):
    """The card's OOM line wins, head first, over a later error of the
    unwinding (seen on the H100 at a 7680² fine-remat probe)."""
    log = ("step 0\ntorch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
           "11.43 GiB. GPU 0 has a total capacity of 79.18 GiB" + " x" * 200 + "\n"
           "Exception ignored in: <generator object _checkpoint_without_reentrant_generator>\n"
           "RuntimeError: is_initialized && !tls.stack.empty() INTERNAL ASSERT FAILED\n")
    assert tbench._stderr_gist(log).startswith(
        "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 11.43 GiB")


SUMMARIES = [
    ({"value": 0.7, "mfu": 0.1, "timing_mode": "async_chain", "remat": "cell"}, None,
     2.85, "vs_baseline_cluster_2048"),
    ({"value": 0.7, "mfu": 1.2, "error": "measurement failed"}, None, 2.85, "k"),
    ({"value": 3.1, "rung_config": {"image_size": 1024}}, None, None, "vs_baseline"),
    (None, "skipped (bench deadline reached)", 2.95, "k"),
    (None, "x" * 400, 2.95, "k"),
]


@pytest.mark.parametrize("result,err,baseline,key", SUMMARIES)
def test_rung_summary_is_the_jax_summary(tbench, jbench, result, err, baseline, key):
    assert tbench._rung_summary(result, err, baseline, key) == \
        jbench._rung_summary(result, err, baseline, key)


# tests/test_bench_logic.py's ladder cases: (fits_px, kwargs, best, probes).
LADDER_TESTS = {
    "doubling_and_midpoint": (3500, dict(start=4096, known_fit=2048), 3328,
                              [4096, 3072, 3584, 3328]),
    "full_ladder": (10_000, dict(start=2048, cap=8192), 8192, [2048, 4096, 8192]),
    "nothing_fits": (0, dict(start=1024, known_fit=0), 0, [1024]),
    "seeded_cap_still_probed": (10_000, dict(start=2048, known_fit=3072), 8192,
                                [6144, 8192]),
}


@pytest.mark.parametrize("case", sorted(LADDER_TESTS))
def test_ladder_cases_of_the_jax_tests(tbench, monkeypatch, case):
    fits_px, kw, best, probes = LADDER_TESTS[case]
    runner = _fake_runner(fits_px)
    monkeypatch.setattr(tbench, "_run_sub", runner)
    got, attempts = tbench._max_trainable_px(**kw)
    assert got == best and runner.calls == probes
    assert all(attempts[str(p)]["ok"] == (p <= fits_px) for p in probes)
    if not attempts[str(probes[0])]["ok"]:
        assert "CUDA out of memory" in attempts[str(probes[0])]["error"]


def test_ladder_deadline_stops_probing(tbench, monkeypatch):
    monkeypatch.setattr(tbench, "_time_left", lambda: 10.0)
    runner = _fake_runner(10_000)
    monkeypatch.setattr(tbench, "_run_sub", runner)
    best, attempts = tbench._max_trainable_px(start=2048, known_fit=1024)
    assert best == 1024 and runner.calls == []
    assert attempts["2048"]["error"] == "bench deadline reached"


def _main(tbench, argv=()):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tbench.main(list(argv)) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_rungs_clamp_to_the_deadline(tbench, monkeypatch):
    """Every rung's time limit fits the remaining budget, and a ladder that
    failed still prints its one line with value 0."""
    seen = []

    def fake_try(name, *args):
        seen.append((name, args[6]))
        return None, f"{name}: simulated failure"

    monkeypatch.setattr(tbench, "_try_rung", fake_try)
    monkeypatch.setattr(tbench, "_time_left", lambda: 500.0)
    monkeypatch.setattr(tbench, "_card_preflight", lambda *a, **k: "NVIDIA H100 80GB HBM3")
    out = _main(tbench)
    assert out["value"] == 0 and out["platform"] == "none" and "error" in out
    assert seen and all(t <= 440 for _, t in seen)


def test_a_negative_preflight_runs_no_rung(tbench, monkeypatch):
    """No card answers: no rung runs and no CPU rung stands in."""
    seen = []
    monkeypatch.setattr(tbench, "_try_rung", lambda name, *a: seen.append(name))
    monkeypatch.setattr(tbench, "_card_preflight", lambda *a, **k: None)
    out = _main(tbench)
    assert seen == [] and out["platform"] == "none" and out["value"] == 0
    assert any("preflight negative" in f for f in out["ladder_failures"])


def test_health_reprobes_after_a_rung_failure(tbench, monkeypatch):
    probes = []
    monkeypatch.setattr(tbench, "_card_preflight",
                        lambda *a, **k: probes.append(1) or "NVIDIA H100 80GB HBM3")
    h = tbench._CardHealth()
    assert h.check() and len(probes) == 1
    assert h.check() and len(probes) == 1  # a fresh success is trusted
    h.note_rung_failure()
    assert h.check() and len(probes) == 2  # invalidated: probed again


def test_measured_merges_and_seeds_the_ladder(tbench, monkeypatch, tmp_path):
    """``--measured PATH``: rungs and passed probes merge into PATH, and a
    banked probe seeds the resolution ladder."""
    path = tmp_path / "measured.json"
    monkeypatch.setattr(tbench, "MEASURED_PATH", str(path))
    tbench._record_measured("gpu_1024", {"value": 4.2, "mfu": 0.1})
    tbench._record_measured("gpu_2048", {"value": 0.9})
    tbench._record_measured("gpu_1024", {"value": 4.5, "mfu": 0.11})
    tbench._record_measured("probe_3072", {"ok": True, "first_step_s": 120.0})
    data = json.loads(path.read_text())
    assert set(data["rungs"]) == {"gpu_1024", "gpu_2048", "probe_3072"}
    assert data["rungs"]["gpu_1024"]["value"] == 4.5 and "captured_unix" in data["rungs"]["gpu_2048"]

    seen = {}

    def fake_probe(start, known_fit, gate=None, note_ok=None):
        seen.update(start=start, known_fit=known_fit)
        return known_fit, {}

    monkeypatch.setattr(tbench, "_try_rung", lambda name, platform, *a: (
        {"value": 4.0, "platform": "gpu", "metric": "m", "unit": "u", "mfu": 0.1}, None))
    monkeypatch.setattr(tbench, "_max_trainable_px", fake_probe)
    monkeypatch.setattr(tbench, "_card_preflight", lambda *a, **k: "NVIDIA H100 80GB HBM3")
    out = _main(tbench, ["--measured", str(path)])
    assert seen == {"start": 2048, "known_fit": 3072} and out["max_trainable_px"] == 3072


def test_without_a_card_one_line_of_value_zero(tbench):
    """The real preflight on a host with no card: one JSON line, value 0,
    platform none, the error, and no CPU figure."""
    out = _main(tbench)
    assert out["value"] == 0 and out["platform"] == "none" and out["vs_baseline"] is None
    assert "no CUDA device" in out["error"]
    assert "mfu" not in out and "flops_per_step" not in out


def test_the_cpu_smoke_rung(tbench, monkeypatch):
    """``--device cpu`` runs the JAX package's CPU smoke rung in-process
    (AmoebaNet-D(3, 64) at 128²; here one timed step and no warm-up, to keep
    the test cheap): counted FLOPs, an MFU against the CPU's nominal peak,
    not comparable."""
    smoke = list(tbench.CPU_SMOKE)
    smoke[5:7] = [0, 1]
    monkeypatch.setattr(tbench, "CPU_SMOKE", tuple(smoke))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tbench.main(["--device", "cpu"]) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["comparable"] is False
    assert out["vs_baseline"] is None and out["metric"].startswith("amoebanetd_128px_bs1")
    assert out["flops_per_step"] > 0 and 0 < out["mfu"] <= 1
    assert out["peak_source"] == "nominal-cpu" and out["timing_mode"] == "async_chain"
    assert out["iters"] == 1 and out["scan_steps_per_dispatch"] == 1
