"""The port's metrics exposition, RunLog trace and trend gate
(mpi4dl_tpu_torch/obs/{metrics,trace,trend}.py and their CLI) against the
JAX package's on the same records.

- ``metrics_from_records``, ``metrics_from_runlog(s)`` and
  ``write_metrics_file`` give byte-identical expositions
  (``tests/test_obs_export.py``'s records, a RunLog of every record kind,
  many RunLogs with colliding stems, a RunLog the port's runner wrote on
  the CPU); ``serve_metrics`` answers one scrape on a loopback port.
- ``trace_from_runlog`` gives identical events; ``chrome_trace`` the same
  container.
- ``trend_report``/``format_trend`` agree over one directory (RunLog series
  and bench artifacts); the CLI's ``metrics``, ``trace --runlog`` and
  ``report --trend`` give JAX's exit codes and output.
"""

import json
import os
import shutil
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_obs_export import _measured_records, _metrics_records  # noqa: E402
from test_torch_obs_report import every_kind_records  # noqa: E402

from mpi4dl_tpu.obs import metrics as jmetrics  # noqa: E402
from mpi4dl_tpu.obs import trace as jtrace  # noqa: E402
from mpi4dl_tpu.obs import trend as jtrend  # noqa: E402
from mpi4dl_tpu.obs.__main__ import main as jmain  # noqa: E402
from mpi4dl_tpu_torch.obs import metrics, trace, trend  # noqa: E402
from mpi4dl_tpu_torch.obs.__main__ import main  # noqa: E402

SMALL = ["--device", "cpu", "--image-size", "32", "--num-layers", "1",
         "--batch-size", "2", "--steps-per-epoch", "3"]
RECORDS = {"metrics": _metrics_records, "measured": _measured_records,
           "every_kind": every_kind_records, "empty": list}


def _write(path, records):
    with open(path, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def tele(tmp_path_factory):
    """A directory of RunLogs: two port runner runs (one series), two of
    every record kind (another), and bench artifacts."""
    from mpi4dl_tpu_torch.benchmarks.common import run

    d = tmp_path_factory.mktemp("tele")
    paths = [run("lp", "resnet", SMALL + ["--telemetry-dir", str(d)])["telemetry_path"]
             for _ in range(2)]
    paths.append(_write(d / "kinds-20260101-000000-p1.jsonl", every_kind_records()))
    paths.append(_write(d / "kinds-20260102-000000-p1.jsonl",
                        every_kind_records(t0=5000.0, ms=(90.0, 300.0, 200.0))))
    (d / "BENCH_ci.json").write_text(json.dumps(
        {"rungs": {"1024": {"img_per_sec": 2.5, "mfu": 0.011}}, "source": "runner"}))
    (d / "BENCH_r01.json").write_text(json.dumps({"rc": 1, "parsed": None, "tail": "x"}))
    return d, paths


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_metrics_from_records_is_byte_identical(name):
    recs = RECORDS[name]()
    assert metrics.metrics_from_records(recs) == jmetrics.metrics_from_records(recs)
    labels = {"job": "alpha", "host": 'a"b'}
    assert metrics.metrics_from_records(recs, prefix="x", labels=labels) == \
        jmetrics.metrics_from_records(recs, prefix="x", labels=labels)


def test_metrics_from_runlogs_and_the_file_sink_are_byte_identical(tele, tmp_path):
    d, paths = tele
    for p in paths:
        assert metrics.metrics_from_runlog(p) == jmetrics.metrics_from_runlog(p)
    # Colliding stems take the parent directory as the job (a fleet's layout).
    jobs = []
    for job in ("alpha", "beta"):
        (tmp_path / job).mkdir()
        jobs.append(_write(tmp_path / job / "supervisor00.jsonl", every_kind_records()))
    for source in (paths, jobs, {"a": paths[0], "b": paths[2]}, paths[0]):
        assert metrics.metrics_from_runlogs(source) == jmetrics.metrics_from_runlogs(source)
    got = metrics.write_metrics_file(every_kind_records(), str(tmp_path / "p.prom"))
    want = jmetrics.write_metrics_file(every_kind_records(), str(tmp_path / "j.prom"))
    assert Path(got).read_bytes() == Path(want).read_bytes()
    prom = os.path.splitext(paths[0])[0] + ".prom"  # the runner's snapshot
    assert Path(prom).read_text() == jmetrics.metrics_from_runlog(paths[0])


def test_serve_metrics_answers_a_loopback_scrape(tele):
    _, paths = tele
    srv = metrics.serve_metrics(paths[0], 0)  # an ephemeral port on 127.0.0.1
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/metrics") as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == metrics.CONTENT_TYPE
            assert resp.read().decode() == jmetrics.metrics_from_runlog(paths[0])
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/nope")
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)


def test_metrics_port_from_env_is_jaxs(monkeypatch):
    for raw in ("", "9100", "nope"):
        monkeypatch.setenv("MPI4DL_METRICS_PORT", raw)
        assert metrics.metrics_port_from_env() == jmetrics.metrics_port_from_env()


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_trace_from_runlog_gives_jaxs_events(name):
    recs = RECORDS[name]()
    got = trace.trace_from_runlog(recs, label="r", pid_base=7)
    assert got == jtrace.trace_from_runlog(recs, label="r", pid_base=7)
    assert trace.chrome_trace(got) == jtrace.chrome_trace(got)


def test_trace_of_the_port_runlog(tele):
    from mpi4dl_tpu_torch.obs import read_runlog

    _, paths = tele
    recs = read_runlog(paths[0])
    events = trace.trace_from_runlog(recs)
    assert events == jtrace.trace_from_runlog(recs)
    assert len([e for e in events if e.get("cat") == "step"]) == 3


def test_trend_agrees_with_jax(tele):
    d, paths = tele
    for threshold in (5.0, 500.0):
        got = trend.trend_report(str(d), threshold)
        assert got == jtrend.trend_report(str(d), threshold)
        assert trend.format_trend(got) == jtrend.format_trend(got)
    got = trend.trend_report(str(d))
    assert [g["series"] for g in got["gates"]] == ["kinds", "lp-resnet"]
    assert got["breaches"] >= 1  # kinds: the newer run's steps are 2.5x slower
    for p in paths:
        assert trend.runlog_series(p) == jtrend.runlog_series(p)
    bench = d / "BENCH_ci.json"
    assert trend.read_bench_artifact(str(bench)) == jtrend.read_bench_artifact(str(bench))


@pytest.mark.parametrize("argv", [
    ["metrics", "{dir}"],
    ["metrics", "{run}"],
    ["metrics", "{run}", "--out", "{out}"],
    ["metrics", "{dir}", "--out", "{out}"],
    ["metrics", "{empty_dir}"],
    ["metrics", "{missing}"],
    ["metrics", "{run}", "--serve"],
    ["trace", "--runlog", "{run}", "--out", "{out}"],
    ["trace", "--runlog", "{missing}", "--out", "{out}"],
    ["trace", "--out", "{out}"],
    ["report", "--trend", "{dir}"],
    ["report", "--trend", "{dir}", "--threshold", "500", "--trend-out", "{out}"],
])
def test_cli_exit_codes_and_output_are_jaxs(tele, tmp_path, argv, capsys, monkeypatch):
    d, paths = tele
    monkeypatch.delenv("MPI4DL_METRICS_PORT", raising=False)
    (tmp_path / "empty").mkdir()
    results = []
    for fn, side in ((main, "port"), (jmain, "jax")):
        out = str(tmp_path / f"{side}.out")
        fill = dict(dir=str(d), run=paths[0], out=out, empty_dir=str(tmp_path / "empty"),
                    missing=str(tmp_path / "missing.jsonl"))
        rc = fn([a.format(**fill) for a in argv])
        text = capsys.readouterr()
        written = Path(out).read_text() if os.path.exists(out) else None
        results.append((rc, text.out.replace(out, "OUT"), text.err.replace(out, "OUT"),
                        written))
    if argv == ["trace", "--out", "{out}"]:
        # The port's usage message names its sources: --profile where JAX
        # has --hlo.
        assert results[0][2] == "obs trace: need --families, --profile, or --runlog\n"
        results = [r[:2] + r[3:] for r in results]
    assert results[0] == results[1]


def test_cli_trend_gate_exits_1_on_a_regression(tele, tmp_path):
    d, _ = tele
    shutil.copytree(d, tmp_path / "t")
    assert main(["report", "--trend", str(tmp_path / "t")]) == 1
    assert main(["report", "--trend", str(tmp_path / "t"), "--threshold", "500"]) == 0
