"""The port's 8192² readiness probe
(``mpi4dl_tpu_torch/benchmarks/readiness_8k.py``) against the JAX
package's ``benchmarks/readiness_8k.py``: the analytic ledger to the byte
over the JAX model's shapes, the JSON line's keys and the gates.  The JAX
package is imported here only.  The end-to-end runs, which step every
role on fake tensors in processes of their own, are ``slow``."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from mpi4dl_tpu_torch.benchmarks import readiness_8k as rd

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--image-size", "256", "--num-layers", "6", "--num-filters", "64", "--tiles", "2",
         "--stages", "2", "--parts", "2", "--spatial-until", "4"]
JAX_CONFIG_KEYS = {"image_size", "grid", "stages", "parts", "schedule", "devices",
                   "spatial_until", "spatial_parts", "stripe_bwd", "model", "quant"}


def test_require_wire_gb_without_attribute_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        rd.main(["--require-wire-gb", "18"])
    assert e.value.code == 2 and "needs --attribute" in capsys.readouterr().err


def _jax_ledger(shapes, su, t, chain):
    """The JAX tool's ledger (``benchmarks/readiness_8k.py:180-214``):
    per-cell bytes before the MB rounding."""
    from mpi4dl_tpu.cells import split_even
    from mpi4dl_tpu.layer_ctx import spatial_levels_for
    from mpi4dl_tpu.parallel.spatial import _cell_bytes

    levels = None
    if chain:
        ctxs = spatial_levels_for("square", chain)
        stops = [hi for _, hi in split_even(su, len(ctxs))]
        levels = []
        for stop, c in zip(stops, ctxs):
            if stop > (levels[-1][0] if levels else 0):
                levels.append((stop, c))
        levels[-1] = (su, levels[-1][1])

    def tiles_for(i):
        if levels:
            for stop, c in levels:
                if i < stop:
                    return c.grid_h * c.grid_w
        return t * t

    out = {"spatial_cells": [], "tail_cells": []}
    for i, shp in enumerate(shapes):
        b = _cell_bytes(shp, 2)
        if i < su:
            b //= tiles_for(i)
        out["spatial_cells" if i < su else "tail_cells"].append({"cell": i, "bytes": b})
    return out


@pytest.mark.parametrize("spatial_parts", [None, "4,1"], ids=["2x2", "chain_4_1"])
@pytest.mark.parametrize("su", [4, "auto"])
def test_ledger_is_the_jax_tools_to_the_byte(spatial_parts, su):
    """AmoebaNet-D(6, 64) at 256²: the same cells, the same per-device bytes
    of every cell, the same placement for ``auto``."""
    import jax

    from mpi4dl_tpu.models.amoebanet import amoebanetd
    from mpi4dl_tpu.parallel.spatial import choose_spatial_until as jax_choose

    model = amoebanetd((1, 256, 256, 3), num_classes=1000, num_layers=6, num_filters=64)
    box = {}

    def init(key):
        params, box["shapes"] = model.init(key)
        return params

    jax.eval_shape(init, jax.random.key(0))
    jshapes = box["shapes"]

    from mpi4dl_tpu_torch.benchmarks.mem_probe import _runner_cfg
    from mpi4dl_tpu_torch.layer_ctx import spatial_levels_for
    from mpi4dl_tpu_torch.models import build_model
    from mpi4dl_tpu_torch.parallel.spatial import cell_output_shapes, choose_spatial_until

    args = rd._parser().parse_args(
        SMALL[:-2] + ["--spatial-until", str(su)]
        + (["--spatial-parts", spatial_parts] if spatial_parts else []))
    t, chain = rd._chain(args)
    cfg = _runner_cfg(rd.runner_argv(args, 1), "")
    shapes = cell_output_shapes(build_model(cfg, device="meta"), (1, 256, 256, 3))
    assert len(shapes) == len(jshapes)
    if su == "auto":
        su = choose_spatial_until(shapes, t * t, itemsize=2)
        assert su == jax_choose(jshapes, t * t, itemsize=2)
    grids = [c.grid_h * c.grid_w for c in spatial_levels_for("square", chain or [t * t])]
    levels = [(stop, grids[i]) for stop, i in rd.level_stops(len(grids), su)]
    assert rd.activation_ledger(shapes, su, rd._tiles_at(levels)) == \
        _jax_ledger(jshapes, su, t, chain)


def _role(rank, peak_gb, stage_handoff):
    from mpi4dl_tpu_torch.obs.comm_stats import COLLECTIVE_CLASSES

    stats = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_CLASSES}
    stats["collective-permute"] = {"count": 12, "bytes": 4096}
    stats["all-reduce"] = {"count": 3, "bytes": 1200}
    scopes = {"sp_region/sp_level0/cell01/halo_exchange_sph": {
        "collective_bytes": 2048, "collective_count": 6 - 2 * stage_handoff}}
    if stage_handoff:
        scopes["gpipe/gpipe_fwd/stage_handoff"] = {"collective_bytes": 1024,
                                                   "collective_count": 2}
    return {"rank": rank, "peak_bytes": int(peak_gb * 2**30),
            "by_category": {"Activation": int(peak_gb * 2**30)}, "seconds": 1.0,
            "collectives": stats, "collective_scopes": scopes}


@pytest.mark.parametrize("gate,rc", [(None, 0), ("0.001", 1), ("80", 0)])
def test_line_carries_the_jax_keys_and_gates_exit_as_there(monkeypatch, gate, rc):
    """Two stage roles (stubbed): the largest role's peak, the collectives
    summed over the roles, the ledger, and ``--require-gb``'s exit code."""
    monkeypatch.setattr(rd, "_run_role",
                        lambda argv, rank: _role(rank, 0.5 + rank / 32, rank > 0))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = rd.main(SMALL + (["--require-gb", gate] if gate else []))
    assert got == rc
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["metric"] == "readiness_8k_per_device_gb" and out["unit"] == "GB/device"
    assert JAX_CONFIG_KEYS <= set(out["config"])
    assert out["config"]["devices"] == 8 and out["config"]["grid"] == "2x2"
    assert out["builds"] and out["value"] == round(0.5 + 4 / 32, 2)
    assert [r["rank"] for r in out["memory_analysis"]["roles"]] == [0, 4]
    assert out["fits_h100_80gb"] and out["headroom_h100_gb"] == round(rd.H100_HBM_GB - 0.625, 1)
    assert out["collectives_per_step"] == {"collective-permute": {"count": 24, "bytes": 8192},
                                           "all-reduce": {"count": 6, "bytes": 2400}}
    assert out["collective_scopes"]["stage_handoff"]["count"] == 2
    assert out["collective_scopes"]["halo_exchange_sph"]["count"] == 10
    assert set(out["activation_ledger"]) == {"spatial_cells_sum_per_device_mb",
                                             "tail_cells_sum_total_mb",
                                             "largest_spatial_cell_mb"}
    assert ("hbm_gate" in out) == (gate is not None)
    if gate:
        assert out["hbm_gate"] == {"limit_gb": float(gate), "ok": rc == 0}


def test_a_role_that_does_not_step_fails_the_build(monkeypatch):
    """At the JAX defaults (one part, two stages) neither package builds the
    step: the line says so and the tool exits 1."""
    monkeypatch.setattr(rd, "_run_role", lambda argv, rank: {
        "rank": rank, "error": "rc 1: ValueError: batch 1 must divide over 2 stage chunks"})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert rd.main(SMALL[:-4] + ["--spatial-until", "4"]) == 1
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["builds"] is False and out["value"] is None
    assert "--parts 1 does not divide over --stages 2" in out["error"]


def _run_tool(argv, tmp_path):
    env = dict(os.environ)
    env.pop("MPI4DL_STRIPE_BWD", None)
    out = tmp_path / "r.json"
    r = subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.readiness_8k",
                        *argv, "--out", str(out)], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=1500)
    return r, json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.slow
def test_readiness_end_to_end(tmp_path):
    """AmoebaNet-D(6, 64) at 256², SP 2x2 x PP 2, two micro-batches: both
    roles step on fake tensors, the line has the JAX keys, the halos and
    the stage handoff are in the step's collectives, and ``--require-gb
    0.001`` exits 1."""
    r, d = _run_tool(SMALL + ["--require-gb", "0.001"], tmp_path)
    assert r.returncode == 1, r.stderr[-2000:]
    assert d["builds"] and d["value"] > 0 and d["hbm_gate"]["ok"] is False
    assert JAX_CONFIG_KEYS <= set(d["config"]) and d["config"]["devices"] == 8
    assert d["collective_scopes"]["stage_handoff"]["count"] > 0
    assert any(k.startswith("halo_exchange") for k in d["collective_scopes"])


@pytest.mark.slow
def test_sp8x8_multilevel_builds(tmp_path):
    """The counterpart of ``tests/test_sp8x8.py:138-185``: ``--spatial-parts
    64,16`` (SP 8x8 coarsening to 4x4) x PP 2 on 128 ranks of the ``fake``
    group builds and reports per-rank memory, and the chain's respatial is
    in the step's collectives."""
    r, d = _run_tool(["--image-size", "512", "--spatial-parts", "64,16", "--stages", "2",
                      "--parts", "2", "--num-layers", "6", "--num-filters", "64",
                      "--spatial-until", "4", "--schedule", "1f1b"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert d["config"]["devices"] == 128 and d["config"]["grid"] == "8x8"
    assert d["config"]["spatial_parts"] == [64, 16] and d["value"] > 0
    assert any(k.startswith("respatial") for k in d["collective_scopes"]), d["collective_scopes"]
