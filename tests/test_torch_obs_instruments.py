"""The port's step instruments (``mpi4dl_tpu_torch/obs/{scopes,comm_stats,
hbm,timeline,overlap,kineto,trace}.py``, the probe's ``--attribute``/
``--overlap``/``--delta-parts``/``--sweep-junction``, the ``obs`` CLI's
``overlap`` and ``trace --families/--profile``) against the JAX package's
``obs/{hlo_stats,hbm,timeline,overlap}.py`` on the same inputs.

- The pure helpers equal the JAX functions: pipeline ticks and bubbles,
  ``wire_class`` over every scope name the port opens and the JAX tests'
  vocabulary, ``clean_scope_path``, the breakdown helpers and growth
  groups, and the four ``format_*`` texts on equal dicts.
- The ledger's hand cases (``tests/test_overlap.py:165-241``'s numbers,
  given as event intervals), and a queueing case against the JAX walker on
  a scheduled module with the same timing.
- The collectives a step records on the ``fake`` process group: the
  ``lp`` family over 4 stages against the GPipe exchange worked out by
  hand; the ``sp`` family on 2x2, where D2 posts fewer halo sends than D1.
- Attribution on fake tensors: ``lp`` and ``sp`` (SP x PP) coverage >= 0.9
  (the JAX gate, ``tests/test_hbm.py:219``) with the probe's peak exactly;
  backward bytes land in their forward scopes (the carry).
- A CPU profile of a toy step: every op attributed or ``<unscoped>``, the
  rows adding up to the trace; two gloo ranks: every transfer sync and
  exposed.  The CLI on such traces, and ``--hlo`` refused.
- None of the new modules imports JAX or the JAX package.
"""

from __future__ import annotations

import ast
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpi4dl_tpu.obs import hbm as jhbm  # noqa: E402
from mpi4dl_tpu.obs import hlo_stats as jhlo  # noqa: E402
from mpi4dl_tpu.obs import overlap as joverlap  # noqa: E402
from mpi4dl_tpu.obs import timeline as jtimeline  # noqa: E402
from mpi4dl_tpu_torch.benchmarks import mem_probe as mp  # noqa: E402
from mpi4dl_tpu_torch.obs import comm_stats, hbm, kineto, overlap, scopes, timeline  # noqa: E402
from mpi4dl_tpu_torch.obs.__main__ import main as obs_main  # noqa: E402
from mpi4dl_tpu_torch.obs.overlap import WireEvent  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RESNET = "--model resnet --image-size 32 --num-layers 1".split()

# ---------------------------------------------------------------------------
# Pure helpers against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "both"])
def test_pipeline_ticks_and_bubbles_are_jaxs(schedule):
    for stages in range(1, 9):
        for parts in range(1, 17):
            assert timeline.pipeline_ticks(schedule, stages, parts) == \
                jtimeline.pipeline_ticks(schedule, stages, parts)
            assert timeline.bubble_fraction(schedule, stages, parts) == \
                jtimeline.bubble_fraction(schedule, stages, parts)


# Every scope name the port opens (mpi4dl_tpu_torch/**: scope(...)), a few
# of their paths, and the JAX tests' vocabulary (tests/test_overlap.py:345).
PORT_SCOPES = [
    "cell03", "stage1", "stage1_bwd", "gpipe_fwd", "gpipe_bwd", "stage_handoff",
    "cot_handoff", "fwd_tick", "bwd_tick", "stats_mirror", "gems_mirror",
    "gems_1f1b_scan", "gems_dual_scan", "pp_1f1b", "gpipe", "grad_reduce",
    "stats_reduce", "optimizer_update", "loss_reduce", "sp_region", "stage_lineup",
    "sp_region_bwd", "junction_gather", "respatial_l1", "sp_level0",
    "halo_exchange_sph", "halo_exchange_spw", "bn_cross_tile", "halo_d2_fused_h2w2",
    "d2_run", "stripe_bwd_halo", "stripe_bwd_stats", "stripe_bwd_scan",
    "sp_region/sp_level0/cell03/halo_exchange_spw", "gpipe/gpipe_bwd/cot_handoff",
    "sp_region/sp_level0/cell02/d2_run/bn_cross_tile", "",
    "junction_batch_split_a2a", "tail_scan/stage_handoff", "tail_scan/grad_reduce",
    "ring_step_hop", "mb_inject", "respatial_l0",
]


@pytest.mark.parametrize("cls", list(comm_stats.COLLECTIVE_CLASSES))
def test_wire_class_is_jaxs(cls):
    for s in PORT_SCOPES:
        assert overlap.wire_class(s, cls) == joverlap.wire_class(s, cls), s


def test_clean_scope_path_is_jaxs():
    paths = ["jit(step)/jit(main)/jit(shmap_body)/jvp(sp_level0)/cell00/"
             "halo_exchange_spw/ppermute",
             "jit(step)/transpose(jvp(cell03))/checkpoint/while/body/conv/dot_general",
             "jit(step)/remat(tail_scan)/branch_1_fun/stage_handoff/ppermute", "x"]
    for p in paths:
        assert scopes.clean_scope_path(p) == jhlo.clean_scope_path(p)
        for c in p.split("/"):
            assert scopes.clean_scope_component(c) == jhlo.clean_scope_component(c)


_SYNTH = """\
HloModule jit_step, is_scheduled=true

%fused_computation (param_0: f32[16,16]) -> f32[16,16] {
  %param_0 = f32[16,16]{1,0} parameter(0)
  ROOT %neg = f32[16,16]{1,0} negate(f32[16,16]{1,0} %param_0), metadata={op_name="jit(step)/jit(main)/prep/neg"}
}

ENTRY %main (Arg_0.1: f32[8,16], Arg_1.2: f32[16,16]) -> f32[16,16] {
  %Arg_0.1 = f32[8,16]{1,0} parameter(0), metadata={op_name="x"}
  %Arg_1.2 = f32[16,16]{1,0} parameter(1), metadata={op_name="state.w"}
  %dot.1 = f32[8,16]{1,0} dot(f32[8,16]{1,0} %Arg_0.1, f32[16,16]{1,0} %Arg_1.2), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(step)/jit(main)/layer0/dot_general"}
  %fus = f32[16,16]{1,0} fusion(f32[16,16]{1,0} %Arg_1.2), kind=kLoop, calls=%fused_computation, metadata={op_name="jit(step)/jit(main)/prep/neg"}
  ROOT %ret = (f32[16,16]{1,0}, f32[8,16]{1,0}) tuple(f32[16,16]{1,0} %fus, f32[8,16]{1,0} %dot.1)
}
"""

# The growth dicts of tests/test_hbm.py:275-300.
_A = {"by_scope": {"sp_region/sp_level0/cell00": 100, "tail_scan/stage0": 500,
                   "stage_lineup": 50, "(args) x": 10}}
_B = {"by_scope": {"sp_region/sp_level0/cell00": 900, "tail_scan/stage0": 600,
                   "stage_lineup": 250, "(args) x": 30}}
_C = {"by_scope": {"sp_region/sp_level0/cell00": 100, "tail_scan/stage0": 100,
                   "stage_lineup": 10, "(args) x": 30}}


def test_breakdown_helpers_and_texts_are_jaxs():
    from benchmarks.mem_probe import growth_groups, top_growth_group

    bd = jhbm.attribute_hlo(_SYNTH)
    other = json.loads(json.dumps(bd))
    other["by_scope"]["prep"] += 2048
    other["peak_bytes_est"] += 2048
    for a in (bd, _A, _B, _C):
        assert hbm.top_scope(a) == jhbm.top_scope(a)
        assert hbm.top_scope(a, ("tail",)) == jhbm.top_scope(a, ("tail",))
        for depth in (1, 2):
            assert hbm.scope_group_bytes(a, depth) == jhbm.scope_group_bytes(a, depth)
    for a, b in ((bd, other), (_A, _B), (_B, _C)):
        assert hbm.compare_breakdowns(a, b) == jhbm.compare_breakdowns(a, b)
    assert hbm.format_breakdown(bd) == jhbm.format_breakdown(bd)
    delta = jhbm.compare_breakdowns(bd, other)
    assert hbm.format_delta(delta) == jhbm.format_delta(delta)
    for a, b in ((_A, _B), (_B, _C)):
        assert hbm.growth_groups(a, b, 2, 4) == growth_groups(a, b, 2, 4)
        g = hbm.growth_groups(a, b, 2, 4)
        assert hbm.top_growth_group(g) == top_growth_group(g)
    with pytest.raises(ValueError):
        hbm.growth_groups(_A, _B, 4, 4)


# ---------------------------------------------------------------------------
# The ledger: hand cases as event intervals (tests/test_overlap.py:165-241)
# ---------------------------------------------------------------------------

# A 10^6-byte payload at 1e10 B/s is 0.1 ms of wire; a 2e9-FLOP dot at 1e11
# FLOP/s is 20 ms of compute (the JAX tests' nominal rates).
_CASES = {
    # name: (events, compute intervals, totals, simulated step)
    "hidden": ([WireEvent("halo_exchange_spw", "collective-permute", 10**6, 0.0, 0.1)],
               [(0.0, 20.0)], dict(hidden_ms=0.1, exposed_ms=0.0), 20.0),
    "exposed": ([WireEvent("halo_exchange_spw", "collective-permute", 10**6, 0.0, 0.1)],
                [(0.1, 20.1)], dict(hidden_ms=0.0, exposed_ms=0.1), 20.1),
    "partial": ([WireEvent("junction_gather", "all-gather", 10**7, 0.0, 1.0)],
                [(0.0, 0.4)], dict(hidden_ms=0.4, exposed_ms=0.6), 1.0),
    "sync": ([WireEvent("respatial_l0", "reduce-scatter", 10**6, 20.0, 0.1, sync=True)],
             [(0.0, 20.0), (20.1, 40.1)], dict(hidden_ms=0.0, exposed_ms=0.1), 40.1),
    # Two 1 ms transfers issued together with 0.5 ms of compute: the second
    # queues behind the first on the one wire.
    "queueing": ([WireEvent("halo_exchange_sph", "collective-permute", 10**7, 0.0, 1.0),
                  WireEvent("halo_exchange_spw", "collective-permute", 10**7, 0.0, 1.0)],
                 [(0.0, 0.5)], dict(hidden_ms=0.5, exposed_ms=1.5), 2.0),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_ledger_hand_cases(case):
    events, compute, want, step = _CASES[case]
    led = overlap.overlap_ledger(events, compute, ici_bw=1e10, ici_source="given",
                                 peak=1e11, peak_source="given")
    t = led["totals"]
    for k, v in want.items():
        assert t[k] == pytest.approx(v), (k, t)
    assert t["hidden_ms"] + t["exposed_ms"] == pytest.approx(t["wire_ms"])
    assert led["simulated_step_ms"] == pytest.approx(step)
    assert t["sync"] == (1 if case == "sync" else 0)
    assert led["hidden_frac"] == pytest.approx(t["hidden_ms"] / t["wire_ms"])
    assert set(led) >= {"rows", "row_count", "by_class", "totals", "hidden_frac",
                        "quantized_frac", "attributed_bytes_frac", "compute_ms",
                        "simulated_step_ms", "peak_flops", "peak_source",
                        "ici_bytes_per_s", "ici_source"}


_QUEUE = """\
HloModule jit_step, is_scheduled=true

ENTRY %main (p0: f32[250,500], p1: f32[2500,1000], p2: f32[2500,1000]) -> f32[250,200] {
  %p0 = f32[250,500]{1,0} parameter(0)
  %p1 = f32[2500,1000]{1,0} parameter(1)
  %p2 = f32[2500,1000]{1,0} parameter(2)
  %a = (f32[2500,1000]{1,0}, f32[2500,1000]{1,0}) collective-permute-start(f32[2500,1000]{1,0} %p1), source_target_pairs={{0,1},{1,0}}, metadata={op_name="jit(step)/jit(main)/halo_exchange_sph/ppermute"}
  %b = (f32[2500,1000]{1,0}, f32[2500,1000]{1,0}) collective-permute-start(f32[2500,1000]{1,0} %p2), source_target_pairs={{0,1},{1,0}}, metadata={op_name="jit(step)/jit(main)/halo_exchange_spw/ppermute"}
  %dot.0 = f32[250,200]{1,0} dot(f32[250,500]{1,0} %p0, f32[500,200]{1,0} %p0), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(step)/jit(main)/cell00/dot_general"}
  %ad = f32[2500,1000]{1,0} collective-permute-done((f32[2500,1000]{1,0}, f32[2500,1000]{1,0}) %a), metadata={op_name="jit(step)/jit(main)/halo_exchange_sph/ppermute"}
  %bd = f32[2500,1000]{1,0} collective-permute-done((f32[2500,1000]{1,0}, f32[2500,1000]{1,0}) %b), metadata={op_name="jit(step)/jit(main)/halo_exchange_spw/ppermute"}
  ROOT %r = f32[250,200]{1,0} negate(f32[250,200]{1,0} %dot.0)
}
"""


def test_queueing_case_is_the_jax_walkers_and_texts_match():
    """The JAX walker on a scheduled module with the queueing case's timing
    (two 10^7-byte permutes, a 0.5 ms dot in their window) gives the port's
    numbers; the two packages' ledger and timeline texts agree on equal
    dicts."""
    want = joverlap.overlap_ledger(_QUEUE, peak=1e11, ici_bw=1e10)
    events, compute, _, _ = _CASES["queueing"]
    got = overlap.overlap_ledger([WireEvent(**vars(e)) for e in events], compute,
                                 ici_bw=1e10, ici_source="given", peak=1e11,
                                 peak_source="given")
    for k in ("bytes", "wire_ms", "hidden_ms", "exposed_ms", "async_pairs", "sync"):
        assert got["totals"][k] == pytest.approx(want["totals"][k]), k
    assert got["simulated_step_ms"] == pytest.approx(want["simulated_step_ms"])
    assert got["by_class"].keys() == want["by_class"].keys()
    assert overlap.format_ledger(want) == joverlap.format_ledger(want)
    tl = jtimeline.analytical_timeline(_QUEUE, peak=1e11, ici_bw=1e10, schedule="gpipe",
                                       stages=2, parts=4)
    assert timeline.format_timeline(tl) == jtimeline.format_timeline(tl)


def test_structural_overlap_counts_sync_bytes_exposed():
    recs = [{"op": "recv_", "cls": "collective-permute", "bytes": 8, "scope": "h",
             "async": True, "quantized": False, "unit": 0, "counted": True},
            {"op": "send", "cls": "collective-permute", "bytes": 8, "scope": "h",
             "async": True, "quantized": False, "unit": 0, "counted": False},
            {"op": "allreduce_", "cls": "all-reduce", "bytes": 16, "scope": "",
             "async": False, "quantized": False, "unit": 1, "counted": True}]
    s = overlap.structural_overlap(recs)
    assert s["totals"] == {"async_pairs": 1, "sync": 1, "bytes": 24, "exposed_bytes": 16}
    assert s["per_scope"]["<unscoped>"]["all-reduce"]["sync"] == 1
    assert comm_stats.collective_stats(recs)["total_count"] == 2
    units = comm_stats.launch_units(recs)
    assert [u["bytes"] for u in units] == [8, 16]


# ---------------------------------------------------------------------------
# Recorded collectives on the fake group
# ---------------------------------------------------------------------------


def _records(flags, family, rank):
    return mp.probe_role(mp._runner_cfg(flags, ""), family, rank,
                         instruments=True)["collective_records"]


def test_lp_four_stages_records_the_gpipe_exchange():
    """GPipe over 4 stages, 4 micro-batches of 1: a middle stage receives
    each micro-batch's activation (``stage_handoff``) and cotangent
    (``cot_handoff``) once and sends each once, posted async; the loss mean
    is one sync all-reduce.  The first stage receives no activation, the
    last no cotangent."""
    from mpi4dl_tpu_torch.benchmarks.common import build_model

    flags = RESNET + ["--batch-size", "4", "--split-size", "4", "--parts", "4"]
    cfg = mp._runner_cfg(flags, "")
    model = build_model(cfg, device=torch.device("meta"))
    from mpi4dl_tpu_torch.parallel.partition import StagePartition

    part = StagePartition.build(model, 4, (1, 32, 32, 3))
    for rank in (0, 1, 3):
        recs = _records(flags, "lp", rank)
        by = {}
        for r in recs:
            key = (r["op"], r["scope"].split("/")[-1])
            by[key] = by.get(key, 0) + 1
            assert r["async"] == (r["op"] in ("send", "recv_")), r
        want = {("allreduce_", "loss_reduce"): 1}
        if rank > 0:
            want.update({("recv_", "stage_handoff"): 4, ("send", "cot_handoff"): 4})
        if rank < 3:
            want.update({("send", "stage_handoff"): 4, ("recv_", "cot_handoff"): 4})
        assert by == want, (rank, by)
        stats = comm_stats.collective_stats(recs)
        act = lambda s: 4 * torch.Size(part.act_shapes[s]).numel()  # noqa: E731
        want_bytes = (act(rank) if rank > 0 else 0) + (act(rank + 1) if rank < 3 else 0)
        assert stats["collective-permute"] == {"count": 4 * ((rank > 0) + (rank < 3)),
                                               "bytes": 4 * want_bytes}
        assert stats["all-reduce"] == {"count": 1, "bytes": 8}  # fp32 loss, accuracy


@pytest.fixture(scope="module")
def sp_records():
    base = RESNET + ["--batch-size", "2", "--num-spatial-parts", "4"]
    return {d2: _records(base + (["--halo-d2"] if d2 else []), "sp", 1)
            for d2 in (False, True)}


def test_sp_grid_records_halos_and_d2_posts_fewer(sp_records):
    """On the 2x2 grid every halo receive pairs with a send on its axis,
    the junction is one all-gather, the gradients one flat all-reduce in
    ``grad_reduce``; D2 posts fewer halo sends than D1."""
    sends = {}
    for d2, recs in sp_records.items():
        count = {}
        for r in recs:
            count[(r["op"], r["scope"].split("/")[-1])] = \
                count.get((r["op"], r["scope"].split("/")[-1]), 0) + 1
        for axis in ("sph", "spw"):
            assert count[("send", f"halo_exchange_{axis}")] == \
                count[("recv_", f"halo_exchange_{axis}")] > 0
        assert count[("allgather_", "junction_gather")] == 1
        assert count[("allreduce_", "grad_reduce")] == 1
        sends[d2] = sum(v for (op, sc), v in count.items()
                        if op == "send" and sc.startswith("halo_exchange"))
    assert sends[True] < sends[False], sends


# ---------------------------------------------------------------------------
# Attribution on fake tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family, flags", [
    ("lp", RESNET + ["--batch-size", "4", "--split-size", "2", "--parts", "2"]),
    ("sp", RESNET + ["--batch-size", "4", "--split-size", "2", "--parts", "2",
                     "--num-spatial-parts", "2", "--slice-method", "vertical"]),
])
def test_attribution_covers_the_probes_peak(family, flags):
    cfg = mp._runner_cfg(flags, "")
    plain = mp.probe_role(cfg, family, 0)
    got = mp.probe_role(cfg, family, 0, instruments=True)
    bd = got["hbm"]
    assert got["peak_bytes"] == plain["peak_bytes"] == bd["peak_bytes_est"]
    assert sum(bd["by_scope"].values()) == bd["peak_bytes_est"]
    assert bd["coverage"] >= 0.9, bd["by_scope"]
    assert bd["reconcile"]["ratio_est_over_actual"] == 1.0
    assert hbm.top_group(bd) is not None
    assert got["timeline"]["serialized_ms"] >= got["timeline"]["overlapped_ms"]
    assert got["overlap"]["hidden_frac"] in (None, 0.0)


def test_backward_work_lands_in_its_forward_scope():
    """The carry: backward ops (CPU backward runs on the calling thread,
    inside another scope), a custom autograd Function's backward, and a
    checkpointed region's recompute all read their forward path."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import checkpoint

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append((func._opname, scopes.current_path()))
            return func(*args, **(kwargs or {}))

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 3

    def region(t):
        with scopes.scope("cell04"):
            return torch.sin(t)

    w = torch.randn(4, 4, requires_grad=True)
    with scopes.instrumenting(), Spy():
        with scopes.scope("stage0"):
            with scopes.scope("cell03"):
                y = Twice.apply(torch.relu(torch.randn(2, 4) @ w))
            y = checkpoint(region, y, use_reentrant=False)
        with scopes.scope("stage0_bwd"):
            y.sum().backward()
    bwd = dict((n, p) for n, p in seen[[n for n, _ in seen].index("ones_like"):])
    assert bwd["threshold_backward"] == "stage0/cell03"
    assert bwd["cos"] == "stage0/cell04"
    assert ("mul", "stage0/cell03") in seen[-8:] or bwd["mul"] in ("stage0/cell03",
                                                                  "stage0/cell04")
    assert torch.autograd.Function.apply.__func__.__name__ == "apply"
    assert scopes.recompute_path("gpipe/stage0/cell17", ["cell00"]) == "gpipe/stage0/cell00"


# ---------------------------------------------------------------------------
# Profiled steps: the measured timeline, the ledger and the CLI
# ---------------------------------------------------------------------------


def _toy_step():
    torch.manual_seed(0)
    w = torch.randn(64, 64, requires_grad=True)
    x = torch.randn(32, 64)
    with scopes.scope("cell00"):
        h = torch.relu(x @ w)
    with scopes.scope("cell01"):
        y = (h @ w).tanh()
    loss = y.square().mean()
    loss.backward()


@pytest.fixture(scope="module")
def toy_trace(tmp_path_factory):
    path = tmp_path_factory.mktemp("prof") / "trace.json.gz"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _toy_step()
    prof.export_chrome_trace(str(path))
    return path


def test_measured_timeline_attributes_every_op(toy_trace):
    tr = kineto.Trace(str(toy_trace))
    tl = timeline.measured_timeline(tr)
    leaves = sum(e["dur"] for e in tr.leaves) / 1e3
    assert tl["ops"] == len(tr.leaves) and tl["device"] == "cpu"
    # The rows are rounded to 1e-4 ms each.
    assert sum(r["device_ms"] for r in tl["rows"]) == pytest.approx(
        leaves, abs=1e-4 * len(tl["rows"]))
    scopes_seen = {r["scope"] for r in tl["rows"]}
    assert scopes_seen <= {"cell00", "cell01", kineto.UNSCOPED}, scopes_seen
    # The backward ops take their forward scope through the sequence links.
    ops = tr.device_ops()
    bwd = [o for o in ops if o["backward"] and o["name"] == "aten::threshold_backward"]
    assert bwd and all(o["scope"] == "cell00" for o in bwd)
    assert any(o["backward"] and o["scope"] == "cell01" for o in ops)
    assert "measured timeline (cpu)" in timeline.format_timeline(tl)


def test_cli_on_a_profile_and_refusing_hlo(toy_trace, tmp_path, capsys):
    assert obs_main(["overlap", "--profile", str(toy_trace), "--json",
                     "--out", str(tmp_path / "l.json")]) == 0
    led = json.loads((tmp_path / "l.json").read_text())[str(toy_trace)]
    assert led["totals"]["bytes"] == 0 and led["source"] == "measured"
    out = tmp_path / "t.json"
    assert obs_main(["trace", "--profile", str(toy_trace), "--out", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"wire", "device stalls"} <= names
    assert any(e.get("cat") == "measured" and e["name"] == "cell00" for e in events)
    capsys.readouterr()
    assert obs_main(["overlap", "--hlo", "x.hlo"]) == 2
    assert obs_main(["trace", "--hlo", "x.hlo", "--out", str(out)]) == 2
    assert "compiles no HLO" in capsys.readouterr().err
    assert obs_main(["overlap"]) == 2
    assert obs_main(["overlap", "--families", "bogus"]) == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# One gloo rank of a toy step (sync all-reduce, sync send/recv): its
# collectives recorded, then the same step profiled.  Run as a script, so
# that a rank imports the port and not this file (and JAX).
_GLOO_RANK = """
import os, sys
import torch, torch.distributed as dist
from mpi4dl_tpu_torch.obs import comm_stats, kineto, scopes
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2)
x = torch.ones(64, 32)
def step():
    with scopes.scope("cell00"):
        y = (x @ torch.ones(32, 32)).relu()
    with scopes.scope("grad_reduce"):
        dist.all_reduce(y)
    with scopes.scope("stage_handoff"):
        if rank == 0:
            dist.send(y, 1)
        else:
            dist.recv(y, 0)
with comm_stats.recording_collectives() as recs:
    step()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    step()
path = os.path.join(out, f"rank{rank}.trace.json.gz")
prof.export_chrome_trace(path)
kineto.save_collectives(path, list(recs))
dist.destroy_process_group()
"""


def test_two_gloo_ranks_every_transfer_sync_and_exposed(tmp_path):
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(r), port,
                               str(tmp_path)], cwd=ROOT) for r in (0, 1)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    for rank in (0, 1):
        led = overlap.ledger_from_trace(str(tmp_path / f"rank{rank}.trace.json.gz"))
        t = led["totals"]
        assert led["match"]["matched"], led["match"]
        assert t["async_pairs"] == 0 and t["sync"] == 2, t
        assert t["hidden_ms"] == 0 and t["exposed_ms"] == pytest.approx(t["wire_ms"])
        assert led["hidden_frac"] == 0.0
        # The all-reduce's buffer; the transfer counted once, on the receiver.
        assert t["bytes"] == 64 * 32 * 4 * (2 if rank == 1 else 1)
        assert {r["scope"] for r in led["rows"]} <= {"grad_reduce", "stage_handoff"}


# ---------------------------------------------------------------------------
# The probe's CLI, the report, and the imports
# ---------------------------------------------------------------------------


def _role(breakdown_scale=1):
    def role(argv, schedule, rank):
        assert "--attribute" in argv
        bd = {"peak_bytes_est": 1000 * breakdown_scale, "coverage": 0.95,
              "scoped_temp_coverage": 0.9, "live_buffers": 3, "top_buffers": [],
              "by_scope": {"gpipe/gpipe_fwd/stage0/cell00": 600 * breakdown_scale,
                           "(args) state.model": 350, "(unattributed)": 50},
              "reconcile": None}
        parts = int(argv[argv.index("--parts") + 1])
        bd["by_scope"]["gpipe/gpipe_fwd/stage0/cell00"] *= parts
        bd["peak_bytes_est"] = sum(bd["by_scope"].values())
        return {"rank": rank, "peak_bytes": bd["peak_bytes_est"] + rank,
                "by_category": {}, "hbm": bd}
    return role


@pytest.mark.parametrize("extra, code", [
    (["--min-coverage", "0.9", "--require-attrib-top", "gpipe"], 0),
    (["--min-coverage", "0.99"], 1),
    (["--require-attrib-top", "sp_region"], 1),
    (["--delta-parts", "4", "--require-delta-top", "gpipe", "--require-delta-slope",
      "1"], 0),
    (["--delta-parts", "4", "--require-delta-top", "tail"], 1),
])
def test_probe_cli_gates_with_roles_stubbed(tmp_path, monkeypatch, extra, code, capsys):
    monkeypatch.setattr(mp, "_role_in_subprocess", _role())
    flags = RESNET + ["--batch-size", "4", "--split-size", "2", "--parts", "2"]
    rc = mp.main(["--family", "lp", "--schedule", "gpipe", "--attribute", *extra,
                  "--telemetry-dir", str(tmp_path / "t"), "--out", str(tmp_path / "o.json"),
                  *flags])
    assert rc == code, capsys.readouterr().err
    data = json.loads((tmp_path / "o.json").read_text())
    assert data["schedules"]["gpipe"]["hbm"]["coverage"] == 0.95
    if "--delta-parts" in extra:
        d = data["parts_delta"]["per_schedule"]["gpipe"]
        assert d["top_growth_group"] == "gpipe"
        assert d["growth_bytes_per_part"]["gpipe"] == 600
    from mpi4dl_tpu_torch.obs.report import render_run

    text = render_run(str(next((tmp_path / "t").glob("*.jsonl"))))
    assert "hbm attribution [lp/gpipe]" in text


@pytest.mark.parametrize("argv, says", [
    (["--min-coverage", "0.9"], "need --attribute"),
    (["--require-hidden-frac", "0.5"], "needs --overlap"),
    (["--attribute", "--require-delta-slope", "1"], "needs --delta-parts"),
    (["--sweep-junction", "--family", "lp"], "--sweep-junction probes the sp family"),
    (["--attribute", "--delta-parts", "4"], "needs an engine family"),
])
def test_probe_cli_refuses_flags_without_their_instrument(argv, says, capsys):
    assert mp.main(argv) == 2
    assert says in capsys.readouterr().err


def _role_in_process(argv, schedule, rank):
    """``mem_probe._role_in_subprocess`` in this process (the fake group is
    joined and left around each role)."""
    args, rest = mp._parser().parse_known_args(argv)
    return mp.probe_role(mp._runner_cfg(rest, schedule), args.family, rank,
                         instruments=mp._instruments(args))


def test_probe_overlap_and_sweep_on_the_fake_group(tmp_path, monkeypatch, capsys):
    """``--overlap --require-hidden-frac``: one card moves no byte, so the
    gate passes; ``--sweep-junction`` probes one placement a level (the
    roles in this process) and the report renders the frontier."""
    monkeypatch.setattr(mp, "_role_in_subprocess", _role_in_process)
    flags = RESNET + ["--batch-size", "2", "--num-spatial-parts", "2",
                      "--slice-method", "vertical"]
    out = tmp_path / "o.json"
    rc = mp.main(["--family", "single", "--overlap", "--require-hidden-frac", "0.5",
                  "--out", str(out), *RESNET, "--batch-size", "1"])
    assert rc == 0  # one card moves no byte: the gate passes
    assert json.loads(out.read_text())["overlap"]["hidden_frac"] is None
    rc = mp.main(["--family", "sp", "--sweep-junction", "--junction-levels", "1,2",
                  "--out", str(out), "--telemetry-dir", str(tmp_path / "t"), *flags])
    assert rc == 0
    art = json.loads(out.read_text())
    assert [p["spatial_until"] for p in art["placements"]] == [1, 2]
    assert sum(p["best"] for p in art["placements"]) == 1
    from mpi4dl_tpu_torch.obs.report import render_run

    text = render_run(str(next((tmp_path / "t").glob("*.jsonl"))))
    assert "junction placement frontier" in text and "<-- best" in text
    capsys.readouterr()


def test_report_renders_every_instrument_record(tmp_path):
    from mpi4dl_tpu_torch.obs import RunLog
    from mpi4dl_tpu_torch.obs.report import render_run

    bd = jhbm.attribute_hlo(_SYNTH)
    led = overlap.overlap_ledger(*_CASES["partial"][:2], ici_bw=1e10, ici_source="given")
    rl = RunLog(str(tmp_path / "r.jsonl"))
    rl.write_meta(config={"model": "resnet"}, family="lp")
    rl.write("cost", flops=1e9, collectives=comm_stats.collective_stats([]))
    rl.write("hbm", label="step", breakdown=bd)
    rl.write("overlap", label="step", **led)
    rl.write("timeline", label="step", **jtimeline.analytical_timeline(
        _QUEUE, peak=1e11, ici_bw=1e10))
    rl.write("timeline", label="profile", source="measured", device="cuda", total_ms=2.0,
             coverage=1.0, ops=3, rows=[{"scope": "cell00", "device_ms": 2.0}])
    rl.write("xprof_ops", total_self_ms=2.0, ops=[{"self_ms": 2.0, "occurrences": 3,
                                                   "category": "kernel", "name": "k",
                                                   "bound_by": None, "scope": "cell00"}])
    rl.write("mem_probe", parts_delta={"parts_a": 2, "parts_b": 4, "per_schedule": {
        "gpipe": {"top_growth_group": "gpipe", "growth_bytes_per_part": {"gpipe": 10}}}})
    rl.write("junction_sweep", placements=[{"spatial_until": 1, "peak_gb_est": 1.0,
                                            "best": True}])
    rl.close()
    text = render_run(str(tmp_path / "r.jsonl"))
    for line in ("hbm attribution [step]", "wire [step]:", "analytical timeline:",
                 "measured timeline [profile]:", "device ops: total self time 2.0 ms",
                 "collectives per step", "O(parts) growth [gpipe]",
                 "junction placement frontier"):
        assert line in text, line


def test_no_new_module_imports_jax():
    new = ["obs/scopes.py", "obs/comm_stats.py", "obs/hbm.py", "obs/timeline.py",
           "obs/overlap.py", "obs/kineto.py", "obs/trace.py", "obs/families.py",
           "obs/__main__.py", "obs/report.py", "benchmarks/mem_probe.py",
           "benchmarks/profile_step.py", "benchmarks/instruments_check.py",
           "benchmarks/communication/comm_volume_report.py"]
    for rel in new:
        tree = ast.parse((ROOT / "mpi4dl_tpu_torch" / rel).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not (n == "jax" or n.startswith("jax.") or n == "mpi4dl_tpu"
                            or n.startswith("mpi4dl_tpu.")), (rel, n)


_SMALL_LP = RESNET + ["--batch-size", "4", "--split-size", "2", "--parts", "2"]


def test_family_cli_and_hidden_frac_gate(tmp_path, monkeypatch, capsys):
    """``obs overlap|trace --families`` on a family's step (the contract
    flags cut to depth 1) and the probe's ``--require-hidden-frac``: the
    fake group's transfers are sync, so a positive fraction fails where
    bytes move."""
    from mpi4dl_tpu_torch.obs import families

    monkeypatch.setattr(families, "family_flags",
                        lambda f: ("lp", _SMALL_LP + ["--schedule", families.schedule_of(f)]))
    out = tmp_path / "l.json"
    assert obs_main(["overlap", "--families", "lp", "--json", "--out", str(out)]) == 0
    led = json.loads(out.read_text())["lp"]
    # Stage 0: two cotangents received, the loss all-reduce; all sync here.
    assert led["totals"]["sync"] == 3 and led["totals"]["async_pairs"] == 0
    assert led["hidden_frac"] == 0.0 and led["totals"]["bytes"] > 0
    trace = tmp_path / "t.json"
    assert obs_main(["trace", "--families", "lp_1f1b", "--out", str(trace)]) == 0
    events = json.loads(trace.read_text())["traceEvents"]
    procs = {e["args"]["name"] for e in events if e["name"] == "process_name"}
    assert procs == {"wire [lp_1f1b]", "timeline [lp_1f1b]", "pipeline [lp_1f1b]"}
    assert sum(e.get("cat") == "bubble" for e in events) == 2  # fill + drain
    monkeypatch.setattr(mp, "_role_in_subprocess", _role_in_process)
    assert mp.main(["--family", "sp", "--schedule", "gpipe", "--overlap",
                    "--require-hidden-frac", "0.5", *RESNET, "--batch-size", "2",
                    "--num-spatial-parts", "2", "--slice-method", "vertical"]) == 1
    assert "hidden wire fraction 0.000 < --require-hidden-frac" in capsys.readouterr().err
