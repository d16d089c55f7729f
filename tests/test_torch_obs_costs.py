"""The port's cost counts (mpi4dl_tpu_torch/obs/costs.py) and the runners'
``cost`` record, against the JAX package (mpi4dl_tpu/obs/costs.py) and
against ``torch.utils.flop_counter.FlopCounterMode``.

- ``mfu`` and ``arithmetic_intensity`` equal JAX's over a grid of inputs;
  the peak and interconnect sources for an H100, an unknown card and the
  CPU (with and without the nominal peak).
- One conv's count is the hand formula exactly (``tests/test_obs.py:230``'s
  case); each kernel's shape formula (``halo_conv.flops``,
  ``flash_attention.flops``) is ``FlopCounterMode`` on its plain version:
  K1, K1 with the fused ReLU, K2 with a margin-excluding window, K1 as a
  dx, K3 and its backward.
- The small AmoebaNet step of ``tests/test_torch_train.py`` with the
  kernels off counts 0.469 of JAX's ``compiled_cost``: XLA's cost model also
  counts the elementwise work (BatchNorms, pools) that ``FlopCounterMode``
  does not, half of XLA's count at 16 filters.  With the kernels on the
  count is held to the plain versions' own, not to JAX's (JAX's would be
  the Pallas interpret-mode lowering), and a launch the dispatch modes
  cannot see (the card's route, emulated on the CPU) gives the same count
  through the wrappers' tallies.
- The runner's ``cost`` record on the CPU (``--device cpu``), a counting
  error turned into a ``cost_error`` record, and on two gloo ranks (this
  file run as the ranks' script) ``flops_by_rank`` and the run's device
  count in the ``meta`` record.
"""

import json
import os
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_torch_ring import launch_gloo_ranks  # noqa: E402

from mpi4dl_tpu_torch.obs import costs  # noqa: E402
from mpi4dl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from mpi4dl_tpu_torch.ops import halo_conv as hc  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
SMALL = ["--device", "cpu", "--image-size", "32", "--num-layers", "1",
         "--batch-size", "2", "--steps-per-epoch", "3"]
AMOEBA = (2, 128, 128, 3)  # tests/test_torch_train.py's SHAPE
# Port FLOPs / JAX compiled_cost FLOPs of that step, kernels off: 0.469
# (72,382,464 / 154,241,408 on the CPU).  XLA counts the elementwise and
# reduction work too; the band allows for its fusion choices moving by a
# few percent between jax versions.
JAX_RATIO = (0.45, 0.49)


def _flops_of(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("flops,ms,peak,n", [
    (1e9, 10.0, 1e12, 1), (1e9, 10.0, 1e12, 2), (5.04e12, 412.5, 989e12, 1),
    (None, 10.0, 1e12, 1), (1e9, 0.0, 1e12, 1), (1e9, None, 1e12, 1),
    (1e9, 10.0, None, 1), (0.0, 10.0, 1e12, 1), (1e9, -5.0, 1e12, 1),
])
def test_mfu_matches_jax(flops, ms, peak, n):
    from mpi4dl_tpu.obs import costs as jcosts

    assert costs.mfu(flops, ms, peak, n) == jcosts.mfu(flops, ms, peak, n)


@pytest.mark.parametrize("flops,nbytes", [
    (2e9, 5e8), (None, 5e8), (2e9, None), (0.0, 1.0), (5038581669888, 292330139374),
])
def test_arithmetic_intensity_matches_jax(flops, nbytes):
    from mpi4dl_tpu.obs import costs as jcosts

    assert costs.arithmetic_intensity(flops, nbytes) == \
        jcosts.arithmetic_intensity(flops, nbytes)


@pytest.mark.parametrize("name,source", [(H100, "table"), ("Some Future Card", "assumed-max")])
def test_peak_and_interconnect_sources(monkeypatch, name, source):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert costs.peak_flops(cuda) == (989e12, source)
    assert costs.peak_flops("cuda:1", allow_cpu_nominal=True) == (989e12, source)
    assert costs.ici_bytes_per_s(cuda) == (9e11, source)
    assert costs.peak_flops(cpu) == (None, None)
    assert costs.peak_flops(cpu, allow_cpu_nominal=True) == (1e11, "nominal-cpu")
    assert costs.ici_bytes_per_s(cpu) == (1e10, "nominal-cpu")


def test_conv_count_matches_the_hand_formula():
    n, h, w, cin, cout, k = 2, 16, 16, 8, 16, 3
    x = torch.zeros((n, cin, h, w))
    kern = torch.zeros((cout, cin, k, k))
    cost = costs.step_cost(F.conv2d, x, kern)
    ho, wo = h - k + 1, w - k + 1
    assert cost["flops"] == 2 * n * ho * wo * k * k * cin * cout
    assert cost["bytes_accessed"] == 4 * (x.numel() + kern.numel() + n * cout * ho * wo)
    assert costs.arithmetic_intensity(cost["flops"], cost["bytes_accessed"]) > 0
    assert cost["kernels"] == {} and cost["error"] is None


@pytest.mark.parametrize("op,sizes", [
    (lambda a, b, c: a.copy_(b), 2),                  # b read, a written
    (lambda a, b, c: a.fill_(1.0), 1),                # a written
    (lambda a, b, c: a.add_(b), 3),                   # a and b read, a written
    (lambda a, b, c: torch.add(a, b, out=c), 3),      # a and b read, c written
    (lambda a, b, c: a + b, 3),
])
def test_bytes_count_each_read_and_write_once(op, sizes):
    a, b, c = (torch.zeros((4, 8)) for _ in range(3))
    assert costs.step_cost(op, a, b, c)["bytes_accessed"] == sizes * a.numel() * 4


def test_a_launch_count_reset_inside_a_counted_block_loses_no_work():
    x, w = torch.zeros((1, 6, 6, 2)), torch.zeros((3, 3, 2, 4))
    y = torch.zeros((1, 4, 4, 4))
    with costs.counting() as cost:
        hc._tally(x, w, y, False, None, 0)
        hc.reset_launch_counts()
        hc._tally(x, w, y, False, None, 0)
    assert hc.LAUNCHES["halo_conv2d"] == 1
    k = cost["kernels"]["halo_conv2d"]
    assert k["launches"] == 2 and k["flops"] == cost["flops"] == 2 * hc.flops(x.shape, w.shape)
    assert k["bytes"] == cost["bytes_accessed"] == 2 * hc.nbytes(x.shape, w.shape, 4, 4)


@pytest.mark.parametrize("case", ["k1", "k1_relu", "k2_margin_window", "k1_dx"])
def test_halo_conv_formula_is_flop_counter_mode_on_the_plain_version(case):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 12, 14, 6), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5, 6, 7), dtype=np.float32))
    relu, win = case != "k1", None
    if case == "k2_margin_window":
        win = (1, 9, 2, 8)   # the 10 x 10 output less a margin
    if case == "k1_dx":
        relu = False
        x, w = hc.pad_hw(torch.ones((2, 10, 10, 7)), 2, 4), hc._flip_swap(w)
    counted = _flops_of(hc.halo_conv2d_plain, x, w, None, relu, win)
    assert hc.flops(x.shape, w.shape) == counted > 0
    ho, wo = x.shape[1] - w.shape[0] + 1, x.shape[2] - w.shape[1] + 1
    want = (x.numel() if relu else 0) + (3 * 2 * 8 * 6 * 7 if win else 0)
    assert hc.vector_flops(x.shape, w.shape, relu, win) == want
    assert hc.nbytes(x.shape, w.shape, 4, 2, stat_rows=3) == \
        4 * (x.numel() + w.numel()) + 2 * 2 * ho * wo * w.shape[3] + 2 * 3 * w.shape[3] * 4


@pytest.mark.parametrize("causal", [False, True])
def test_block_flash_formulas_are_flop_counter_mode_on_the_plain_versions(causal):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, t, 8), generator=gen) for t in (16, 24, 24))
    o, m, l = fa.block_flash_plain(q, k, v, 0, 8, causal, 0.5)
    assert _flops_of(fa.block_flash_plain, q, k, v, 0, 8, causal, 0.5) == fa.flops(2, 16, 24, 8)
    do, dl = torch.randn(o.shape, generator=gen), torch.randn(l.shape, generator=gen)
    assert _flops_of(fa.block_flash_bwd_plain, q, k, v, m, do, dl, 0, 8, causal, 0.5, 10) \
        == fa.flops(2, 16, 24, 8, backward=True)
    assert fa.nbytes(2, 16, 24, 8, 2, 2) == 2 * (2 * 16 * 8 + 2 * 2 * 24 * 8) + 2 * 16 * 10 * 4


@pytest.fixture(scope="module")
def amoeba():
    """The small AmoebaNet step with the kernels off (False) and on (True),
    each built once and run once under ``FlopCounterMode`` and
    :func:`costs.counting` together (and, kernels on, ``count_dispatches``):
    {pallas: (step, state, x, y, FlopCounterMode's count, counting's
    record, the K1/K2 calls)}."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(AMOEBA).astype(np.float32))
    out = {}
    for pallas in (False, True):
        model = amoebanetd(AMOEBA, device="cpu", num_classes=10, num_layers=3, num_filters=16)
        opt = Optimizer("sgd", lr=0.01)
        step, state = make_train_step(model, opt, pallas_conv=pallas), TrainState.create(model, opt)
        with FlopCounterMode(display=False) as fc, hc.count_dispatches() as seen, \
                costs.counting() as cost:
            step(state, x, torch.arange(2))
        out[pallas] = (step, state, x, torch.arange(2), fc.get_total_flops(), cost, seen.calls)
    return out


@pytest.mark.parametrize("pallas", [False, True])
def test_counting_is_flop_counter_mode_on_a_step(amoeba, pallas):
    """The module's one dispatch mode counts a whole step as
    ``FlopCounterMode`` does, both counting the same run."""
    *_, want, cost, _ = amoeba[pallas]
    assert cost["flops"] == want == (74231808 if pallas else 72382464)
    assert cost["kernels"] == {} and cost["error"] is None


def test_amoebanet_count_against_jax_compiled_cost(amoeba, monkeypatch):
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.layer_ctx import ApplyCtx
    from mpi4dl_tpu.models.amoebanet import amoebanetd as j_amoebanetd
    from mpi4dl_tpu.obs.costs import compiled_cost
    from mpi4dl_tpu.obs.scopes import _reset_enabled_cache
    from mpi4dl_tpu.train import make_loss_fn

    _, _, x, y, _, cost, _ = amoeba[False]
    port = cost["flops"]
    assert port == 72382464  # the count of this step (PyTorch's formulas)
    # Without the scope names XLA's cost model counts the same program,
    # and the lowering takes seconds instead of most of a minute.
    monkeypatch.setenv("MPI4DL_NO_SCOPES", "1")
    _reset_enabled_cache()
    try:
        model = j_amoebanetd(AMOEBA, num_classes=10, num_layers=3, num_filters=16)
        # Lowering needs the parameters' shapes only.
        params = jax.eval_shape(lambda key: model.init(key)[0], jax.random.key(0))
        loss = make_loss_fn(model, ApplyCtx(train=True))
        vg = jax.jit(jax.value_and_grad(lambda p, a, b: loss(p, a, b)[0]))
        ref = compiled_cost(vg.lower(params, jnp.asarray(x.numpy()),
                                     jnp.asarray(y.numpy())).compile())["flops"]
    finally:
        monkeypatch.delenv("MPI4DL_NO_SCOPES")
        _reset_enabled_cache()
    assert JAX_RATIO[0] <= port / ref <= JAX_RATIO[1], (port, ref, port / ref)


def test_kernel_tallies_give_the_plain_versions_count(amoeba, monkeypatch):
    """The card's route on the CPU: each K1/K2 call runs its plain version
    out of sight of the dispatch modes (as a ctypes launch is) and is
    counted through the wrapper's tally; the step's count is the plain
    versions' own."""
    from torch.utils._python_dispatch import _disable_current_modes

    def launching(x, w, out_dtype=None, fuse_relu=False, stat_window=None):
        with _disable_current_modes():
            out = hc.halo_conv2d_plain(x, w, out_dtype, fuse_relu, stat_window)
        hc._tally(x, w, out if stat_window is None else out[0], fuse_relu, stat_window, 0)
        return out

    step, state, x, y, _, plain, calls = amoeba[True]
    monkeypatch.setattr(hc, "halo_conv2d", launching)
    card = costs.step_cost(step, state, x, y)
    assert card["flops"] == plain["flops"]
    for name in ("halo_conv2d", "halo_conv2d_stats"):
        mine = [c for c in calls if c[0] == name]
        k = card["kernels"][name]
        assert k["launches"] == len(mine) == 20
        assert k["flops"] == sum(hc.flops(c[2], c[3]) for c in mine)
        assert k["vector_flops"] == sum(hc.vector_flops(c[2], c[3], c[5], c[6]) for c in mine)
    assert card["bytes_accessed"] > 0 and card["error"] is None


def _runner_cost(tmp_path, extra=()):
    from mpi4dl_tpu_torch.benchmarks.common import run
    from mpi4dl_tpu_torch.obs import read_runlog

    out = run("lp", "resnet", SMALL + ["--telemetry-dir", str(tmp_path)] + list(extra))
    return out, read_runlog(out["telemetry_path"])


def test_runner_cost_record_counts_its_warmup_step(tmp_path):
    from mpi4dl_tpu_torch.benchmarks.common import _build
    from mpi4dl_tpu_torch.config import config_from_args, get_parser

    out, recs = _runner_cost(tmp_path)
    kinds = [r["kind"] for r in recs]
    assert kinds == ["meta", "cost", "step", "step", "step", "summary"], kinds
    cost = recs[1]
    assert cost["peak_source"] == "nominal-cpu" and cost["peak_flops"] == 1e11
    assert cost["device_count"] == recs[0]["device_count"] == 1
    assert cost["tick_scopes"] == [] and cost["kernels"] == {}
    assert "flops_by_rank" not in cost and "collectives" not in cost
    assert cost["arithmetic_intensity"] == cost["flops"] / cost["bytes_accessed"]
    assert os.path.exists(os.path.splitext(out["telemetry_path"])[0] + ".prom")
    # The same step counted directly: FLOPs do not depend on the values.
    cfg = config_from_args(get_parser().parse_known_args(SMALL)[0])
    step, state, _, _ = _build(cfg, "lp", torch.device("cpu"), None, print)
    direct = costs.step_cost(step, state, torch.zeros((2, 32, 32, 3)), torch.zeros(2).long())
    assert cost["flops"] == direct["flops"] > 0


def test_runner_counting_error_is_a_cost_error_record(tmp_path, monkeypatch, capfd):
    from torch.utils.flop_counter import flop_registry

    def broken(*a, **k):
        raise ValueError("formula broken for the test")

    monkeypatch.setitem(flop_registry, torch.ops.aten.convolution, broken)
    out, recs = _runner_cost(tmp_path)
    kinds = [r["kind"] for r in recs]
    assert "cost" not in kinds and kinds.count("cost_error") == 1, kinds
    assert "formula broken for the test" in recs[kinds.index("cost_error")]["error"]
    assert kinds.count("step") == 3 and out["final_step"] == 3
    assert "telemetry cost record unavailable" in capfd.readouterr().err


def test_meta_device_count_is_the_runs_not_the_machines(tmp_path, monkeypatch):
    """A one-process run on a machine of four cards uses one: the ``meta``
    record's ``device_count`` (the report's ``devices:`` line) is 1, as the
    cost record's is."""
    from mpi4dl_tpu_torch.obs import RunLog, read_runlog

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    with RunLog(str(tmp_path / "run.jsonl")) as rl:
        rl.write_meta(config={}, device=torch.device("cuda", 0))
    meta = read_runlog(str(tmp_path / "run.jsonl"))[0]
    assert meta["platform"] == "gpu" and meta["device_kind"] == H100
    assert meta["device_count"] == 1


# ---------------------------------------------------------------------------
# Two gloo ranks: the lp runner's 1F1B pipeline over two stages.
# ---------------------------------------------------------------------------


def _rank_main(job: str, rank: int, world: int, workdir: Path) -> None:
    import torch.distributed as dist

    from mpi4dl_tpu_torch.benchmarks.common import run

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    out = run("lp", "resnet", SMALL + ["--split-size", "2", "--parts", "2", "--schedule",
                                       "1f1b", "--telemetry-dir", str(workdir / "tele")])
    (workdir / f"rank{rank}.json").write_text(json.dumps(out["telemetry_path"]))
    dist.destroy_process_group()


def test_ranks_gather_their_counts_to_rank_0(tmp_path):
    from mpi4dl_tpu_torch.obs import read_runlog

    launch_gloo_ranks("cost", tmp_path, world=2, script=__file__)
    paths = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    base = os.path.splitext(os.path.basename(paths[0]))[0]
    assert paths[1] is None  # rank 0 alone writes the RunLog and its snapshot
    assert sorted(os.listdir(tmp_path / "tele")) == [base + ".jsonl", base + ".prom"]
    recs = read_runlog(paths[0])
    meta, cost = recs[0], next(r for r in recs if r["kind"] == "cost")
    assert meta["device_count"] == cost["device_count"] == 2
    by_rank = cost["flops_by_rank"]
    assert len(by_rank) == 2 and all(f > 0 for f in by_rank)
    assert cost["flops"] == sum(by_rank) / 2
    assert cost["tick_scopes"] == ["bwd_tick", "fwd_tick"]


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
