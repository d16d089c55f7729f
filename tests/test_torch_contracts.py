"""The port's recorded-collective contract gate (``mpi4dl_tpu_torch/
analysis/contracts``): the golden round trip of the GPipe families (the
1F1B and ``--quant int8`` sets under ``-m slow``, as the JAX gate's tests
run theirs), an injected extra all-gather in the halo exchange named by the
drift report, the quantized byte-ratio gate, and parity of the diff with
the JAX ``diff_contracts`` on the same contracts."""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os

import numpy as np
import pytest

from mpi4dl_tpu_torch.analysis.__main__ import main as analysis_main
from mpi4dl_tpu_torch.analysis.contracts.diff import (
    diff_contracts, diff_kernels_contract, diff_rank, quant_byte_ratios,
    render_drift_report,
)
from mpi4dl_tpu_torch.analysis.contracts.engines import extract_many
from mpi4dl_tpu_torch.analysis.contracts.extract import CONTRACT_SCHEMA, contract_of

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(os.path.dirname(HERE), "mpi4dl_tpu_torch", "analysis", "contracts",
                       "goldens")
GPIPE = ("lp", "sp", "gems", "gems_sp")
ONE_F_ONE_B = ("lp_1f1b", "sp_1f1b", "gems_1f1b", "gems_sp_1f1b")
FAULT = "torch_contract_faults:extra_halo_all_gather"


def golden(name, quant=False):
    with open(os.path.join(GOLDENS, "quant_int8" if quant else "", f"{name}.json"),
              encoding="utf-8") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def extracted():
    """The GPipe families' roles and the ``sp`` family's with the fault, in
    role processes at once."""
    env = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (HERE, env) if p)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            clean = pool.submit(extract_many, list(GPIPE), None, 4)
            faulty = pool.submit(extract_many, ["sp"], None, 2, FAULT)
            return clean.result(), faulty.result()["sp"]
    finally:
        if env is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = env


@pytest.mark.parametrize("family", GPIPE)
def test_golden_round_trip(extracted, family):
    current = contract_of(family, extracted[0][family])
    drifts = diff_contracts(golden(family), current)
    assert drifts == [], render_drift_report(family, drifts)
    assert current["schema"] == CONTRACT_SCHEMA and current["ircheck"] == {}


@pytest.mark.slow
@pytest.mark.parametrize("quant", [None, "int8"])
def test_golden_round_trip_slow_sets(quant):
    families = list(ONE_F_ONE_B) + ([] if quant is None else list(GPIPE))
    roles = extract_many(families, quant, 4)
    for family in families:
        drifts = diff_contracts(golden(family, quant is not None),
                                contract_of(family, roles[family]))
        assert drifts == [], render_drift_report(family, drifts)


def test_injected_all_gather_names_the_halo_scope(extracted):
    drifts = diff_contracts(golden("sp"), contract_of("sp", extracted[1]))
    gathers = [d for d in drifts if d["kind"] == "collective" and d["op"] == "all-gather"
               and d["scope"].endswith("/halo_exchange_spw")]
    assert gathers and all(d["count_golden"] == 0 for d in gathers), drifts
    assert {d["rank"] for d in gathers} == {0, 1, 2, 3}
    report = render_drift_report("sp", drifts)
    assert "/halo_exchange_spw: all-gather APPEARED" in report, report
    # the p2p halo traffic itself is unchanged
    assert not [d for d in drifts if d["kind"] == "collective"
                and d["op"] == "collective-permute"]


def _raw_quant(raw_grad, quant_grad, handoff=(100, 90)):
    def contract(grad, hand):
        return {"ranks": {"0": {"collectives": {
            "grad_reduce": {"all-reduce": {"count": 1, "bytes": grad}},
            "gpipe/gpipe_fwd/stage_handoff": {"collective-permute": {"count": 1,
                                                                     "bytes": hand}},
            "loss_reduce": {"all-reduce": {"count": 1, "bytes": 8}}}}}}
    return contract(raw_grad, handoff[0]), contract(quant_grad, handoff[1])


def test_quant_byte_ratio_gate():
    rows, breaches = quant_byte_ratios(*_raw_quant(1000, 300), 0.55)
    assert breaches == [] and {r["class"]: r["ratio"] for r in rows} == {
        "grad": 0.3, "handoff": 0.9}
    rows, breaches = quant_byte_ratios(*_raw_quant(1000, 600), 0.55)
    assert len(breaches) == 1 and "class grad" in breaches[0]
    # the committed int8 set holds its gated classes under 0.55 of the raw set
    for family in GPIPE + ONE_F_ONE_B:
        rows, breaches = quant_byte_ratios(golden(family), golden(family, True), 0.55)
        assert breaches == [], (family, rows)
        gated = {r["class"]: r["ratio"] for r in rows if r["gated"]}
        if family.startswith(("sp", "gems_sp")):
            assert 0 < gated["grad"] < 0.55 and 0 < gated["junction"] < 0.55, gated


def _section(rng):
    scopes = ["a", "a/halo_exchange_spw", "b/stage_handoff", "grad_reduce"]
    classes = ["all-reduce", "collective-permute", "all-gather"]

    def tree(keys):
        return {k: {c: {"count": int(rng.integers(0, 3)), "bytes": int(rng.integers(0, 4))}
                    for c in rng.choice(classes, size=int(rng.integers(1, 3)),
                                        replace=False)}
                for k in rng.choice(keys, size=int(rng.integers(0, len(keys))),
                                    replace=False)}

    per_scope = {s: {c: {f: int(rng.integers(0, 3)) for f in
                         ("async_pairs", "sync", "bytes", "exposed_bytes")}
                     for c in ops} for s, ops in tree(scopes).items()}
    return {"collectives": tree(scopes), "axis_collectives": tree(["tiles", "stage", "data"]),
            "scopes": sorted(rng.choice(scopes, size=int(rng.integers(0, 4)),
                                        replace=False).tolist()),
            "overlap": {"per_scope": per_scope, "totals": {}}}


@pytest.mark.parametrize("seed", range(12))
def test_diff_parity_with_jax(seed):
    """On the same contracts (collectives, axis_collectives, scopes,
    overlap) the port's drift records equal the JAX gate's."""
    from mpi4dl_tpu.analysis.contracts.diff import diff_contracts as jax_diff

    rng = np.random.default_rng(seed)
    g, c = _section(rng), _section(rng)
    if seed % 3 == 0:
        c = copy.deepcopy(g)
    meta = {"schema": 3, "engine": "sp"}
    want = jax_diff({**meta, **g}, {**meta, **c})
    assert diff_rank(g, c) == want
    whole = diff_contracts({"schema": 1, "engine": "sp", "ranks": {"0": g}},
                           {"schema": 1, "engine": "sp", "ranks": {"0": c}})
    assert whole == [{**d, "rank": 0} for d in want]


def test_meta_inputs_and_ircheck_drift():
    base = golden("lp")
    assert diff_contracts(base, base) == []
    other = copy.deepcopy(base)
    other["ranks"].pop("1")
    assert [d["field"] for d in diff_contracts(base, other)] == ["ranks"]
    other = copy.deepcopy(base)
    other["inputs"]["1"]["state"]["own_bytes"] += 4
    other["ircheck"] = {"unmatched-p2p": 1}
    kinds = [(d["kind"], d.get("field", d.get("finding"))) for d in diff_contracts(base, other)]
    assert kinds == [("inputs", "state"), ("ircheck", "unmatched-p2p")]
    assert diff_contracts(base, {**base, "engine": "sp"})[0]["kind"] == "meta"


def test_kernels_contract_diff():
    g = {"schema": 1, "smem_frac": 1.0, "symbols": {"k<1>": {"regs": 80, "stack": 0}},
         "cases": {"c": ["k<1>"]}, "kernels": {"halo_conv2d": ["k<1>"]}}
    assert diff_kernels_contract(g, copy.deepcopy(g)) == []
    c = copy.deepcopy(g)
    c["symbols"]["k<1>"]["stack"] = 8
    c["symbols"]["k<2>"] = {"regs": 1}
    fields = [(d["kernel"], d["field"]) for d in diff_kernels_contract(g, c)]
    assert fields == [("k<1>", "stack"), ("k<2>", "presence")]


def test_cli_usage_errors():
    assert analysis_main(["contracts", "--engines", "nope"]) == 2
    assert analysis_main(["contracts", "--quant", "off"]) == 2
    assert analysis_main(["contracts", "--quant", "int8", "--engines", "kernels"]) == 2
    # the kernels contract needs the built libraries and a card
    assert analysis_main(["contracts", "--engines", "kernels"]) == 2
