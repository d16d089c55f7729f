"""The port's cross-rank wire verifier (``mpi4dl_tpu_torch/analysis/
ircheck``): every finding kind on a violating fixture and a clean one, each
fixture a few ranks run one after another on the ``fake`` process group in
this process; the contract families proved clean; and parity of the pure
table proofs with the JAX verifier's ``_perm_problems`` /
``_group_problems`` on the same tables."""

from __future__ import annotations

import json
import os

import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.testing._internal.distributed.fake_pg import FakeStore

from mpi4dl_tpu_torch.analysis.__main__ import main as analysis_main
from mpi4dl_tpu_torch.analysis.ircheck import (
    FINDING_KINDS, NO_COUNTERPART, check_family, check_roles, watching,
)
from mpi4dl_tpu_torch.analysis.ircheck.collectives import _group_problems, _perm_problems
from mpi4dl_tpu_torch.obs import scopes
from mpi4dl_tpu_torch.obs.comm_stats import group_dims

GOLDENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "mpi4dl_tpu_torch", "analysis", "contracts", "goldens")


def roles_of(world, body, tables=None):
    """Each rank's recorded ``body(rank)`` on the fake group, as roles."""
    tables = tables or {"world": [list(range(world))]}
    out = []
    for rank in range(world):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        try:
            with watching(group_dims(tables)) as w:
                body(rank)
        finally:
            dist.destroy_process_group()
        out.append({"family": "fx", "rank": rank, "world": world, "groups": tables,
                    "records": w.records, "scopes": w.paths,
                    "findings": [f.as_dict() for f in w.findings("fx", rank)],
                    "wasted": w.wasted()})
    return out


def kinds(roles):
    return sorted({f.kind for f in check_roles(roles, "fx")})


def _exchange(rank, peer, n=4, m=4, tag=0):
    send = torch.ones(n)
    recv = torch.empty(m)
    ops = [dist.P2POp(dist.isend, send, peer, tag=tag), dist.P2POp(dist.irecv, recv, peer, tag=tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def clean_exchange(rank):
    with scopes.scope("halo_exchange_spw"):
        _exchange(rank, 1 - rank)
    loss = torch.randn(1)
    dist.all_reduce(loss)


CASES = {
    # kind: (violating body, ranks)
    "wasted-wire": (lambda rank: [dist.all_reduce(t) for t in [torch.randn(3)] * 2], 2),
    "nonbijective-perm": (lambda rank: [r.wait() for r in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, torch.ones(2), 1 - rank),
        dist.P2POp(dist.isend, torch.ones(2), 1 - rank),
        dist.P2POp(dist.irecv, torch.empty(2), 1 - rank),
        dist.P2POp(dist.irecv, torch.empty(2), 1 - rank)])], 2),
    "peer-out-of-group": (lambda rank: dist.isend(torch.ones(2), rank).wait(), 2),
    "mismatched-collective": (lambda rank: dist.all_reduce(torch.randn(4 + 4 * rank)), 2),
    "unmatched-p2p": (lambda rank: rank == 0 and dist.isend(torch.ones(2), 1).wait(), 2),
    "p2p-size-mismatch": (lambda rank: _exchange(rank, 1 - rank, n=4, m=4 + rank), 2),
    "deadlock": (lambda rank: (dist.send(torch.ones(2), 1 - rank),
                               dist.recv(torch.empty(2), 1 - rank)), 2),
    "unwaited-async": (lambda rank: dist.isend(torch.ones(2), 1 - rank) if rank == 0
                       else dist.recv(torch.empty(2), 0), 2),
}


def _race(rank):
    buf = torch.zeros(4)
    if rank == 0:
        req = dist.irecv(buf, 1)
        buf.add_(1)  # reads and writes the receive buffer before the wait
        req.wait()
    else:
        dist.send(torch.ones(4), 0)


CASES["async-buffer-race"] = (_race, 2)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_kind_fires_on_its_fixture(kind):
    body, world = CASES[kind]
    assert kind in kinds(roles_of(world, body)), kind


def test_mismatched_replica_groups_fixture():
    roles = roles_of(4, lambda rank: None,
                     tables={"tiles": [[0, 1], [2, 3]], "stage": [[0, 2], [1, 3]]})
    assert kinds(roles) == []
    roles[1]["groups"] = {**roles[1]["groups"], "tiles": [[0, 1], [1, 2, 3]]}
    found = [f for f in check_roles(roles, "fx") if f.kind == "mismatched-replica-groups"]
    assert found and any("unequal group sizes" in f.message for f in found)
    assert any("differ from rank 0" in f.message for f in found)


def test_clean_fixture_and_every_kind_covered():
    assert kinds(roles_of(2, clean_exchange)) == []
    assert set(CASES) | {"mismatched-replica-groups"} == set(FINDING_KINDS)
    assert not set(NO_COUNTERPART) & set(FINDING_KINDS)


def test_unmatched_send_names_rank_and_scope():
    def body(rank):
        with scopes.scope("stage_handoff"):
            if rank == 0:
                dist.isend(torch.ones(8), 1).wait()

    found = check_roles(roles_of(2, body), "fx")
    assert {f.kind for f in found} == {"unmatched-p2p", "deadlock"}
    for f in found:
        assert f.scope == "stage_handoff" and "rank 0" in f.message, f.render()


def test_async_wait_and_buffer_clean():
    def body(rank):
        buf = torch.zeros(4)
        req = dist.irecv(buf, 1 - rank) if rank == 0 else dist.isend(torch.ones(4), 0)
        req.wait()
        buf.add_(1)  # after the wait: no race

    assert kinds(roles_of(2, body)) == []


def test_wasted_wire_needs_every_member():
    def body(rank):
        # stage 0 reduces a constant, stage 1 its own value: not wasted
        dist.all_reduce(torch.zeros(2) if rank == 0 else torch.randn(2))
        t = torch.randn(3)
        dist.all_reduce(t)
        dist.all_reduce(t * 2)  # identical on every member after the first

    found = [f for f in check_roles(roles_of(2, body), "fx") if f.kind == "wasted-wire"]
    assert [f.message.split(":")[0] for f in found] == ["collective #2 on group [0, 1] (world)"]


def test_positional_ops_dereplicate():
    def body(rank):
        t = torch.randn(4)
        dist.all_reduce(t)
        dist.all_reduce(t[rank * 2:rank * 2 + 2].clone())  # each rank its own piece

    assert kinds(roles_of(2, body)) == []


def test_families_prove_clean():
    """The committed goldens pin an empty ircheck section for every family
    (raw and int8), and the lp family proves clean live."""
    names = [os.path.join(d, f) for d in (GOLDENS, os.path.join(GOLDENS, "quant_int8"))
             for f in sorted(os.listdir(d)) if f.endswith(".json") and f != "kernels.json"]
    assert len(names) == 16
    for name in names:
        with open(name, encoding="utf-8") as fh:
            assert json.load(fh)["ircheck"] == {}, name
    assert check_family("lp", jobs=2) == []


def test_cli_usage_errors():
    assert analysis_main(["ircheck", "--families", "nope"]) == 2
    assert analysis_main(["ircheck", "--quant", "off"]) == 2


PAIRS = st.lists(st.tuples(st.integers(-1, 6), st.integers(-1, 6)), max_size=7)
GROUPS = st.lists(st.lists(st.integers(-1, 8), min_size=1, max_size=4), max_size=4)
SIZES = st.one_of(st.none(), st.integers(1, 8))


@settings(max_examples=150, deadline=None)
@given(PAIRS, SIZES)
def test_perm_problems_parity(pairs, size):
    from mpi4dl_tpu.analysis.ircheck.collectives import _perm_problems as jax_perm

    assert _perm_problems(pairs, size) == jax_perm(pairs, size)


@settings(max_examples=150, deadline=None)
@given(GROUPS, SIZES)
def test_group_problems_parity(groups, size):
    from mpi4dl_tpu.analysis.ircheck.collectives import _group_problems as jax_groups

    assert _group_problems(groups, size) == jax_groups(groups, size)


@pytest.mark.parametrize("table,size", [
    ([(0, 1), (1, 2), (2, 0)], 3), ([(0, 1), (0, 2)], 3), ([(0, 1), (2, 1)], 3),
    ([(0, 5)], 4), ([], 2)])
def test_perm_problems_parity_fixed(table, size):
    from mpi4dl_tpu.analysis.ircheck.collectives import _perm_problems as jax_perm

    assert _perm_problems(table, size) == jax_perm(table, size)


def test_records_carry_the_cross_rank_fields():
    tables = {"tiles": [[0, 1]], "stage": [[0], [1]]}

    def body(rank):
        with scopes.scope("halo_exchange_spw"):
            _exchange(rank, 1 - rank, tag=3)
        dist.all_reduce(torch.randn(2, 3), op=dist.ReduceOp.MAX, async_op=True).wait()

    role = roles_of(2, body, tables)[1]
    send, recv, red = role["records"]
    assert (send["op"], send["peer"], send["tag"], send["group"], send["dim"]) == (
        "send", 0, 3, [0, 1], "tiles")
    assert (recv["op"], recv["peer"], recv["unit"]) == ("recv_", 0, send["unit"])
    assert (recv["dtype"], recv["shape"], recv["reduce_op"]) == ("float32", [4], None)
    assert (red["reduce_op"], red["shape"], red["async"]) == ("max", [2, 3], True)
    assert [r["work"] for r in role["records"]] == [0, 1, 2]
    assert role["findings"] == [] and role["scopes"] == ["halo_exchange_spw"]


def test_sarif_of_findings(tmp_path):
    from mpi4dl_tpu_torch.analysis.sarif import finding_results, sarif_log

    body, world = CASES["unmatched-p2p"]
    found = check_roles(roles_of(world, body), "fx")
    log = sarif_log(extra=finding_results(found, "ircheck", lambda f: "obs/families.py"))
    results = log["runs"][0]["results"]
    assert {r["ruleId"] for r in results} == {"ircheck/unmatched-p2p", "ircheck/deadlock"}
    assert all(r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"]
               == "obs/families.py" for r in results)
