"""The port's source-level analyzer (mpi4dl_tpu_torch/analysis) and its
kernel registry (mpi4dl_tpu_torch/ops/kernel_registry.py).

A positive and a negative fixture for every rule and every numbered check,
written as strings into ``tmp_path`` (the JAX analyzer's repo gate scans
``tests/`` too, so no fixture may be live code here); parity with the JAX
analyzer for the three rules that carry over unchanged; the repo gate over
the port's default paths with no baseline; the CLI; and the registry's rows
on the CPU against the JAX package's kernels (Pallas interpret mode), at the
registry's shapes, with the JAX tests' tolerances.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4dl_tpu.analysis import RULES_BY_NAME as JAX_RULES
from mpi4dl_tpu.analysis import analyze_paths as jax_analyze_paths
from mpi4dl_tpu.ops import pallas_attention as jpa
from mpi4dl_tpu.ops import pallas_conv as jpc
from mpi4dl_tpu_torch.analysis import (
    RULE_TABLE,
    RULES_BY_NAME,
    analyze_paths,
    build_project,
    run_rules,
    stale_pragmas,
)
from mpi4dl_tpu_torch.analysis import __main__ as cli
from mpi4dl_tpu_torch.ops import kernel_registry as kr

ROOT = cli.repo_root()


def _write(tmp_path, filename, source):
    f = tmp_path / filename
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    return f


def _run(tmp_path, source, rule, filename="mpi4dl_tpu_torch/fix.py", extra=()):
    """Findings of ``rule`` over the fixture (plus ``extra`` (name, source)
    files), as (rule, line, message)."""
    paths = [_write(tmp_path, filename, source)]
    paths += [_write(tmp_path, n, s) for n, s in extra]
    vs = analyze_paths([str(p) for p in paths], root=str(tmp_path),
                       rules=[RULES_BY_NAME[rule]])
    return [(v.rule, v.line, v.message) for v in vs]


# ---------------------------------------------------------------------------
# Positive and negative fixtures: (rule, filename, source, lines flagged)
# ---------------------------------------------------------------------------

CASES = {
    # collective-axis (a): an explicit group
    "group_missing": ("collective-axis", "mpi4dl_tpu_torch/fix.py", """
        import torch.distributed as dist
        def f(t, g, peer):
            dist.all_reduce(t)
            dist.barrier()
            return dist.P2POp(dist.isend, t, peer)
        """, [4, 5, 6]),
    "group_given": ("collective-axis", "mpi4dl_tpu_torch/fix.py", """
        import torch.distributed as dist
        def f(t, g, peer, parts):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
            dist.all_reduce(t, dist.ReduceOp.SUM, g)
            dist.all_gather(parts, t, group=g)
            dist.barrier(group=g)
            ops = [dist.P2POp(dist.isend, t, peer, g)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        """, []),
    "group_missing_in_a_tool": ("collective-axis", "mpi4dl_tpu_torch/benchmarks/fix.py", """
        import torch.distributed as dist
        def f(t):
            dist.all_reduce(t)
        """, []),
    # collective-axis (b): mesh-group lookups
    "group_key_typo": ("collective-axis", "mpi4dl_tpu_torch/fix.py", """
        import torch.distributed as dist
        def build(ranks):
            mine = {}
            g = dist.new_group(ranks)
            mine["tiles"] = g
            return mine["tile"], mine.get("data_stages"), "stagee" in mine
        """, [7, 7, 7]),
    "group_keys_of_the_mesh": ("collective-axis", "mpi4dl_tpu_torch/fix.py", """
        import torch.distributed as dist
        def build(ranks, world):
            mine, other = {}, {}
            g = dist.group.WORLD if world else dist.new_group(ranks)
            mine["tiles"] = g
            other["whatever"] = 1
            return (mine["tiles"], mine.get("data_tiles"), "stage" in mine,
                    other["anything"])
        """, []),
    # collective-axis (c): peer tables
    "perm_not_bijective": ("collective-axis", "mpi4dl_tpu_torch/fix.py", """
        from mpi4dl_tpu_torch.quant.collectives import quantized_shift
        def f(t, g):
            a = quantized_shift(t, g, [(0, 1), (1, 1)], None, 0, None)
            return a, quantized_shift(t, g, mode=None, block=0, cls=None,
                                      perm=[(0, 1), (0, 2)])
        """, [4, 5]),
    "perm_bijective": ("collective-axis", "mpi4dl_tpu_torch/fix.py", """
        from mpi4dl_tpu_torch.quant.collectives import quantized_shift
        def f(t, g, perm):
            a = quantized_shift(t, g, [(0, 1), (1, 2), (2, 0)], None, 0, None)
            return a, quantized_shift(t, g, perm, None, 0, None)
        """, []),
    # host-sync
    "sync_in_autograd_function": ("host-sync", "mpi4dl_tpu_torch/fix.py", """
        import torch
        def helper(x):
            return x.item()
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, q_off):
                n = int(q_off)
                if x.sum() > 0:
                    x = x * 2
                ctx.n = helper(x)
                return x
            @staticmethod
            def backward(ctx, g):
                s = float(torch.linalg.norm(g))
                torch.cuda.synchronize()
                return g.cpu(), None
        """, [4, 9, 15, 16, 17]),
    "sync_outside_autograd": ("host-sync", "mpi4dl_tpu_torch/fix.py", """
        import torch
        def step(x):
            return x.sum().item()
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, q_off):
                ctx.off = int(q_off)
                if ctx.off and torch.is_tensor(x):
                    x = x * 2
                return self_helper(x)
        class Plain:
            def forward(self, x):
                return x.item()
        """, []),
    "checkpointed_clock_and_random": ("host-sync", "mpi4dl_tpu_torch/fix.py", """
        import random
        import time
        import numpy as np
        from torch.utils.checkpoint import checkpoint
        def body(x):
            t = time.time()
            return x * random.random() * np.random.rand()
        def run(x):
            return checkpoint(body, x, use_reentrant=False)
        """, [7, 8, 8]),
    "clock_outside_checkpoint": ("host-sync", "mpi4dl_tpu_torch/fix.py", """
        import time
        from torch.utils.checkpoint import checkpoint
        def body(x):
            return x * 2
        def run(x):
            t = time.time()
            return checkpoint(body, x, use_reentrant=False), t
        """, []),
    "sync_in_graph_capture": ("host-sync", "mpi4dl_tpu_torch/fix.py", """
        import torch
        def step(x):
            return x.tolist()
        def capture(g, x):
            with torch.cuda.graph(g):
                y = step(x)
                z = x.numpy()
            return y, z
        """, [4, 8]),
    # dtype-policy (1): float64
    "float64_in_hot_path": ("dtype-policy", "mpi4dl_tpu_torch/ops/fix.py", """
        import torch
        def f(x):
            return torch.zeros(3, dtype=torch.float64, device=x.device)
        """, [4]),
    "float64_following_the_input": ("dtype-policy", "mpi4dl_tpu_torch/parallel/fix.py", """
        import torch
        def wire_dtype(*tensors):
            return torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32
        def dw(wo, w):
            return torch.zeros(wo.shape, dtype=torch.float32 if w.dtype != torch.float64
                               else w.dtype, device=w.device)
        def sums(t):
            acc = torch.promote_types(t.dtype, torch.float32)
            return t.sum(dim=(0, 1, 2), dtype=acc)
        """, []),
    "float64_outside_hot_dirs": ("dtype-policy", "mpi4dl_tpu_torch/utils/fix.py", """
        import torch
        X = torch.float64
        """, []),
    # dtype-policy (2): constructors
    "constructor_without_dtype_or_device": ("dtype-policy", "mpi4dl_tpu_torch/ops/fix.py", """
        import torch
        def f(x, n):
            a = torch.zeros((n, 3), device=x.device)
            b = torch.arange(n, dtype=torch.int64)
            c = torch.full((n,), 1.0)
            return a, b, c
        """, [4, 5, 6]),
    "constructor_stating_both": ("dtype-policy", "mpi4dl_tpu_torch/ops/fix.py", """
        import torch
        def f(x, n, kw):
            a = torch.zeros((n, 3), dtype=x.dtype, device=x.device)
            b = torch.zeros_like(x)
            c = torch.empty(n, **kw)
            return a, b, c
        """, []),
    # dtype-policy (3): init builds fp32
    "init_builds_bf16": ("dtype-policy", "mpi4dl_tpu_torch/models/fix.py", """
        import torch
        def init(shape):
            return torch.randn(shape, dtype=torch.bfloat16)
        """, [4]),
    "init_builds_fp32": ("dtype-policy", "mpi4dl_tpu_torch/models/fix.py", """
        import torch
        def init(shape):
            return torch.randn(shape, dtype=torch.float32)
        """, []),
    # env-hatch: reads
    "undeclared_hatch": ("env-hatch", "mpi4dl_tpu_torch/fix.py", """
        import os
        def f():
            return os.environ.get("MPI4DL_NOT_A_HATCH"), os.environ["MPI4DL_NOR_THIS"]
        """, [4, 4]),
    "declared_hatch": ("env-hatch", "mpi4dl_tpu_torch/fix.py", """
        import os
        def f():
            os.environ["MPI4DL_UNDECLARED_WRITE"] = "1"
            return os.environ.get("MPI4DL_STRIPE_BWD", "0"), os.getenv("HOME")
        """, []),
    # import-time-tensor (1)
    "tensor_at_import": ("import-time-tensor", "mpi4dl_tpu_torch/fix.py", """
        import torch
        SCALE = torch.tensor(2.0)
        TABLE = {"a": torch.zeros(3)}
        HAS = torch.cuda.is_available()
        class K:
            DEV = torch.cuda.current_device()
        """, [3, 4, 5, 7]),
    "plain_numbers_from_tensors": ("import-time-tensor", "mpi4dl_tpu_torch/fix.py", """
        import torch
        _QMAX = {"int8": 127.0, "fp8": 448.0, "int4": 7.0}
        _RECIP = {m: float(torch.tensor(1.0 / q, dtype=torch.float32)) for m, q in _QMAX.items()}
        DT = torch.float32
        def f():
            if torch.cuda.is_available():
                return torch.zeros(3)
        """, []),
    # import-time-tensor (2)
    "cached_mutable_default": ("import-time-tensor", "mpi4dl_tpu_torch/fix.py", """
        import functools
        @functools.lru_cache(maxsize=None)
        def plan(n, dims=[0, 1]):
            return n
        @functools.cache
        def plan2(n, *, opts={}):
            return n
        """, [4, 7]),
    "cached_hashable_default": ("import-time-tensor", "mpi4dl_tpu_torch/fix.py", """
        import functools
        @functools.lru_cache(maxsize=None)
        def plan(n, dims=(0, 1)):
            return n
        def uncached(n, dims=[0, 1]):
            return n
        """, []),
    # print-call
    "print_in_library": ("print-call", "mpi4dl_tpu_torch/fix.py", """
        def f(x):
            print(x)
        """, [3]),
    "print_in_a_cli": ("print-call", "mpi4dl_tpu_torch/obs/__main__.py", """
        def f(x):
            print(x)
        """, []),
    "print_in_a_tool": ("print-call", "mpi4dl_tpu_torch/benchmarks/fix.py", """
        def f(x):
            print(x)
        """, []),
    # swallow-except
    "swallowed": ("swallow-except", "mpi4dl_tpu_torch/fix.py", """
        def f(g):
            try:
                g()
            except:
                pass
            try:
                g()
            except (ValueError, Exception):
                ...
        """, [5, 9]),
    "handled": ("swallow-except", "mpi4dl_tpu_torch/fix.py", """
        import logging
        def f(g):
            try:
                g()
            except Exception:
                logging.exception("g failed")
            try:
                g()
            except ValueError:
                pass
        """, []),
    # thread-shared-state
    "thread_without_sync": ("thread-shared-state", "mpi4dl_tpu_torch/fix.py", """
        import threading
        class W:
            def start(self):
                threading.Thread(target=self._run).start()
            def _run(self):
                self.error = 1
                self.items.append(2)
        """, [7, 8]),
    "thread_with_sync": ("thread-shared-state", "mpi4dl_tpu_torch/fix.py", """
        import threading
        class W:
            def __init__(self):
                self._lock = threading.Lock()
            def start(self):
                threading.Thread(target=self._run).start()
            def _run(self):
                with self._lock:
                    self.error = 1
        """, []),
    # unscoped-collective
    "unscoped": ("unscoped-collective", "mpi4dl_tpu_torch/parallel/fix.py", """
        import torch.distributed as dist
        from mpi4dl_tpu_torch.obs.scopes import scope
        def f(t, g, ops):
            dist.all_reduce(t, group=g)
            with scope("grad_reduce"):
                pass
            dist.batch_isend_irecv(ops)
        """, [5, 8]),
    "scoped": ("unscoped-collective", "mpi4dl_tpu_torch/quant/collectives.py", """
        import torch.distributed as dist
        from mpi4dl_tpu_torch.obs import scopes
        def f(t, g, ops):
            with scopes.scope("grad_reduce"):
                dist.all_reduce(t, group=g)
                for r in dist.batch_isend_irecv(ops):
                    r.wait()
        """, []),
    "unscoped_outside_the_layers": ("unscoped-collective", "mpi4dl_tpu_torch/resilience/fix.py", """
        import torch.distributed as dist
        def f(t, g):
            dist.all_reduce(t, group=g)
        """, []),
    # unquantized-collective
    "hot_scope_without_quant": ("unquantized-collective", "mpi4dl_tpu_torch/parallel/fix.py", """
        import torch.distributed as dist
        from mpi4dl_tpu_torch.obs.scopes import scope
        def f(parts, t, g, li, quant):
            if quant:
                pass
            with scope(f"respatial_l{li}"):
                dist.all_gather(parts, t, group=g)
            with scope("junction_gather"):
                dist.all_gather(parts, t, group=g)
        """, [8, 10]),
    "hot_scope_with_quant": ("unquantized-collective", "mpi4dl_tpu_torch/parallel/fix.py", """
        import torch.distributed as dist
        from mpi4dl_tpu_torch.obs.scopes import scope
        def f(parts, t, g, quant):
            with scope("stage_lineup"):
                if quant is None:
                    dist.all_gather(parts, t, group=g)
            with scope("loss_reduce"):
                dist.all_reduce(t, group=g)
        """, []),
    # unregistered-kernel-launch (a)
    "unregistered_library": ("unregistered-kernel-launch", "mpi4dl_tpu_torch/ops/newk.py", """
        import ctypes
        import triton
        from mpi4dl_tpu_torch.ops import _build
        def _library():
            lib = _build.load("newk")
            lib.newk_launch.argtypes = [ctypes.c_void_p]
            return lib
        @triton.jit
        def kernel(x_ptr):
            pass
        """, [6, 7, 10]),
    "registered_library": ("unregistered-kernel-launch", "mpi4dl_tpu_torch/ops/halo_conv.py", """
        import ctypes
        from mpi4dl_tpu_torch.ops import _build
        def _library():
            lib = _build.load("halo_conv")
            lib.halo_conv2d_launch.argtypes = [ctypes.c_void_p]
            return lib
        """, []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_fixture(tmp_path, case):
    rule, filename, source, lines = CASES[case]
    got = _run(tmp_path, source, rule, filename)
    assert sorted(line for _, line, _ in got) == sorted(lines), got


def test_every_rule_has_a_positive_and_a_negative_fixture():
    for rule in RULES_BY_NAME:
        flagged = [c for c in CASES.values() if c[0] == rule and c[3]]
        clean = [c for c in CASES.values() if c[0] == rule and not c[3]]
        assert flagged and clean, rule


def test_dead_flag_against_a_scanned_registry(tmp_path):
    config = """
        class Hatch:
            def __init__(self, *a, **k):
                pass
        HATCHES = {h.name: h for h in (Hatch("MPI4DL_READ", "0", "read"),
                                        Hatch("MPI4DL_DEAD", "0", "never read"))}
        """
    reader = """
        import os
        def f():
            return os.environ.get("MPI4DL_READ")
        """
    got = _run(tmp_path, reader, "env-hatch",
               extra=[("mpi4dl_tpu_torch/config.py", config)])
    assert [(line, "MPI4DL_DEAD" in msg) for _, line, msg in got] == [(6, True)], got


def test_unloaded_build_source(tmp_path):
    registry = "from mpi4dl_tpu_torch.ops import newk\n"
    build = 'SOURCES = ("newk", "orphan")\n'
    newk = """
        from mpi4dl_tpu_torch.ops import _build
        def _library():
            return _build.load("newk")
        """
    got = _run(tmp_path, newk, "unregistered-kernel-launch", "mpi4dl_tpu_torch/ops/newk.py",
               extra=[("mpi4dl_tpu_torch/ops/kernel_registry.py", registry),
                      ("mpi4dl_tpu_torch/ops/_build.py", build)])
    assert len(got) == 1 and got[0][1] == 1 and "orphan" in got[0][2], got


@pytest.mark.parametrize("rel,rule", [
    ("mpi4dl_tpu_torch/parallel/gems.py", "dtype-policy"),
    ("mpi4dl_tpu_torch/ops/hstripe_conv.py", "dtype-policy"),
    ("mpi4dl_tpu_torch/quant/kernels.py", "import-time-tensor"),
])
def test_the_ports_own_negative_sites(rel, rule):
    """The float64 sites that follow their input's dtype and the plain
    numbers quant/kernels.py builds from tensors at import stay clean."""
    assert analyze_paths([os.path.join(ROOT, rel)], root=ROOT,
                         rules=[RULES_BY_NAME[rule]]) == []


def test_pragma_suppresses_and_stale_pragma_is_reported(tmp_path):
    f = _write(tmp_path, "mpi4dl_tpu_torch/fix.py", """
        def f(x):
            print(x)  # analysis: ok(print-call)
        def g(x):  # analysis: ok(print-call)
            print(x)
            return x  # analysis: ok(swallow-except)
        """)
    project = build_project([str(f)], root=str(tmp_path))
    used = set()
    assert run_rules(project, RULE_TABLE, used_pragmas=used) == []
    stale = stale_pragmas(project, used)
    assert [(v.rule, v.line) for v in stale] == [("stale-pragma", 6)]


# ---------------------------------------------------------------------------
# Parity with the JAX analyzer for the rules that carry over unchanged
# ---------------------------------------------------------------------------

PARITY = {
    "print_and_cli": """
        def f(x):
            print(x)
            print(x)  # analysis: ok(print-call)
        def print_table(rows):
            for r in rows:
                print(r)
        """,
    "swallows": """
        def f(g):
            try:
                g()
            except:
                pass
            try:
                g()
            except BaseException as e:
                pass
            try:
                g()
            except Exception:
                raise
        """,
    "threads": """
        import threading
        STATE = {}
        def work():
            global COUNT
            COUNT = 1
            STATE["k"] = 2
        def spawn():
            threading.Thread(target=work).start()
        class Run(threading.Thread):
            def run(self):
                self.done = True
                self.items.append(1)
        """,
}
PARITY_RULES = ("print-call", "swallow-except", "thread-shared-state")


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_with_the_jax_rules(tmp_path, case):
    src = PARITY[case]
    jf = _write(tmp_path / "jax", "mpi4dl_tpu/fix.py", src)
    tf = _write(tmp_path / "torch", "mpi4dl_tpu_torch/fix.py", src)
    want = jax_analyze_paths([str(jf)], root=str(tmp_path / "jax"),
                             rules=[JAX_RULES[r] for r in PARITY_RULES])
    got = analyze_paths([str(tf)], root=str(tmp_path / "torch"),
                        rules=[RULES_BY_NAME[r] for r in PARITY_RULES])
    assert want, case  # every fixture trips its rule
    assert [(v.rule, v.line) for v in got] == [(v.rule, v.line) for v in want]


# ---------------------------------------------------------------------------
# The repo gate, the README and the CLI
# ---------------------------------------------------------------------------


def test_port_is_violation_free_without_a_baseline():
    """The gate as the CLI runs it on the whole tree: no finding and no
    stale pragma."""
    project = build_project(cli.default_paths(ROOT), root=ROOT)
    used = set()
    violations = run_rules(project, RULE_TABLE, used_pragmas=used)
    violations += stale_pragmas(project, used)
    assert violations == [], "\n".join(v.render() for v in violations)
    assert len(project.files) > 150 and len(project.hatches) == 30
    assert project.groups == ("tiles", "data", "stage", "data_tiles", "data_stage")


def test_hatches_declare_what_the_port_reads():
    from mpi4dl_tpu_torch.config import HATCHES

    assert "MPI4DL_FAULT_RANKS" in HATCHES
    for name in ("MPI4DL_NO_PACK", "MPI4DL_NO_PHASE_DX", "MPI4DL_NO_SCOPES",
                 "MPI4DL_1F1B_CELL_REMAT", "MPI4DL_LANE_PAD"):
        assert name not in HATCHES


def test_readme_port_hatch_table_in_sync():
    from mpi4dl_tpu.config import hatches_markdown as jax_table
    from mpi4dl_tpu_torch.config import hatches_markdown

    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    assert hatches_markdown() in readme, (
        "README's table of the port's hatches is out of sync with "
        "mpi4dl_tpu_torch/config.py; regenerate it with "
        "`python -m mpi4dl_tpu_torch.analysis --hatch-docs`")
    assert jax_table() in readme


def test_cli_exit_codes_json_and_list(tmp_path, capsys):
    bad = _write(tmp_path, "mpi4dl_tpu_torch/bad.py", CASES["group_missing"][2])
    good = _write(tmp_path, "mpi4dl_tpu_torch/good.py", CASES["group_given"][2])
    r = subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.analysis", "--json", str(bad)],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 1, r.stdout + r.stderr
    payload = json.loads(r.stdout)
    assert {v["rule"] for v in payload["violations"]} == {"collective-axis"}
    assert payload["files"] == 1 and len(payload["rules"]) == 11
    assert cli.main([str(good)]) == 0
    capsys.readouterr()
    assert cli.main(["--list-rules"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 11
    # The artifact gates dispatch as subcommands (usage errors exit 2; the
    # kernel certifier finds no ptxas report here); named after a flag, a
    # subcommand is a usage error of the source gate.
    for argv in (["--rule", "nope", str(good)], ["contracts", "--engines", "nope"],
                 ["--json", "ircheck"], ["ircheck", "--families", "nope"],
                 ["pallascheck"], [str(tmp_path / "missing.py")],
                 [str(tmp_path / "mpi4dl_tpu_torch" / "x")]):
        assert cli.main(argv) == 2, argv
    (tmp_path / "empty").mkdir()
    assert cli.main([str(tmp_path / "empty")]) == 2  # an empty scan is no pass


@pytest.mark.parametrize("case", ["group_missing", "unscoped", "tensor_at_import",
                                  "sync_in_autograd_function", "unregistered_library"])
def test_cli_fails_on_positive_fixtures(tmp_path, case):
    rule, filename, source, _ = CASES[case]
    f = _write(tmp_path, filename, source)
    assert cli.main(["--rule", rule, str(f)]) == 1


def test_sarif_and_baseline(tmp_path, capsys):
    bad = _write(tmp_path, "mpi4dl_tpu_torch/bad.py", CASES["print_in_library"][2])
    sarif = tmp_path / "out.sarif"
    assert cli.main([str(bad), "--sarif", str(sarif)]) == 1
    log = json.loads(sarif.read_text())
    assert log["version"] == "2.1.0"
    (res,) = log["runs"][0]["results"]
    assert res["ruleId"] == "print-call"
    assert res["locations"][0]["physicalLocation"]["region"]["startLine"] == 3
    assert log["runs"][0]["tool"]["driver"]["rules"][0]["id"] == "print-call"
    capsys.readouterr()
    assert cli.main([str(bad), "--json"]) == 1
    (v,) = json.loads(capsys.readouterr().out)["violations"]
    stale = {"rule": "print-call", "path": "gone.py", "message": "no longer fires"}
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps([{k: v[k] for k in ("rule", "path", "message")}, stale]))
    assert cli.main([str(bad), "--baseline", str(base), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["stale_baseline"] == [stale]
    assert cli.main(["--prune-baseline"]) == 2
    assert cli.main(["--prune-baseline", "--baseline", str(base), "--changed-only"]) == 2


def test_prune_pragmas_needs_the_whole_tree(tmp_path, capsys):
    f = _write(tmp_path, "mpi4dl_tpu_torch/fix.py", "x = 1\n")
    assert cli.main(["--prune-pragmas", str(f)]) == 2
    assert cli.main(["--prune-pragmas", "--rule", "print-call"]) == 2
    assert cli.main(["--prune-pragmas", "--changed-only"]) == 2


def test_changed_only_widens_on_ground_truth(monkeypatch, capsys):
    truth = os.path.join(ROOT, "mpi4dl_tpu_torch", "config.py")
    other = os.path.join(ROOT, "mpi4dl_tpu_torch", "ops", "ring.py")
    outside = os.path.join(ROOT, "mpi4dl_tpu", "config.py")
    assert cli.cross_file_ground_truth([truth, other]) == ["mpi4dl_tpu_torch/config.py"]
    for rel in cli.CROSS_FILE_GROUND_TRUTH:
        assert cli.cross_file_ground_truth([os.path.join(ROOT, rel)]) == [rel]
    assert cli.scope_filter([truth, outside], cli.default_paths(ROOT)) == [truth]

    scanned = []
    real = cli.build_project

    def spy(paths, root=None):
        scanned.append(list(paths))
        return real(paths, root=root)

    monkeypatch.setattr(cli, "build_project", spy)
    # a small "whole tree", so that the widened scan stays cheap
    monkeypatch.setattr(cli, "default_paths", lambda root: [truth, other])
    monkeypatch.setattr(cli, "changed_python_files", lambda root: [other, outside])
    assert cli.main(["--changed-only", "--rule", "print-call"]) == 0
    assert scanned[-1] == [other]
    monkeypatch.setattr(cli, "changed_python_files", lambda root: [other, truth])
    assert cli.main(["--changed-only", "--rule", "print-call"]) == 0
    assert scanned[-1] == [truth, other]
    assert "widening" in capsys.readouterr().err
    monkeypatch.setattr(cli, "changed_python_files", lambda root: [outside])
    assert cli.main(["--changed-only", "--rule", "print-call"]) == 0 and len(scanned) == 2


def test_analyzer_loads_no_jax_and_no_reference_package():
    code = ("import sys\n"
            "from mpi4dl_tpu_torch.analysis.__main__ import main\n"
            "rc = main(['--json', 'mpi4dl_tpu_torch/ops'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mpi4dl_tpu')]\n"
            "import torch\n"
            "print(rc, bad, torch.cuda.is_initialized(), file=sys.stderr)\n"
            "sys.exit(1 if rc or bad or torch.cuda.is_initialized() else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


# ---------------------------------------------------------------------------
# The kernel registry on the CPU, against the JAX package's kernels
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jax_of(t: torch.Tensor):
    return jnp.asarray(_np(t), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _jax_reference(case: kr.KernelCase, args):
    if case.kernel.startswith("halo_conv2d"):
        x, w = args
        kw = dict(fuse_relu=True, stat_window=(1, 23, 2, 38)) if "fused" in case.name else {}
        out = jpc.halo_conv2d(_jax_of(x), _jax_of(w), interpret=True, **kw)
        return out if isinstance(out, tuple) else (out,)
    q, k, v = args[:3]
    if case.kernel == "block_flash":
        _, _, _, q_off, k_off, causal, scale = args
        return jpa.block_flash(_jax_of(q), _jax_of(k), _jax_of(v), jnp.asarray(q_off, jnp.int32),
                               jnp.asarray(k_off, jnp.int32), causal, scale, 16, 128, True)
    _, _, _, _, do, dl, q_off, k_off, causal, scale = args

    def f(q, k, v):
        return jpa.block_flash(q, k, v, jnp.asarray(q_off, jnp.int32),
                               jnp.asarray(k_off, jnp.int32), causal, scale, 16, 128, True)

    state, vjp = jax.vjp(f, *(jnp.asarray(_np(t)) for t in (q, k, v)))
    return vjp((jnp.asarray(_np(do)), jnp.zeros_like(state[1]), jnp.asarray(_np(dl))))


@pytest.mark.parametrize("name", kr.case_names())
def test_registry_row_matches_the_jax_kernel(name):
    """Each row's CPU call (the plain version) against the JAX kernel in
    interpret mode on the same inputs: fp32 conv atol 2e-4 and <= 8 scaled
    ULP for the statistics (tests/test_pallas_conv.py), bf16 conv one bf16
    rounding of the largest output, K3 rtol/atol 1e-5, its backward rtol
    1e-4 / atol 1e-5·max|ref| (tests/test_pallas_attention.py)."""
    case = kr.registry_case(name)
    call, plain, args = case.build(torch.device("cpu"))
    tallies = (kr.hc.TALLY, kr.fa.TALLY)
    before = [{k: dict(v) for k, v in t.items()} for t in tallies]
    got = call(*args)
    assert [{k: dict(v) for k, v in t.items()} for t in tallies] == before  # no launch
    got = got if isinstance(got, tuple) else (got,)
    want = _jax_reference(case, args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = _np(g)
        assert g.shape == w.shape
        big = float(np.abs(w).max())
        if case.kernel.startswith("halo_conv2d"):
            if args[0].dtype == torch.bfloat16:
                np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -7 * big)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-4)
        elif case.kernel == "block_flash":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * big)
    assert case.run("cpu") == 0.0  # the call IS the plain version here


@pytest.mark.parametrize("name", kr.case_names())
def test_registry_check_rejects_a_wrong_result(name):
    case = kr.registry_case(name)
    _, plain, args = case.build(torch.device("cpu"))
    ref = plain(*args)
    ref_t = ref if isinstance(ref, tuple) else (ref,)
    bad = tuple(t.clone() for t in ref_t)
    flat = bad[0].view(-1)
    i = int(flat.float().abs().argmax())
    flat[i] = flat[i] * 1.5 + 1.0
    with pytest.raises(AssertionError):
        case.check(name, bad if isinstance(ref, tuple) else bad[0], ref)


def test_registry_enrolls_every_counted_kernel():
    from mpi4dl_tpu_torch.ops import flash_attention as fa
    from mpi4dl_tpu_torch.ops import halo_conv as hc

    assert set(kr.enrolled_kernels()) == set(hc.LAUNCHES) | set(fa.LAUNCHES)
    assert kr.case_names(["halo_conv2d"]) == tuple(
        n for n in kr.case_names() if n.startswith("halo_conv2d:"))
    with pytest.raises(KeyError):
        kr.registry_case("nope")
