"""The contract families' rank roles (counterpart of ``mpi4dl_tpu/analysis/
contracts/engines.py``).

The frozen builds are ``obs.families.family_flags``'s (ResNet v2 depth 11,
32², batch 4, 8 for ``gems_sp``, 2 stages, 2 micro-batches, the spatial
families on 2 vertical tiles; ``<family>_1f1b`` runs 1F1B), so the
contracts and the instruments' families cannot drift.  ``quant`` adds the
runners' ``--quant SPEC``.

:func:`run_role` runs one rank's training step of a family through the
runner's own ``_build`` (``benchmarks/common.py``), as
``benchmarks/mem_probe.probe_role(..., kernels="plain", real=True,
collectives=True)`` does, on real CPU tensors (seeded inputs) on the
``fake`` process group, under ``ircheck.watching``: its collective records,
the scope paths it opened, its inputs and its rank-local findings.  Real
tensors, not fake ones, because the async check compares storages.  No
step may branch on what the fake group leaves in a receive buffer (it
moves nothing); one that did would show as a contract that changes from
run to run.  :func:`extract_many` runs every rank of each family, one
process a family (its ranks one after another), several at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional

from mpi4dl_tpu_torch.obs.families import ENGINE_FAMILIES, family_flags

SEED = 0
FAMILY_TIMEOUT_S = 900


def role_config(family: str, quant: Optional[str] = None):
    """(runner family, config, mesh spec) of ``family``'s frozen build."""
    from mpi4dl_tpu_torch.benchmarks.mem_probe import mesh_spec
    from mpi4dl_tpu_torch.config import config_from_args, get_parser

    base, flags = family_flags(family)
    if quant:
        flags = flags + ["--quant", quant]
    cfg = config_from_args(get_parser().parse_args(flags))
    return base, cfg, mesh_spec(cfg, base)


def world_size(family: str) -> int:
    return role_config(family)[2].size


def _inject(spec: Optional[str]):
    """The context manager ``module:callable`` names (None: nothing)."""
    if not spec:
        return contextlib.nullcontext()
    mod, _, name = spec.partition(":")
    return getattr(importlib.import_module(mod), name)()


def run_role(family: str, rank: int, quant: Optional[str] = None,
             inject: Optional[str] = None) -> Dict[str, Any]:
    """Rank ``rank``'s recorded step of ``family`` in this process (module
    docstring).  ``inject``: ``module:callable`` of a context manager
    entered around the build and the step (the tests' seeded faults)."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from mpi4dl_tpu_torch.analysis.ircheck import watching
    from mpi4dl_tpu_torch.benchmarks.common import _build
    from mpi4dl_tpu_torch.mesh import build_process_mesh, group_tables
    from mpi4dl_tpu_torch.obs.comm_stats import group_dims
    from mpi4dl_tpu_torch.obs.hbm import named_tensors
    from mpi4dl_tpu_torch.quant import QuantPolicy

    base, cfg, spec = role_config(family, quant)
    tables = group_tables(spec)
    stripe = os.environ.get("MPI4DL_STRIPE_BWD")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=spec.size)
    try:
        with _inject(inject):
            mesh = build_process_mesh(spec)
            step, state, _, _ = _build(cfg, base, torch.device("cpu"), mesh,
                                       lambda *a, **k: None,
                                       QuantPolicy.resolve(cfg.quant_collectives))
            gen = torch.Generator().manual_seed(SEED)
            batch = cfg.batch_size * spec.data
            x = torch.randn((batch, cfg.image_size, cfg.image_size, 3), generator=gen)
            y = torch.randint(0, cfg.num_classes, (batch,), generator=gen)
            with watching(group_dims(tables)) as watch:
                step(state, x, y)
    finally:
        dist.destroy_process_group()
        if stripe is None:
            os.environ.pop("MPI4DL_STRIPE_BWD", None)
        else:
            os.environ["MPI4DL_STRIPE_BWD"] = stripe
    leaves = [t for _, t in named_tensors(state, "state")]
    own = [t for t in leaves if t.device.type != "meta"]
    return {
        "family": family, "rank": rank, "world": spec.size, "groups": tables,
        "records": watch.records, "scopes": watch.paths,
        "inputs": {
            "batch": [f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}" for t in (x, y)],
            "state": {"leaves": len(leaves), "own_leaves": len(own),
                      "own_bytes": sum(t.numel() * t.element_size() for t in own)},
        },
        "findings": [f.as_dict() for f in watch.findings(family, rank)],
        "wasted": watch.wasted(),
    }


def run_family(family: str, quant: Optional[str] = None,
               inject: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every rank role of ``family`` in this process, one after another
    (each joins and leaves its own ``fake`` group)."""
    return [run_role(family, r, quant, inject) for r in range(world_size(family))]


def _family_in_subprocess(family: str, quant: Optional[str],
                          inject: Optional[str]) -> List[Dict[str, Any]]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    with tempfile.TemporaryDirectory(prefix="mpi4dl_contract_roles_") as tmp:
        out = os.path.join(tmp, "roles.json")
        cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.analysis.contracts.engines",
               family, "--out", out]
        if quant:
            cmd += ["--quant", quant]
        if inject:
            cmd += ["--inject", inject]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       p for p in (root, os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=FAMILY_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"contract roles of {family} exit {proc.returncode}:\n"
                               f"{proc.stderr[-3000:]}")
        with open(out, encoding="utf-8") as fh:
            return json.load(fh)


def default_jobs() -> int:
    return max(1, min(8, (os.cpu_count() or 2) // 2))


def extract_roles(family: str, quant: Optional[str] = None, jobs: Optional[int] = None,
                  inject: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every rank role of ``family``, in rank order, run in a process of
    their own."""
    return extract_many([family], quant, jobs, inject)[family]


def extract_many(families: List[str], quant: Optional[str] = None,
                 jobs: Optional[int] = None, inject: Optional[str] = None
                 ) -> Dict[str, List[Dict[str, Any]]]:
    """The roles of several families, one process a family, ``jobs`` at a
    time (default: half the host's cores, at most 8)."""
    for f in families:
        if f not in ENGINE_FAMILIES:
            raise ValueError(f"unknown engine family {f!r}; have {ENGINE_FAMILIES}")
    with concurrent.futures.ThreadPoolExecutor(jobs or default_jobs()) as pool:
        futs = {f: pool.submit(_family_in_subprocess, f, quant, inject) for f in families}
        return {f: futs[f].result() for f in families}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.analysis.contracts.engines",
        description="Run every rank role of a contract family; write their JSON.")
    ap.add_argument("family", choices=ENGINE_FAMILIES)
    ap.add_argument("--quant", default=None)
    ap.add_argument("--inject", default=None, metavar="MODULE:CALLABLE")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    roles = run_family(args.family, args.quant, args.inject)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(roles, fh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
