"""Per-rank peak-memory probe of a runner's training step (counterpart of
``benchmarks/mem_probe.py``), without a card.

The JAX probe asks XLA for a compiled step's peak.  This one builds the
family's step with the runner's own ``_build`` (``benchmarks/common.py``)
under ``FakeTensorMode`` (tensors with shapes and no storage) and runs one
training step under ``torch.distributed._tools.mem_tracker.MemTracker``,
which follows every storage the step allocates and frees: the peak of the
live bytes, parameters, optimizer state and the input batch included.

- **Ranks.**  A job of N ranks is probed one rank role at a time, each in
  its own process as rank r of N on the ``fake`` process group
  (``torch.testing._internal.distributed.fake_pg``: collectives and
  point-to-point ops return at once and move nothing).  Each pipeline
  stage is a role; the tiles of a stage and the data replicas are
  symmetric, so the role of stage s is rank ``s · tiles``.  The result is
  the largest role's peak.
- **Kernels.**  The probe takes the card's path: inside
  ``halo_conv.fake_launches`` and ``flash_attention.fake_launches``, K1,
  K2 and K3 allocate what their launches allocate (outputs, K2's partial
  statistics) and not their plain versions' fp32 temporaries
  (``probe_role(..., kernels="plain")`` runs the plain versions, as on the
  CPU).
- **No card.**  Every tensor is a fake CPU tensor: the probe creates no
  CUDA context, so a supervisor can run it beside a live job.
- **What it leaves out.**  The CUDA caching allocator's rounding and
  fragmentation, cuBLAS/cuDNN workspaces and NCCL's buffers: the card's
  ``torch.cuda.max_memory_allocated`` counts the first two (NCCL's are
  outside it).

Family mode (``--family lp|gems|sp|gems_sp``; ``sp_pipeline`` is ``sp``)
writes one row per schedule; ``--schedule both`` is the gpipe-vs-1f1b
table, and ``--require-1f1b-win`` exits 1 unless 1F1B's peak is strictly
below GPipe's.  The single-device mode (``--family single``) probes the
one-card step.  Every other flag is the runners' (``config.get_parser``),
so that a probe builds what a leg with the same flags trains::

    python -m mpi4dl_tpu_torch.benchmarks.mem_probe --family lp \\
        --schedule both --require-1f1b-win --model amoebanet --image-size 1024 \\
        --batch-size 4 --split-size 4 --parts 4 --precision bf_16 \\
        --pallas-conv --no-remat --out probe.json

The JSON (printed, and written to ``--out``) carries
``schedules[<schedule>].peak_gb_est`` (GiB, the largest role's) with the
per-role bytes, plus ``win_1f1b_gb`` and ``table`` for ``both``;
``--telemetry-dir`` mirrors it into a RunLog ``mem_probe`` record
(``python -m mpi4dl_tpu_torch.obs report`` renders it).  The JAX probe's
attribution and overlap instruments (``--attribute``, ``--overlap``,
``--delta-parts``, ``--min-coverage``, ``--require-attrib-top``,
``--require-delta-top``, ``--sweep-junction`` and their companions) exit 2:
they wait for ROADMAP A15's second half (``obs/hbm``, ``overlap``,
``timeline``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

FAMILIES = ("single", "lp", "gems", "sp", "sp_pipeline", "gems_sp")

# The JAX probe's flags that need the A15 instruments (hbm attribution,
# the overlap ledger, the analytical timeline).
_LATER_FLAGS = ("--attribute", "--overlap", "--delta-parts", "--min-coverage",
                "--require-attrib-top", "--require-delta-top", "--require-delta-slope",
                "--require-hidden-frac", "--sweep-junction", "--junction-levels")


def mesh_spec(cfg, family: str):
    """The runner's mesh for ``family`` at ``cfg`` (``common.run``)."""
    from mpi4dl_tpu_torch.mesh import MeshSpec

    if family in ("single", "lp", "gems"):
        if family == "single":
            return MeshSpec()
        return MeshSpec(data=cfg.data_parallel, stage=max(cfg.split_size, 1))
    return MeshSpec.from_config(cfg)


def role_ranks(spec) -> List[int]:
    """One rank a pipeline stage (data replica 0, tile 0): rank ``s · tiles``
    of the runner's row-major ``(data, stage, sph, spw)`` layout."""
    return [s * spec.sph * spec.spw for s in range(spec.stage)]


def _tensors(obj) -> List[Any]:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    return []


def _peak_tracker():
    """``MemTracker``'s storage accounting (every storage an op returns,
    rounded as the caching allocator rounds it, freed when the storage
    dies) without its module tracking, which the probe does not read and
    which cannot follow the engines: its hooks refuse a module called twice
    in one step (a pipeline stage runs once a micro-batch), its backward
    hooks fail under ``autograd.grad``, and its per-module peaks walk every
    module at every op (minutes at AmoebaNet's full depth)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._python_dispatch import TorchDispatchMode

    class PeakTracker(MemTracker):
        def __enter__(self):
            from torch._guards import active_fake_mode

            self._fake_mode_on_entry = active_fake_mode()
            self._track_resize()
            self._peak_mem_snap = self.get_tracker_snapshot()
            self._peak_mem = {d: s["Total"] for d, s in self._peak_mem_snap.items()}
            TorchDispatchMode.__enter__(self)
            return self

        def __exit__(self, *args):
            self._restore_resize()
            TorchDispatchMode.__exit__(self, *args)

        def _update_peak_stats(self, peak_state) -> None:
            for dev, snap in self._curr_mem_snap.items():
                if self._peak_mem.get(dev, 0) < snap["Total"]:
                    self._peak_mem[dev] = snap["Total"]
                    self._peak_mem_snap[dev] = dict(snap)

    return PeakTracker()


@contextlib.contextmanager
def _fake_module_moves(mode):
    """Let ``Module.to`` move fake parameters.  Under ``FakeTensorMode`` it
    swaps each parameter with its moved copy (``torch.utils.swap_tensors``),
    which refuses a tensor that a weak reference points to, and the mode's
    converter memoizes every fake ``Parameter`` through one.  The memo
    caches real-to-fake conversions, which the probe never repeats: it is
    cleared before each swap."""
    import torch

    swap = torch.utils.swap_tensors
    memo = mode.fake_tensor_converter.meta_converter.tensor_memo

    def cleared_swap(t1, t2):
        memo.clear()
        return swap(t1, t2)

    torch.utils.swap_tensors = cleared_swap
    try:
        yield
    finally:
        torch.utils.swap_tensors = swap


def probe_role(cfg, family: str, rank: int = 0, kernels: str = "card",
               real: bool = False) -> Dict[str, Any]:
    """Peak bytes of one training step of ``family`` at ``cfg`` on rank
    ``rank`` of the runner's mesh, in this process: ``{"rank", "peak_bytes",
    "by_category"}``.  Ranks > 1 join the ``fake`` process group for the
    call.  ``real=True`` runs the same step on real CPU tensors (the test's
    reference for the fake run; ``kernels`` must then be "plain")."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mpi4dl_tpu_torch.benchmarks.common import _build
    from mpi4dl_tpu_torch.mesh import build_process_mesh
    from mpi4dl_tpu_torch.ops import flash_attention, halo_conv
    from mpi4dl_tpu_torch.quant import QuantPolicy

    if real and kernels != "plain":
        raise ValueError("a real CPU step runs the plain versions: kernels='plain'")
    spec = mesh_spec(cfg, family)
    if family in ("sp", "gems_sp") and spec.sph * spec.spw < 2:
        raise ValueError(f"the {family} runner needs --num-spatial-parts > 1, as "
                         "benchmarks/common.run does")
    world = spec.size
    dev = torch.device("cpu")
    stripe = os.environ.get("MPI4DL_STRIPE_BWD")
    if world > 1:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        with contextlib.ExitStack() as stack:
            if not real:
                stack.enter_context(_fake_module_moves(stack.enter_context(FakeTensorMode())))
            if kernels == "card":
                stack.enter_context(halo_conv.fake_launches())
                stack.enter_context(flash_attention.fake_launches())
            mesh = build_process_mesh(spec) if world > 1 else None
            step, state, _, _ = _build(cfg, "lp" if family == "single" else family, dev,
                                       mesh, lambda *a, **k: None,
                                       QuantPolicy.resolve(cfg.quant_collectives))
            batch = cfg.batch_size * spec.data
            x = torch.zeros((batch, cfg.image_size, cfg.image_size, 3), dtype=torch.float32)
            y = torch.zeros((batch,), dtype=torch.int64)
            tracker = _peak_tracker()
            tracker.track_external(*_tensors(state), x, y)
            with tracker:
                step(state, x, y)
            snap = tracker.get_tracker_snapshot("peak")
    finally:
        if world > 1:
            dist.destroy_process_group()
        if stripe is None:
            os.environ.pop("MPI4DL_STRIPE_BWD", None)
        else:
            os.environ["MPI4DL_STRIPE_BWD"] = stripe
    # The CPU's bytes only: the stages another rank holds live on the meta
    # device (``release_others``), which the tracker counts apart.
    cats = snap.get(dev, {})
    return {"rank": rank,
            "peak_bytes": int(cats.get("Total", 0)),
            "by_category": {str(getattr(k, "value", k)): int(v) for k, v in cats.items()
                            if k != "Total"}}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.benchmarks.mem_probe",
        description="per-rank peak memory of a runner's step, on fake tensors "
                    "(every other flag is the runners')")
    p.add_argument("--family", default="single", choices=FAMILIES)
    p.add_argument("--schedule", default="both", choices=["gpipe", "1f1b", "both"])
    p.add_argument("--require-1f1b-win", action="store_true",
                   help="exit 1 unless 1f1b's peak < gpipe's (needs --schedule both)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--telemetry-dir", default=None,
                   help="mirror the result into a RunLog mem_probe record")
    p.add_argument("--role", type=int, default=None, help=argparse.SUPPRESS)
    return p


def _runner_cfg(rest: List[str], schedule: str):
    from mpi4dl_tpu_torch.config import config_from_args, get_parser

    extra = ["--schedule", schedule] if schedule in ("gpipe", "1f1b") else []
    return config_from_args(get_parser().parse_args(list(rest) + extra))


def _role_in_subprocess(argv: List[str], schedule: str, rank: int) -> Dict[str, Any]:
    """One role in its own process (the fake process group is per
    process); its JSON line back."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "mpi4dl_tpu_torch.benchmarks.mem_probe", *argv,
           "--schedule", schedule, "--role", str(rank)]
    env = {k: v for k, v in os.environ.items() if k != "MPI4DL_FAULT"}
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"probe of rank {rank} ({schedule}) failed, rc "
                           f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def probe_family(argv: List[str], args, rest: List[str]) -> Dict[str, Any]:
    """Every schedule's row: each rank role probed in a process of its own
    (here for a one-rank job) and the largest role's peak."""
    family = "sp" if args.family == "sp_pipeline" else args.family
    schedules = ["gpipe", "1f1b"] if args.schedule == "both" else [args.schedule]
    cfg = _runner_cfg(rest, schedules[0])
    spec = mesh_spec(cfg, family)
    jobs = [(s, r) for s in schedules for r in role_ranks(spec)]
    t0 = time.perf_counter()
    if spec.size > 1:
        with concurrent.futures.ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as ex:
            got = list(ex.map(lambda j: _role_in_subprocess(argv, *j), jobs))
    else:
        got = [probe_role(_runner_cfg(rest, s), family, r) for s, r in jobs]
    rows: Dict[str, Any] = {}
    for (s, _), role in zip(jobs, got):
        row = rows.setdefault(s, {"roles": []})
        row["roles"].append(role)
    for s, row in rows.items():
        peak = max(r["peak_bytes"] for r in row["roles"])
        row.update(peak_bytes=peak, peak_gb_est=round(peak / 2**30, 3))
        print(f"[mem_probe] {family}/{s}: {row['peak_gb_est']} GiB peak "
              f"(largest of {len(row['roles'])} rank role(s))", file=sys.stderr)
    out = {"metric": "mem_probe_peak_gb", "family": family, "mesh": str(spec),
           "ranks": spec.size, "config": dataclasses.asdict(cfg), "schedules": rows,
           "probe_s": round(time.perf_counter() - t0, 3)}
    if len(rows) == 2:
        # From the bytes: a small model's win rounds to 0.000 GiB.
        win = rows["gpipe"]["peak_bytes"] - rows["1f1b"]["peak_bytes"]
        out["win_1f1b_bytes"] = win
        out["win_1f1b_gb"] = win / 2**30
        out["table"] = (f"schedule  peak_gb\ngpipe     {rows['gpipe']['peak_gb_est']}\n"
                        f"1f1b      {rows['1f1b']['peak_gb_est']}\n"
                        f"1f1b win  {round(win / 2**30, 3)} GB ({win} bytes)")
    return out


def probe_single(rest: List[str]) -> Dict[str, Any]:
    """The one-card step's row (the JAX probe's single-device mode)."""
    cfg = _runner_cfg(rest, "")
    t0 = time.perf_counter()
    role = probe_role(cfg, "single")
    return {"config": dataclasses.asdict(cfg), "peak_bytes": role["peak_bytes"],
            "peak_gb_est": round(role["peak_bytes"] / 2**30, 3),
            "by_category": role["by_category"],
            "probe_s": round(time.perf_counter() - t0, 3)}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    later = [f for f in _LATER_FLAGS if any(a == f or a.startswith(f + "=") for a in argv)]
    if later:
        print(f"[mem_probe] {', '.join(later)}: the probe's attribution and overlap "
              "instruments are not ported yet (ROADMAP A15, second half: obs/hbm, "
              "overlap, timeline)", file=sys.stderr)
        return 2
    args, rest = _parser().parse_known_args(argv)
    family = "sp" if args.family == "sp_pipeline" else args.family
    if args.role is not None:
        cfg = _runner_cfg(rest, args.schedule)
        print(json.dumps(probe_role(cfg, family, args.role)))
        return 0
    if args.require_1f1b_win and (args.schedule != "both" or family == "single"):
        print("[mem_probe] --require-1f1b-win needs --schedule both and an engine "
              "family", file=sys.stderr)
        return 2
    # The roles' argv: this one without the schedule (each role gets its own).
    role_argv = list(argv)
    if "--schedule" in role_argv:
        i = role_argv.index("--schedule")
        del role_argv[i:i + 2]
    out = probe_single(rest) if family == "single" else probe_family(
        role_argv, args, rest)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    if args.telemetry_dir:
        from mpi4dl_tpu_torch.obs import RunLog

        runlog = RunLog.create(args.telemetry_dir, prefix="mem_probe")
        runlog.write_meta(config=out.get("config"), family=family, argv=argv)
        runlog.write("mem_probe", **out)
        runlog.close()
        print(f"[mem_probe] telemetry written to {runlog.path}", file=sys.stderr)
    if args.require_1f1b_win:
        win = out.get("win_1f1b_gb")
        if win is None or win <= 0:
            print(f"[mem_probe] FAIL: 1f1b does not win (win_1f1b_gb={win})",
                  file=sys.stderr)
            return 1
        print(f"[mem_probe] OK: 1f1b wins by {win} GB", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
