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
(``python -m mpi4dl_tpu_torch.obs report`` renders it).

The JAX probe's instruments, with its flags and gates
(``benchmarks/mem_probe.py:562-610`` of the JAX package):

- ``--attribute``: each probed role's step also runs under
  ``obs.costs.counting`` and the tracker attributes the bytes live at its
  peak by ``obs.scope`` path (``obs/hbm.py``); each row carries its largest
  role's ``hbm`` breakdown and analytical ``timeline`` (``obs/timeline.py``)
  and the telemetry gets ``hbm`` and ``timeline`` records.  Gates:
  ``--min-coverage``, ``--require-attrib-top``.
- ``--overlap``: the exposed-wire ledger (``obs/overlap.py``) of the
  collectives the fake step recorded (``obs/comm_stats.py``): on the CPU
  every transfer is sync, so the ledger reads 100% exposed, as the JAX
  probe's CPU backend does; ``--require-hidden-frac`` (rows that move no
  bytes pass).
- ``--delta-parts N`` with ``--require-delta-top`` and
  ``--require-delta-slope``: the family probed again at ``--parts N`` (the
  micro-batch held) and the per-scope growth (``parts_delta``).
- ``--sweep-junction`` with ``--junction-levels``: the ``sp`` family probed
  at each ``--spatial-until`` (one probe a placement), the
  ``junction_sweep`` frontier.
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
               real: bool = False, instruments: bool = False,
               collectives: bool = False, levels=None) -> Dict[str, Any]:
    """Peak bytes of one training step of ``family`` at ``cfg`` on rank
    ``rank`` of the runner's mesh, in this process: ``{"rank", "peak_bytes",
    "by_category"}``.  Ranks > 1 join the ``fake`` process group for the
    call.  ``real=True`` runs the same step on real CPU tensors (the test's
    reference for the fake run; ``kernels`` must then be "plain").
    ``instruments``: the step also runs under ``obs.costs.counting`` (FLOPs
    by scope, the recorded collectives) with the tracker attributing its
    peak by scope, and the role adds ``hbm``, ``timeline``, ``overlap``,
    ``collectives`` and ``collective_records`` (:func:`instrument_role`).
    ``collectives`` alone records the step's collectives and adds
    ``collectives`` (per class) and ``collective_scopes`` (per scope path).
    ``levels``: the spatial chain in place of the runner's (``_build``)."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mpi4dl_tpu_torch.benchmarks.common import _build
    from mpi4dl_tpu_torch.mesh import build_process_mesh
    from mpi4dl_tpu_torch.obs.comm_stats import (
        collective_stats, recording_collectives, scope_collectives,
    )
    from mpi4dl_tpu_torch.obs.costs import counting
    from mpi4dl_tpu_torch.obs.hbm import named_tensors, peak_tracker
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
                                       QuantPolicy.resolve(cfg.quant_collectives), levels)
            batch = cfg.batch_size * spec.data
            x = torch.zeros((batch, cfg.image_size, cfg.image_size, 3), dtype=torch.float32)
            y = torch.zeros((batch,), dtype=torch.int64)
            tracker = peak_tracker(attribute=instruments)
            tracker.label_external(named_tensors(state, "state") + [("x", x), ("y", y)])
            with contextlib.ExitStack() as inner:
                cost = inner.enter_context(counting()) if instruments else None
                records = (inner.enter_context(recording_collectives())
                           if collectives and not instruments else None)
                inner.enter_context(tracker)
                step(state, x, y)
            snap = tracker.get_tracker_snapshot("peak")
            breakdown = tracker.breakdown(dev) if instruments else None
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
    out = {"rank": rank,
           "peak_bytes": int(cats.get("Total", 0)),
           "by_category": {str(getattr(k, "value", k)): int(v) for k, v in cats.items()
                           if k != "Total"}}
    if instruments:
        out.update(instrument_role(cfg, family, breakdown, cost, out["peak_bytes"]))
        records = cost["collective_records"]
    if collectives:
        out.update(collectives=collective_stats(records),
                   collective_scopes=scope_collectives(records))
    return out


def card_attribution(cfg, family: str, dev, mesh=None, seed: int = 0) -> Dict[str, Any]:
    """The same attribution as a probed role's, of one step of ``family`` at
    ``cfg`` run for real on ``dev`` (a card: the kernels launch, tensors are
    real): ``hbm``, the breakdown of the tracker's peak (``obs/hbm.py``,
    512-byte rounding as the caching allocator rounds) held against the
    card's ``torch.cuda.max_memory_allocated`` of the step (``reconcile``),
    and ``cost``, the step's ``obs.costs.counting`` (FLOPs by scope, the
    recorded collectives).  ``mesh``: the runner's process mesh on ranks."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.common import _build
    from mpi4dl_tpu_torch.obs.costs import counting
    from mpi4dl_tpu_torch.obs.hbm import named_tensors, peak_tracker, reconcile
    from mpi4dl_tpu_torch.quant import QuantPolicy

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    spec = mesh_spec(cfg, family)
    step, state, _, _ = _build(cfg, "lp" if family == "single" else family, dev, mesh,
                               lambda *a, **k: None, QuantPolicy.resolve(cfg.quant_collectives))
    batch = cfg.batch_size * spec.data
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((batch, cfg.image_size, cfg.image_size, 3), generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (batch,), generator=gen, device=dev)
    tracker = peak_tracker(attribute=True)
    tracker.label_external(named_tensors(state, "state") + [("x", x), ("y", y)])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with counting() as cost, tracker:
        step(state, x, y)
    torch.cuda.synchronize(dev)
    actual = torch.cuda.max_memory_allocated(dev)
    bd = tracker.breakdown(dev)
    del step, state, tracker
    if cost["error"] is not None:
        raise RuntimeError(f"the step's counting failed: {cost['error']}")
    return {"hbm": reconcile(bd, actual, "max_memory_allocated"), "cost": cost}


def instrument_role(cfg, family: str, breakdown: dict, cost: dict, peak: int
                    ) -> Dict[str, Any]:
    """The instruments of one probed role: ``hbm`` (the breakdown, held
    against the tracker's own peak), the analytical ``timeline`` and the
    CPU ``overlap`` ledger of its recorded collectives (every transfer sync:
    ``obs/overlap.ledger_from_records``), at the CPU's nominal rates as the
    JAX probe's virtual mesh has them."""
    import torch

    from mpi4dl_tpu_torch.obs.comm_stats import scope_collectives
    from mpi4dl_tpu_torch.obs.costs import ici_bytes_per_s, peak_flops
    from mpi4dl_tpu_torch.obs.hbm import reconcile
    from mpi4dl_tpu_torch.obs.overlap import ledger_from_records
    from mpi4dl_tpu_torch.obs.timeline import analytical_timeline

    if cost["error"] is not None:
        raise RuntimeError(f"the probed step's counting failed: {cost['error']}")
    fpeak, fsrc = peak_flops(torch.device("cpu"), allow_cpu_nominal=True)
    ici, isrc = ici_bytes_per_s(None)
    records = cost["collective_records"]
    ledger = ledger_from_records(records, compute_ms=cost["flops"] / fpeak * 1e3,
                                 ici_bw=ici, ici_source=isrc, peak=fpeak, peak_source=fsrc)
    piped = family != "single" and cfg.split_size > 1
    timeline = analytical_timeline(
        cost["by_scope"], scope_collectives(records), peak=fpeak, peak_source=fsrc,
        ici_bw=ici, ici_source=isrc, ledger=ledger,
        schedule=cfg.schedule if piped else None, stages=cfg.split_size if piped else None,
        parts=cfg.parts if piped else None)
    return {"hbm": reconcile(breakdown, peak, "tracker"), "timeline": timeline,
            "overlap": ledger, "collectives": cost["collectives"],
            "collective_records": records}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpi4dl_tpu_torch.benchmarks.mem_probe",
        description="per-rank peak memory of a runner's step, on fake tensors "
                    "(every other flag is the runners')")
    p.add_argument("--family", default="single", choices=FAMILIES)
    p.add_argument("--schedule", default="both", choices=["gpipe", "1f1b", "both"])
    p.add_argument("--require-1f1b-win", action="store_true",
                   help="exit 1 unless 1f1b's peak < gpipe's (needs --schedule both)")
    p.add_argument("--attribute", action="store_true",
                   help="add the per-obs.scope breakdown of the peak bytes and the "
                        "analytical timeline to every probed row")
    p.add_argument("--overlap", action="store_true",
                   help="add the exposed-wire ledger of the recorded collectives "
                        "to every probed row")
    p.add_argument("--require-hidden-frac", type=float, default=None, metavar="FRAC",
                   help="with --overlap: exit 1 when less than this fraction of "
                        "wire time is hidden on any probed row (rows that move "
                        "no collective bytes pass)")
    p.add_argument("--min-coverage", type=float, default=None,
                   help="with --attribute: exit 1 when less than this fraction of "
                        "peak bytes attributes to named scopes")
    p.add_argument("--require-attrib-top", default=None,
                   help="with --attribute: exit 1 unless the plurality scope group "
                        "at peak starts with one of these comma-separated prefixes")
    p.add_argument("--delta-parts", type=int, default=None,
                   help="with --attribute in family mode: probe again at this part "
                        "count (micro-batch held fixed) and emit the per-scope "
                        "O(parts) growth ledger")
    p.add_argument("--require-delta-top", default=None,
                   help="with --delta-parts: exit 1 unless the phase group with "
                        "the largest positive per-part growth starts with one of "
                        "these comma-separated prefixes")
    p.add_argument("--require-delta-slope", type=float, default=None, metavar="GB",
                   help="with --delta-parts: exit 1 when the per-part peak slope "
                        "exceeds this many GiB/part on any probed schedule")
    p.add_argument("--sweep-junction", action="store_true",
                   help="probe the sp family at each junction placement "
                        "(--spatial-until) and emit the placement frontier")
    p.add_argument("--junction-levels", default=None,
                   help="comma-separated --spatial-until candidates for "
                        "--sweep-junction (default: every legal placement)")
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


_INSTRUMENT_KEYS = ("hbm", "timeline", "overlap", "collectives")


def probe_family(argv: List[str], args, rest: List[str]) -> Dict[str, Any]:
    """Every schedule's row: each rank role probed in a process of its own
    (here for a one-rank job) and the largest role's peak.  With the
    instruments on, the row carries the largest role's ``hbm``,
    ``timeline``, ``overlap`` and ``collectives``."""
    family = "sp" if args.family == "sp_pipeline" else args.family
    schedules = ["gpipe", "1f1b"] if args.schedule == "both" else [args.schedule]
    cfg = _runner_cfg(rest, schedules[0])
    spec = mesh_spec(cfg, family)
    instruments = _instruments(args)
    jobs = [(s, r) for s in schedules for r in role_ranks(spec)]
    t0 = time.perf_counter()
    if spec.size > 1 and len(jobs) > 1:
        with concurrent.futures.ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as ex:
            got = list(ex.map(lambda j: _role_in_subprocess(argv, *j), jobs))
    elif spec.size > 1:
        got = [_role_in_subprocess(argv, *jobs[0])]
    else:
        got = [probe_role(_runner_cfg(rest, s), family, r, instruments=instruments)
               for s, r in jobs]
    rows: Dict[str, Any] = {}
    for (s, _), role in zip(jobs, got):
        row = rows.setdefault(s, {"roles": []})
        row["roles"].append(role)
    for s, row in rows.items():
        top = max(row["roles"], key=lambda r: r["peak_bytes"])
        peak = top["peak_bytes"]
        row.update(peak_bytes=peak, peak_gb_est=round(peak / 2**30, 3))
        for key in _INSTRUMENT_KEYS:
            if key in top:
                row[key] = top[key]
        for role in row["roles"]:
            role.pop("collective_records", None)
        print(f"[mem_probe] {family}/{s}: {row['peak_gb_est']} GiB peak "
              f"(largest of {len(row['roles'])} rank role(s))", file=sys.stderr)
        _print_instruments(f"{family}/{s}", row)
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


def _instruments(args) -> bool:
    return bool(args.attribute or args.overlap)


def _print_instruments(label: str, row: Dict[str, Any]) -> None:
    from mpi4dl_tpu_torch.obs.hbm import format_breakdown
    from mpi4dl_tpu_torch.obs.overlap import format_ledger

    if row.get("hbm") is not None:
        print(f"[mem_probe] {label} attribution:\n{format_breakdown(row['hbm'])}",
              file=sys.stderr)
    if row.get("overlap") is not None:
        print(f"[mem_probe] {label} wire:\n{format_ledger(row['overlap'])}",
              file=sys.stderr)


def probe_single(rest: List[str], args=None) -> Dict[str, Any]:
    """The one-card step's row (the JAX probe's single-device mode)."""
    cfg = _runner_cfg(rest, "")
    t0 = time.perf_counter()
    role = probe_role(cfg, "single", instruments=args is not None and _instruments(args))
    out = {"config": dataclasses.asdict(cfg), "peak_bytes": role["peak_bytes"],
           "peak_gb_est": round(role["peak_bytes"] / 2**30, 3),
           "by_category": role["by_category"],
           "probe_s": round(time.perf_counter() - t0, 3)}
    out.update({k: role[k] for k in _INSTRUMENT_KEYS if k in role})
    _print_instruments("single", out)
    return out


def _with_flag(rest: List[str], flag: str, value) -> List[str]:
    """``rest`` with ``flag`` set to ``value`` (replaced where present)."""
    out, skip = [], False
    for i, a in enumerate(rest):
        if skip:
            skip = False
            continue
        if a == flag:
            skip = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out + [flag, str(value)]


def _strip_flags(argv: List[str], flags) -> List[str]:
    """``argv`` without ``flags`` (and the values of those that take one)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = a not in _SWITCHES
        elif not any(a.startswith(f + "=") for f in flags):
            out.append(a)
    return out


def parts_delta(args, out: Dict[str, Any], role_argv: List[str], rest: List[str]) -> dict:
    """Probe the family again at ``--delta-parts`` (the same micro-batch)
    and the per-scope growth between the two (the JAX probe's
    ``_parts_delta``)."""
    from mpi4dl_tpu_torch.obs.hbm import compare_breakdowns, growth_groups, top_growth_group

    cfg = _runner_cfg(rest, "")
    micro = max(cfg.batch_size // cfg.parts, 1)
    change = [("--parts", args.delta_parts), ("--batch-size", micro * args.delta_parts)]
    rest_b, argv_b = list(rest), list(role_argv)
    for flag, value in change:
        rest_b, argv_b = _with_flag(rest_b, flag, value), _with_flag(argv_b, flag, value)
    out_b = probe_family(argv_b, args, rest_b)
    delta = {"parts_a": cfg.parts, "parts_b": args.delta_parts, "micro_batch": micro,
             "per_schedule": {}}
    dparts = args.delta_parts - cfg.parts
    for sched, row in out["schedules"].items():
        row_b = out_b["schedules"].get(sched)
        if not (row.get("hbm") and row_b and row_b.get("hbm")):
            continue
        growth = growth_groups(row["hbm"], row_b["hbm"], cfg.parts, args.delta_parts)
        delta["per_schedule"][sched] = {
            "growth_bytes_per_part": growth,
            "top_growth_group": top_growth_group(growth),
            "peak_delta_bytes": compare_breakdowns(row["hbm"], row_b["hbm"])["peak_delta_bytes"],
            "peak_slope_gb_per_part": round(
                (row_b["peak_bytes"] - row["peak_bytes"]) / 2**30 / dparts, 3),
        }
        print(f"[mem_probe] {out['family']}/{sched} growth parts {cfg.parts}->"
              f"{args.delta_parts} (bytes/part):", file=sys.stderr)
        for k, v in list(growth.items())[:8]:
            print(f"  {v / 2**20:>10.1f} MB/part  {k}", file=sys.stderr)
    return delta


def sweep_junction(args, role_argv: List[str], rest: List[str]) -> Dict[str, Any]:
    """The junction-placement frontier: the ``sp`` family probed at each
    ``--spatial-until`` (one probe a placement)."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.common import build_model

    cfg = _runner_cfg(rest, "")
    n_cells = len(build_model(cfg, device=torch.device("meta")).cells)
    if args.junction_levels:
        asked = [int(v) for v in args.junction_levels.split(",")]
        levels = [su for su in asked if 1 <= su <= n_cells - 1]
        if levels != asked:
            print(f"[mem_probe] note: junction levels {asked} clamped to legal "
                  f"placements {levels} ({n_cells}-cell model)", file=sys.stderr)
        if not levels:
            raise ValueError(f"no legal junction level in {asked}")
    else:
        levels = list(range(1, n_cells - 1))
    # One schedule, as the JAX sweep compiles (gpipe for "both").
    sched_args = argparse.Namespace(**{
        **vars(args), "family": "sp",
        "schedule": "gpipe" if args.schedule == "both" else args.schedule})
    placements = []
    for su in levels:
        got = probe_family(_with_flag(role_argv, "--spatial-until", su), sched_args,
                           _with_flag(rest, "--spatial-until", su))
        row = next(iter(got["schedules"].values()))
        entry = {"spatial_until": su, "spatial_cells": su, "tail_cells": n_cells - su,
                 "peak_bytes": row["peak_bytes"], "peak_gb_est": row["peak_gb_est"]}
        entry.update({k: row[k] for k in _INSTRUMENT_KEYS if k in row})
        placements.append(entry)
        print(f"[mem_probe] sweep spatial_until={su}: {row['peak_gb_est']} GiB peak",
              file=sys.stderr)
    best = min(placements, key=lambda p_: p_["peak_bytes"])
    for p_ in placements:
        p_["best"] = p_ is best
    naive = max(placements, key=lambda p_: p_["spatial_until"])
    return {
        "metric": "junction_frontier_peak_gb", "value": best["peak_gb_est"],
        "unit": "GB/device", "family": "sp", "config": dataclasses.asdict(cfg),
        "placements": placements,
        "best": {k: best[k] for k in ("spatial_until", "peak_gb_est")},
        "naive": {k: naive[k] for k in ("spatial_until", "peak_gb_est")},
        "naive_over_best": (round(naive["peak_bytes"] / best["peak_bytes"], 3)
                            if best["peak_bytes"] else None),
    }


def _prefixes(spec: str):
    return tuple(v.strip() for v in spec.split(",") if v.strip())


def _check_gates(args, rows) -> int:
    """--min-coverage / --require-attrib-top / --require-hidden-frac over the
    gate rows; the number of failures (each reported on stderr)."""
    from mpi4dl_tpu_torch.obs.hbm import scope_group_bytes, top_group

    failures = 0
    for label, row in rows:
        bd = row.get("hbm")
        if bd is not None and args.min_coverage is not None and \
                bd["coverage"] < args.min_coverage:
            print(f"[mem_probe] FAIL {label}: coverage {bd['coverage']:.3f} "
                  f"< --min-coverage {args.min_coverage}", file=sys.stderr)
            failures += 1
        if bd is not None and args.require_attrib_top:
            prefixes, phase = _prefixes(args.require_attrib_top), top_group(bd)
            if phase is None or not any(phase.startswith(p_) for p_ in prefixes):
                groups = scope_group_bytes(bd)
                print(f"[mem_probe] FAIL {label}: plurality scope group {phase!r} does "
                      f"not match --require-attrib-top {prefixes} (groups: "
                      f"{ {k: v for k, v in list(groups.items())[:4]} })", file=sys.stderr)
                failures += 1
            else:
                print(f"[mem_probe] OK {label}: plurality scope group {phase!r} owns "
                      f"{scope_group_bytes(bd)[phase]} bytes at peak", file=sys.stderr)
        led = row.get("overlap")
        if args.require_hidden_frac is not None and led is not None \
                and led.get("hidden_frac") is not None:
            hf = led["hidden_frac"]
            if hf < args.require_hidden_frac:
                t = led["totals"]
                print(f"[mem_probe] FAIL {label}: hidden wire fraction {hf:.3f} < "
                      f"--require-hidden-frac {args.require_hidden_frac} (exposed "
                      f"{t['exposed_ms']} ms of {t['wire_ms']} ms wire; sync "
                      f"collectives {t['sync']})", file=sys.stderr)
                failures += 1
            else:
                print(f"[mem_probe] OK {label}: hidden wire fraction {hf:.3f}",
                      file=sys.stderr)
    return failures


def _check_delta(args, out: Dict[str, Any]) -> int:
    """--require-delta-top / --require-delta-slope; the number of failures."""
    rows = (out.get("parts_delta") or {}).get("per_schedule") or {}
    fails = 0
    if (args.require_delta_top or args.require_delta_slope is not None) and not rows:
        print("[mem_probe] FAIL: no parts-delta rows", file=sys.stderr)
        return 1
    for sched, d in rows.items():
        if args.require_delta_top:
            prefixes, topg = _prefixes(args.require_delta_top), d["top_growth_group"]
            if topg is None or not any(topg.startswith(p_) for p_ in prefixes):
                print(f"[mem_probe] FAIL {out['family']}/{sched}: top O(parts) growth "
                      f"group {topg!r} does not match --require-delta-top {prefixes}",
                      file=sys.stderr)
                fails += 1
            else:
                print(f"[mem_probe] OK {out['family']}/{sched}: O(parts) memory lives in "
                      f"{topg!r} ({d['growth_bytes_per_part'][topg] / 2**30:.3f} "
                      "GB/device/part)", file=sys.stderr)
        if args.require_delta_slope is not None:
            slope = d["peak_slope_gb_per_part"]
            ok = slope <= args.require_delta_slope
            print(f"[mem_probe] {'OK' if ok else 'FAIL'} {out['family']}/{sched}: "
                  f"per-part peak slope {slope} GB/part "
                  f"{'<=' if ok else 'exceeds --require-delta-slope'} "
                  f"{args.require_delta_slope}", file=sys.stderr)
            fails += 0 if ok else 1
    return fails


def _usage_error(args, family: str) -> Optional[str]:
    if args.require_1f1b_win and (args.schedule != "both" or family == "single"):
        return "--require-1f1b-win needs --schedule both and an engine family"
    if args.delta_parts is not None and (args.sweep_junction or family == "single"):
        return ("--delta-parts needs an engine family (--family lp|gems|sp|gems_sp, "
                "no --sweep-junction)")
    if not args.attribute and (args.min_coverage is not None or args.require_attrib_top
                               or args.delta_parts is not None or args.require_delta_top
                               or args.require_delta_slope is not None):
        return ("--min-coverage/--require-attrib-top/--delta-parts/--require-delta-top/"
                "--require-delta-slope need --attribute")
    if args.require_delta_slope is not None and args.delta_parts is None:
        return "--require-delta-slope needs --delta-parts"
    if args.require_hidden_frac is not None and not args.overlap:
        return "--require-hidden-frac needs --overlap"
    if args.sweep_junction and family not in ("sp",):
        return "--sweep-junction probes the sp family (--family sp)"
    return None


_SWITCHES = ("--sweep-junction", "--require-1f1b-win")
_TOOL_FLAGS = ("--schedule", "--out", "--telemetry-dir", "--delta-parts",
               "--require-delta-top", "--require-delta-slope", "--sweep-junction",
               "--junction-levels", "--require-attrib-top", "--min-coverage",
               "--require-hidden-frac", "--require-1f1b-win")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args, rest = _parser().parse_known_args(argv)
    family = "sp" if args.family == "sp_pipeline" else args.family
    if args.role is not None:
        cfg = _runner_cfg(rest, args.schedule)
        print(json.dumps(probe_role(cfg, family, args.role, instruments=_instruments(args))))
        return 0
    err = _usage_error(args, family)
    if err:
        print(f"[mem_probe] {err}", file=sys.stderr)
        return 2
    # The roles' argv: the family, the instruments and the runner's flags.
    role_argv = _strip_flags(argv, _TOOL_FLAGS)
    if args.sweep_junction:
        out = sweep_junction(args, role_argv, rest)
        gate_rows = [(f"su={p_['spatial_until']}", p_) for p_ in out["placements"]]
    elif family == "single":
        out = probe_single(rest, args)
        gate_rows = [("single", out)]
    else:
        out = probe_family(role_argv, args, rest)
        gate_rows = [(f"{family}/{s}", r) for s, r in out["schedules"].items()]
        if args.delta_parts is not None:
            out["parts_delta"] = parts_delta(args, out, role_argv, rest)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    if args.telemetry_dir:
        from mpi4dl_tpu_torch.obs import RunLog

        runlog = RunLog.create(args.telemetry_dir, prefix="mem_probe")
        runlog.write_meta(config=out.get("config"), family=family, argv=argv)
        if args.sweep_junction:
            runlog.write("junction_sweep", placements=out["placements"], best=out["best"],
                         naive=out["naive"], naive_over_best=out["naive_over_best"])
        else:
            runlog.write("mem_probe", **out)
        for label, row in gate_rows:
            if row.get("hbm") is not None:
                runlog.write("hbm", label=label, breakdown=row["hbm"])
            if row.get("timeline") is not None:
                runlog.write("timeline", label=label, **row["timeline"])
            if row.get("overlap") is not None:
                runlog.write("overlap", label=label, **row["overlap"])
        runlog.close()
        print(f"[mem_probe] telemetry written to {runlog.path}", file=sys.stderr)
    if _check_gates(args, gate_rows) + _check_delta(args, out):
        return 1
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
