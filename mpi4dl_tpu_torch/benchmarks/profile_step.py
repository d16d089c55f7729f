"""Profile the headline training step scope by scope (counterpart of
``benchmarks/profile_step.py``).

Builds the JAX package's headline step (AmoebaNet-D(18, 416), 1024², bs1,
bf16 compute over fp32 parameters, the hand kernels K1/K2 on, remat none),
runs two warm-up steps, then profiles ``--steps`` steps with
``torch.profiler`` (host and CUDA activity) and writes the Chrome trace
(``<out>/trace.json.gz``, loadable in ui.perfetto.dev).  The analysis
(:func:`analyze`, also ``--analyze DIR`` on a saved trace) reads it with
``obs/kineto.py``: each device op attributed to the ``obs.scope`` path its
launch ran in (backward ops to their forward scope), the measured per-scope
timeline (``obs/timeline.measured_timeline``), the top ops by self device
time, each with its scope path (the JAX ``xprof_ops`` record: ``self_ms``,
``occurrences``, ``category``, ``name``, ``bound_by`` (not measured:
None), plus ``scope``), and the hand kernels' launches a step, split into
forward (K2, ``halo_conv2d_stats``) and backward (K1 as K2's dx) by where
they were launched, and the device ms a step by op family
(:data:`FAMILIES`: the hand kernels, NCCL, copies and fills, library
GEMMs/convolutions, reductions, elementwise).  ``--telemetry-dir`` writes
a RunLog (meta, one ``step`` record a profiled step, ``xprof_ops``,
``timeline``) that ``python -m mpi4dl_tpu_torch.obs report`` renders; ``python -m mpi4dl_tpu_torch.obs
overlap|trace --profile <out>/trace.json.gz`` reads the trace.

    python -m mpi4dl_tpu_torch.benchmarks.profile_step --steps 2 \\
        --out build/profile --telemetry-dir build/profile/t
    python -m mpi4dl_tpu_torch.benchmarks.profile_step --analyze build/profile

``--device cpu`` (with a small ``--image-size``/``--num-filters``) rehearses
the tool on the CPU, where the "device ops" are the host's leaf ops and the
hand kernels run their plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

TRACE_NAME = "trace.json.gz"
SUMMARY_NAME = "summary.json"
K_NAME = "halo_conv"  # K1 and K2 share the CUDA kernel (csrc/halo_conv.cu)


def build_step(args):
    """(step, state, x, y) of the headline step at ``args``."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.train import Optimizer, TrainState, make_train_step

    dev = torch.device(args.device)
    shape = (args.batch, args.image_size, args.image_size, 3)
    model = amoebanetd(shape, num_classes=1000, num_layers=args.num_layers,
                       num_filters=args.num_filters, device=dev, seed=0)
    opt = Optimizer("sgd", lr=1e-3)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16,
                           remat=args.remat != "none" and args.remat, pallas_conv=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(shape, generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    return step, TrainState.create(model, opt), x, y


def capture(args, runlog=None) -> str:
    """Warm up, profile ``args.steps`` steps, write the trace; its path."""
    import torch

    from mpi4dl_tpu_torch.obs.scopes import step_annotation

    step, state, x, y = build_step(args)
    cuda = args.device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(2):
        state, m = step(state, x, y)
    float(m["loss"])
    sync()
    print(f"[profile] warm-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.out, exist_ok=True)
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps):
            t = time.perf_counter()
            with step_annotation(i):
                state, m = step(state, x, y)
            loss = float(m["loss"])
            sync()
            walls.append((time.perf_counter() - t) * 1e3)
            if runlog is not None:
                runlog.write_step(epoch=0, step=i, ms=walls[-1],
                                  images_per_sec=args.batch / walls[-1] * 1e3, loss=loss,
                                  accuracy=float(m.get("accuracy", 0.0)))
    path = os.path.join(args.out, TRACE_NAME)
    prof.export_chrome_trace(path)
    print(f"[profile] {args.steps} steps, {[round(w, 1) for w in walls]} ms wall; "
          f"trace -> {path}", file=sys.stderr)
    with open(os.path.join(args.out, "steps.json"), "w") as f:
        json.dump({"steps": args.steps, "wall_ms": walls}, f)
    return path


def top_ops(ops: List[Dict[str, Any]], top: int) -> Dict[str, Any]:
    """The JAX ``xprof_ops`` record's fields: the top ``top`` (name, scope)
    pairs by self device time."""
    groups: Dict[Any, Dict[str, Any]] = {}
    for o in ops:
        g = groups.setdefault((o["name"], o["scope"]), {
            "self_ms": 0.0, "occurrences": 0, "category": o["cat"], "name": o["name"],
            "bound_by": None, "scope": o["scope"]})
        g["self_ms"] += o["dur"] / 1e3
        g["occurrences"] += 1
    rows = sorted(groups.values(), key=lambda g: -g["self_ms"])
    for g in rows:
        g["self_ms"] = round(g["self_ms"], 3)
    total = sum(o["dur"] for o in ops) / 1e3
    return {"total_self_ms": round(total, 3), "ops": rows[:top]}


# Device-op families by name (first match wins).
FAMILIES = (("hand kernels (K1/K2)", (K_NAME,)), ("nccl", ("nccl",)),
            ("copies and fills", ("Memcpy", "Memset", "copy_kernel", "FillFunctor")),
            ("library gemm/conv", ("gemm", "cutlass", "xmma", "cudnn", "conv", "sm90_",
                                   "sm80_")),
            ("reductions", ("reduce_kernel",)),
            ("elementwise", ("elementwise",)))


def kernel_families(ops: List[Dict[str, Any]], steps: int) -> Dict[str, float]:
    """Device ms a step by op family (:data:`FAMILIES`, the rest "other")."""
    out: Dict[str, float] = {}
    for o in ops:
        fam = next((f for f, keys in FAMILIES if any(k in o["name"] for k in keys)), "other")
        out[fam] = out.get(fam, 0.0) + o["dur"] / 1e3 / steps
    return dict(sorted(((k, round(v, 3)) for k, v in out.items()), key=lambda kv: -kv[1]))


def kernel_launches(ops: List[Dict[str, Any]], steps: int) -> Dict[str, Any]:
    """The hand kernels' launches a step and device ms a step, forward (K2)
    and backward (K1, K2's dx), with the scopes they ran in."""
    out = {}
    for name, bwd in (("halo_conv2d_stats", False), ("halo_conv2d", True)):
        mine = [o for o in ops if K_NAME in o["name"] and bool(o["backward"]) == bwd]
        out[name] = {"launches_per_step": len(mine) / steps,
                     "ms_per_step": sum(o["dur"] for o in mine) / 1e3 / steps,
                     "scopes": sorted({o["scope"] for o in mine}),
                     "unlinked": sum(1 for o in mine if not o["linked"])}
    return out


def analyze(trace_dir: str, top: int = 30, runlog=None, steps: Optional[int] = None
            ) -> Dict[str, Any]:
    """Read a saved trace (module docstring); print and return the summary
    (also written to ``<trace_dir>/summary.json``)."""
    from mpi4dl_tpu_torch.obs import kineto
    from mpi4dl_tpu_torch.obs.timeline import format_timeline, measured_timeline

    path = os.path.join(trace_dir, TRACE_NAME)
    if steps is None:
        meta = os.path.join(trace_dir, "steps.json")
        steps = json.load(open(meta))["steps"] if os.path.exists(meta) else 1
    t0 = time.perf_counter()
    tr = kineto.Trace(path)
    ops = tr.device_ops()
    timeline = measured_timeline(tr)
    xops = top_ops(ops, top)
    kern = kernel_launches(ops, steps)
    fams = kernel_families(ops, steps)
    print(format_timeline(timeline, top=top))
    print(f"total device self time: {xops['total_self_ms']:.1f} ms over {steps} step(s)")
    for o in xops["ops"]:
        print(f"{o['self_ms']:9.3f} ms x{o['occurrences']:<5d} {o['name'][:70]}  "
              f"[{o['scope']}]")
    for name, k in kern.items():
        print(f"{name}: {k['launches_per_step']} launches and {k['ms_per_step']:.3f} ms a "
              f"step, {len(k['scopes'])} scopes, {k['unlinked']} unlinked")
    print("device ms a step by family: "
          + ", ".join(f"{k} {v:.3f}" for k, v in fams.items()))
    summary = {"steps": steps, "timeline": timeline, "xprof_ops": xops, "kernels": kern,
               "families": fams,
               "device": "cuda" if tr.has_device else "cpu",
               "analyze_s": round(time.perf_counter() - t0, 3)}
    with open(os.path.join(trace_dir, SUMMARY_NAME), "w") as f:
        json.dump(summary, f)
    if runlog is not None:
        runlog.write("xprof_ops", **xops)
        runlog.write("timeline", label="profile_step", **timeline)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpi4dl_tpu_torch.benchmarks.profile_step",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--image-size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--num-layers", type=int, default=18)
    ap.add_argument("--num-filters", type=int, default=416)
    ap.add_argument("--remat", default="none", choices=["none", "cell", "fine", "sqrt"])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/profile_step")
    ap.add_argument("--analyze", default=None, metavar="DIR",
                    help="skip the capture; analyze the trace saved in DIR")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--telemetry-dir", default=None,
                    help="write a RunLog (meta, step records, xprof_ops, timeline)")
    args = ap.parse_args(argv)
    if not args.analyze and args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("[profile] no CUDA device (use --device cpu to rehearse)", file=sys.stderr)
            return 2
    runlog = None
    if args.telemetry_dir:
        from mpi4dl_tpu_torch.obs import RunLog

        runlog = RunLog.create(args.telemetry_dir, prefix="profile")
        runlog.write_meta(config=vars(args), family="single", argv=list(argv or sys.argv[1:]))
    try:
        if args.analyze:
            analyze(args.analyze, args.top, runlog=runlog)
            return 0
        capture(args, runlog=runlog)
        analyze(args.out, args.top, runlog=runlog, steps=args.steps)
        return 0
    finally:
        if runlog is not None:
            runlog.close()
            print(f"[profile] telemetry written to {runlog.path}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
