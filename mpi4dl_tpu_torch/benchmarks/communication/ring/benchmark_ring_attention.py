"""Long-context attention microbenchmark of the PyTorch port — the
counterpart of ``benchmarks/communication/ring/benchmark_ring_attention.py``.

Times exact attention three ways at a given sequence length:

  flash   — single-device attention through the block kernel K3
            (``ops/flash_attention.flash_attention_local``)
  einsum  — the materialised-scores reference (``ops/ring.py`` einsum path)
  ring    — ``ring_attention`` over ``--ring-devices`` ranks (under torchrun)

and validates flash and ring against the reference (rtol/atol 0.05, as the
JAX tool does).  The last line of standard output is one JSON object with
the JAX tool's keys.  Runs on the card unless ``--device cpu`` is given
(then "flash" is the kernel's plain version).  Times are CUDA events on
the card, the host clock on the CPU.

Examples:
  python mpi4dl_tpu_torch/benchmarks/communication/ring/benchmark_ring_attention.py \\
      --seq-len 16384 --heads 8 --dim 128
  torchrun --nproc-per-node 4 mpi4dl_tpu_torch/benchmarks/communication/ring/\\
benchmark_ring_attention.py --seq-len 16384 --ring-devices 4
  torchrun --nproc-per-node 4 .../benchmark_ring_attention.py --seq-len 256 \\
      --heads 2 --dim 32 --ring-devices 4 --device cpu     # gloo ranks
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 4)))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mpi4dl_tpu_torch.device import resolve_device  # noqa: E402
from mpi4dl_tpu_torch.ops.flash_attention import flash_attention_local  # noqa: E402
from mpi4dl_tpu_torch.ops.ring import ring_attention  # noqa: E402


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--causal", action="store_true", default=True)
    p.add_argument("--no-causal", dest="causal", action="store_false")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--flash-only", action="store_true",
                   help="skip the einsum reference (its T² scores fill memory)")
    p.add_argument("--ring-devices", type=int, default=0,
                   help="also run ring_attention over this many ranks "
                        "(0 = skip; run under torchrun with that many "
                        "processes: NCCL on cards, gloo with --device cpu)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def _timed(fn, args, dev):
    """Run fn once, ``--warmup`` more times, then time ``--iterations``
    calls; returns (last output, seconds per call)."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = fn()
    for _ in range(args.warmup):
        out = fn()
    sync()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iterations):
            out = fn()
        end.record()
        sync()
        return out, start.elapsed_time(end) / 1e3 / args.iterations
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        out = fn()
    return out, (time.perf_counter() - t0) / args.iterations


def _close(a, b) -> bool:
    return bool(torch.allclose(a.float().cpu(), b.float().cpu(), rtol=0.05, atol=0.05))


@torch.no_grad()
def measure(args) -> dict:
    """Run the variants; returns the JSON object the tool prints."""
    dev = resolve_device(args.device)
    n = args.ring_devices
    group = None
    if n > 1:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
        group = dist.group.WORLD
        if dist.get_world_size() != n:
            raise RuntimeError(f"--ring-devices {n} but {dist.get_world_size()} "
                               "ranks: run under torchrun --nproc-per-node "
                               f"{n}")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    b, t, h, d = args.batch, args.seq_len, args.heads, args.dim
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), generator=gen).to(device=dev, dtype=dtype)
               for _ in range(3))
    # attention flops: QK^T + PV, 2 matmuls x 2 flops/MAC
    flops = 4 * b * h * t * t * d
    if args.causal:
        flops //= 2

    def entry(sec, **extra):
        return {"ms": round(sec * 1e3, 3), "tflops": round(flops / sec / 1e12, 2),
                **extra}

    variants = {}
    out_f, sec = _timed(lambda: flash_attention_local(q, k, v, causal=args.causal),
                        args, dev)
    variants["flash"] = entry(sec)
    validation = None
    if not args.flash_only:
        out_r, sec = _timed(lambda: ring_attention(q, k, v, None, 1, causal=args.causal,
                                                   use_flash=False), args, dev)
        variants["einsum"] = entry(sec)
        validation = _close(out_f, out_r)
    if n > 1:
        if t % n:
            raise ValueError(f"--seq-len {t} does not split over {n} ranks")
        tl, rank = t // n, dist.get_rank()
        qs, ks, vs = (x[:, rank * tl:(rank + 1) * tl].contiguous() for x in (q, k, v))
        out_s, sec = _timed(lambda: ring_attention(qs, ks, vs, group, n,
                                                   causal=args.causal), args, dev)
        variants["ring"] = entry(sec, devices=n)
        shards = [torch.empty((b, tl, h, d), device=dev) for _ in range(n)]
        dist.all_gather(shards, out_s.float().contiguous(), group=group)
        if not args.flash_only:
            validation = validation and _close(torch.cat(shards, dim=1), out_r)
        dist.destroy_process_group()
    return {
        "metric": "exact_attention_ms",
        "value": variants["flash"]["ms"],
        "unit": "ms",
        "config": {"seq_len": t, "heads": h, "dim": d, "batch": b,
                   "causal": args.causal, "dtype": args.dtype},
        "variants": variants,
        "flops_per_call": flops,
        "validation": ("skipped" if validation is None
                       else ("pass" if validation else "FAIL")),
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
    }


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    out = measure(args)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(out), flush=True)
    return 0 if out["validation"] in ("skipped", "pass") else 1


if __name__ == "__main__":
    raise SystemExit(main())
