"""Halo-exchange latency microbenchmark and validation — the counterpart of
``benchmarks/communication/halo/benchmark_sp_halo_exchange.py``.

An arange image is cut into a tile grid (``--num-spatial-parts``,
``--slice-method``); every tile pulls a ``--halo-len`` halo from its
neighbours (``ops/halo.halo_exchange_2d``, 4 shifts for a square grid) and
must equal, exactly, its window of the globally zero-padded image (the
reference's check, ``benchmark_sp_halo_exchange.py:417-578``); then the
exchange is timed.  ``--with-compute`` adds the reference's
``_with_compute`` variant: exchange + a VALID conv consuming the halo
(kernel 2·halo+1) across the grid, against the same conv SAME over the
whole image on one device; the gathered output must agree (atol 1e-4) and
both are timed.  Each validation prints ``PASSED`` or ``FAILED``; the last
line is one JSON object with the JAX tool's keys.

Two backends: under ``torchrun`` one tile per rank
(``ProcessGroupTiles``: NCCL across cards, gloo with ``--device cpu``);
without it, every tile in this process (``TileGrid``, the tiles folded
into the batch).  Times are device time on the card (CUDA events, rank
0's), host time on the CPU.

Examples:
  python mpi4dl_tpu_torch/benchmarks/communication/halo/benchmark_sp_halo_exchange.py \\
      --image-size 1024 --halo-len 3 --num-spatial-parts 4 --slice-method vertical \\
      --with-compute
  torchrun --nproc-per-node 4 .../benchmark_sp_halo_exchange.py --device cpu \\
      --image-size 64 --num-spatial-parts 4 --slice-method square --with-compute
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 4)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from mpi4dl_tpu_torch.benchmarks.communication.halo._timing import platform, timed_ms  # noqa: E402
from mpi4dl_tpu_torch.device import resolve_device  # noqa: E402
from mpi4dl_tpu_torch.layer_ctx import spatial_ctx_for  # noqa: E402
from mpi4dl_tpu_torch.mesh import initialize_distributed  # noqa: E402
from mpi4dl_tpu_torch.ops.halo import HaloSpec, halo_exchange_2d  # noqa: E402
from mpi4dl_tpu_torch.parallel.tiles import ProcessGroupTiles, TileGrid  # noqa: E402


def _tile_windows(tiles, full: torch.Tensor, grid_h: int, grid_w: int, eh: int, ew: int):
    """This process's tiles' windows of ``full`` (the padded image), each
    ``(th + 2·eh) x (tw + 2·ew)``, in the backend's layout."""
    n, hp, wp = full.shape[:3]
    th, tw = (hp - 2 * eh) // grid_h, (wp - 2 * ew) // grid_w
    wins = {(r, c): full[:, r * th:r * th + th + 2 * eh, c * tw:c * tw + tw + 2 * ew]
            for r in range(grid_h) for c in range(grid_w)}
    if tiles.folded:
        return torch.cat([wins[(r, c)] for r in range(grid_h) for c in range(grid_w)])
    return wins[(tiles.ih, tiles.iw)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--halo-len", type=int, default=3)
    p.add_argument("--num-spatial-parts", type=int, default=4)
    p.add_argument("--slice-method", default="vertical",
                   help="square | vertical | horizontal")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--with-compute", action="store_true",
                   help="also time halo exchange + conv against a one-device conv "
                        "and validate")
    p.add_argument("--num-filters", type=int, default=32,
                   help="conv output channels for --with-compute")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    ranks = "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1
    probe = spatial_ctx_for(args.slice_method, args.num_spatial_parts)
    gh, gw = probe.grid_h, probe.grid_w
    rank = 0
    if ranks:
        rank = initialize_distributed("gloo" if dev.type == "cpu" else "nccl")
        tiles = ProcessGroupTiles(gh, gw)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    else:
        tiles = TileGrid(gh, gw)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    sp = spatial_ctx_for(args.slice_method, args.num_spatial_parts, tiles=tiles)
    h = args.halo_len
    size, b, c = args.image_size, args.batch_size, args.channels
    halo_h = HaloSpec.symmetric(h if gh > 1 else 0)
    halo_w = HaloSpec.symmetric(h if gw > 1 else 0)

    def exchange(t):
        return halo_exchange_2d(t, halo_h, halo_w, sp.axis_h, sp.axis_w, gh, gw, tiles)

    def all_ok(ok: bool) -> bool:
        if not ranks:
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=tiles.group)
        return bool(flag.item())

    say = print if rank == 0 else (lambda *a, **k: None)
    x = torch.arange(b * size * size * c, dtype=torch.float32, device=dev).reshape(b, size, size, c)
    mine = tiles.scatter(x)
    with torch.no_grad():
        out = exchange(mine)
        padded = F.pad(x, (0, 0, halo_w.lo, halo_w.hi, halo_h.lo, halo_h.hi))
        ok = all_ok(torch.equal(out, _tile_windows(tiles, padded, gh, gw, halo_h.lo, halo_w.lo)))
    say(f"validation: {'PASSED' if ok else 'FAILED'}", flush=True)

    with torch.no_grad():
        ex_ms = timed_ms(lambda: exchange(mine), dev, args.warmup, args.iterations)
    result = {
        "metric": "halo_exchange_ms_per_iter",
        "value": round(ex_ms, 4),
        "platform": platform(dev),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": "ranks" if ranks else "one-process grid",
        "config": {"image_size": size, "batch": b, "channels": c, "halo_len": h,
                   "parts": args.num_spatial_parts, "slice_method": args.slice_method},
        "validation": "pass" if ok else "FAIL",
        "reference_ms": 0.334,  # the reference's 4-GPU sample (halo README:29-43)
    }

    if args.with_compute:
        kh = 2 * h + 1
        rng = np.random.default_rng(0)
        kernel = (torch.from_numpy(rng.standard_normal((args.num_filters, c, kh, kh)).astype(
            np.float32)) / (kh * kh * c)).to(dev)
        pad = (0 if gh > 1 else h, 0 if gw > 1 else h)

        def conv(t, padding):
            y = F.conv2d(t.permute(0, 3, 1, 2), kernel, padding=padding)
            return y.permute(0, 2, 3, 1)

        with torch.no_grad():
            dist_fn = lambda: conv(exchange(mine), pad)  # noqa: E731
            single_fn = lambda: conv(x, (h, h))  # noqa: E731
            got = tiles.gather(dist_fn())
            want = single_fn()
            cok = all_ok(bool(torch.allclose(got, want, atol=1e-4)))
            say(f"conv validation: {'PASSED' if cok else 'FAILED'}", flush=True)
            ok = ok and cok
            t_dist = timed_ms(dist_fn, dev, args.warmup, args.iterations)
            t_single = timed_ms(single_fn, dev, args.warmup, args.iterations)
        result["with_compute"] = {
            "dist_exchange_conv_ms": round(t_dist, 4),
            "single_device_conv_ms": round(t_single, 4),
            "speedup_vs_single": round(t_single / t_dist, 3),
            "num_filters": args.num_filters,
            "kernel": kh,
            "conv_validation": "pass" if cok else "FAIL",
        }
        result["validation"] = "pass" if ok else "FAIL"
    say(json.dumps(result), flush=True)
    if ranks:
        dist.barrier()
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
