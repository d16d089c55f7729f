"""Where a slice of the bf16 halo-conv kernel (K1/K2) spends its cycles, at
the eight shapes of AmoebaNet-D(18, 416)'s 1024² step.

    python -m mpi4dl_tpu_torch.benchmarks.halo_conv_clocks   # one CUDA card

It builds ``csrc/halo_conv.cu`` a second time with ``HALO_CONV_CLOCKS``, in
which thread 0 of every block reads ``clock64()`` around the phases of each
64-deep slice of its main loop: waiting for the slice's copies
(``cp.async.wait_group`` and the barrier), issuing the copies of a later
slice, and the rest (``ldmatrix``, ReLU and the MMA issue).  For K2 on its
forward H x H and K1 as its dx on H x (H+6), as ``chip_smoke.py`` runs
them, it prints those cycles per slice, averaged over the blocks of one
launch, and the device time of one call of the clocked and of the normal
build (20 calls in a CUDA graph, median of 5 replays), so the counters' own
cost shows.  Then the card's name, power limit and SM clock.  Exits
non-zero without a card.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys

import torch

from mpi4dl_tpu_torch.ops import halo_conv as hc

CLOCKS = ("HALO_CONV_CLOCKS",)
SLICE = 64  # depth of one slice (tc::BK)
# (H = W, m = Cin = Cout, kernel) of the main path's K2 / K1-dx calls.
MAIN_PATH = [
    (256, 52, (1, 7)), (256, 52, (7, 1)),
    (128, 104, (1, 7)), (128, 104, (7, 1)),
    (64, 208, (1, 7)), (64, 208, (7, 1)),
    (32, 416, (1, 7)), (32, 416, (7, 1)),
]


def graph_ms(fn, iters: int = 20, windows: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def take_clocks(lib) -> list:
    out = (ctypes.c_ulonglong * 4)()
    torch.cuda.synchronize()
    err = lib.halo_conv2d_take_clocks(out)
    if err != 0:
        raise RuntimeError(lib.halo_conv2d_error_string(err).decode())
    return list(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("halo_conv_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    normal = hc._library
    clocked = hc._library(CLOCKS)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    for hw, m, (kh, kw) in MAIN_PATH:
        xp = torch.randn((1, hw + kh - 1, hw + kw - 1, m), generator=gen, device=dev).to(bf)
        bound = 1.0 / math.sqrt(m * kh * kw)
        wk = ((torch.rand((kh, kw, m, m), generator=gen, device=dev) * 2 - 1) * bound).to(bf)
        ctp = hc.pad_hw(torch.randn((1, hw, hw, m), generator=gen, device=dev).to(bf),
                        kh - 1, kw - 1)
        wt = hc._flip_swap(wk)
        calls = {
            "K2": (xp, wk, lambda: hc.halo_conv2d(xp, wk, fuse_relu=True,
                                                   stat_window=(0, hw, 0, hw))),
            "K1": (ctp, wt, lambda: hc.halo_conv2d(ctp, wt)),
        }
        for key, (x, w, fn) in calls.items():
            hc._library = lambda: clocked
            try:
                fn()
                take_clocks(clocked)
                fn()
                wait, issue, whole, slices = take_clocks(clocked)
                clocked_ms = graph_ms(fn)
            finally:
                hc._library = normal
            normal_ms = graph_ms(fn)
            tiles = hc.stat_rows(x, w)  # pixel tiles of the launch
            blocks = slices // -(-kh * kw * m // SLICE)
            print(f"clocks: {key} {hw}x{hw} m={m} {kh}x{kw}: {tiles} pixel tiles x "
                  f"{blocks // tiles} channel tiles, {slices // blocks} slices a "
                  f"block; cycles a slice: wait {wait / slices:.0f}  issue "
                  f"{issue / slices:.0f}  ldmatrix+mma {(whole - wait - issue) / slices:.0f}"
                  f"  (slice {whole / slices:.0f}); one call {normal_ms:.4f} ms "
                  f"(clocked build {clocked_ms:.4f} ms)", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    print(f"clocks: card {card.stdout.strip().splitlines()[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
