"""Timing shared by the halo tools: device time on the card, host time on
the CPU (where a number says how fast PyTorch's CPU kernels are, not the
card)."""

from __future__ import annotations

import statistics
import time

import torch


def timed_ms(fn, dev: torch.device, warmup: int, iterations: int, windows: int = 3) -> float:
    """Milliseconds per call of ``fn()``: on the card the median over
    ``windows`` of CUDA-event windows of ``iterations`` calls after
    ``warmup`` calls; on the CPU the host clock around the same windows."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(windows):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iterations):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iterations)
        else:
            t0 = time.perf_counter()
            for _ in range(iterations):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / iterations)
    return statistics.median(out)


def platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"
