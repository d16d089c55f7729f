"""Small utilities (counterpart of ``mpi4dl_tpu/utils/misc.py``)."""

from __future__ import annotations

import statistics
import time
from typing import List


def get_depth(version: int, n: int) -> int:
    """ResNet depth: v1 → 6n+2, v2 → 9n+2."""
    if version == 1:
        return n * 6 + 2
    if version == 2:
        return n * 9 + 2
    raise ValueError(f"unknown resnet version {version}")


class Timer:
    """Wall-clock timer for one region; ``start``/``stop``, read ``.ms``."""

    def __init__(self) -> None:
        self._t0 = 0.0
        self.ms = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return self.ms


def _percentile(sorted_ms: List[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted sample."""
    if len(sorted_ms) == 1:
        return sorted_ms[0]
    pos = q * (len(sorted_ms) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_ms) - 1)
    frac = pos - lo
    return sorted_ms[lo] * (1 - frac) + sorted_ms[hi] * frac


class StepMeter:
    """Per-step times and images/sec as the reference's benchmarks print
    them.  The first ``warmup_steps`` samples are counted
    (``warmup_dropped``) but left out of the statistics; ``add`` returns
    whether the sample was measured."""

    def __init__(self, batch_size: int, warmup_steps: int = 0) -> None:
        self.batch_size = batch_size
        self.warmup_steps = warmup_steps
        self.warmup_dropped = 0
        self.times_ms: List[float] = []

    def add(self, ms: float) -> bool:
        if self.warmup_dropped < self.warmup_steps:
            self.warmup_dropped += 1
            return False
        self.times_ms.append(ms)
        return True

    def images_per_sec(self) -> float:
        if not self.times_ms:
            return 0.0
        return self.batch_size / (statistics.mean(self.times_ms) / 1e3)

    def stats(self) -> dict:
        """mean/median/p10/p90/min over the measured steps."""
        if not self.times_ms:
            return {"steps": 0, "warmup_dropped": self.warmup_dropped}
        s = sorted(self.times_ms)
        return {
            "steps": len(s),
            "warmup_dropped": self.warmup_dropped,
            "mean_ms": statistics.mean(s),
            "median_ms": statistics.median(s),
            "p10_ms": _percentile(s, 0.10),
            "p90_ms": _percentile(s, 0.90),
            "min_ms": s[0],
            "images_per_sec": self.images_per_sec(),
        }

    def summary(self) -> str:
        if not self.times_ms:
            return "no steps recorded"
        st = self.stats()
        return (
            f"steps={st['steps']} mean={st['mean_ms']:.2f}ms "
            f"median={st['median_ms']:.2f}ms p10={st['p10_ms']:.2f}ms "
            f"p90={st['p90_ms']:.2f}ms min={st['min_ms']:.2f}ms "
            f"warmup_dropped={st['warmup_dropped']} "
            f"images/sec={st['images_per_sec']:.3f}"
        )
