"""Global statistics/timing registry (port of `dynosam_tpu/utils/stats.py`;
the device trace is a `torch.profiler` run).

The analog of `utils::Statistics` / `TimingStatsCollector`
(`utils/Statistics.hpp:81-243`, `utils/TimingStats.hpp:33-71`): a
tag -> accumulator registry with RAII-style scope timers, plus CSV dumps in
the reference's format (`statistics_samples.csv`, per-module summaries,
`src/utils/Statistics.cc:444`).
"""

from __future__ import annotations

import contextlib
import csv
import math
import threading
import time
from collections import defaultdict
from typing import Dict, List


class Accumulator:
    def __init__(self):
        self.samples: List[float] = []
        self.timestamps: List[float] = []

    def add(self, v: float):
        self.samples.append(float(v))
        self.timestamps.append(time.time())

    @property
    def count(self):
        return len(self.samples)

    @property
    def total(self):
        return sum(self.samples)

    @property
    def mean(self):
        return self.total / self.count if self.samples else 0.0

    @property
    def max(self):
        return max(self.samples) if self.samples else 0.0

    @property
    def min(self):
        return min(self.samples) if self.samples else 0.0

    @property
    def std(self):
        if len(self.samples) < 2:
            return 0.0
        m = self.mean
        return math.sqrt(
            sum((s - m) ** 2 for s in self.samples) / (len(self.samples) - 1)
        )

    def percentile(self, q: float):
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        i = min(int(q * (len(xs) - 1)), len(xs) - 1)
        return xs[i]

    @property
    def hz(self):
        """Rate from inter-sample timestamps."""
        if len(self.timestamps) < 2:
            return 0.0
        dt = self.timestamps[-1] - self.timestamps[0]
        return (len(self.timestamps) - 1) / dt if dt > 0 else 0.0


_registry: Dict[str, Accumulator] = defaultdict(Accumulator)
_lock = threading.Lock()


def add_sample(tag: str, value: float):
    with _lock:
        _registry[tag].add(value)


def get(tag: str) -> Accumulator:
    return _registry[tag]


def tags() -> List[str]:
    return sorted(_registry)


def reset():
    with _lock:
        _registry.clear()


@contextlib.contextmanager
def timer(tag: str):
    """Scope timer feeding `<tag> [ms]` samples (TimingStatsCollector)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_sample(f"{tag} [ms]", (time.perf_counter() - t0) * 1e3)


def write_samples_csv(path: str):
    """All raw samples: one row per tag (reference statistics_samples.csv)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tag", "samples"])
        for tag in tags():
            w.writerow([tag] + _registry[tag].samples)


def write_summary_csv(path: str):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tag", "count", "mean", "std", "min", "max", "p50", "p95", "hz"])
        for tag in tags():
            a = _registry[tag]
            w.writerow(
                [
                    tag,
                    a.count,
                    f"{a.mean:.6f}",
                    f"{a.std:.6f}",
                    f"{a.min:.6f}",
                    f"{a.max:.6f}",
                    f"{a.percentile(0.5):.6f}",
                    f"{a.percentile(0.95):.6f}",
                    f"{a.hz:.3f}",
                ]
            )


def print_summary():
    lines = []
    for tag in tags():
        a = _registry[tag]
        lines.append(
            f"{tag}: n={a.count} mean={a.mean:.3f} min={a.min:.3f} "
            f"max={a.max:.3f} p95={a.percentile(0.95):.3f}"
        )
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """`torch.profiler` scope over the CPU and, when a card is present, the
    CUDA device; writes a Chrome trace (`trace.json`) into `log_dir` — the
    device-side companion of the host timers."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(tag: str):
    """Named region visible in device profiles."""
    import torch

    return torch.profiler.record_function(tag)
