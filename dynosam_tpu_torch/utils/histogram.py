"""Simple histogram accumulator (port of `dynosam_tpu/utils/histogram.py`,
the analog of the reference's Histogram utility exercised by
`test_histogram.cc`); numpy on the host, tensors accepted."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Histogram:
    def __init__(self, bin_edges: Sequence[float], name: str = ""):
        self.edges = np.asarray(sorted(bin_edges), np.float64)
        if self.edges.size < 2:
            raise ValueError("need at least 2 bin edges")
        self.counts = np.zeros(self.edges.size - 1, np.int64)
        self.underflow = 0
        self.overflow = 0
        self.name = name

    def add(self, value: float):
        self.add_all([value])

    def add_all(self, values):
        if hasattr(values, "detach"):
            values = values.detach().cpu().numpy()
        v = np.asarray(values, np.float64).reshape(-1)
        self.underflow += int((v < self.edges[0]).sum())
        self.overflow += int((v >= self.edges[-1]).sum())
        inside = v[(v >= self.edges[0]) & (v < self.edges[-1])]
        idx = np.searchsorted(self.edges, inside, side="right") - 1
        np.add.at(self.counts, idx, 1)

    @property
    def total(self) -> int:
        return int(self.counts.sum()) + self.underflow + self.overflow

    def bin_of(self, value: float) -> int:
        """Bin index of value; -1 under, len(counts) over."""
        if value < self.edges[0]:
            return -1
        if value >= self.edges[-1]:
            return len(self.counts)
        return int(np.searchsorted(self.edges, value, side="right") - 1)

    def to_dict(self):
        return {
            "name": self.name,
            "edges": self.edges.tolist(),
            "counts": self.counts.tolist(),
            "underflow": self.underflow,
            "overflow": self.overflow,
        }

    def __str__(self):
        rows = [
            f"[{self.edges[i]:.3g}, {self.edges[i+1]:.3g}): {self.counts[i]}"
            for i in range(self.counts.size)
        ]
        return f"Histogram({self.name})\n" + "\n".join(rows)
