"""IMU buffer + time-synchronized interpolation (the port's own copy of
`dynosam_tpu/frontend/imu.py`).

Analog of the reference's IMU scaffolding (`frontend/imu/
ThreadSafeImuBuffer.hpp:55`, `dataprovider/DataInterfacePipeline.hpp:87-120`)
— present but unused by the RGB-D main path, kept for sensor-fusion
extensions.  Functional ring buffer with linear interpolation at query
timestamps; no locking needed (single-writer host code).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ImuMeasurement:
    timestamp: float
    accel: np.ndarray   # (3,)
    gyro: np.ndarray    # (3,)


class ImuBuffer:
    """Time-ordered IMU buffer with interpolated range queries."""

    def __init__(self, capacity: int = 10000):
        self.capacity = capacity
        self.ts = np.zeros((0,), np.float64)
        self.accel = np.zeros((0, 3), np.float64)
        self.gyro = np.zeros((0, 3), np.float64)

    def add(self, m: ImuMeasurement):
        if self.ts.size and m.timestamp <= self.ts[-1]:
            raise ValueError("IMU timestamps must be strictly increasing")
        self.ts = np.append(self.ts, m.timestamp)[-self.capacity:]
        self.accel = np.vstack([self.accel, m.accel[None]])[-self.capacity:]
        self.gyro = np.vstack([self.gyro, m.gyro[None]])[-self.capacity:]

    def __len__(self):
        return self.ts.size

    def interpolate(self, t: float) -> Optional[ImuMeasurement]:
        """Linear interpolation at time t; None if outside the buffer."""
        if self.ts.size == 0 or t < self.ts[0] or t > self.ts[-1]:
            return None
        i = int(np.searchsorted(self.ts, t))
        if i == 0 or self.ts[i - 1] == t:
            i = max(i, 1)
        t0, t1 = self.ts[i - 1], self.ts[min(i, self.ts.size - 1)]
        if t1 == t0:
            a = self.accel[i - 1]
            g = self.gyro[i - 1]
        else:
            w = (t - t0) / (t1 - t0)
            a = (1 - w) * self.accel[i - 1] + w * self.accel[min(i, self.ts.size - 1)]
            g = (1 - w) * self.gyro[i - 1] + w * self.gyro[min(i, self.ts.size - 1)]
        return ImuMeasurement(t, a, g)

    def between(self, t0: float, t1: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Measurements in (t0, t1] with interpolated endpoints — the
        reference's `getImuDataInterpolatedUpperBorder` semantics."""
        if t1 <= t0:
            raise ValueError("t1 must be > t0")
        sel = (self.ts > t0) & (self.ts <= t1)
        ts = self.ts[sel]
        acc = self.accel[sel]
        gyr = self.gyro[sel]
        lo = self.interpolate(t0)
        hi = self.interpolate(t1)
        if lo is not None:
            ts = np.concatenate([[t0], ts])
            acc = np.vstack([lo.accel[None], acc])
            gyr = np.vstack([lo.gyro[None], gyr])
        if hi is not None and (ts.size == 0 or ts[-1] < t1):
            ts = np.concatenate([ts, [t1]])
            acc = np.vstack([acc, hi.accel[None]])
            gyr = np.vstack([gyr, hi.gyro[None]])
        return ts, acc, gyr
