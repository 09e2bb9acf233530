"""External-sensor constraints: wheel odometry and IMU gravity alignment
(the port's copy of `lidarslam_tpu/sensors/constraints.py`, which imports
jax).

Host-side measurement managers mirroring SensorConstraints.{h,cxx}:
buffered timestamped measurements, float64 linear interpolation to the
LiDAR stamp, an optional time offset, weight gating (`CanBeUsed` = weight >
1e-6 and non-empty). They produce small residual blocks that the LM solver
adds to every evaluation (`ops/solver.py::_extra_terms`), as the reference
pushes extra Ceres residual blocks into LocalOptimizer (Slam.cxx:1123-1131):

- OdomResidual: 1-D `||t - t_prev|| - measured_distance`
  (CeresCostFunctions.h:267-295);
- GravityResidual: 3-D `R(rpy) g_cur - g_ref` (CeresCostFunctions.h:311-341);
  the reference direction comes from a spherical histogram vote over all
  measurements (SensorConstraints.cxx:153-189).

A manager returns its residual with float32 numpy fields (the values the
JAX package puts on its device); `on_device` turns them into tensors on
the device, and the streaming graph reads them from each sweep's input
record instead (ops/stream_graph.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class OdomResidual(NamedTuple):
    prev_pos: object   # (3,) float32: numpy on the host, a tensor on the device
    distance: object   # ()
    weight: object     # ()
    valid: object      # () bool


class GravityResidual(NamedTuple):
    g_ref: object      # (3,) unit reference gravity direction
    g_cur: object      # (3,) unit measured direction at the LiDAR stamp
    weight: object     # ()
    valid: object      # () bool


def inactive_odom() -> OdomResidual:
    return OdomResidual(np.zeros(3, np.float32), np.float32(0.0), np.float32(0.0),
                        np.False_)


def inactive_gravity() -> GravityResidual:
    up = np.array([0.0, 0.0, 1.0], np.float32)
    return GravityResidual(up, up.copy(), np.float32(0.0), np.False_)


def on_device(res, device):
    """The residual with its fields as tensors on `device` (float32, `valid`
    bool)."""
    return type(res)(*(torch.as_tensor(np.asarray(v), device=device,
                                       dtype=torch.bool if name == "valid" else torch.float32)
                       for name, v in zip(res._fields, res)))


class _ManagerBase:
    def __init__(self, weight=0.0, time_offset=0.0):
        self.weight = weight
        self.time_offset = time_offset
        self.times: list = []
        self.values: list = []

    def can_be_used(self) -> bool:
        return self.weight > 1e-6 and len(self.times) > 0

    def reset(self):
        self.times = []
        self.values = []

    def _interpolate(self, t):
        """Linear interpolation at t; None if t outside the measurement span."""
        if not self.times or t < self.times[0] or t > self.times[-1]:
            return None
        i = int(np.searchsorted(self.times, t)) - 1
        i = max(0, min(i, len(self.times) - 2))
        t0, t1 = self.times[i], self.times[i + 1]
        r = (t - t0) / max(t1 - t0, 1e-12)
        v0 = np.asarray(self.values[i], np.float64)
        v1 = np.asarray(self.values[i + 1], np.float64)
        return (1 - r) * v0 + r * v1


class WheelOdometryManager(_ManagerBase):
    """Travelled-distance constraint (SensorConstraints.cxx:8-106).

    relative=False: distance from the reference pose where tracking started;
    relative=True: per-frame distance increments (|currDist - prevDist|).
    """

    def __init__(self, weight=0.0, relative=False, time_offset=0.0):
        super().__init__(weight, time_offset)
        self.relative = relative
        self.prev_distance: Optional[float] = None
        self.prev_pos = np.zeros(3)

    def add_measurement(self, time: float, distance: float):
        self.times.append(float(time))
        self.values.append(float(distance))

    def compute_constraint(self, lidar_time: float) -> Optional[OdomResidual]:
        if not self.can_be_used():
            return None
        d = self._interpolate(lidar_time - self.time_offset)
        if d is None:
            return None
        d = float(d)
        if self.prev_distance is None:
            self.prev_distance = d
            return None
        target = d - self.prev_distance
        if self.relative:
            target = abs(target)
            self.prev_distance = d
        return OdomResidual(prev_pos=np.asarray(self.prev_pos, np.float32),
                            distance=np.float32(target), weight=np.float32(self.weight),
                            valid=np.True_)

    def set_reference_pose(self, pos):
        """Update the reference position (SetPreviousPose surface)."""
        self.prev_pos = np.asarray(pos, np.float64)


class ImuManager(_ManagerBase):
    """Gravity-direction constraint (SensorConstraints.cxx:108-189)."""

    def __init__(self, weight=0.0, time_offset=0.0):
        super().__init__(weight, time_offset)
        self.gravity_ref = np.zeros(3)

    def add_measurement(self, time: float, acceleration):
        self.times.append(float(time))
        self.values.append(np.asarray(acceleration, np.float64))

    def compute_gravity_ref(self, delta_angle_rad=np.deg2rad(5.0)):
        """Spherical histogram vote for the dominant acceleration direction."""
        if not self.values:
            return
        dirs = np.stack([v / max(np.linalg.norm(v), 1e-12) for v in self.values])
        phi = np.arctan2(dirs[:, 1], dirs[:, 0]) + np.pi
        theta = np.arccos(np.clip(dirs[:, 2], -1, 1))
        n_phi = int(np.ceil(2 * np.pi / delta_angle_rad))
        n_theta = int(np.ceil(np.pi / delta_angle_rad))
        iphi = np.minimum((phi / delta_angle_rad).astype(int), n_phi - 1)
        itheta = np.minimum((theta / delta_angle_rad).astype(int), n_theta - 1)
        bins = iphi * n_theta + itheta
        counts = np.bincount(bins, minlength=n_phi * n_theta)
        best = np.argmax(counts)
        g = dirs[bins == best].sum(axis=0)
        self.gravity_ref = g / max(np.linalg.norm(g), 1e-12)

    def compute_constraint(self, lidar_time: float) -> Optional[GravityResidual]:
        if not self.can_be_used():
            return None
        if np.linalg.norm(self.gravity_ref) < 1e-6:
            self.compute_gravity_ref()
        acc = self._interpolate(lidar_time - self.time_offset)
        if acc is None:
            return None
        n = np.linalg.norm(acc)
        if n < 1e-6:
            return None
        return GravityResidual(g_ref=np.asarray(self.gravity_ref, np.float32),
                               g_cur=np.asarray(acc / n, np.float32),
                               weight=np.float32(self.weight), valid=np.True_)
