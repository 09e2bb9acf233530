"""Confidence estimators: LCP overlap and motion limits (PyTorch port of
`lidarslam_tpu/confidence.py`).

Parity targets: Confidence::LCPEstimator (ConfidenceEstimators.cxx:27-65)
and Slam::CheckMotionLimits (Slam.cxx:1391-1484). The overlap is a batched
1-NN of the sampled sweep against each map's submap (the k-NN kernel on
CUDA) with a per-map Gaussian score (sigma = leaf_size / 3), reduced by a
mean. The motion-limit checker is host float64 numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops.voxel_map import SubmapView, brute_knn


def lcp_overlap(sample_xyz, sample_valid, indices: Sequence[SubmapView],
                leaf_sizes: Sequence[float], prepared=None, mesh=None) -> torch.Tensor:
    """Mean best per-map Gaussian probability of having a close map
    neighbour: a () tensor in [0, 1].

    `sample_xyz` (S, 3) are the sampled registered points in the map frame;
    `indices`/`leaf_sizes` one entry per map; `prepared` optional per-map
    `cuda_knn.KnnIndex` (the matcher's submap cache) to reuse; `mesh`:
    `indices` are this rank's slabs of slab-sharded maps, and each sample's
    nearest distance is the minimum over the ranks."""
    best = torch.zeros(sample_xyz.shape[0], dtype=torch.float32, device=sample_xyz.device)
    for i, (index, leaf) in enumerate(zip(indices, leaf_sizes)):
        # beyond 6 sigma = 2*leaf the Gaussian is below exp(-18) ~ 1e-8, so
        # the kernel may skip map sub-blocks there; the 2 m floor keeps
        # small leaves' pruning coarse, as in the JAX package
        d2, _, _ = brute_knn(index, sample_xyz, 1, prune_radius=max(2.0, 2.0 * float(leaf)),
                             q_valid=sample_valid,
                             prepared=None if prepared is None else prepared[i])
        d2 = d2[:, 0]
        if mesh is not None:
            d2 = mesh.pmin(d2)
        sigma2 = (leaf / 3.0) ** 2
        proba = torch.where(torch.isfinite(d2), torch.exp(-d2 / (2.0 * sigma2)), 0.0)
        best = torch.maximum(best, proba)
    n = torch.clamp(torch.sum(sample_valid), min=1)
    return torch.sum(torch.where(sample_valid, best, 0.0)) / n


class MotionStatus(NamedTuple):
    comply: bool
    velocity: np.ndarray       # [m/s, deg/s]
    acceleration: np.ndarray   # [m/s2, deg/s2] (zeros before 2 frames)


class MotionLimitChecker:
    """Sliding-window velocity/acceleration compliance (host-side float64)."""

    def __init__(self, time_window: float, velocity_limits, acceleration_limits):
        self.time_window = time_window
        self.velocity_limits = np.asarray(velocity_limits, np.float64)
        self.acceleration_limits = np.asarray(acceleration_limits, np.float64)
        self.prev_velocity = None

    def check(self, trajectory, current_pose_hmat, current_time) -> MotionStatus:
        """trajectory: list of (time, (4,4) pose) oldest..newest (excluding
        the current pose)."""
        if not trajectory:
            return MotionStatus(True, np.zeros(2), np.zeros(2))
        # pick the logged pose whose age best brackets the window
        ages = np.array([current_time - t for t, _ in trajectory])
        idx = len(trajectory) - 1
        if ages[-1] < self.time_window:
            older = np.where(ages >= self.time_window)[0]
            if len(older) == 0:
                idx = 0
            else:
                i0 = older[-1]  # oldest bound of the bracketing interval
                i1 = min(i0 + 1, len(trajectory) - 1)
                idx = i0 if abs(ages[i0] - self.time_window) < \
                    abs(ages[i1] - self.time_window) else i1
        dt = max(current_time - trajectory[idx][0], 1e-9)
        T = se3.hmat_inverse(trajectory[idx][1]) @ current_pose_hmat
        angle = np.abs(np.rad2deg(_rotation_angle(T[:3, :3])))
        dist = np.linalg.norm(T[:3, 3])
        velocity = np.array([dist / dt, angle / dt])
        comply = True
        accel = np.zeros(2)
        if self.prev_velocity is not None:
            accel = (velocity - self.prev_velocity) / dt
            comply = bool(np.all(velocity < self.velocity_limits)
                          and np.all(np.abs(accel) < self.acceleration_limits))
        self.prev_velocity = velocity
        return MotionStatus(comply, velocity, accel)


def _rotation_angle(R):
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    a = np.arccos(c)
    return a if a <= np.pi else 2 * np.pi - a
