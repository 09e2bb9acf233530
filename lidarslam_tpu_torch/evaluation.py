"""Trajectory evaluation: ATE / RPE against a ground-truth trajectory.

The KITTI-parity metric surface (BASELINE.json north star): absolute
trajectory error after SE(3) (or similarity) alignment, and relative pose
error over a fixed frame delta, as evo / the KITTI devkit compute them.
Host-side numpy float64.

A copy of `lidarslam_tpu/evaluation.py` (numpy only), so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lidarslam_tpu_torch.backend.registration import _kabsch
from lidarslam_tpu_torch.core import se3


@dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    max: float
    n: int


def align_trajectories(est_positions, gt_positions):
    """Best-fit rigid alignment (Umeyama without scale) of the estimated
    positions onto ground truth; returns the (4,4) transform."""
    return _kabsch(np.asarray(est_positions, np.float64),
                   np.asarray(gt_positions, np.float64))


def absolute_trajectory_error(est_poses, gt_poses, align=True) -> ATEResult:
    """ATE over matched pose lists (same length/order)."""
    est_p = np.stack([np.asarray(p)[:3, 3] for p in est_poses])
    gt_p = np.stack([np.asarray(p)[:3, 3] for p in gt_poses])
    if align:
        T = align_trajectories(est_p, gt_p)
        est_p = est_p @ T[:3, :3].T + T[:3, 3]
    err = np.linalg.norm(est_p - gt_p, axis=1)
    return ATEResult(rmse=float(np.sqrt(np.mean(err**2))), mean=float(err.mean()),
                     median=float(np.median(err)), max=float(err.max()), n=len(err))


def relative_pose_error(est_poses, gt_poses, delta: int = 1):
    """RPE: translational / rotational error of pose increments over `delta`
    frames. Returns (trans ATEResult [m], rot ATEResult [deg])."""
    t_err, r_err = [], []
    for i in range(len(est_poses) - delta):
        de = se3.hmat_inverse(np.asarray(est_poses[i])) @ np.asarray(est_poses[i + delta])
        dg = se3.hmat_inverse(np.asarray(gt_poses[i])) @ np.asarray(gt_poses[i + delta])
        e = se3.hmat_inverse(dg) @ de
        t_err.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_err.append(np.rad2deg(abs(np.arccos(c))))
    t = np.asarray(t_err)
    r = np.asarray(r_err)

    def mk(a):
        return ATEResult(rmse=float(np.sqrt(np.mean(a**2))), mean=float(a.mean()),
                         median=float(np.median(a)), max=float(a.max()), n=len(a))

    return mk(t), mk(r)
