"""Poses.csv / Evaluators.csv writers + golden-trajectory comparison.

Format parity with the reference regression harness
(LidarSlamTestNode.cxx:243-260, 328-344):
- Poses.csv lines:      time x y z rX rY rZ          (9-decimal fixed)
- Evaluators.csv lines: time overlap nb_matches computation_time

`compare_to_reference` reimplements the test node's pass criteria
(eval.yaml:11-13 + LidarSlamTestNode.cxx:308-312, 410-414): every pose within
0.01 m / 5 deg of the golden run, mean computation time within +5 ms.

A copy of `lidarslam_tpu/io/csv_log.py` (numpy on the host), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lidarslam_tpu_torch.core import se3


def write_poses_csv(path, entries):
    """entries: iterable of (time, (4,4) pose)."""
    with open(path, "w") as f:
        for t, H in entries:
            p = se3.hmat_to_pose(H)
            f.write(f"{t:.9f} " + " ".join(f"{v:.9f}" for v in p) + "\n")


def read_poses_csv(path):
    data = np.loadtxt(path, ndmin=2)
    return [(row[0], se3.pose_to_hmat(row[1:7])) for row in data]


def write_evaluators_csv(path, entries):
    """entries: iterable of (time, overlap, nb_matches, duration_s)."""
    with open(path, "w") as f:
        for t, ov, nm, dt in entries:
            f.write(f"{t:.9f} {ov:.9f} {nm:.9f} {dt:.9f}\n")


def read_evaluators_csv(path):
    return np.loadtxt(path, ndmin=2)


def write_kitti_poses(path, entries):
    """KITTI odometry format: 3x4 row-major matrices, one pose per line
    (evo/kitti-devkit compatible)."""
    with open(path, "w") as f:
        for _, H in entries:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(H)[:3, :].ravel()) + "\n")


def write_tum_poses(path, entries):
    """TUM trajectory format: `time tx ty tz qx qy qz qw` (evo compatible)."""
    with open(path, "w") as f:
        for t, H in entries:
            q = se3.quat_from_matrix(H[:3, :3])  # (w, x, y, z)
            tx, ty, tz = H[:3, 3]
            f.write(f"{t:.9f} {tx:.9f} {ty:.9f} {tz:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


@dataclass
class ComparisonResult:
    success: bool
    max_position_error: float      # [m]
    max_angle_error: float         # [deg]
    mean_time_delta: float         # [s]
    n_compared: int
    messages: list


def compare_to_reference(res_poses, ref_poses, res_eval=None, ref_eval=None,
                         position_threshold=0.01, angle_threshold_deg=5.0,
                         time_threshold=0.005, time_tolerance=5e-4):
    """Golden-run comparison with frame-drop-tolerant timestamp alignment."""
    msgs = []
    ref_times = np.array([t for t, _ in ref_poses])
    max_pos = 0.0
    max_ang = 0.0
    n = 0
    for t, H in res_poses:
        j = int(np.argmin(np.abs(ref_times - t)))
        if abs(ref_times[j] - t) > time_tolerance:
            continue  # dropped frame in one of the runs
        Href = ref_poses[j][1]
        dp = np.linalg.norm(H[:3, 3] - Href[:3, 3])
        dR = Href[:3, :3].T @ H[:3, :3]
        da = np.rad2deg(abs(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
        max_pos = max(max_pos, dp)
        max_ang = max(max_ang, da)
        n += 1
    ok = max_pos <= position_threshold and max_ang <= angle_threshold_deg
    if not ok:
        msgs.append(f"pose deviation: {max_pos:.4f} m / {max_ang:.2f} deg "
                    f"(thresholds {position_threshold} m / {angle_threshold_deg} deg)")

    mean_dt = 0.0
    if res_eval is not None and ref_eval is not None and len(ref_eval):
        mean_dt = float(np.mean(res_eval[:, 3]) - np.mean(ref_eval[:, 3]))
        if mean_dt > time_threshold:
            ok = False
            msgs.append(f"mean frame time regression: +{mean_dt*1000:.1f} ms")
    return ComparisonResult(ok, max_pos, max_ang, mean_dt, n, msgs)
