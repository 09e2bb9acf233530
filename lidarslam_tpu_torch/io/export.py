"""Aggregated-cloud and trajectory export — the vtkSlam output surface as
files.

The reference's ParaView plugin exposes, per update: the world-registered
frame with debug arrays, a trajectory polyline carrying
position/quaternion/axis-angle/time/covariance point-data
(vtkSlam.cxx:631-665 AddCurrentPoseToTrajectory), and aggregated keypoint
maps (vtkSlam.cxx:262); Slam::GetRegisteredFrame-style aggregation of the
logged frames (Slam.cxx:1542-1578) transforms each logged cloud to WORLD
with per-point motion interpolation. Without VTK in this stack the same
products are emitted as PCD (clouds) / CSV and PLY (trajectory) files.

A copy of `lidarslam_tpu/io/export.py` (numpy on the host), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from lidarslam_tpu_torch.core import se3


# ----------------------------------------------------------------------
# Aggregated world-frame cloud over the logged frames
# ----------------------------------------------------------------------


def aggregate_logged_frames(slam, types=None, undistort=True):
    """World-frame aggregation of the keypoint log.

    Each logged (BASE-frame) cloud is transformed by its trajectory pose —
    with per-point within-frame motion interpolation between the previous
    and current pose when `undistort` (Slam.cxx:1542-1578) — and
    concatenated. Returns a dict of arrays: xyz (n,3) f32, intensity (n,),
    time (n,) absolute stamps, label (n,) u8 keypoint type, frame_id (n,)
    i32 index into the trajectory log.
    """
    from lidarslam_tpu_torch.io import storage as storage_mod

    cfg = slam.cfg
    types = list(types) if types is not None else list(cfg.used_types)
    if len(slam.log_keypoints) == 0:
        raise ValueError(
            "no logged frames to aggregate: logging_timeout is 0 (set "
            "SlamConfig.logging_timeout < 0 for unbounded logging)")
    # the keypoint log can be shorter than the trajectory log (pruning
    # drops them in lock-step; both append per frame) — align at the tail
    traj = slam.log_trajectory[-len(slam.log_keypoints):]
    xyz, inten, time, label, fid = [], [], [], [], []
    for i, (entry, kps) in enumerate(zip(traj, slam.log_keypoints)):
        H = entry["pose"]
        for k in types:
            if k not in kps:
                continue
            kp = storage_mod.restore(kps[k])
            n = len(kp.xyz)
            if n == 0:
                continue
            pts = kp.xyz.astype(np.float64)
            if undistort and cfg.undistortion != 0 and i >= 1:
                pts = slam._replay_undistort(pts, kp.time, traj[i - 1], entry)
            else:
                pts = pts @ H[:3, :3].T + H[:3, 3]
            xyz.append(pts.astype(np.float32))
            inten.append(kp.intensity)
            time.append(entry["time"] + kp.time.astype(np.float64))
            label.append(np.full(n, int(k), np.uint8))
            fid.append(np.full(n, i, np.int32))
    if not xyz:
        raise ValueError("aggregation produced no points (empty logs)")
    return {
        "xyz": np.concatenate(xyz),
        "intensity": np.concatenate(inten),
        "time": np.concatenate(time),
        "label": np.concatenate(label),
        "frame_id": np.concatenate(fid),
    }


def undistort_between(pts, point_times, t0, H0, t1, H1):
    """Per-point slerp of `pts` (BASE frame, relative times `point_times`)
    between poses (t0, H0) -> (t1, H1) into WORLD (Slam.cxx:1542-1551)."""
    pts = np.asarray(pts, np.float64)
    if abs(t1 - t0) < 1e-9 or np.allclose(H0, H1, atol=1e-12):
        return pts @ H1[:3, :3].T + H1[:3, 3]
    R, tv = se3.interpolate_rt(H0[:3, :3], H0[:3, 3], H1[:3, :3], H1[:3, 3],
                               t1 + np.asarray(point_times, np.float64), t0, t1)
    return np.einsum("nij,nj->ni", R, pts) + tv


def aggregate_disk_log(log_dir, traj, types=None, undistort=True):
    """Offline re-aggregation from an on-disk keypoint log.

    `log_dir` holds the `kp_NNNNNN_<type>.pcd` files written by
    LoggingStorage.DISK (io/storage.py); `traj` is a list of
    {"time", "pose"} dicts (e.g. `read_trajectory_csv`). Frames are matched
    to trajectory rows in file order, aligned at the tail when the log is
    shorter. Returns the same dict as `aggregate_logged_frames`.

    `undistort` should match the run's SlamConfig.undistortion setting
    (pass False for runs with undistortion NONE, else the offline points
    get a pose-slerp the live map never saw).
    """
    import glob
    import os
    import re

    from lidarslam_tpu_torch.io import pcd

    types = set(types) if types is not None else {"edge", "plane", "blob"}
    by_frame = {}
    for path in sorted(glob.glob(os.path.join(log_dir, "kp_*.pcd"))):
        m = re.match(r"kp_(\d+)_(\w+)\.pcd$", os.path.basename(path))
        if not m or m.group(2) not in types:
            continue
        by_frame.setdefault(int(m.group(1)), {})[m.group(2)] = path
    if not by_frame:
        raise ValueError(f"no kp_*.pcd files in {log_dir}")
    frame_ids = sorted(by_frame)[-len(traj):]
    traj = list(traj)[-len(frame_ids):]
    name_to_label = {"edge": 0, "plane": 1, "blob": 2}
    xyz, inten, time, label, fid = [], [], [], [], []
    for i, (f_id, entry) in enumerate(zip(frame_ids, traj)):
        H = entry["pose"]
        for name, path in sorted(by_frame[f_id].items()):
            data = pcd.load_pcd(path)
            n = len(data["xyz"])
            if n == 0:
                continue
            t_rel = data.get("time", np.zeros(n))
            if undistort and i >= 1:
                pts = undistort_between(data["xyz"], t_rel,
                                        traj[i - 1]["time"], traj[i - 1]["pose"],
                                        entry["time"], H)
            else:
                pts = data["xyz"].astype(np.float64) @ H[:3, :3].T + H[:3, 3]
            xyz.append(pts.astype(np.float32))
            inten.append(data.get("intensity", np.zeros(n, np.float32)))
            time.append(entry["time"] + np.asarray(t_rel, np.float64))
            label.append(np.full(n, name_to_label[name], np.uint8))
            fid.append(np.full(n, i, np.int32))
    return {"xyz": np.concatenate(xyz), "intensity": np.concatenate(inten),
            "time": np.concatenate(time), "label": np.concatenate(label),
            "frame_id": np.concatenate(fid)}


def save_aggregated_pcd(path, slam, types=None, undistort=True):
    """Aggregate the logged frames and write one world-frame PCD."""
    from lidarslam_tpu_torch.io import pcd

    agg = aggregate_logged_frames(slam, types=types, undistort=undistort)
    pcd.save_pcd(path, agg["xyz"], intensity=agg["intensity"],
                 time=agg["time"], label=agg["label"], binary=True)
    return len(agg["xyz"])


# ----------------------------------------------------------------------
# Trajectory with orientation + covariance point data
# ----------------------------------------------------------------------


def trajectory_arrays(slam, extras=None):
    """Per-pose arrays matching the vtkSlam trajectory point data
    (vtkSlam.cxx:631-665): position, Orientation(Quaternion) wxyz,
    Orientation(AxisAngle) xyz+angle, Time, Covariance (row-major 36).

    `extras`: optional list of per-frame summary dicts (the add_frame /
    flush outputs) aligned with the trajectory tail; their scalar entries
    (overlap, n_matches, ...) are added as extra columns — the
    AdvancedReturnMode debug-info arrays (vtkSlam.cxx:363-368).
    """
    traj = slam.log_trajectory
    n = len(traj)
    pos = np.zeros((n, 3)); quat = np.zeros((n, 4))
    axang = np.zeros((n, 4)); tstamp = np.zeros(n)
    cov = np.zeros((n, 36))
    for i, e in enumerate(traj):
        H = e["pose"]
        pos[i] = H[:3, 3]
        quat[i] = se3.quat_from_matrix(H[:3, :3])  # wxyz
        w = se3.so3_log(H[:3, :3])
        angle = float(np.linalg.norm(w))
        axis = w / angle if angle > 1e-12 else np.array([1.0, 0.0, 0.0])
        axang[i] = [*axis, angle]
        tstamp[i] = e["time"]
        cov[i] = np.asarray(e["covariance"], np.float64).ravel()
    out = {"position": pos, "quaternion_wxyz": quat, "axis_angle": axang,
           "time": tstamp, "covariance": cov}
    if extras:
        extras = list(extras)[-n:]
        pad = n - len(extras)
        keys = sorted({k for r in extras for k, v in r.items()
                       if np.isscalar(v) and not isinstance(v, (str, bytes))})
        for k in keys:
            col = np.full(n, np.nan)
            for j, r in enumerate(extras):
                v = r.get(k)
                if v is not None and np.isscalar(v):
                    col[pad + j] = float(v)
            out[k] = col
    return out


def write_trajectory_csv(path, slam, extras=None):
    """One row per pose: time, x, y, z, qw..qz, axis+angle, cov00..cov55,
    then any extra debug columns."""
    arr = trajectory_arrays(slam, extras=extras)
    n = len(arr["time"])
    cols = [("time", arr["time"])]
    cols += [(c, arr["position"][:, i]) for i, c in enumerate("xyz")]
    cols += [(f"q{c}", arr["quaternion_wxyz"][:, i])
             for i, c in enumerate("wxyz")]
    cols += [(f"axis_{c}", arr["axis_angle"][:, i]) for i, c in enumerate("xyz")]
    cols += [("angle", arr["axis_angle"][:, 3])]
    cols += [(f"cov{i // 6}{i % 6}", arr["covariance"][:, i]) for i in range(36)]
    for k in sorted(arr):
        if k not in ("time", "position", "quaternion_wxyz", "axis_angle",
                     "covariance"):
            cols.append((k, arr[k]))
    with open(path, "w") as f:
        f.write(",".join(c for c, _ in cols) + "\n")
        for i in range(n):
            f.write(",".join(repr(float(v[i])) for _, v in cols) + "\n")
    return n


def read_trajectory_csv(path):
    """Read a write_trajectory_csv file back into a list of
    {"time", "pose" (4,4), "covariance" (6,6)} dicts."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = np.array([[float(v) for v in line.split(",")]
                         for line in f if line.strip()])
    idx = {c: i for i, c in enumerate(header)}
    out = []
    for r in rows:
        H = np.eye(4)
        H[:3, :3] = se3.quat_to_matrix(
            [r[idx["qw"]], r[idx["qx"]], r[idx["qy"]], r[idx["qz"]]])
        H[:3, 3] = [r[idx["x"]], r[idx["y"]], r[idx["z"]]]
        cov = np.array([r[idx[f"cov{i // 6}{i % 6}"]]
                        for i in range(36)]).reshape(6, 6)
        out.append({"time": r[idx["time"]], "pose": H, "covariance": cov})
    return out


def save_trajectory_ply(path, slam):
    """Trajectory as an ASCII PLY polyline (vertices + edges), with
    time and position-variance vertex properties — the SLAM_TRAJECTORY
    output port as a file any mesh viewer opens."""
    arr = trajectory_arrays(slam)
    n = len(arr["time"])
    var = arr["covariance"][:, [0, 7, 14]].sum(axis=1)  # tr(position block)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property double time\nproperty float position_variance\n"
                f"element edge {max(n - 1, 0)}\n"
                "property int vertex1\nproperty int vertex2\n"
                "end_header\n")
        for i in range(n):
            p = arr["position"][i]
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{arr['time'][i]:.9f} {var[i]:.6e}\n")
        for i in range(n - 1):
            f.write(f"{i} {i + 1}\n")
    return n
