"""KITTI odometry Velodyne ingestion (HDL-64E .bin sweeps).

The KITTI odometry benchmark ships raw HDL-64E sweeps as float32 .bin files
(x, y, z, reflectance) with no ring ids or per-point times. This module
reconstructs both so the sweeps can feed the engine (the BASELINE configs[1]
workload):

- ring ids from the firing order: HDL-64E scans are stored laser-by-firing in
  azimuth-major order, so ring boundaries appear as azimuth wrap-arounds;
  points between consecutive wrap-arounds belong to one ring (the standard
  community reconstruction). Falls back to vertical-angle binning if the
  sweep was reordered.
- per-point time from azimuth advancement within the sweep
  (io/conversions.estimate_frame_advancement).

Also provides the KITTI ground-truth pose reader (3x4 row-major matrices in
the left-camera frame) and the Tr calibration to move them into the Velodyne
frame for ATE evaluation.

A copy of `lidarslam_tpu/io/kitti.py` (numpy on the host), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from lidarslam_tpu_torch.io.conversions import estimate_frame_advancement

HDL64_N_RINGS = 64
HDL64_ELEV_MIN = np.deg2rad(-24.8)
HDL64_ELEV_MAX = np.deg2rad(2.0)


def read_velodyne_bin(path) -> np.ndarray:
    """-> (n, 4) float32 [x, y, z, reflectance]."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def rings_from_scan_order(xyz) -> np.ndarray:
    """Ring ids from azimuth wrap-arounds in firing order (top ring first in
    KITTI files -> ids flipped so ring 0 is the lowest beam, the convention
    the extractor expects)."""
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    # a wrap: azimuth jumps by ~2*pi between consecutive points
    jumps = np.abs(np.diff(az)) > np.pi
    ring = np.concatenate([[0], np.cumsum(jumps)])
    n = ring.max() + 1
    if n > HDL64_N_RINGS * 2 or n < 16:
        return rings_from_elevation(xyz)
    ring = np.minimum(ring, HDL64_N_RINGS - 1)
    # KITTI stores top (smallest elevation index) first; flip to bottom-up
    return (HDL64_N_RINGS - 1 - ring).astype(np.int64)


def rings_from_elevation(xyz) -> np.ndarray:
    """Fallback: bin points by vertical angle into 64 rings bottom-up."""
    r_xy = np.linalg.norm(xyz[:, :2], axis=1)
    elev = np.arctan2(xyz[:, 2], np.maximum(r_xy, 1e-9))
    frac = (elev - HDL64_ELEV_MIN) / (HDL64_ELEV_MAX - HDL64_ELEV_MIN)
    return np.clip((frac * (HDL64_N_RINGS - 1)).round(), 0,
                   HDL64_N_RINGS - 1).astype(np.int64)


def bin_to_frame(path, stamp: float, sweep_duration: float = 0.1, seq=None) -> dict:
    """One KITTI .bin sweep -> engine frame dict."""
    pts = read_velodyne_bin(path)
    xyz = pts[:, :3]
    finite = np.isfinite(xyz).all(axis=1) & (np.linalg.norm(xyz, axis=1) > 0.1)
    xyz = xyz[finite]
    refl = pts[finite, 3]
    ring = rings_from_scan_order(xyz)
    time = estimate_frame_advancement(xyz) * sweep_duration
    out = {"xyz": xyz.astype(np.float32),
           "intensity": (refl * 255.0).astype(np.float32),
           "laser_id": ring,
           "time": time.astype(np.float32),
           "stamp": float(stamp)}
    if seq is not None:
        out["seq"] = int(seq)
    return out


def load_sequence(velodyne_dir, rate: float = 10.0, limit=None):
    """Iterate engine frames over a KITTI sequence directory of .bin files."""
    files = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    if limit:
        files = files[:limit]
    for i, f in enumerate(files):
        yield bin_to_frame(os.path.join(velodyne_dir, f), stamp=i / rate, seq=i)


def read_poses(pose_file, calib_file=None):
    """KITTI ground-truth poses -> list of (4,4) in the Velodyne frame.

    pose_file rows are 3x4 row-major camera-frame poses; when `calib_file`
    (with a `Tr:` line) is given, poses are conjugated into the LiDAR frame:
    T_velo = Tr^-1 @ T_cam @ Tr."""
    rows = np.loadtxt(pose_file).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :] = rows
    if calib_file:
        Tr = np.eye(4)
        with open(calib_file) as f:
            for line in f:
                if line.startswith("Tr"):
                    Tr[:3, :] = np.fromstring(line.split(":", 1)[1], sep=" ").reshape(3, 4)
        Tr_inv = np.linalg.inv(Tr)
        poses = np.einsum("ij,njk,kl->nil", Tr_inv, poses, Tr)
    return list(poses)
