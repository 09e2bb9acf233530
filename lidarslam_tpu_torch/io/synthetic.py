"""Synthetic spinning-LiDAR simulator (host-side numpy).

A copy of `lidarslam_tpu/io/synthetic.py` on the port's numpy se3 helpers,
so the port renders the same sweeps without importing jax
(tests/test_torch_config.py checks the arrays are bit-identical).

Ray-casts an analytic world (ground plane, axis-aligned boxes, vertical
cylinders) from a spinning multi-ring sensor moving along a trajectory. Used
as the deterministic golden-sequence substrate for end-to-end SLAM tests and
benchmarks — the same role the recorded rosbags play in the reference CI
(ros_wrapping/tests, ci/.gitlab-ci.yml ros_test stage), available offline.

Points are produced in the LIDAR sensor frame (spin axis = Z) with per-point
time offsets within the sweep, laser ring ids, and per-surface intensities,
matching the `LidarPoint` field set (LidarPoint.h:31-77).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from lidarslam_tpu_torch.core import se3


@dataclass
class Box:
    lo: np.ndarray  # (3,)
    hi: np.ndarray  # (3,)
    intensity: float = 40.0
    # world-frame velocity [m/s]; a non-None value makes this a MOVING
    # object (vehicle/pedestrian analog): the box rigidly translates by
    # velocity * t, the substrate for `min_frames_per_voxel` moving-object
    # rejection scenarios (RollingGrid.cxx:362-442 semantics)
    velocity: np.ndarray = None

    def at(self, t: float) -> "Box":
        if self.velocity is None:
            return self
        d = np.asarray(self.velocity, float) * t
        return Box(self.lo + d, self.hi + d, self.intensity)


@dataclass
class Cylinder:
    center: np.ndarray  # (2,) x, y
    radius: float
    z0: float
    z1: float
    intensity: float = 90.0


@dataclass
class World:
    boxes: List[Box] = field(default_factory=list)
    cylinders: List[Cylinder] = field(default_factory=list)
    ground_z: float = 0.0
    ground_intensity: float = 20.0
    max_range: float = 80.0


def default_world(seed=0) -> World:
    """A street scene: ground, buildings on both sides, poles/trees."""
    rng = np.random.default_rng(seed)
    w = World()
    for side in (-1, 1):
        x = -10.0
        while x < 120.0:
            depth = rng.uniform(6, 14)
            width = rng.uniform(8, 16)
            height = rng.uniform(4, 12)
            gap = rng.uniform(2, 8)
            y0 = side * rng.uniform(7, 10)
            y1 = y0 + side * depth
            lo = np.array([x, min(y0, y1), 0.0])
            hi = np.array([x + width, max(y0, y1), height])
            w.boxes.append(Box(lo, hi, intensity=rng.uniform(30, 60)))
            x += width + gap
    for _ in range(30):
        cx = rng.uniform(-10, 120)
        cy = rng.uniform(-6.5, 6.5) + np.sign(rng.normal()) * 4.5
        w.cylinders.append(Cylinder(np.array([cx, cy]), rng.uniform(0.1, 0.25),
                                    0.0, rng.uniform(3, 6),
                                    intensity=rng.uniform(80, 120)))
    return w


@dataclass
class SensorModel:
    n_rings: int = 16
    n_azimuth: int = 900
    elevation_min_deg: float = -15.0
    elevation_max_deg: float = 15.0
    sweep_duration: float = 0.1
    range_noise: float = 0.01
    min_range: float = 0.5

    def ray_directions(self):
        """(R, A, 3) unit directions in the sensor frame."""
        elev = np.deg2rad(np.linspace(self.elevation_min_deg, self.elevation_max_deg,
                                      self.n_rings))
        az = 2 * np.pi * np.arange(self.n_azimuth) / self.n_azimuth
        ce, se_ = np.cos(elev)[:, None], np.sin(elev)[:, None]
        ca, sa = np.cos(az)[None, :], np.sin(az)[None, :]
        return np.stack([ce * ca, ce * sa, np.broadcast_to(se_, (self.n_rings, self.n_azimuth))],
                        axis=-1)


def _ray_ground(origins, dirs, z):
    dz = dirs[..., 2]
    t = np.where(np.abs(dz) > 1e-9, (z - origins[..., 2]) / dz, np.inf)
    return np.where(t > 0, t, np.inf)


def _ray_box(origins, dirs, box: Box):
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(dirs) > 1e-12, 1.0 / dirs, 1e15)
    t0 = (box.lo - origins) * inv
    t1 = (box.hi - origins) * inv
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit & (t > 0), t, np.inf)


def _ray_cylinder(origins, dirs, cyl: Cylinder):
    ox = origins[..., 0] - cyl.center[0]
    oy = origins[..., 1] - cyl.center[1]
    dx, dy = dirs[..., 0], dirs[..., 1]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl.radius**2
    disc = b * b - 4 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = (-b - sq) / np.maximum(2 * a, 1e-12)
    z = origins[..., 2] + t * dirs[..., 2]
    ok = ok & (t > 0) & (z >= cyl.z0) & (z <= cyl.z1)
    return np.where(ok, t, np.inf)


def render_sweep(world: World, sensor: SensorModel, pose_at, t_start: float, seed=0,
                 motion_distortion: bool = True):
    """Ray-cast one sweep.

    Args:
      pose_at: callable t -> (4, 4) world pose of the sensor.
      t_start: sweep start time; column a fires at t_start + a/A * duration.
      motion_distortion: if False the whole sweep uses the pose at t_start.

    Returns dict of per-point arrays (sensor frame) + ground-truth pose at
    the sweep stamp: {xyz, intensity, laser_id, time, stamp, gt_pose}.
    """
    rng = np.random.default_rng(seed)
    R, A = sensor.n_rings, sensor.n_azimuth
    dirs_sensor = sensor.ray_directions()            # (R, A, 3)

    times = sensor.sweep_duration * np.arange(A) / A
    if motion_distortion:
        poses = np.stack([pose_at(t_start + dt) for dt in times])  # (A, 4, 4)
    else:
        poses = np.broadcast_to(pose_at(t_start), (A, 4, 4))
    Rw = poses[:, :3, :3]                            # (A, 3, 3)
    tw = poses[:, :3, 3]                             # (A, 3)

    dirs_world = np.einsum("aij,raj->rai", Rw, dirs_sensor)
    origins = np.broadcast_to(tw[None], (R, A, 3))

    t_hit = _ray_ground(origins, dirs_world, world.ground_z)
    inten = np.full((R, A), world.ground_intensity)
    for box in world.boxes:
        tb = _ray_box(origins, dirs_world, box.at(t_start))
        closer = tb < t_hit
        inten = np.where(closer, box.intensity, inten)
        t_hit = np.minimum(t_hit, tb)
    for cyl in world.cylinders:
        tc = _ray_cylinder(origins, dirs_world, cyl)
        closer = tc < t_hit
        inten = np.where(closer, cyl.intensity, inten)
        t_hit = np.minimum(t_hit, tc)

    valid = np.isfinite(t_hit) & (t_hit <= world.max_range) & (t_hit >= sensor.min_range)
    t_hit = np.where(valid, t_hit, 0.0) + rng.normal(0, sensor.range_noise, t_hit.shape)
    xyz_sensor = dirs_sensor * t_hit[..., None]      # sensor frame at firing time

    ring_ids = np.broadcast_to(np.arange(R)[:, None], (R, A))
    times_full = np.broadcast_to(times[None, :], (R, A))

    # NOTE on distortion: each column's points are expressed in the sensor
    # frame at its own firing time (that is exactly the rolling-shutter
    # distortion an undistortion stage must correct). With
    # motion_distortion=False they are all consistent with the pose at
    # t_start.
    v = valid.ravel()
    return {
        "xyz": xyz_sensor.reshape(-1, 3)[v].astype(np.float32),
        "intensity": inten.ravel()[v].astype(np.float32),
        "laser_id": ring_ids.ravel()[v].astype(np.int32),
        "time": times_full.ravel()[v].astype(np.float32),
        "stamp": t_start,
        "gt_pose": pose_at(t_start),
    }


def straight_then_turn_trajectory(speed=2.0, yaw_rate_deg=6.0, turn_start=6.0):
    """Pose callable: drive +x, then begin a gentle yaw turn."""

    def pose_at(t):
        if t <= turn_start:
            x, y, yaw = speed * t, 0.0, 0.0
        else:
            w = np.deg2rad(yaw_rate_deg)
            dt = t - turn_start
            r = speed / w
            x = speed * turn_start + r * np.sin(w * dt)
            y = r * (1 - np.cos(w * dt))
            yaw = w * dt
        return se3.pose_to_hmat([x, y, 1.8, 0.0, 0.0, yaw])

    return pose_at


def weaving_street_trajectory(speed=2.0, weave_amp=2.0, weave_period=20.0):
    """Pose callable: drive +x down the street's open corridor (|y| < ~5 in
    `default_world`) with a gentle sinusoidal weave, yaw tangent to the path.

    `straight_then_turn_trajectory`'s constant-rate turn leaves the corridor
    after ~18 s and drives INTO the building band (y >= 7) — fine for short
    golden sequences, degenerate for long ones (the ray caster then returns
    a box interior and localization legitimately fails). This trajectory is
    valid for the full street length (x in [-10, 120]: ~65 s at 2 m/s) while
    still exercising continuous yaw/vy motion."""
    w = 2 * np.pi / weave_period

    def pose_at(t):
        x = speed * t
        y = weave_amp * np.sin(w * t)
        yaw = np.arctan2(weave_amp * w * np.cos(w * t), speed)
        return se3.pose_to_hmat([x, y, 1.8, 0.0, 0.0, yaw])

    return pose_at


def generate_sequence(n_frames=20, world=None, sensor=None, trajectory=None,
                      seed=0, motion_distortion=True):
    """Render a full sweep sequence. Returns list of render_sweep dicts."""
    world = world or default_world(seed)
    sensor = sensor or SensorModel()
    trajectory = trajectory or straight_then_turn_trajectory()
    frames = []
    for i in range(n_frames):
        frames.append(render_sweep(world, sensor, trajectory, i * sensor.sweep_duration,
                                   seed=seed + i, motion_distortion=motion_distortion))
    return frames
