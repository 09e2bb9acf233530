"""Frozen numpy copy of the ray caster in `lidarslam_tpu_torch/io/synthetic.py`
(`_ray_ground`, `_ray_box`, `_ray_cylinder`, `render_sweep`), the yardstick
that `slambench/raycast.py` is held to. Changed from the original: the world
is given as arrays (boxes (B, 6) lo/hi, cylinders (C, 5) cx, cy, radius, z0,
z1) and the sensor as the configuration's sensor block; boxes do not move."""

import numpy as np


def ray_directions(sensor):
    R, A = sensor["n_rings"], sensor["n_azimuth"]
    elev = np.deg2rad(np.linspace(sensor["elevation_min_deg"], sensor["elevation_max_deg"], R))
    az = 2 * np.pi * np.arange(A) / A
    ce, se_ = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(az)[None, :], np.sin(az)[None, :]
    return np.stack([ce * ca, ce * sa, np.broadcast_to(se_, (R, A))], axis=-1)


def _ray_ground(origins, dirs, z):
    dz = dirs[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(np.abs(dz) > 1e-9, (z - origins[..., 2]) / dz, np.inf)
    return np.where(t > 0, t, np.inf)


def _ray_box(origins, dirs, lo, hi):
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(dirs) > 1e-12, 1.0 / dirs, 1e15)
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit & (t > 0), t, np.inf)


def _ray_cylinder(origins, dirs, cyl):
    cx, cy, radius, z0, z1 = cyl
    ox = origins[..., 0] - cx
    oy = origins[..., 1] - cy
    dx, dy = dirs[..., 0], dirs[..., 1]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius**2
    disc = b * b - 4 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = (-b - sq) / np.maximum(2 * a, 1e-12)
    z = origins[..., 2] + t * dirs[..., 2]
    ok = ok & (t > 0) & (z >= z0) & (z <= z1)
    return np.where(ok, t, np.inf)


def render_sweep(world, sensor, pose_at, t_start, noise):
    """One sweep as the simulator casts it; `noise` (R, A) is added to
    every range (the original draws it from its own generator)."""
    R, A = sensor["n_rings"], sensor["n_azimuth"]
    dirs_sensor = ray_directions(sensor)
    times = sensor["sweep_duration"] * np.arange(A) / A
    poses = np.stack([pose_at(t_start + dt) for dt in times])
    Rw = poses[:, :3, :3]
    tw = poses[:, :3, 3]
    dirs_world = np.einsum("aij,raj->rai", Rw, dirs_sensor)
    origins = np.broadcast_to(tw[None], (R, A, 3))
    t_hit = _ray_ground(origins, dirs_world, world["ground_z"])
    inten = np.full((R, A), world["ground_intensity"])
    for box, bi in zip(world["boxes"], world["box_intensity"]):
        tb = _ray_box(origins, dirs_world, box[:3], box[3:])
        closer = tb < t_hit
        inten = np.where(closer, bi, inten)
        t_hit = np.minimum(t_hit, tb)
    for cyl, ci in zip(world["cylinders"], world["cyl_intensity"]):
        tc = _ray_cylinder(origins, dirs_world, cyl)
        closer = tc < t_hit
        inten = np.where(closer, ci, inten)
        t_hit = np.minimum(t_hit, tc)
    valid = (np.isfinite(t_hit) & (t_hit <= sensor["max_range"])
             & (t_hit >= sensor["min_range"]))
    t_hit = np.where(valid, t_hit, 0.0) + noise
    xyz_sensor = dirs_sensor * t_hit[..., None]
    ring_ids = np.broadcast_to(np.arange(R)[:, None], (R, A))
    times_full = np.broadcast_to(times[None, :], (R, A))
    v = valid.ravel()
    return {
        "xyz": xyz_sensor.reshape(-1, 3)[v].astype(np.float32),
        "intensity": inten.ravel()[v].astype(np.float32),
        "laser_id": ring_ids.ravel()[v].astype(np.int32),
        "time": times_full.ravel()[v].astype(np.float32),
    }
