"""Ray caster of a spinning multi-ring LiDAR in PyTorch, on the card.

A frozen copy of the primitives and `render_sweep` of
`lidarslam_tpu_torch/io/synthetic.py` (ground plane, axis-aligned boxes,
vertical cylinders; each column fires at its own time along the drive, the
rolling-shutter distortion), rewritten to cast many sweeps at once in
float64 tensors. Sweeps come out in the simulator's field layout: xyz
(sensor frame at the firing time), intensity, laser_id (ring, lowest
elevation first), time (offset from the sweep's stamp), only the rays that
hit within [min_range, max_range].

Primitives farther from every sweep of a chunk than the sensor's range are
culled: a hit on one would lie beyond the range, and so would every hit it
could occlude, so no returned point changes. `slambench/tests` holds the
caster to a frozen numpy copy of `render_sweep`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# sweeps cast together, and boxes (or cylinders) per intersection pass
_CHUNK_SWEEPS = 8
_PRIM_BLOCK = 48


def ray_directions(sensor: dict, device, dtype=torch.float64) -> torch.Tensor:
    """(R, A, 3) unit directions in the sensor frame (SensorModel's)."""
    R, A = int(sensor["n_rings"]), int(sensor["n_azimuth"])
    elev = torch.deg2rad(torch.linspace(float(sensor["elevation_min_deg"]),
                                        float(sensor["elevation_max_deg"]), R,
                                        dtype=dtype, device=device))
    az = 2 * math.pi * torch.arange(A, dtype=dtype, device=device) / A
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(az)[None, :], torch.sin(az)[None, :]
    return torch.stack([ce * ca, ce * sa, se.expand(R, A)], dim=-1)


def _ground(o, d, z):
    dz = d[:, 2]
    t = torch.where(dz.abs() > 1e-9, (z - o[:, 2]) / torch.where(dz.abs() > 1e-9, dz, 1.0),
                    torch.inf)
    return torch.where(t > 0, t, torch.inf)


def _boxes(o, d, lo, hi):
    """(N, B) hit distances of N rays on B boxes (inf: no hit)."""
    inv = torch.where(d.abs() > 1e-12, 1.0 / torch.where(d.abs() > 1e-12, d, 1.0), 1e15)
    tmin = tmax = None
    for k in range(3):
        t0 = (lo[None, :, k] - o[:, None, k]) * inv[:, None, k]
        t1 = (hi[None, :, k] - o[:, None, k]) * inv[:, None, k]
        a, b = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tmin = a if tmin is None else torch.maximum(tmin, a)
        tmax = b if tmax is None else torch.minimum(tmax, b)
    hit = (tmax >= tmin) & (tmax > 0)
    t = torch.where(tmin > 0, tmin, tmax)
    return torch.where(hit & (t > 0), t, torch.inf)


def _cylinders(o, d, cyl):
    """(N, C) hit distances of N rays on C vertical cylinders."""
    ox = o[:, None, 0] - cyl[None, :, 0]
    oy = o[:, None, 1] - cyl[None, :, 1]
    dx, dy = d[:, None, 0], d[:, None, 1]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl[None, :, 2] ** 2
    disc = b * b - 4 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.clamp(2 * a, min=1e-12)
    z = o[:, None, 2] + t * d[:, None, 2]
    ok = ok & (t > 0) & (z >= cyl[None, :, 3]) & (z <= cyl[None, :, 4])
    return torch.where(ok, t, torch.inf)


def _first_hit(t_best, i_best, fn, prims, o, d):
    """Fold blocks of primitives into the running nearest hit: a later
    primitive wins only when strictly nearer, as the simulator's loop."""
    for j in range(0, prims.shape[0], _PRIM_BLOCK):
        t = fn(o, d, prims[j:j + _PRIM_BLOCK])
        tm, im = t.min(dim=1)
        closer = tm < t_best
        t_best = torch.where(closer, tm, t_best)
        i_best = torch.where(closer, im + j, i_best)
    return t_best, i_best


def cast(origins, dirs, world: dict):
    """Nearest hits of rays (N, 3) on the world's ground, boxes, cylinders:
    (t (N,), intensity (N,)); t is inf where nothing is hit."""
    t = _ground(origins, dirs, world["ground_z"])
    inten = torch.full_like(t, world["ground_intensity"])
    for key, fn in (("boxes", lambda o, d, p: _boxes(o, d, p[:, :3], p[:, 3:])),
                    ("cylinders", _cylinders)):
        prims, pint = world[key], world[key + "_intensity"]
        if prims.shape[0] == 0:
            continue
        idx = torch.full(t.shape, -1, dtype=torch.long, device=t.device)
        t_new, idx = _first_hit(t, idx, fn, prims, origins, dirs)
        inten = torch.where(idx >= 0, pint[idx.clamp(min=0)], inten)
        t = t_new
    return t, inten


def _near(prims_xy_lo, prims_xy_hi, centers, reach):
    """Indices of primitives whose xy box lies within `reach` of any of the
    centers (numpy)."""
    d = np.zeros((centers.shape[0], prims_xy_lo.shape[0]))
    for k in range(2):
        gap = np.maximum(prims_xy_lo[None, :, k] - centers[:, None, k],
                         centers[:, None, k] - prims_xy_hi[None, :, k])
        d += np.maximum(gap, 0.0) ** 2
    return np.flatnonzero((np.sqrt(d) <= reach).any(axis=0))


def render_lap(circuit, sensor: dict, generator: torch.Generator, device,
               motion_distortion: bool = True):
    """Every sweep of one lap, cast on `device`: a dict of host numpy
    arrays of all sweeps' points back to back (xyz float32 (M, 3),
    intensity float32, laser_id int32, time float32) with `offsets`
    (n_sweeps + 1,) into them. Range noise comes from `generator` (on
    `device`), in sweep order."""
    R, A = int(sensor["n_rings"]), int(sensor["n_azimuth"])
    dur = float(sensor["sweep_duration"])
    max_range, min_range = float(sensor["max_range"]), float(sensor["min_range"])
    noise = float(sensor["range_noise"])
    dirs_s = ray_directions(sensor, device)                        # (R, A, 3)
    col_dt = dur * torch.arange(A, dtype=torch.float64, device=device) / A
    ring = torch.arange(R, dtype=torch.int32, device=device)[:, None].expand(R, A)
    n = circuit.n_sweeps
    starts = circuit.sweep_poses()[:, :2, 3].numpy()                # (n, 2)
    reach = max_range + circuit.speed * dur * _CHUNK_SWEEPS + 1.0
    boxes_t = torch.as_tensor(circuit.boxes, device=device)
    cyl_t = torch.as_tensor(circuit.cylinders, device=device)
    bint_t = torch.as_tensor(circuit.box_intensity, device=device)
    cint_t = torch.as_tensor(circuit.cyl_intensity, device=device)
    cyl_lo = circuit.cylinders[:, :2] - circuit.cylinders[:, 2:3]
    cyl_hi = circuit.cylinders[:, :2] + circuit.cylinders[:, 2:3]
    parts = {"xyz": [], "intensity": [], "laser_id": [], "time": []}
    counts = []
    for s0 in range(0, n, _CHUNK_SWEEPS):
        s1 = min(n, s0 + _CHUNK_SWEEPS)
        S = s1 - s0
        bi = _near(circuit.boxes[:, :2], circuit.boxes[:, 3:5], starts[s0:s1], reach)
        ci = _near(cyl_lo, cyl_hi, starts[s0:s1], reach)
        world = {"ground_z": circuit.ground_z, "ground_intensity": circuit.ground_intensity,
                 "boxes": boxes_t[bi], "boxes_intensity": bint_t[bi],
                 "cylinders": cyl_t[ci], "cylinders_intensity": cint_t[ci]}
        t0 = torch.arange(s0, s1, dtype=torch.float64, device=device) * dur    # (S,)
        if motion_distortion:
            poses = circuit.poses(t0[:, None] + col_dt[None, :])              # (S, A, 4, 4)
        else:
            poses = circuit.poses(t0)[:, None].expand(S, A, 4, 4)
        Rw, tw = poses[..., :3, :3], poses[..., :3, 3]
        dirs_w = torch.einsum("saij,raj->srai", Rw, dirs_s)                  # (S, R, A, 3)
        origins = tw[:, None].expand(S, R, A, 3)
        t_hit, inten = cast(origins.reshape(-1, 3), dirs_w.reshape(-1, 3), world)
        valid = torch.isfinite(t_hit) & (t_hit <= max_range) & (t_hit >= min_range)
        eps = torch.randn(t_hit.shape, generator=generator, dtype=torch.float64,
                          device=device) * noise
        rng = torch.where(valid, t_hit, 0.0) + eps
        xyz = dirs_s[None] * rng.reshape(S, R, A)[..., None]
        v = valid.reshape(S, R * A)
        counts.append(v.sum(dim=1))
        parts["xyz"].append(xyz.reshape(S, R * A, 3)[v].float())
        parts["intensity"].append(inten.reshape(S, R * A)[v].float())
        parts["laser_id"].append(ring.reshape(1, R * A).expand(S, R * A)[v])
        parts["time"].append(col_dt[None, None, :].expand(S, R, A).reshape(S, R * A)[v].float())
    out = {k: torch.cat(v).cpu().numpy() for k, v in parts.items()}
    counts = torch.cat(counts).cpu().numpy()
    out["offsets"] = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return out
