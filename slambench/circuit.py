"""The drive of a traffic mix: a closed city-block circuit.

A traffic file (`slambench/traffic/<mix>.json`) gives the block, the corner
radius, the speed and the street furniture's ranges; this module turns it
into a `Circuit`: the world's primitives (axis-aligned boxes for buildings,
vertical cylinders for poles, the ground plane) and the sensor's path, a
rectangle with eased corners driven counter-clockwise at constant speed,
starting on its first long side a set distance before the first corner.
Each corner eases in and out: its curvature ramps linearly (a clothoid, as
roads are laid out) over the mix's transition length into an arc of the
corner radius and back, so yaw rate never jumps. The lap is a whole number
of sweeps, so replaying it lap after lap is seamless.

Buildings and poles are laid as `default_world` in
`lidarslam_tpu_torch/io/synthetic.py` lays them along its street (setbacks,
depths, widths, heights, gaps and intensities drawn uniformly from the same
ranges), here along both sides of each of the circuit's four streets. Inner
buildings and poles stay within the straight part of their street, so the
corners keep the setback; outer buildings run past the block's corners.

Imports neither the program nor JAX: the reference (`check.py`) takes its
poses from here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Circuit:
    """A mix's world and path. Boxes are (B, 6) lo/hi rows with (B,)
    intensities; cylinders (C, 5) rows of cx, cy, radius, z0, z1 with (C,)
    intensities."""

    boxes: np.ndarray
    box_intensity: np.ndarray
    cylinders: np.ndarray
    cyl_intensity: np.ndarray
    ground_z: float
    ground_intensity: float
    width: float            # block extent along x [m] (path rectangle)
    height: float           # along y [m]
    radius: float           # corner radius [m]
    transition: float       # length of each curvature ramp into and out of a corner [m]
    speed: float            # [m/s], adjusted so a lap is a whole number of sweeps
    start: float            # arc length [m] from the middle of the first side at t = 0
    mount_height: float     # sensor above the ground [m]
    sweep_duration: float   # [s]
    n_sweeps: int           # sweeps in one lap

    def poses(self, t, dtype=torch.float64) -> torch.Tensor:
        """(..., 4, 4) sensor poses at times `t` [s] (a tensor), computed in
        `dtype` (float64 for the reference, lower for its control)."""
        return path_poses(t.to(dtype), self.width, self.height, self.radius, self.transition,
                          self.speed, self.start, self.mount_height)

    def sweep_poses(self, n=None) -> torch.Tensor:
        """(n, 4, 4) float64 poses at the stamps of sweeps 0..n-1 (a lap's
        by default), stamps continuing past the lap."""
        n = self.n_sweeps if n is None else n
        return self.poses(torch.arange(n, dtype=torch.float64) * self.sweep_duration)


# Gauss-Legendre nodes and weights on [0, 1] for the transition curves
_GL_X, _GL_W = np.polynomial.legendre.leggauss(16)
_GL_X, _GL_W = (_GL_X + 1.0) / 2.0, _GL_W / 2.0


def _corner(radius: float, transition: float):
    """A 90-degree left corner: a transition whose curvature ramps from 0
    to 1/radius over `transition` metres (a clothoid), an arc, and the
    mirrored transition. Returns its pieces as (length, k0, k1) and the
    distance T from its start to the tangents' intersection (the
    rectangle's corner), which by symmetry is also the distance from there
    to its end."""
    k = 1.0 / radius
    arc = math.pi / 2 - transition * k
    if arc < 0:
        raise ValueError("transition too long for the corner radius")
    pieces = [(transition, 0.0, k), (radius * arc, k, k), (transition, k, 0.0)]
    x = y = th = 0.0
    for length, k0, k1 in pieces:
        dx, dy = _advance(th, k0, k1, length, length)
        x, y = x + dx, y + dy
        th += (k0 + k1) / 2 * length
    return pieces, x


def _advance(th0, k0, k1, length, u):
    """Displacement along a piece of linearly varying curvature (k0 to k1
    over `length`) from its start at heading th0 to arc length u, by
    Gauss-Legendre quadrature (exact to rounding for these short pieces).
    Works on floats and on tensors of u."""
    if isinstance(u, torch.Tensor):
        v = u[..., None] * torch.as_tensor(_GL_X, dtype=u.dtype, device=u.device)
        w = torch.as_tensor(_GL_W, dtype=u.dtype, device=u.device)
        th0, k0, k1, length = (x[..., None] for x in (th0, k0, k1, length))
        th = th0 + k0 * v + (k1 - k0) / (2 * length) * v * v
        return (u * (torch.cos(th) * w).sum(-1), u * (torch.sin(th) * w).sum(-1))
    v = u * _GL_X
    th = th0 + k0 * v + (k1 - k0) / (2 * length) * v * v
    return u * float((np.cos(th) * _GL_W).sum()), u * float((np.sin(th) * _GL_W).sum())


def path_pieces(width: float, height: float, radius: float, transition: float):
    """The lap as (length, k0, k1, x0, y0, th0) pieces from the middle of
    the bottom side, counter-clockwise: half a straight, then four times a
    corner and a straight, the last one half."""
    corner, T = _corner(radius, transition)
    sides = [width - 2 * T, height - 2 * T, width - 2 * T, height - 2 * T]
    if min(sides) <= 0:
        raise ValueError("block too small for its corners")
    plan = [(sides[0] / 2, 0.0, 0.0)]
    for i in range(4):
        plan += corner
        plan.append((sides[(i + 1) % 4] / (2 if i == 3 else 1), 0.0, 0.0))
    out = []
    x, y, th = 0.0, -height / 2, 0.0
    for length, k0, k1 in plan:
        out.append((length, k0, k1, x, y, th))
        dx, dy = _advance(th, k0, k1, length, length)
        x, y = x + dx, y + dy
        th += (k0 + k1) / 2 * length
    return out


def perimeter(width: float, height: float, radius: float, transition: float) -> float:
    return sum(p[0] for p in path_pieces(width, height, radius, transition))


def path_poses(t, width, height, radius, transition, speed, start, mount_height):
    """(..., 4, 4) poses along the circuit at times `t`, starting `start`
    metres along it, computed in t's dtype: yaw along the path, no roll or
    pitch."""
    pieces = path_pieces(width, height, radius, transition)
    dt, dev = t.dtype, t.device
    col = [torch.tensor([p[i] for p in pieces], dtype=torch.float64) for i in range(6)]
    starts = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.float64), col[0][:-1]]), 0)
    total = float(col[0].sum())
    s = torch.remainder(t * speed + start, total)
    idx = torch.clamp(torch.bucketize(s.double().cpu(), starts, right=True) - 1,
                      0, len(pieces) - 1).to(dev)
    length, k0, k1, x0, y0, th0 = (c.to(device=dev, dtype=dt)[idx] for c in col)
    u = s - starts.to(device=dev, dtype=dt)[idx]
    dx, dy = _advance(th0, k0, k1, length, u)
    yaw = th0 + k0 * u + (k1 - k0) / (2 * length) * u * u
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    H = torch.zeros(t.shape + (4, 4), dtype=dt, device=dev)
    H[..., 0, 0], H[..., 0, 1] = cy, -sy
    H[..., 1, 0], H[..., 1, 1] = sy, cy
    H[..., 2, 2] = 1.0
    H[..., 3, 3] = 1.0
    H[..., 0, 3], H[..., 1, 3] = x0 + dx, y0 + dy
    H[..., 2, 3] = mount_height
    return H


def _street_side(rng, lo, hi, must_fit, out):
    """Buildings along one side of a street, in the street's own frame:
    (s0, s1, d0, d1, height, intensity) rows with s along the street and d
    outward from its line, appended to `out` (default_world's draws)."""
    s = lo
    while s < hi:
        depth = rng.uniform(6, 14)
        width = rng.uniform(8, 16)
        height = rng.uniform(4, 12)
        gap = rng.uniform(2, 8)
        setback = rng.uniform(7, 10)
        inten = rng.uniform(30, 60)
        if must_fit and s + width > hi:
            break
        out.append((s, s + width, setback, setback + depth, height, inten))
        s += width + gap


def make_circuit(traffic: dict, sensor: dict) -> Circuit:
    """The circuit of a traffic mix: its buildings and poles are drawn from
    the mix's own `world_seed`, so every run of a cell drives the same
    streets (the run's seed draws the range noise). `traffic` keys:
    block_m [width, height], corner_radius_m, transition_m, speed_mps,
    first_corner_m (the drive starts that far before its first corner),
    poles_per_m, world_seed;
    `sensor`: sweep_duration, mount_height."""
    rng = np.random.default_rng(int(traffic["world_seed"]))
    width, height = (float(v) for v in traffic["block_m"])
    r = float(traffic["corner_radius_m"])
    ease = float(traffic["transition_m"])
    T = _corner(r, ease)[1]         # where a street's straight part ends
    period = float(sensor["sweep_duration"])
    length = perimeter(width, height, r, ease)
    n_sweeps = max(1, round(length / float(traffic["speed_mps"]) / period))
    speed = length / (n_sweeps * period)
    start = (width - 2 * T) / 2 - float(traffic["first_corner_m"])
    w2, h2 = width / 2.0, height / 2.0
    # each street: its line's along-axis (0 = x, 1 = y), its fixed
    # coordinate, its outward sign, and its side length
    streets = [(0, -h2, -1.0, width), (1, w2, 1.0, height),
               (0, h2, 1.0, width), (1, -w2, -1.0, height)]
    boxes, binten, cyls, cinten = [], [], [], []
    for axis, fixed, sign, side in streets:
        rows_out, rows_in = [], []
        _street_side(rng, -side / 2 - 10.0, side / 2 + 10.0, False, rows_out)
        _street_side(rng, -side / 2 + T, side / 2 - T, True, rows_in)
        for rows, outward in ((rows_out, 1.0), (rows_in, -1.0)):
            for s0, s1, d0, d1, hgt, inten in rows:
                e0, e1 = fixed + sign * outward * d0, fixed + sign * outward * d1
                lo_d, hi_d = min(e0, e1), max(e0, e1)
                if axis == 0:
                    boxes.append((s0, lo_d, 0.0, s1, hi_d, hgt))
                else:
                    boxes.append((lo_d, s0, 0.0, hi_d, s1, hgt))
                binten.append(inten)
        n_poles = round(float(traffic["poles_per_m"]) * (side - 2 * T))
        for _ in range(n_poles):
            s = rng.uniform(-side / 2 + T, side / 2 - T)
            d = fixed + np.sign(rng.normal()) * rng.uniform(3.0, 6.0)
            cx, cy = (s, d) if axis == 0 else (d, s)
            cyls.append((cx, cy, rng.uniform(0.1, 0.25), 0.0, rng.uniform(3, 6)))
            cinten.append(rng.uniform(80, 120))
    return Circuit(boxes=np.asarray(boxes, np.float64), box_intensity=np.asarray(binten),
                   cylinders=np.asarray(cyls, np.float64), cyl_intensity=np.asarray(cinten),
                   ground_z=0.0, ground_intensity=20.0, width=width, height=height,
                   radius=r, transition=ease, speed=speed, start=start,
                   mount_height=float(sensor["mount_height"]), sweep_duration=period,
                   n_sweeps=int(n_sweeps))
