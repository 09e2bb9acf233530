"""GPS <-> local-frame conversion nodes (host-side stream utilities).

TPU-native equivalents of the reference's gps_conversions ROS package:

- `utm_to_gps`: inverse transverse-Mercator projection, the counterpart of
  `conversions.gps_to_utm` (ref OdomToGpsNode.cxx:84-91 via geodesy).
- `GpsToUtmConverter`: stateful GPSFix -> odometry stream converter with
  heading-from-motion estimation, distance-based smoothing, time-jump
  reset, zone/band tracking and origin-on-first-pose local framing
  (ref GpsToUtmNode.cxx:94-263, GpsToUtmNode.h:19-78).
- `odom_to_gps`: SLAM odometry pose -> GPSFix with ENU roll/pitch/dip and
  true-bearing track plus rotated covariance (ref OdomToGpsNode.cxx:50-135).

These are pure-numpy host utilities: they run in the ingest/export path,
never on the device, so there is nothing to jit.

A copy of `lidarslam_tpu/io/gps.py` (numpy on the host), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.io.conversions import (_K0, _WGS84_A, _WGS84_F, gps_to_utm)

_BANDS = "CDEFGHJKLMNPQRSTUVWX"


def _is_southern(band: str) -> bool:
    return band.upper() < "N"


def utm_to_gps(easting, northing, zone, band="N", alt=0.0):
    """UTM easting/northing (m) in `zone` -> (lat_deg, lon_deg, alt).

    Inverse of `conversions.gps_to_utm` (footpoint-latitude series,
    ~mm-accurate within a zone). `band` only decides the hemisphere; pass
    a latitude-band letter or 'N'/'S'."""
    x = np.asarray(easting, np.float64) - 500000.0
    y = np.asarray(northing, np.float64)
    if _is_southern(band):
        y = y - 10000000.0

    a, f = _WGS84_A, _WGS84_F
    e2 = f * (2 - f)
    e4, e6 = e2 * e2, e2 * e2 * e2
    ep2 = e2 / (1 - e2)
    e1 = (1 - np.sqrt(1 - e2)) / (1 + np.sqrt(1 - e2))

    M = y / _K0
    mu = M / (a * (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256))
    phi1 = (mu
            + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
            + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
            + (151 * e1**3 / 96) * np.sin(6 * mu)
            + (1097 * e1**4 / 512) * np.sin(8 * mu))

    sin1, cos1, tan1 = np.sin(phi1), np.cos(phi1), np.tan(phi1)
    C1 = ep2 * cos1**2
    T1 = tan1**2
    N1 = a / np.sqrt(1 - e2 * sin1**2)
    R1 = a * (1 - e2) / (1 - e2 * sin1**2) ** 1.5
    D = x / (N1 * _K0)

    lat = phi1 - (N1 * tan1 / R1) * (
        D**2 / 2
        - (5 + 3 * T1 + 10 * C1 - 4 * C1**2 - 9 * ep2) * D**4 / 24
        + (61 + 90 * T1 + 298 * C1 + 45 * T1**2 - 252 * ep2 - 3 * C1**2)
        * D**6 / 720)
    lon0 = np.deg2rad((np.asarray(zone, np.float64) - 1) * 6.0 - 180.0 + 3.0)
    lon = lon0 + (D - (1 + 2 * T1 + C1) * D**3 / 6
                  + (5 - 2 * C1 + 28 * T1 - 3 * C1**2 + 8 * ep2 + 24 * T1**2)
                  * D**5 / 120) / cos1
    return np.rad2deg(lat), np.rad2deg(lon), np.asarray(alt, np.float64)


def _rms95_to_var(rms95: float) -> float:
    """RMS error at 95% confidence -> variance (GpsToUtmNode.cxx:41)."""
    return rms95 * rms95 / 4.0


def _var_to_rms95(var: float) -> float:
    """Variance -> RMS error at 95% confidence (OdomToGpsNode.cxx:30)."""
    return float(np.sqrt(max(var, 0.0)) * 2.0)


def _smooth_with_distance(new, prev, dist):
    """Innovation-weighted blend: full trust after >= 0.5 m of motion
    (GpsToUtmNode.cxx:44-49) to avoid heading oscillation at low speed."""
    innovation = min(dist / 0.5, 1.0)
    return innovation * new + (1.0 - innovation) * prev


def _smooth_angle_with_distance(new, prev, dist):
    """Same innovation blend along the shortest arc — a heading pair
    straddling the +-pi seam (e.g. +3.13 / -3.13 rad, just south of due
    west) must blend to ~pi, not to the 0-rad midpoint."""
    innovation = min(dist / 0.5, 1.0)
    delta = (new - prev + np.pi) % (2.0 * np.pi) - np.pi
    a = prev + innovation * delta
    return float((a + np.pi) % (2.0 * np.pi) - np.pi)


class GpsToUtmConverter:
    """GPSFix stream -> UTM/local-map odometry stream.

    Feed fixes in time order through `process(fix)`; each call returns an
    odometry dict or None (when orientation must first be inferred from
    the NEXT position — the one-sample latency of the reference node).

    fix keys: lat, lon (deg), alt (m), stamp (s); optional roll, pitch,
    dip (deg, full orientation), track (deg true bearing), speed, climb
    (m/s), position_covariance ((3,3) ENU), err_roll/err_pitch/err_dip/
    err_speed/err_climb (RMS 95%).

    Output keys: stamp, frame ('utm' | 'map'), position (3,), quaternion
    (w,x,y,z), rpy (rad), covariance ((6,6)), zone, band, speed, climb,
    twist_covariance ((6,6)).

    Mirrors GpsToUtmNode.cxx:94-263; `origin_on_first_pose` re-expresses
    poses relative to the first received pose (frame 'map').
    """

    def __init__(self, origin_on_first_pose: bool = False,
                 time_offset: float = 0.0):
        self.origin_on_first_pose = bool(origin_on_first_pose)
        self.time_offset = float(time_offset)
        self.zone = None
        self.band = None
        self.first_pose = None        # (position (3,), R (3,3))
        self._prev_fix = None         # previous fix awaiting an orientation
        self._prev_pos = None         # its UTM position
        self._prev_rpy = None         # last motion-derived (roll, pitch, yaw)

    # -- internals ------------------------------------------------------
    def _utm(self, fix):
        e, n, zone, band = gps_to_utm(fix["lat"], fix["lon"])
        if (int(zone), str(band)) != (self.zone, self.band):
            self.zone, self.band = int(zone), str(band)
        return np.array([e, n, fix.get("alt", 0.0)], np.float64)

    def _emit(self, fix, position, rpy):
        R = se3.rpy_to_matrix(np.asarray(rpy, np.float64))
        frame = "utm"
        if self.origin_on_first_pose:
            if self.first_pose is None:
                self.first_pose = (position.copy(), R.copy())
            p0, R0 = self.first_pose
            # Xmap = H^-1 * Xenu with H the first pose's rotation about its
            # own position (GpsToUtmNode.cxx:194-209)
            position = R0.T @ (position - p0)
            R = R0.T @ R
            frame = "map"

        cov = np.zeros((6, 6), np.float64)
        pc = fix.get("position_covariance")
        if pc is not None:
            cov[:3, :3] = np.asarray(pc, np.float64).reshape(3, 3)
        cov[3, 3] = _rms95_to_var(fix.get("err_roll", 0.0))
        cov[4, 4] = _rms95_to_var(fix.get("err_pitch", 0.0))
        cov[5, 5] = _rms95_to_var(fix.get("err_dip", 0.0))
        tcov = np.zeros((6, 6), np.float64)
        tcov[0, 0] = _rms95_to_var(fix.get("err_speed", 0.0))
        tcov[2, 2] = _rms95_to_var(fix.get("err_climb", 0.0))

        return {
            "stamp": float(fix["stamp"]) + self.time_offset,
            "frame": frame,
            "position": position,
            "quaternion": se3.quat_from_matrix(R),
            "rpy": se3.matrix_to_rpy(R),
            "covariance": cov,
            "zone": self.zone,
            "band": self.band,
            "speed": float(fix.get("speed", 0.0)),
            "climb": float(fix.get("climb", 0.0)),
            "twist_covariance": tcov,
        }

    # -- public ---------------------------------------------------------
    def process(self, fix: dict):
        position = self._utm(fix)

        # full orientation present (GpsToUtmNode.cxx:102-107). Presence =
        # key supplied, so a measured 0.0 (level / due-east) still counts.
        if any(fix.get(k) is not None for k in ("roll", "pitch", "dip")):
            rpy = np.deg2rad([fix.get("roll") or 0.0, fix.get("pitch") or 0.0,
                              fix.get("dip") or 0.0])
            return self._emit(fix, position, rpy)

        # bearing only: true bearing (clockwise from north, deg) -> ENU
        # heading (counter-clockwise from east, rad) (cxx:110-114)
        if fix.get("track") is not None:
            yaw = np.deg2rad(90.0 - fix["track"])
            return self._emit(fix, position, (0.0, 0.0, yaw))

        # no orientation: derive heading/pitch from motion to the NEXT fix,
        # then emit the PREVIOUS fix (cxx:116-163)
        out = None
        prev = self._prev_fix
        if prev is not None and abs(fix["stamp"] - prev["stamp"]) > 1.0:
            self._prev_rpy = None          # time jump: reset the guess
        elif prev is not None:
            delta = position - self._prev_pos
            d = float(np.linalg.norm(delta))
            heading = float(np.arctan2(delta[1], delta[0]))
            pitch = float(-np.arcsin(delta[2] / d)) if d > 0 else 0.0
            if self._prev_rpy is not None:
                heading = _smooth_angle_with_distance(heading, self._prev_rpy[2], d)
                pitch = _smooth_with_distance(pitch, self._prev_rpy[1], d)
            self._prev_rpy = (0.0, pitch, heading)
            out = self._emit(prev, self._prev_pos, self._prev_rpy)
        self._prev_fix = dict(fix)
        self._prev_pos = position
        return out


def odom_to_gps(position, quaternion=None, rotation=None, covariance=None,
                zone=None, band="N", T_utm_from_odom=None):
    """SLAM odometry pose -> GPSFix dict (ref OdomToGpsNode.cxx:50-135).

    `T_utm_from_odom`: (4,4) transform from the odometry/map frame to the
    UTM grid (the tf lookup of the reference node; e.g. built from the
    first `GpsToUtmConverter` output). Defaults to identity (odometry
    already in UTM). `zone`/`band` locate the grid (take them from
    `GpsToUtmConverter.zone/band`).

    Returns {lat, lon, alt, roll, pitch, dip, track (deg),
    position_covariance (3,3), err_roll/err_pitch/err_dip (RMS 95%)}.
    """
    if zone is None:
        raise ValueError("UTM zone is unset — run GpsToUtmConverter first "
                         "or pass zone explicitly")
    position = np.asarray(position, np.float64)
    R = (se3.quat_to_matrix(np.asarray(quaternion, np.float64))
         if rotation is None else np.asarray(rotation, np.float64))
    if T_utm_from_odom is not None:
        T = np.asarray(T_utm_from_odom, np.float64)
        position = T[:3, :3] @ position + T[:3, 3]
        R = T[:3, :3] @ R
    else:
        T = np.eye(4)

    lat, lon, alt = utm_to_gps(position[0], position[1], zone, band,
                               alt=position[2])
    rpy = se3.matrix_to_rpy(R)
    dip = float(np.rad2deg(rpy[2]))   # ENU heading, CCW from east

    out = {
        "lat": float(lat), "lon": float(lon), "alt": float(alt),
        "roll": float(np.rad2deg(rpy[0])),
        "pitch": float(np.rad2deg(rpy[1])),
        "dip": dip,
        "track": 90.0 - dip,          # true bearing, CW from north
    }
    if covariance is not None:
        cov = np.asarray(covariance, np.float64).reshape(6, 6)
        Rt = T[:3, :3]
        rot6 = np.zeros((6, 6))
        rot6[:3, :3] = Rt
        rot6[3:, 3:] = Rt
        cov = rot6 @ cov @ rot6.T     # tf2::transformCovariance
        out["position_covariance"] = cov[:3, :3]
        out["err_roll"] = _var_to_rms95(cov[3, 3])
        out["err_pitch"] = _var_to_rms95(cov[4, 4])
        out["err_dip"] = _var_to_rms95(cov[5, 5])
    return out
