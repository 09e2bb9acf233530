"""Sensor adaptation: vendor point clouds -> engine frames, GPS -> UTM.

Host-side equivalents of the reference's conversion nodes
(ros_wrapping/lidar_conversions + gps_conversions):

- `velodyne_to_frame`: ring ids map straight to laser_id; missing per-point
  times are synthesized from azimuth advancement within the sweep
  (VelodyneToLidarNode.cxx:53-112 + SpinningFrameAdvancementEstimator,
  lidar_conversions/Utilities.h:59-113);
- `robosense_to_frame`: NaN filtering, duplicate (dual-return) removal,
  laser-id remapping, same time synthesis (RobosenseToLidarNode.cxx:29-146);
- `gps_to_utm`: WGS84 lat/lon -> UTM easting/northing/zone
  (GpsToUtmNode semantics).

A copy of `lidarslam_tpu/io/conversions.py` (numpy on the host), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# RoboSense RS16 laser-id -> bottom-up ring remap, the exact table the
# reference ships (RobosenseToLidarNode.cxx:32): lasers 0-7 fire the lower
# bank bottom-up (-15..-1 deg), lasers 8-15 the upper bank top-down
# (+15..+1 deg).
RS16_RING_REMAP = np.array([0, 1, 2, 3, 4, 5, 6, 7, 15, 14, 13, 12, 11, 10, 9, 8])


def estimate_frame_advancement(xyz):
    """Per-point sweep advancement in [0, 1) from azimuth rotation.

    Assumes a sensor spinning around +Z at constant rate within the sweep;
    advancement is the (unwrapped) angle swept since the first point."""
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    rel = az[0] - az  # clockwise spin advances -azimuth
    rel = np.mod(rel, 2 * np.pi)
    # unwrap regressions caused by multi-ring interleaving: enforce a
    # monotonically increasing envelope
    adv = np.maximum.accumulate(rel) / (2 * np.pi)
    return np.minimum(adv, 0.999999)


def velodyne_to_frame(xyz, intensity, ring, stamp, time=None, sweep_duration=0.1,
                      device_id=0, seq=None):
    """Velodyne-style cloud -> engine frame dict."""
    xyz = np.asarray(xyz, np.float32)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    intensity = np.asarray(intensity, np.float32)[finite]
    ring = np.asarray(ring, np.int64)[finite]
    if time is None:
        time = estimate_frame_advancement(xyz) * sweep_duration
    else:
        time = np.asarray(time, np.float64)[finite]
    out = {"xyz": xyz, "intensity": intensity, "laser_id": ring,
           "time": time.astype(np.float32), "stamp": float(stamp),
           "device_id": device_id}
    if seq is not None:
        out["seq"] = int(seq)
    return out


def robosense_to_frame(xyz, intensity, ring, stamp, sweep_duration=0.1,
                       ring_remap=None, vertical_angles=None, device_id=0,
                       seq=None, n_lasers=None):
    """RoboSense-style cloud -> engine frame: drop NaNs and dual-return
    duplicates, remap rings bottom-up, synthesize times.

    Remap resolution mirrors RobosenseToLidarNode.cxx:104-109: an explicit
    `ring_remap` wins; else the RS16 table applies iff the cloud has 16
    lasers; else identity. `vertical_angles` (per-laser, firing order)
    derives the remap data-driven for other models (RS32/RSBPEARL — the
    reference leaves these as a TODO, RobosenseToLidarNode.cxx:31).

    `n_lasers` is the sensor's structural laser count (the reference uses
    the organized cloud's height, not the data max). Pass it when known:
    inferring it from `ring.max()+1` mis-gates the RS16 remap on frames
    where the top beam has no valid return."""
    xyz = np.asarray(xyz, np.float64)
    intensity = np.asarray(intensity, np.float32)
    ring = np.asarray(ring, np.int64)
    finite = np.isfinite(xyz).all(axis=1)
    xyz, intensity, ring = xyz[finite], intensity[finite], ring[finite]
    # dual-return dedup: drop a point identical to its predecessor
    if len(xyz) > 1:
        same = np.all(np.abs(np.diff(xyz, axis=0)) < 1e-9, axis=1)
        keep = np.concatenate([[True], ~same])
        xyz, intensity, ring = xyz[keep], intensity[keep], ring[keep]
    if n_lasers is None:
        n_lasers = int(ring.max()) + 1 if len(ring) else 0
    if ring_remap is None and vertical_angles is not None:
        ring_remap = laser_id_mapping(vertical_angles)
    if ring_remap is None and n_lasers == 16:
        ring_remap = RS16_RING_REMAP
    if ring_remap is not None:
        ring = np.asarray(ring_remap)[np.clip(ring, 0, len(ring_remap) - 1)]
    time = estimate_frame_advancement(xyz) * sweep_duration
    out = {"xyz": xyz.astype(np.float32), "intensity": intensity,
           "laser_id": ring, "time": time.astype(np.float32),
           "stamp": float(stamp), "device_id": device_id}
    if seq is not None:
        out["seq"] = int(seq)
    return out


def leishen_to_frame(xyz, intensity, ring, stamp, time=None,
                     sweep_duration=0.1, vertical_angles=None, device_id=0,
                     seq=None):
    """Leishen (LSC32) cloud -> engine frame (validated-sensor parity,
    reference README.md:42 — the reference ships no Leishen conversion
    node, so this follows its Velodyne node semantics): NaN filter,
    per-point time from the cloud or synthesized from azimuth advancement,
    optional bottom-up ring remap from the sensor's firing-order vertical
    angles (the LSC32 interleaves its two banks, so the raw ring field is
    not height-ordered)."""
    xyz = np.asarray(xyz, np.float32)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    intensity = np.asarray(intensity, np.float32)[finite]
    ring = np.asarray(ring, np.int64)[finite]
    if vertical_angles is not None:
        mapping = laser_id_mapping(vertical_angles)
        ring = mapping[np.clip(ring, 0, len(mapping) - 1)]
    if time is None:
        time = estimate_frame_advancement(xyz) * sweep_duration
    else:
        time = np.asarray(time, np.float64)[finite]
    out = {"xyz": xyz, "intensity": intensity, "laser_id": ring,
           "time": time.astype(np.float32), "stamp": float(stamp),
           "device_id": device_id}
    if seq is not None:
        out["seq"] = int(seq)
    return out


# -----------------------------------------------------------------------------
# Vendor array autodetection (vtkSlam::IdentifyInputArrays, vtkSlam.cxx:531-612)
# -----------------------------------------------------------------------------

# vendor -> ((time, intensity, laser_id) array names, time->seconds factor,
#            vertical-calibration array name or None)
VENDOR_TABLE = (
    ("velodyne", ("adjustedtime", "intensity", "laser_id"), 1e-6,
     "verticalCorrection"),
    ("ouster", ("Raw Timestamp", "Signal Photons", "Channel"), 1e-9,
     "Altitude Angles"),
    ("hesai", ("Timestamp", "Intensity", "LaserID"), 1.0, None),
)


def identify_vendor(arrays):
    """Detect the LiDAR vendor from the available per-point array names.

    `arrays`: mapping of array name -> array (the polydata point-data
    analog). Returns (vendor, (time, intensity, laser_id) names, factor,
    calib_name) or raises ValueError — exactly the vtkSlam autodetect
    cascade (Velodyne us / Ouster ns / Hesai s)."""
    for vendor, names, factor, calib in VENDOR_TABLE:
        if all(n in arrays for n in names):
            return vendor, names, factor, calib
    raise ValueError(
        f"unable to identify LiDAR arrays among {sorted(arrays)}; expected "
        "Velodyne (adjustedtime/intensity/laser_id), Ouster (Raw Timestamp/"
        "Signal Photons/Channel) or Hesai (Timestamp/Intensity/LaserID)")


def laser_id_mapping(vertical_angles):
    """laser_id -> bottom-up ring rank from per-laser vertical angles
    (vtkSlam::GetLaserIdMapping role)."""
    angles = np.asarray(vertical_angles, np.float64)
    return np.argsort(np.argsort(angles))


def autodetect_frame(xyz, arrays, calibration=None, device_id=0, seq=None):
    """Vendor-shaped arrays -> engine frame dict, with the vtkSlam ingest
    semantics (IdentifyInputArrays + PolyDataToPointCloud, vtkSlam.cxx:
    531-612, 668-707): vendor detected from array names; per-vendor
    time-unit factor; frame stamp = frame-END time in seconds; per-point
    times rebased to it (<= 0); all-zero-coordinate points dropped; laser
    ids remapped bottom-up when a vertical calibration table is given.

    `calibration`: optional mapping holding the vendor's vertical-angle
    array (e.g. {"Altitude Angles": (...)}) or a plain angle array."""
    vendor, (t_name, i_name, l_name), factor, calib_name = identify_vendor(arrays)
    xyz = np.asarray(xyz, np.float64)
    raw_t = np.asarray(arrays[t_name], np.float64)
    inten = np.asarray(arrays[i_name], np.float32)
    lid = np.asarray(arrays[l_name], np.int64)

    keep = np.any(xyz != 0.0, axis=1)
    xyz, raw_t, inten, lid = xyz[keep], raw_t[keep], inten[keep], lid[keep]

    if calibration is not None and calib_name is not None:
        angles = calibration.get(calib_name) if hasattr(calibration, "get") \
            else calibration
        if angles is not None:
            mapping = laser_id_mapping(angles)
            # ids outside the calibration table are corrupt: drop those
            # points rather than silently folding them into an edge ring
            ok = (lid >= 0) & (lid < len(mapping))
            xyz, raw_t, inten, lid = xyz[ok], raw_t[ok], inten[ok], lid[ok]
            lid = mapping[lid]

    frame_end = float(raw_t.max()) if len(raw_t) else 0.0
    out = {"xyz": xyz.astype(np.float32), "intensity": inten,
           "laser_id": lid,
           "time": ((raw_t - frame_end) * factor).astype(np.float32),
           "stamp": frame_end * factor, "device_id": device_id,
           "vendor": vendor}
    if seq is not None:
        out["seq"] = int(seq)
    return out


def advise_extractor_params(vendor, extractor_cfg):
    """Per-vendor extractor-parameter advice (the CheckKEParameter warnings
    at SLAM init, vtkSlam.cxx:567-596). Returns a list of warning strings."""
    w = []
    e = extractor_cfg
    if vendor == "velodyne" and not (e.edge_intensity_gap_threshold < 100):
        w.append("velodyne data: consider edge_intensity_gap_threshold < 100")
    if vendor == "ouster":
        if not (e.edge_intensity_gap_threshold >= 100):
            w.append("ouster data: consider edge_intensity_gap_threshold >= 100")
        if not (e.neighbor_width > 4):
            w.append("ouster data: consider neighbor_width > 4")
    if vendor == "hesai":
        if not (e.edge_intensity_gap_threshold > 1e6):
            w.append("hesai data: consider edge_intensity_gap_threshold > 1e6")
        if not (e.neighbor_width > 4):
            w.append("hesai data: consider neighbor_width > 4")
        if not (e.min_distance_to_sensor < 1):
            w.append("hesai data: consider min_distance_to_sensor < 1")
    return w


# -----------------------------------------------------------------------------
# WGS84 -> UTM
# -----------------------------------------------------------------------------

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_K0 = 0.9996


def gps_to_utm(lat_deg, lon_deg, alt=0.0):
    """Lat/lon (degrees) -> (easting [m], northing [m], zone, band letter).

    Transverse-Mercator series expansion (the conversion GpsToUtmNode
    performs via GeographicLib), accurate to ~mm within a zone."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.asarray(lon_deg, np.float64)
    zone = (np.floor((lon + 180.0) / 6.0).astype(int) % 60) + 1
    lon0 = np.deg2rad((zone - 1) * 6.0 - 180.0 + 3.0)
    lon = np.deg2rad(lon)

    a = _WGS84_A
    f = _WGS84_F
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    n_lat = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    T = np.tan(lat) ** 2
    C = ep2 * np.cos(lat) ** 2
    A = (lon - lon0) * np.cos(lat)

    e4, e6 = e2 * e2, e2 * e2 * e2
    M = a * ((1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * lat
             - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * lat)
             + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * lat)
             - (35 * e6 / 3072) * np.sin(6 * lat))

    easting = _K0 * n_lat * (A + (1 - T + C) * A**3 / 6
                             + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * A**5 / 120) + 500000.0
    northing = _K0 * (M + n_lat * np.tan(lat) * (
        A**2 / 2 + (5 - T + 9 * C + 4 * C**2) * A**4 / 24
        + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * A**6 / 720))
    northing = np.where(lat < 0, northing + 10000000.0, northing)

    bands = "CDEFGHJKLMNPQRSTUVWX"
    band_idx = np.clip(((np.rad2deg(lat) + 80) // 8).astype(int), 0, len(bands) - 1)
    band = bands[int(band_idx)] if np.ndim(band_idx) == 0 else \
        [bands[i] for i in np.atleast_1d(band_idx)]
    return easting, northing, zone, band
