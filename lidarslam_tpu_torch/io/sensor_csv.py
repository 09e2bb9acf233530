"""External sensor CSV loading and vendor array identification (the port's
host copy of `lidarslam_tpu/io/sensor_csv.py`, whose package imports jax).

`load_sensor_csv` mirrors vtkSlam::SetSensorData
(paraview_wrapping/Plugin/vtkLidarSlam/vtkSlam.cxx:406-458): a delimited
text file with a header row; columns `time` + `odom` feed wheel-odometry
measurements, columns `time` + `acc_x`/`acc_y`/`acc_z` feed IMU gravity
measurements. Delimiters may be spaces, semicolons or commas.

`identify_input_arrays` names a vendor's per-point arrays from the field
names of a point cloud (vtkSlam::IdentifyInputArrays), and
`recommended_parameter_checks` gives vtkSlam's CheckKEParameter warnings
for that vendor. (The ParaView core, `paraview_plugin.py`, keeps its own
copy of the reference's form with calibration columns.)
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Sequence


def _parse_table(path: str) -> dict:
    """Header-keyed float columns from a space/semicolon/comma-separated
    text file (vtkDelimitedTextReader with " ;," delimiters)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines:
        return {}
    split = re.compile(r"[ ;,]+")
    header = [h for h in split.split(lines[0]) if h]
    cols = {h: [] for h in header}
    for ln in lines[1:]:
        vals = [v for v in split.split(ln) if v]
        if len(vals) != len(header):
            continue
        for h, v in zip(header, vals):
            cols[h].append(float(v))
    return cols


def load_sensor_csv(path: str, wheel_odom=None, imu=None) -> dict:
    """Feed a sensor CSV into the given manager objects.

    Args:
      path: CSV/whitespace table with a header line.
      wheel_odom: optional WheelOdometryManager — receives (time, odom) rows.
      imu: optional ImuManager — receives (time, [acc_x, acc_y, acc_z]) rows.

    Returns {"odometry": n_rows, "imu": n_rows} counts of loaded
    measurements (0 when the columns are absent)."""
    cols = _parse_table(path)
    n_odom = n_imu = 0
    if "time" in cols and "odom" in cols:
        for t, d in zip(cols["time"], cols["odom"]):
            if wheel_odom is not None:
                wheel_odom.add_measurement(t, d)
            n_odom += 1
    if ("time" in cols and "acc_x" in cols and "acc_y" in cols
            and "acc_z" in cols):
        for t, ax, ay, az in zip(cols["time"], cols["acc_x"], cols["acc_y"],
                                 cols["acc_z"]):
            if imu is not None:
                imu.add_measurement(t, [ax, ay, az])
            n_imu += 1
    return {"odometry": n_odom, "imu": n_imu}


class InputArrays(NamedTuple):
    """Identified per-point arrays of a vendor point cloud."""

    vendor: str                   # "velodyne" | "ouster" | "hesai"
    time: str                     # per-point time array name
    intensity: str                # intensity array name
    laser_id: str                 # ring / channel array name
    time_to_seconds: float        # multiply the time array by this
    calibration: Optional[str]    # vertical-angle calibration column, if any


_VENDORS = (
    InputArrays("velodyne", "adjustedtime", "intensity", "laser_id",
                1e-6, "verticalCorrection"),
    InputArrays("ouster", "Raw Timestamp", "Signal Photons", "Channel",
                1e-9, "Altitude Angles"),
    InputArrays("hesai", "Timestamp", "Intensity", "LaserID", 1.0, None),
)


def identify_input_arrays(field_names: Sequence[str],
                          calib_fields: Sequence[str] = ()) -> Optional[InputArrays]:
    """Auto-detect the LiDAR vendor from available array names
    (vtkSlam.cxx:574-601 order: Velodyne, then Ouster, then Hesai).
    Returns None when no vendor matches."""
    fields = set(field_names)
    calib = set(calib_fields)
    for v in _VENDORS:
        if {v.time, v.intensity, v.laser_id} <= fields:
            has_cal = v.calibration in calib if v.calibration else False
            return v._replace(calibration=v.calibration if has_cal else None)
    return None


def recommended_parameter_checks(vendor: str, extractor_cfg) -> list:
    """The CheckKEParameter warnings (vtkSlam.cxx:567-597): a list of
    human-readable suggestions when extractor settings look wrong for the
    detected vendor."""
    out = []
    if vendor == "velodyne":
        if not extractor_cfg.edge_intensity_gap_threshold < 100:
            out.append("Velodyne data: consider edge_intensity_gap_threshold < 100")
    elif vendor == "ouster":
        if not extractor_cfg.edge_intensity_gap_threshold >= 100:
            out.append("Ouster data: consider edge_intensity_gap_threshold >= 100")
        if not extractor_cfg.neighbor_width > 4:
            out.append("Ouster data: consider neighbor_width > 4")
    elif vendor == "hesai":
        if not extractor_cfg.edge_intensity_gap_threshold > 1e6:
            out.append("Hesai data: consider edge_intensity_gap_threshold > 1e6")
        if not extractor_cfg.neighbor_width > 4:
            out.append("Hesai data: consider neighbor_width > 4")
        if not extractor_cfg.min_distance_to_sensor < 1:
            out.append("Hesai data: consider min_distance_to_sensor < 1")
    return out
