"""External sensor CSV loading (the port's copy of `load_sensor_csv` from
`lidarslam_tpu/io/sensor_csv.py`, whose package imports jax; the vendor
array identification there waits for the front ends, ROADMAP item 22).

`load_sensor_csv` mirrors vtkSlam::SetSensorData
(paraview_wrapping/Plugin/vtkLidarSlam/vtkSlam.cxx:406-458): a delimited
text file with a header row; columns `time` + `odom` feed wheel-odometry
measurements, columns `time` + `acc_x`/`acc_y`/`acc_z` feed IMU gravity
measurements. Delimiters may be spaces, semicolons or commas.
"""

from __future__ import annotations

import re


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
