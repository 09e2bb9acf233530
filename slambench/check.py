"""The plain reference and the comparison that decides `correct`.

The reference is the drive itself: the sensor's pose at each sweep's stamp,
worked out in float64 from the traffic mix's circuit (`circuit.py`), the
same poses the ray caster rendered the sweeps from. It imports neither the
program nor JAX and takes nothing the program made. The program's answers
are the poses `add_frame` (live) or `flush` (log) returned. Only motions
between sweeps are compared, so the frame each side starts in does not
matter.

Every sweep handed in during the window is judged, with its motion from
the sweep before it and over the 10 sweeps before it where those lie in
the window or are the last sweep before it. A pose is the product
of keypoint extraction, undistortion, the localization ICP (k-NN matches
and LM solve) and the map that earlier sweeps left, so each compared
number covers all of them:

- `step_m`, `step_deg`: the widest gap between a sweep's motion from the
  sweep before, as the program returned it, and the reference's motion
  (translation [m], rotation [deg]);
- `drift_m`: the same over 10 sweeps (one second of drive), which the map
  update carries;
- `missing`: sweeps handed in whose pose never came back or is not finite
  (exact: limit 0).

A run is correct when every number is within its limit.
"""

from __future__ import annotations

import numpy as np

DRIFT_SPAN = 10


def _inv(H):
    Hi = np.zeros_like(H)
    R = H[..., :3, :3]
    Rt = np.swapaxes(R, -1, -2)
    Hi[..., :3, :3] = Rt
    Hi[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, H[..., :3, 3])
    Hi[..., 3, 3] = 1.0
    return Hi


def motion_gaps(poses, ref, span: int):
    """(translation [m], rotation [deg]) gaps, for each k >= span, between
    the motion from sweep k - span to k in `poses` and in `ref` ((n, 4, 4)
    float64 each)."""
    if len(poses) <= span:
        return np.zeros(0), np.zeros(0)
    a = _inv(poses[:-span]) @ poses[span:]
    b = _inv(ref[:-span]) @ ref[span:]
    e = _inv(b) @ a
    trans = np.linalg.norm(e[:, :3, 3], axis=1)
    cos = np.clip((np.trace(e[:, :3, :3], axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return trans, np.degrees(np.arccos(cos))


def readings(poses, ref, first_judged: int) -> dict:
    """The compared numbers of a run. `poses` (n, 4, 4) holds the program's
    pose of every sweep from the run's first (NaN where none came back),
    `ref` the reference's at the same sweeps; sweeps from `first_judged` on
    were handed in during the window. Motions are judged from the last
    sweep before the window on: the warm-up's first sweeps, which build the
    map from nothing, are not the window's answers."""
    poses = np.asarray(poses, np.float64)
    ref = np.asarray(ref, np.float64)
    finite = np.isfinite(poses).all(axis=(1, 2))
    out = {"missing": int((~finite[first_judged:]).sum())}
    safe = np.where(finite[:, None, None], poses, ref)
    for span, keys in ((1, ("step_m", "step_deg")), (DRIFT_SPAN, ("drift_m", None))):
        t, r = motion_gaps(safe, ref, span)
        starts = np.arange(0, len(poses) - span)
        judged = starts >= first_judged - 1
        out[keys[0]] = float(t[judged].max()) if judged.any() else 0.0
        if keys[1]:
            out[keys[1]] = float(r[judged].max()) if judged.any() else 0.0
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every limit's number within it."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
