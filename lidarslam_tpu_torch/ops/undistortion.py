"""Device pose interpolation (PyTorch port of the part of
`lidarslam_tpu/ops/undistortion.py` that the streaming step uses).

`jinterpolate_pose` is the in-graph constant-velocity extrapolation of the
streaming step (Slam::InterpolateScanPose, Slam.cxx:1271-1285). The sweep
warp itself (`WarpParams`, `compute_warp`, `warp_points`) and the ONCE /
REFINED undistortion modes are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from lidarslam_tpu_torch.core import se3


def jinterpolate_pose(pose_a, pose_b, t, ta, tb, max_ratio):
    """Interpolate/extrapolate between xyzrpy poses at times ta, tb.

    Returns pose_b's (R, t) when extrapolating farther than `max_ratio`
    spans or when the time base is degenerate."""
    Ra, tva = se3.jpose_to_rt(pose_a)
    Rb, tvb = se3.jpose_to_rt(pose_b)
    span = tb - ta
    degenerate = torch.abs(span) < 1e-9
    safe_span = torch.where(degenerate, 1.0, span)
    R, tv = se3.jinterpolate_rt(Ra, tva, Rb, tvb, t, tb - safe_span, tb)
    bad = degenerate | (torch.abs((t - tb) / safe_span) > max_ratio)
    return torch.where(bad, Rb, R), torch.where(bad, tvb, tv)
