"""Within-sweep motion undistortion (PyTorch port of
`lidarslam_tpu/ops/undistortion.py`).

The scan pose is interpolated between the previous and the current frame
poses, the BASE-frame motion over the sweep's [time0, time1] point-time range
is extracted, and every keypoint is warped by the slerp-interpolated
transform at its own time stamp (Slam.cxx:1271-1352 + MotionModel.h).

As in the JAX package, every refinement warps the *raw* keypoints by the
absolute interpolator of the current pose estimate (the reference re-warps
the already undistorted cloud incrementally, Slam.cxx:1336-1351), so the
warp is a pure function of the pose and lives inside the ICP loop.

`jinterpolate_pose` is also the streaming step's constant-velocity
extrapolation (Slam::InterpolateScanPose, Slam.cxx:1271-1285).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidarslam_tpu_torch.core import se3


class WarpParams(NamedTuple):
    """BASE-frame sweep motion: H(time0) = (q0, t0v), H(time1) = (q1, t1v)."""

    q0: torch.Tensor      # (4,) quaternion wxyz
    t0v: torch.Tensor     # (3,)
    q1: torch.Tensor      # (4,)
    t1v: torch.Tensor     # (3,)
    time0: torch.Tensor   # ()
    time1: torch.Tensor   # ()
    enabled: torch.Tensor  # () bool — False => identity warp


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


def compute_warp(prev_pose, cur_pose, t_prev, t_cur, time0, time1,
                 max_ratio) -> WarpParams:
    """BASE-frame within-sweep motion from the (prev, cur) pose pair:
    H_base(time) = cur_pose^-1 o interp(prev_pose, cur_pose)(t_cur + time),
    at the sweep's first and last point times (Slam.cxx:1322-1334). The
    times are () float32 tensors on the poses' device."""
    Rc, tc = se3.jpose_to_rt(cur_pose)

    def base_motion(time):
        Rw, tw = jinterpolate_pose(prev_pose, cur_pose, t_cur + time, t_prev, t_cur,
                                   max_ratio)
        return se3.jquat_from_matrix(Rc.T @ Rw), Rc.T @ (tw - tc)

    q0, t0v = base_motion(time0)
    q1, t1v = base_motion(time1)
    return WarpParams(q0=q0, t0v=t0v, q1=q1, t1v=t1v, time0=time0, time1=time1,
                      enabled=(time1 - time0) > 1e-6)


def identity_warp(device) -> WarpParams:
    one = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    zero = torch.zeros(3, device=device)
    return WarpParams(q0=one, t0v=zero, q1=one.clone(), t1v=zero.clone(),
                      time0=torch.zeros((), device=device),
                      time1=torch.ones((), device=device),
                      enabled=torch.zeros((), dtype=torch.bool, device=device))


def warp_points(xyz, times, w: WarpParams):
    """The per-point slerp warp p' = H(time_p) p, batched over (N, 3)."""
    span = torch.where(w.enabled, w.time1 - w.time0, 1.0)
    u = torch.clamp((times - w.time0) / span, -2.0, 3.0)
    n = xyz.shape[0]
    q = se3.jquat_slerp(w.q0.expand(n, 4), w.q1.expand(n, 4), u)
    R = se3.jquat_to_matrix(q)                                # (N, 3, 3)
    tv = w.t0v + u[:, None] * (w.t1v - w.t0v)
    out = torch.sum(R * xyz[:, None, :], dim=-1) + tv
    return torch.where(w.enabled, out, xyz)
