"""SE(3) pose math with the reference's exact conventions (PyTorch port of
`lidarslam_tpu/core/se3.py`).

The pose parameterization is the 6-vector [x, y, z, rX, rY, rZ] with
R = Rz(rZ) @ Ry(rY) @ Rx(rX)  (Utilities.cxx:33-38) and the stable Euler
decomposition with ranges [-pi,pi] x [-pi/2,pi/2] x [-pi,pi]
(Utilities.cxx:41-59):

    rX = atan2(R21, R22);  rY = -asin(R20);  rZ = atan2(R10, R00)

Two families, as in the JAX package:
- numpy float64 helpers without prefix (host trajectory bookkeeping);
- torch helpers with a ``j`` prefix (device float32), named after their
  jax.numpy counterparts so a reader finds each one.
"""

from __future__ import annotations

import numpy as _np
import torch

# -----------------------------------------------------------------------------
# numpy (host, float64)
# -----------------------------------------------------------------------------


def _rpy_to_matrix(rpy):
    """(..., 3) roll/pitch/yaw -> (..., 3, 3) with R = Rz @ Ry @ Rx."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = _np.cos(r), _np.sin(r)
    cp, sp = _np.cos(p), _np.sin(p)
    cy, sy = _np.cos(y), _np.sin(y)
    row0 = _np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = _np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = _np.stack([-sp, cp * sr, cp * cr], axis=-1)
    return _np.stack([row0, row1, row2], axis=-2)


def _matrix_to_rpy(R):
    rx = _np.arctan2(R[..., 2, 1], R[..., 2, 2])
    ry = -_np.arcsin(_np.clip(R[..., 2, 0], -1.0, 1.0))
    rz = _np.arctan2(R[..., 1, 0], R[..., 0, 0])
    return _np.stack([rx, ry, rz], axis=-1)


def _quat_from_matrix(R):
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), 4-branch Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return _np.sqrt(_np.maximum(v, 1e-30))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = _np.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = _np.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = _np.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = _np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = _np.where(use0, q0, _np.where(use1, q1, _np.where(use2, q2, q3)))
    norm = _np.sqrt(_np.sum(q * q, axis=-1, keepdims=True))
    return q / _np.maximum(norm, 1e-30)


def _quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = _np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1)
    row1 = _np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1)
    row2 = _np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1)
    return _np.stack([row0, row1, row2], axis=-2)


def _quat_slerp(q0, q1, u):
    """Slerp between quaternions, shortest arc; u broadcastable (...,)."""
    u = _np.asarray(u)[..., None]
    dot = _np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = _np.where(dot < 0.0, -q1, q1)
    dot = _np.clip(_np.abs(dot), -1.0, 1.0)
    theta = _np.arccos(dot)
    sin_theta = _np.sin(theta)
    small = sin_theta < 1e-6
    w0 = _np.where(small, 1.0 - u, _np.sin((1.0 - u) * theta) / _np.where(small, 1.0, sin_theta))
    w1 = _np.where(small, u, _np.sin(u * theta) / _np.where(small, 1.0, sin_theta))
    q = w0 * q0 + w1 * q1
    norm = _np.sqrt(_np.sum(q * q, axis=-1, keepdims=True))
    return q / _np.maximum(norm, 1e-30)


def pose_to_rt(pose):
    pose = _np.asarray(pose, dtype=_np.float64)
    return _rpy_to_matrix(pose[..., 3:6]), pose[..., 0:3]


def rt_to_pose(R, t):
    return _np.concatenate([_np.asarray(t), _matrix_to_rpy(_np.asarray(R))], axis=-1)


def pose_to_hmat(pose):
    """(6,) xyzrpy -> (4, 4) homogeneous matrix."""
    R, t = pose_to_rt(pose)
    H = _np.eye(4)
    H[:3, :3] = R
    H[:3, 3] = t
    return H


def hmat_to_pose(H):
    H = _np.asarray(H, dtype=_np.float64)
    return rt_to_pose(H[:3, :3], H[:3, 3])


def hmat_inverse(H):
    H = _np.asarray(H, dtype=_np.float64)
    Hi = _np.eye(4)
    R = H[:3, :3]
    Hi[:3, :3] = R.T
    Hi[:3, 3] = -R.T @ H[:3, 3]
    return Hi


def interpolate_hmat(H0, H1, t, t0=0.0, t1=1.0):
    """Interpolate/extrapolate between two (4,4) isometries: linear
    translation + quaternion slerp (MotionModel.h:115-124). Returns H0 when
    t0==t1 or H0~H1."""
    H0 = _np.asarray(H0, dtype=_np.float64)
    H1 = _np.asarray(H1, dtype=_np.float64)
    if abs(t1 - t0) < 1e-12 or _np.allclose(H0, H1, atol=1e-12):
        return H0.copy()
    u = (_np.float64(t) - t0) / (t1 - t0)
    q = _quat_slerp(_quat_from_matrix(H0[:3, :3]), _quat_from_matrix(H1[:3, :3]), u)
    H = _np.eye(4)
    H[:3, :3] = _quat_to_matrix(q)
    H[:3, 3] = H0[:3, 3] + u * (H1[:3, 3] - H0[:3, 3])
    return H


# -----------------------------------------------------------------------------
# torch (device, float32)
# -----------------------------------------------------------------------------

def jrpy_to_matrix(rpy):
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def jmatrix_to_rpy(R):
    rx = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    ry = -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    rz = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([rx, ry, rz], dim=-1)


def jpose_to_rt(pose):
    """(..., 6) xyzrpy -> ((..., 3, 3) rotation, (..., 3) translation)."""
    return jrpy_to_matrix(pose[..., 3:6]), pose[..., 0:3]


def jrt_to_pose(R, t):
    return torch.cat([t, jmatrix_to_rpy(R)], dim=-1)


def japply_pose(pose, pts):
    """Apply (6,) xyzrpy pose to (..., 3) points."""
    R, t = jpose_to_rt(pose)
    return pts @ R.T + t


def jcompose_pose(pose_a, pose_b):
    """Pose of (A @ B) where A, B are xyzrpy 6-vectors."""
    Ra, ta = jpose_to_rt(pose_a)
    Rb, tb = jpose_to_rt(pose_b)
    return jrt_to_pose(Ra @ Rb, Ra @ tb + ta)
