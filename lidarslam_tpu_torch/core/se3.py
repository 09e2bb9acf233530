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
    R, tv = interpolate_rt(H0[:3, :3], H0[:3, 3], H1[:3, :3], H1[:3, 3], _np.float64(t),
                           t0, t1)
    H = _np.eye(4)
    H[:3, :3] = R
    H[:3, 3] = tv
    return H


def interpolate_rt(R0, t0v, R1, t1v, t, t0, t1):
    """Linear translation + slerp rotation between (R0, t0v) at t0 and
    (R1, t1v) at t1, evaluated at times t (broadcastable); extrapolates
    outside [t0, t1] (MotionModel.h:115-124). Returns ((..., 3, 3), (..., 3))."""
    u = (_np.asarray(t) - t0) / (t1 - t0)
    q = _quat_slerp(_quat_from_matrix(_np.asarray(R0, _np.float64)),
                    _quat_from_matrix(_np.asarray(R1, _np.float64)), u)
    tv = _np.asarray(t0v) + u[..., None] * (_np.asarray(t1v) - _np.asarray(t0v))
    return _quat_to_matrix(q), tv


def rpy_to_matrix(rpy):
    return _rpy_to_matrix(_np.asarray(rpy, dtype=_np.float64))


def matrix_to_rpy(R):
    return _matrix_to_rpy(_np.asarray(R, dtype=_np.float64))


def quat_from_matrix(R):
    return _quat_from_matrix(_np.asarray(R, dtype=_np.float64))


def quat_to_matrix(q):
    return _quat_to_matrix(_np.asarray(q, dtype=_np.float64))


def hat(w):
    """(3,) -> (3, 3) skew-symmetric cross-product matrix."""
    w = _np.asarray(w, dtype=_np.float64)
    return _np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def so3_log(R):
    """Rotation matrix -> rotation vector (angle * axis)."""
    R = _np.asarray(R, dtype=_np.float64)
    c = _np.clip((_np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = _np.arccos(c)
    if theta < 1e-9:
        return _np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    if abs(_np.pi - theta) < 1e-6:
        # near pi: the axis from the symmetric part, signs from its first row
        A = (R + _np.eye(3)) / 2.0
        axis = _np.sqrt(_np.maximum(_np.diag(A), 0.0))
        if A[0, 1] < 0:
            axis[1] = -axis[1]
        if A[0, 2] < 0:
            axis[2] = -axis[2]
        return theta * axis / max(_np.linalg.norm(axis), 1e-12)
    v = _np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return theta / (2.0 * _np.sin(theta)) * v


def so3_exp(w):
    """Rotation vector -> rotation matrix (Rodrigues)."""
    w = _np.asarray(w, dtype=_np.float64)
    theta = _np.linalg.norm(w)
    W = hat(w)
    if theta < 1e-9:
        return _np.eye(3) + W
    return (_np.eye(3) + _np.sin(theta) / theta * W
            + (1 - _np.cos(theta)) / theta**2 * (W @ W))


def se3_log(H):
    """(4,4) isometry -> (6,) twist [rho, phi] with H = exp([rho, phi])."""
    H = _np.asarray(H, dtype=_np.float64)
    phi = so3_log(H[:3, :3])
    theta = _np.linalg.norm(phi)
    W = hat(phi)
    if theta < 1e-9:
        Vinv = _np.eye(3) - 0.5 * W
    else:
        Vinv = (_np.eye(3) - 0.5 * W
                + (1.0 / theta**2 - (1.0 + _np.cos(theta)) / (2.0 * theta * _np.sin(theta)))
                * (W @ W))
    return _np.concatenate([Vinv @ H[:3, 3], phi])


def se3_exp(xi):
    """(6,) twist [rho, phi] -> (4,4) isometry."""
    xi = _np.asarray(xi, dtype=_np.float64)
    rho, phi = xi[:3], xi[3:]
    theta = _np.linalg.norm(phi)
    W = hat(phi)
    R = so3_exp(phi)
    if theta < 1e-9:
        V = _np.eye(3) + 0.5 * W
    else:
        V = (_np.eye(3) + (1 - _np.cos(theta)) / theta**2 * W
             + (theta - _np.sin(theta)) / theta**3 * (W @ W))
    H = _np.eye(4)
    H[:3, :3] = R
    H[:3, 3] = V @ rho
    return H


def adjoint(H):
    """(4,4) -> (6,6) adjoint of SE(3) for [rho, phi] twist order."""
    H = _np.asarray(H, dtype=_np.float64)
    R = H[:3, :3]
    Ad = _np.zeros((6, 6))
    Ad[:3, :3] = R
    Ad[:3, 3:] = hat(H[:3, 3]) @ R
    Ad[3:, 3:] = R
    return Ad


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


def jquat_from_matrix(R):
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), 4-branch Shepperd
    evaluated on every branch and selected by mask."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-30))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2, q3)))
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=1e-30)


def jquat_to_matrix(q):
    """(..., 4) (w, x, y, z) unit quaternion -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def jquat_slerp(q0, q1, u):
    """Slerp between quaternions, shortest arc; u broadcastable (...,)."""
    u = u[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    # fall back to lerp for tiny angles
    small = sin_theta < 1e-6
    safe_sin = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / safe_sin)
    w1 = torch.where(small, u, torch.sin(u * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=1e-30)


def jinterpolate_rt(R0, t0v, R1, t1v, t, t0, t1):
    """Linear translation + slerp rotation between (R0, t0v) at t0 and
    (R1, t1v) at t1, evaluated at times t; extrapolates outside [t0, t1]
    (MotionModel.h:115-124)."""
    u = (t - t0) / (t1 - t0)
    q = jquat_slerp(jquat_from_matrix(R0), jquat_from_matrix(R1), u)
    return jquat_to_matrix(q), t0v + u[..., None] * (t1v - t0v)


# -----------------------------------------------------------------------------
# Batched SE(3) Lie ops (torch, branch-free): the building blocks of the
# device pose-graph backend (backend/posegraph_device.py). All accept leading
# batch dimensions and follow the input dtype (float64 for pose graphs).
# -----------------------------------------------------------------------------

def _eye_like(x, n: int, shape):
    return torch.eye(n, dtype=x.dtype, device=x.device).expand(shape)


def _bottom_row(top):
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, row.expand(top[..., :1, :].shape)], dim=-2)


def jhat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1)], dim=-2)


def jso3_log(R):
    """(..., 3, 3) -> (..., 3) rotation vectors, branch-free.

    Accurate for |theta| < pi - 1e-3 (pose-graph residuals and consecutive
    relative motions lie far inside); near pi the axis comes from the
    symmetric part, and the exact-pi axis ambiguity is not handled."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.acos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-5
    big = theta > _np.pi - 1e-3
    # theta / (2 sin theta); Taylor 0.5 + theta^2/12 near 0
    f = torch.where(small, 0.5 + theta * theta / 12.0,
                    theta / torch.clamp(2.0 * torch.sin(theta), min=1e-20))
    general = f[..., None] * v
    A = 0.5 * (R + _eye_like(R, 3, R.shape))
    diag = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp(diag, min=0.0)) * torch.where(v >= 0, 1.0, -1.0)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-12)
    return torch.where(big[..., None], theta[..., None] * axis, general)


def jso3_exp(w):
    """(..., 3) rotation vectors -> (..., 3, 3) matrices (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-40))
    W = jhat(w)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye_like(w, 3, W.shape) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def jse3_log(H):
    """(..., 4, 4) -> (..., 6) twists [rho, phi] (se3_log parity)."""
    phi = jso3_log(H[..., :3, :3])
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-40))
    W = jhat(phi)
    small = theta2 < 1e-12
    coef = torch.where(small, 1.0 / 12.0,
                       1.0 / torch.clamp(theta2, min=1e-40)
                       - (1.0 + torch.cos(theta))
                       / torch.clamp(2.0 * theta * torch.sin(theta), min=1e-20))
    Vinv = _eye_like(H, 3, W.shape) - 0.5 * W + coef[..., None, None] * (W @ W)
    rho = torch.einsum("...ij,...j->...i", Vinv, H[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def jse3_exp(xi):
    """(..., 6) twists [rho, phi] -> (..., 4, 4) isometries."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-40))
    W = jhat(phi)
    small = theta2 < 1e-12
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-40))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-40))
    V = _eye_like(xi, 3, W.shape) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return _bottom_row(torch.cat([jso3_exp(phi), t[..., None]], dim=-1))


def jhmat_inverse(H):
    """(..., 4, 4) isometry inverse."""
    Rt = H[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, H[..., :3, 3])
    return _bottom_row(torch.cat([Rt, ti[..., None]], dim=-1))


def jadjoint(H):
    """(..., 4, 4) -> (..., 6, 6) SE(3) adjoints for [rho, phi] order."""
    R = H[..., :3, :3]
    top = torch.cat([R, jhat(H[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)
