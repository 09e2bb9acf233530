"""Global rigid registration of two trajectories (SLAM <-> GPS).

Re-design of GlobalTrajectoriesRegistration.cxx:26-140: rough initial
alignment from trajectory endpoints (translation of first poses + rotation
mapping the first->last displacement vectors onto each other), refined by
point-to-point ICP over the position sequences (Kabsch best-fit per
iteration), with an optional no-roll constraint.

A copy of `lidarslam_tpu/backend/registration.py` (numpy only), so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from lidarslam_tpu_torch.core import se3


def _rotation_from_two_vectors(a, b):
    """Smallest rotation taking a onto b (Eigen Quaternion::FromTwoVectors)."""
    a = a / max(np.linalg.norm(a), 1e-12)
    b = b / max(np.linalg.norm(b), 1e-12)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # opposite: rotate pi around any orthogonal axis
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return se3.so3_exp(np.pi * axis)
    angle = np.arctan2(np.linalg.norm(v), c)
    return se3.so3_exp(angle * v / np.linalg.norm(v))


def _kabsch(src, dst):
    """Best-fit rigid transform mapping src points onto dst (4,4)."""
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    Hm = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(Hm)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


def _remove_roll(T):
    """Zero the roll component of the rotation (keep pitch/yaw),
    GlobalTrajectoriesRegistration.cxx:85-94 semantics."""
    rpy = se3.matrix_to_rpy(T[:3, :3])
    out = T.copy()
    out[:3, :3] = se3.rpy_to_matrix([0.0, rpy[1], rpy[2]])
    return out


def compute_transform_offset(from_positions, to_positions, no_roll=False,
                             max_iter=50, tol=1e-8):
    """(4,4) transform mapping `from_positions` onto `to_positions`
    (ComputeTransformOffset semantics: endpoints init + position ICP)."""
    src = np.asarray(from_positions, np.float64)
    dst = np.asarray(to_positions, np.float64)
    if len(src) < 2 or len(dst) < 2:
        raise ValueError("need at least 2 poses per trajectory")

    # rough init: first points coincide, first->last directions align
    R0 = _rotation_from_two_vectors(src[-1] - src[0], dst[-1] - dst[0])
    T = np.eye(4)
    T[:3, :3] = R0
    T[:3, 3] = dst[0] - R0 @ src[0]

    # nearest-neighbor distances in BLAS form: ||a-b||^2 = ||a||^2 + ||b||^2
    # - 2 a.b, one (N, M) GEMM per iteration instead of an (N, M, 3)
    # broadcast temp (the naive form cost ~10 s at 4096 poses — it was the
    # whole "PGO scaling" wall, not the graph solve)
    dst_n2 = np.sum(dst * dst, axis=1)
    prev_err = np.inf
    for _ in range(max_iter):
        moved = src @ T[:3, :3].T + T[:3, 3]
        d2 = (np.sum(moved * moved, axis=1)[:, None] + dst_n2[None, :]
              - 2.0 * (moved @ dst.T))
        nn = np.argmin(d2, axis=1)
        err = float(np.mean(np.maximum(d2[np.arange(len(src)), nn], 0.0)))
        T_new = _kabsch(src, dst[nn])
        if no_roll:
            T_new = _remove_roll(T_new)
        T = T_new
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T
