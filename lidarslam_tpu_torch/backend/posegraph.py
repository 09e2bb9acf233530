"""Pose-graph optimization back-end (g2o replacement).

Re-design of PoseGraphOptimization.cxx:112-285: the graph has one SE(3)
vertex per SLAM pose, an SE(3) relative-motion edge between consecutive poses
with information = inverse SLAM 6x6 covariance, and a 3-D GPS position prior
on each time-matched vertex (information = inverse GPS covariance) applied
through the GPS<->sensor calibration offset. GPS/SLAM association is by
closest timestamp (FindClosestSlamPose, 52-74); the initial estimate is the
trajectory rigidly aligned to GPS via backend/registration.

Instead of a generic sparse solver (g2o LM + BlockSolver_6_3), the chain +
unary structure is exploited directly: the Gauss-Newton Hessian is block
tridiagonal, solved exactly by block LDL forward/backward sweeps — the same
structure a multi-host Schur / cyclic-reduction split will shard in a later
round. Residuals use SE(3) twists with right perturbations.

A copy of `lidarslam_tpu/backend/posegraph.py` (numpy only), so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from lidarslam_tpu_torch.backend import registration
from lidarslam_tpu_torch.core import se3


@dataclass
class PoseGraphConfig:
    n_iterations: int = 50
    init_lambda: float = 1e-6
    function_tolerance: float = 1e-9
    # weight of the gauge prior on vertex 0 when no GPS edge exists
    gauge_weight: float = 1e4


def _closest(times: np.ndarray, t: float) -> int:
    return int(np.argmin(np.abs(times - t)))


def optimize_pose_graph(
    slam_poses: Sequence[np.ndarray],     # list of (4,4)
    slam_times: np.ndarray,               # (N,)
    slam_covariances: Sequence[np.ndarray],  # list of (6,6) in xyzrpy params
    gps_positions: Optional[np.ndarray] = None,   # (M, 3)
    gps_times: Optional[np.ndarray] = None,       # (M,)
    gps_covariances: Optional[np.ndarray] = None,  # (M, 3, 3)
    gps_to_sensor_offset: Optional[np.ndarray] = None,  # (4,4)
    config: PoseGraphConfig = PoseGraphConfig(),
    verbose: bool = False,
):
    """Returns (optimized_poses list[(4,4)], final_cost)."""
    N = len(slam_poses)
    X = [np.asarray(p, np.float64).copy() for p in slam_poses]
    slam_times = np.asarray(slam_times, np.float64)
    offset = np.eye(4) if gps_to_sensor_offset is None else np.asarray(gps_to_sensor_offset)

    has_gps = gps_positions is not None and len(gps_positions) >= 2
    if has_gps:
        gps_positions = np.asarray(gps_positions, np.float64)
        gps_times = np.asarray(gps_times, np.float64)
        if gps_covariances is None:
            gps_covariances = np.broadcast_to(np.eye(3) * 1e-2, (len(gps_positions), 3, 3))
        # initial rigid alignment of the trajectory onto GPS (145-149)
        positions = np.stack([(p @ offset)[:3, 3] for p in X])
        T = registration.compute_transform_offset(positions, gps_positions)
        X = [T @ p for p in X]
        # associate each GPS sample to its closest SLAM vertex
        gps_vertex = np.array([_closest(slam_times, t) for t in gps_times])

    # measured relative motions and their information matrices
    Z = [se3.hmat_inverse(slam_poses[i]) @ slam_poses[i + 1] for i in range(N - 1)]
    W_rel = []
    for i in range(N - 1):
        cov = np.asarray(slam_covariances[i + 1], np.float64)
        cov = cov + np.eye(6) * 1e-8
        W_rel.append(np.linalg.inv(cov))

    lam = config.init_lambda
    prev_cost = np.inf
    cost = np.inf
    for it in range(config.n_iterations):
        D = [np.zeros((6, 6)) for _ in range(N)]
        U = [np.zeros((6, 6)) for _ in range(N - 1)]
        b = [np.zeros(6) for _ in range(N)]
        cost = 0.0

        for i in range(N - 1):
            Hij = se3.hmat_inverse(X[i]) @ X[i + 1]
            e = se3.se3_log(se3.hmat_inverse(Z[i]) @ Hij)
            W = W_rel[i]
            Ji = -se3.adjoint(se3.hmat_inverse(Hij))
            # Jj ~ I (right perturbation of X_j, small-residual approximation)
            D[i] += Ji.T @ W @ Ji
            D[i + 1] += W
            U[i] += Ji.T @ W
            b[i] += Ji.T @ W @ e
            b[i + 1] += W @ e
            cost += float(e @ W @ e)

        if has_gps:
            for g, vi in enumerate(gps_vertex):
                R = X[vi][:3, :3]
                pred = (X[vi] @ offset)[:3, 3]
                e = pred - gps_positions[g]
                Wg = np.linalg.inv(np.asarray(gps_covariances[g]) + np.eye(3) * 1e-9)
                J = np.zeros((3, 6))
                J[:, :3] = R
                J[:, 3:] = -R @ se3.hat(offset[:3, 3])
                D[vi] += J.T @ Wg @ J
                b[vi] += J.T @ Wg @ e
                cost += float(e @ Wg @ e)
        else:
            # gauge prior on vertex 0
            D[0] += np.eye(6) * config.gauge_weight
            e0 = se3.se3_log(se3.hmat_inverse(slam_poses[0]) @ X[0])
            b[0] += config.gauge_weight * e0
            cost += config.gauge_weight * float(e0 @ e0)

        if verbose:
            print(f"[pgo] iter {it} cost {cost:.6e} lambda {lam:.1e}")
        if abs(prev_cost - cost) <= config.function_tolerance * max(cost, 1e-12):
            break
        prev_cost = cost

        for i in range(N):
            D[i] = D[i] + lam * np.diag(np.maximum(np.diag(D[i]), 1e-9))
        delta = _solve_block_tridiag(D, U, [-bi for bi in b])
        for i in range(N):
            X[i] = X[i] @ se3.se3_exp(delta[i])

    return X, cost


def _solve_block_tridiag(D, U, rhs):
    """Exact solve of the block-tridiagonal system via block LDL sweeps.

    D: list of (6,6) diagonal blocks, U[i]: block (i, i+1), rhs: list of (6,).
    """
    N = len(D)
    C = [None] * N
    G = [None] * (N - 1)
    y = [None] * N
    C[0] = D[0]
    y[0] = rhs[0]
    for i in range(1, N):
        G[i - 1] = np.linalg.solve(C[i - 1].T, U[i - 1]).T  # U^T C^-1
        C[i] = D[i] - G[i - 1] @ U[i - 1]
        y[i] = rhs[i] - G[i - 1] @ y[i - 1]
    x = [None] * N
    x[N - 1] = np.linalg.solve(C[N - 1], y[N - 1])
    for i in range(N - 2, -1, -1):
        x[i] = np.linalg.solve(C[i], y[i] - U[i] @ x[i + 1])
    return x


def save_g2o(path, poses, times=None, rel_information=None,
             gps_positions=None, gps_vertex=None, gps_information=None,
             gps_to_sensor_offset=None):
    """Dump the pose graph in g2o text format (PoseGraphOptimization.cxx:
    164-170 optional .g2o save): VERTEX_SE3:QUAT per SLAM pose, EDGE_SE3:QUAT
    between consecutive poses, fixed VERTEX_TRACKXYZ + EDGE_SE3_TRACKXYZ per
    GPS prior through the PARAMS_SE3OFFSET GPS<->sensor calibration."""
    N = len(poses)
    offset = np.eye(4) if gps_to_sensor_offset is None \
        else np.asarray(gps_to_sensor_offset, np.float64)
    lines = []
    oq = se3.quat_from_matrix(offset[:3, :3])  # (w, x, y, z)
    ot = offset[:3, 3]
    lines.append("PARAMS_SE3OFFSET 0 "
                 f"{ot[0]:.9f} {ot[1]:.9f} {ot[2]:.9f} "
                 f"{oq[1]:.9f} {oq[2]:.9f} {oq[3]:.9f} {oq[0]:.9f}")
    for i, P in enumerate(poses):
        q = se3.quat_from_matrix(np.asarray(P)[:3, :3])
        t = np.asarray(P)[:3, 3]
        lines.append(f"VERTEX_SE3:QUAT {i} "
                     f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                     f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}")
    iu = np.triu_indices(6)
    for i in range(N - 1):
        Z = se3.hmat_inverse(np.asarray(poses[i])) @ np.asarray(poses[i + 1])
        q = se3.quat_from_matrix(Z[:3, :3])
        t = Z[:3, 3]
        W = np.eye(6) if rel_information is None else np.asarray(rel_information[i])
        info = " ".join(f"{v:.9f}" for v in W[iu])
        lines.append(f"EDGE_SE3:QUAT {i} {i + 1} "
                     f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                     f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f} {info}")
    if gps_positions is not None and gps_vertex is not None:
        iu3 = np.triu_indices(3)
        for g, (p, vi) in enumerate(zip(np.asarray(gps_positions), gps_vertex)):
            pid = N + g
            lines.append(f"VERTEX_TRACKXYZ {pid} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f}")
            lines.append(f"FIX {pid}")
            # measurement = GPS point expressed in the (offset-corrected)
            # sensor frame of its matched vertex
            H = np.asarray(poses[int(vi)]) @ offset
            local = se3.hmat_inverse(H)[:3, :3] @ (p - H[:3, 3])
            Wg = np.eye(3) if gps_information is None else np.asarray(gps_information[g])
            info = " ".join(f"{v:.9f}" for v in Wg[iu3])
            lines.append(f"EDGE_SE3_TRACKXYZ {int(vi)} {pid} 0 "
                         f"{local[0]:.9f} {local[1]:.9f} {local[2]:.9f} {info}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
