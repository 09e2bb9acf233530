"""Batched robust Levenberg-Marquardt registration solver (PyTorch port of
`lidarslam_tpu/ops/solver.py`).

- residuals e_i = A_i (R(rpy) X_i + t - P_i) with analytic 3x6 Jacobians
  (dR/d(rpy) in the reference's Rz·Ry·Rx convention);
- Tukey robust loss at scale `saturation` as IRLS weights (1 - s/a^2)^2,
  scaled by each match's fit-quality weight;
- normal equations H = sum w J^T J (6x6), g = sum w J^T e;
- the LM loop runs a fixed `lm_max_iter` trips whose updates are gated by
  `where` once converged — the JAX package's own unrolled form
  (`SolverConfig.lm_unroll`), equivalent to its `while_loop` — so it costs
  no host sync per LM step. `n_success` starts at 1 (the initial
  evaluation), for the ICP loop's gate on `n_success == 1`;
- sensor residual blocks (`extras`: wheel odometry, IMU gravity) add plain
  scaled least squares to every evaluation; an invalid block's weight is 0,
  so it adds exactly nothing;
- pose covariance = pseudo-inverse of the robust Gauss-Newton Hessian,
  by a fixed-sweep Jacobi eigendecomposition (no host sync).

The JAX package pins the match blocks with `lax.optimization_barrier` so XLA
does not sink the matcher into the LM loop; eager PyTorch evaluates them
once, so there is nothing to pin.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from lidarslam_tpu_torch.config import SolverConfig
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops.matcher import Matches
from lidarslam_tpu_torch.sensors.constraints import GravityResidual, OdomResidual


def tukey_rho(s, a):
    """Ceres TukeyLoss on squared residual s (KeypointsMatcher.cxx:85-89)."""
    a2 = a * a
    u = torch.clamp(1.0 - s / a2, 0.0, 1.0)
    return a2 / 3.0 * (1.0 - u * u * u)


def tukey_weight(s, a):
    """d rho / d s — the IRLS weight."""
    u = torch.clamp(1.0 - s / (a * a), 0.0, 1.0)
    return u * u


def rotation_derivatives(rpy):
    """dR/d(roll, pitch, yaw) for R = Rz(y) Ry(p) Rx(r), as (3, 3, 3)."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    o, z = torch.ones_like(r), torch.zeros_like(r)

    def m(rows):
        return torch.stack([torch.stack(row) for row in rows])

    Rx = m([[o, z, z], [z, cr, -sr], [z, sr, cr]])
    Ry = m([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    Rz = m([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    dRx = m([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    dRy = m([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    dRz = m([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    return torch.stack([Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx])


class _Block(NamedTuple):
    """Loop-invariant per-match inputs of `_evaluate`, built once per solve."""

    A: torch.Tensor   # (Q, 3, 3) dense symmetric A
    X: torch.Tensor   # (Q, 3)
    P: torch.Tensor   # (Q, 3)
    w: torch.Tensor   # (Q,) fit weight, 0 where invalid


def _block(m: Matches) -> _Block:
    return _Block(A=m.A, X=m.X, P=m.P, w=torch.where(m.valid, m.weight, 0.0))


def _extra_terms(extras, R, t, dRs):
    """Cost, H and g of the sensor residual blocks at the pose (R, t) with
    rotation derivatives dRs: plain scaled least squares, no robust loss,
    as the reference's ScaledLoss(NULL, weight) (SensorConstraints.cxx)."""
    dev = t.device
    H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    g = torch.zeros((6,), dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    zeros3 = torch.zeros(3, dtype=torch.float32, device=dev)
    for ex in extras:
        w = torch.where(ex.valid, ex.weight, 0.0)
        if isinstance(ex, OdomResidual):
            m = t - ex.prev_pos
            sq = torch.sum(m * m)
            norm = torch.sqrt(torch.clamp(sq, min=1e-12))
            e = torch.where(sq < 1e-6, 0.0, norm) - ex.distance
            J = torch.cat([torch.where(sq < 1e-6, zeros3, m / norm), zeros3])
            H = H + w * torch.outer(J, J)
            g = g + w * J * e
            cost = cost + w * e * e
        elif isinstance(ex, GravityResidual):
            e = R @ ex.g_cur - ex.g_ref
            Jr = torch.stack([dRs[0] @ ex.g_cur, dRs[1] @ ex.g_cur, dRs[2] @ ex.g_cur],
                             dim=-1)
            J = torch.cat([torch.zeros((3, 3), dtype=torch.float32, device=dev), Jr],
                          dim=-1)
            H = H + w * J.T @ J
            g = g + w * J.T @ e
            cost = cost + w * torch.sum(e * e)
        else:
            raise TypeError(f"unknown extra residual {type(ex)}")
    return cost, H, g


def _evaluate(b: _Block, pose, saturation, extras=(), mesh=None):
    """Robust cost, normal equations H (6,6) and gradient g (6,) at `pose`,
    sensor blocks included. With `mesh` the matches are this rank's share,
    and their partial sums are summed over the ranks in one 43-float
    `psum` of [cost, g, H] (the multi-device reduction point); the sensor
    blocks, replicated, are added after it."""
    R, t = se3.jpose_to_rt(pose)
    dRs = rotation_derivatives(pose[3:6])                 # (3 params, 3, 3)
    d = b.X @ R.T + t - b.P                               # (Q, 3)
    e = torch.einsum("qij,qj->qi", b.A, d)                # (Q, 3)
    s = torch.sum(e * e, dim=-1)
    irls = b.w * tukey_weight(s, saturation)
    # J = [A | A (dR/dparam X)]: (Q, 3, 6)
    u = torch.einsum("cij,qj->qic", dRs, b.X)             # (Q, 3, 3 params)
    J = torch.cat([b.A, b.A @ u], dim=-1)
    wJ = J * irls[:, None, None]
    H = torch.einsum("qki,qkj->ij", wJ, J)
    g = torch.einsum("qki,qk->i", wJ, e)
    cost = torch.sum(b.w * tukey_rho(s, saturation))
    if mesh is not None:
        flat = mesh.psum(torch.cat([cost[None], g, H.reshape(36)]))
        cost, g, H = flat[0], flat[1:7], flat[7:].reshape(6, 6)
    if not extras:
        return cost, H, g
    ec, eH, eg = _extra_terms(extras, R, t, dRs)
    return cost + ec, H + eH, g + eg


class LMResult(NamedTuple):
    pose: torch.Tensor        # (6,) optimized
    n_success: torch.Tensor   # () int32 — accepted steps incl. the initial eval
    cost: torch.Tensor        # () final robust cost
    H: torch.Tensor           # (6, 6) robust GN Hessian at the solution
    trips: object = None      # () int32 trips begun before convergence (count_trips)


def robust_lm(blocks: Sequence[Matches], pose0, saturation, cfg: SolverConfig,
              lm_max_iter: int, extras=(), mesh=None, count_trips: bool = False) -> LMResult:
    """LM minimization of the robustified match cost, plus the sensor
    blocks `extras`, starting at pose0. `mesh`: the blocks are this rank's
    share of the matches (see `_evaluate`); every rank steps the same pose.
    `count_trips`: also count, on the device, the trips that began before
    the solve converged (`LMResult.trips`, at most `lm_max_iter`)."""
    b = _block(blocks[0]) if len(blocks) == 1 else _Block(
        *(torch.cat(parts) for parts in zip(*(_block(m) for m in blocks))))
    dev = pose0.device
    cost, H, g = _evaluate(b, pose0, saturation, extras, mesh)
    pose = pose0
    lam = torch.full((), cfg.initial_lm_lambda, dtype=pose0.dtype, device=dev)
    nsucc = torch.ones((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    free = None
    if cfg.two_d_mode:
        # x, y, yaw free; z, roll, pitch held (filled in on the device)
        free = torch.ones(6, dtype=pose0.dtype, device=dev)
        free[2:5] = 0.0
    done_at_start = []
    for _ in range(lm_max_iter):
        done_at_start.append(done)
        D = torch.clamp(torch.diagonal(H), min=1e-12)
        Hd = H + lam * torch.diag(D)
        # solve_ex: no error check, hence no host sync; a singular system
        # gives a non-finite step, which the `finite` gate rejects
        delta = -torch.linalg.solve_ex(Hd, g[:, None], check_errors=False)[0][:, 0]
        if free is not None:
            delta = delta * free
        pose_new = pose + delta
        cost_new, H_new, g_new = _evaluate(b, pose_new, saturation, extras, mesh)
        finite = torch.isfinite(cost_new) & torch.all(torch.isfinite(delta))
        accept = finite & (cost_new < cost) & ~done
        small = accept & (cost - cost_new
                          <= cfg.function_tolerance * torch.clamp(cost, min=1e-30))
        pose = torch.where(accept, pose_new, pose)
        cost = torch.where(accept, cost_new, cost)
        H = torch.where(accept, H_new, H)
        g = torch.where(accept, g_new, g)
        lam = torch.where(done, lam,
                          torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                                      torch.clamp(lam * 4.0, max=1e12)))
        nsucc = nsucc + accept.to(torch.int32)
        done = done | small | (~accept & ~done & (lam >= 1e10))
    trips = None
    if count_trips:   # done_at_start[0] is the initial, unconverged flag
        trips = lm_max_iter - torch.stack(done_at_start).sum(dtype=torch.int32) \
            if done_at_start else torch.zeros((), dtype=torch.int32, device=dev)
    return LMResult(pose=pose, n_success=nsucc, cost=cost, H=H, trips=trips)


def pose_covariance(H):
    """6x6 pose covariance = pseudo-inverse of the robust GN Hessian, with
    the JAX package's cutoff (eigenvalues within 1e-10 of the largest count
    as zero).

    The eigendecomposition is `_jacobi_eigh6`, in tensor ops only:
    `torch.linalg.pinv` reads its eigensolver's error flag on the host,
    which would stall the streaming step and break its CUDA-graph capture."""
    lam, V = _jacobi_eigh6(H)
    keep = torch.abs(lam) > 1e-10 * torch.amax(torch.abs(lam))
    inv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
    return (V * inv) @ V.T


# circle-method round robin over 6 indices: 5 rounds of 3 disjoint pairs
# cover all 15 pairs once; each round lists its pairs as (p0 q0 p1 q1 p2 q2)
_ROUND_ROBIN = ((0, 1, 2, 5, 3, 4), (0, 2, 3, 1, 4, 5), (0, 3, 4, 2, 5, 1),
                (0, 4, 5, 3, 1, 2), (0, 5, 1, 4, 2, 3))
JACOBI_SWEEPS = 5   # float32-converged on 6x6 Hessians (cond up to ~1e6)


def _jacobi_eigh6(A):
    """Eigenvalues (6,) and eigenvectors (columns of V) of a symmetric 6x6
    matrix by cyclic Jacobi: a fixed number of sweeps, each 5 rounds of 3
    disjoint plane rotations applied as one 6x6 orthogonal matrix. Only
    tensor ops, no host read. Unordered eigenvalues (pinv needs none)."""
    dev, dt = A.device, A.dtype
    eye = torch.eye(6, dtype=dt, device=dev)
    # row-permutation matrices moving round r's pairs to (0,1) (2,3) (4,5)
    perms = torch.stack([eye[i] for order in _ROUND_ROBIN for i in order]).reshape(5, 6, 6)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    V = eye
    for _ in range(JACOBI_SWEEPS):
        for r in range(5):
            P = perms[r]
            Ap = P @ A @ P.T
            app = torch.diagonal(Ap[0::2, 0::2])
            aqq = torch.diagonal(Ap[1::2, 1::2])
            apq = torch.diagonal(Ap[0::2, 1::2])
            # the rotation that zeroes apq (Numerical Recipes 11.1)
            zero = apq == 0.0
            theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            sgn = torch.where(theta >= 0.0, 1.0, -1.0)
            t = sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            t = torch.where(zero, 0.0, t)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            blocks = torch.stack([torch.stack([c, s], dim=-1),
                                  torch.stack([-s, c], dim=-1)], dim=-2)
            G = torch.einsum("ij,iab->iajb", eye3, blocks).reshape(6, 6)
            Q = P.T @ G @ P
            A = Q.T @ A @ Q
            V = V @ Q
    return torch.diagonal(A), V


class RegistrationError(NamedTuple):
    """LocalOptimizer::RegistrationError parity (LocalOptimizer.h:34-49)."""

    covariance: torch.Tensor             # (6, 6)
    position_error: torch.Tensor         # () [m] sqrt of largest position eigval
    position_direction: torch.Tensor     # (3,)
    orientation_error: torch.Tensor      # () [deg]
    orientation_direction: torch.Tensor  # (3,)


def registration_error(H) -> RegistrationError:
    cov = pose_covariance(H)
    lam_p, V_p = torch.linalg.eigh(cov[:3, :3])
    lam_o, V_o = torch.linalg.eigh(cov[3:, 3:])
    return RegistrationError(
        covariance=cov,
        position_error=torch.sqrt(torch.clamp(lam_p[2], min=0.0)),
        position_direction=V_p[:, 2],
        orientation_error=torch.rad2deg(torch.sqrt(torch.clamp(lam_o[2], min=0.0))),
        orientation_direction=V_o[:, 2],
    )
