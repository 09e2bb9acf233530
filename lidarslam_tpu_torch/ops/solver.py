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
  evaluation), for the ICP early exit on `n_success == 1`;
- pose covariance = pseudo-inverse of the robust Gauss-Newton Hessian.

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


def _evaluate(b: _Block, pose, saturation):
    """Robust cost, normal equations H (6,6) and gradient g (6,) at `pose`."""
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
    return cost, H, g


class LMResult(NamedTuple):
    pose: torch.Tensor        # (6,) optimized
    n_success: torch.Tensor   # () int32 — accepted steps incl. the initial eval
    cost: torch.Tensor        # () final robust cost
    H: torch.Tensor           # (6, 6) robust GN Hessian at the solution


_FREE_MASK_2D = (1.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def robust_lm(blocks: Sequence[Matches], pose0, saturation, cfg: SolverConfig,
              lm_max_iter: int, extras=()) -> LMResult:
    """LM minimization of the robustified match cost starting at pose0."""
    if extras:
        raise NotImplementedError("sensor constraint residuals are not ported "
                                  "yet (ROADMAP.md, Queue 1: sensor constraints)")
    b = _block(blocks[0]) if len(blocks) == 1 else _Block(
        *(torch.cat(parts) for parts in zip(*(_block(m) for m in blocks))))
    dev = pose0.device
    cost, H, g = _evaluate(b, pose0, saturation)
    pose = pose0
    lam = torch.tensor(cfg.initial_lm_lambda, dtype=pose0.dtype, device=dev)
    nsucc = torch.ones((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    free = torch.tensor(_FREE_MASK_2D, dtype=pose0.dtype, device=dev) \
        if cfg.two_d_mode else None
    for _ in range(lm_max_iter):
        D = torch.clamp(torch.diagonal(H), min=1e-12)
        Hd = H + lam * torch.diag(D)
        # solve_ex: no error check, hence no host sync; a singular system
        # gives a non-finite step, which the `finite` gate rejects
        delta = -torch.linalg.solve_ex(Hd, g[:, None], check_errors=False)[0][:, 0]
        if free is not None:
            delta = delta * free
        pose_new = pose + delta
        cost_new, H_new, g_new = _evaluate(b, pose_new, saturation)
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
    return LMResult(pose=pose, n_success=nsucc, cost=cost, H=H)


def pose_covariance(H):
    """6x6 pose covariance = pseudo-inverse of the robust GN Hessian."""
    return torch.linalg.pinv(H, rtol=1e-10, hermitian=True)


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
