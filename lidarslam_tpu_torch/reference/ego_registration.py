"""Plain float64 reference of the scan-to-scan ego-motion registration.

The stage refines the extrapolated ego-motion prior (the motion of the
sensor from the previous sweep to this one, xyz + roll/pitch/yaw with
R = Rz(yaw) Ry(pitch) Rx(roll)) by ICP of this sweep's edge and plane
keypoints against the previous sweep's (upstream Slam.cxx:813-972, the mode
MOTION_EXTRAPOLATION_AND_REGISTRATION of Enums.h:68-93). This file computes
it in float64 with plain `torch` operations, from the keypoints alone: it
imports nothing but torch and keeps no kernel, cache or batching of the
program it checks. Its semantics are those of the port's ego stage
(`lidarslam_tpu_torch/ops/pipeline.py::_ego_registration`, through
`ops/icp.py`, `ops/matcher.py` and `ops/solver.py`), which mirror the JAX
package's; each departure from upstream that they make, this makes too:

- Rounds: `ICP_max_iter` rounds, the Tukey saturation distance going
  linearly from `init_saturation_distance` to `final_saturation_distance`.
  Upstream breaks out of the loop when an LM solve converges in its first
  evaluation (`num_successful_steps == 1`, Slam.cxx:950); here, as in the
  port, every round runs and a round that begins with the gate shut
  changes nothing. A round with fewer than `min_matches` matches keeps the
  pose, shuts the gate and fails the stage; a failed stage returns the
  prior.
- Neighbours: the exact k nearest previous keypoints of each keypoint moved
  by the current estimate, ties to the lower index (upstream: a k-d tree).
  Edges take 8 and keep one per laser ring, the closest neighbour's ring
  and rings more than 4 from it excluded, and need 3
  (GetPerRingLineNeighbors, KeypointsMatcher.cxx:349-405); planes take 5
  and need all 5. The farthest neighbour kept must lie within
  `max_neighbors_distance`.
- Models (BuildLineMatch 106-187, BuildPlaneMatch 190-273): the
  neighbours' mean P and covariance (normalized by their count). An edge's
  residual matrix is A = I - v v^T (v the largest eigenvector), its mean
  squared error the two smaller eigenvalues' sum; a plane's A = n n^T (n
  the smallest eigenvector), its error the smallest eigenvalue, and it
  needs l1 >= planarity_threshold * l2. The error must stay below the
  type's `max_model_error` squared; the match's weight is
  1 - sqrt(mse) / max_model_error (1 where mse <= 1e-6).
- Solve: `LM_max_iter` Levenberg-Marquardt trips on the cost
  sum_i w_i rho(|A_i (R X_i + t - P_i)|^2), rho Ceres' Tukey loss at the
  round's saturation distance, by IRLS normal equations with analytic
  Jacobians; lambda starts at 1e-4 and is divided by 3 on an accepted step
  and multiplied by 4 otherwise; a solve stops when a step improves the
  cost by at most 1e-6 of it, or when lambda reaches 1e10 on a rejected
  step (the port's fixed-trip loop with converged trips gated off). The
  gate stays open while the solve accepted a step.

`register` also returns the counts the port reads on the device: the
rounds begun with the gate open and the LM trips those rounds began
before converging.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64


class EgoParams(NamedTuple):
    """The preset's `ego_motion_registration` block, and the stage's
    minimum match count and solver constants."""

    max_neighbors_distance: float = 5.0
    edge_nb_neighbors: int = 8
    edge_min_nb_neighbors: int = 3
    edge_max_model_error: float = 0.2
    plane_nb_neighbors: int = 5
    planarity_threshold: float = 0.04
    plane_max_model_error: float = 0.2
    icp_max_iter: int = 4
    lm_max_iter: int = 15
    init_saturation_distance: float = 5.0
    final_saturation_distance: float = 1.0
    min_matches: int = 20
    function_tolerance: float = 1e-6
    initial_lm_lambda: float = 1e-4

    @classmethod
    def from_block(cls, block: dict, min_matches: int = 20) -> "EgoParams":
        """From a yaml `ego_motion_registration` block (its keys as the
        upstream presets name them; a key left out keeps its default)."""
        keys = {"ICP_max_iter": "icp_max_iter", "LM_max_iter": "lm_max_iter"}
        kw = {keys.get(k, k): v for k, v in block.items() if keys.get(k, k) in cls._fields}
        return cls(**kw, min_matches=min_matches)


class EgoResult(NamedTuple):
    motion: torch.Tensor   # (6,) float64 refined ego-motion (the prior where failed)
    failed: bool           # a round found fewer than min_matches matches
    rounds: int            # rounds begun with the gate open
    lm_steps: int          # LM trips of those rounds begun before convergence
    matches: int           # matches of the last round begun with the gate open


def rotation(rpy):
    """R = Rz(yaw) Ry(pitch) Rx(roll) of (3,) roll, pitch, yaw."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr, cp, sp, cy, sy = r.cos(), r.sin(), p.cos(), p.sin(), y.cos(), y.sin()
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr]),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr]),
        torch.stack([-sp, cp * sr, cp * cr])])


def rotation_derivatives(rpy):
    """(3, 3, 3): dR/droll, dR/dpitch, dR/dyaw."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr, cp, sp, cy, sy = r.cos(), r.sin(), p.cos(), p.sin(), y.cos(), y.sin()
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


def transform(pose, pts):
    return pts @ rotation(pose[3:6]).T + pose[0:3]


def nearest(target, queries, k: int):
    """(d2 (Q, k), idx (Q, k)): the k nearest target points of each query in
    ascending squared distance, ties to the lower index; +inf and index 0
    where the target has fewer than k points."""
    Q, M = queries.shape[0], target.shape[0]
    d2 = torch.full((Q, k), float("inf"), dtype=F64, device=queries.device)
    idx = torch.zeros((Q, k), dtype=torch.int64, device=queries.device)
    if M and Q:
        full = ((queries[:, None, :] - target[None, :, :]) ** 2).sum(dim=-1)
        d, i = torch.sort(full, dim=1, stable=True)
        n = min(k, M)
        d2[:, :n], idx[:, :n] = d[:, :n], i[:, :n]
    return d2, idx


def _gather(target, idx):
    """(Q, k, 3) target points at `idx` (zeros from an empty target)."""
    if target.shape[0]:
        return target[idx]
    return torch.zeros(idx.shape + (3,), dtype=F64, device=idx.device)


def _pca(nbr, mask):
    """Mean (Q, 3), ascending eigenvalues (Q, 3) and eigenvectors (Q, 3, 3
    as columns) of each row's masked neighbours."""
    m = mask.to(F64)[..., None]
    n = m.sum(dim=1).clamp(min=1.0)
    mean = (nbr * m).sum(dim=1) / n
    c = (nbr - mean[:, None, :]) * m
    cov = c.transpose(1, 2) @ c / n[..., None]
    lam, vec = torch.linalg.eigh(cov)
    return mean, lam, vec


def _weight(mse, max_err):
    return torch.where(mse <= 1e-6, 1.0, 1.0 - mse.clamp(min=0.0).sqrt() / max_err)


def match_edges(x, prev_xyz, prev_ring, pose, prm: EgoParams):
    """(A (Q, 3, 3), P (Q, 3), w (Q,), ok (Q,)) of every edge keypoint."""
    d2, idx = nearest(prev_xyz, transform(pose, x), prm.edge_nb_neighbors)
    found = d2.isfinite()
    rings = prev_ring[idx] if prev_ring.shape[0] else torch.zeros_like(idx)
    r0 = rings[:, :1]
    allowed = found & ((rings - r0).abs() <= 4) & (rings != r0)
    k = rings.shape[1]
    earlier = torch.ones((k, k), dtype=torch.bool, device=x.device).tril(-1)
    taken = ((rings[:, :, None] == rings[:, None, :]) & earlier & allowed[:, None, :]).any(2)
    sel = allowed & ~taken
    enough = sel.sum(dim=1) >= prm.edge_min_nb_neighbors
    near = torch.where(sel, d2, 0.0).amax(dim=1) <= prm.max_neighbors_distance ** 2
    mean, lam, vec = _pca(_gather(prev_xyz, idx), sel)
    v = vec[:, :, 2]
    A = torch.eye(3, dtype=F64, device=x.device) - v[:, :, None] * v[:, None, :]
    mse = lam[:, 0] + lam[:, 1]
    ok = enough & near & (mse < prm.edge_max_model_error ** 2) & (lam[:, 2] > 1e-20)
    return A, mean, _weight(mse, prm.edge_max_model_error), ok


def match_planes(x, prev_xyz, pose, prm: EgoParams):
    """(A, P, w, ok) of every plane keypoint."""
    d2, idx = nearest(prev_xyz, transform(pose, x), prm.plane_nb_neighbors)
    found = d2.isfinite()
    enough = found.sum(dim=1) >= prm.plane_nb_neighbors
    near = torch.where(found, d2, 0.0).amax(dim=1) <= prm.max_neighbors_distance ** 2
    mean, lam, vec = _pca(_gather(prev_xyz, idx), found)
    n = vec[:, :, 0]
    A = n[:, :, None] * n[:, None, :]
    planar = lam[:, 1] >= prm.planarity_threshold * lam[:, 2].clamp(min=1e-30)
    mse = lam[:, 0]
    ok = enough & near & planar & (mse < prm.plane_max_model_error ** 2) & (lam[:, 2] > 1e-20)
    return A, mean, _weight(mse, prm.plane_max_model_error), ok


def evaluate(A, P, X, w, pose, sat):
    """Robust cost, normal equations H (6, 6) and gradient g (6,)."""
    R = rotation(pose[3:6])
    e = torch.einsum("qij,qj->qi", A, X @ R.T + pose[0:3] - P)
    s = (e * e).sum(dim=1)
    u = (1.0 - s / sat ** 2).clamp(0.0, 1.0)
    irls = w * u * u
    dR = rotation_derivatives(pose[3:6])
    J = torch.cat([A, A @ torch.einsum("cij,qj->qic", dR, X)], dim=2)
    H = torch.einsum("qki,qkj,q->ij", J, J, irls)
    g = torch.einsum("qki,qk,q->i", J, e, irls)
    cost = (w * sat ** 2 / 3.0 * (1.0 - u ** 3)).sum()
    return cost, H, g


def solve(A, P, X, w, pose, sat, prm: EgoParams):
    """(pose, accepted steps + 1, trips begun before convergence)."""
    cost, H, g = evaluate(A, P, X, w, pose, sat)
    lam, n_success, trips = prm.initial_lm_lambda, 1, 0
    for _ in range(prm.lm_max_iter):
        trips += 1
        D = torch.diagonal(H).clamp(min=1e-12)
        # a singular system gives a non-finite step, which is rejected
        delta = -torch.linalg.solve_ex(H + lam * torch.diag(D), g[:, None])[0][:, 0]
        new = pose + delta
        c_new, H_new, g_new = evaluate(A, P, X, w, new, sat)
        if bool(c_new.isfinite()) and bool(delta.isfinite().all()) and c_new < cost:
            small = cost - c_new <= prm.function_tolerance * max(float(cost), 1e-30)
            pose, cost, H, g = new, c_new, H_new, g_new
            lam = max(lam / 3.0, 1e-12)
            n_success += 1
            if small:
                break
        else:
            lam = min(lam * 4.0, 1e12)
            if lam >= 1e10:
                break
    return pose, n_success, trips


def register(edges, planes, prev_edges, prev_edge_rings, prev_planes, prior,
             prm: EgoParams = EgoParams()) -> EgoResult:
    """The refined ego-motion of one sweep. `edges`, `planes`: (n, 3) valid
    keypoints of this sweep; `prev_edges` (m, 3) with their laser rings
    `prev_edge_rings` (m,), `prev_planes`: the previous sweep's; `prior`:
    (6,) xyzrpy. Tensors or arrays of any float dtype; computed in float64
    on the device of `edges`."""
    dev = torch.as_tensor(edges).device

    def f64(a, cols=3):
        return torch.as_tensor(a).to(device=dev, dtype=F64).reshape(-1, cols)

    x_e, x_p, t_e, t_p = f64(edges), f64(planes), f64(prev_edges), f64(prev_planes)
    rings = torch.as_tensor(prev_edge_rings).to(device=dev, dtype=torch.int64).reshape(-1)
    prior = f64(prior, 6)[0]
    pose = prior.clone()
    gate, failed, rounds, lm_steps, matches = True, False, 0, 0, 0
    n = prm.icp_max_iter
    for it in range(n):
        if not gate:
            break
        ratio = it / max(n - 1, 1)
        sat = (1.0 - ratio) * prm.init_saturation_distance + ratio * prm.final_saturation_distance
        Ae, Pe, we, oke = match_edges(x_e, t_e, rings, pose, prm)
        Ap, Pp, wp, okp = match_planes(x_p, t_p, pose, prm)
        ok = torch.cat([oke, okp])
        A, P = torch.cat([Ae, Ap])[ok], torch.cat([Pe, Pp])[ok]
        X, w = torch.cat([x_e, x_p])[ok], torch.cat([we, wp])[ok]
        rounds += 1
        matches = int(ok.sum())
        new, n_success, trips = solve(A, P, X, w, pose, sat, prm)
        lm_steps += trips
        if matches < prm.min_matches:
            failed = True
            break
        pose = new
        gate = n_success != 1
    return EgoResult(motion=prior if failed else pose, failed=failed, rounds=rounds,
                     lm_steps=lm_steps, matches=matches)
