"""Device pose-graph optimization in PyTorch (port of
`lidarslam_tpu/backend/posegraph_device.py`): the scalable backend.

Same graph and semantics as `backend/posegraph.py` (the numpy oracle;
reference PoseGraphOptimization.cxx:112-285): SE(3) chain edges weighted by
inverse SLAM covariances, 3-D GPS priors through the GPS<->sensor offset, a
gauge prior when no GPS is present, constant-damped Gauss-Newton with a
function-tolerance stop. Everything is batched:

- residual/Jacobian assembly is one batch over all chain edges and all GPS
  edges (the batched SE(3) log/exp/adjoint of core/se3.py); GPS blocks go
  into their vertices with `index_add_`, which sums two fixes that share a
  nearest vertex (indexed `+=` would keep only one of them);
- the block-tridiagonal normal system is solved either by a loop of
  batched 6x6 block-LDL steps over the poses (exact, sequential), or by a
  segment-Schur (domain-decomposition) solve: the chain is split into S
  contiguous segments whose interiors are eliminated together (stacked on a
  leading dimension, where the JAX package uses `vmap`), the reduced
  (S-1)-separator system is solved by the loop, and the interiors
  back-substitute together.

Numerics: pose graphs carry world-scale coordinates, so the solve runs in
float64. The JAX package pins it to its CPU backend (a TPU has no float64
LU); an H100 has float64 linear algebra, so here the solve runs on the
card, in float64, unless the caller names the CPU (ROADMAP Queue 3, D6).
Every solve goes through `torch.linalg.solve_ex` without its error check,
so no LM iteration reads the device but for its one convergence flag.

On a mesh (`mesh`: a `parallel.sharded.Mesh`) the segment interiors shard
over the ranks: each rank eliminates its contiguous range of segments in
float64 on its own device, the segments' endpoint blocks are gathered, every
rank solves the small separator system, back-substitutes its own segments,
and one gather assembles the step. The JAX package drops its mesh off the
CPU (a TPU has no float64 LU); the card has float64, so the mesh stays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from lidarslam_tpu_torch.backend import registration
from lidarslam_tpu_torch.backend.posegraph import PoseGraphConfig, _closest
from lidarslam_tpu_torch.core import se3


# -----------------------------------------------------------------------------
#   Block-tridiagonal solvers
# -----------------------------------------------------------------------------

def _solve(A, B):
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def solve_block_tridiag_scan(D, U, rhs):
    """Exact block-LDL solve of the symmetric block-tridiagonal system.

    D: (..., N, b, b) diagonal blocks, U: (..., N-1, b, b) super-diagonal
    blocks (sub-diagonal = U^T), rhs: (..., N, b, r) or (N, b). Leading
    dimensions are independent systems. Returns x, shaped as rhs. A loop
    over N, each step a batched b x b solve."""
    squeeze = rhs.dim() == D.dim() - 1
    if squeeze:
        rhs = rhs[..., None]
    N = D.shape[-3]
    if N == 1:
        x = _solve(D[..., 0, :, :], rhs[..., 0, :, :])[..., None, :, :]
        return x[..., 0] if squeeze else x
    Cs, ys = [D[..., 0, :, :]], [rhs[..., 0, :, :]]
    for i in range(1, N):
        Ui = U[..., i - 1, :, :]
        G = _solve(Cs[-1].transpose(-1, -2), Ui).transpose(-1, -2)    # U^T C^-1
        Cs.append(D[..., i, :, :] - G @ Ui)
        ys.append(rhs[..., i, :, :] - G @ ys[-1])
    xs = [_solve(Cs[-1], ys[-1])]
    for i in range(N - 2, -1, -1):
        xs.append(_solve(Cs[i], ys[i] - U[..., i, :, :] @ xs[-1]))
    x = torch.stack(xs[::-1], dim=-3)
    return x[..., 0] if squeeze else x


def solve_block_tridiag_schur(D, U, rhs, n_segments: int, mesh=None):
    """Segment-Schur solve: interior elimination of all segments at once,
    the loop on the (n_segments - 1)-separator reduced system, and the
    interiors' back-substitution at once.

    Exact (up to roundoff) for any symmetric positive-definite block
    tridiagonal system. The chain is padded with decoupled identity blocks
    so every segment interior has equal length m (padding unknowns solve to
    zero and cannot affect the rest: their couplings are zero).

    With `mesh` every rank passes the same system and gets the same x;
    each eliminates and back-substitutes only its own ceil(S/n) segments
    (the last rank's range padded with decoupled identity segments)."""
    squeeze = rhs.dim() == 2
    if squeeze:
        rhs = rhs[..., None]
    N, B = D.shape[0], D.shape[1]
    r = rhs.shape[-1]
    S = n_segments
    if S <= 1 or N < 2 * S:
        x = solve_block_tridiag_scan(D, U, rhs)
        return x[..., 0] if squeeze else x

    def zeros(*shape):
        return torch.zeros(shape, dtype=D.dtype, device=D.device)

    # layout: [int_0 (m) | sep_0 | int_1 (m) | sep_1 | ... | int_{S-1} (m)]
    m = -(-(N - (S - 1)) // S)
    Np = S * (m + 1) - 1
    D_p = torch.cat([D, torch.eye(B, dtype=D.dtype, device=D.device).expand(Np - N, B, B)])
    U_p = torch.cat([U, zeros(Np - N, B, B)])
    rhs_p = torch.cat([rhs, zeros(Np - N, B, r)])

    # per-segment rows of length m+1: [m interiors, 1 separator]
    D_rows = torch.cat([D_p, zeros(1, B, B)]).reshape(S, m + 1, B, B)
    U_rows = torch.cat([U_p, zeros(2, B, B)]).reshape(S, m + 1, B, B)
    r_rows = torch.cat([rhs_p, zeros(1, B, r)]).reshape(S, m + 1, B, r)

    D_int = D_rows[:, :m]            # (S, m, B, B)
    U_int = U_rows[:, :m - 1]        # (S, m-1, B, B)
    rhs_int = r_rows[:, :m]          # (S, m, B, r)
    D_sep = D_rows[:-1, m]           # (S-1, B, B)
    rhs_sep = r_rows[:-1, m]         # (S-1, B, r)
    a = U_rows[:, m - 1]             # (S, B, B)  block (last_int_s, sep_s); a[S-1] unused
    c = U_rows[:, m]                 # (S, B, B)  block (sep_s, first_int_{s+1}); c[S-1]=0
    c_prev = torch.cat([zeros(1, B, B), c[:-1]])      # left coupling per segment

    # per-segment multi-RHS solve: [rhs | e_0 c_prev^T | e_last a]
    BL = zeros(S, m, B, B)
    BL[:, 0] = c_prev.transpose(-1, -2)
    BR = zeros(S, m, B, B)
    BR[:, m - 1] = a
    big_rhs = torch.cat([rhs_int, BL, BR], -1)
    if mesh is None:
        sol = solve_block_tridiag_scan(D_int, U_int, big_rhs)
        y = sol[..., :r]                              # A^-1 rhs
        FL = sol[..., r:r + B]                        # A^-1 (e_0 (x) c_prev^T)
        FR = sol[..., r + B:]                         # A^-1 (e_last (x) a)
    else:
        y, FL, FR, mine = _sharded_interiors(D_int, U_int, big_rhs, r, B, mesh)

    aT = a.transpose(-1, -2)
    # reduced separator system (S-1 blocks, block tridiagonal)
    D_red = D_sep - aT[:-1] @ FR[:-1, m - 1] - c[:-1] @ FL[1:, 0]
    U_red = -c[:-1][:-1] @ FR[1:-1, 0] if S > 2 else zeros(0, B, B)
    rhs_red = rhs_sep - aT[:-1] @ y[:-1, m - 1] - c[:-1] @ y[1:, 0]
    x_sep = solve_block_tridiag_scan(D_red, U_red, rhs_red)     # (S-1, B, r)

    # interior back-substitution: x_int_s = y_s - FL_s x_sep_{s-1} - FR_s x_sep_s
    zpad = zeros(1, B, r)
    x_left = torch.cat([zpad, x_sep])                 # (S, B, r)
    x_right = torch.cat([x_sep, zpad])
    if mesh is None:
        x_int = y - FL @ x_left[:, None] - FR @ x_right[:, None]
    else:   # this rank's segments (padding past S), then every rank's
        yl, FLl, FRl = mine
        per = yl.shape[0]
        lo = mesh.rank * per
        spare = zeros(per * mesh.size - S, B, r)
        xl = torch.cat([x_left, spare])[lo:lo + per]
        xr = torch.cat([x_right, spare])[lo:lo + per]
        x_int = mesh.all_gather(yl - FLl @ xl[:, None] - FRl @ xr[:, None], tiled=True)[:S]

    # stitch back into chain order and drop padding
    x_full = torch.cat([x_int, torch.cat([x_sep, zpad])[:, None]],
                       dim=1).reshape(S * (m + 1), B, r)[:N]
    return x_full[..., 0] if squeeze else x_full


def _sharded_interiors(D_int, U_int, big_rhs, r: int, B: int, mesh):
    """The interiors' elimination on a mesh: this rank solves its
    contiguous ceil(S/n) segments (padded with identity segments past S),
    and the blocks the separator system reads (each segment's first and
    last rows of y, FL, FR) are gathered from every rank in one collective.
    Returns full-S (y, FL, FR) holding only those endpoint rows, and this
    rank's own (y, FL, FR) for its back-substitution."""
    S, m = D_int.shape[0], D_int.shape[1]
    per = -(-S // mesh.size)
    lo = mesh.rank * per
    own = slice(lo, min(lo + per, S))
    n_pad = per - (own.stop - own.start)
    D_l, U_l, rhs_l = D_int[own], U_int[own], big_rhs[own]
    if n_pad:
        eye = torch.eye(B, dtype=D_int.dtype, device=D_int.device)
        D_l = torch.cat([D_l, eye.expand(n_pad, m, B, B)])
        U_l = torch.cat([U_l, U_l.new_zeros((n_pad,) + U_l.shape[1:])])
        rhs_l = torch.cat([rhs_l, rhs_l.new_zeros((n_pad,) + rhs_l.shape[1:])])
    sol = solve_block_tridiag_scan(D_l, U_l, rhs_l)              # (per, m, B, r+2B)
    ends = mesh.all_gather(torch.stack([sol[:, 0], sol[:, m - 1]], dim=1),
                           tiled=True)[:S]                        # (S, 2, B, r+2B)
    full = torch.zeros((S, m) + sol.shape[2:], dtype=sol.dtype, device=sol.device)
    full[:, 0] = ends[:, 0]
    full[:, m - 1] = ends[:, 1]
    y, FL, FR = full[..., :r], full[..., r:r + B], full[..., r + B:]
    mine = (sol[..., :r], sol[..., r:r + B], sol[..., r + B:])
    return y, FL, FR, mine


# -----------------------------------------------------------------------------
#   Gauss-Newton pose-graph iterations
# -----------------------------------------------------------------------------

def _assemble(X, Z, W_rel, gps_pos, gps_W, gps_vertex, offset, anchor,
              gauge_weight: float, has_gps: bool):
    """Batched D/U/b assembly (mirrors the numpy loop in posegraph.py)."""
    N = X.shape[0]
    Hij = se3.jhmat_inverse(X[:-1]) @ X[1:]
    E = se3.jse3_log(se3.jhmat_inverse(Z) @ Hij)           # (N-1, 6)
    Ji = -se3.jadjoint(se3.jhmat_inverse(Hij))             # (N-1, 6, 6)
    JiW = Ji.transpose(-1, -2) @ W_rel                     # Ji^T W

    D = torch.zeros((N, 6, 6), dtype=X.dtype, device=X.device)
    b = torch.zeros((N, 6), dtype=X.dtype, device=X.device)
    D[:-1] += JiW @ Ji
    D[1:] += W_rel
    U = JiW                                                # block (i, i+1)
    We = torch.einsum("nij,nj->ni", W_rel, E)
    b[:-1] += torch.einsum("nij,nj->ni", JiW, E)
    b[1:] += We
    cost = torch.sum(E * We)

    if has_gps:
        Xg = X[gps_vertex]                                 # (M, 4, 4)
        R = Xg[:, :3, :3]
        e = (Xg @ offset)[:, :3, 3] - gps_pos
        J = torch.cat([R, -R @ se3.jhat(offset[:3, 3].expand(R.shape[0], 3))], -1)
        JW = J.transpose(-1, -2) @ gps_W
        # a vertex nearest to several fixes takes each of their blocks
        D.index_add_(0, gps_vertex, JW @ J)
        b.index_add_(0, gps_vertex, torch.einsum("mij,mj->mi", JW, e))
        cost = cost + torch.sum(e * torch.einsum("mij,mj->mi", gps_W, e))
    else:
        D[0] += torch.eye(6, dtype=X.dtype, device=X.device) * gauge_weight
        e0 = se3.jse3_log(se3.jhmat_inverse(anchor) @ X[0])
        b[0] += gauge_weight * e0
        cost = cost + gauge_weight * torch.sum(e0 * e0)
    return D, U, b, cost


def _pgo_iterations(X, Z, W_rel, gps_pos, gps_W, gps_vertex, offset, anchor,
                    n_iterations: int, lam: float, ftol: float, gauge_weight: float,
                    has_gps: bool, n_segments: int, mesh=None):
    """The JAX package's LM while-loop as a host loop: each iteration
    assembles, tests convergence, damps, solves, steps X by exp(delta) and
    keeps X once converged, then reads the flag (one device read per
    iteration). Returns (X, cost, iterations run)."""
    prev_cost = torch.full((), float("inf"), dtype=X.dtype, device=X.device)
    cost = prev_cost
    it = 0
    while it < n_iterations:
        D, U, b, cost = _assemble(X, Z, W_rel, gps_pos, gps_W, gps_vertex, offset, anchor,
                                  gauge_weight, has_gps)
        done = torch.abs(prev_cost - cost) <= ftol * torch.clamp(cost, min=1e-12)
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-9)
        Dd = D + lam * torch.diag_embed(diag)
        if n_segments > 1:
            delta = solve_block_tridiag_schur(Dd, U, -b, n_segments, mesh=mesh)
        else:
            delta = solve_block_tridiag_scan(Dd, U, -b)
        X = torch.where(done, X, X @ se3.jse3_exp(delta))
        prev_cost = cost
        it += 1
        if bool(done):
            break
    return X, cost, it


def optimize_pose_graph_device(
    slam_poses: Sequence[np.ndarray],
    slam_times: np.ndarray,
    slam_covariances: Sequence[np.ndarray],
    gps_positions: Optional[np.ndarray] = None,
    gps_times: Optional[np.ndarray] = None,
    gps_covariances: Optional[np.ndarray] = None,
    gps_to_sensor_offset: Optional[np.ndarray] = None,
    config: PoseGraphConfig = PoseGraphConfig(),
    n_segments: int = 0,
    verbose: bool = False,
    device=None,
    mesh=None,
):
    """Drop-in device-backed replacement for posegraph.optimize_pose_graph.

    n_segments > 1 selects the segment-Schur solve; 0/1 the sequential
    block-LDL loop. Runs in float64 on `device`: "cuda" unless given (it
    raises where torch finds no CUDA device), "cpu" for the plain host
    run; on a `mesh` its device unless given. With `mesh` every rank calls
    it with the same graph: the Schur's segment interiors shard over the
    ranks (4 segments a rank when `n_segments` < 2, as in the JAX package)
    and every rank returns the same poses. Returns (optimized_poses
    list[(4,4)], final_cost)."""
    if mesh is not None and n_segments < 2:
        n_segments = 4 * mesh.size
    if device is None and mesh is not None:
        device = mesh.device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("optimize_pose_graph_device runs on a CUDA device unless asked "
                           "for another (device='cpu'), and torch finds none")
    N = len(slam_poses)
    X = np.stack([np.asarray(p, np.float64) for p in slam_poses])
    slam_times = np.asarray(slam_times, np.float64)
    offset = np.eye(4) if gps_to_sensor_offset is None \
        else np.asarray(gps_to_sensor_offset, np.float64)

    has_gps = gps_positions is not None and len(gps_positions) >= 2
    if has_gps:
        gps_positions = np.asarray(gps_positions, np.float64)
        gps_times = np.asarray(gps_times, np.float64)
        if gps_covariances is None:
            gps_covariances = np.broadcast_to(np.eye(3) * 1e-2, (len(gps_positions), 3, 3))
        positions = np.stack([(p @ offset)[:3, 3] for p in X])
        T = registration.compute_transform_offset(positions, gps_positions)
        X = np.einsum("ij,njk->nik", T, X)
        gps_vertex = np.array([_closest(slam_times, t) for t in gps_times])
        gps_W = np.linalg.inv(np.asarray(gps_covariances, np.float64) + np.eye(3) * 1e-9)
    else:
        gps_vertex = np.zeros(1, np.int64)
        gps_positions = np.zeros((1, 3))
        gps_W = np.zeros((1, 3, 3))

    Z = np.stack([se3.hmat_inverse(np.asarray(slam_poses[i], np.float64))
                  @ np.asarray(slam_poses[i + 1], np.float64) for i in range(N - 1)])
    W_rel = np.stack([np.linalg.inv(np.asarray(slam_covariances[i + 1], np.float64)
                                    + np.eye(6) * 1e-8) for i in range(N - 1)])

    def up(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    Xt, cost, it = _pgo_iterations(
        up(X), up(Z), up(W_rel), up(gps_positions), up(gps_W),
        up(gps_vertex, torch.int64), up(offset), up(X[0]),
        n_iterations=config.n_iterations, lam=float(config.init_lambda),
        ftol=float(config.function_tolerance), gauge_weight=float(config.gauge_weight),
        has_gps=has_gps, n_segments=max(int(n_segments), 0), mesh=mesh)
    Xh = Xt.cpu().numpy()
    cost = float(cost)
    if verbose:
        print(f"[pgo-device] {it} iterations, cost {cost:.6e}")
    return [np.asarray(Xh[i], np.float64) for i in range(N)], cost
