"""Batched keypoint -> map-model matching (PyTorch port of
`lidarslam_tpu/ops/matcher.py`).

Per keypoint type one batched pipeline over the fixed keypoint capacity:
k-NN, masked neighbourhood PCA, the validity gates and the Mahalanobis
residual parameters (KeypointsMatcher.cxx:33-480):

- edges, localization mode: 2-point RANSAC line neighbours
  (GetRansacLineNeighbors 408-480) as a dense (k-1)x(k-1) inlier matrix;
  ego-motion mode: one neighbour per ring, the closest neighbour's ring
  excluded (GetPerRingLineNeighbors 349-405); line model A = I - n n^T
  (BuildLineMatch 106-187);
- planes: planarity gate l1/l2 >= threshold, model A = n n^T
  (BuildPlaneMatch 190-273);
- blobs: point-to-ellipsoid, A = sum_j rsqrt(max(l_j, blob_min_sigma^2))
  v_j v_j^T, weight 1 (BuildBlobMatch 276-346).

Each match yields (A, P, X, weight, status): the solver's residual is
w * A @ (R X + t - P) with w = 1 - sqrt(mse)/max_model_error (1 for
blobs), and status is a MatchStatus rejection code.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidarslam_tpu_torch.config import Keypoint, MatchingConfig, MatchStatus
from lidarslam_tpu_torch.core import pca, se3
from lidarslam_tpu_torch.ops.voxel_map import SubmapView, brute_knn


class Matches(NamedTuple):
    """Per-keypoint match parameters (slots align with the keypoint arrays).
    The symmetric A is kept as its six unique entries in (6, Q) layout."""

    A6: torch.Tensor       # (6, Q) symmetric A entries [a00,a01,a02,a11,a12,a22]
    P: torch.Tensor        # (Q, 3) model position (neighborhood mean)
    X: torch.Tensor        # (Q, 3) keypoint in BASE coordinates
    weight: torch.Tensor   # (Q,) fit-quality weight
    status: torch.Tensor   # (Q,) uint8 MatchStatus
    valid: torch.Tensor    # (Q,) bool == (status == SUCCESS)

    @property
    def n_matches(self):
        return torch.sum(self.valid)

    @property
    def A(self):
        """(Q, 3, 3) dense view of A6."""
        a00, a01, a02, a11, a12, a22 = self.A6
        row0 = torch.stack([a00, a01, a02], dim=-1)
        row1 = torch.stack([a01, a11, a12], dim=-1)
        row2 = torch.stack([a02, a12, a22], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)


def _a6(a00, a01, a02, a11, a12, a22):
    return torch.stack([a00, a01, a02, a11, a12, a22], dim=0)


def _finish(A6, P, X, weight, ok, status):
    status = torch.where(ok, int(MatchStatus.SUCCESS), status).to(torch.uint8)
    return Matches(
        A6=torch.where(ok[None, :], A6, 0.0),
        P=torch.where(ok[:, None], P, 0.0),
        X=X,
        weight=torch.where(ok, weight, 0.0),
        status=status,
        valid=ok,
    )


def _knn(index: SubmapView, world, k, prune_radius, q_valid=None, prepared=None,
         need_rings=False):
    """Neighbour search. Returns (d2 (Q,k), nbr (Q,k,3), rings (Q,k) or
    None, found (Q,k)). `rings` are the ring ids of the returned slots
    (`need_rings`, the ego-motion edge filter); a missing neighbour comes
    back as slot 0, so its ring is slot 0's and only `found` masks it.
    `prune_radius` skips, on the kernel path, map sub-blocks beyond it (the
    plain scan ignores it): every neighbour within it comes back as in the
    exact scan, but which slots beyond it come back may differ (`knn_radius`
    says which searches may prune)."""
    d2, idx, nbr = brute_knn(index, world, k, prune_radius=prune_radius,
                             q_valid=q_valid, prepared=prepared)
    rings = index.ring[idx.long()] if need_rings else None
    return d2, nbr, rings, torch.isfinite(d2)


# public alias: the ICP loop's reuse_knn mode queries neighbours itself in
# round 0 and hands the cached (nbr, rings, found) back into match_*
knn_query = _knn


def knn_radius(kind: Keypoint, params: MatchingConfig):
    """The kernel's prune radius for one keypoint type's localization k-NN
    against a leaf-sorted submap (None: the exact scan).

    Edges scan unpruned: their `near` gate reads only the neighbours the
    filter selected (RANSAC inliers, or one per ring), so a beyond-radius
    slot that a pruned scan returns differently from the exact scan can
    enter the selection and change the match (and, under `reuse_knn`, be
    re-posed inside the gate in a later round). Unpruned, the kernel
    returns exactly what the exact scan — and the JAX package's CPU
    reference — returns. Planes and blobs prune at the neighbour gate:
    their `near` reads every found neighbour, so a beyond-gate neighbour
    fails it whichever slot it is."""
    return None if kind == Keypoint.EDGE else float(params.max_neighbors_distance)


def _reuse_d2(world, nbr, found):
    """Exact squared distances of re-posed queries to CACHED neighbour
    coordinates (reuse_knn: coordinates from round 0, distances against the
    current round's pose)."""
    diff = world[:, None, :] - nbr
    d2 = torch.sum(diff * diff, dim=-1)
    return torch.where(found, d2, float("inf"))


def match_planes(kp_xyz, kp_valid, index: SubmapView, pose, params: MatchingConfig,
                 prepared=None, knn=None, prune_radius=None):
    """Point-to-plane matches (BuildPlaneMatch semantics). `knn`: cached
    (nbr, rings, found) from a previous round (reuse_knn mode);
    `prune_radius`: the kernel's (None: the exact scan; `knn_radius`)."""
    k = params.plane_nb_neighbors
    world = se3.japply_pose(pose, kp_xyz)
    if knn is None:
        d2, nbr, _, found = _knn(index, world, k, prune_radius, kp_valid, prepared)
    else:
        nbr, _, found = knn
        d2 = _reuse_d2(world, nbr, found)

    n_found = torch.sum(found, dim=1)
    enough = kp_valid & (n_found >= k)
    # farthest of the k must be close enough (KeypointsMatcher.cxx:217)
    near = torch.where(found, d2, 0.0).amax(dim=1) <= params.max_neighbors_distance ** 2

    mean, c6, _ = pca.masked_cov6(nbr, found)
    (l0, l1, l2), (n, _, _) = pca.eigh6(c6)
    planar = l1 >= params.planarity_threshold * torch.clamp(l2, min=1e-30)
    A = _a6(n[0] * n[0], n[0] * n[1], n[0] * n[2],
            n[1] * n[1], n[1] * n[2], n[2] * n[2])
    mse = l0
    mse_ok = mse < params.plane_max_model_error ** 2
    finite = (torch.isfinite(n[0]) & torch.isfinite(n[1]) & torch.isfinite(n[2])
              & (l2 > 1e-20))

    ok = enough & near & planar & mse_ok & finite
    weight = torch.where(mse <= 1e-6, 1.0,
                         1.0 - torch.sqrt(torch.clamp(mse, min=0.0))
                         / params.plane_max_model_error)
    status = _status_chain(kp_valid, enough, near,
                           [(planar, MatchStatus.BAD_PCA_STRUCTURE),
                            (finite, MatchStatus.INVALID_NUMERICAL),
                            (mse_ok, MatchStatus.MSE_TOO_LARGE)])
    return _finish(A, mean, kp_xyz, weight, ok, status)


def match_edges(kp_xyz, kp_valid, index: SubmapView, pose, params: MatchingConfig,
                prepared=None, knn=None, prune_radius=None):
    """Point-to-line matches; the neighbour filter per
    `params.single_edge_per_ring` (ego-motion: one neighbour per ring;
    localization: RANSAC). `knn`: cached (nbr, rings, found) from a previous
    round (reuse_knn); `prune_radius`: as in `match_planes`."""
    k = params.edge_nb_neighbors
    per_ring = params.single_edge_per_ring
    world = se3.japply_pose(pose, kp_xyz)
    if knn is None:
        d2, nbr, rings, found = _knn(index, world, k, prune_radius, kp_valid, prepared,
                                     need_rings=per_ring)
    else:
        nbr, rings, found = knn
        d2 = _reuse_d2(world, nbr, found)

    if per_ring:
        sel = _per_ring_filter(rings, found)
    else:
        sel = _ransac_line_filter(nbr, found, params.edge_max_model_error)
    n_sel = torch.sum(sel, dim=1)
    enough = kp_valid & (n_sel >= params.edge_min_nb_neighbors)
    far_sel = torch.where(sel, d2, 0.0).amax(dim=1)
    near = far_sel <= params.max_neighbors_distance ** 2

    mean, c6, _ = pca.masked_cov6(nbr, sel)
    (l0, l1, l2), (_, _, n) = pca.eigh6(c6)     # n = line direction
    A = _a6(1.0 - n[0] * n[0], -n[0] * n[1], -n[0] * n[2],
            1.0 - n[1] * n[1], -n[1] * n[2], 1.0 - n[2] * n[2])
    mse = l0 + l1
    mse_ok = mse < params.edge_max_model_error ** 2
    finite = (torch.isfinite(n[0]) & torch.isfinite(n[1]) & torch.isfinite(n[2])
              & (l2 > 1e-20))

    ok = enough & near & mse_ok & finite
    weight = torch.where(mse <= 1e-6, 1.0,
                         1.0 - torch.sqrt(torch.clamp(mse, min=0.0))
                         / params.edge_max_model_error)
    status = _status_chain(kp_valid, enough, near,
                           [(finite, MatchStatus.INVALID_NUMERICAL),
                            (mse_ok, MatchStatus.MSE_TOO_LARGE)])
    return _finish(A, mean, kp_xyz, weight, ok, status)


def match_blobs(kp_xyz, kp_valid, index: SubmapView, pose, params: MatchingConfig,
                prepared=None, knn=None, prune_radius=None):
    """Point-to-ellipsoid matches (BuildBlobMatch semantics); `knn` and
    `prune_radius` as in `match_planes` (blobs prune at the gate too: their
    `near` reads every found neighbour)."""
    k = params.blob_nb_neighbors
    world = se3.japply_pose(pose, kp_xyz)
    if knn is None:
        d2, nbr, _, found = _knn(index, world, k, prune_radius, kp_valid, prepared)
    else:
        nbr, _, found = knn
        d2 = _reuse_d2(world, nbr, found)

    n_found = torch.sum(found, dim=1)
    enough = kp_valid & (n_found >= k)
    near = torch.where(found, d2, 0.0).amax(dim=1) <= params.max_neighbors_distance ** 2

    mean, c6, _ = pca.masked_cov6(nbr, found)
    lams, vecs = pca.eigh6(c6)
    pca_ok = lams[0] > 1e-12
    # the sigma floor (MatchingConfig.blob_min_sigma) bounds the weight of
    # near-singular single-arc neighbourhoods
    lam_floor = float(np.float32(params.blob_min_sigma ** 2))
    s = [torch.rsqrt(torch.clamp(lam, min=lam_floor)) for lam in lams]

    def entry(a, b):
        return s[0] * vecs[0][a] * vecs[0][b] + s[1] * vecs[1][a] * vecs[1][b] \
            + s[2] * vecs[2][a] * vecs[2][b]

    A = _a6(entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2))
    finite = torch.isfinite(A).all(dim=0)

    ok = enough & near & pca_ok & finite
    weight = torch.ones_like(d2[:, 0])
    status = _status_chain(kp_valid, enough, near,
                           [(pca_ok, MatchStatus.BAD_PCA_STRUCTURE),
                            (finite, MatchStatus.INVALID_NUMERICAL)])
    return _finish(A, mean, kp_xyz, weight, ok, status)


def _per_ring_filter(rings, found):
    """One neighbour per ring, the closest neighbour's ring excluded, rings
    beyond +-4 of it excluded (GetPerRingLineNeighbors 349-405).
    Neighbours arrive in ascending-distance order."""
    k = rings.shape[1]
    r0 = rings[:, 0:1]
    allowed = found & (torch.abs(rings - r0) <= 4) & (rings != r0)
    # first occurrence of each ring among the allowed neighbours
    ar = torch.arange(k, device=rings.device)
    same_ring_before = (rings[:, :, None] == rings[:, None, :]) \
        & (ar[None, :] < ar[:, None])[None, :, :]
    taken = torch.any(same_ring_before & allowed[:, None, :], dim=2)
    return allowed & ~taken


def _ransac_line_filter(nbr, found, max_dist_inlier):
    """2-point RANSAC around the closest neighbour
    (GetRansacLineNeighbors 408-480): lines (P1, Pi) for i>=1 score inliers
    among candidates j>=1; keep the best line's inliers plus P1."""
    Q, k, _ = nbr.shape
    p1 = nbr[:, 0:1, :]
    rel = nbr[:, 1:, :] - p1                               # candidates j>=1
    norm = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True))
    dirs = rel / torch.clamp(norm, min=1e-12)              # (Q, k-1, 3)
    # inlier[i, j]: candidate j fits line i (candidate j == i counts itself)
    a = rel[:, None, :, :].expand(Q, k - 1, k - 1, 3)
    b = dirs[:, :, None, :].expand(Q, k - 1, k - 1, 3)
    cr = torch.linalg.cross(a, b)
    d2l = torch.sum(cr * cr, dim=-1)                       # (Q, k-1 lines, k-1 cands)
    self_pair = torch.eye(k - 1, dtype=torch.bool, device=nbr.device)[None]
    inlier = (self_pair | (d2l < max_dist_inlier ** 2)) & found[:, None, 1:]
    line_ok = found[:, 1:]
    scores = torch.where(line_ok, torch.sum(inlier, dim=2), -1)
    best = torch.argmax(scores, dim=1)                     # first max, as jnp.argmax
    best_inliers = torch.gather(
        inlier, 1, best[:, None, None].expand(Q, 1, k - 1))[:, 0, :]
    sel = torch.cat([found[:, 0:1], best_inliers], dim=1)
    return sel & found


def _status_chain(kp_valid, enough, near, gates):
    """Rejection codes with the reference's precedence order."""
    status = torch.full(kp_valid.shape, int(MatchStatus.UNKNOWN), dtype=torch.uint8,
                        device=kp_valid.device)
    for gate, code in reversed(gates):
        status = torch.where(~gate, int(code), status)
    status = torch.where(~near, int(MatchStatus.NEIGHBORS_TOO_FAR), status)
    status = torch.where(~enough, int(MatchStatus.NOT_ENOUGH_NEIGHBORS), status)
    status = torch.where(~kp_valid, int(MatchStatus.UNKNOWN), status)
    return status


def rejection_histogram(matches: Matches):
    """Counts per MatchStatus (MatchingResults::RejectionsHistogram parity)."""
    return torch.bincount(matches.status.to(torch.int64),
                          minlength=int(MatchStatus.UNKNOWN) + 1)
