"""Match -> optimize ICP loop (PyTorch port of `lidarslam_tpu/ops/icp.py`,
`UndistortionMode.NONE`).

`icp_iters` rounds of (match every keypoint type, robust LM) with a linearly
shrinking Tukey saturation distance (Slam.cxx:892-954, 1071-1156). The
minimum-match guard and the state updates are `where`-gated as in the JAX
package. The early exit — the reference BREAKS when LM converges in one
step (Slam.cxx:950, 1151) — is a host branch: one read of the `active` flag
per round, which skips the remaining rounds' matcher and LM work.

With `MatchingConfig.reuse_knn` the map k-NN runs once, in round 0, and later
rounds reuse the neighbour coordinates with exact distances against the
refined pose: one kernel launch per keypoint type per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from lidarslam_tpu_torch.config import (Keypoint, MatchingConfig, SolverConfig,
                                        UndistortionMode)
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops import matcher, solver, voxel_map


class ICPInputs(NamedTuple):
    """Per-keypoint-type matching inputs (entries may be None when unused)."""

    kp_xyz: tuple       # (Q, 3) per type, BASE coordinates
    kp_valid: tuple     # (Q,) per type
    index: tuple        # SubmapView per type


class ICPResult(NamedTuple):
    pose: torch.Tensor            # (6,) optimized pose
    failed: torch.Tensor          # () bool — too few matches at some round
    total_matches: torch.Tensor   # () int32 from the last executed matching
    match_counts: torch.Tensor    # (3,) int32 per keypoint type
    H: torch.Tensor               # (6, 6) robust Hessian at the last solve
    statuses: tuple               # (Q,) uint8 per type — last-round debug codes
    weights: tuple                # (Q,) f32 per type


_MATCH_FNS = {Keypoint.EDGE: matcher.match_edges,
              Keypoint.PLANE: matcher.match_planes}


def saturation_schedule(it: int, icp_iters: int, params: MatchingConfig):
    """Round `it`'s Tukey saturation distance, in float32 as the JAX loop
    computes it from its traced round index."""
    ratio = np.float32(it) / np.float32(max(icp_iters - 1, 1))
    return (np.float32(1.0) - ratio) * np.float32(params.init_saturation_distance) \
        + ratio * np.float32(params.final_saturation_distance)


def icp_register(inputs: ICPInputs, types: Sequence[Keypoint], pose0,
                 params: MatchingConfig, solver_cfg: SolverConfig, icp_iters: int,
                 lm_max_iter: int, min_matches: int, prepared=None,
                 undistort_mode: UndistortionMode = UndistortionMode.NONE,
                 extras=()) -> ICPResult:
    """Run the ICP-LM loop from `pose0`. `prepared`: per-type
    `cuda_knn.KnnIndex` (built here when missing on CUDA)."""
    if undistort_mode != UndistortionMode.NONE:
        raise NotImplementedError("undistortion is not ported yet "
                                  "(ROADMAP.md, Queue 1: undistortion)")
    for t in types:
        if t not in _MATCH_FNS:
            raise NotImplementedError(f"{t.name} matching is not ported yet "
                                      "(ROADMAP.md, Queue 1: blobs)")
    pose = pose0.to(torch.float32)
    dev = pose.device
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.zeros((3,), dtype=torch.int32, device=dev)
    H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    statuses = tuple(torch.zeros(inputs.kp_xyz[int(t)].shape[0], dtype=torch.uint8,
                                 device=dev) for t in types)
    weights = tuple(torch.zeros(inputs.kp_xyz[int(t)].shape[0], dtype=torch.float32,
                                device=dev) for t in types)

    prepared = list(prepared) if prepared is not None else [None, None, None]
    for t in types:
        if prepared[int(t)] is None:
            prepared[int(t)] = voxel_map.prepare_knn_index(inputs.index[int(t)])

    k_of = {Keypoint.EDGE: params.edge_nb_neighbors,
            Keypoint.PLANE: params.plane_nb_neighbors}
    reuse = params.reuse_knn and icp_iters > 1
    knn_cache = None

    for it in range(icp_iters):
        sat = torch.tensor(saturation_schedule(it, icp_iters, params),
                           dtype=torch.float32, device=dev)
        if reuse and it == 0:
            knn_cache = []
            for t in types:
                ti = int(t)
                world = se3.japply_pose(pose, inputs.kp_xyz[ti])
                _, nbr, found = matcher.knn_query(inputs.index[ti], world, k_of[t],
                                                  params, inputs.kp_valid[ti],
                                                  prepared[ti])
                knn_cache.append((nbr, found))

        blocks = [_MATCH_FNS[t](inputs.kp_xyz[int(t)], inputs.kp_valid[int(t)],
                                inputs.index[int(t)], pose, params,
                                prepared=prepared[int(t)],
                                knn=knn_cache[i] if reuse else None)
                  for i, t in enumerate(types)]

        it_counts = torch.stack([b.n_matches.to(torch.int32) for b in blocks])
        it_total = torch.sum(it_counts, dtype=torch.int32)
        enough = it_total >= min_matches

        res = solver.robust_lm(blocks, pose, sat, solver_cfg, lm_max_iter,
                               extras=extras)

        pose = torch.where(enough, res.pose, pose)
        H = torch.where(enough, res.H, H)
        total = it_total
        counts = torch.zeros((3,), dtype=torch.int32, device=dev)
        for i, t in enumerate(types):
            counts[int(t)] = it_counts[i]
        statuses = tuple(b.status for b in blocks)
        weights = tuple(b.weight for b in blocks)
        failed = failed | ~enough
        active = enough & (res.n_success != 1)
        if not bool(active):      # host read: the reference's early exit
            break

    return ICPResult(pose=pose, failed=failed, total_matches=total,
                     match_counts=counts, H=H, statuses=statuses, weights=weights)
