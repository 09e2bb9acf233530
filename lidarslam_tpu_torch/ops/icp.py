"""Match -> optimize ICP loop (PyTorch port of `lidarslam_tpu/ops/icp.py`).

`icp_iters` rounds of (match every keypoint type, robust LM) with a linearly
shrinking Tukey saturation distance (Slam.cxx:892-954, 1071-1156). The
minimum-match guard and the state updates are `where`-gated on the device
`active` flag, as in the JAX package's loop body. Where the reference
BREAKS (LM converged in one step, Slam.cxx:950, 1151), `active` turns off:
all `icp_iters` rounds run and an inactive round changes nothing, as a
skipped round of the JAX `while_loop` does. The loop reads nothing on the
host, so a CUDA graph can capture it.

With `MatchingConfig.reuse_knn` the map k-NN runs once, in round 0, and later
rounds reuse the neighbour coordinates with exact distances against the
refined pose: one kernel launch per keypoint type per frame.

With `count=True` the loop also counts on the device the rounds whose gate
was still open when they began and the LM trips those rounds' solves began
before converging (`ICPResult.rounds`, `ICPResult.lm_steps`), read with the
step's other scalars.

Undistortion (ONCE / REFINED) warps the raw keypoints by the sweep motion
(`undistortion.compute_warp`) before they are matched: ONCE keeps the warp
of the prior pose for every round, REFINED rebuilds it from the current
pose from round 1 on. The final warp (of the last pose under REFINED) is
returned for the map update.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from lidarslam_tpu_torch.config import (Keypoint, MatchingConfig, SolverConfig,
                                        UndistortionMode)
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops import matcher, solver, undistortion, voxel_map
from lidarslam_tpu_torch.utils.timer import span


class ICPInputs(NamedTuple):
    """Per-keypoint-type matching inputs (entries may be None when unused)."""

    kp_xyz: tuple       # (Q, 3) per type, BASE coordinates
    kp_valid: tuple     # (Q,) per type
    index: tuple        # SubmapView per type
    kp_time: tuple = (None, None, None)  # (Q,) per type, for undistortion


class ICPResult(NamedTuple):
    pose: torch.Tensor            # (6,) optimized pose
    failed: torch.Tensor          # () bool — too few matches at some round
    total_matches: torch.Tensor   # () int32 from the last executed matching
    match_counts: torch.Tensor    # (3,) int32 per keypoint type
    H: torch.Tensor               # (6, 6) robust Hessian at the last solve
    statuses: tuple               # (Q,) uint8 per type — last-round debug codes
    weights: tuple                # (Q,) f32 per type
    warp: object = None           # final WarpParams (None when not undistorting)
    rounds: object = None         # () int32 rounds begun with the gate open (count)
    lm_steps: object = None       # () int32 LM trips of those rounds before convergence


_MATCH_FNS = {Keypoint.EDGE: matcher.match_edges,
              Keypoint.PLANE: matcher.match_planes,
              Keypoint.BLOB: matcher.match_blobs}


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
                 prev_pose=None, t_prev=None, t_cur=None, time_range=None,
                 max_extrapolation_ratio: float = 3.0, extras=(),
                 prune_radii=(None, None, None), mesh=None,
                 map_shard: bool = False, count: bool = False) -> ICPResult:
    """Run the ICP-LM loop from `pose0`. `prepared`: per-type
    `cuda_knn.KnnIndex` (built here when missing on CUDA). Undistortion
    needs `prev_pose`, the stamps `t_prev`, `t_cur` and the sweep's point
    `time_range` (time0, time1), all () float32 tensors. `prune_radii`: per
    type, the radius beyond which the kernel may skip map sub-blocks (None:
    the exact scan; `matcher.knn_radius`). `extras`: sensor residual blocks
    (sensors/constraints.py) that every LM evaluation adds.

    With `mesh` the keypoint arrays are this rank's slices: the match
    counts and the normal equations are summed over the ranks, so every
    rank steps the same pose. `map_shard`: the indices are this rank's
    slabs of slab-sharded maps; each k-NN then gathers the queries and
    merges the slabs' candidates (`matcher._knn`), and `reuse_knn` is off,
    as in the JAX package. `count`: count the open rounds and their live LM
    trips (see the module docstring)."""
    pose = pose0.to(torch.float32)
    dev = pose.device
    active = torch.ones((), dtype=torch.bool, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.zeros((3,), dtype=torch.int32, device=dev)
    H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    statuses = tuple(torch.zeros(inputs.kp_xyz[int(t)].shape[0], dtype=torch.uint8,
                                 device=dev) for t in types)
    weights = tuple(torch.zeros(inputs.kp_xyz[int(t)].shape[0], dtype=torch.float32,
                                device=dev) for t in types)

    undistort = undistort_mode != UndistortionMode.NONE and prev_pose is not None

    def make_warp(p):
        return undistortion.compute_warp(prev_pose, p, t_prev, t_cur, time_range[0],
                                         time_range[1], max_extrapolation_ratio)

    prior_warp = make_warp(pose) if undistort else None

    prepared = list(prepared) if prepared is not None else [None, None, None]
    for t in types:
        if prepared[int(t)] is None:
            prepared[int(t)] = voxel_map.prepare_knn_index(inputs.index[int(t)])

    k_of = {Keypoint.EDGE: params.edge_nb_neighbors,
            Keypoint.PLANE: params.plane_nb_neighbors,
            Keypoint.BLOB: params.blob_nb_neighbors}
    reuse = params.reuse_knn and icp_iters > 1 and not map_shard
    map_mesh = mesh if map_shard else None
    knn_cache = None
    opened, trips = [], []   # per round begun: its gate, its solve's live trips

    for it in range(icp_iters):
        with span("slam.icp.round"):
            sat = torch.full((), saturation_schedule(it, icp_iters, params),
                             dtype=torch.float32, device=dev)
            xs = list(inputs.kp_xyz)
            if undistort:
                # REFINED: the JAX loop's where(it > 0, make_warp(pose), prior)
                warp = make_warp(pose) if undistort_mode == UndistortionMode.REFINED \
                    and it > 0 else prior_warp
                for t in types:
                    xs[int(t)] = undistortion.warp_points(xs[int(t)], inputs.kp_time[int(t)],
                                                          warp)
            with span("slam.icp.match"):
                if reuse and it == 0:
                    knn_cache = []
                    for t in types:
                        ti = int(t)
                        world = se3.japply_pose(pose, xs[ti])
                        need_rings = t == Keypoint.EDGE and params.single_edge_per_ring
                        _, nbr, rings, found = matcher.knn_query(
                            inputs.index[ti], world, k_of[t], prune_radii[ti],
                            inputs.kp_valid[ti], prepared[ti], need_rings=need_rings,
                            map_mesh=map_mesh)
                        knn_cache.append((nbr, rings, found))

                blocks = [_MATCH_FNS[t](xs[int(t)], inputs.kp_valid[int(t)],
                                        inputs.index[int(t)], pose, params,
                                        prepared=prepared[int(t)],
                                        knn=knn_cache[i] if reuse else None,
                                        prune_radius=prune_radii[int(t)], map_mesh=map_mesh)
                          for i, t in enumerate(types)]

            it_counts = torch.stack([b.n_matches.to(torch.int32) for b in blocks])
            if mesh is not None:
                it_counts = mesh.psum(it_counts)
            it_total = torch.sum(it_counts, dtype=torch.int32)
            enough = it_total >= min_matches

            with span("slam.icp.solve"):
                res = solver.robust_lm(blocks, pose, sat, solver_cfg, lm_max_iter,
                                       extras=extras, mesh=mesh, count_trips=count)
            if count:
                opened.append(active)
                trips.append(res.trips)

            step_ok = active & enough
            pose = torch.where(step_ok, res.pose, pose)
            H = torch.where(step_ok, res.H, H)
            total = torch.where(active, it_total, total)
            full_counts = torch.zeros((3,), dtype=torch.int32, device=dev)
            for i, t in enumerate(types):
                full_counts[int(t)] = it_counts[i]
            counts = torch.where(active, full_counts, counts)
            statuses = tuple(torch.where(active, b.status, s)
                             for b, s in zip(blocks, statuses))
            weights = tuple(torch.where(active, b.weight, w)
                            for b, w in zip(blocks, weights))
            failed = failed | (active & ~enough)
            active = step_ok & (res.n_success != 1)

    final_warp = None
    if undistort:
        final_warp = make_warp(pose) if undistort_mode == UndistortionMode.REFINED \
            else prior_warp
    rounds = lm_steps = None
    if count:
        gate = torch.stack(opened).to(torch.int32)
        rounds = gate.sum(dtype=torch.int32)
        lm_steps = (gate * torch.stack(trips)).sum(dtype=torch.int32)
    return ICPResult(pose=pose, failed=failed, total_matches=total,
                     match_counts=counts, H=H, statuses=statuses, weights=weights,
                     warp=final_warp, rounds=rounds, lm_steps=lm_steps)
