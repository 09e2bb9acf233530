"""The per-sweep step (PyTorch port of `lidarslam_tpu/ops/pipeline.py`,
synchronous single-LiDAR subset).

`process_frame` runs keypoint extraction, scan-to-map localization ICP, the
keyframe gate and the rolling-map update for one sweep. The float64 world
bookkeeping stays on the host (slam.py). Where the JAX package decides on
device with `lax.cond`, this port branches on the host:

- the submap rebuild (`SubmapCache`) runs when the host-side `cache_stale`
  flag says the map changed since the last rebuild;
- the map update runs when the keyframe gate says so: the gate's outputs
  are read in the frame's one transfer of packed scalars
  (`pack_scalars`), and the update is issued after it. A keyframe then
  reads the maps' post-insert overflow counts in a second small transfer.

Ego-motion REGISTRATION, undistortion, overlap estimation, sensor
constraints and the multi-chip branches are not ported yet; each raises if
its configuration asks for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidarslam_tpu_torch.config import EgoMotionMode, SlamConfig, UndistortionMode
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops import extractor, icp, solver, voxel_map
from lidarslam_tpu_torch.ops.frame import ensure_range_image


class SubmapCache(NamedTuple):
    """Lazily rebuilt submap selection (the reference's kd-tree validity
    discipline, Slam.cxx:1008-1035): `selected` is the submap mask over map
    slots, `index` the k-NN kernel's map-side inputs (None on the CPU)."""

    selected: torch.Tensor   # (M,) bool
    index: object            # cuda_knn.KnnIndex or None


class FrameInputs(NamedTuple):
    """Per-frame scalars/poses (MAP-frame where positional)."""

    trel_prior: torch.Tensor     # (6,) extrapolated ego-motion prior
    prev_pose: torch.Tensor      # (6,) previous world pose, MAP frame
    stamp: float                 # current frame stamp
    az_resolution: float         # extractor azimuthal resolution [rad]
    kf_last_pose: torch.Tensor   # (6,) last keyframe pose, MAP frame
    kf_counter: int
    map_update: bool = True      # live map-update switch
    submap_cache: tuple = (None, None, None)  # per-type SubmapCache (or None)
    cache_stale: bool = True     # map changed since the last rebuild


class FrameResult(NamedTuple):
    maps: tuple                # VoxelMap per type (None when unused)
    keypoints: tuple           # Keypoints per type
    pose: torch.Tensor         # (6,) optimized world pose, MAP frame
    trel: torch.Tensor         # (6,) refined ego-motion estimate
    failed: torch.Tensor       # () bool
    total_matches: torch.Tensor  # () int32
    match_counts: torch.Tensor   # (3,) int32
    covariance: torch.Tensor     # (6, 6)
    roll_offset: torch.Tensor    # (3,) int32 — shared window shift applied
    is_keyframe: torch.Tensor    # () bool — the map was updated
    statuses: tuple              # (Q,) uint8 per used type
    weights: tuple               # (Q,) f32 per used type
    packed: np.ndarray           # (64,) host copy of pack_scalars
    submap_cache: tuple = (None, None, None)
    cache_stale: bool = True     # for the next frame



def pack_scalars(pose, trel, failed, total, counts, cov, roll_offset, is_kf,
                 overlap, map_overflow, kp_counts):
    """All host-bound scalars in one (64,) f32 tensor (one transfer)."""
    f = torch.float32
    return torch.cat([
        pose.to(f), trel.to(f), counts.to(f),
        torch.stack([failed.to(f), total.to(f), is_kf.to(f), overlap.to(f)]),
        cov.reshape(-1).to(f), roll_offset.to(f), map_overflow.to(f),
        kp_counts.to(f)])


def unpack_scalars(packed):
    """numpy (64,) -> dict mirroring pack_scalars."""
    return {
        "pose": np.asarray(packed[0:6], np.float64),
        "trel": np.asarray(packed[6:12], np.float64),
        "counts": packed[12:15].astype(np.int64),
        "failed": bool(packed[15] > 0.5),
        "total": int(packed[16]),
        "is_kf": bool(packed[17] > 0.5),
        "overlap": float(packed[18]),
        "cov": np.asarray(packed[19:55], np.float64).reshape(6, 6),
        "roll_offset": packed[55:58].astype(np.int64),
        "map_overflow": packed[58:61].astype(np.int64),
        "kp_counts": packed[61:64].astype(np.int64),
    }


def init_submap_cache(cfg: SlamConfig, map_cfgs, device):
    """Empty per-type SubmapCache tuple (stale: rebuilt on first use). Types
    with per-frame decay get no cache."""
    caches = [None, None, None]
    for t in cfg.used_types:
        mc = map_cfgs[int(t)]
        if mc.decaying_threshold > 0:
            continue
        caches[int(t)] = SubmapCache(
            selected=torch.zeros((mc.capacity,), dtype=torch.bool, device=device),
            index=None)
    return tuple(caches)


def check_supported(cfg: SlamConfig):
    """Raise for configurations whose branches are not ported yet."""
    if cfg.ego_motion_mode in (EgoMotionMode.REGISTRATION,
                               EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION):
        raise NotImplementedError("ego-motion REGISTRATION is not ported yet "
                                  "(ROADMAP.md, Queue 1)")
    if cfg.undistortion != UndistortionMode.NONE:
        raise NotImplementedError("undistortion is not ported yet (ROADMAP.md, Queue 1)")
    if cfg.confidence.overlap_sampling_ratio > 0:
        raise NotImplementedError("overlap estimation is not ported yet "
                                  "(ROADMAP.md, Queue 1)")
    if cfg.use_blobs:
        raise NotImplementedError("blob keypoints are not ported yet (ROADMAP.md, Queue 1)")
    if any(cfg.map_config(t).decaying_threshold > 0 for t in cfg.used_types):
        raise NotImplementedError("map decay (clear_old_points) is not ported yet")
    for t in cfg.used_types:
        voxel_map._check_sampling(cfg.map_config(t).sampling)


def process_frame(ri, maps: tuple, inp: FrameInputs, cfg: SlamConfig,
                  map_cfgs: tuple, first_frame: bool) -> FrameResult:
    """Full per-sweep step from a range image (or its byte wire)."""
    ri = ensure_range_image(ri)
    ext = extractor.extract_keypoints(ri, inp.az_resolution, cfg.extractor)
    return process_keypoints((ext.edges, ext.planes, ext.blobs), maps, inp, cfg,
                             map_cfgs, first_frame)


def _bbox(world, valid):
    big = 3e38
    lo = torch.where(valid[:, None], world, big).amin(dim=0)
    hi = torch.where(valid[:, None], world, -big).amax(dim=0)
    return lo, hi


def process_keypoints(kps: tuple, maps: tuple, inp: FrameInputs, cfg: SlamConfig,
                      map_cfgs: tuple, first_frame: bool) -> FrameResult:
    """Per-sweep step from already-extracted keypoints."""
    check_supported(cfg)
    types = cfg.used_types
    dev = inp.prev_pose.device
    trel = inp.trel_prior
    loc_prior = se3.jcompose_pose(inp.prev_pose, trel)
    new_cache = list(inp.submap_cache)

    # ---------------- localization ----------------
    if first_frame:
        pose = loc_prior
        failed = torch.zeros((), dtype=torch.bool, device=dev)
        total = torch.zeros((), dtype=torch.int32, device=dev)
        counts = torch.zeros((3,), dtype=torch.int32, device=dev)
        cov = torch.zeros((6, 6), dtype=torch.float32, device=dev)
        statuses = tuple(torch.zeros(kps[int(t)].xyz.shape[0], dtype=torch.uint8,
                                     device=dev) for t in types)
        wts = tuple(torch.zeros(kps[int(t)].xyz.shape[0], dtype=torch.float32,
                                device=dev) for t in types)
    else:
        index = [None, None, None]
        prepared = [None, None, None]
        for t in types:
            ti = int(t)
            m, kp, mc = maps[ti], kps[ti], map_cfgs[ti]
            if inp.submap_cache[ti] is None or inp.cache_stale:
                world = se3.japply_pose(loc_prior, kp.xyz)
                bbox_min, bbox_max = _bbox(world, kp.valid)
                view = voxel_map.extract_submap_view(
                    m, bbox_min, bbox_max, torch.div(kp.count, 2, rounding_mode="floor"), mc)
                if inp.submap_cache[ti] is not None:
                    new_cache[ti] = SubmapCache(selected=view.valid,
                                                index=voxel_map.prepare_knn_index(view))
            else:
                view = voxel_map.SubmapView(xyz=m.xyz, ring=None,
                                            valid=inp.submap_cache[ti].selected)
            index[ti] = view
            if new_cache[ti] is not None:
                prepared[ti] = new_cache[ti].index

        res = icp.icp_register(
            icp.ICPInputs(kp_xyz=tuple(k.xyz for k in kps),
                          kp_valid=tuple(k.valid for k in kps), index=tuple(index)),
            types=types, pose0=loc_prior, params=cfg.loc_matching,
            solver_cfg=cfg.solver, icp_iters=cfg.localization_icp_max_iter,
            lm_max_iter=cfg.localization_lm_max_iter,
            min_matches=cfg.min_nb_matched_keypoints, prepared=tuple(prepared))

        failed = res.failed
        pose = torch.where(failed, inp.prev_pose, res.pose)  # rollback (Slam.cxx:1098-1107)
        total = res.total_matches
        counts = res.match_counts
        cov = torch.where(failed, 0.0, solver.pose_covariance(res.H))
        statuses = res.statuses
        wts = res.weights
        trel = torch.where(failed, 0.0, _relative_pose(inp.prev_pose, pose))

    # ---------------- keyframe gate ----------------
    kf_motion = _relative_pose(inp.kf_last_pose, pose)
    trans = torch.linalg.vector_norm(kf_motion[:3])
    R_m, _ = se3.jpose_to_rt(kf_motion)
    rot = torch.acos(torch.clamp((torch.trace(R_m) - 1.0) / 2.0, -1.0, 1.0))
    coef = np.float32(min(np.float32(inp.kf_counter) / np.float32(10.0), 1.0))
    n_map_pts = sum(maps[int(t)].n_points for t in types)
    is_kf = ((n_map_pts < cfg.min_nb_matched_keypoints * 10)
             | (trans >= float(coef * np.float32(cfg.kf_distance_threshold)))
             | (rot >= float(np.deg2rad(coef * np.float32(cfg.kf_angle_threshold)))))
    do_update = is_kf & ~failed & bool(inp.map_update)

    # union world bbox of keypoints -> one shared roll offset
    world_kp = [None, None, None]
    bbox_min = torch.full((3,), 3e38, dtype=torch.float32, device=dev)
    bbox_max = torch.full((3,), -3e38, dtype=torch.float32, device=dev)
    for t in types:
        kp = kps[int(t)]
        w = se3.japply_pose(pose, kp.xyz)
        world_kp[int(t)] = w
        lo, hi = _bbox(w, kp.valid)
        bbox_min = torch.minimum(bbox_min, lo)
        bbox_max = torch.maximum(bbox_max, hi)
    shared_cfg = map_cfgs[int(types[0])]
    res_m = voxel_map.effective_resolution(shared_cfg)
    offset = voxel_map.compute_roll_offset(bbox_min, bbox_max, shared_cfg)
    offset = torch.where(do_update, offset, 0)

    map_overflow = _overflow(maps, dev)
    kp_counts = torch.stack([kps[i].count for i in range(3)])
    overlap = torch.full((), -1.0, device=dev)
    # the frame's one device->host transfer: everything the host needs, and
    # the keyframe decision that gates the map update below. map_overflow is
    # the cumulative count before this frame's insert; a keyframe re-reads it
    # after the insert.
    packed = pack_scalars(pose, trel, failed, total, counts, cov, offset,
                          do_update, overlap, map_overflow, kp_counts).cpu().numpy()

    # ---------------- map update (host branch on the keyframe gate) --------
    new_maps = list(maps)
    updated = bool(packed[17] > 0.5)
    if updated:
        for t in types:
            ti = int(t)
            kp = kps[ti]
            shifted = world_kp[ti] - offset.to(torch.float32) * res_m
            m = voxel_map.roll_by_offset(maps[ti], offset, map_cfgs[ti])
            new_maps[ti] = voxel_map.add_points(m, shifted, kp.intensity, kp.time,
                                                kp.valid, inp.stamp, map_cfgs[ti],
                                                fixed=False)
        packed[58:61] = _overflow(new_maps, dev).cpu().numpy()

    return FrameResult(
        maps=tuple(new_maps), keypoints=tuple(kps), pose=pose, trel=trel,
        failed=failed, total_matches=total, match_counts=counts, covariance=cov,
        roll_offset=offset, is_keyframe=do_update, statuses=statuses, weights=wts,
        packed=packed, submap_cache=tuple(new_cache),
        # a map update invalidates the submap selection; first_frame skips
        # matching, so its cache is never built
        cache_stale=True if first_frame else updated)


def _overflow(maps, device):
    """(3,) cumulative leaves each map dropped at capacity (0 when unused)."""
    return torch.stack([m.overflow if m is not None
                        else torch.zeros((), dtype=torch.int32, device=device)
                        for m in maps])


def _relative_pose(pose_a, pose_b):
    """xyzrpy of A^-1 B."""
    Ra, ta = se3.jpose_to_rt(pose_a)
    Rb, tb = se3.jpose_to_rt(pose_b)
    return se3.jrt_to_pose(Ra.T @ Rb, Ra.T @ (tb - ta))
