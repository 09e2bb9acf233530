"""The per-sweep step and the streaming step (PyTorch port of
`lidarslam_tpu/ops/pipeline.py`).

`process_frame` runs keypoint extraction, the optional scan-to-scan
ego-motion ICP, scan-to-map localization ICP (with ONCE / REFINED
undistortion), the LCP overlap, the keyframe gate and the rolling-map update
for one sweep. Where the JAX package decides on device with `lax.cond` /
`while_loop`, this port has two forms of `process_keypoints`:

- synchronous (`Slam.add_frame`): host branches. The submap rebuild
  (`SubmapCache`) runs when the host-side `cache_stale` flag says the map
  changed since the last rebuild; both ICP loops (ego-motion and
  localization) exit early on a host read; the keyframe gate travels in the
  frame's one transfer of packed scalars (`pack_scalars`) and the map
  update is issued after it. A keyframe then reads the maps' post-insert
  overflow counts in a second small transfer.
- `sync_free=True` (the streaming step, and `Slam.add_frame` on one CUDA
  device): no host read. The submap rebuild and the map update are
  computed every frame and `torch.where`-selected on the device flags,
  both ICP loops run every round, gated, and the packed scalars stay on
  the device, so a CUDA graph can capture the step (ops/stream_graph.py).
  `_stream_step` chains the device `StreamState` from frame to frame;
  `add_frame`'s graph takes the host's inputs each sweep.

Both forms compute the keyframe thresholds from the keyframe counter on the
device, and the covariance by a Jacobi pseudo-inverse (solver.py).

Every single-LiDAR option runs on both forms: blobs with the blob map, the
five leaf-sampling modes, map decay (`clear_old_points`, before the submap
view, so a decaying type rebuilds its submap every frame and keeps no
`SubmapCache`) and the sensor residual blocks (`FrameInputs.extras`, added
to the localization LM). A multi-LiDAR acquisition enters as merged
keypoints (`process_keypoints`, `process_keypoints_stream`), with no range
image and so no overlap.

On a mesh (`mesh`: a `parallel.sharded.Mesh`; every rank calls the step
with the same sweep) the ICPs match this rank's contiguous 1/n of each
keypoint type and sum their counts and normal equations over the ranks,
and the per-keypoint statuses and weights are gathered back, so every
output is replicated. The submap is rebuilt every frame (no
`SubmapCache`), as in the JAX package. `shard_extraction` splits the
extractor over rings (`extract_sharded`); `shard_maps` keeps in `maps`
this rank's slabs of slab-sharded maps (`parallel/sharded_map.py`): the
matcher's k-NN merges every slab's candidates, the overlap takes the
minimum over the slabs, the keyframe gate sums the map sizes, and the
update rolls with ring migration and inserts into the rank's slab, with
`overflow` the global total.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from lidarslam_tpu_torch import confidence
from lidarslam_tpu_torch.config import (EgoMotionMode, Keypoint, SlamConfig,
                                        UndistortionMode)
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops import extractor, icp, matcher, solver, undistortion, voxel_map
from lidarslam_tpu_torch.ops.frame import (FlatRangeImage, Keypoints, ensure_range_image,
                                           flatten_keypoints, merge_keypoints)
from lidarslam_tpu_torch.parallel import sharded_map
from lidarslam_tpu_torch.utils.timer import device_mark, span


class SubmapCache(NamedTuple):
    """Lazily rebuilt submap selection (the reference's kd-tree validity
    discipline, Slam.cxx:1008-1035): `selected` is the submap mask over map
    slots, `index` the k-NN kernel's map-side inputs (`cuda_knn.KnnIndex`;
    None on the CPU)."""

    selected: torch.Tensor   # (M,) bool
    index: object            # cuda_knn.KnnIndex or None


class FrameInputs(NamedTuple):
    """Per-frame scalars/poses (MAP-frame where positional). The scalars are
    host values on the synchronous path and () device tensors in the
    streaming step."""

    trel_prior: torch.Tensor     # (6,) extrapolated ego-motion prior
    prev_pose: torch.Tensor      # (6,) previous world pose, MAP frame
    t_prev: object               # previous frame stamp
    stamp: object                # current frame stamp
    az_resolution: object        # extractor azimuthal resolution [rad]
    kf_last_pose: torch.Tensor   # (6,) last keyframe pose, MAP frame
    kf_counter: object           # keyframes so far
    extras: tuple = ()           # sensor residual blocks (sensors/constraints.py)
    map_update: object = True    # live map-update switch
    submap_cache: tuple = (None, None, None)  # per-type SubmapCache (or None)
    cache_stale: object = True   # map changed since the last rebuild


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
    overlap: torch.Tensor        # () LCP overlap (-1 when disabled)
    warp: object                 # final WarpParams or None
    statuses: tuple              # (Q,) uint8 per used type
    weights: tuple               # (Q,) f32 per used type
    packed: object               # (PACKED_LEN,) pack_scalars: a host copy (numpy)
                                 # on the synchronous path, a tensor when sync-free
    submap_cache: tuple = (None, None, None)
    cache_stale: object = True   # for the next frame


PACKED_LEN = 72


def pack_scalars(pose, trel, failed, total, counts, cov, roll_offset, is_kf,
                 overlap, map_overflow, kp_counts, ego_trel, ego_counts):
    """All host-bound scalars in one (PACKED_LEN,) f32 tensor (one
    transfer). The first 64 are the JAX package's packed scalars; then the
    ego-motion registration's refined estimate (its prior where the stage
    did not run or failed) and its device counts (open rounds, live LM
    trips; 0 where it did not run)."""
    f = torch.float32
    return torch.cat([
        pose.to(f), trel.to(f), counts.to(f),
        torch.stack([failed.to(f), total.to(f), is_kf.to(f), overlap.to(f)]),
        cov.reshape(-1).to(f), roll_offset.to(f), map_overflow.to(f),
        kp_counts.to(f), ego_trel.to(f), ego_counts.to(f)])


def unpack_scalars(packed):
    """numpy (PACKED_LEN,) -> dict mirroring pack_scalars."""
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
        "ego_trel": np.asarray(packed[64:70], np.float64),
        "ego_rounds": int(packed[70]),
        "ego_lm_steps": int(packed[71]),
    }


def init_submap_cache(cfg: SlamConfig, map_cfgs, device, sharded: bool = False):
    """Empty per-type SubmapCache tuple (stale: rebuilt on first use), with
    the structure the step produces (a KnnIndex of the empty selection on
    CUDA). Types with per-frame decay get no cache, nor does a mesh
    (`sharded`), whose step rebuilds the submap every frame."""
    caches = [None, None, None]
    if sharded:
        return tuple(caches)
    for t in cfg.used_types:
        mc = map_cfgs[int(t)]
        if mc.decaying_threshold > 0:
            continue
        sel = torch.zeros((mc.capacity,), dtype=torch.bool, device=device)
        view = voxel_map.SubmapView(
            xyz=torch.zeros((mc.capacity, 3), dtype=torch.float32, device=device),
            ring=None, valid=sel)
        caches[int(t)] = SubmapCache(selected=sel, index=voxel_map.prepare_knn_index(view))
    return tuple(caches)


def process_frame(ri, maps: tuple, prev_keypoints: tuple, inp: FrameInputs,
                  cfg: SlamConfig, map_cfgs: tuple, first_frame: bool, mesh=None,
                  shard_maps: bool = False, shard_extraction: bool = False,
                  sync_free: bool = False) -> FrameResult:
    """Full per-sweep step from a range image (or one of its wires);
    `prev_keypoints`: the previous sweep's Keypoints per type (ego-motion
    registration's target). `sync_free`: the form with no host read, which
    `Slam.add_frame` replays as a CUDA graph (ops/stream_graph.FrameGraph);
    `mesh`, `shard_maps`, `shard_extraction`: see the module docstring."""
    ri = ensure_range_image(ri)
    return process_keypoints(_extract(ri, inp.az_resolution, cfg, mesh, shard_extraction),
                             ri, maps, prev_keypoints, inp, cfg, map_cfgs, first_frame,
                             sync_free=sync_free, mesh=mesh, shard_maps=shard_maps)


def _extract(ri, az_res, cfg: SlamConfig, mesh, shard_extraction: bool):
    with span("slam.extract"):
        if shard_extraction and mesh is not None:
            return extract_sharded(ri, az_res, cfg, mesh)
        ext = extractor.extract_keypoints(ri, az_res, cfg.extractor)
        return ext.edges, ext.planes, ext.blobs


def extract_sharded(ri, az_res, cfg: SlamConfig, mesh):
    """Ring-sharded keypoint extraction: every extraction stage is
    per-ring independent, so each rank extracts its contiguous R/n-ring
    slice of the (replicated) range image with a K/n keypoint budget, and
    the per-type sets are gathered and compacted back to the full
    capacity. Per-rank K/n budgets change which keypoints survive only at
    capacity saturation (the even-spread compaction then runs per slice
    instead of globally)."""
    ecfg = cfg.extractor
    n = mesh.size
    R = ecfg.n_rings
    caps = tuple(ecfg.kp_capacity(i) for i in range(3))
    if R % n or any(K % n for K in caps):
        raise ValueError(f"shard_extraction needs n_rings ({R}) and every keypoint "
                         f"capacity ({caps}) divisible by the mesh size ({n})")
    rows = R // n
    start = mesh.rank * rows
    ri_s = type(ri)(*(a[start:start + rows] for a in ri))
    ecfg_s = dataclasses.replace(
        ecfg, n_rings=rows, max_keypoints=ecfg.max_keypoints // n,
        max_edge_keypoints=ecfg.max_edge_keypoints // n,
        max_plane_keypoints=ecfg.max_plane_keypoints // n,
        max_blob_keypoints=ecfg.max_blob_keypoints // n)
    ext = extractor.extract_keypoints(ri_s, az_res, ecfg_s)
    out = []
    for K, kp in zip(caps, (ext.edges, ext.planes, ext.blobs)):
        kp = kp._replace(ring=torch.where(kp.valid, kp.ring + start, kp.ring))
        g = Keypoints(*(mesh.all_gather(a, tiled=True) for a in kp[:-1]), count=kp.count)
        # compact valid-first so downstream capacity slices stay dense
        # (merge_keypoints counts the valid slots itself)
        out.append(merge_keypoints([g], K))
    return tuple(out)


def _bbox(world, valid):
    big = 3e38
    lo = torch.where(valid[:, None], world, big).amin(dim=0)
    hi = torch.where(valid[:, None], world, -big).amax(dim=0)
    return lo, hi


def process_keypoints(kps: tuple, ri, maps: tuple, prev_keypoints: tuple,
                      inp: FrameInputs, cfg: SlamConfig, map_cfgs: tuple,
                      first_frame: bool, sync_free: bool = False, mesh=None,
                      shard_maps: bool = False) -> FrameResult:
    """Per-sweep step from already-extracted keypoints; `ri` (a RangeImage,
    or None) is sampled for the overlap. `sync_free`: the streaming form,
    with no host read; `mesh`, `shard_maps`: the multi-device forms (see
    module docstring)."""
    types = cfg.used_types
    dev = inp.prev_pose.device
    if shard_maps and mesh is None:
        raise ValueError("shard_maps requires a mesh")
    if mesh is not None:
        for t in types:
            if kps[int(t)].xyz.shape[0] % mesh.size:
                raise ValueError(f"extractor.max_keypoints ({kps[int(t)].xyz.shape[0]}) "
                                 f"must be divisible by the mesh size ({mesh.size})")
    map_mesh = mesh if shard_maps else None

    # ---------------- ego-motion registration (optional) ----------------
    trel = inp.trel_prior
    ego_counts = torch.zeros((2,), dtype=torch.int32, device=dev)
    if cfg.ego_motion_mode in (EgoMotionMode.REGISTRATION,
                               EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION) \
            and prev_keypoints is not None and not first_frame:
        with span("slam.ego"):
            trel, ego_counts = _ego_registration(kps, prev_keypoints, trel, cfg, sync_free,
                                                 mesh)
    ego_trel = trel

    loc_prior = se3.jcompose_pose(inp.prev_pose, trel)
    new_cache = list(inp.submap_cache)
    warp = None
    overlap = torch.full((), -1.0, device=dev)

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
        maps = list(maps)
        with span("slam.submap"):
            for t in types:
                ti = int(t)
                mc = map_cfgs[ti]
                if mc.decaying_threshold > 0:
                    maps[ti] = voxel_map.clear_old_points(maps[ti], inp.stamp, mc)
                m, kp = maps[ti], kps[ti]
                cache = inp.submap_cache[ti]
                view = None
                if cache is None or sync_free or inp.cache_stale:
                    world = se3.japply_pose(loc_prior, kp.xyz)
                    bbox_min, bbox_max = _bbox(world, kp.valid)
                    view = voxel_map.extract_submap_view(
                        m, bbox_min, bbox_max, torch.div(kp.count, 2, rounding_mode="floor"),
                        mc, mesh=map_mesh)
                    if cache is not None:
                        fresh = SubmapCache(selected=view.valid,
                                            index=voxel_map.prepare_knn_index(view))
                        # sync-free: the JAX package's lax.cond on cache_stale,
                        # computed every frame and selected
                        new_cache[ti] = _select(inp.cache_stale, fresh, cache) \
                            if sync_free else fresh
                if new_cache[ti] is not None:
                    view = voxel_map.SubmapView(xyz=m.xyz, ring=None,
                                                valid=new_cache[ti].selected)
                    prepared[ti] = new_cache[ti].index
                else:   # per-frame submap (decay): one index for the ICP and the overlap
                    prepared[ti] = voxel_map.prepare_knn_index(view)
                index[ti] = view

        undist_kwargs = {}
        if cfg.undistortion != UndistortionMode.NONE:
            undist_kwargs = dict(
                undistort_mode=cfg.undistortion, prev_pose=inp.prev_pose,
                t_prev=voxel_map.device_f32(inp.t_prev, dev),
                t_cur=voxel_map.device_f32(inp.stamp, dev),
                time_range=_time_range(kps, types, dev),
                max_extrapolation_ratio=cfg.max_extrapolation_ratio)
        sl = (lambda a: a) if mesh is None else mesh.shard_slice
        with span("slam.icp"):
            res = icp.icp_register(
                icp.ICPInputs(kp_xyz=tuple(sl(k.xyz) for k in kps),
                              kp_valid=tuple(sl(k.valid) for k in kps), index=tuple(index),
                              kp_time=tuple(sl(k.time) for k in kps)),
                types=types, pose0=loc_prior, params=cfg.loc_matching,
                solver_cfg=cfg.solver, icp_iters=cfg.localization_icp_max_iter,
                lm_max_iter=cfg.localization_lm_max_iter,
                min_matches=cfg.min_nb_matched_keypoints, prepared=tuple(prepared),
                extras=inp.extras, gated=sync_free,
                prune_radii=(None,) * 3 if shard_maps
                else tuple(matcher.knn_radius(t, cfg.loc_matching) for t in Keypoint),
                mesh=mesh, map_shard=shard_maps, **undist_kwargs)

        failed = res.failed
        pose = torch.where(failed, inp.prev_pose, res.pose)  # rollback (Slam.cxx:1098-1107)
        total = res.total_matches
        counts = res.match_counts
        cov = torch.where(failed, 0.0, solver.pose_covariance(res.H))
        statuses = res.statuses
        wts = res.weights
        if mesh is not None:
            # the per-keypoint debug surface, reassembled on every rank
            statuses = tuple(mesh.all_gather(x, tiled=True) for x in statuses)
            wts = tuple(mesh.all_gather(x, tiled=True) for x in wts)
        warp = res.warp
        trel = torch.where(failed, 0.0, _relative_pose(inp.prev_pose, pose))
        if cfg.confidence.overlap_sampling_ratio > 0 and ri is not None:
            with span("slam.overlap"):
                overlap = _overlap(ri, pose, index, cfg, map_cfgs, warp, prepared, map_mesh)

    # ---------------- keyframe gate ----------------
    kf_motion = _relative_pose(inp.kf_last_pose, pose)
    trans = torch.linalg.vector_norm(kf_motion[:3])
    R_m, _ = se3.jpose_to_rt(kf_motion)
    rot = torch.acos(torch.clamp((torch.trace(R_m) - 1.0) / 2.0, -1.0, 1.0))
    # keyframe thresholds ramp up over the first 10 keyframes
    kf_counter = inp.kf_counter if isinstance(inp.kf_counter, torch.Tensor) \
        else torch.full((), inp.kf_counter, dtype=torch.int32, device=dev)
    coef = torch.clamp(kf_counter.to(torch.float32) / 10.0, max=1.0)
    dist_thr = coef * cfg.kf_distance_threshold
    ang_thr = torch.deg2rad(coef * cfg.kf_angle_threshold)
    n_map_pts = sum(maps[int(t)].n_points for t in types)
    if shard_maps:
        n_map_pts = mesh.psum(n_map_pts)
    is_kf = ((n_map_pts < cfg.min_nb_matched_keypoints * 10)
             | (trans >= dist_thr) | (rot >= ang_thr))
    do_update = is_kf & ~failed & inp.map_update

    # union world bbox of keypoints -> one shared roll offset
    world_kp = [None, None, None]
    bbox_min = torch.full((3,), 3e38, dtype=torch.float32, device=dev)
    bbox_max = torch.full((3,), -3e38, dtype=torch.float32, device=dev)
    for t in types:
        kp = kps[int(t)]
        base = kp.xyz if warp is None else undistortion.warp_points(kp.xyz, kp.time, warp)
        w = se3.japply_pose(pose, base)
        world_kp[int(t)] = w
        lo, hi = _bbox(w, kp.valid)
        bbox_min = torch.minimum(bbox_min, lo)
        bbox_max = torch.maximum(bbox_max, hi)
    shared_cfg = map_cfgs[int(types[0])]
    offset = voxel_map.compute_roll_offset(bbox_min, bbox_max, shared_cfg)
    offset = torch.where(do_update, offset, 0)

    def update(ti):
        kp = kps[ti]
        shifted = world_kp[ti] - offset.to(torch.float32) * voxel_map.effective_resolution(
            shared_cfg)
        if shard_maps:
            # overflow stays the global total: this frame's per-slab drops
            # of the roll and the insert are summed over the ranks
            m = maps[ti]
            m = m._replace(overflow=torch.zeros_like(m.overflow))
            m = sharded_map.shard_roll(m, offset, map_cfgs[ti], mesh, sync_free=sync_free)
            m = sharded_map.shard_add_points(m, shifted, kp.intensity, kp.time, kp.valid,
                                             inp.stamp, map_cfgs[ti], False, mesh)
            return m._replace(overflow=maps[ti].overflow + mesh.psum(m.overflow))
        m = voxel_map.roll_by_offset(maps[ti], offset, map_cfgs[ti])
        return voxel_map.add_points(m, shifted, kp.intensity, kp.time, kp.valid,
                                    inp.stamp, map_cfgs[ti], fixed=False)

    kp_counts = torch.stack([kps[i].count for i in range(3)])
    new_maps = list(maps)
    if sync_free:
        # the JAX package's lax.cond on do_update: computed every frame and
        # selected, so a non-keyframe keeps exactly the old map tensors'
        # values (overflow included: the update adds the frame's drops once)
        with span("slam.map_update"):
            for t in types:
                new_maps[int(t)] = _select(do_update, update(int(t)), maps[int(t)])
        packed = pack_scalars(pose, trel, failed, total, counts, cov, offset, do_update,
                              overlap, _overflow(new_maps, dev), kp_counts, ego_trel,
                              ego_counts)
        cache_stale = torch.ones((), dtype=torch.bool, device=dev) if first_frame \
            else do_update
    else:
        # the frame's one device->host transfer: everything the host needs,
        # and the keyframe decision that gates the map update below.
        # map_overflow is the cumulative count before this frame's insert; a
        # keyframe re-reads it after the insert.
        packed = pack_scalars(pose, trel, failed, total, counts, cov, offset, do_update,
                              overlap, _overflow(maps, dev), kp_counts, ego_trel,
                              ego_counts)
        with span("slam.sync"):
            packed = packed.cpu().numpy()
        updated = bool(packed[17] > 0.5)
        if updated:
            with span("slam.map_update"):
                for t in types:
                    new_maps[int(t)] = update(int(t))
                overflow = _overflow(new_maps, dev)
                with span("slam.sync"):
                    packed[58:61] = overflow.cpu().numpy()
        # a map update invalidates the submap selection; first_frame skips
        # matching, so its cache is never built
        cache_stale = True if first_frame else updated

    return FrameResult(
        maps=tuple(new_maps), keypoints=tuple(kps), pose=pose, trel=trel,
        failed=failed, total_matches=total, match_counts=counts, covariance=cov,
        roll_offset=offset, is_keyframe=do_update, overlap=overlap, warp=warp,
        statuses=statuses, weights=wts, packed=packed, submap_cache=tuple(new_cache),
        cache_stale=cache_stale)


def _ego_registration(kps, prev_keypoints, trel_prior, cfg: SlamConfig, gated: bool,
                      mesh=None):
    """Scan-to-scan ICP of this sweep's edges and planes against the
    previous sweep's (JAX pipeline.py:277-306). Returns the refined
    ego-motion, or the prior where the ICP fails (an empty previous set
    fails it), and (2,) int32 device counts: the rounds begun with the gate
    open and their LM trips begun before convergence. The index is the
    previous keypoints in extraction order, searched by the exact scan (no
    prune radius): at most 4096 slots, and the per-ring filter's `near`
    gate, like the RANSAC one, reads only the selected neighbours. With
    `mesh` each rank matches its slice of this sweep's keypoints against
    all of the previous sweep's (replicated). On CUDA the stage lies
    between the marker kernels `slam_mark_ego_begin` and `slam_mark_ego_end`
    (utils/timer.device_mark). Its plain float64 reference is
    `reference/ego_registration.py`."""
    ego_types = tuple(t for t in (Keypoint.EDGE, Keypoint.PLANE) if cfg.use_keypoints(t))
    index = [None, None, None]
    for t in ego_types:
        pk = prev_keypoints[int(t)]
        index[int(t)] = voxel_map.SubmapView(xyz=pk.xyz, ring=pk.ring, valid=pk.valid)
    sl = (lambda a: a) if mesh is None else mesh.shard_slice
    device_mark("ego_begin", trel_prior.device)
    ego = icp.icp_register(
        icp.ICPInputs(kp_xyz=tuple(sl(k.xyz) for k in kps),
                      kp_valid=tuple(sl(k.valid) for k in kps), index=tuple(index)),
        types=ego_types, pose0=trel_prior, params=cfg.ego_matching,
        solver_cfg=cfg.solver, icp_iters=cfg.ego_motion_icp_max_iter,
        lm_max_iter=cfg.ego_motion_lm_max_iter,
        min_matches=cfg.min_nb_matched_keypoints, gated=gated, mesh=mesh, count=True)
    device_mark("ego_end", trel_prior.device)
    return (torch.where(ego.failed, trel_prior, ego.pose),
            torch.stack([ego.rounds, ego.lm_steps]))


def _time_range(kps, types, device):
    """(time0, time1): the sweep's point-time range over the valid
    keypoints of every used type, on the device."""
    tmin = torch.full((), 3e38, dtype=torch.float32, device=device)
    tmax = torch.full((), -3e38, dtype=torch.float32, device=device)
    for t in types:
        kp = kps[int(t)]
        tmin = torch.minimum(tmin, torch.where(kp.valid, kp.time, 3e38).amin())
        tmax = torch.maximum(tmax, torch.where(kp.valid, kp.time, -3e38).amax())
    return tmin, tmax


def _overlap(ri, pose, indices, cfg: SlamConfig, map_cfgs, warp, prepared, map_mesh=None):
    """LCP overlap of a strided sample of the registered sweep against the
    localization submaps (JAX pipeline.py:712-734), reusing their k-NN
    indices; `map_mesh`: the submaps are this rank's slabs."""
    flat = ri.xyz.reshape(-1, 3)
    n = flat.shape[0]
    take = min(cfg.confidence.overlap_max_samples,
               max(int(n * cfg.confidence.overlap_sampling_ratio), 1))
    stride = max(n // take, 1)
    sample = flat[::stride][:take]
    svalid = ri.valid.reshape(-1)[::stride][:take].contiguous()
    if warp is not None:
        sample = undistortion.warp_points(sample, ri.time.reshape(-1)[::stride][:take], warp)
    world = se3.japply_pose(pose, sample)
    types = cfg.used_types
    return confidence.lcp_overlap(world, svalid, [indices[int(t)] for t in types],
                                  [map_cfgs[int(t)].leaf_size for t in types],
                                  prepared=[prepared[int(t)] for t in types],
                                  mesh=map_mesh)


def _select(cond, a, b):
    """`torch.where(cond, a, b)` over matching NamedTuples of tensors (None
    leaves stay None)."""
    if a is None:
        return None
    return type(a)(*(_select(cond, x, y) if isinstance(x, tuple) or x is None
                     else torch.where(cond, x, y) for x, y in zip(a, b)))


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


# -----------------------------------------------------------------------------
#   Streaming (device-chained) mode
# -----------------------------------------------------------------------------

class StreamState(NamedTuple):
    """Device-resident cross-frame state of the streaming mode: the
    ego-motion prior is extrapolated on the device from the two previous
    poses, and the keyframe state and the rolling origin accumulate there,
    so nothing goes to the host until `Slam.flush`."""

    maps: tuple            # VoxelMap per type (None when unused)
    prev_keypoints: tuple  # Keypoints per type (previous sweep)
    pose: torch.Tensor     # (6,) latest pose, current MAP frame
    prev_pose: torch.Tensor  # (6,) pose before it, current MAP frame
    t_cur: torch.Tensor    # () stamp of `pose`
    t_prev: torch.Tensor   # () stamp of `prev_pose`
    kf_pose: torch.Tensor  # (6,) last keyframe pose, current MAP frame
    kf_counter: torch.Tensor  # () int32
    origin_vox: torch.Tensor  # (3,) int32 accumulated window shifts
    n_frames: torch.Tensor    # () int32
    map_update: torch.Tensor  # () bool, live map-update switch
    submap_cache: tuple = (None, None, None)  # per-type SubmapCache
    cache_stale: torch.Tensor = None          # () bool


def process_frame_stream(ri, state: StreamState, stamp, az_res, cfg: SlamConfig,
                         map_cfgs: tuple, first_frame: bool, extras=(), mesh=None,
                         shard_maps: bool = False, shard_extraction: bool = False):
    """One chained streaming step: (state', packed (PACKED_LEN + 3,),
    kps_flat — one (7K+1,) log buffer per type, frame.flatten_keypoints).

    packed = pack_scalars + origin_vox after this frame (3); its poses
    are relative to the origin before this frame's roll. `stamp` and
    `az_res` are () float32 device tensors; `extras` the sweep's sensor
    residual blocks, as device tensors. On a mesh the state's maps are
    replicated, or this rank's slabs with `shard_maps`; the step's
    collectives are read by the host, so a mesh step runs eagerly."""
    ri = ensure_range_image(ri)
    return _stream_step(_extract(ri, az_res, cfg, mesh, shard_extraction), ri, state, stamp,
                        az_res, cfg, map_cfgs, first_frame, extras, mesh, shard_maps)


def process_keypoints_stream(kps: tuple, state: StreamState, stamp, az_res, cfg: SlamConfig,
                             map_cfgs: tuple, first_frame: bool, extras=(), mesh=None,
                             shard_maps: bool = False):
    """The streaming step from pre-extracted keypoints (a multi-LiDAR
    acquisition's merged sets, `Slam.add_frames_async`): `_stream_step`
    with no range image, so no overlap. Returns what `process_frame_stream`
    returns."""
    return _stream_step(kps, None, state, stamp, az_res, cfg, map_cfgs, first_frame, extras,
                        mesh, shard_maps)


def _stream_step(kps, ri, state: StreamState, stamp, az_res, cfg: SlamConfig, map_cfgs,
                 first_frame: bool, extras=(), mesh=None, shard_maps: bool = False):
    dev = state.pose.device
    # in-graph constant-velocity extrapolation (Slam.cxx:821-836)
    Rw, tw = undistortion.jinterpolate_pose(state.prev_pose, state.pose, stamp,
                                            state.t_prev, state.t_cur,
                                            cfg.max_extrapolation_ratio)
    trel = _relative_pose(state.pose, se3.jrt_to_pose(Rw, tw))
    trel = torch.where(state.n_frames >= 2, trel, 0.0)

    inp = FrameInputs(
        trel_prior=trel, prev_pose=state.pose, t_prev=state.t_cur, stamp=stamp,
        az_resolution=az_res,
        kf_last_pose=state.kf_pose, kf_counter=state.kf_counter, extras=extras,
        map_update=state.map_update, submap_cache=state.submap_cache,
        cache_stale=state.cache_stale)
    res = process_keypoints(kps, ri, state.maps, state.prev_keypoints, inp, cfg, map_cfgs,
                            first_frame, sync_free=True, mesh=mesh, shard_maps=shard_maps)

    res_m = voxel_map.effective_resolution(map_cfgs[int(cfg.used_types[0])])
    shift = torch.cat([res.roll_offset.to(torch.float32) * res_m,
                       torch.zeros(3, dtype=torch.float32, device=dev)])
    origin_vox = state.origin_vox + res.roll_offset
    new_state = StreamState(
        maps=res.maps,
        prev_keypoints=res.keypoints,
        pose=res.pose - shift,
        prev_pose=state.pose - shift,
        t_cur=stamp.to(torch.float32),
        t_prev=state.t_cur,
        kf_pose=torch.where(res.is_keyframe, res.pose, state.kf_pose) - shift,
        kf_counter=state.kf_counter + res.is_keyframe.to(torch.int32),
        origin_vox=origin_vox,
        n_frames=state.n_frames + 1,
        map_update=state.map_update,
        submap_cache=res.submap_cache,
        cache_stale=res.cache_stale)
    packed = torch.cat([res.packed, origin_vox.to(torch.float32)])
    kps_flat = tuple(flatten_keypoints(kp) for kp in res.keypoints)
    return new_state, packed, kps_flat


def window_frame(ri_stack, w: int):
    """Sweep `w` of a window-stacked wire (views, no copy)."""
    if isinstance(ri_stack, FlatRangeImage):
        return FlatRangeImage(*(getattr(ri_stack, f)[w] for f in FlatRangeImage.FIELDS),
                              ri_stack.shape)
    return type(ri_stack)(*(a[w] for a in ri_stack))


def process_stream_window(ri_stack, state: StreamState, stamps, az_res,
                          cfg: SlamConfig, map_cfgs: tuple, mesh=None, shard_maps: bool = False,
                          shard_extraction: bool = False):
    """W chained streaming steps over a leading-axis-W stack of sweeps
    (`frame.stack_range_images`), the exact per-frame step each time — the
    JAX package's `lax.scan` as a loop. Returns (state', packed (W, PACKED_LEN + 3),
    kps_flat — per type (W, 7K+1))."""
    packed, kps_flat = [], []
    for w in range(stamps.shape[0]):
        state, p, k = process_frame_stream(window_frame(ri_stack, w), state, stamps[w],
                                           az_res, cfg, map_cfgs, False, mesh=mesh,
                                           shard_maps=shard_maps,
                                           shard_extraction=shard_extraction)
        packed.append(p)
        kps_flat.append(k)
    return state, torch.stack(packed), tuple(torch.stack(k) for k in zip(*kps_flat))


def init_stream_state(cfg: SlamConfig, map_cfgs, device, mesh=None,
                      shard_maps: bool = False) -> StreamState:
    """A fresh segment's state: empty maps (this rank's slabs with
    `shard_maps`), zero poses, stale submaps (none on a mesh)."""
    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    n = mesh.size if shard_maps else 1
    return StreamState(
        maps=tuple(sharded_map.empty_slab(map_cfgs[i], n, device)
                   if cfg.use_keypoints(Keypoint(i)) else None for i in range(3)),
        prev_keypoints=tuple(Keypoints.empty(cfg.extractor.kp_capacity(i), device)
                             for i in range(3)),
        pose=z(6), prev_pose=z(6), t_cur=z(()), t_prev=z(()), kf_pose=z(6),
        kf_counter=z((), torch.int32), origin_vox=z(3, torch.int32),
        n_frames=z((), torch.int32),
        map_update=torch.full((), cfg.mapping_mode != 0, dtype=torch.bool, device=device),
        submap_cache=init_submap_cache(cfg, map_cfgs, device, sharded=mesh is not None),
        cache_stale=torch.ones((), dtype=torch.bool, device=device))


def seed_stream_state(maps: tuple, pose, prev_pose, t_cur, t_prev, kf_pose,
                      kf_counter, origin_vox, n_frames, map_update,
                      cfg: SlamConfig, map_cfgs: tuple, device, mesh=None,
                      shard_maps: bool = False) -> StreamState:
    """A segment's state from host state (numpy poses, Python scalars); the
    maps are copied, so the host's map tensors stay its own."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)
    f32 = torch.float32
    st = init_stream_state(cfg, map_cfgs, device, mesh, shard_maps)
    return st._replace(
        maps=tuple(None if m is None else voxel_map.VoxelMap(*(a.clone() for a in m))
                   for m in maps),
        pose=t(pose, f32), prev_pose=t(prev_pose, f32), t_cur=t(t_cur, f32),
        t_prev=t(t_prev, f32), kf_pose=t(kf_pose, f32),
        kf_counter=t(kf_counter, torch.int32), origin_vox=t(origin_vox, torch.int32),
        n_frames=t(n_frames, torch.int32), map_update=t(map_update, torch.bool))
