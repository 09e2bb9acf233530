"""SLAM orchestrator (PyTorch port of `lidarslam_tpu/slam.py`, single-LiDAR
subset).

`Slam.add_frame` runs one sweep through `ops/pipeline.process_frame` on the
Slam's device and keeps the float64 pose bookkeeping, the trajectory log and
the rolling-map origin on the host, as the JAX package does.

Streaming (`add_frame_async` + `flush`) chains the device `StreamState` from
sweep to sweep with no host sync until `flush`, with the JAX package's
segment rules: a segment's first sweep and a partial window at `flush` run
per sweep, full windows of `cfg.stream_window` sweeps as one upload, a
flush ends the segment and the next one is seeded from the host's float64
state. On CUDA every steady-state sweep is a replay of one captured CUDA
graph (`ops/stream_graph.py`); on the CPU the same step runs eagerly.

Coordinate frames:
- BASE: sensor platform frame of the current sweep (keypoints live here).
- WORLD: global frame (float64 host poses).
- MAP: WORLD translated by `-map_origin`; all device map/ICP tensors are
  MAP-frame float32. The origin is shared by all keypoint maps and advances
  by whole rolling-grid voxels.

The confidence surface (LCP overlap from the device, motion-limit checks
on the host's float64 log) fills `overlap` and `comply_motion_limits` in
every summary dict, on both paths.

Multi-LiDAR (and its streaming step), pose-graph optimization, keypoint
logs, sensor constraints, checkpoints and the debug surface are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from lidarslam_tpu_torch import confidence
from lidarslam_tpu_torch.config import (KEYPOINT_NAMES, EgoMotionMode, Keypoint,
                                       MappingMode, SlamConfig)
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops import pipeline, stream_graph, voxel_map
from lidarslam_tpu_torch.ops.frame import (Keypoints, KeypointsView, build_range_image,
                                           ensure_range_image,
                                           estimate_azimuthal_resolution,
                                           flatten_packed, stack_range_images,
                                           to_device_range_image)


def _shared_resolution(cfg: SlamConfig) -> float:
    """Rolling-window resolution: the largest value <= every map's snapped
    voxel resolution that is an integer multiple of every used leaf size."""
    leafs_mm = [round(cfg.map_config(k).leaf_size * 1000) for k in cfg.used_types]
    lcm = leafs_mm[0]
    for v in leafs_mm[1:]:
        lcm = lcm * v // math.gcd(lcm, v)
    min_res = min(voxel_map.effective_resolution(cfg.map_config(k)) for k in cfg.used_types)
    quanta = int(min_res * 1000 // lcm)
    if quanta < 1:
        raise ValueError("voxel_resolution smaller than the leaf-size common multiple")
    return quanta * lcm / 1000.0


class Slam:
    """The public SLAM engine API, single-LiDAR subset: `add_frame` per
    sweep, or `add_frame_async` + `flush` streaming.

    `device` has no default: "cuda" runs the k-NN kernel (and replays the
    streaming step as a CUDA graph), "cpu" the plain PyTorch versions."""

    def __init__(self, config: Optional[SlamConfig] = None, *, device):
        self.cfg = config or SlamConfig()
        if self.cfg.two_d_mode and not self.cfg.solver.two_d_mode:
            self.cfg = dataclasses.replace(
                self.cfg, solver=dataclasses.replace(self.cfg.solver, two_d_mode=True))
        cfg = self.cfg
        self.device = torch.device(device)
        if len(cfg.used_types) == 0:
            raise ValueError("at least one keypoint type must be enabled")
        pipeline.check_supported(cfg)
        if len({cfg.map_config(k).grid_size for k in cfg.used_types}) != 1:
            raise ValueError("all maps must share grid_size for the shared rolling window")

        # snap every map's voxel resolution to the shared rolling quantum
        shared_res = _shared_resolution(cfg)
        self._map_cfgs_tuple = tuple(
            dataclasses.replace(cfg.map_config(Keypoint(i)), voxel_resolution=shared_res)
            for i in range(3))
        self.map_cfgs = {k: self._map_cfgs_tuple[int(k)] for k in cfg.used_types}
        self._graph = None   # stream_graph.StreamGraph, built at first use on CUDA
        self.reset()

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def reset(self, reset_log: bool = True):
        """Reset SLAM state (Slam::Reset, Slam.cxx:164-210)."""
        cfg = self.cfg
        self.maps: Dict[Keypoint, voxel_map.VoxelMap] = {
            k: voxel_map.VoxelMap.empty(self.map_cfgs[k], self.device)
            for k in cfg.used_types}
        self.map_origin = np.zeros(3)
        self.Tworld = np.eye(4)
        self.PreviousTworld = np.eye(4)
        self.kf_last_pose = np.eye(4)
        self.kf_counter = 0
        self.covariance = np.zeros((6, 6))
        self.overlap = -1.0
        self.comply_motion_limits = True
        self.total_matched_keypoints = 0
        self.map_overflow = np.zeros(3, np.int64)
        self.latency = 0.0
        self.mapping_mode = cfg.mapping_mode
        self.azimuthal_resolution = cfg.extractor.azimuthal_resolution
        self.last_stamp = None
        self.last_seq = None
        self.failure = False
        self.current_keypoints = {}     # per type, KeypointsView after a flush
        self.current_warp = None        # the last add_frame's WarpParams
        self._device_keypoints = None   # previous sweep's Keypoints (device)
        self._maps_populated = False    # host-side: any map has points
        self._prefetched = None         # (stamp, wire) of add_frame's next_frame
        self._stream_state = None       # StreamState while a segment is open
        self._stream_pending = []       # enqueued results not yet flushed
        self._window_buf = []           # host sweeps of the filling window
        self._stream_enqueued = 0
        self.motion_checker = confidence.MotionLimitChecker(
            cfg.confidence.time_window_duration, cfg.confidence.velocity_limits,
            cfg.confidence.acceleration_limits)
        self._invalidate_submaps()
        if reset_log:
            self.n_frames = 0
            self.log_trajectory: List[dict] = []  # {time, pose (4,4), covariance}

    def _invalidate_submaps(self):
        """Mark the cached submap selections stale (reset, external map
        change)."""
        self._submap_cache = pipeline.init_submap_cache(self.cfg, self._map_cfgs_tuple,
                                                        self.device)
        self._cache_stale = True

    # ------------------------------------------------------------------
    # Main entry
    # ------------------------------------------------------------------

    def add_frame(self, frame: dict, next_frame: dict = None) -> dict:
        """Process one sweep (Slam::AddFrames single-LiDAR path).

        `frame` is a dict with arrays xyz (n,3), intensity, laser_id, time
        and scalar `stamp` [s] (+ optional `seq`). Pass the upcoming sweep as
        `next_frame` to build and upload its wire right after this sweep's
        step is issued. Returns a summary dict."""
        t0 = _time.perf_counter()
        skip = self._check_frame(frame)
        if skip:
            return skip
        stamp = float(frame["stamp"])
        pre, self._prefetched = self._prefetched, None
        if pre is not None and pre[0] == frame.get("stamp"):
            ri = pre[1]
        else:
            ri = self._build_ri(frame)
        if self.azimuthal_resolution <= 1e-6 or self.azimuthal_resolution > np.pi / 4:
            self.azimuthal_resolution = float(
                estimate_azimuthal_resolution(ensure_range_image(ri)))

        inp = self._make_inputs(stamp)
        first = not self._maps_populated
        maps_in = tuple(self.maps.get(Keypoint(i)) for i in range(3))
        prev_kp = self._device_keypoints if self._device_keypoints is not None \
            else tuple(Keypoints.empty(self.cfg.extractor.kp_capacity(i), self.device)
                       for i in range(3))
        res = pipeline.process_frame(ri, maps_in, prev_kp, inp, self.cfg,
                                     self._map_cfgs_tuple, first)
        if next_frame is not None and next_frame.get("xyz") is not None \
                and len(next_frame["xyz"]) > 0:
            self._prefetched = (next_frame["stamp"], self._build_ri(next_frame))
        out = self._apply_result(res, stamp, t0)
        self.last_stamp = frame["stamp"]
        return out

    def _build_ri(self, frame, device=None):
        """The sweep's wire on the Slam's device; `device=False`: the host
        PackedRangeImage of a window sweep."""
        cfg = self.cfg
        return build_range_image(frame["xyz"], frame["intensity"], frame["laser_id"],
                                 frame["time"], cfg.extractor.n_rings,
                                 cfg.extractor.max_ring_points,
                                 packed=cfg.compress_upload,
                                 device=self.device if device is None else device)

    # ------------------------------------------------------------------
    # Streaming (device-chained) mode: no host sync until flush
    # ------------------------------------------------------------------

    def add_frame_async(self, frame: dict) -> int:
        """Enqueue one sweep in streaming mode; returns its frame index (-1
        when skipped).

        The ego-motion prior, the keyframe gate and the rolling origin
        advance on the device, so nothing synchronizes with the host until
        `flush()`, which fills the logs and returns the results. Mixing with
        `add_frame` is allowed across a flush. Sweeps buffer on the host
        and every `cfg.stream_window` of them go up in one upload."""
        self._check_stream_supported()
        skip = self._check_frame(frame)
        if skip:
            return -1
        stamp = float(frame["stamp"])
        self._ensure_stream_state()
        first = not self._maps_populated and self._stream_enqueued == 0 \
            and self.n_frames == 0
        # until a valid azimuthal-resolution estimate exists (the first
        # sweep against preloaded maps) sweeps take the per-frame path,
        # which estimates it
        az_invalid = (self.azimuthal_resolution <= 1e-6
                      or self.azimuthal_resolution > np.pi / 4)
        # on CUDA every steady-state sweep replays the graph, so a window of
        # one is still a window
        if not first and not az_invalid and (self.cfg.stream_window > 1
                                              or self._graph is not None):
            self._window_buf.append((self._build_ri(frame, device=False), stamp))
            if len(self._window_buf) >= self.cfg.stream_window:
                self._dispatch_window()
        else:
            # any buffered partial window runs first, to keep frame order
            self._drain_window()
            ri = self._build_ri(frame)
            if az_invalid:
                self.azimuthal_resolution = float(
                    estimate_azimuthal_resolution(ensure_range_image(ri)))
            if self._graph is not None:
                self._graph.set_az(self.azimuthal_resolution)
                packed, kps_flat = self._graph.eager_step(ri, stamp, first)
            else:
                self._stream_state, packed, kps_flat = pipeline.process_frame_stream(
                    ri, self._stream_state, self._f32(stamp),
                    self._f32(self.azimuthal_resolution), self.cfg,
                    self._map_cfgs_tuple, first)
            self._stream_pending.append({"stamps": [stamp], "packed": packed,
                                         "kps_flat": kps_flat})
        self.last_stamp = frame["stamp"]
        idx = self._stream_enqueued
        self._stream_enqueued += 1
        return idx

    def _f32(self, x) -> torch.Tensor:
        return torch.full((), float(np.float32(x)), dtype=torch.float32,
                          device=self.device)

    def _check_stream_supported(self):
        """Raise where the config asks streaming for what is not ported."""
        cfg = self.cfg
        if cfg.wheel_odom_weight > 0 or cfg.imu_weight > 0:
            raise NotImplementedError("sensor constraints in the stream are not "
                                      "ported yet (ROADMAP.md, Queue 1)")
        if not cfg.compress_upload:
            raise NotImplementedError("streaming takes the quantized wire "
                                      "(compress_upload=True) only")

    def _dispatch_window(self):
        """Run the buffered sweeps (a full window, or a partial one at
        flush on CUDA) in order: on CUDA one upload of their flat-wire
        records and one graph replay each, on the CPU the eager window."""
        buf, self._window_buf = self._window_buf, []
        cfg = self.cfg
        stamps = [s for _, s in buf]
        if self._graph is not None:
            wire = self._graph.wire
            records = wire.pack([flatten_packed(r, wire.capacity) for r, _ in buf], stamps)
            packed, kps_flat = self._graph.run(records.to(self.device, non_blocking=True))
        else:
            ris = [r for r, _ in buf]
            if cfg.flat_wire:
                ris = [flatten_packed(r, cfg.wire_capacity) for r in ris]
            self._stream_state, packed, kps_flat = pipeline.process_stream_window(
                stack_range_images(ris, self.device), self._stream_state,
                torch.tensor(stamps, dtype=torch.float32, device=self.device),
                self._f32(self.azimuthal_resolution), cfg, self._map_cfgs_tuple)
        self._stream_pending.append({"stamps": stamps, "packed": packed,
                                     "kps_flat": kps_flat})

    def _drain_window(self):
        """Run a buffered partial window sweep by sweep (on CUDA: graph
        replays of one upload; on the CPU: the per-frame step on each
        sweep's dense planes, as the JAX package does)."""
        if not self._window_buf:
            return
        if self._graph is not None:
            self._dispatch_window()
            return
        buf, self._window_buf = self._window_buf, []
        for ri_host, stamp in buf:
            self._stream_state, packed, kps_flat = pipeline.process_frame_stream(
                to_device_range_image(ri_host, self.device), self._stream_state,
                self._f32(stamp), self._f32(self.azimuthal_resolution), self.cfg,
                self._map_cfgs_tuple, False)
            self._stream_pending.append({"stamps": [stamp], "packed": packed,
                                         "kps_flat": kps_flat})

    def _ensure_stream_state(self):
        """Open a segment: the device stream state, seeded from the host
        state when there is one (previous segment, add_frame, loaded
        state), fresh otherwise."""
        if self._stream_state is not None:
            return
        cfg = self.cfg
        self._stream_pending = []
        self._window_buf = []
        self._stream_enqueued = 0
        if self._maps_populated or self.n_frames > 0:
            res_m = voxel_map.effective_resolution(
                self._map_cfgs_tuple[int(cfg.used_types[0])])
            rel, prev_rel, kf_rel = (H.copy() for H in
                                     (self.Tworld, self.PreviousTworld, self.kf_last_pose))
            for H in (rel, prev_rel, kf_rel):
                H[:3, 3] -= self.map_origin
            t_cur = self.log_trajectory[-1]["time"] if self.log_trajectory else 0.0
            t_prev = self.log_trajectory[-2]["time"] if len(self.log_trajectory) > 1 \
                else t_cur
            state = pipeline.seed_stream_state(
                tuple(self.maps.get(Keypoint(i)) for i in range(3)),
                se3.hmat_to_pose(rel).astype(np.float32),
                se3.hmat_to_pose(prev_rel).astype(np.float32),
                np.float32(t_cur), np.float32(t_prev),
                se3.hmat_to_pose(kf_rel).astype(np.float32), self.kf_counter,
                np.round(self.map_origin / res_m).astype(np.int32),
                max(self.n_frames, 1), self.mapping_mode != MappingMode.NONE,
                cfg, self._map_cfgs_tuple, self.device)
        else:
            state = pipeline.init_stream_state(cfg, self._map_cfgs_tuple, self.device)
            state = state._replace(map_update=torch.full(
                (), self.mapping_mode != MappingMode.NONE, dtype=torch.bool,
                device=self.device))
        if self.device.type == "cuda":
            if self._graph is None:
                ecfg = cfg.extractor
                cap = (cfg.wire_capacity if cfg.flat_wire else 0) \
                    or ecfg.n_rings * ecfg.max_ring_points
                self._graph = stream_graph.StreamGraph(
                    cfg, self._map_cfgs_tuple, self.device,
                    stream_graph.WireRecord(ecfg.n_rings, ecfg.max_ring_points, cap))
            self._graph.seed(state, self.azimuthal_resolution)
            state = self._graph.state
        self._stream_state = state

    def flush(self) -> list:
        """Bring the streamed results to the host (one transfer) and into
        the logs; returns the per-frame summary dicts of the flushed frames.
        Ends the segment."""
        self._drain_window()
        if not self._stream_pending:
            return []
        cfg = self.cfg
        n_packed = pipeline.PACKED_LEN + 3
        res_m = voxel_map.effective_resolution(self._map_cfgs_tuple[int(cfg.used_types[0])])
        rows = torch.cat([e["packed"].reshape(-1, n_packed)
                          for e in self._stream_pending]).cpu().numpy()
        # the segment's maps and last keypoints, copied out of the state (on
        # CUDA the graph's buffers, which the next segment overwrites)
        self.maps = {k: stream_graph.clone_tree(self._stream_state.maps[int(k)])
                     for k in cfg.used_types}
        self._device_keypoints = stream_graph.clone_tree(self._stream_state.prev_keypoints)
        outs = []
        r = 0
        for entry in self._stream_pending:
            windowed = entry["packed"].dim() == 2
            for w, stamp in enumerate(entry["stamps"]):
                packed = rows[r]
                r += 1
                u = pipeline.unpack_scalars(packed[:pipeline.PACKED_LEN])
                origin_after_vox = packed[pipeline.PACKED_LEN:n_packed].astype(np.int64)
                origin_before = (origin_after_vox - u["roll_offset"]).astype(np.float64) * res_m
                Tnew = se3.pose_to_hmat(u["pose"])
                Tnew[:3, 3] += origin_before
                self.PreviousTworld = self.Tworld.copy()
                self.Tworld = Tnew
                self.covariance = u["cov"]
                self.failure = u["failed"]
                self.total_matched_keypoints = u["total"]
                self.overlap = u["overlap"]
                if u["is_kf"]:
                    self.kf_counter += 1
                    self.kf_last_pose = self.Tworld.copy()
                    self._maps_populated = True
                self.map_origin = origin_after_vox.astype(np.float64) * res_m
                self._update_map_overflow(u["map_overflow"])
                # lazy views over the per-frame log buffers: nothing moves to
                # the host unless a consumer reads them
                self.current_keypoints = {
                    Keypoint(i): KeypointsView(entry["kps_flat"][i],
                                               row=w if windowed else None)
                    for i in range(3)}
                self._check_motion_limits(stamp)
                self._log_state(stamp)
                self.n_frames += 1
                outs.append({"pose": self.Tworld.copy(),
                             "covariance": self.covariance.copy(),
                             "n_matches": int(u["total"]), "overlap": u["overlap"],
                             "failure": u["failed"], "kp_counts": u["kp_counts"],
                             "comply_motion_limits": self.comply_motion_limits})
        self._stream_pending = []
        # the host is the source of truth again; the next segment re-seeds
        self._stream_state = None
        self._invalidate_submaps()
        return outs

    def _check_frame(self, frame):
        if frame["xyz"] is None or len(frame["xyz"]) == 0:
            return {"skipped": "empty"}
        if self.last_stamp is not None and frame["stamp"] == self.last_stamp:
            return {"skipped": "duplicate stamp"}
        if self.last_seq is not None and "seq" in frame:
            dropped = frame["seq"] - self.last_seq - 1
            if dropped > 0:
                self._log(f"{dropped} frame(s) dropped")
        self.last_seq = frame.get("seq")
        return None

    def _pose_tensor(self, H):
        return torch.tensor(se3.hmat_to_pose(H), dtype=torch.float32, device=self.device)

    def _make_inputs(self, stamp) -> pipeline.FrameInputs:
        cfg = self.cfg
        # ego-motion extrapolation (host, Slam.cxx:813-836)
        trel_prior = np.eye(4)
        if len(self.log_trajectory) >= 2 and cfg.ego_motion_mode in (
                EgoMotionMode.MOTION_EXTRAPOLATION,
                EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION):
            t1 = self.log_trajectory[-1]["time"]
            tp0 = self.log_trajectory[-2]["time"]
            if abs((stamp - t1) / max(t1 - tp0, 1e-12)) > cfg.max_extrapolation_ratio:
                self._log("extrapolation time too far; skipping prediction")
            else:
                nxt = se3.interpolate_hmat(self.PreviousTworld, self.Tworld, stamp, tp0, t1)
                trel_prior = se3.hmat_inverse(self.Tworld) @ nxt

        prev_rel = self.Tworld.copy()
        prev_rel[:3, 3] -= self.map_origin
        kf_rel = self.kf_last_pose.copy()
        kf_rel[:3, 3] -= self.map_origin
        t_prev = self.log_trajectory[-1]["time"] if self.log_trajectory else stamp
        return pipeline.FrameInputs(
            trel_prior=self._pose_tensor(trel_prior),
            prev_pose=self._pose_tensor(prev_rel),
            t_prev=t_prev,
            stamp=stamp,
            az_resolution=float(np.float32(self.azimuthal_resolution)),
            kf_last_pose=self._pose_tensor(kf_rel),
            kf_counter=int(self.kf_counter),
            map_update=self.mapping_mode != MappingMode.NONE,
            submap_cache=self._submap_cache,
            cache_stale=self._cache_stale)

    def _apply_result(self, res: pipeline.FrameResult, stamp, t0) -> dict:
        """Float64 bookkeeping from the frame's packed scalars."""
        cfg = self.cfg
        u = pipeline.unpack_scalars(res.packed)
        self.maps = {k: res.maps[int(k)] for k in cfg.used_types}
        self._submap_cache = res.submap_cache
        self._cache_stale = res.cache_stale
        self._device_keypoints = res.keypoints
        self.current_warp = res.warp
        if cfg.verbosity >= 1:
            for t in cfg.used_types:
                cap = cfg.extractor.kp_capacity(t)
                if int(u["kp_counts"][int(t)]) >= cap:
                    self._log(f"{t.name} keypoints hit capacity {cap}; raise the "
                              "extractor keypoint budget for this sensor")
        self.failure = u["failed"]
        self.total_matched_keypoints = u["total"]
        self.overlap = u["overlap"]
        self._update_map_overflow(u["map_overflow"])
        if self.failure:
            self._log("not enough keypoints matched; localization skipped")

        self.PreviousTworld = self.Tworld.copy()
        Tnew = se3.pose_to_hmat(u["pose"])
        Tnew[:3, 3] += self.map_origin
        self.Tworld = Tnew
        self.covariance = u["cov"]
        if u["is_kf"]:
            self.kf_counter += 1
            self.kf_last_pose = self.Tworld.copy()
            self._maps_populated = True
        shift = np.asarray(u["roll_offset"], np.float64) * voxel_map.effective_resolution(
            self._map_cfgs_tuple[int(cfg.used_types[0])])
        self.map_origin = self.map_origin + shift

        self._check_motion_limits(stamp)
        self._log_state(stamp)
        self.n_frames += 1
        self.latency = _time.perf_counter() - t0
        return {
            "pose": self.Tworld.copy(),
            "covariance": self.covariance.copy(),
            "n_matches": int(self.total_matched_keypoints),
            "overlap": self.overlap,
            "comply_motion_limits": self.comply_motion_limits,
            "failure": self.failure,
            "kp_counts": u["kp_counts"],
            "duration": self.latency,
        }

    def _update_map_overflow(self, overflow):
        """Track map leaves dropped at capacity and warn when it grows."""
        overflow = np.asarray(overflow, np.int64)
        if self.cfg.verbosity >= 1 and (overflow > self.map_overflow).any():
            for k in self.cfg.used_types:
                d = int(overflow[int(k)] - self.map_overflow[int(k)])
                if d > 0:
                    self._log(f"{KEYPOINT_NAMES[k]} map dropped {d} leaves at "
                              f"capacity {self.map_cfgs[k].capacity}; raise "
                              "map capacity for this environment")
        self.map_overflow = overflow

    def _check_motion_limits(self, stamp):
        """Motion-limit confidence of the new pose against the log before it
        is appended (Slam.cxx:1391-1484), when a time window is set."""
        if self.cfg.confidence.time_window_duration > 0:
            status = self.motion_checker.check(
                [(e["time"], e["pose"]) for e in self.log_trajectory], self.Tworld, stamp)
            self.comply_motion_limits = status.comply

    def _log_state(self, stamp):
        """Trajectory/covariance logging with timeout pruning
        (Slam::LogCurrentFrameState, Slam.cxx:1225-1264)."""
        cfg = self.cfg
        self.log_trajectory.append({"time": stamp, "pose": self.Tworld.copy(),
                                    "covariance": self.covariance.copy()})
        if cfg.logging_timeout == 0:
            while len(self.log_trajectory) > 2:
                self.log_trajectory.pop(0)
        elif cfg.logging_timeout > 0:
            while (len(self.log_trajectory) > 2
                   and stamp - self.log_trajectory[0]["time"] > cfg.logging_timeout):
                self.log_trajectory.pop(0)

    # ------------------------------------------------------------------
    # Results API
    # ------------------------------------------------------------------

    def get_world_transform(self) -> np.ndarray:
        return self.Tworld.copy()

    def get_trajectory(self):
        return [(e["time"], e["pose"].copy()) for e in self.log_trajectory]

    def get_covariance(self) -> np.ndarray:
        return self.covariance.copy()

    def get_map_points(self, k: Keypoint, clean: bool = False):
        """World-frame map points (RollingGrid::Get)."""
        xyz, inten, t, fixed = voxel_map.gather_valid_points(self.maps[k], clean,
                                                            self.map_cfgs[k])
        return xyz + self.map_origin.astype(np.float32), inten, t, fixed

    def load_numpy_state(self, state: dict):
        """Continue from another engine's state (see state.py)."""
        from lidarslam_tpu_torch import state as state_mod

        state_mod.load_numpy_state(self, state)

    def _log(self, msg):
        if self.cfg.verbosity > 0:
            print(f"[lidarslam_tpu_torch] {msg}")
