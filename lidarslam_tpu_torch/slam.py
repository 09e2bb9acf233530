"""SLAM orchestrator, synchronous subset (PyTorch port of
`lidarslam_tpu/slam.py`).

`Slam.add_frame` runs one sweep through `ops/pipeline.process_frame` on the
Slam's device and keeps the float64 pose bookkeeping, the trajectory log and
the rolling-map origin on the host, as the JAX package does.

Coordinate frames:
- BASE: sensor platform frame of the current sweep (keypoints live here).
- WORLD: global frame (float64 host poses).
- MAP: WORLD translated by `-map_origin`; all device map/ICP tensors are
  MAP-frame float32. The origin is shared by all keypoint maps and advances
  by whole rolling-grid voxels.

Streaming (`add_frame_async`/`flush`), multi-LiDAR, pose-graph optimization,
checkpoints and the debug surface are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from lidarslam_tpu_torch.config import (KEYPOINT_NAMES, EgoMotionMode, Keypoint,
                                       MappingMode, SlamConfig)
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.ops import pipeline, voxel_map
from lidarslam_tpu_torch.ops.frame import (build_range_image, ensure_range_image,
                                           estimate_azimuthal_resolution)


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
    """The public SLAM engine API, synchronous per-sweep subset.

    `device` has no default: "cuda" runs the k-NN kernel, "cpu" the plain
    PyTorch versions."""

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
        self.total_matched_keypoints = 0
        self.map_overflow = np.zeros(3, np.int64)
        self.latency = 0.0
        self.mapping_mode = cfg.mapping_mode
        self.azimuthal_resolution = cfg.extractor.azimuthal_resolution
        self.last_stamp = None
        self.last_seq = None
        self.failure = False
        self._device_keypoints = None   # previous sweep's Keypoints (device)
        self._maps_populated = False    # host-side: any map has points
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

    def add_frame(self, frame: dict) -> dict:
        """Process one sweep (Slam::AddFrames single-LiDAR path).

        `frame` is a dict with arrays xyz (n,3), intensity, laser_id, time
        and scalar `stamp` [s] (+ optional `seq`). Returns a summary dict."""
        t0 = _time.perf_counter()
        skip = self._check_frame(frame)
        if skip:
            return skip
        stamp = float(frame["stamp"])
        ri = self._build_ri(frame)
        if self.azimuthal_resolution <= 1e-6 or self.azimuthal_resolution > np.pi / 4:
            self.azimuthal_resolution = float(
                estimate_azimuthal_resolution(ensure_range_image(ri)))

        inp = self._make_inputs(stamp)
        first = not self._maps_populated
        maps_in = tuple(self.maps.get(Keypoint(i)) for i in range(3))
        res = pipeline.process_frame(ri, maps_in, inp, self.cfg, self._map_cfgs_tuple,
                                     first)
        out = self._apply_result(res, stamp, t0)
        self.last_stamp = frame["stamp"]
        return out

    def _build_ri(self, frame):
        cfg = self.cfg
        return build_range_image(frame["xyz"], frame["intensity"], frame["laser_id"],
                                 frame["time"], cfg.extractor.n_rings,
                                 cfg.extractor.max_ring_points,
                                 packed=cfg.compress_upload, device=self.device)

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
        return pipeline.FrameInputs(
            trel_prior=self._pose_tensor(trel_prior),
            prev_pose=self._pose_tensor(prev_rel),
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
        if cfg.verbosity >= 1:
            for t in cfg.used_types:
                cap = cfg.extractor.kp_capacity(t)
                if int(u["kp_counts"][int(t)]) >= cap:
                    self._log(f"{t.name} keypoints hit capacity {cap}; raise the "
                              "extractor keypoint budget for this sensor")
        self.failure = u["failed"]
        self.total_matched_keypoints = u["total"]
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

        self._log_state(stamp)
        self.n_frames += 1
        self.latency = _time.perf_counter() - t0
        return {
            "pose": self.Tworld.copy(),
            "covariance": self.covariance.copy(),
            "n_matches": int(self.total_matched_keypoints),
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
