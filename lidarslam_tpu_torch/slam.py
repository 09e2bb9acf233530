"""SLAM orchestrator (PyTorch port of `lidarslam_tpu/slam.py`).

`Slam.add_frame` runs one sweep through `ops/pipeline.process_frame` on the
Slam's device and keeps the float64 pose bookkeeping, the trajectory and
keypoint logs and the rolling-map origin on the host, as the JAX package
does. On one CUDA device (no mesh) every sweep after the first replays
the step's sync-free form as a captured CUDA graph
(`stream_graph.FrameGraph`, after its eager warm-up steps): the host's
inputs go up in one pinned record, and the host reads the packed scalars
back once. The maps, the previous keypoints and the submap cache then
live in the graph's buffers; whatever replaced them since the last replay
(a reset, a stream segment's flush, a map load, the PGO, a checkpoint) is
copied in before the next one.

`Slam.add_frames` takes one acquisition of a multi-LiDAR rig: each
device's sweep is extracted with its own `ExtractorConfig`, moved into BASE
by its calibration offset (`set_base_to_lidar_offset`), time-rebased to the
first frame's stamp, and the merged keypoints go through
`pipeline.process_keypoints`.

Streaming (`add_frame_async` / `add_frames_async` + `flush`) chains the
device `StreamState` from sweep to sweep with no host sync until `flush`,
with the JAX package's segment rules: a segment's first sweep and a partial
window at `flush` run per sweep, full windows of `cfg.stream_window` sweeps
as one upload, a flush ends the segment and the next one is seeded from the
host's float64 state. A full window is stacked, uploaded and stepped on the
calling thread (the JAX package uses a worker thread; ROADMAP Queue 3,
D5). On CUDA every steady-state sweep is a replay
of a captured CUDA graph (`ops/stream_graph.py`): one for the sweeps (the
flat wire, or the float planes with `compress_upload=False`) and one for a
rig's merged keypoints, which share the segment's state; a rig's
per-device extraction is a graph per device, on both paths. On the CPU the
same steps run eagerly.

Coordinate frames:
- BASE: sensor platform frame of the current sweep (keypoints live here).
- WORLD: global frame (float64 host poses).
- MAP: WORLD translated by `-map_origin`; all device map/ICP tensors are
  MAP-frame float32. The origin is shared by all keypoint maps and advances
  by whole rolling-grid voxels.

The confidence surface (LCP overlap from the device, motion-limit checks
on the host's float64 log) fills `overlap` and `comply_motion_limits` in
every summary dict, on both paths; a rig's acquisition has no range image
and so no overlap (-1), as in the JAX package.

Wheel odometry and IMU gravity (`sensors/constraints.py`) are measured on
the host and enter the localization solve as residual blocks, on both
paths. In the CPU stream a sweep that carries them runs alone, as in the
JAX package; on CUDA it stays in its window, since the graph replays each
sweep's input record on its own and the blocks ride in that record.

The back end and the state surface: `run_pose_graph_optimization`
optimizes the logged trajectory against GPS priors (`backend/posegraph.py`
on the host, or `backend/posegraph_device.py` in float64 on the Slam's
device) and rebuilds the maps on the device from the keypoint log;
`save_checkpoint` / `load_checkpoint` carry the whole state in the JAX
package's `.npz` keys, so either package loads the other's (the port's
file also holds the previous sweep's keypoints, which JAX ignores;
ROADMAP Queue 3, D7);
`save_maps_to_pcd` / `load_maps_from_pcd` write and read the maps;
`execute_command` takes the reference's runtime commands; `subscribe`
registers per-frame output callbacks (`outputs.FrameOutput`). After any of
these replaces the maps, the next stream segment is seeded from them: on
CUDA the state is copied into the captured graph's buffers.

Several devices: `Slam(cfg, mesh=mesh)` with a `parallel.sharded.Mesh`
(one process per rank, `parallel/launch.py` or `torchrun`). Every rank
builds the same Slam and feeds it the same sweeps; the step matches each
rank's 1/n of the keypoints and sums the normal equations over the ranks,
so every rank holds the same poses, logs and (replicated) maps.
`shard_extraction` splits extraction over rings; `shard_maps` keeps in
`self.maps` this rank's slab of each map (`parallel/sharded_map.py`). Every
path runs on a mesh: `add_frame(s)`, `add_frame(s)_async` + `flush`
and the PGO, whose segment-Schur solve shards over the ranks. On an NCCL
mesh the stream replays the same CUDA graphs as on one card, each holding
the rank's SPMD step with its collectives; a gloo mesh streams eagerly,
since gloo stages every collective through host memory (ROADMAP Queue 3,
D10). Under `shard_maps` the methods that read the maps gather the slabs,
so every rank must call them (collectives), and those that write files
write them on rank 0 only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from lidarslam_tpu_torch import confidence
from lidarslam_tpu_torch.config import (KEYPOINT_NAMES, EgoMotionMode, Keypoint,
                                       MappingMode, SlamConfig)
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.io import storage
from lidarslam_tpu_torch.ops import extractor, pipeline, stream_graph, undistortion, voxel_map
from lidarslam_tpu_torch.ops.frame import (Keypoints, KeypointsView, PackedRangeImage,
                                           RangeImage, build_range_image, ensure_range_image,
                                           estimate_azimuthal_resolution,
                                           flatten_packed, merge_keypoints,
                                           stack_range_images, to_device_range_image,
                                           transform_keypoints)
from lidarslam_tpu_torch.parallel import sharded, sharded_map
from lidarslam_tpu_torch.sensors.constraints import (ImuManager, WheelOdometryManager,
                                                     on_device)
from lidarslam_tpu_torch.utils import timer
from lidarslam_tpu_torch.utils.timer import span


def _root_span(name: str):
    """Run the method in the span `name`: the root of one public call of
    the per-sweep path, with the timers on at verbosity >= 3
    (`utils/timer.py`)."""
    def wrap(method):
        @functools.wraps(method)
        def call(self, *args, **kw):
            timer.enable(self.cfg.verbosity >= 3)
            with span(name):
                return method(self, *args, **kw)
        return call
    return wrap


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


def _valid_az(az: float) -> bool:
    return 1e-6 < az <= np.pi / 4


class Slam:
    """The public SLAM engine API: `add_frame` per sweep or `add_frames` per
    multi-LiDAR acquisition, or `add_frame_async` / `add_frames_async` +
    `flush` streaming.

    `device` "cuda" (the default) runs the k-NN kernel and replays the
    streaming step as a CUDA graph; it raises where no CUDA device exists.
    "cpu" runs the plain PyTorch versions. With a `mesh` (see the module
    docstring) the Slam runs on the mesh's device; `shard_maps` and
    `shard_extraction` need one."""

    def __init__(self, config: Optional[SlamConfig] = None, *, device=None, mesh=None,
                 shard_maps: bool = False, shard_extraction: bool = False):
        self.cfg = config or SlamConfig()
        if (shard_maps or shard_extraction) and mesh is None:
            raise ValueError("shard_maps/shard_extraction require a mesh")
        self.mesh = mesh
        self.shard_maps = bool(shard_maps)
        self.shard_extraction = bool(shard_extraction)
        if mesh is not None and device is not None:
            want = torch.device(device)
            if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        if self.cfg.two_d_mode and not self.cfg.solver.two_d_mode:
            self.cfg = dataclasses.replace(
                self.cfg, solver=dataclasses.replace(self.cfg.solver, two_d_mode=True))
        cfg = self.cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Slam runs on a CUDA device unless asked for another "
                               "(device='cpu'), and torch finds none")
        if len(cfg.used_types) == 0:
            raise ValueError("at least one keypoint type must be enabled")
        if len({cfg.map_config(k).grid_size for k in cfg.used_types}) != 1:
            raise ValueError("all maps must share grid_size for the shared rolling window")

        # snap every map's voxel resolution to the shared rolling quantum
        shared_res = _shared_resolution(cfg)
        self._map_cfgs_tuple = tuple(
            dataclasses.replace(cfg.map_config(Keypoint(i)), voxel_resolution=shared_res)
            for i in range(3))
        self.map_cfgs = {k: self._map_cfgs_tuple[int(k)] for k in cfg.used_types}
        if mesh is not None:
            self._check_mesh(mesh)
        self._graph = None       # stream_graph.StreamGraph of the sweeps (CUDA)
        self._rig_graph = None   # ... of a rig's merged keypoints, sharing its state
        self._extract_graphs = {}   # device_id -> stream_graph.ExtractGraph (CUDA)
        self._frame_graph = None  # stream_graph.FrameGraph of add_frame's step (CUDA)
        self.live_replays = 0     # add_frame sweeps stepped by a replay of it
        self._profiler = None    # (torch.profiler.profile, log_dir) while profiling
        # per-LiDAR-device calibration: BASE <- LIDAR (Slam.h:502-505)
        self.base_to_lidar_offsets: Dict[int, np.ndarray] = {}
        # live output subscribers (outputs.py); wiring, not SLAM state, so
        # they survive reset(), as do the last localization's debug arrays
        self._subscribers: list = []
        self._last_statuses = self._last_weights = None
        self.reset()

    def _check_mesh(self, mesh):
        """The JAX package's divisibility errors for a mesh of `mesh.size`."""
        cfg, n = self.cfg, mesh.size
        for t in cfg.used_types:
            if cfg.extractor.kp_capacity(t) % n:
                raise ValueError(f"{t.name} keypoint capacity ({cfg.extractor.kp_capacity(t)}) "
                                 f"must be divisible by the mesh size ({n})")
        if self.shard_maps:
            for k in cfg.used_types:
                if self.map_cfgs[k].capacity % n:
                    raise ValueError(f"map capacity ({self.map_cfgs[k].capacity}) must be "
                                     f"divisible by the mesh size ({n})")
        if self.shard_extraction and cfg.extractor.n_rings % n:
            raise ValueError(f"extractor.n_rings ({cfg.extractor.n_rings}) must be divisible "
                             f"by the mesh size ({n}) with shard_extraction")

    def _step(self, name: str, extraction: bool = True):
        """The step `name` of `ops/pipeline`, or on a mesh its SPMD entry
        point `parallel.sharded.<name>_spmd` with this Slam's mesh and
        sharding modes bound."""
        if self.mesh is None:
            return getattr(pipeline, name)
        kw = {"mesh": self.mesh, "shard_maps": self.shard_maps}
        if extraction:
            kw["shard_extraction"] = self.shard_extraction
        return functools.partial(getattr(sharded, f"{name}_spmd"), **kw)

    def subscribe(self, callback):
        """Register a per-frame output callback (LidarSlamNode::PublishOutput
        / vtkSlam output-port role): called with an `outputs.FrameOutput`
        after every processed (sync) or flushed (streaming) frame. Array
        ports are lazy: a pose-only consumer adds no device traffic.
        Returns an unsubscribe function."""
        self._subscribers.append(callback)

        def unsubscribe():
            if callback in self._subscribers:
                self._subscribers.remove(callback)
        return unsubscribe

    def _emit_output(self, stamp, summary, is_keyframe, views):
        if not self._subscribers:
            return
        from lidarslam_tpu_torch.outputs import FrameOutput

        out = FrameOutput(self, stamp, self.n_frames - 1, summary, is_keyframe, views)
        for cb in list(self._subscribers):
            cb(out)

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def reset(self, reset_log: bool = True):
        """Reset SLAM state (Slam::Reset, Slam.cxx:164-210)."""
        cfg = self.cfg
        n = self.mesh.size if self.shard_maps else 1
        self.maps: Dict[Keypoint, voxel_map.VoxelMap] = {
            k: sharded_map.empty_slab(self.map_cfgs[k], n, self.device)
            for k in cfg.used_types}
        self.map_origin = np.zeros(3)
        self.Tworld = np.eye(4)
        self.PreviousTworld = np.eye(4)
        self.Trelative = np.eye(4)
        # the last sweep's ego-motion registration (xyzrpy, float64): the
        # prior the last add_frame gave the step, the estimate it returned
        # (the prior where the stage did not run or failed), and its device
        # counts of open rounds and live LM trips
        self.ego_prior = np.zeros(6)
        self.ego_motion = np.zeros(6)
        self.ego_rounds = 0
        self.ego_lm_steps = 0
        self.kf_last_pose = np.eye(4)
        self.kf_counter = 0
        self.covariance = np.zeros((6, 6))
        self.overlap = -1.0
        self.comply_motion_limits = True
        self.total_matched_keypoints = 0
        self.match_counts = np.zeros(3, np.int64)
        self.map_overflow = np.zeros(3, np.int64)
        self.latency = 0.0
        self.mapping_mode = cfg.mapping_mode
        self.azimuthal_resolution = cfg.extractor.azimuthal_resolution
        self._az_by_device: Dict[int, float] = {}
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
        self.wheel_odom = WheelOdometryManager(cfg.wheel_odom_weight, cfg.wheel_odom_relative,
                                               cfg.sensor_time_offset)
        self.imu = ImuManager(cfg.imu_weight, cfg.sensor_time_offset)
        self._invalidate_submaps()
        if reset_log:
            self.n_frames = 0
            self.log_trajectory: List[dict] = []  # {time, pose (4,4), covariance}
            self.log_keypoints: List[dict] = []   # per frame {type: stored keypoints}

    def _invalidate_submaps(self):
        """Mark the cached submap selections stale (reset, external map
        change)."""
        self._submap_cache = pipeline.init_submap_cache(self.cfg, self._map_cfgs_tuple,
                                                        self.device,
                                                        sharded=self.mesh is not None)
        self._cache_stale = True

    def _reshard_maps(self):
        """After the maps were replaced by global ones from outside the
        sharded step (PCD load, PGO rebuild, checkpoint restore): the
        submaps are stale, and under `shard_maps` each rank keeps its slab
        of the global map repacked in slab order (`reshard_host`)."""
        self._invalidate_submaps()
        if not self.shard_maps:
            return
        mesh = self.mesh
        for k in self.cfg.used_types:
            g = sharded_map.reshard_host(self.maps[k], self.map_cfgs[k], mesh.size)
            self.maps[k] = sharded_map.local_slab(g, mesh.rank, mesh.size, self.device)

    def _rank0_writes(self, write):
        """Run `write` on rank 0 only (every process without a mesh); on a
        mesh every rank returns once it has run (a barrier), so a file it
        writes exists for all of them."""
        if self.mesh is None or self.mesh.rank == 0:
            write()
        if self.mesh is not None:
            self.mesh.psum(torch.zeros(1, device=self.device))

    def _global_map(self, m):
        """A map as one map: under `shard_maps` the slabs of every rank,
        gathered (a collective); otherwise `m` itself."""
        if m is None or not self.shard_maps:
            return m
        return sharded_map.gather_slabs(self.mesh, m)

    def _empty_keypoints(self):
        return tuple(Keypoints.empty(self.cfg.extractor.kp_capacity(i), self.device)
                     for i in range(3))

    def _prev_keypoints(self):
        return self._device_keypoints if self._device_keypoints is not None \
            else self._empty_keypoints()

    # ------------------------------------------------------------------
    # Main entry
    # ------------------------------------------------------------------

    @_root_span("slam.add_frame")
    def add_frame(self, frame: dict, next_frame: dict = None) -> dict:
        """Process one sweep (Slam::AddFrames single-LiDAR path).

        `frame` is a dict with arrays xyz (n,3), intensity, laser_id, time
        and scalar `stamp` [s] (+ optional `seq`). Pass the upcoming sweep as
        `next_frame` to build and upload its wire right after this sweep's
        step is issued. Returns a summary dict."""
        t0 = _time.perf_counter()
        cfg = self.cfg
        skip = self._check_frame(frame)
        if skip:
            return skip
        stamp = float(frame["stamp"])
        pre, self._prefetched = self._prefetched, None
        if pre is not None and pre[0] == frame.get("stamp"):
            ri = pre[1]
        else:
            with span("slam.ingest"):
                ri = self._build_ri(frame)
        az_invalid = not _valid_az(self.azimuthal_resolution)
        if az_invalid:
            with span("slam.sync"):
                self.azimuthal_resolution = float(
                    estimate_azimuthal_resolution(ensure_range_image(ri)))

        first = not self._maps_populated
        prev_kps = None
        if first or az_invalid or not self._frame_captured():
            inp = self._make_inputs(stamp)
            maps_in = tuple(self.maps.get(Keypoint(i)) for i in range(3))
            with span("slam.step"):
                res = self._step("process_frame")(ri, maps_in, self._prev_keypoints(), inp,
                                                   cfg, self._map_cfgs_tuple, first)
        else:
            with span("slam.step"):
                res = self._replay_frame(ri, stamp)
            prev_kps = res.keypoints
            # the sweep's own keypoints, kept while later replays run
            res = res._replace(keypoints=stream_graph.clone_tree(prev_kps))
        if next_frame is not None and next_frame.get("xyz") is not None \
                and len(next_frame["xyz"]) > 0:
            with span("slam.ingest"):
                self._prefetched = (next_frame["stamp"], self._build_ri(next_frame))
        if isinstance(res.packed, torch.Tensor):   # a replay's one read
            with span("slam.sync"):
                res = res._replace(packed=res.packed.cpu().numpy())
        out = self._apply_result(res, stamp, t0)
        if prev_kps is not None:
            self._device_keypoints = prev_kps
        self.last_stamp = frame["stamp"]
        return out

    def _frame_captured(self) -> bool:
        """Whether add_frame replays its step as a CUDA graph: on one card,
        with no mesh."""
        return self.device.type == "cuda" and self.mesh is None

    def _replay_frame(self, ri, stamp) -> pipeline.FrameResult:
        """add_frame's step as a step of the live graph (a replay once it is
        captured). The graph's state is reseeded from the host's where the
        host's maps, previous keypoints or submap cache are not the graph's
        buffers; new maps force the submap's rebuild. The result's packed
        scalars stay on the device."""
        trel_prior, prev_rel, kf_rel, t_prev, extras = self._host_inputs(stamp)
        g = self._frame_graph_for(ri, extras)
        maps = tuple(self.maps.get(Keypoint(i)) for i in range(3))
        prev = self._prev_keypoints()
        new_maps = g.state is None or any(a is not b for a, b in zip(maps, g.state[0]))
        if new_maps or prev is not g.state[1] or self._submap_cache is not g.state[2] \
                or self._cache_stale is not g.state[3]:
            g.seed(maps, prev, self._submap_cache, self._cache_stale)
        record = stream_graph.FrameRecord.pack(
            trel_prior, prev_rel, kf_rel, stamp, t_prev, self.azimuthal_resolution,
            self.kf_counter, self.mapping_mode != MappingMode.NONE, new_maps, extras)
        replay = g.replays_next
        with span("slam.replay") if replay else contextlib.nullcontext():
            res = g.step(ri, record)
        self.live_replays += replay
        return res

    def _frame_graph_for(self, ri, extras):
        """The live graph, built at first use on the wire of `ri` with the
        sensor blocks of the configured weights, and anew, taking over the
        old one's state buffers, for a block of a kind it lacks (captured
        anew, as `_graph_with_blocks` does for the stream)."""
        g = self._frame_graph
        have = g.blocks if g is not None else (self.wheel_odom.weight > 1e-6,
                                               self.imu.weight > 1e-6)
        need = tuple(h or any(isinstance(e, kind) for e in extras)
                     for h, kind in zip(have, stream_graph.BLOCK_KINDS))
        if g is None or need != g.blocks:
            new = stream_graph.FrameGraph(self.cfg, self._map_cfgs_tuple, self.device, ri,
                                          blocks=need)
            if g is not None:
                new.state = g.state
            g = self._frame_graph = new
        return g

    def _build_ri(self, frame, device=None):
        """The sweep's wire on the Slam's device; `device=False`: the host
        sweep of a window (a PackedRangeImage, or float planes)."""
        cfg = self.cfg
        return build_range_image(frame["xyz"], frame["intensity"], frame["laser_id"],
                                 frame["time"], cfg.extractor.n_rings,
                                 cfg.extractor.max_ring_points,
                                 packed=cfg.compress_upload,
                                 device=self.device if device is None else device)

    def add_frames(self, frames) -> dict:
        """Process one synchronized multi-LiDAR acquisition
        (Slam::AddFrames, Slam.cxx:230-344 + ExtractKeypoints 746-810).

        Each frame dict carries a `device_id`; per-device sweeps are
        extracted independently, transformed into BASE by the per-device
        calibration offsets, time-rebased to the first frame's stamp, and
        the keypoint sets merged before the shared pipeline. A lone frame of
        an uncalibrated device goes to `add_frame`."""
        t0 = _time.perf_counter()
        frames = [f for f in frames if f["xyz"] is not None and len(f["xyz"])]
        if not frames:
            return {"skipped": "empty"}
        if len(frames) == 1 and int(frames[0].get("device_id", 0)) not in \
                self.base_to_lidar_offsets:
            return self.add_frame(frames[0])
        skip = self._check_frame(frames[0])
        if skip:
            return skip
        stamp = float(frames[0]["stamp"])
        kps = self._extract_merge(frames, stamp)
        inp = self._make_inputs(stamp)
        first = not self._maps_populated
        maps_in = tuple(self.maps.get(Keypoint(i)) for i in range(3))
        res = self._step("process_keypoints", extraction=False)(
            kps, None, maps_in, self._prev_keypoints(), inp, self.cfg, self._map_cfgs_tuple,
            first)
        out = self._apply_result(res, stamp, t0)
        self.last_stamp = frames[0]["stamp"]
        return out

    def _extract_merge(self, frames, stamp):
        """Per-device extraction (each LiDAR with its own ExtractorConfig and
        azimuthal resolution, estimated once and kept, Slam.h:239-245 /
        LidarSlamNode.cxx:791-817), BASE-frame transform by calibration
        offset, time rebase, and merge into one keypoint set per type at the
        default extractor's capacities."""
        cfg = self.cfg
        cuda = self.device.type == "cuda"
        per_type = ([], [], [])
        for f in frames:
            dev = int(f.get("device_id", 0))
            ecfg = cfg.extractor_for(dev)
            ri = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                                   ecfg.n_rings, ecfg.max_ring_points,
                                   device=False if cuda else self.device)
            az = self._az_by_device.get(dev, ecfg.azimuthal_resolution)
            if not _valid_az(az):
                az = float(estimate_azimuthal_resolution(
                    RangeImage(*(torch.as_tensor(a) for a in ri))))
                self._az_by_device[dev] = az
            if self.azimuthal_resolution <= 1e-6:
                self.azimuthal_resolution = az
            pose6 = se3.hmat_to_pose(self.base_to_lidar_offsets.get(dev, np.eye(4)))
            dt = float(f["stamp"]) - stamp
            if cuda:    # one graph per device: extraction and transform replayed
                g = self._extract_graphs.get(dev)
                if g is None or g.ecfg is not ecfg:
                    g = self._extract_graphs[dev] = stream_graph.ExtractGraph(ecfg, self.device)
                kps = g.run(ri, dt, az, pose6)
            else:
                ext = extractor.extract_keypoints(ri, float(np.float32(az)), ecfg)
                pose = torch.tensor(pose6, dtype=torch.float32)
                kps = [transform_keypoints(kp, pose, dt)
                       for kp in (ext.edges, ext.planes, ext.blobs)]
            for i, kp in enumerate(kps):
                per_type[i].append(kp)
        return tuple(merge_keypoints(per_type[i], cfg.extractor.kp_capacity(i))
                     for i in range(3))

    def set_base_to_lidar_offset(self, device_id: int, hmat):
        """Static LIDAR-in-BASE calibration per device (Slam.h:502-505)."""
        self.base_to_lidar_offsets[int(device_id)] = np.asarray(hmat, np.float64)

    # ------------------------------------------------------------------
    # Streaming (device-chained) mode: no host sync until flush
    # ------------------------------------------------------------------

    @_root_span("slam.add_frame_async")
    def add_frame_async(self, frame: dict) -> int:
        """Enqueue one sweep in streaming mode; returns its frame index (-1
        when skipped).

        The ego-motion prior, the keyframe gate and the rolling origin
        advance on the device, so nothing synchronizes with the host until
        `flush()`, which fills the logs and returns the results. Mixing with
        `add_frame` is allowed across a flush. Sweeps buffer on the host
        and every `cfg.stream_window` of them go up in one upload."""
        skip = self._check_frame(frame)
        if skip:
            return -1
        stamp = float(frame["stamp"])
        self._ensure_stream_state()
        first = not self._maps_populated and self._stream_enqueued == 0 \
            and self.n_frames == 0
        extras = self._stream_extras(stamp)
        # until a valid azimuthal-resolution estimate exists (the first
        # sweep against preloaded maps) sweeps take the per-frame path,
        # which estimates it
        az_invalid = not _valid_az(self.azimuthal_resolution)
        # on CUDA every steady-state sweep replays the graph, so a window of
        # one is still a window
        windowed = not first and not az_invalid and (self.cfg.stream_window > 1
                                                      or self._graph is not None)
        # a sweep with sensor blocks runs alone after the buffered ones on
        # the CPU, whose window step takes none; on CUDA the graph replays
        # each record on its own, its blocks in the record
        if windowed and (self._graph is not None or not extras):
            with span("slam.ingest"):
                ri_host = self._build_ri(frame, device=False)
            self._window_buf.append((ri_host, stamp, extras))
            if len(self._window_buf) >= self.cfg.stream_window:
                self._dispatch_window()
        else:
            # any buffered partial window runs first, to keep frame order
            self._drain_window()
            with span("slam.ingest"):
                ri = self._build_ri(frame)
            if az_invalid:
                with span("slam.sync"):
                    self.azimuthal_resolution = float(
                        estimate_azimuthal_resolution(ensure_range_image(ri)))
            dev_extras = tuple(on_device(e, self.device) for e in extras)
            with span("slam.step"):
                if self._graph is not None:
                    self._graph.set_az(self.azimuthal_resolution)
                    packed, kps_flat = self._graph.eager_step(ri, stamp, first, dev_extras)
                else:
                    self._stream_state, packed, kps_flat = self._step("process_frame_stream")(
                        ri, self._stream_state, self._f32(stamp),
                        self._f32(self.azimuthal_resolution), self.cfg,
                        self._map_cfgs_tuple, first, dev_extras)
            self._stream_pending.append({"stamps": [stamp], "packed": packed,
                                         "kps_flat": kps_flat})
        self.last_stamp = frame["stamp"]
        idx = self._stream_enqueued
        self._stream_enqueued += 1
        return idx

    def add_frames_async(self, frames) -> int:
        """Streaming multi-LiDAR: enqueue one synchronized acquisition (per
        device extraction, transform and merge as in `add_frames`), whose
        merged keypoints step the device-resident stream (on CUDA a replay
        of the rig's graph). Returns the pending frame
        index; results land at `flush()`. A lone frame of an uncalibrated
        device on the default extractor goes to `add_frame_async`; a device
        with its own ExtractorConfig keeps this path."""
        cfg = self.cfg
        frames = [f for f in frames if f["xyz"] is not None and len(f["xyz"])]
        if not frames:
            return -1
        dev0 = int(frames[0].get("device_id", 0))
        if len(frames) == 1 and dev0 not in self.base_to_lidar_offsets \
                and cfg.extractor_for(dev0) is cfg.extractor:
            return self.add_frame_async(frames[0])
        skip = self._check_frame(frames[0])
        if skip:
            return -1
        stamp = float(frames[0]["stamp"])
        self._ensure_stream_state()
        kps = self._extract_merge(frames, stamp)
        self._drain_window()        # a partial window runs first, in order
        extras = self._stream_extras(stamp)
        first = not self._maps_populated and self._stream_enqueued == 0 \
            and self.n_frames == 0
        if self._graph is not None:
            g = self._rig_graph_for(extras)
            g.set_az(self.azimuthal_resolution)
            if first:
                packed, kps_flat = g.eager_step(
                    kps, stamp, True, tuple(on_device(e, self.device) for e in extras))
            else:   # the record goes up and is replayed without a host sync
                g.wire.write(g.record, kps, stamp, extras)
                packed, kps_flat = g.step()
        else:
            self._stream_state, packed, kps_flat = self._step(
                "process_keypoints_stream", extraction=False)(
                kps, self._stream_state, self._f32(stamp),
                self._f32(self.azimuthal_resolution), cfg, self._map_cfgs_tuple, first,
                tuple(on_device(e, self.device) for e in extras))
        self._stream_pending.append({"stamps": [stamp], "packed": packed,
                                     "kps_flat": kps_flat})
        self.last_stamp = frames[0]["stamp"]
        idx = self._stream_enqueued
        self._stream_enqueued += 1
        return idx

    def _f32(self, x) -> torch.Tensor:
        return torch.full((), float(np.float32(x)), dtype=torch.float32,
                          device=self.device)

    def _dispatch_window(self):
        """Run the buffered full window."""
        buf, self._window_buf = self._window_buf, []
        self._run_window(buf)

    def _run_window(self, buf):
        """Step buffered sweeps in order: on CUDA one upload of their
        records (flat wire or float planes) and one graph replay each, on
        the CPU the eager window."""
        with span("slam.dispatch"):
            cfg = self.cfg
            stamps = [s for _, s, _ in buf]
            if self._graph is not None:
                with torch.cuda.device(self.device):
                    self._graph_with_blocks([e for _, _, ex in buf for e in ex])
                    wire = self._graph.wire
                    sweeps = [flatten_packed(r, wire.capacity) if isinstance(r, PackedRangeImage)
                              else r for r, _, _ in buf]
                    records = wire.pack(sweeps, stamps, [ex for _, _, ex in buf])
                    packed, kps_flat = self._graph.run(records.to(self.device, non_blocking=True))
            else:
                ris = [r for r, _, _ in buf]
                if cfg.flat_wire and isinstance(ris[0], PackedRangeImage):
                    ris = [flatten_packed(r, cfg.wire_capacity) for r in ris]
                self._stream_state, packed, kps_flat = self._step("process_stream_window")(
                    stack_range_images(ris, self.device), self._stream_state,
                    torch.tensor(stamps, dtype=torch.float32, device=self.device),
                    self._f32(self.azimuthal_resolution), cfg, self._map_cfgs_tuple)
            self._stream_pending.append({"stamps": stamps, "packed": packed,
                                         "kps_flat": kps_flat})

    def _drain_window(self):
        """Run a buffered partial window sweep by sweep (on CUDA: graph
        replays of one upload; on the CPU: the per-frame step on each
        sweep's planes, as the JAX package does)."""
        if not self._window_buf:
            return
        buf, self._window_buf = self._window_buf, []
        if self._graph is not None:
            self._run_window(buf)
            return
        for ri_host, stamp, _ in buf:
            with span("slam.step"):
                self._stream_state, packed, kps_flat = self._step("process_frame_stream")(
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
            with span("slam.sync"):   # blocking copies of the host state
                state = pipeline.seed_stream_state(
                    tuple(self.maps.get(Keypoint(i)) for i in range(3)),
                    se3.hmat_to_pose(rel).astype(np.float32),
                    se3.hmat_to_pose(prev_rel).astype(np.float32),
                    np.float32(t_cur), np.float32(t_prev),
                    se3.hmat_to_pose(kf_rel).astype(np.float32), self.kf_counter,
                    np.round(self.map_origin / res_m).astype(np.int32),
                    max(self.n_frames, 1), self.mapping_mode != MappingMode.NONE,
                    cfg, self._map_cfgs_tuple, self.device, self.mesh, self.shard_maps)
        else:
            state = pipeline.init_stream_state(cfg, self._map_cfgs_tuple, self.device,
                                               self.mesh, self.shard_maps)
            state = state._replace(map_update=torch.full(
                (), self.mapping_mode != MappingMode.NONE, dtype=torch.bool,
                device=self.device))
        if self._stream_captured():
            if self._graph is None:
                ecfg = cfg.extractor
                cap = (cfg.wire_capacity if cfg.flat_wire else 0) \
                    or ecfg.n_rings * ecfg.max_ring_points
                wire = stream_graph.WireRecord(ecfg.n_rings, ecfg.max_ring_points, cap) \
                    if cfg.compress_upload \
                    else stream_graph.FloatRecord(ecfg.n_rings, ecfg.max_ring_points)
                self._graph = self._new_graph(
                    wire, (self.wheel_odom.weight > 1e-6, self.imu.weight > 1e-6))
            self._graph.seed(state, self.azimuthal_resolution)
            state = self._graph.state
        self._stream_state = state

    def _stream_captured(self) -> bool:
        """Whether the stream replays CUDA graphs: on a card, alone or on an
        NCCL mesh. A gloo mesh streams eagerly: gloo stages every collective
        through host memory (ROADMAP Queue 3, D10)."""
        return self.device.type == "cuda" and (self.mesh is None
                                                or self.mesh.backend == "nccl")

    def _new_graph(self, wire, blocks):
        """A StreamGraph of this Slam's step on `wire` (on a mesh its SPMD
        step) holding the sensor `blocks`."""
        return stream_graph.StreamGraph(
            self.cfg, self._map_cfgs_tuple, self.device, wire, blocks=blocks, mesh=self.mesh,
            shard_maps=self.shard_maps, shard_extraction=self.shard_extraction)

    def _graph_with_blocks(self, extras):
        """Make the graph hold a block of each kind in `extras`: a graph
        without one is replaced by one with it, seeded with the current
        state (captured anew, as the JAX package compiles a new program
        for a new extras structure)."""
        g = self._graph
        need = tuple(have or any(isinstance(e, kind) for e in extras)
                     for have, kind in zip(g.blocks, stream_graph.BLOCK_KINDS))
        if need == g.blocks:
            return
        self._graph = self._new_graph(g.wire, need)
        self._graph.seed(g.state, self.azimuthal_resolution)
        self._stream_state = self._graph.state

    def _rig_graph_for(self, extras):
        """The graph of a rig's merged keypoints: built at first use, and
        anew whenever the sweep graph was (for a block it lacked), sharing
        the sweep graph's state and blocks."""
        self._graph_with_blocks(extras)
        g = self._graph
        if self._rig_graph is None or self._rig_graph.state is not g.state:
            caps = [self.cfg.extractor.kp_capacity(i) for i in range(3)]
            self._rig_graph = self._new_graph(stream_graph.KeypointRecord(caps), g.blocks)
            self._rig_graph.share(g)
        return self._rig_graph

    def _stream_extras(self, stamp):
        """The sweep's sensor residual blocks (host values, prev_pos rebased
        to the map frame), computed at enqueue time as the JAX package does:
        in relative mode `prev_pos` only moves in `add_frame`, so a streamed
        sweep measures from the last synchronous pose (ROADMAP Queue 3)."""
        extras = []
        if self.wheel_odom.can_be_used():
            r = self.wheel_odom.compute_constraint(stamp)
            if r is not None:
                extras.append(r._replace(
                    prev_pos=r.prev_pos - np.asarray(self.map_origin, np.float32)))
        if self.imu.can_be_used():
            r = self.imu.compute_constraint(stamp)
            if r is not None:
                extras.append(r)
        return extras

    @_root_span("slam.flush")
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
        rows = torch.cat([e["packed"].reshape(-1, n_packed) for e in self._stream_pending])
        with span("slam.sync"):
            rows = rows.cpu().numpy()
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
                self.Trelative = se3.pose_to_hmat(u["trel"])
                self.covariance = u["cov"]
                self._note_ego(u)
                self.failure = u["failed"]
                self.total_matched_keypoints = u["total"]
                self.match_counts = u["counts"]
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
                self._emit_output(stamp, outs[-1], u["is_kf"], self.current_keypoints)
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

    def _pose_tensor(self, pose):
        with span("slam.sync"):   # a blocking copy from pageable memory
            return torch.tensor(pose, dtype=torch.float32, device=self.device)

    def _host_inputs(self, stamp):
        """The step's inputs as host values, in float64: the ego-motion
        prior, the previous pose and the last keyframe's pose (MAP frame;
        each xyzrpy), the previous stamp and the sweep's host sensor
        residuals."""
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
        extras = self._stream_extras(stamp)   # Slam::ComputeSensorConstraints
        self.ego_prior = se3.hmat_to_pose(trel_prior)
        return (self.ego_prior, se3.hmat_to_pose(prev_rel),
                se3.hmat_to_pose(kf_rel), t_prev, extras)

    def _make_inputs(self, stamp) -> pipeline.FrameInputs:
        """The eager step's inputs: `_host_inputs` on the device."""
        trel_prior, prev_rel, kf_rel, t_prev, extras = self._host_inputs(stamp)
        return pipeline.FrameInputs(
            trel_prior=self._pose_tensor(trel_prior),
            prev_pose=self._pose_tensor(prev_rel),
            t_prev=t_prev,
            stamp=stamp,
            az_resolution=float(np.float32(self.azimuthal_resolution)),
            kf_last_pose=self._pose_tensor(kf_rel),
            kf_counter=int(self.kf_counter),
            extras=tuple(on_device(e, self.device) for e in extras),
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
        self.current_keypoints = {Keypoint(i): res.keypoints[i] for i in range(3)}
        self.current_warp = res.warp
        if cfg.verbosity >= 1:
            for t in cfg.used_types:
                cap = cfg.extractor.kp_capacity(t)
                if int(u["kp_counts"][int(t)]) >= cap:
                    self._log(f"{t.name} keypoints hit capacity {cap}; raise the "
                              "extractor keypoint budget for this sensor")
        self.failure = u["failed"]
        self.total_matched_keypoints = u["total"]
        self.match_counts = u["counts"]
        self.overlap = u["overlap"]
        self._update_map_overflow(u["map_overflow"])
        if self.failure:
            self._log("not enough keypoints matched; localization skipped")

        self.PreviousTworld = self.Tworld.copy()
        Tnew = se3.pose_to_hmat(u["pose"])
        Tnew[:3, 3] += self.map_origin
        self.Tworld = Tnew
        self.Trelative = se3.pose_to_hmat(u["trel"])
        self.covariance = u["cov"]
        self._note_ego(u)
        if u["is_kf"]:
            self.kf_counter += 1
            self.kf_last_pose = self.Tworld.copy()
            self._maps_populated = True
        shift = np.asarray(u["roll_offset"], np.float64) * voxel_map.effective_resolution(
            self._map_cfgs_tuple[int(cfg.used_types[0])])
        self.map_origin = self.map_origin + shift
        if cfg.wheel_odom_relative and not self.failure:
            self.wheel_odom.set_reference_pose(self.Tworld[:3, 3])

        self._check_motion_limits(stamp)
        self._log_state(stamp)
        self._last_statuses = res.statuses
        self._last_weights = res.weights
        self.n_frames += 1
        self.latency = _time.perf_counter() - t0
        ret = {
            "pose": self.Tworld.copy(),
            "covariance": self.covariance.copy(),
            "n_matches": int(self.total_matched_keypoints),
            "overlap": self.overlap,
            "comply_motion_limits": self.comply_motion_limits,
            "failure": self.failure,
            "kp_counts": u["kp_counts"],
            "duration": self.latency,
        }
        self._emit_output(stamp, ret, u["is_kf"], self.current_keypoints)
        return ret

    def _note_ego(self, u):
        """Keep a sweep's ego-motion registration from its packed scalars
        `u`. With registration configured, its device counts also go into
        the trace, read by no host sync of their own: one `slam.ego.counts`
        span holding a `slam.ego.round` span per open round and a
        `slam.ego.lm_step` span per live LM trip."""
        self.ego_motion = u["ego_trel"]
        self.ego_rounds, self.ego_lm_steps = u["ego_rounds"], u["ego_lm_steps"]
        if self.cfg.ego_motion_mode not in (
                EgoMotionMode.REGISTRATION, EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION):
            return
        with span("slam.ego.counts"):
            for name, n in (("slam.ego.round", self.ego_rounds),
                            ("slam.ego.lm_step", self.ego_lm_steps)):
                for _ in range(n):
                    with span(name):
                        pass

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
        """Trajectory/covariance/keypoint logging with timeout pruning
        (Slam::LogCurrentFrameState, Slam.cxx:1225-1264). Each frame's
        keypoints go through `cfg.logging_storage` (io/storage.py); the
        DEVICE tier keeps tensors of the log's own."""
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
                if self.log_keypoints:
                    self.log_keypoints.pop(0)
        if cfg.logging_timeout != 0:
            self.log_keypoints.append(
                {k: storage.store(self.current_keypoints[k], cfg.logging_storage,
                                  directory=cfg.logging_dir,
                                  tag=f"{self.n_frames:06d}_{KEYPOINT_NAMES[k]}")
                 for k in cfg.used_types})

    def get_log_memory_usage(self) -> dict:
        """Bytes held by the keypoint log per storage tier (the verbosity-5
        log-memory report, Slam.cxx:318-338 / PointCloudStorage MemorySize)."""
        total = {"ram": 0, "disk": 0, "device": 0}
        for entry in self.log_keypoints:
            for obj in entry.values():
                for tier, b in storage.memory_size(obj).items():
                    total[tier] += b
        total["n_frames"] = len(self.log_keypoints)
        return total

    # ------------------------------------------------------------------
    # Pose-graph optimization (Slam::RunPoseGraphOptimization, 355-487)
    # ------------------------------------------------------------------

    def run_pose_graph_optimization(self, gps_positions, gps_times,
                                    gps_covariances=None,
                                    gps_to_sensor_offset=None,
                                    use_device_backend=None,
                                    n_segments: int = 0,
                                    g2o_file_name: str = "",
                                    odometry_sigma_floor: float = 0.0) -> bool:
        """Optimize the whole logged trajectory against GPS priors and
        rebuild the maps from the logged keypoints. Returns success.

        `use_device_backend` selects the batched float64 torch solver on the
        Slam's device (default: auto, device for >= 100 poses);
        `n_segments > 1` uses the segment-Schur partitioned solve.
        `g2o_file_name` dumps the graph in g2o text format before optimizing
        (PoseGraphOptimization.cxx:164-170).

        `odometry_sigma_floor` [m]: additive floor on the odometry edges'
        covariance. The registration covariance models match noise only, so
        with thousands of matches the chain is numerically rigid and GPS
        priors can only align it globally; a floor at the expected per-frame
        drift lets them bend it. 0 keeps the reference's semantics
        (information = inverse SLAM covariance,
        PoseGraphOptimization.cxx:222-247)."""
        from lidarslam_tpu_torch.backend import posegraph

        cfg = self.cfg
        if len(self.log_trajectory) < 2:
            self._log("PGO requires at least 2 logged poses")
            return False
        if len(self.log_keypoints) != len(self.log_trajectory):
            self._log("PGO requires keypoint logging (logging_timeout != 0)")
            return False

        times = np.array([e["time"] for e in self.log_trajectory])
        poses = [e["pose"] for e in self.log_trajectory]
        covs = [e["covariance"] if np.trace(e["covariance"]) > 0 else np.eye(6) * 1e-4
                for e in self.log_trajectory]
        if odometry_sigma_floor > 0:
            covs = [c + np.eye(6) * odometry_sigma_floor**2 for c in covs]
        gps = dict(
            gps_positions=np.asarray(gps_positions, np.float64),
            gps_times=np.asarray(gps_times, np.float64),
            gps_covariances=None if gps_covariances is None
            else np.asarray(gps_covariances, np.float64),
            gps_to_sensor_offset=gps_to_sensor_offset)

        if g2o_file_name:
            posegraph.save_g2o(
                g2o_file_name, poses, times,
                rel_information=[np.linalg.inv(c + np.eye(6) * 1e-8) for c in covs[1:]],
                gps_positions=gps_positions,
                gps_vertex=[int(np.argmin(np.abs(times - t))) for t in gps_times],
                gps_information=None if gps_covariances is None
                else [np.linalg.inv(np.asarray(c) + np.eye(3) * 1e-9)
                      for c in gps_covariances],
                gps_to_sensor_offset=gps_to_sensor_offset)
            self._log(f"pose graph dumped to {g2o_file_name}")

        if use_device_backend is None:
            use_device_backend = len(poses) >= 100
        if use_device_backend:
            from lidarslam_tpu_torch.backend.posegraph_device import optimize_pose_graph_device

            # on a mesh the segment interiors shard over the ranks
            optimized, cost = optimize_pose_graph_device(
                poses, times, covs, **gps, n_segments=n_segments,
                verbose=cfg.verbosity >= 2, device=self.device, mesh=self.mesh)
        else:
            optimized, cost = posegraph.optimize_pose_graph(
                poses, times, covs, **gps, verbose=cfg.verbosity >= 2)

        # re-anchor the world frame at the first optimized pose (Slam.cxx:404-419)
        anchor_inv = se3.hmat_inverse(optimized[0])
        new_poses = [anchor_inv @ p for p in optimized]
        for e, p in zip(self.log_trajectory, new_poses):
            e["pose"] = p
        self._rebuild_maps(times[-1])
        self.Tworld = new_poses[-1].copy()
        self.PreviousTworld = new_poses[-2].copy()
        self.Trelative = se3.hmat_inverse(self.PreviousTworld) @ self.Tworld
        self.kf_last_pose = self.Tworld.copy()
        self._log(f"PGO done: cost {cost:.3e}, {len(new_poses)} poses")
        return True

    def _rebuild_maps(self, stamp):
        """Rebuild the maps on the device from the keypoint log at the
        logged (optimized) poses (Slam.cxx:421-477): each frame's keypoints
        in WORLD (replay-undistorted between consecutive poses when
        undistortion is on), inserted in chunks of the map's capacity with
        an origin at 0, then rolled so the last frame's box fits."""
        cfg, dev = self.cfg, self.device
        self.maps = {k: voxel_map.VoxelMap.empty(self.map_cfgs[k], dev)
                     for k in cfg.used_types}
        self.map_origin = np.zeros(3)
        world_clouds = {k: [] for k in cfg.used_types}
        last_bbox = None
        n = len(self.log_trajectory)
        for i, (entry, kps) in enumerate(zip(self.log_trajectory, self.log_keypoints)):
            H = entry["pose"]
            for k in cfg.used_types:
                kp = storage.restore(kps[k])
                if len(kp.xyz) == 0:
                    continue
                pts = kp.xyz.astype(np.float64)
                if cfg.undistortion != 0 and i >= 1:
                    pts = self._replay_undistort(pts, kp.time, self.log_trajectory[i - 1], entry)
                else:
                    pts = pts @ H[:3, :3].T + H[:3, 3]
                world_clouds[k].append((pts.astype(np.float32), kp.intensity))
                if i == n - 1:
                    bb = (pts.min(axis=0), pts.max(axis=0))
                    last_bbox = (np.minimum(last_bbox[0], bb[0]),
                                 np.maximum(last_bbox[1], bb[1])) if last_bbox else bb
        off = np.zeros(3, np.int64)
        for k in cfg.used_types:
            if not world_clouds[k]:
                continue
            mc = self.map_cfgs[k]
            all_pts = np.concatenate([c[0] for c in world_clouds[k]])
            all_int = np.concatenate([c[1] for c in world_clouds[k]]).astype(np.float32)
            for start in range(0, len(all_pts), mc.capacity):
                pts = torch.from_numpy(all_pts[start:start + mc.capacity]).to(dev)
                inten = torch.from_numpy(all_int[start:start + mc.capacity]).to(dev)
                valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
                self.maps[k] = voxel_map.add_points(self.maps[k], pts, inten, stamp, valid,
                                                    stamp, mc, fixed=False)
            if last_bbox is not None:
                lo, hi = (torch.tensor(b, dtype=torch.float32, device=dev) for b in last_bbox)
                self.maps[k], o = voxel_map.roll(self.maps[k], lo, hi, mc)
                off = o.cpu().numpy().astype(np.int64)
        if last_bbox is not None:
            res = voxel_map.effective_resolution(next(iter(self.map_cfgs.values())))
            self.map_origin = self.map_origin + off.astype(np.float64) * res
        self._reshard_maps()

    def _replay_undistort(self, pts, point_times, prev_entry, cur_entry):
        """Per-point slerp between consecutive optimized poses (Slam.cxx:426-440)."""
        H0, H1 = prev_entry["pose"], cur_entry["pose"]
        t0, t1 = prev_entry["time"], cur_entry["time"]
        if abs(t1 - t0) < 1e-9 or np.allclose(H0, H1, atol=1e-12):
            return pts @ H1[:3, :3].T + H1[:3, 3]
        R, tv = se3.interpolate_rt(H0[:3, :3], H0[:3, 3], H1[:3, :3], H1[:3, 3],
                                   t1 + point_times.astype(np.float64), t0, t1)
        return np.einsum("nij,nj->ni", R, pts) + tv

    # ------------------------------------------------------------------
    # Results API
    # ------------------------------------------------------------------

    def get_world_transform(self) -> np.ndarray:
        return self.Tworld.copy()

    def get_latency_compensated_world_transform(self) -> np.ndarray:
        """Extrapolate the pose by the last processing latency
        (Slam::GetLatencyCompensatedWorldTransform, Slam.cxx:556-588)."""
        if len(self.log_trajectory) < 2:
            return self.Tworld.copy()
        prev, cur = self.log_trajectory[-2], self.log_trajectory[-1]
        dt = cur["time"] - prev["time"]
        if abs(dt) < 1e-6 or abs(self.latency / dt) > self.cfg.max_extrapolation_ratio:
            return self.Tworld.copy()
        return se3.interpolate_hmat(prev["pose"], cur["pose"], cur["time"] + self.latency,
                                    prev["time"], cur["time"])

    def set_world_transform_from_guess(self, pose_hmat: np.ndarray):
        """External pose reset (Slam::SetWorldTransformFromGuess, 490-501):
        the previous sweep's keypoints are dropped with the old pose."""
        self.Tworld = np.asarray(pose_hmat, np.float64).copy()
        self.PreviousTworld = self.Tworld.copy()
        self._device_keypoints = None

    def get_trajectory(self):
        return [(e["time"], e["pose"].copy()) for e in self.log_trajectory]

    def get_covariance(self) -> np.ndarray:
        return self.covariance.copy()

    def get_map_points(self, k: Keypoint, clean: bool = False):
        """World-frame map points (RollingGrid::Get). Under `shard_maps` a
        collective: every rank calls it and gets every slab's points."""
        xyz, inten, t, fixed = voxel_map.gather_valid_points(
            self._global_map(self.maps[k]), clean, self.map_cfgs[k])
        return xyz + self.map_origin.astype(np.float32), inten, t, fixed

    def get_target_submap(self, k: Keypoint) -> np.ndarray:
        """World-frame points of the submap the matcher targets
        (Slam::GetTargetSubMap): the selection of the last rebuild, or the
        whole map when none is valid (before the first localization, after
        a map update, for a decaying type, and always on a mesh, which
        keeps no selection). In a streaming segment it reads the device
        state, which waits for the enqueued sweeps. Under `shard_maps` a
        collective: every rank calls it."""
        ti = int(k)
        origin = self.map_origin.astype(np.float32)
        if self._stream_state is not None:
            cache = self._stream_state.submap_cache[ti]
            m = self._stream_state.maps[ti]
            stale = bool(self._stream_state.cache_stale)
            origin = (self._stream_state.origin_vox.cpu().numpy().astype(np.float64)
                      * voxel_map.effective_resolution(self.map_cfgs[k])).astype(np.float32)
        else:
            cache = self._submap_cache[ti]
            m = self.maps.get(k)
            stale = bool(self._cache_stale)
        if m is None:
            return np.zeros((0, 3), np.float32)
        m = self._global_map(m)
        if cache is None or stale:
            xyz, _, _, _ = voxel_map.gather_valid_points(m, False, self.map_cfgs[k])
            return xyz + origin
        sel = (cache.selected & m.valid).cpu().numpy()
        return m.xyz.cpu().numpy()[sel] + origin

    def get_keypoints(self, k: Keypoint, world: bool = False) -> np.ndarray:
        """The last sweep's keypoints of one type (BASE frame, or WORLD with
        `world`, undistorted by the last `add_frame`'s warp)."""
        kp = self.current_keypoints.get(k)
        if kp is None:
            return np.zeros((0, 3), np.float32)
        n = int(kp.count)
        xyz = kp.xyz
        if world and self.current_warp is not None:
            xyz = undistortion.warp_points(torch.as_tensor(xyz, device=self.device),
                                           torch.as_tensor(kp.time, device=self.device),
                                           self.current_warp)
        pts = (xyz.cpu().numpy() if isinstance(xyz, torch.Tensor) else np.asarray(xyz))[:n]
        if world:
            pts = pts @ np.asarray(self.Tworld[:3, :3].T, np.float32) + \
                np.asarray(self.Tworld[:3, 3], np.float32)
        return pts

    def set_map_update(self, mode):
        """Live mapping-mode switch (Slam::SetMapUpdate): takes effect on the
        next sweep; in a streaming segment the buffered sweeps run first."""
        self.mapping_mode = MappingMode(mode)
        if self._stream_state is not None:
            self._drain_window()
            self._stream_state.map_update.fill_(self.mapping_mode != MappingMode.NONE)

    def get_map_update(self):
        return self.mapping_mode

    # SlamCommand codes (ros_wrapping/lidar_slam/msg/SlamCommand.msg)
    GPS_SLAM_CALIBRATION = 0
    GPS_SLAM_POSE_GRAPH_OPTIMIZATION = 2
    SET_SLAM_POSE_FROM_GPS = 4
    DISABLE_SLAM_MAP_UPDATE = 8
    ENABLE_SLAM_MAP_EXPANSION = 9
    ENABLE_SLAM_MAP_UPDATE = 10
    SAVE_KEYPOINTS_MAPS = 16
    SAVE_FILTERED_KEYPOINTS_MAPS = 17
    LOAD_KEYPOINTS_MAPS = 18

    def execute_command(self, command: int, string_arg: str = "", **kw):
        """Runtime command dispatch (LidarSlamNode::SlamCommandCallback,
        LidarSlamNode.cxx:244-349): live map-update switches, mid-run map
        save/load, GPS-prior pose-graph optimization, GPS calibration and
        pose reset. The map, GPS and pose commands flush an open stream
        first; mode switches apply live without ending it."""
        c = int(command)
        if c == self.DISABLE_SLAM_MAP_UPDATE:
            self.set_map_update(MappingMode.NONE)
        elif c == self.ENABLE_SLAM_MAP_EXPANSION:
            self.set_map_update(MappingMode.ADD_KPTS_TO_FIXED_MAP)
        elif c == self.ENABLE_SLAM_MAP_UPDATE:
            self.set_map_update(MappingMode.UPDATE)
        elif c in (self.SAVE_KEYPOINTS_MAPS, self.SAVE_FILTERED_KEYPOINTS_MAPS):
            self.flush()
            self.save_maps_to_pcd(string_arg, clean=c == self.SAVE_FILTERED_KEYPOINTS_MAPS)
        elif c == self.LOAD_KEYPOINTS_MAPS:
            self.flush()
            self.load_maps_from_pcd(string_arg)
        elif c == self.GPS_SLAM_POSE_GRAPH_OPTIMIZATION:
            self.flush()
            return self.run_pose_graph_optimization(**kw)
        elif c == self.GPS_SLAM_CALIBRATION:
            # rigid world alignment of the SLAM trajectory onto GPS positions
            # (GpsSlamCalibration path); returns WORLD<-ODOM
            from lidarslam_tpu_torch.backend import registration

            self.flush()
            slam_xyz = np.stack([e["pose"][:3, 3] for e in self.log_trajectory])
            return registration.compute_transform_offset(
                slam_xyz, np.asarray(kw["gps_positions"], np.float64),
                no_roll=bool(kw.get("no_roll", False)))
        elif c == self.SET_SLAM_POSE_FROM_GPS:
            self.flush()
            self.set_world_transform_from_guess(np.asarray(kw["pose"]))
        else:
            raise ValueError(f"unknown SLAM command {command}")

    # ------------------------------------------------------------------
    # Maps and whole-state snapshots
    # ------------------------------------------------------------------

    def save_maps_to_pcd(self, file_prefix: str, binary: bool = True,
                         clean: bool = False, compressed: bool = False):
        """Write one `<prefix><type>s.pcd` per enabled map
        (Slam::SaveMapsToPCD, Slam.cxx:504-516): WORLD points with
        intensity, time and the fixed flag as label. `compressed` writes
        PCL `binary_compressed` (LZF), the reference's PCDFormat=2. Under
        `shard_maps` a collective (the slabs are gathered); on a mesh rank 0
        writes the files and every rank returns once they exist."""
        from lidarslam_tpu_torch.io import pcd

        clouds = {k: voxel_map.gather_valid_points(self._global_map(self.maps[k]), clean,
                                                   self.map_cfgs[k])
                  for k in self.cfg.used_types}

        def write():
            for k, (xyz, inten, t, fixed) in clouds.items():
                pcd.save_pcd(f"{file_prefix}{KEYPOINT_NAMES[k]}s.pcd",
                             xyz + self.map_origin.astype(np.float32), intensity=inten, time=t,
                             label=fixed.astype(np.uint8), binary=binary,
                             compressed=compressed)
        self._rank0_writes(write)

    def load_maps_from_pcd(self, file_prefix: str, reset_maps: bool = True):
        """Load per-type maps (a missing file leaves its map as it is); the
        points are fixed when the mapping mode keeps the initial map
        immutable (Slam::LoadMapsFromPCD, Slam.cxx:519-543). On a mesh every
        rank reads the files; under `shard_maps` the maps are built whole
        and each rank keeps its slab (a collective when `reset_maps` is
        off: the slabs are gathered first)."""
        from lidarslam_tpu_torch.io import pcd

        dev = self.device
        if reset_maps:
            self.maps = {k: voxel_map.VoxelMap.empty(self.map_cfgs[k], dev)
                         for k in self.cfg.used_types}
            self.map_origin = np.zeros(3)
        else:
            self.maps = {k: self._global_map(m) for k, m in self.maps.items()}
        fixed = self.mapping_mode in (MappingMode.NONE, MappingMode.ADD_KPTS_TO_FIXED_MAP)
        for k in self.cfg.used_types:
            path = f"{file_prefix}{KEYPOINT_NAMES[k]}s.pcd"
            if not os.path.exists(path):
                continue
            data = pcd.load_pcd(path)
            pts = np.asarray(data["xyz"] - self.map_origin.astype(np.float32), np.float32)
            inten = np.asarray(data.get("intensity", np.zeros(len(pts), np.float32)),
                               np.float32)
            self.maps[k] = voxel_map.add_points(
                self.maps[k], torch.from_numpy(pts).to(dev), torch.from_numpy(inten).to(dev),
                0.0, torch.ones(len(pts), dtype=torch.bool, device=dev), 0.0,
                self.map_cfgs[k], fixed=fixed)
            if len(pts):
                self._maps_populated = True
        self._reshard_maps()

    def save_checkpoint(self, path: str):
        """Snapshot the maps, rolling origin, pose state and trajectory log
        into one .npz with the JAX package's keys (either package loads the
        other's), plus the previous sweep's keypoints under
        `prev_keypoints<type>_<field>`, which the JAX package does not write
        and ignores: with them the first sweep after a load registers its
        ego-motion as the uninterrupted run does (ROADMAP Queue 3, D7).
        Keypoint logs are not included. Under `shard_maps` a collective
        (the slabs are gathered into the global layout, the JAX package's
        sharded map); on a mesh rank 0 writes the file and every rank
        returns once it exists."""
        arrs = {
            "map_origin": self.map_origin, "Tworld": self.Tworld,
            "PreviousTworld": self.PreviousTworld, "Trelative": self.Trelative,
            "kf_last_pose": self.kf_last_pose,
            "kf_counter": np.int64(self.kf_counter),
            "covariance": self.covariance,
            "n_frames": np.int64(self.n_frames),
            "azimuthal_resolution": np.float64(self.azimuthal_resolution),
            "maps_populated": np.bool_(self._maps_populated),
            "traj_times": np.array([e["time"] for e in self.log_trajectory]),
            "traj_poses": np.stack([e["pose"] for e in self.log_trajectory])
            if self.log_trajectory else np.zeros((0, 4, 4)),
            "traj_covs": np.stack([e["covariance"] for e in self.log_trajectory])
            if self.log_trajectory else np.zeros((0, 6, 6)),
        }
        for k in self.cfg.used_types:
            for field, v in zip(voxel_map.VoxelMap._fields, self._global_map(self.maps[k])):
                arrs[f"map{int(k)}_{field}"] = v.cpu().numpy()
        kps = self._device_keypoints
        if kps is not None and all(kp is not None for kp in kps):
            for i, kp in enumerate(kps):
                for field, v in zip(Keypoints._fields, kp):
                    arrs[f"prev_keypoints{i}_{field}"] = v.cpu().numpy()
        self._rank0_writes(lambda: np.savez_compressed(path, **arrs))

    def load_checkpoint(self, path: str):
        """Restore a save_checkpoint snapshot of either package (the config
        must match the saved map and keypoint capacities). Any open stream
        segment is dropped; the overflow tracker is re-baselined and the
        submaps are stale. The previous sweep's keypoints come back when the
        file holds them (this port's); without them (the JAX package's) the
        first sweep's ego-motion registration has nothing to match, as in
        the JAX package. Under `shard_maps` each rank keeps its slab of the
        file's maps (a JAX mesh checkpoint holds them in slab order already,
        which the repack keeps)."""
        from lidarslam_tpu_torch import state as state_mod

        z = np.load(path)
        self.reset()
        self.map_origin = z["map_origin"]
        self.Tworld = z["Tworld"]
        self.PreviousTworld = z["PreviousTworld"]
        self.Trelative = z["Trelative"]
        self.kf_last_pose = z["kf_last_pose"]
        self.kf_counter = int(z["kf_counter"])
        self.covariance = z["covariance"]
        self.n_frames = int(z["n_frames"])
        self.azimuthal_resolution = float(z["azimuthal_resolution"])
        self._maps_populated = bool(z["maps_populated"])
        self.log_trajectory = [{"time": float(t), "pose": p, "covariance": c}
                               for t, p, c in zip(z["traj_times"], z["traj_poses"],
                                                  z["traj_covs"])]
        for k in self.cfg.used_types:
            m = state_mod.voxel_map_from_numpy(
                {f: z[f"map{int(k)}_{f}"] for f in voxel_map.VoxelMap._fields}, self.device)
            if m.xyz.shape[0] != self.map_cfgs[k].capacity:
                raise ValueError("checkpoint map capacity mismatch")
            self.maps[k] = m
            # re-baseline the overflow tracker: drops before the checkpoint
            # are not new
            self.map_overflow[int(k)] = int(m.overflow)
        if "prev_keypoints0_xyz" in z.files:
            kps = tuple(state_mod.keypoints_from_numpy(
                {f: z[f"prev_keypoints{i}_{f}"] for f in Keypoints._fields}, self.device)
                for i in range(3))
            if any(kp.xyz.shape[0] != self.cfg.extractor.kp_capacity(i)
                   for i, kp in enumerate(kps)):
                raise ValueError("checkpoint keypoint capacity mismatch")
            self._device_keypoints = kps
        self._reshard_maps()

    # ------------------------------------------------------------------
    # External sensor API (Slam.cxx:1584-1598); weights and the time offset
    # take effect on the next sweep
    # ------------------------------------------------------------------

    def add_wheel_odom_measurement(self, time: float, distance: float):
        self.wheel_odom.add_measurement(time, distance)

    def add_gravity_measurement(self, time: float, acceleration):
        self.imu.add_measurement(time, acceleration)

    def clear_sensor_measurements(self):
        self.wheel_odom.reset()
        self.imu.reset()

    def set_sensor_data(self, file_name: str) -> dict:
        """Clear and reload the sensor measurements from a delimited text
        file (vtkSlam::SetSensorData): columns `time`+`odom` feed wheel
        odometry, `time`+`acc_x/y/z` IMU gravity. Returns the row counts."""
        from lidarslam_tpu_torch.io.sensor_csv import load_sensor_csv

        self.clear_sensor_measurements()
        if not file_name:
            return {"odometry": 0, "imu": 0}
        return load_sensor_csv(file_name, wheel_odom=self.wheel_odom, imu=self.imu)

    def set_wheel_odom_weight(self, w: float):
        self.wheel_odom.weight = float(w)

    def set_gravity_weight(self, w: float):
        self.imu.weight = float(w)

    def set_sensor_time_offset(self, dt: float):
        self.wheel_odom.time_offset = float(dt)
        self.imu.time_offset = float(dt)

    def get_sensor_time_offset(self) -> float:
        return float(self.wheel_odom.time_offset)

    # ------------------------------------------------------------------
    # Profiling (the reference's Utils::Timer instrumentation,
    # Utilities.h:353-399, and a device trace)
    # ------------------------------------------------------------------

    def start_profiling(self, log_dir: str):
        """Start a torch.profiler trace (host ops, and the CUDA kernels and
        copies on a GPU) that `stop_profiling` writes under `log_dir`; read
        it with `utils/profiling.py`, chrome://tracing or Perfetto.

        The trace holds the per-sweep path's stage spans as host ops on
        the profiler's clock (`utils/timer.span`), nested by time:
        `slam.add_frame` over `slam.ingest` (the sweep's build and upload),
        `slam.step` (`slam.extract`, `slam.ego`, `slam.submap`, `slam.icp`
        with one `slam.icp.round` of `slam.icp.match` and `slam.icp.solve`
        per round, `slam.overlap`, `slam.map_update`; on one CUDA device,
        past the live graph's warm-up, one `slam.replay` of the captured
        step, the stage spans running only at its warm-up and capture);
        `slam.add_frame_async`
        and `slam.flush` over `slam.ingest`, `slam.dispatch` (a window's
        upload and graph replays) and `slam.step` (eager steps); and
        `slam.sync` around every host read of a device result and every
        blocking copy from pageable host memory (where the host waits on
        the device). With ego-motion registration, each sweep's device
        counts of its open rounds and live LM trips arrive as zero-length
        spans (`_note_ego`), and on a GPU the device trace holds the
        marker kernels `slam_mark_ego_begin` / `slam_mark_ego_end` at the
        ends of the stage."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = (profile(activities=acts), log_dir)
        self._profiler[0].start()

    def stop_profiling(self) -> str:
        """Wait for the enqueued work, stop the trace and write it as a
        Chrome trace under the `start_profiling` log_dir; returns its path."""
        if self._profiler is None:
            raise RuntimeError("stop_profiling without start_profiling")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        (prof, log_dir), self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"slam_{os.getpid()}_{_time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path

    def get_timing_summary(self) -> dict:
        """Host wall time per span name (`start_profiling` lists them),
        accumulated while `verbosity >= 3`: {name: {calls, total_s,
        average_ms}}."""
        return timer.summary()

    # ------------------------------------------------------------------
    # Debug surface (Slam::GetDebugInformation / GetDebugArray)
    # ------------------------------------------------------------------

    def get_registered_frame(self, frame: dict) -> np.ndarray:
        """Full sweep transformed into WORLD coordinates, undistorted by the
        last add_frame's warp (Slam::GetRegisteredFrame / AggregateFrames,
        Slam.cxx:1512-1578); the warp runs on the Slam's device."""
        pts = torch.from_numpy(np.asarray(frame["xyz"], np.float32)).to(self.device)
        if self.current_warp is not None:
            times = torch.from_numpy(np.asarray(frame["time"], np.float32)).to(self.device)
            pts = undistortion.warp_points(pts, times, self.current_warp)
        pts = pts.cpu().numpy().astype(np.float64)
        return (pts @ self.Tworld[:3, :3].T + self.Tworld[:3, 3]).astype(np.float32)

    def get_debug_array(self) -> dict:
        """Per-keypoint matching debug arrays (Slam::GetDebugArray,
        Slam.cxx:635-657): rejection cause (MatchStatus code) and fit weight
        for every keypoint of the last add_frame's localization. On a mesh
        the step has already gathered every rank's share, so every rank
        holds them all and this reads no other rank."""
        out = {}
        if self._last_statuses is None:
            return out
        for t, st, w in zip(self.cfg.used_types, self._last_statuses, self._last_weights):
            kp = self.current_keypoints.get(t)
            n = int(kp.count) if kp is not None else 0
            name = KEYPOINT_NAMES[t]
            out[f"{name}_match_status"] = st.cpu().numpy()[:n]
            out[f"{name}_match_weight"] = w.cpu().numpy()[:n]
        return out

    def extract_debug(self, frame: dict) -> dict:
        """Re-run extraction on a sweep on the Slam's device and return the
        per-point score/label grids (SpinningSensorKeypointExtractor::
        GetDebugArray parity, SSKE.cxx:640-680). On demand: not part of the
        per-frame path."""
        cfg = self.cfg
        ri = build_range_image(frame["xyz"], frame["intensity"], frame["laser_id"],
                               frame["time"], cfg.extractor.n_rings,
                               cfg.extractor.max_ring_points, device=self.device)
        az = self.azimuthal_resolution if self.azimuthal_resolution > 1e-6 \
            else float(estimate_azimuthal_resolution(ri))
        ext = extractor.extract_keypoints(ri, float(np.float32(az)), cfg.extractor,
                                          with_debug=True)
        return {k: v.cpu().numpy() for k, v in ext.debug.items()}

    def get_debug_information(self) -> dict:
        """Scalar debug metrics (Slam::GetDebugInformation, Slam.cxx:611-632).
        The map overflow counters are global totals on every rank (the step
        sums each slab's drops), so this is no collective."""
        return {
            "total_matched_keypoints": int(self.total_matched_keypoints),
            "edge_matches": int(self.match_counts[0]),
            "plane_matches": int(self.match_counts[1]),
            "blob_matches": int(self.match_counts[2]),
            "overlap": self.overlap,
            "comply_motion_limits": self.comply_motion_limits,
            "failure": self.failure,
            "map_overflow_edge": int(self.map_overflow[0]),
            "map_overflow_plane": int(self.map_overflow[1]),
            "map_overflow_blob": int(self.map_overflow[2]),
        }

    def load_numpy_state(self, state: dict):
        """Continue from another engine's state (see state.py)."""
        from lidarslam_tpu_torch import state as state_mod

        state_mod.load_numpy_state(self, state)
        if self.mesh is not None:
            self._reshard_maps()

    def _log(self, msg):
        if self.cfg.verbosity > 0:
            print(f"[lidarslam_tpu_torch] {msg}")
