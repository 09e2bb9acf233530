#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lidarslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, each printed as it goes:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile csrc/knn.cu and csrc/extract.cu with nvcc (sm_90a,
   one library) and the native host
   ingest (native/*.cpp) with g++ into lidarslam_tpu_torch/_build/ from
   this checkout; a native library that does not load fails the run;
3. kernel vs plain: the k-NN kernel against its plain PyTorch version at the
   slice's shapes — (Q=2048, k=10) edges and (Q=4096, k=5) planes — on
   three 65,536-slot maps from the 30 rendered VLP-16 sweeps: one filled to
   capacity at 0.20 m leaves (the largest a slice map can grow), one at the
   edge map's own 0.30 m leaf (its occupancy printed), and the full one
   with slots 0-2047's coordinates copied onto 4,096 slots in other
   sub-blocks and scan warps (exact ties). Each: bit-equal without
   pruning, equal wherever the plain neighbour lies within the 5 m prune
   radius, dead queries empty, the plan's work lists equal to
   `plain_work_list`. Printed:
   the beyond-radius entries that differ from the exact scan; the median
   of 20 CUDA-event timings of the wrapper, of the C launch alone on a
   prepared order, of its CUDA-graph replay, of the plain version and of
   `torch.cdist` + `topk` (the library yardstick, two calls the port never
   makes); each kernel's device time (profiler); the bound (`knn_bound`:
   9 FP32 operations per (live query, valid slot) pair whose 64-slot
   sub-block lies within the radius, at 33.5 T/s, or the bytes the
   function must move at 3.35 TB/s, whichever is larger) and the share of
   it; the scan
   work of the busiest and the mean CTA (at most 2x, or it fails). The
   edges also time the unpruned call the localization edges now make
   (wrapper, C launch, replay) on the full and slice-fill maps, against
   their bound: every live query against every valid slot at 9 operations;
   then the extraction kernel (csrc/extract.cu, `phase_extract`) on one
   rendered sweep at each of the benchmark's shapes (16 and 64 rings of
   2,048 slots) under the outdoor preset's extractor: its labels equal to
   the torch form's and its scores within 1e-5 on the card, the wrapper
   and its graph replay timed beside the torch form's labelling replayed
   as one graph, the whole stage with compaction on both, and its bound
   (`extract_bound_us` at 3.35 TB/s: 38 B a slot for all it writes, 20 B
   for what the main path reads);
4. the slice: `Slam(cfg, device="cuda").add_frame` over 30 VLP-16 sweeps at
   the bench configuration, held against the JAX package's trajectory
   (lidarslam_tpu_torch/data/vlp16_bench_ref.npz, made by
   scripts/make_torch_reference.py) and the simulator ground truth, every
   frame after the first and the live graph's warm-up steps a replay of
   its captured step (2 wrapper calls per warm-up step and the capture,
   none per replay); then a torch.profiler window over 8 more synchronous
   frames (device busy time, kernels, each k-NN kernel twice per frame and
   their device ms/frame);
5. the stream: `add_frame_async` x 30 + `flush` at `stream_window=8` on the
   same sweeps, every steady-state frame a CUDA-graph replay, held against
   the JAX package's streaming trajectory (vlp16_bench_stream_ref.npz) and
   the ground truth; ms/frame over the full windows (frames 9-24). On a
   second stream: one eager step under
   `torch.cuda.set_sync_debug_mode("error")` (no host sync), one replay
   against the eager step from the same state, and a torch.profiler window
   over one full window of replays (each of the four k-NN kernels runs
   exactly twice per frame inside the graph; their device ms/frame); the
   same stream with `compress_upload=False` (float planes in a
   FloatRecord graph) against vlp16_bench_float_stream_ref.npz, one
   replay against the eager step; then, on the native ingest, the host
   ingest per sweep (median of the 30: numpy and native window planes,
   the native per-sweep byte wire) and the bench stream with its windows
   dispatched inline (the port's dispatch) and on a worker thread (the
   JAX package's), in turns, with ms/frame and idle share beside the
   numpy run;
6. the full pipeline: `full_config()` (REFINED undistortion, ego-motion
   registration after the extrapolation, LCP overlap on 8192 samples,
   motion limits) on 30 sweeps rendered with motion distortion, through
   `add_frame` and through `add_frame_async` + `flush`, each against its
   JAX reference (vlp16_full_ref.npz, vlp16_full_stream_ref.npz): 0 failed,
   every pose within 0.01 m / 5 deg, n_matches within 1% on every frame
   with the min equal, overlap within 0.01, the same motion-limit flags
   (the error against ground truth printed beside the reference's own).
   Both paths are profiled; the stream's frame 17 runs eagerly under
   `set_sync_debug_mode("error")` with every k-NN call's inputs kept, one
   replay from the same state equals it, and a window of replays runs each
   k-NN kernel 12 times per frame (4 ego rounds x 2 types, 2 localization,
   2 overlap); the same window with registration off gives what the
   gated ego rounds add. Each call shape of that step is then checked
   against the plain version on its own inputs and timed (wrapper, C
   launch, replay, plain, `cdist` + `topk`) beside its bound;
7. the rest of the single-LiDAR configuration surface: `ext_config()`
   (full_config with blobs on a CENTER_POINT blob map, a CENTROID plane
   map, edge points decaying after 2 s, wheel odometry and IMU gravity fed
   from the drive's ground truth at 50 Hz, `sensor_measurements`) on the
   same distorted sweeps, through `add_frame` (its k-NN launches counted)
   and through the stream (every sweep carries both sensor blocks in its
   window record, replayed by a graph that holds them), against
   vlp16_ext_ref.npz / vlp16_ext_stream_ref.npz within EXT_TOL (0 failed,
   the same motion-limit flags, the edge map's decay, the first
   localization, per-type n_matches (blobs included) on every frame, and
   poses, overlap and each map's valid slots within limits set between a
   rounding witness and a faulty control, scripts/ext_witness.py: with
   blobs the trajectory amplifies rounding, and the two JAX references
   part by 1.1e-02 m). Then the stream's frame 17 by hand with its sensor
   blocks (sync-debug "error", replay == eager; dropping the blocks must
   move the step; its blob matches against the CPU's), a window of
   replays running each k-NN kernel 14 times per frame, and each call
   shape of the step (the blobs' localization query and overlap 1-NN
   included) against the plain version on its own inputs, timed beside
   its bound;
8. the multi-LiDAR rig: `rig_config()` (full_config, device 1 with its own
   copy of the extractor) on `render_rig`'s 30 acquisitions of two VLP-16s
   (device 1 at RIG_OFFSET_POSE, RIG_DT_S later, so the merge truncates
   2 x 2048 edges to 2048 slots and the time rebase moves device 1's
   keypoints) through `add_frames` and `add_frames_async` + `flush`
   against vlp16_rig_ref.npz / vlp16_rig_stream_ref.npz (0 failed, poses
   within 0.01 m / 5 deg, n_matches per type within 1%, flags equal); the
   rig graph's step under sync-debug "error" and one replay against it,
   the host syncs of one whole add_frames_async counted, a window of
   acquisitions profiled through `Slam.start_profiling` /
   `stop_profiling` and read back from the trace file (10 executions of
   each k-NN kernel per acquisition), the keypoint log's bytes, and each
   k-NN call shape of the step against the plain version;
9. the back end and the state surface: the float64 pose-graph solver on a
   1000-pose graph (`pgo_graph`: a 100 s drive at 10 Hz with GPS every
   fifth pose), the block-LDL loop and Schur over 8 segments on the card
   against the numpy oracle (within 1e-5 m), each timed (median of 5 after
   a warm-up) beside the oracle; `run_pose_graph_optimization` on phase
   6's synchronous drive with GPS from the ground truth (REFINED replay,
   the maps rebuilt on the card) against vlp16_pgo_ref.npz (poses within
   0.01 m / 5 deg, map slots within 1%, the error against the ground
   truth at most JAX's + 0.01 m), and JAX's logged poses and covariances
   through the port's solver (within 1e-5 m of JAX's result); phase 6's
   checkpoint after 15 sweeps loaded into a fresh Slam and continued
   (within 5e-3 m of the uninterrupted run); the maps through
   `save_maps_to_pcd` / `load_maps_from_pcd` (the same points); a stream
   of 20 sweeps, `execute_command(GPS_SLAM_POSE_GRAPH_OPTIMIZATION)`, and
   the next segment: its captured graph's buffers re-seeded in place from
   the rebuilt maps, one replay against the eager step, a window of 8
   replays with 0 failed;
10. the front ends, on phase 6's 30 distorted sweeps written as binary PCDs
   (`write_cli_pcds`, each file's sha256 the reference's): `cli run
   --config configs/slam_config_outdoor.yaml --pcd-dir ... --log-dir ...
   --aggregate --vtp --save-maps` and `cli run --follow`, each in its own
   process on the card (`counted_cli`: `cli.main`, what `python -m
   lidarslam_tpu_torch.cli` runs, with the k-NN counters read at its end),
   each held by `cli compare` to the JAX CLI's run on the same files
   (lidarslam_tpu_torch/data/vlp16_cli_ref.npz, 0.01 m / 5 deg, the time
   check off: the reference's times are a CPU's), 0 failed, n_matches
   within 1%, every output file parsed by the port's readers; `cli
   aggregate` on the run's log within 1e-4 m of its aggregated.pcd, point
   for point, with JAX's count; `cli extract` on the first 5 sweeps with
   JAX's edge / plane / blob counts and azimuthal resolutions (1e-6). Then,
   in this process, after direct runs on the card: the TCP server with
   client A streaming sweeps 0-14 and client B, on a new connection, 15-29
   (the stream's graph captured in A's handler thread and replayed in
   B's, `GraphSteps`), within 1e-6 m of a direct stream with the same
   flushes and 0.01 m of JAX's `--follow`, its plane map the direct
   run's, command 99 answered with an `error` on a session that goes on;
   the server in sync mode, the ROS node (PointCloud2 wire, a recording
   facade, its `Slam` built on the card from the yaml tree) and the
   ParaView core (Velodyne arrays) on 10 sweeps, each within 1e-6 m of a
   direct sync run on the sweeps it ingests. On every path the k-NN
   kernels ran once per wrapper call outside a graph plus the calls the
   graphs replayed, counted on the device;
11. the mesh (`phase_mesh`): `parallel.launch` starts a gloo group of
   MESH_GLOO_WORLD ranks sharing cuda:0 (NCCL refuses two ranks on one
   card; the collectives are host-staged, so their times are not NCCL's
   over NVLink) and then an NCCL group at min(device_count, 4) ranks, each
   rank printing its backend and device. The gloo group: the slab-sharded
   map's insert, k-NN and a migrating roll against the single-device map
   on the card (contents equal); the bench drive (MESH_FRAMES sweeps)
   through `Slam(cfg, mesh=...).add_frame` keypoint-sharded, with
   `shard_extraction` and with `shard_maps`, each 0 failed, every pose
   within 1e-3 m / 0.01 rad of phase 4's run and of
   vlp16_mesh_ref.npz (the JAX package on a 2-device CPU mesh), the ranks
   bit-equal, its k-NN wrapper calls equal to each kernel's executions
   counted on the device from 0 just before the drive, its ms/frame beside
   phase 4's; the bench stream on the mesh keypoint-sharded (30 sweeps,
   with its ms/frame), with `shard_extraction` and with `shard_maps` (their
   first window each), in eager windows of 8 (gloo stages every collective
   through the host, D10), within 1e-3 m of the mesh's sync path and of
   vlp16_mesh_stream_ref.npz (the JAX package's mesh stream on a 2-device
   CPU mesh); the full drive with `shard_maps` within 1e-3 m of phase 6's
   run and of JAX's mesh run, overlap within 0.01; 10 rig acquisitions
   through `add_frames` with `shard_maps`, 0 failed; the 1000-pose Schur
   over 8 segments sharded over the ranks within 1e-10 relative of the
   unsharded solve, both timed. The NCCL group (the card count from
   `nvidia-smi -L` printed beside it): the bench drive with `shard_maps`,
   within 1e-3 m of phase 4's configuration without `reuse_knn` (what
   `shard_maps` runs) and of JAX's mesh run; then the bench stream
   keypoint-sharded, with `shard_extraction` and with `shard_maps` through
   the captured graph (`_mesh_graph_stream`: each rank's SPMD step with its
   NCCL collectives, one replay per sweep) and, over its first window,
   eagerly on the same group: 0 failed, one replay bit-equal to the eager
   step from the same state (that step run under
   set_sync_debug_mode("error")), poses within 1e-3 m / 0.01 rad of
   vlp16_mesh_stream_ref.npz and of the eager stream, the ranks bit-equal,
   ms/frame over frames 9-24, and from the same stream's frames 25-29
   profiled on rank 0 device busy, idle share and each k-NN kernel's
   executions per replayed frame (2 keypoint-sharded and with `shard_extraction`, 6 with
   `shard_maps`, `_mesh_stream_executions`); and 10 rig acquisitions
   through `add_frames_async` with `shard_maps`, the rig's step graph
   captured on the mesh, within 1e-3 m of the eager rig stream. Every drive
   of either group records the k-NN calls of one frame, and rank 0 holds
   each call shape of its group (a rank's localization slice against the
   whole submap, the slab scans of the gathered queries, the ego
   registration, the overlap) against the plain version on the path's own
   inputs, timed beside its bound.

Phases 4-7 and 9 pin the port's host ingest to numpy (`numpy_ingest`), on
which their JAX references were made, as do phase 11's bench and full
drives; phase 5's native runs, phases 8 and 10 and phase 11's rig take the
native ingest.

Every count of k-NN kernel executions above is the kernels' own, kept on
the device (`cuda_knn.executions`) and reset just before the profiled
work; the profiler's trace, which can lose records when a frame runs tens
of thousands of small kernels, must show each k-NN kernel and never more
often than the device counted it.

The extraction kernel is held the same way on every path of phases 4-11
(`extract_counted`; in each profiled window, `_readings`): it ran on the
device once a sweep (twice an acquisition of the rig), each run either a
wrapper call made eagerly, in a warm-up or into a capture, or a graph
replaying the call its capture recorded. The counts of each path go into
the extract entry of the kernels line (`counts_by_path`).

Any failure raises and exits non-zero. Without a CUDA device, or without
the package beside this file, it exits non-zero before printing a result.
The last line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_bench_ref.npz"
STREAM_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_bench_stream_ref.npz"
FULL_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_full_ref.npz"
FULL_STREAM_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_full_stream_ref.npz"
N_FRAMES = 30
WINDOW = 8                  # bench_config's stream_window
TIMED = range(9, 25)        # the stream's full windows of replays
PROFILED = range(17, 25)    # frames of the profiled windows
# one replay against the eager step from the same state
REPLAY_TOL_M, REPLAY_TOL_DEG = 1e-5, 1e-4
PRUNE_RADIUS = 5.0
SLOW_CALL_MS = 50.0         # _median_ms times slower calls 5 times, not 20
# the card's peaks for the bound (H100 SXM data sheet): FP32 outside the
# tensor cores, 67 TFLOP/s counting an FMA as two, so 33.5 T of the
# kernel's non-FMA operations a second; HBM3 at 3.35 TB/s
FP32_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
# the k-NN's kernels (csrc/knn.cu), each launched once per wrapper call
KNN_KERNELS = ("knn_plan", "knn_prefix", "knn_scan", "knn_merge")  # cuda_knn.KERNELS
EXTRACT_KERNEL = "extract_rings"    # csrc/extract.cu's kernel, as a trace names it
# the reference CI's per-pose tolerance (io/csv_log.py) and the simulator
# ground-truth bounds of tests/test_slam_e2e.py
REF_TOL_M, REF_TOL_DEG = 0.01, 5.0
GT_TOL_M, GT_TOL_DEG = 0.07, 0.8


def bench_config(rings: int, azimuth: int):
    """The bench's headline SlamConfig of one ring count, rebuilt from the
    port's config (mirrors bench.py::bench_config with its defaults:
    per-type keypoint budgets with planes at 2x, 65,536-slot maps,
    reuse_knn on)."""
    from lidarslam_tpu_torch.config import (ExtractorConfig, MapConfig,
                                            MatchingConfig, SlamConfig)

    ring_cap = 1 << (azimuth - 1).bit_length()
    kp_cap = 2048 if rings <= 32 else 8192
    return SlamConfig(
        extractor=ExtractorConfig(n_rings=rings, max_ring_points=ring_cap,
                                  max_keypoints=kp_cap,
                                  max_plane_keypoints=2 * kp_cap),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 16),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 16),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 16),
        loc_matching=MatchingConfig(reuse_knn=True),
    )


# full_config's motion limits, [m/s, deg/s] and [m/s2, deg/s2]: finite, and
# met by the weaving-street drive (~2 m/s, yaw rate under ~11 deg/s)
FULL_VELOCITY_LIMITS = (5.0, 45.0)
FULL_ACCELERATION_LIMITS = (10.0, 90.0)


def full_config():
    """bench_config(16, 1800) with the rest of the single-LiDAR sweep
    pipeline on: REFINED undistortion (as configs/slam_config_outdoor.yaml),
    scan-to-scan ego-motion registration after the extrapolation, LCP overlap
    on 8192 samples (a quarter of the 16 x 2048 range image) and motion
    limits over a 0.5 s window."""
    import dataclasses

    from lidarslam_tpu_torch.config import (ConfidenceConfig, EgoMotionMode,
                                            UndistortionMode)

    return dataclasses.replace(
        bench_config(16, 1800), undistortion=UndistortionMode.REFINED,
        ego_motion_mode=EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION,
        confidence=ConfidenceConfig(overlap_sampling_ratio=0.25, time_window_duration=0.5,
                                    velocity_limits=FULL_VELOCITY_LIMITS,
                                    acceleration_limits=FULL_ACCELERATION_LIMITS))


# ext_config: the edge map's decay [s] and the sensors' weights (absolute
# wheel odometry and IMU gravity at tests/test_sensors.py's weights)
EXT_DECAY_S = 2.0
EXT_ODOM_WEIGHT, EXT_IMU_WEIGHT = 1.0, 0.5
SENSOR_RATE_HZ = 50.0
GRAVITY = 9.81
SENSOR_END_S = 3.1          # measurements span the 30 sweeps' stamps (0-2.9 s)


def ext_config():
    """full_config with the rest of the single-LiDAR configuration surface:
    blobs with a 0.30 m, 65,536-slot CENTER_POINT blob map, a CENTROID plane
    map, an edge map whose points decay after EXT_DECAY_S, and wheel
    odometry (absolute) and IMU gravity residuals."""
    import dataclasses

    from lidarslam_tpu_torch.config import MapConfig, SamplingMode

    cfg = full_config()
    return dataclasses.replace(
        cfg, use_blobs=True,
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 16,
                           sampling=SamplingMode.CENTER_POINT),
        plane_map=dataclasses.replace(cfg.plane_map, sampling=SamplingMode.CENTROID),
        edge_map=dataclasses.replace(cfg.edge_map, decaying_threshold=EXT_DECAY_S),
        wheel_odom_weight=EXT_ODOM_WEIGHT, imu_weight=EXT_IMU_WEIGHT)


# the rig's second VLP-16: mounted at the multi-LiDAR tests' OFFSET
# (tests/test_multilidar_streaming.py) and starting each sweep RIG_DT_S after
# device 0, so the acquisition's time rebase moves its keypoint times
RIG_OFFSET_POSE = (0.4, 0.15, 0.05, 0.0, 0.0, 0.25)
RIG_DT_S = 0.05


def rig_config():
    """full_config for a rig of two VLP-16s: device 1 has its own
    ExtractorConfig (a copy of the bench's), so it keeps the keypoint path
    in the stream even alone."""
    import dataclasses

    cfg = full_config()
    return dataclasses.replace(cfg, device_extractors=((1, dataclasses.replace(cfg.extractor)),))


def render_rig(n: int):
    """n motion-distorted acquisitions of two VLP-16s (16 rings x 1800
    firings) on the weaving street: device 0 is the bench sensor along the
    drive, device 1 is mounted at RIG_OFFSET_POSE, rendered in its own frame
    along base(t) @ offset, its sweeps starting RIG_DT_S later. Returns
    (acquisitions as lists of two frame dicts with `device_id`, the (4,4)
    offset)."""
    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.io import synthetic

    offset = se3.pose_to_hmat(list(RIG_OFFSET_POSE))
    world = synthetic.default_world(0)
    sensor = synthetic.SensorModel(n_rings=16, n_azimuth=1800)
    base = synthetic.weaving_street_trajectory()

    def mounted(t):
        return base(t) @ offset

    acquisitions = []
    for i in range(n):
        t0 = i * sensor.sweep_duration
        f0 = synthetic.render_sweep(world, sensor, base, t0, seed=i)
        f1 = synthetic.render_sweep(world, sensor, mounted, t0 + RIG_DT_S, seed=100 + i)
        f0["device_id"], f1["device_id"] = 0, 1
        acquisitions.append([f0, f1])
    return acquisitions, offset


def sensor_measurements(pose_at, t_end: float, t_start: float = -0.1):
    """Wheel-odometer and accelerometer readings at SENSOR_RATE_HZ from a
    ground-truth trajectory over [t_start, t_end]: (times, odometer [m],
    accelerations (n, 3) [m/s2]). The odometer is the path length driven
    since t = 0 (summed over 1 ms steps; negative before 0); the
    accelerometer reads gravity in the sensor frame, (0, 0, -9.81) when
    level (tests/test_sensors.py's sign)."""
    import numpy as np

    fine = 1000                                   # steps per second
    n = int(round((t_end - t_start) * fine)) + 1
    t_fine = t_start + np.arange(n) / fine
    pos = np.stack([pose_at(t)[:3, 3] for t in t_fine])
    path = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pos, axis=0), axis=1))])
    path -= path[int(round(-t_start * fine))]
    idx = np.arange(0, n, int(round(fine / SENSOR_RATE_HZ)))
    acc = np.stack([pose_at(t_fine[i])[:3, :3].T @ np.array([0.0, 0.0, -GRAVITY])
                    for i in idx])
    return t_fine[idx], path[idx], acc


def feed_sensors(slam, measurements):
    """Hand sensor_measurements' readings to a Slam (either package's)."""
    for t, d, a in zip(*measurements):
        slam.add_wheel_odom_measurement(float(t), float(d))
        slam.add_gravity_measurement(float(t), a)


def render_frames(n: int, motion_distortion: bool = False):
    """The bench's VLP-16 sequence: 16 rings x 1800 firings along the
    street-corridor trajectory (bench.py:232-239); `motion_distortion`
    renders each firing at its own time along the drive."""
    from lidarslam_tpu_torch.io import synthetic

    sensor = synthetic.SensorModel(n_rings=16, n_azimuth=1800)
    return synthetic.generate_sequence(
        n_frames=n, sensor=sensor,
        trajectory=synthetic.weaving_street_trajectory(),
        motion_distortion=motion_distortion)


def pose_errors(got, ref):
    """Translation [m] and rotation [deg] differences of two (4,4) poses."""
    import numpy as np

    dt = float(np.linalg.norm(got[:3, 3] - ref[:3, 3]))
    dR = ref[:3, :3].T @ got[:3, :3]
    ang = float(np.rad2deg(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
    return dt, ang


def phase_env():
    import torch

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_build():
    from lidarslam_tpu_torch.io import native
    from lidarslam_tpu_torch.ops import cuda_knn

    t0 = time.perf_counter()
    lib = cuda_knn.build_kernel()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native host ingest did not build or load: "
                             f"{native.last_error()}")
    print(f"[build] {Path(native._SO).name} (native host ingest, g++) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = lib.with_name(lib.name.replace(".so", ".ptxas.txt"))
    if ptxas.is_file():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas {line.strip()}", flush=True)


# seconds spent in the helpers `_timed` wraps (phase by phase): where the
# script's time goes, printed with each phase's end
SPENT = collections.defaultdict(lambda: [0.0, 0])


def _timed(fn, name=None):
    """`fn`, adding its wall seconds and calls to SPENT[name]."""
    name = name or fn.__name__

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            SPENT[name][0] += time.perf_counter() - t0
            SPENT[name][1] += 1
    return wrapped


def _spent_line() -> str:
    out = ", ".join(f"{k} {v[0]:.1f} s ({v[1]})" for k, v in
                    sorted(SPENT.items(), key=lambda kv: -kv[1][0]))
    SPENT.clear()
    return out


def _median_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of `fn` after a warm-up call;
    5 when the warm-up took over SLOW_CALL_MS (the plain scans and the
    library calls on the overlap's shapes take up to ~0.7 s each)."""
    import torch

    t0 = time.perf_counter()
    fn()  # warm
    torch.cuda.synchronize()
    if 1000 * (time.perf_counter() - t0) > SLOW_CALL_MS:
        reps = 5
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _graph_ms(fn):
    """Median of 20 CUDA-event timings of replays of one CUDA graph of `fn`:
    the device time of its launches without the host's cost of issuing
    them (as in the stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _median_ms(graph.replay)


def _kernel_split_us(fn, reps=10):
    """Device microseconds per call of each k-NN kernel over `reps` calls
    of `fn` (torch.profiler, read by utils/profiling.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidarslam_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dur = profiling.op_totals(prof)[0]
    return {name: 1000 * sum(ms for k, ms in dur.items() if name in k) / reps
            for name in KNN_KERNELS}


def kernel_test_map(frames, device, leaf: float = 0.20):
    """A 65,536-slot map filled from rendered sweeps through the port's own
    insert, so its slots are leaf-key sorted as on the path. At 0.20 m
    leaves (the edge map's are 0.30 m) 30 VLP-16 sweeps fill every slot:
    the kernel then scans a map as full as a slice map can get."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch.config import MapConfig
    from lidarslam_tpu_torch.ops import voxel_map

    cfg = MapConfig(leaf_size=leaf, capacity=1 << 16)
    m = voxel_map.VoxelMap.empty(cfg, device)
    origin = frames[0]["gt_pose"][:3, 3]
    for f in frames:
        R, t = f["gt_pose"][:3, :3], f["gt_pose"][:3, 3] - origin
        w = (f["xyz"].astype(np.float64) @ R.T + t).astype(np.float32)
        m = voxel_map.add_points(
            m, torch.from_numpy(w).to(device),
            torch.from_numpy(f["intensity"]).to(device),
            torch.zeros(len(w), device=device),
            torch.ones(len(w), dtype=torch.bool, device=device), 0.0, cfg)
    return m, origin


def tie_map(xyz):
    """The full map's coordinates with those of slots 0-2047 copied onto
    slots 20,000 and 45,000 on: each copy lies in another sub-block, far
    apart in the scan order (so in another scan warp), at exactly the same
    distance from every query."""
    x = xyz.clone()
    for off in (20_000, 45_000):
        x[off:off + 2048] = xyz[:2048]
    return x


def _queries(world, Q, rng, device, on=None):
    """Q noisy queries off one sweep, ~75% live; `on`: (n, 3) points the
    first n queries sit on exactly."""
    import numpy as np
    import torch

    pick = rng.choice(len(world), Q, replace=False)
    q = world[pick] + rng.normal(0, 0.05, (Q, 3)).astype(np.float32)
    if on is not None:
        q[:len(on)] = on
    q_valid = rng.uniform(size=Q) < 0.75
    return torch.from_numpy(q).to(device), torch.from_numpy(q_valid).to(device)


def _work_list_ok(run, want):
    """The kernel's work lists (rows of run.work, run.count long) hold
    exactly want's sub-blocks, in ascending order."""
    import torch

    n = run.count.long()
    used = torch.arange(run.work.shape[1], device=n.device)[None, :] < n[:, None]
    got = torch.zeros_like(want)
    rows = torch.arange(run.work.shape[0], device=n.device)[:, None].expand_as(used)
    got[rows[used], run.work.long()[used]] = True
    ascending = ((run.work[:, 1:] > run.work[:, :-1]) | ~used[:, 1:]).all()
    return (torch.equal(n, want.sum(1)) and torch.equal(got, want) and bool(ascending)
            and int(run.start[-1]) == int(n.sum()))


def bound_pairs(index, queries, q_valid, radius: float) -> int:
    """The (live query, valid slot) pairs an exact scan must evaluate when
    it prunes per query at the kernel's own granularity: those whose 64-slot
    sub-block box (index.sub_lo/sub_hi) lies within `radius` of the query.
    The bound counts 9 FP32 operations for each (3 subtracts, 3 multiplies,
    2 adds, 1 compare)."""
    import torch

    n_valid = index.pts[:, 0].isfinite().reshape(index.n_sub, -1).sum(1)
    q = queries[q_valid][:, None, :]
    g = torch.clamp(torch.maximum(index.sub_lo[None, :, :3] - q,
                                  q - index.sub_hi[None, :, :3]), min=0.0)
    box = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
    return int(((box <= radius * radius) * n_valid).sum())


def knn_bound(index, q, q_valid, k: int, radius) -> dict:
    """The least time the card could take for one k-NN call (radius None:
    every live query against every valid slot), the larger of
    - operations: bound_pairs' pairs x 9 FP32 operations over FP32_OPS_PER_S;
    - bytes: what the function must read and write once over HBM_BYTES_PER_S:
      the x, y, z of each valid slot and of each live query (12 B), one bit
      per slot and per query for validity, and the outputs (d2, slot and
      x, y, z: 20 B per (query, rank)). The index's +inf padding slots and
      its sub-block boxes are the kernel's layout, not the function's input.
    Returns us, pairs, bytes, the us of each side and which side sets it."""
    pairs = bound_pairs(index, q, q_valid, float("inf") if radius is None else radius)
    n_slots, n_queries = index.pts.shape[0], q.shape[0]
    n_valid = int(index.pts[:, 0].isfinite().sum())
    nbytes = (12 * (n_valid + int(q_valid.sum())) + -(-(n_slots + n_queries) // 8)
              + 20 * n_queries * k)
    ops_us = 1e6 * 9 * pairs / FP32_OPS_PER_S
    bytes_us = 1e6 * nbytes / HBM_BYTES_PER_S
    return {"us": max(ops_us, bytes_us), "pairs": pairs, "bytes": nbytes, "ops_us": ops_us,
            "bytes_us": bytes_us, "by": "operations" if ops_us >= bytes_us else "bytes"}


def _timings(index, q, q_valid, k: int, radius, plain_map=None) -> dict:
    """Medians of 20 CUDA-event timings (ms) of one k-NN call: the wrapper
    (kernel_knn), the C launch alone on the order kernel_knn would give the
    queries, and that launch's CUDA-graph replay; with `plain_map` (xyz,
    valid) also plain_knn and torch.cdist + topk (two calls the port never
    makes) on the same inputs."""
    import torch

    from lidarslam_tpu_torch.ops import cuda_knn

    r2 = float("inf") if radius is None else float(radius) ** 2
    order = cuda_knn.spatial_order(q, 1.0 if radius is None else max(radius, 1e-3), q_valid)

    def call():
        return cuda_knn.launch(index, q, q_valid, order, k, r2)

    out = {"ms": _median_ms(lambda: cuda_knn.kernel_knn(index, q, k, radius, q_valid)),
           "launch_ms": _median_ms(call), "device_ms": _graph_ms(call)}
    if plain_map is not None:
        xyz, valid = plain_map
        pts = index.pts[:, :3].contiguous()
        out["plain_ms"] = _median_ms(lambda: cuda_knn.plain_knn(xyz, valid, q, k,
                                                                q_valid=q_valid))
        out["library_ms"] = _median_ms(lambda: torch.topk(
            torch.cdist(q, pts, compute_mode="donot_use_mm_for_euclid_dist"), k,
            largest=False))
    return out


def _unpruned_timing(label, index, q, q_valid, k, card):
    """Wrapper, C launch and CUDA-graph replay of the call without a prune
    radius (as the localization edges now run), with its bound."""
    t = _timings(index, q, q_valid, k, None)
    b = knn_bound(index, q, q_valid, k, None)
    print(f"[kernel] {label} unpruned: wrapper {t['ms']:.4f} ms, C launch "
          f"{t['launch_ms']:.4f} ms, graph replay {t['device_ms']:.4f} ms; bound {b['pairs']} "
          f"pairs x 9 ops = {b['ops_us']:.2f} us (bytes {b['bytes']} = {b['bytes_us']:.2f} "
          f"us), replay at {100 * b['us'] / (1000 * t['device_ms']):.1f}% of it ({card})",
          flush=True)
    return {**t, "bound_us": b["us"]}


def _kernel_case(label, m, index, q, q_valid, k, card):
    """One (map, shape): the kernel against plain_knn and its plan against
    plain_work_list, the bound, the scan's work per CTA and the timings.
    Returns its record."""
    import torch

    from lidarslam_tpu_torch.ops import cuda_knn

    r2 = PRUNE_RADIUS ** 2
    # no pruning: bit-equal to the plain version
    kd, ki, kn = cuda_knn.kernel_knn(index, q, k, None, q_valid)
    pd, pi, pn = cuda_knn.plain_knn(m.xyz, m.valid, q, k, q_valid=q_valid)
    torch.cuda.synchronize()
    if not (torch.equal(kd, pd) and torch.equal(ki, pi) and torch.equal(kn, pn)):
        bad = int(((kd != pd) | (ki != pi)).any(dim=1).sum())
        raise AssertionError(f"{label}: kernel != plain without pruning ({bad} rows)")
    dead = ~q_valid
    if not (torch.isinf(kd[dead]).all() and (ki[dead] == 0).all()
            and (kn[dead] == 0).all()):
        raise AssertionError(f"{label}: dead queries returned neighbours")

    # with the matcher's prune radius: nothing within the radius is lost
    rd, ri_, rn = cuda_knn.kernel_knn(index, q, k, PRUNE_RADIUS, q_valid)
    torch.cuda.synchronize()
    inside = torch.isfinite(pd) & (pd <= r2)
    if not (torch.equal(rd[inside], pd[inside]) and torch.equal(ri_[inside], pi[inside])
            and torch.equal(rn[inside], pn[inside])):
        raise AssertionError(f"{label}: pruning lost a neighbour within the radius")
    fin = torch.isfinite(rd)
    if not bool(m.valid[ri_[fin].long()].all()):
        raise AssertionError(f"{label}: pruned kernel returned an invalid slot")
    if not (torch.isinf(rd[dead]).all() and (ri_[dead] == 0).all()):
        raise AssertionError(f"{label}: pruned kernel returned neighbours for dead queries")
    beyond = int((((rd != pd) | (ri_ != pi)) & ~inside & q_valid[:, None]).sum())
    err = float(torch.where(inside, (rd - pd).abs(), 0.0).max())

    # the plan against its plain version; the scan's work per CTA
    order = cuda_knn.spatial_order(q, PRUNE_RADIUS, q_valid)
    run = cuda_knn.launch(index, q, q_valid, order, k, r2)
    want = cuda_knn.plain_work_list(index, q, q_valid, order, r2)
    torch.cuda.synchronize()
    if not _work_list_ok(run, want):
        raise AssertionError(f"{label}: the plan's work lists != plain_work_list")
    if not (torch.equal(run.d2, rd) and torch.equal(run.idx, ri_)):
        raise AssertionError(f"{label}: launch on a prepared order != kernel_knn")
    given, scanned = run.stats[:, 0].float(), run.stats[:, 1].float()

    # the bound: 9 FP32 operations per pair that per-query sub-block pruning keeps
    b = knn_bound(index, q, q_valid, k, PRUNE_RADIUS)
    t = _timings(index, q, q_valid, k, PRUNE_RADIUS, plain_map=(m.xyz, m.valid))
    split = _kernel_split_us(lambda: cuda_knn.launch(index, q, q_valid, order, k, r2))
    n_live = int(q_valid.sum())
    print(f"[kernel] {label} Q={len(q)} k={k}: exact without pruning; "
          f"{int(inside.sum())} within-radius neighbours kept; {n_live} live "
          f"queries; {beyond} of {n_live * k} live (query, rank) entries beyond the "
          f"radius differ from the exact scan", flush=True)
    print(f"[kernel] {label}: wrapper {t['ms']:.4f} ms, C launch on a prepared order "
          f"{t['launch_ms']:.4f} ms, its graph replay {t['device_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, library cdist+topk (two calls) {t['library_ms']:.4f} ms "
          f"(median of 20; {card})", flush=True)
    print(f"[kernel] {label}: device us per call by kernel (profiler, 10 calls): "
          + ", ".join(f"{n} {us:.1f}" for n, us in split.items()), flush=True)
    print(f"[kernel] {label}: bound {b['pairs']} pairs x 9 ops = {b['ops_us']:.2f} us "
          f"(bytes {b['bytes']} = {b['bytes_us']:.2f} us); graph replay at "
          f"{100 * b['us'] / (1000 * t['device_ms']):.1f}% of it, C launch at "
          f"{100 * b['us'] / (1000 * t['launch_ms']):.1f}%, wrapper at "
          f"{100 * b['us'] / (1000 * t['ms']):.1f}%", flush=True)
    print(f"[kernel] {label}: {int(run.start[-1])} (tile, sub-block) entries over "
          f"{len(given)} scan CTAs: given busiest {int(given.max())} / mean "
          f"{float(given.mean()):.2f}, scanned busiest {int(scanned.max())} / mean "
          f"{float(scanned.mean()):.2f}", flush=True)
    if float(given.max()) > 2 * float(given.mean()):
        raise AssertionError(f"{label}: busiest scan CTA above 2x the mean work")
    return {"err": err, **t, "bound_us": b["us"], "beyond": beyond}


def phase_kernel(frames, card: str):
    """Kernel vs plain at the slice's shapes on three maps. Returns the
    full map's record (edges + planes) and the largest error."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch.ops import cuda_knn

    dev = torch.device("cuda")
    full, origin = kernel_test_map(frames, dev)
    fill, _ = kernel_test_map(frames, dev, leaf=0.30)
    ties = full._replace(xyz=tie_map(full.xyz))
    f = frames[8]
    R, t = f["gt_pose"][:3, :3], f["gt_pose"][:3, 3] - origin
    world = (f["xyz"].astype(np.float64) @ R.T + t).astype(np.float32)

    recs, max_err = {}, 0.0
    for label, m, seed in (("full", full, 0), ("slice-fill", fill, 1), ("ties", ties, 2)):
        n_valid = int(m.valid.sum())
        print(f"[kernel] {label} map from {len(frames)} sweeps: {m.xyz.shape[0]} slots, "
              f"{n_valid} valid ({100 * n_valid / m.xyz.shape[0]:.1f}%), "
              f"{int(m.overflow)} leaves dropped at capacity", flush=True)
        if label == "full" and n_valid != m.xyz.shape[0]:
            raise AssertionError("the kernel's full test map is not full")
        index = cuda_knn.prepare_map(m.xyz, m.valid)
        rng = np.random.default_rng(seed)
        on = m.xyz[:2048:4].cpu().numpy() if label == "ties" else None
        for name, Q, k in (("edges", 2048, 10), ("planes", 4096, 5)):
            q, q_valid = _queries(world, Q, rng, dev, on)
            rec = _kernel_case(f"{label} {name}", m, index, q, q_valid, k, card)
            if name == "edges" and label != "ties":
                # the localization edges scan unpruned on the path
                rec["unpruned"] = _unpruned_timing(f"{label} {name}", index, q, q_valid,
                                                   k, card)
            recs[(label, name)] = rec
            max_err = max(max_err, rec["err"])
    both = {key: recs[("full", "edges")][key] + recs[("full", "planes")][key]
            for key in ("ms", "launch_ms", "device_ms", "plain_ms", "library_ms",
                        "bound_us")}
    fill_ms = recs[("slice-fill", "edges")]["ms"] + recs[("slice-fill", "planes")]["ms"]
    print(f"[kernel] full map, edges + planes: wrapper {both['ms']:.4f} ms, C launch "
          f"{both['launch_ms']:.4f} ms, graph replay {both['device_ms']:.4f} ms, bound "
          f"{both['bound_us']:.2f} us; slice-fill map: wrapper {fill_ms:.4f} ms ({card})",
          flush=True)
    unpruned = {label: recs[(label, "edges")]["unpruned"] for label in ("full", "slice-fill")}
    return {"max_abs_err": max_err, **both, "slice_fill_ms": fill_ms,
            "edges_unpruned": unpruned}


EXTRACT_SHAPES = ((16, 1800), (64, 2048))  # the benchmark's sweeps: rings, firings
# the JAX extractor's keypoint sets on `extract_drive` (scripts/make_torch_reference.py
# --which extract), which tests/test_torch_cuda.py holds the card's extraction to
EXTRACT_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "extract_ref.npz"
EXTRACT_SWEEPS = 3
EXTRACT_AZ = 2 * math.pi / 2048     # rounded to float32 where used


def extract_drive(synthetic, rings: int):
    """The sweeps of EXTRACT_REF_PATH at `rings` x 2,048 firings, from
    either package's `io.synthetic` (they render the same points)."""
    return synthetic.generate_sequence(
        n_frames=EXTRACT_SWEEPS, seed=5, motion_distortion=False,
        sensor=synthetic.SensorModel(n_rings=rings, n_azimuth=2048, range_noise=0.005))


def sweep_sha256(f) -> str:
    """The sha256 of a sweep's point arrays."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for key in ("xyz", "intensity", "laser_id", "time"):
        h.update(np.ascontiguousarray(f[key]).tobytes())
    return h.hexdigest()


def extract_bound_us(rings: int, slots: int, debug: bool = True) -> float:
    """The extraction kernel's bound at 3.35 TB/s: xyz, intensity and
    validity in (17 B a slot), and out either all it writes, five label
    grids and four score grids (21 B), or with `debug` False the three
    label grids that the main path's compaction reads (3 B; the validity
    and score grids serve only `with_debug`)."""
    return rings * slots * (17 + (21 if debug else 3)) / 3.35e12 * 1e6


def phase_extract(card: str):
    """The extraction kernel (csrc/extract.cu) alone at the benchmark's two
    sweep shapes, on one rendered sweep each under the outdoor preset's
    extractor at 2,048 slots a ring: its labels and scores against the
    torch form's on the card, then the median of 20 CUDA-event timings of
    the wrapper and of its graph replay, beside the torch form's labelling
    replayed as one CUDA graph, the whole stage (labelling and compaction)
    replayed on both, and the bound. The kernel replaces no TPU kernel: it
    replaces the XLA-fused jnp stencils of lidarslam_tpu/ops/extractor.py."""
    import dataclasses

    import numpy as np
    import torch

    from lidarslam_tpu_torch.io import synthetic
    from lidarslam_tpu_torch.io.yaml_config import load_config
    from lidarslam_tpu_torch.ops import cuda_extract, extractor
    from lidarslam_tpu_torch.ops.frame import build_range_image

    dev = torch.device("cuda")
    preset = load_config(ROOT / "configs" / "slam_config_outdoor.yaml").extractor
    shapes = []
    for rings, firings in EXTRACT_SHAPES:
        cfg = dataclasses.replace(preset, n_rings=rings, max_ring_points=2048)
        f = synthetic.generate_sequence(
            n_frames=1, seed=11, motion_distortion=False,
            sensor=synthetic.SensorModel(n_rings=rings, n_azimuth=firings,
                                         range_noise=0.01))[0]
        ri = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                               rings, 2048, device=dev)
        az = torch.full((), float(np.float32(2 * np.pi / firings)), device=dev)
        labels, scores = cuda_extract.launch(ri, az, cfg)
        want = extractor.label_grids(ri, az, cfg)
        _require(all(torch.equal(a, b) for a, b in zip(labels, want[:5])),
                 f"[extract] {rings} x 2048: the kernel's labels differ from the torch form's")
        err = float((scores - torch.stack(want[5:])).abs().max())
        _require(err <= 1e-5, f"[extract] {rings} x 2048: scores differ by {err}")
        ms = _median_ms(lambda: cuda_extract.launch(ri, az, cfg))
        replay_ms = _graph_ms(lambda: cuda_extract.launch(ri, az, cfg))
        torch_ms = _graph_ms(lambda: extractor.label_grids(ri, az, cfg))
        stage_ms = _graph_ms(lambda: extractor.extract_keypoints(ri, az, cfg))
        torch_stage_ms = _graph_ms(lambda: extractor._result(
            ri, extractor.label_grids(ri, az, cfg), cfg, False))
        bound_us = extract_bound_us(rings, 2048)
        main_bound_us = extract_bound_us(rings, 2048, debug=False)
        rec = {"shape": f"{rings}x2048", "valid": int(ri.valid.sum()),
               "labels": [int(x.sum()) for x in labels[:3]], "max_abs_err": err,
               "ms": ms, "replay_ms": replay_ms, "torch_replay_ms": torch_ms,
               "stage_replay_ms": stage_ms, "torch_stage_replay_ms": torch_stage_ms,
               "bound_us": bound_us, "main_path_bound_us": main_bound_us}
        print(f"[extract] {rings} x 2048 ({rec['valid']} valid, edges / planes / blobs "
              f"{rec['labels']}): labels equal, scores within {err:.2e}; kernel: wrapper "
              f"{ms:.4f} ms, graph replay {replay_ms:.4f} ms; torch form replayed "
              f"{torch_ms:.4f} ms; the stage with compaction replayed {stage_ms:.4f} ms "
              f"(torch form {torch_stage_ms:.4f} ms); bound {bound_us:.2f} us for all it "
              f"writes ({100 * bound_us / 1000 / replay_ms:.2f}% of it), {main_bound_us:.2f} us "
              f"for what the main path reads ({100 * main_bound_us / 1000 / replay_ms:.2f}%) "
              f"({card})", flush=True)
        shapes.append(rec)
    return {"shapes": shapes, "max_abs_err": max(r["max_abs_err"] for r in shapes)}


def _require(ok, msg):
    """Fail the phase with `msg` unless `ok`."""
    if not ok:
        raise AssertionError(msg)


def _check_trajectory(tag, frames, results, ref, gate_gt=True, tol_m=REF_TOL_M):
    """Poses against a JAX reference trajectory (within `tol_m` and
    REF_TOL_DEG) and the ground truth (`gate_gt`: within GT_TOL); no failed
    frame. Returns the worst (m, deg) of each."""
    import numpy as np

    from lidarslam_tpu_torch.core import se3

    _require(len(results) == len(frames) == ref["poses"].shape[0],
             f"[{tag}] {len(results)} results, {ref['poses'].shape[0]} reference poses "
             f"for {len(frames)} frames")
    gt0 = frames[0]["gt_pose"]
    worst_ref, worst_gt = (0.0, 0.0), (0.0, 0.0)
    for i, (f, r) in enumerate(zip(frames, results)):
        pose = r["pose"]
        _require(np.isfinite(pose).all(), f"[{tag}] frame {i}: non-finite pose")
        e_ref = pose_errors(pose, ref["poses"][i])
        e_gt = pose_errors(pose, se3.hmat_inverse(gt0) @ f["gt_pose"])
        worst_ref = tuple(max(a, b) for a, b in zip(worst_ref, e_ref))
        worst_gt = tuple(max(a, b) for a, b in zip(worst_gt, e_gt))
        _require(e_ref[0] <= tol_m and e_ref[1] <= REF_TOL_DEG,
                 f"[{tag}] frame {i}: {e_ref} from the JAX reference")
        _require(not gate_gt or (e_gt[0] <= GT_TOL_M and e_gt[1] <= GT_TOL_DEG),
                 f"[{tag}] frame {i}: {e_gt} from ground truth")
    n_failed = sum(bool(r["failure"]) for r in results)
    _require(n_failed == 0, f"[{tag}] {n_failed} failed frames")
    return worst_ref, worst_gt


def _profile(fn, n_frames: int, sweeps_per_frame: int = 1):
    """torch.profiler over `fn` (which ends in a device sync): the
    `_readings` of its device work, whose `n_frames` frames of
    `sweeps_per_frame` sweeps each ran the extraction kernel once a sweep.
    Device activity only: the host ops' events would double the profiler's
    own time and no reading uses them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidarslam_tpu_torch.ops import cuda_extract, cuda_knn

    torch.cuda.synchronize()
    cuda_knn.reset_executions()
    extracted = cuda_extract.executions()   # read, not reset: `extract_counted` may hold it
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _readings(prof, n_frames, cuda_knn.executions(),
                     cuda_extract.executions() - extracted, n_frames * sweeps_per_frame)


def _readings(source, n_frames: int, executed: dict, extracted: int, sweeps: int):
    """From a torch.profiler profile or its Chrome trace (utils/profiling.py)
    and the k-NN and extraction kernels' device execution counts over the
    same work (`cuda_knn.executions`, `cuda_extract.executions`), in which
    the extraction kernel ran once in each of `sweeps` sweeps: device busy
    ms/frame, device kernels/frame (copies and memsets excluded),
    executions of each k-NN kernel as the kernels counted them (`knn`) and
    as the trace recorded them (`knn_traced`), the same of the extraction
    kernel (`extract`, `extract_traced`), and the k-NN kernels' device
    ms/frame (every device kernel named knn_*). A trace can lose records
    when the device runs tens of thousands of small kernels a frame, so the
    exact counts come from the device; the trace must still show each
    kernel, and never more often than it ran."""
    from lidarslam_tpu_torch.utils import profiling

    _, cnt, cat = profiling.op_totals(source)
    busy_ms = profiling.device_busy_ms(source)
    kernels = sum(n for name, n in cnt.items()
                  if profiling.category(name) not in ("memcpy", "memset"))
    if busy_ms <= 0 or kernels == 0:
        raise AssertionError("torch.profiler saw no device time")
    traced = {k: sum(n for name, n in cnt.items() if k in name) for k in KNN_KERNELS}
    _require(all(0 < traced[k] <= executed[k] for k in KNN_KERNELS),
             f"the trace's k-NN kernel executions {traced} are not within the "
             f"device's counts {executed}")
    extract_traced = sum(n for name, n in cnt.items() if EXTRACT_KERNEL in name)
    _require(extracted == sweeps and 0 < extract_traced <= extracted,
             f"the extraction kernel ran {extracted} times on the device ({extract_traced} "
             f"traced) in {sweeps} sweeps")
    return {"busy_ms": busy_ms / n_frames, "kernels": kernels / n_frames,
            "knn": dict(executed), "knn_traced": traced,
            "extract": extracted, "extract_traced": extract_traced,
            "knn_ms": cat["knn"] / n_frames}


def _stream_run_ms(slam, items, enqueue=None, worker=False, tail=None):
    """Enqueue `items` in order through `enqueue` (by default
    `slam.add_frame_async`; a rig's acquisitions go through
    `slam.add_frames_async`), each as its own index, time items TIMED
    between two device syncs, and flush: (ms per item over TIMED, as PERF.md
    section 2 defines it, and the flush's results). With `worker`, the
    timed full windows are stacked, uploaded and replayed on one worker
    thread while this one builds the next sweeps, as the JAX package's
    window worker does; the port dispatches inline (ROADMAP Queue 3, D5).
    With `tail`, the items after TIMED are enqueued and their window
    replayed inside `tail(fn)` (a profiler window), before the flush."""
    import torch

    enqueue = enqueue or slam.add_frame_async
    pool = ThreadPoolExecutor(max_workers=1) if worker else None
    futures = []

    def on_worker():
        buf, slam._window_buf = slam._window_buf, []
        futures.append(pool.submit(slam._run_window, buf))

    def settle():           # the worker's windows, then the device
        while futures:
            futures.pop(0).result()
        if slam.device.type == "cuda":
            torch.cuda.synchronize()

    t0 = t1 = 0.0
    rest = TIMED.stop if tail is not None else len(items)
    try:
        for i, item in enumerate(items[:rest]):
            if i == TIMED.start:
                settle()
                if worker:
                    slam._dispatch_window = on_worker
                t0 = time.perf_counter()
            _require(enqueue(item) == i, f"item {i} was not enqueued as {i}")
            if i == TIMED.stop - 1:
                settle()
                t1 = time.perf_counter()
                slam.__dict__.pop("_dispatch_window", None)
    finally:
        if pool is not None:
            pool.shutdown()
    if tail is not None:
        def run_rest():
            for i in range(rest, len(items)):
                _require(enqueue(items[i]) == i, f"item {i} was not enqueued as {i}")
            slam._drain_window()
            torch.cuda.synchronize()
        tail(run_rest)
    return 1000 * (t1 - t0) / len(TIMED), slam.flush()


def _check_knn_executions(tag, prof, n_frames):
    """Each k-NN kernel ran twice per frame (edges and planes)."""
    if any(n != 2 * n_frames for n in prof["knn"].values()):
        raise AssertionError(f"[{tag}] k-NN kernel executions {prof['knn']} in "
                             f"{n_frames} frames (expected {2 * n_frames} each)")


def phase_slice(frames):
    """30 VLP-16 sweeps through Slam.add_frame on the card."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.ops import cuda_knn, stream_graph

    ref = np.load(REF_PATH)
    if ref["poses"].shape[0] != len(frames):
        raise AssertionError(f"{REF_PATH.name} holds {ref['poses'].shape[0]} poses, "
                             f"not {len(frames)}")
    slam = Slam(bench_config(16, 1800), device="cuda")
    cuda_knn.LAUNCHES = 0
    results, wall = [], []
    with extract_counted("bench sync", len(frames)) as extracted:
        for f in frames:
            t0 = time.perf_counter()
            results.append(slam.add_frame(f))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
    launches = cuda_knn.LAUNCHES

    worst_ref, worst_gt = _check_trajectory("slice", frames, results, ref)
    # the first frame only seeds the maps; the live graph's warm-up steps
    # and its capture call the wrapper (2 calls each), its replays do not
    eager = 1 + stream_graph.WARMUP_STEPS
    if launches != 2 * eager or slam.live_replays != len(frames) - eager:
        raise AssertionError(f"{launches} kernel launches and {slam.live_replays} replays "
                             f"in {len(frames)} frames (expected {2 * eager} and "
                             f"{len(frames) - eager})")
    n_matches = [r["n_matches"] for r in results[1:]]
    ref_matches = [int(v) for v in ref["n_matches"][1:len(frames)]]
    ms_frame = 1000 * statistics.median(wall[1:])
    print(f"[slice] {len(frames)} frames, 0 failed, {launches} kernel "
          f"launches; median {ms_frame:.2f} ms/frame "
          f"(first frame {1000 * wall[0]:.1f} ms); extraction kernel "
          f"{_extract_line(extracted)}", flush=True)
    print(f"[slice] min n_matches {min(n_matches)} (JAX reference {min(ref_matches)}); "
          f"max pose divergence from the reference {worst_ref[0]:.3e} m / "
          f"{worst_ref[1]:.3e} deg; from ground truth {worst_gt[0]:.3e} m / "
          f"{worst_gt[1]:.3e} deg", flush=True)
    for k, m in slam.maps.items():
        n_valid = int(m.valid.sum())
        print(f"[slice] {k.name} map at frame {len(frames)}: {n_valid} of "
              f"{m.xyz.shape[0]} slots valid ({100 * n_valid / m.xyz.shape[0]:.1f}%), "
              f"overflow {int(slam.map_overflow[int(k)])}", flush=True)

    # profiled: frames 17-24 of a second run, after 17 unprofiled ones,
    # each a replay of the live graph (every ICP round runs, gated)
    slam = Slam(bench_config(16, 1800), device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame(f)
    prof = _profile(lambda: [slam.add_frame(frames[i]) for i in PROFILED], len(PROFILED))
    _check_knn_executions("slice", prof, len(PROFILED))
    print(f"[slice] profiled frames {PROFILED.start}-{PROFILED.stop - 1}: device busy "
          f"{prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} device kernels/frame; "
          f"k-NN kernels "
          f"{prof['knn_ms']:.4f} ms/frame ({100 * prof['knn_ms'] / prof['busy_ms']:.2f}% "
          f"of device busy), executions {prof['knn']} (device counts; traced"
          f" {prof['knn_traced']}); extraction kernel executions {prof['extract']} (traced "
          f"{prof['extract_traced']})", flush=True)
    return {"launches": launches, "ms_frame": ms_frame, "results": results, **prof}


def phase_stream(frames, card: str, sync: dict):
    """30 VLP-16 sweeps through Slam.add_frame_async + flush on the card:
    CUDA-graph replays, checked against the JAX streaming trajectory; then
    the sync-free, replay-equals-eager and kernel-in-graph checks."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.ops import cuda_knn, pipeline
    from lidarslam_tpu_torch.ops.frame import build_range_image, flatten_packed
    from lidarslam_tpu_torch.ops.stream_graph import clone_tree

    ref = np.load(STREAM_REF_PATH)
    cfg = bench_config(16, 1800)
    if cfg.stream_window != WINDOW or not cfg.flat_wire:
        raise AssertionError("bench_config no longer streams 8-sweep flat-wire windows")

    slam = Slam(cfg, device="cuda")
    cuda_knn.LAUNCHES = 0
    t_all = time.perf_counter()
    with extract_counted("bench stream", len(frames)) as extracted:
        ms_frame, results = _stream_run_ms(slam, frames)
    wall_all = time.perf_counter() - t_all
    calls = cuda_knn.LAUNCHES
    if slam._graph is None or slam._graph.graph is None:
        raise AssertionError("the stream never captured its CUDA graph")
    # the wrapper runs once per type in each warm-up step and in the
    # capture; replays launch the captured kernel without it
    if calls != 2 * (slam._graph.warmup_steps + 1):
        raise AssertionError(f"[stream] {calls} k-NN wrapper calls for "
                             f"{slam._graph.warmup_steps} warm-up steps and 1 capture")
    worst_ref, worst_gt = _check_trajectory("stream", frames, results, ref)
    n_matches = [r["n_matches"] for r in results[1:]]
    ref_matches = [int(v) for v in ref["n_matches"][1:]]
    bad = [i for i, (a, b) in enumerate(zip(n_matches, ref_matches), 1)
           if abs(a - b) > 0.01 * b]
    if bad:
        raise AssertionError(f"[stream] n_matches off the JAX reference by > 1% "
                             f"at frames {bad}")
    print(f"[stream] {len(frames)} frames, 0 failed, {calls} Python k-NN calls "
          f"(first frame, {slam._graph.warmup_steps} warm-up steps, 1 capture); "
          f"{ms_frame:.2f} ms/frame over frames {TIMED.start}-{TIMED.stop - 1} "
          f"(enqueue + device sync); all 30 frames + flush {1000 * wall_all:.1f} ms; "
          f"extraction kernel {_extract_line(extracted)}", flush=True)
    print(f"[stream] min n_matches {min(n_matches)} (JAX reference {min(ref_matches)}); "
          f"max pose divergence from the JAX streaming reference {worst_ref[0]:.3e} m / "
          f"{worst_ref[1]:.3e} deg; from ground truth {worst_gt[0]:.3e} m / "
          f"{worst_gt[1]:.3e} deg", flush=True)

    # second stream: frames 0-16 through the API, then frame 17 by hand
    slam = Slam(cfg, device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame_async(f)
    g = slam._graph
    f = frames[PROFILED.start]
    host = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                             cfg.extractor.n_rings, cfg.extractor.max_ring_points,
                             packed=True, device=False)
    record = g.wire.pack([flatten_packed(host, g.wire.capacity)],
                         [np.float32(f["stamp"])]).to("cuda")[0]
    flat, stamp, _ = g.wire.unpack(record)
    before = clone_tree(g.state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, packed_eager, _ = pipeline.process_frame_stream(
            flat, before, stamp, g.az, cfg, slam._map_cfgs_tuple, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g.record.copy_(record)
    g.graph.replay()
    packed_graph = g._outputs[0].clone()
    e, r = packed_eager.cpu().numpy(), packed_graph.cpu().numpy()
    ue = pipeline.unpack_scalars(e[:pipeline.PACKED_LEN])
    ur = pipeline.unpack_scalars(r[:pipeline.PACKED_LEN])
    dt, dr = pose_errors(se3.pose_to_hmat(ur["pose"]), se3.pose_to_hmat(ue["pose"]))
    if dt > REPLAY_TOL_M or dr > REPLAY_TOL_DEG or ue["total"] != ur["total"] \
            or (ue["counts"] != ur["counts"]).any():
        raise AssertionError(f"[stream] replay != eager step: {dt} m, {dr} deg, "
                             f"matches {ur['total']} vs {ue['total']}")
    print(f"[stream] eager step under set_sync_debug_mode('error'): no sync; "
          f"replay vs eager from the same state: {dt:.3e} m / {dr:.3e} deg, "
          f"matches {ur['total']} == {ue['total']}", flush=True)

    # frames 18-25 (one full window of replays), profiled
    window = range(PROFILED.start + 1, PROFILED.start + 1 + WINDOW)
    prof = _profile(lambda: [slam.add_frame_async(frames[i]) for i in window], WINDOW)
    _check_knn_executions("stream", prof, WINDOW)
    print(f"[stream] profiled window of {WINDOW} replays (frames {window.start}-"
          f"{window.stop - 1}): k-NN kernel executions {prof['knn']} (device counts; traced"
          f" {prof['knn_traced']}) (2 per frame "
          f"each), extraction kernel {prof['extract']} (traced {prof['extract_traced']}); "
          f"device busy {prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} "
          f"device kernels/frame; k-NN kernels {prof['knn_ms']:.4f} ms/frame "
          f"({100 * prof['knn_ms'] / prof['busy_ms']:.2f}% of device busy)", flush=True)
    print(f"[stream-vs-sync] {card}: stream {ms_frame:.2f} ms/frame, sync "
          f"{sync['ms_frame']:.2f} ms/frame; device busy stream {prof['busy_ms']:.2f} / "
          f"sync {sync['busy_ms']:.2f} ms/frame; kernels/frame stream "
          f"{prof['kernels']:.1f} / sync {sync['kernels']:.1f}; k-NN device ms/frame "
          f"stream {prof['knn_ms']:.4f} / sync {sync['knn_ms']:.4f}", flush=True)
    flt = _float_stream(frames, card)
    return {"ms_frame": ms_frame, "calls": calls, "float": flt, **prof}


FLOAT_STREAM_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_bench_float_stream_ref.npz"


@contextlib.contextmanager
def numpy_ingest():
    """The port's host ingest pinned to its numpy path: phases 4-7 hold the
    port against JAX references made on the JAX package's numpy ingest, and
    the native one rounds a few 4 mm coordinates differently (ROADMAP Queue
    3, F5)."""
    from lidarslam_tpu_torch.io import native

    real = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = real


def _replay_vs_eager(tag, g, record, step, cfg, map_cfgs, path_calls=None, exact=False):
    """The eager step of `step` from a copy of the graph's state on the
    record's inputs under set_sync_debug_mode("error"), a slab-sharded
    map's roll taking the loop the graph captures (its k-NN calls' inputs
    appended to `path_calls` when given), against one replay of the graph
    `g` on `record`; with `exact` every scalar the step packs must be
    bit-equal. Returns (m, deg, total matches)."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.ops import pipeline
    from lidarslam_tpu_torch.ops.frame import FlatRangeImage
    from lidarslam_tpu_torch.ops.stream_graph import clone_tree
    from lidarslam_tpu_torch.parallel import sharded_map

    g.record.copy_(record)
    inp, stamp, _ = g.wire.unpack(g.record)
    if isinstance(inp, FlatRangeImage):     # the flat wire's planes
        inp = FlatRangeImage(*(getattr(inp, f).clone() for f in inp.FIELDS), inp.shape)
    else:
        inp = clone_tree(inp)
    stamp = stamp.clone()
    before = clone_tree(g.state)
    torch.cuda.synchronize()
    capturing = sharded_map._capturing
    sharded_map._capturing = lambda t: True
    torch.cuda.set_sync_debug_mode("error")
    try:
        (_, packed_eager, _), calls = _record_knn_calls(
            lambda: step(inp, before, stamp, g.az, cfg, map_cfgs, False))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        sharded_map._capturing = capturing
    if path_calls is not None:
        path_calls.extend(calls)
    g.graph.replay()
    e, r = packed_eager.cpu().numpy(), g._outputs[0].cpu().numpy()
    _require(not exact or np.array_equal(e, r),
             f"[{tag}] replay != eager step in {int(np.sum(e != r))} of {e.size} packed "
             "scalars")
    ue = pipeline.unpack_scalars(e[:pipeline.PACKED_LEN])
    ur = pipeline.unpack_scalars(r[:pipeline.PACKED_LEN])
    dt, dr = pose_errors(se3.pose_to_hmat(ur["pose"]), se3.pose_to_hmat(ue["pose"]))
    _require(dt <= REPLAY_TOL_M and dr <= REPLAY_TOL_DEG and ue["total"] == ur["total"]
             and np.array_equal(ue["counts"], ur["counts"]),
             f"[{tag}] replay != eager step: {dt} m, {dr} deg, matches {ur['counts']} "
             f"vs {ue['counts']}")
    return dt, dr, ur["total"]


def _float_stream(frames, card: str):
    """The bench stream with compress_upload=False: each sweep's float planes
    go up in a FloatRecord and replay in their own graph; held against
    vlp16_bench_float_stream_ref.npz, with one replay against the eager
    step from the same state."""
    import dataclasses

    import numpy as np

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.ops import pipeline, stream_graph
    from lidarslam_tpu_torch.ops.frame import build_range_image

    ref = np.load(FLOAT_STREAM_REF_PATH)
    cfg = dataclasses.replace(bench_config(16, 1800), compress_upload=False)
    slam = Slam(cfg, device="cuda")
    ms_frame, results = _stream_run_ms(slam, frames)
    g = slam._graph
    _require(isinstance(g.wire, stream_graph.FloatRecord) and g.graph is not None,
             "[float] the float stream never captured its FloatRecord graph")
    worst_ref, _ = _check_trajectory("float", frames, results, ref)
    n, want = [r["n_matches"] for r in results], ref["n_matches"]
    bad = [i for i in range(1, len(n)) if abs(n[i] - want[i]) > 0.01 * want[i]]
    _require(not bad, f"[float] n_matches off the JAX reference by > 1% at {bad}")

    slam = Slam(cfg, device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame_async(f)
    g = slam._graph
    f = frames[PROFILED.start]
    host = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                             cfg.extractor.n_rings, cfg.extractor.max_ring_points,
                             device=False)
    record = g.wire.pack([host], [np.float32(f["stamp"])]).to("cuda")[0]
    dt, dr, total = _replay_vs_eager("float", g, record, pipeline.process_frame_stream, cfg,
                                     slam._map_cfgs_tuple)
    print(f"[float] compress_upload=False stream: {len(frames)} frames, 0 failed, records "
          f"of {g.wire.nbytes} B a sweep, {ms_frame:.2f} ms/frame over "
          f"frames {TIMED.start}-{TIMED.stop - 1}; max divergence from the JAX float stream "
          f"{worst_ref[0]:.3e} m / {worst_ref[1]:.3e} deg; n_matches within 1%; eager step "
          f"under set_sync_debug_mode('error'): no sync; replay vs eager {dt:.3e} m / "
          f"{dr:.3e} deg, matches {total} ({card})", flush=True)
    return {"ms_frame": ms_frame, "max_div_m": worst_ref[0]}


def phase_ingest(frames, card: str, stream: dict):
    """Phase 5 on the native host ingest: the median per-sweep host ingest of
    the 30 sweeps (numpy and native window planes, the native per-sweep
    byte wire), then the bench stream on native ingest with its timed
    windows dispatched inline and on a worker thread (`_stream_run_ms`), in
    turns (inline, worker, worker, inline, inline, worker), each held to
    the JAX stream reference; its idle share from phase 5's device busy
    time."""
    import numpy as np

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.io import native
    from lidarslam_tpu_torch.ops.frame import build_range_image

    _require(native.available(), f"[ingest] no native ingest: {native.last_error()}")
    cfg = bench_config(16, 1800)
    R, C = cfg.extractor.n_rings, cfg.extractor.max_ring_points

    def ingest_ms(device):
        times = []
        for f in frames:
            t0 = time.perf_counter()
            build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"], R, C,
                              packed=True, device=device)
            times.append(time.perf_counter() - t0)
        return 1000 * statistics.median(times)

    with numpy_ingest():
        numpy_ms = ingest_ms(False)
    ingest = {"numpy": numpy_ms, "native packed2": ingest_ms(False),
              "native packed": ingest_ms(None)}
    print(f"[ingest] host ingest per VLP-16 sweep, median of {len(frames)}: numpy window "
          f"planes {ingest['numpy']:.3f} ms, native packed2 (window planes) "
          f"{ingest['native packed2']:.3f} ms, native packed (per-sweep byte wire) "
          f"{ingest['native packed']:.3f} ms ({card})", flush=True)

    ref = np.load(STREAM_REF_PATH)
    runs = {False: [], True: []}
    worst = 0.0
    for worker in (False, True, True, False, False, True):
        ms, results = _stream_run_ms(Slam(cfg, device="cuda"), frames, worker=worker)
        worst = max(worst, _check_trajectory("native stream", frames, results, ref)[0][0])
        runs[worker].append(ms)
    busy = stream["busy_ms"]
    idle = {k: [1 - busy / ms for ms in v] for k, v in runs.items()}
    print(f"[ingest] bench stream on native ingest, ms/frame over frames {TIMED.start}-"
          f"{TIMED.stop - 1} (idle share at phase 5's {busy:.2f} ms/frame of device busy): "
          f"inline {', '.join(f'{m:.2f} ({100 * i:.1f}%)' for m, i in zip(runs[False], idle[False]))}; "
          f"worker {', '.join(f'{m:.2f} ({100 * i:.1f}%)' for m, i in zip(runs[True], idle[True]))}; "
          f"numpy ingest inline (phase 5) {stream['ms_frame']:.2f} "
          f"({100 * (1 - busy / stream['ms_frame']):.1f}%); max divergence from the JAX "
          f"stream {worst:.3e} m ({card})", flush=True)
    return {"ingest_ms": ingest, "inline_ms": runs[False], "worker_ms": runs[True]}


# the k-NN calls of one step of full_config, in order: 4 ego rounds of
# (edges, planes) against the previous sweep's keypoints, the localization
# pair under reuse_knn, then the overlap 1-NN against each submap
FULL_CALLS = ((("ego edges", 8), ("ego planes", 5)) * 4
              + (("loc edges", 10), ("loc planes", 5), ("overlap, edge map", 1),
                 ("overlap, plane map", 1)))
OVERLAP_TOL = 0.01


def _knn_site():
    """What the k-NN launch under way scans, read from the call stack: the
    previous sweep's keypoints (`ego`), the overlap's sample (`overlap`),
    this rank's slab of a slab-sharded map (`slab`) or a whole submap."""
    names, f = set(), sys._getframe(2)
    while f is not None:
        names.add(f.f_code.co_name)
        f = f.f_back
    if "_ego_registration" in names:
        return "ego"
    if "lcp_overlap" in names:
        return "overlap"
    return "slab" if "shard_knn" in names else "submap"


def _record_knn_calls(fn, keep_inputs=True, site=False):
    """Run `fn` watching every k-NN launch: returns (fn's result, one entry
    per launch in order), the entry a copy of the launch's inputs (index,
    queries, q_valid, k, r2), or with `keep_inputs=False` its shape label.
    With `site=True` each entry starts with the call's `_knn_site()`."""
    from lidarslam_tpu_torch.ops import cuda_knn

    calls = []
    real = cuda_knn.launch

    def recording(index, queries, q_valid, order, k, r2):
        if keep_inputs:
            entry = (cuda_knn.KnnIndex(*(t.clone() for t in index)), queries.clone(),
                     q_valid.clone(), k, r2)
        else:
            radius = "" if r2 == float("inf") else f" r={r2 ** 0.5:g} m"
            entry = f"Q={queries.shape[0]} k={k} slots={index.pts.shape[0]}{radius}"
        calls.append(((_knn_site(),) + entry if keep_inputs else (_knn_site(), entry))
                     if site else entry)
        return real(index, queries, q_valid, order, k, r2)

    cuda_knn.launch = recording
    try:
        return fn(), calls
    finally:
        cuda_knn.launch = real


def _hold_call(label, index, q, q_valid, k, r2, tag):
    """One k-NN call on the inputs a path gave it: the kernel against
    plain_knn (bit-equal without a prune radius, equal within it with one).
    Returns (max abs error of d2, radius or None, the plain map)."""
    import torch

    from lidarslam_tpu_torch.ops import cuda_knn

    radius = None if r2 == float("inf") else r2 ** 0.5
    valid = index.pts[:, 0].isfinite()
    xyz = torch.where(valid[:, None], index.pts[:, :3], 0.0)
    kd, ki, kn = cuda_knn.kernel_knn(index, q, k, radius, q_valid)
    pd, pi, pn = cuda_knn.plain_knn(xyz, valid, q, k, q_valid=q_valid)
    torch.cuda.synchronize()
    keep = torch.ones_like(pd, dtype=torch.bool) if radius is None \
        else torch.isfinite(pd) & (pd <= r2)
    if not (torch.equal(kd[keep], pd[keep]) and torch.equal(ki[keep], pi[keep])
            and torch.equal(kn[keep], pn[keep])):
        raise AssertionError(f"[{tag}] {label}: kernel != plain on the path's inputs")
    both = keep & torch.isfinite(pd)
    return float(torch.where(both, (kd - pd).abs(), 0.0).max()), radius, (xyz, valid)


def _path_call_case(label, per_frame, index, q, q_valid, k, r2, card, tag="full"):
    """One k-NN call of a path on the inputs the path gave it: held against
    plain_knn (`_hold_call`), its timings and its bound. Returns its record."""
    err, radius, (xyz, valid) = _hold_call(label, index, q, q_valid, k, r2, tag)

    t = _timings(index, q, q_valid, k, radius, plain_map=(xyz, valid))
    b = knn_bound(index, q, q_valid, k, radius)
    n_slots, n_valid = index.pts.shape[0], int(valid.sum())
    print(f"[{tag}] {label}: Q={q.shape[0]} ({int(q_valid.sum())} live) k={k} against "
          f"{n_slots} slots ({n_valid} valid), radius "
          f"{'none' if radius is None else f'{radius:g} m'}, {per_frame}x per frame: "
          f"{'bit-equal to' if radius is None else 'within the radius equal to'} the plain "
          f"scan; wrapper {t['ms']:.4f} ms, C launch {t['launch_ms']:.4f} ms, graph replay "
          f"{t['device_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cdist+topk "
          f"{t['library_ms']:.4f} ms; bound {b['pairs']} pairs x 9 ops = {b['ops_us']:.2f} us "
          f"(bytes {b['bytes']} = {b['bytes_us']:.2f} us), replay at "
          f"{100 * b['us'] / (1000 * t['device_ms']):.1f}% of it ({card})", flush=True)
    return {"name": label, "Q": q.shape[0], "k": k, "map_slots": n_slots,
            "radius": radius, "calls_per_frame": per_frame, "max_abs_err": err, **t,
            "bound_ms": b["us"] / 1000.0, "bound_by": b["by"]}


def _check_confidence(tag, results, ref):
    """n_matches within 1% of JAX on every frame (min equal), overlap within
    OVERLAP_TOL, the same motion-limit flags. Returns the largest overlap
    difference."""
    import numpy as np

    n = [r["n_matches"] for r in results]
    bad = [i for i, (a, b) in enumerate(zip(n, ref["n_matches"])) if abs(a - b) > 0.01 * b]
    if bad:
        raise AssertionError(f"[{tag}] n_matches off the JAX reference by > 1% at {bad}")
    if min(n[1:]) != int(ref["n_matches"][1:].min()):
        raise AssertionError(f"[{tag}] min n_matches {min(n[1:])} != JAX "
                             f"{int(ref['n_matches'][1:].min())}")
    d_ov = np.abs(np.array([r["overlap"] for r in results]) - ref["overlap"])
    if d_ov.max() > OVERLAP_TOL:
        raise AssertionError(f"[{tag}] overlap off JAX by {d_ov.max()} at frame "
                             f"{int(d_ov.argmax())}")
    flags = [bool(r["comply_motion_limits"]) for r in results]
    if flags != [bool(x) for x in ref["comply_motion_limits"]]:
        raise AssertionError(f"[{tag}] motion-limit flags {flags} differ from JAX's")
    return float(d_ov.max())


def _ref_gt_error(frames, ref):
    """The JAX reference's own worst error against the ground truth."""
    from lidarslam_tpu_torch.core import se3

    gt0 = frames[0]["gt_pose"]
    errs = [pose_errors(p, se3.hmat_inverse(gt0) @ f["gt_pose"])
            for p, f in zip(ref["poses"], frames)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_full(card: str, frames, ckpt_dir: Path):
    """`frames` (30 sweeps rendered with motion distortion) at full_config
    through add_frame and through add_frame_async + flush, each held against
    its JAX reference; the stream's sync-free step, replay == eager, the k-NN
    executions per replayed frame, and each k-NN call shape of the path on
    its own inputs. The add_frame run writes phase 9's checkpoint into
    `ckpt_dir` after CKPT_AT sweeps (outside its timings) and is returned
    with its results for phase 9's PGO."""
    import dataclasses

    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.config import EgoMotionMode
    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.ops import cuda_knn, pipeline
    from lidarslam_tpu_torch.ops.frame import build_range_image, flatten_packed
    from lidarslam_tpu_torch.ops.stream_graph import clone_tree

    cfg = full_config()
    ref, sref = np.load(FULL_REF_PATH), np.load(FULL_STREAM_REF_PATH)
    ref_gt = _ref_gt_error(frames, ref)

    # ---- add_frame
    slam = Slam(cfg, device="cuda")
    results, wall = [], []

    def run_sync():
        for i, f in enumerate(frames):
            if i == CKPT_AT:
                slam.save_checkpoint(str(ckpt_dir / "full_sync.npz"))
            t1 = time.perf_counter()
            results.append(slam.add_frame(f))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t1)

    cuda_knn.LAUNCHES = 0
    with extract_counted("full sync", len(frames)) as extracted:
        _, shapes_run = _record_knn_calls(run_sync, keep_inputs=False)
    sync_launches = cuda_knn.LAUNCHES
    if sync_launches != len(shapes_run):
        raise AssertionError(f"[full] {sync_launches} counted k-NN launches, "
                             f"{len(shapes_run)} seen")
    sync_by_shape = dict(sorted(collections.Counter(shapes_run).items()))
    worst_ref, worst_gt = _check_trajectory("full sync", frames, results, ref, gate_gt=False)
    d_ov = _check_confidence("full sync", results, ref)
    sync_ms = 1000 * statistics.median(wall[1:])
    print(f"[full] sync: {len(frames)} frames, 0 failed, {sync_launches} k-NN launches "
          f"{sync_by_shape}; median {sync_ms:.2f} ms/frame; extraction kernel "
          f"{_extract_line(extracted)}", flush=True)
    print(f"[full] sync: min n_matches {min(r['n_matches'] for r in results[1:])} (JAX "
          f"{int(ref['n_matches'][1:].min())}); max divergence from JAX {worst_ref[0]:.3e} m "
          f"/ {worst_ref[1]:.3e} deg; overlap within {d_ov:.2e} of JAX's; motion-limit "
          f"flags equal ({sum(not r['comply_motion_limits'] for r in results)} breaking); "
          f"from ground truth {worst_gt[0]:.3e} m / {worst_gt[1]:.3e} deg (the JAX "
          f"reference's own: {ref_gt[0]:.3e} m / {ref_gt[1]:.3e} deg)", flush=True)
    if sync_launches == 0:
        raise AssertionError("[full] the sync path launched no k-NN kernel")
    sync_slam, sync_results = slam, list(results)

    slam = Slam(cfg, device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame(f)
    cuda_knn.LAUNCHES = 0
    prof = _profile(lambda: [slam.add_frame(frames[i]) for i in PROFILED], len(PROFILED))
    # replays of the live graph: its gated step runs every round, as the stream's
    if cuda_knn.LAUNCHES or any(n != len(FULL_CALLS) * len(PROFILED)
                                for n in prof["knn"].values()):
        raise AssertionError(f"[full] sync profile: executions {prof['knn']} for "
                             f"{cuda_knn.LAUNCHES} wrapper calls in {len(PROFILED)} "
                             f"replays (expected {len(FULL_CALLS)} per frame each)")
    sync_prof = {**prof, "ms_frame": sync_ms}
    print(f"[full] sync profiled frames {PROFILED.start}-{PROFILED.stop - 1}: device busy "
          f"{prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} device kernels/frame, "
          f"k-NN executions {prof['knn']} (device counts; traced"
          f" {prof['knn_traced']}) ({len(FULL_CALLS)} per replayed frame), k-NN "
          f"{prof['knn_ms']:.4f} ms/frame", flush=True)

    # ---- add_frame_async + flush
    slam = Slam(cfg, device="cuda")
    cuda_knn.LAUNCHES = 0
    with extract_counted("full stream", len(frames)) as extracted:
        stream_ms, results = _stream_run_ms(slam, frames)
    calls = cuda_knn.LAUNCHES
    if slam._graph is None or slam._graph.graph is None:
        raise AssertionError("[full] the stream never captured its CUDA graph")
    if calls != len(FULL_CALLS) * (slam._graph.warmup_steps + 1):
        raise AssertionError(f"[full] {calls} k-NN wrapper calls in the stream for "
                             f"{slam._graph.warmup_steps} warm-up steps and 1 capture")
    worst_sref, worst_sgt = _check_trajectory("full stream", frames, results, sref,
                                              gate_gt=False)
    d_sov = _check_confidence("full stream", results, sref)
    print(f"[full] stream: {len(frames)} frames, 0 failed, {calls} Python k-NN calls "
          f"({slam._graph.warmup_steps} warm-up steps and 1 capture, {len(FULL_CALLS)} "
          f"each); {stream_ms:.2f} ms/frame over frames {TIMED.start}-{TIMED.stop - 1}; "
          f"extraction kernel {_extract_line(extracted)}", flush=True)
    print(f"[full] stream: min n_matches {min(r['n_matches'] for r in results[1:])} (JAX "
          f"{int(sref['n_matches'][1:].min())}); max divergence from the JAX stream "
          f"{worst_sref[0]:.3e} m / {worst_sref[1]:.3e} deg; overlap within {d_sov:.2e}; "
          f"motion-limit flags equal; from ground truth {worst_sgt[0]:.3e} m / "
          f"{worst_sgt[1]:.3e} deg", flush=True)

    # frames 0-16 through the API, frame 17 by hand: the eager step (its k-NN
    # inputs kept) under sync-debug "error", then one replay from the state
    slam = Slam(cfg, device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame_async(f)
    g = slam._graph
    f = frames[PROFILED.start]
    host = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                             cfg.extractor.n_rings, cfg.extractor.max_ring_points,
                             packed=True, device=False)
    record = g.wire.pack([flatten_packed(host, g.wire.capacity)],
                         [np.float32(f["stamp"])]).to("cuda")[0]
    flat, stamp, _ = g.wire.unpack(record)
    before = clone_tree(g.state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (_, packed_eager, _), path_calls = _record_knn_calls(
            lambda: pipeline.process_frame_stream(flat, before, stamp, g.az, cfg,
                                                  slam._map_cfgs_tuple, False))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g.record.copy_(record)
    g.graph.replay()
    packed_graph = g._outputs[0].clone()
    ue = pipeline.unpack_scalars(packed_eager.cpu().numpy()[:pipeline.PACKED_LEN])
    ur = pipeline.unpack_scalars(packed_graph.cpu().numpy()[:pipeline.PACKED_LEN])
    dt, dr = pose_errors(se3.pose_to_hmat(ur["pose"]), se3.pose_to_hmat(ue["pose"]))
    if dt > REPLAY_TOL_M or dr > REPLAY_TOL_DEG or ue["total"] != ur["total"] \
            or (ue["counts"] != ur["counts"]).any() or abs(ue["overlap"] - ur["overlap"]) > 1e-5:
        raise AssertionError(f"[full] replay != eager step: {dt} m, {dr} deg, matches "
                             f"{ur['total']} vs {ue['total']}, overlap {ur['overlap']} vs "
                             f"{ue['overlap']}")
    print(f"[full] eager step under set_sync_debug_mode('error'): no sync; replay vs eager: "
          f"{dt:.3e} m / {dr:.3e} deg, matches {ur['total']} == {ue['total']}, overlap "
          f"{ur['overlap']:.6f} / {ue['overlap']:.6f}", flush=True)
    got = [(c[3], c[1].shape[0]) for c in path_calls]
    if [c[3] for c in path_calls] != [k for _, k in FULL_CALLS]:
        raise AssertionError(f"[full] the step's k-NN calls (k, Q) {got} are not FULL_CALLS")

    window = range(PROFILED.start + 1, PROFILED.start + 1 + WINDOW)
    prof = _profile(lambda: [slam.add_frame_async(frames[i]) for i in window], WINDOW)
    if any(n != len(FULL_CALLS) * WINDOW for n in prof["knn"].values()):
        raise AssertionError(f"[full] k-NN executions {prof['knn']} in {WINDOW} replays "
                             f"(expected {len(FULL_CALLS)} per frame each)")
    slam.flush()
    print(f"[full] profiled window of {WINDOW} replays (frames {window.start}-"
          f"{window.stop - 1}): k-NN executions {prof['knn']} (device counts; traced"
          f" {prof['knn_traced']}) ({len(FULL_CALLS)} per frame "
          f"each); device busy {prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} device "
          f"kernels/frame; k-NN {prof['knn_ms']:.4f} ms/frame "
          f"({100 * prof['knn_ms'] / prof['busy_ms']:.2f}% of device busy)", flush=True)
    print(f"[full-stream-vs-sync] {card}: stream {stream_ms:.2f} ms/frame, sync "
          f"{sync_ms:.2f} ms/frame; device busy stream {prof['busy_ms']:.2f} / sync "
          f"{sync_prof['busy_ms']:.2f} ms/frame; kernels/frame stream {prof['kernels']:.1f} "
          f"/ sync {sync_prof['kernels']:.1f}; k-NN device ms/frame stream "
          f"{prof['knn_ms']:.4f} / sync {sync_prof['knn_ms']:.4f}", flush=True)

    # the same stream with registration off: what the 4 gated ego rounds add
    no_ego = dataclasses.replace(cfg, ego_motion_mode=EgoMotionMode.MOTION_EXTRAPOLATION)
    slam = Slam(no_ego, device="cuda")
    for f in frames[:window.start]:
        slam.add_frame_async(f)
    prof_no_ego = _profile(lambda: [slam.add_frame_async(frames[i]) for i in window], WINDOW)
    slam.flush()
    print(f"[full] the same window with registration off: device busy "
          f"{prof_no_ego['busy_ms']:.2f} ms/frame, {prof_no_ego['kernels']:.1f} device "
          f"kernels/frame, k-NN {prof_no_ego['knn_ms']:.4f} ms/frame; the gated ego rounds "
          f"add {prof['kernels'] - prof_no_ego['kernels']:.1f} kernels and "
          f"{prof['busy_ms'] - prof_no_ego['busy_ms']:.2f} ms of device busy per frame "
          f"({card})", flush=True)

    # each call shape of the step, on the inputs the path gave it
    shapes, seen = [], set()
    labels = [label for label, _ in FULL_CALLS]
    for (label, _), (index, q, q_valid, k, r2) in zip(FULL_CALLS, path_calls):
        if label in seen:
            continue
        seen.add(label)
        shapes.append(_path_call_case(label, labels.count(label), index, q, q_valid, k, r2,
                                      card))
    per_frame = {key: sum(s_[key] * s_["calls_per_frame"] for s_ in shapes)
                 for key in ("ms", "launch_ms", "device_ms", "plain_ms", "library_ms",
                             "bound_ms")}
    print(f"[full] k-NN device ms per streamed frame by call shape (graph replay x calls): "
          + ", ".join(f"{s_['name']} {s_['device_ms'] * s_['calls_per_frame']:.4f}"
                      for s_ in shapes)
          + f"; sum {per_frame['device_ms']:.4f} against the profiler's "
          f"{prof['knn_ms']:.4f} ({card})", flush=True)
    return {"sync_launches": sync_launches,
            "sync_by_shape": sync_by_shape,
            "stream_calls": calls, "stream_executions": prof["knn"],
            "stream_knn_ms": prof["knn_ms"], "sync_knn_ms": sync_prof["knn_ms"],
            "shapes": shapes, "per_frame": per_frame,
            "max_abs_err": max(s_["max_abs_err"] for s_ in shapes),
            "sync_slam": sync_slam, "sync_results": sync_results, "sync_ms": sync_ms}


PGO_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_pgo_ref.npz"
PGO_POSES = 1000            # the solver's graph: a 100 s drive at 10 Hz
PGO_SEGMENTS = 8
PGO_SOLVE_M = 1e-5          # both solver forms against the numpy oracle [m]
PGO_INPUTS_M = 1e-5         # JAX's logged inputs against JAX's optimized poses [m]
PGO_GT_SLACK_M = 0.01       # the drive's error against the ground truth over JAX's
CKPT_AT = 15                # phase 6's sync run writes its checkpoint after 15 sweeps
CKPT_M = 5e-3               # tests/test_mapping_modes.py::test_checkpoint_roundtrip's
PGO_CMD_AT = 20             # the stream's PGO command after this many sweeps


def pgo_graph(n: int, seed: int = 7):
    """A drifting 10 Hz odometry chain of n poses (1 m and 0.02 rad a step,
    2 cm and 2 mrad of noise) with a GPS fix at every fifth pose (1 cm of
    noise): the recipe of tests/test_posegraph_device.py::_make_graph.
    Returns (poses, times, covariances, gps positions, gps times, ground
    truth)."""
    import numpy as np

    from lidarslam_tpu_torch.core import se3

    rng = np.random.default_rng(seed)
    gt, noisy = [np.eye(4)], [np.eye(4)]
    for _ in range(1, n):
        step = np.eye(4)
        step[:3, :3] = se3.so3_exp([0, 0, 0.02])
        step[0, 3] = 1.0
        gt.append(gt[-1] @ step)
        nstep = step.copy()
        nstep[:3, 3] += rng.normal(0, 0.02, 3)
        nstep[:3, :3] = nstep[:3, :3] @ se3.so3_exp(rng.normal(0, 0.002, 3))
        noisy.append(noisy[-1] @ nstep)
    times = np.arange(n) * 0.1
    gps = np.stack([gt[i][:3, 3] for i in range(0, n, 5)])
    gps = gps + rng.normal(0, 0.01, gps.shape)
    return noisy, times, [np.eye(6) * 1e-3] * n, gps, times[::5], gt


def _wall_median_ms(fn, reps=5):
    """Median wall ms of `reps` calls of `fn` (each ending in a host read)
    after one warm-up call; returns (ms, the last call's result)."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(1000 * (time.perf_counter() - t0))
    return statistics.median(times), out


def _max_position_diff(a, b) -> float:
    import numpy as np

    return max(float(np.abs(np.asarray(x)[:3, 3] - np.asarray(y)[:3, 3]).max())
               for x, y in zip(a, b))


def _max_rotation_diff(a, b) -> float:
    import numpy as np

    return max(float(np.abs(np.asarray(x)[:3, :3] - np.asarray(y)[:3, :3]).max())
               for x, y in zip(a, b))


def _gt_positions(frames):
    import numpy as np

    from lidarslam_tpu_torch.core import se3

    gt0 = se3.hmat_inverse(frames[0]["gt_pose"])
    return np.stack([(gt0 @ f["gt_pose"])[:3, 3] for f in frames])


def phase_pgo(card: str, frames, full: dict, ckpt_dir: Path):
    """The back end and the state surface on the card: the float64 PGO
    solver at PGO_POSES poses (loop and Schur against the numpy oracle,
    timed); `run_pose_graph_optimization` on phase 6's synchronous drive
    against vlp16_pgo_ref.npz, and JAX's own logged inputs through the
    port's solver; phase 6's checkpoint continued in a fresh Slam; the maps
    through PCD; a stream after the PGO command (replay == eager)."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.backend import posegraph
    from lidarslam_tpu_torch.backend.posegraph_device import optimize_pose_graph_device
    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.ops import pipeline
    from lidarslam_tpu_torch.ops.frame import build_range_image, flatten_packed

    out = {}
    # ---- the solver at a realistic size
    noisy, times, covs, gps, gps_t, gt = pgo_graph(PGO_POSES)
    kw = dict(gps_positions=gps, gps_times=gps_t)
    oracle_ms, oracle = _wall_median_ms(
        lambda: posegraph.optimize_pose_graph(noisy, times, covs, **kw))
    for name, segments in (("scan", 0), ("schur", PGO_SEGMENTS)):
        ms, (poses, cost) = _wall_median_ms(lambda: optimize_pose_graph_device(
            noisy, times, covs, **kw, n_segments=segments, device="cuda"))
        d = _max_position_diff(poses, oracle[0])
        _require(d <= PGO_SOLVE_M and np.isfinite(cost),
                 f"[pgo] {name}: {d:.3e} m from the numpy oracle (limit {PGO_SOLVE_M})")
        out[name + "_ms"], out[name + "_m"] = ms, d
    err = max(np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(oracle[0], gt))
    print(f"[pgo] {card}: {PGO_POSES}-pose graph (float64, {len(gps)} GPS fixes), median of "
          f"5 solves after one warm-up: scan {out['scan_ms']:.1f} ms, schur "
          f"({PGO_SEGMENTS} segments) {out['schur_ms']:.1f} ms on the card, numpy oracle "
          f"{oracle_ms:.1f} ms on the host; from the oracle: scan {out['scan_m']:.3e} m, "
          f"schur {out['schur_m']:.3e} m; oracle from ground truth {err:.3e} m", flush=True)
    out["numpy_ms"] = oracle_ms

    # ---- run_pose_graph_optimization on phase 6's synchronous drive
    ref = np.load(PGO_REF_PATH)
    slam = full["sync_slam"]
    gps = _gt_positions(frames)
    log_times = np.array([e["time"] for e in slam.log_trajectory])
    _require(np.array_equal(log_times, ref["times"]), "[pgo] the drive's stamps are not "
             "the reference's")
    t0 = time.perf_counter()
    _require(slam.run_pose_graph_optimization(gps, log_times, use_device_backend=True),
             "[pgo] run_pose_graph_optimization failed")
    torch.cuda.synchronize()
    pgo_ms = 1000 * (time.perf_counter() - t0)
    after = [e["pose"] for e in slam.log_trajectory]
    worst = (0.0, 0.0)
    for i, (a, b) in enumerate(zip(after, ref["poses_after"])):
        e = pose_errors(a, b)
        worst = tuple(max(x, y) for x, y in zip(worst, e))
        _require(e[0] <= REF_TOL_M and e[1] <= REF_TOL_DEG,
                 f"[pgo] frame {i}: {e} from JAX's optimized pose")
    valid = [len(slam.get_map_points(k)[0]) if k in slam.maps else 0 for k in range(3)]
    for k, (n, m) in enumerate(zip(valid, ref["map_valid"])):
        _require(abs(n - int(m)) <= 0.01 * int(m), f"[pgo] map {k}: {n} valid slots, JAX {m}")
    gt_err = max(float(np.linalg.norm(p[:3, 3] - g)) for p, g in zip(after, gps))
    gt_err_jax = max(float(np.linalg.norm(p[:3, 3] - g))
                     for p, g in zip(ref["poses_after"], gps))
    _require(gt_err <= gt_err_jax + PGO_GT_SLACK_M,
             f"[pgo] {gt_err:.3e} m from ground truth, JAX {gt_err_jax:.3e} m")
    print(f"[pgo] drive: {len(after)} poses optimized and 3 maps rebuilt on the card in "
          f"{pgo_ms:.1f} ms; from JAX's optimized poses {worst[0]:.3e} m / {worst[1]:.3e} "
          f"deg; map slots {valid} (JAX {ref['map_valid'].tolist()}); from ground truth "
          f"{gt_err:.3e} m (JAX {gt_err_jax:.3e} m) ({card})", flush=True)
    out.update(drive_m=worst[0], drive_deg=worst[1], gt_m=gt_err, gt_jax_m=gt_err_jax,
               drive_ms=pgo_ms)
    # JAX's logged inputs through the port's solver
    poses, _ = optimize_pose_graph_device(
        list(ref["poses_before"]), ref["times"], list(ref["covariances"]),
        gps_positions=ref["gps"], gps_times=ref["times"], device="cuda")
    anchor = se3.hmat_inverse(poses[0])
    poses = [anchor @ p for p in poses]
    d, dr = _max_position_diff(poses, ref["poses_after"]), \
        _max_rotation_diff(poses, ref["poses_after"])
    _require(d <= PGO_INPUTS_M and dr <= PGO_INPUTS_M,
             f"[pgo] JAX's inputs: {d:.3e} m / {dr:.3e} from JAX's optimized poses")
    print(f"[pgo] JAX's logged poses and covariances through the port's solver on the card: "
          f"{d:.3e} m (rotation entries {dr:.3e}) from JAX's optimized poses", flush=True)
    out["inputs_m"] = d

    # ---- phase 6's checkpoint continued in a fresh Slam
    cfg = full_config()
    b = Slam(cfg, device="cuda")
    b.load_checkpoint(str(ckpt_dir / "full_sync.npz"))
    _require(b.n_frames == CKPT_AT and b._stream_state is None,
             f"[pgo] checkpoint: {b.n_frames} frames")
    cont = [b.add_frame(f) for f in frames[CKPT_AT:]]
    d = max(pose_errors(r["pose"], w["pose"])[0]
            for r, w in zip(cont, full["sync_results"][CKPT_AT:]))
    _require(d <= CKPT_M and not any(r["failure"] for r in cont),
             f"[pgo] checkpoint continuation {d:.3e} m from the uninterrupted run")
    print(f"[pgo] checkpoint after {CKPT_AT} sweeps, loaded into a fresh Slam on the card and "
          f"continued over {len(cont)}: {d:.3e} m from the uninterrupted run (limit "
          f"{CKPT_M}; JAX's own resume, from the reference: {ref['resume_m'][0]:.3e} m from its "
          f"checkpoint as loaded, {ref['resume_m'][1]:.3e} m with the previous keypoints "
          f"restored, which the port's checkpoint carries: ROADMAP D7)", flush=True)
    out["ckpt_m"] = d
    # the maps through PCD
    prefix = str(ckpt_dir / "map_")
    b.save_maps_to_pcd(prefix)
    c = Slam(cfg, device="cuda")
    c.load_maps_from_pcd(prefix)
    for k in cfg.used_types:
        x = b.get_map_points(k)[0]
        y = c.get_map_points(k)[0]
        x, y = x[np.lexsort(x.T)], y[np.lexsort(y.T)]
        _require(x.shape == y.shape and np.array_equal(x, y),
                 f"[pgo] {k.name} map through PCD: {len(y)} points, saved {len(x)}")
    print(f"[pgo] maps through save_maps_to_pcd / load_maps_from_pcd: the same valid points "
          f"({[len(b.get_map_points(k)[0]) for k in cfg.used_types]})", flush=True)

    # ---- a stream after the PGO command, seeded into the captured graph
    s = Slam(cfg, device="cuda")
    for f in frames[:PGO_CMD_AT]:
        s.add_frame_async(f)
    g = s._graph
    _require(g is not None and g.graph is not None, "[pgo] the stream captured no graph")
    ptr = g.state.maps[1].xyz.data_ptr()
    gps = _gt_positions(frames[:PGO_CMD_AT])
    _require(s.execute_command(Slam.GPS_SLAM_POSE_GRAPH_OPTIMIZATION, gps_positions=gps,
                               gps_times=[f["stamp"] for f in frames[:PGO_CMD_AT]],
                               use_device_backend=True) is True, "[pgo] the command failed")
    _require(s.n_frames == PGO_CMD_AT and s._stream_state is None,
             "[pgo] the command did not flush the stream")
    s.add_frame_async(frames[PGO_CMD_AT])          # the segment's first sweep, seeded
    f = frames[PGO_CMD_AT + 1]
    host = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                             cfg.extractor.n_rings, cfg.extractor.max_ring_points,
                             packed=True, device=False)
    record = g.wire.pack([flatten_packed(host, g.wire.capacity)],
                         [np.float32(f["stamp"])]).to("cuda")[0]
    dt, dr, total = _replay_vs_eager("pgo", g, record, pipeline.process_frame_stream, cfg,
                                     s._map_cfgs_tuple)
    window = frames[PGO_CMD_AT + 2:PGO_CMD_AT + 2 + WINDOW]
    _require(len(window) == WINDOW, "[pgo] too few sweeps for a window after the command")
    for f in window:
        s.add_frame_async(f)
    outs = s.flush()
    n_failed = sum(bool(o["failure"]) for o in outs)
    _require(s._graph is g and g.state.maps[1].xyz.data_ptr() == ptr,
             "[pgo] the graph or its buffers were replaced after the PGO")
    _require(len(outs) == 1 + WINDOW and n_failed == 0,
             f"[pgo] stream after the PGO: {n_failed} of {len(outs)} failed")
    print(f"[pgo] stream after GPS_SLAM_POSE_GRAPH_OPTIMIZATION at sweep {PGO_CMD_AT}: the "
          f"captured graph's buffers re-seeded in place; replay vs eager {dt:.3e} m / "
          f"{dr:.3e} deg ({total} matches); a window of {WINDOW} replays, 0 failed, min "
          f"n_matches {min(o['n_matches'] for o in outs)}", flush=True)
    return out


EXT_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_ext_ref.npz"
EXT_STREAM_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_ext_stream_ref.npz"
# the k-NN calls of one step of ext_config: FULL_CALLS with the blobs'
# localization query (reuse_knn: round 0, after edges and planes) and the
# overlap's 1-NN against the blob submap
EXT_CALLS = (FULL_CALLS[:8] + (("loc edges", 10), ("loc planes", 5), ("loc blobs", 10))
             + (("overlap, edge map", 1), ("overlap, plane map", 1), ("overlap, blob map", 1)))


def _ext_run(cfg, frames, sensors, stream: bool, device: str = "cuda", worker=False):
    """One ext_config run on `device` (`sensors` fed first; none when None):
    (results, per-type match counts per frame, the Slam, ms/frame as PERF.md
    defines it: the median over the localized frames of add_frame ending in
    a device sync, or the stream's frames TIMED between two device syncs,
    their windows on a worker thread with `worker`)."""
    import torch

    from lidarslam_tpu_torch import Slam

    slam = Slam(cfg, device=device)
    if sensors is not None:
        feed_sensors(slam, sensors)
    if not stream:
        results, counts, wall = [], [], []
        for f in frames:
            t0 = time.perf_counter()
            results.append(slam.add_frame(f))
            if device == "cuda":
                torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            counts.append(slam.match_counts.copy())
        return results, counts, slam, 1000 * statistics.median(wall[1:] or wall)
    counts = []
    real = slam._log_state

    def log_state(stamp):       # flush logs each frame after its match counts
        counts.append(slam.match_counts.copy())
        real(stamp)
    slam._log_state = log_state
    ms, results = _stream_run_ms(slam, frames, worker=worker)
    return results, counts, slam, ms


# Phase 7's limits on a run against its JAX reference (ext_readings). With
# blobs this drive's trajectory amplifies rounding (ROADMAP Queue 3), so the
# pose, overlap and map limits lie between readings of scripts/ext_witness.py
# (PERF.md): above the port's distance from JAX and from itself on the CPU,
# below a run's with a MAX_INTENSITY plane map for CENTROID. A run with its
# sensor blocks dropped or its blob model in bfloat16 stays within the
# rounding spread, so phase 7 checks those two on one step instead. The
# first localization starts from maps equal to JAX's; per-type n_matches
# (relative, every localized frame) hold to 1%.
EXT_TOL = {"pose_m": 0.03, "pose_deg": REF_TOL_DEG, "first_m": 1e-3, "overlap": 0.02,
           "maps": [0.04, 0.02, 0.005], "matches": 0.01}


def ext_record(results, counts, slam, stamp) -> dict:
    """A run of ext_config in its JAX reference's format: per-frame poses,
    n_matches, failure, overlap, motion-limit flags and per-type match
    counts; each map's valid slots and the age of the oldest removable edge
    point at `stamp`, after the last frame."""
    import numpy as np

    from lidarslam_tpu_torch.config import Keypoint

    m = slam.maps[Keypoint.EDGE]
    keep = (m.valid & ~m.fixed).cpu().numpy()
    return {"poses": np.stack([r["pose"] for r in results]),
            "n_matches": np.asarray([r["n_matches"] for r in results], np.int64),
            "failure": np.asarray([bool(r["failure"]) for r in results]),
            "overlap": np.asarray([r["overlap"] for r in results], np.float64),
            "comply_motion_limits": np.asarray([bool(r["comply_motion_limits"])
                                                for r in results]),
            "match_counts": np.asarray(counts, np.int64).reshape(len(results), 3),
            "map_valid": np.asarray([int(slam.maps[k].valid.sum()) for k in Keypoint]),
            "edge_oldest_age": float((np.float32(stamp) - m.time.cpu().numpy()[keep]).max())}


def ext_readings(got, want) -> dict:
    """How far run `got` lies from `want` (ext_record's or a reference's
    format), in EXT_TOL's keys: the worst pose over the drive (m, deg), the
    first localization (m), the largest overlap difference, each map's
    valid slots and each type's n_matches over the localized frames
    (largest relative difference); besides, the motion-limit flags that
    differ, the failed frames, each type's smallest n_matches and the edge
    map's oldest removable point (s)."""
    import numpy as np

    errs = [pose_errors(a, b) for a, b in zip(got["poses"], want["poses"])]
    g, w = got["match_counts"][1:], want["match_counts"][1:]
    return {"pose_m": max(e[0] for e in errs), "pose_deg": max(e[1] for e in errs),
            "first_m": errs[1][0],
            "overlap": float(np.abs(got["overlap"] - want["overlap"]).max()),
            "maps": (np.abs(got["map_valid"] - want["map_valid"])
                     / np.maximum(want["map_valid"], 1)).tolist(),
            "matches": (np.abs(g - w) / np.maximum(w, 1)).max(0).tolist(),
            "flags": int((got["comply_motion_limits"] != want["comply_motion_limits"]).sum()),
            "failed": int(got["failure"].sum()), "min_matches": g.min(0).tolist(),
            "edge_oldest_age": float(got["edge_oldest_age"])}


def _check_ext(tag, readings):
    """A run's ext_readings within EXT_TOL; no failed frame, the same
    motion-limit flags, no removable edge point older than the decay."""
    r, t = readings, EXT_TOL
    _require(r["failed"] == 0, f"[{tag}] {r['failed']} failed frames")
    _require(r["flags"] == 0, f"[{tag}] {r['flags']} motion-limit flags differ from JAX's")
    _require(r["edge_oldest_age"] <= EXT_DECAY_S,
             f"[{tag}] an edge point {r['edge_oldest_age']} s old outlived the decay")
    for key in ("pose_m", "pose_deg", "first_m", "overlap"):
        _require(r[key] <= t[key], f"[{tag}] {key} {r[key]} from JAX's, above {t[key]}")
    for key, lim in (("maps", t["maps"]), ("matches", [t["matches"]] * 3)):
        _require(all(x <= y for x, y in zip(r[key], lim)),
                 f"[{tag}] {key} {r[key]} from JAX's (relative), above {lim}")


def _ext_summary(readings, ref) -> str:
    """A run's readings against JAX, for the log."""
    r = readings
    return (f"min n_matches per type (edge, plane, blob) {r['min_matches']} (JAX "
            f"{ref['match_counts'][1:].min(0).tolist()}), off JAX's by at most "
            f"{[f'{x:.4f}' for x in r['matches']]} (relative); first localization "
            f"{r['first_m']:.3e} m from JAX's; max divergence from JAX "
            f"{r['pose_m']:.3e} m / {r['pose_deg']:.3e} deg; overlap within "
            f"{r['overlap']:.3e}; flags equal; valid map slots off JAX's "
            f"{ref['map_valid'].tolist()} by {[f'{x:.4f}' for x in r['maps']]} (relative); "
            f"oldest edge point {r['edge_oldest_age']:.4f} s")


# the blob matcher on the card against the CPU on the same neighbours: A6
# relative to each match's largest entry (tests/test_torch_blobs_sensors.py
# holds the CPU against JAX to the same), P in metres
BLOB_A6_TOL, BLOB_P_TOL_M = 1e-3, 1e-5


def _cpu_tree(tree):
    """A (Named)tuple tree with its tensors copied to the host."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple):
        vals = [_cpu_tree(t) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _keeping_first_blob_match(fn, store):
    """Run `fn` keeping in `store` the arguments and result of the blob
    matcher's first call (localization round 0), copied on the device."""
    import torch

    from lidarslam_tpu_torch.config import Keypoint
    from lidarslam_tpu_torch.ops import icp
    from lidarslam_tpu_torch.ops.stream_graph import clone_tree

    real = icp._MATCH_FNS[Keypoint.BLOB]

    def keep(a):
        return clone_tree(a) if isinstance(a, (tuple, torch.Tensor)) else a

    def keeping(*args, **kwargs):
        out = real(*args, **kwargs)
        if not store:
            store.append(([keep(a) for a in args], {k: keep(v) for k, v in kwargs.items()},
                          clone_tree(out)))
        return out

    icp._MATCH_FNS[Keypoint.BLOB] = keeping
    try:
        return fn()
    finally:
        icp._MATCH_FNS[Keypoint.BLOB] = real


def _check_blob_model(call):
    """The blob matcher's call kept by _keeping_first_blob_match, re-run on
    the CPU (the plain path, on the same neighbours): A6 within BLOB_A6_TOL
    and P within BLOB_P_TOL_M on every keypoint both sides match, equal
    weights; the same A6 rounded to bfloat16, a control, beyond the limit.
    Returns (A6 error, the control's, P error, status flips, live
    keypoints, matches on both sides)."""
    import torch

    from lidarslam_tpu_torch.ops import matcher

    args, kwargs, got = call
    want = matcher.match_blobs(*[_cpu_tree(a) for a in args],
                               **{k: _cpu_tree(v) for k, v in kwargs.items() if k != "prepared"})
    got = _cpu_tree(got)
    both = got.valid & want.valid
    scale = want.A6[:, both].abs().amax(dim=0).clamp(min=1e-30)

    def a6_err(a6):
        return float(((a6[:, both] - want.A6[:, both]).abs().amax(dim=0) / scale).max())
    err = a6_err(got.A6)
    control = a6_err(got.A6.to(torch.bfloat16).to(torch.float32))
    p_err = float((got.P[both] - want.P[both]).abs().max())
    flips = int((got.status != want.status).sum())
    live = int(args[1].sum())
    _require(int(both.sum()) > 0 and err <= BLOB_A6_TOL < control and p_err <= BLOB_P_TOL_M
             and torch.equal(got.weight[both], want.weight[both]),
             f"[ext] blob matches on the card vs the CPU: A6 {err} (limit {BLOB_A6_TOL}, "
             f"bfloat16 control {control}), P {p_err} m over {int(both.sum())} matches")
    return err, control, p_err, flips, live, int(both.sum())


def phase_ext(card: str, frames):
    """The rest of the single-LiDAR configuration surface, ext_config
    (blobs, the CENTER_POINT blob map, the CENTROID plane map, edge decay,
    wheel odometry and IMU gravity), on `frames` (rendered with motion
    distortion) through add_frame and through add_frame_async + flush, each
    held against its JAX reference (vlp16_ext_ref.npz,
    vlp16_ext_stream_ref.npz): poses, per-type n_matches, overlap, flags,
    the maps' valid slots and the decay (EXT_TOL); the stream's sync-free
    step with its sensor blocks, replay == eager, the same step without
    them elsewhere, its blob matches against the CPU's (BLOB_A6_TOL, a
    bfloat16 control beyond it), 14 executions of each k-NN kernel
    per replayed frame, and each k-NN call shape of the step (the blobs'
    two new ones included) on its own inputs, with its timings and bound."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.io import synthetic
    from lidarslam_tpu_torch.ops import cuda_knn, pipeline
    from lidarslam_tpu_torch.ops.frame import build_range_image, flatten_packed
    from lidarslam_tpu_torch.ops.stream_graph import clone_tree
    from lidarslam_tpu_torch.sensors.constraints import (inactive_gravity, inactive_odom,
                                                         on_device)

    cfg = ext_config()
    sensors = sensor_measurements(synthetic.weaving_street_trajectory(), SENSOR_END_S)
    ref, sref = np.load(EXT_REF_PATH), np.load(EXT_STREAM_REF_PATH)
    ref_gt = _ref_gt_error(frames, ref)
    print(f"[ext] {len(sensors[0])} odometer and accelerometer readings at "
          f"{SENSOR_RATE_HZ:g} Hz; held to {EXT_TOL} of JAX", flush=True)

    # ---- add_frame: the slice's main path, its k-NN launches counted
    cuda_knn.LAUNCHES = 0
    with extract_counted("ext sync", len(frames)) as extracted:
        (results, counts, slam, sync_ms), shapes_run = _record_knn_calls(
            lambda: _ext_run(cfg, frames, sensors, stream=False), keep_inputs=False)
    sync_launches = cuda_knn.LAUNCHES
    _require(sync_launches == len(shapes_run) > 0,
             f"[ext] {sync_launches} counted k-NN launches, {len(shapes_run)} seen")
    sync_by_shape = dict(sorted(collections.Counter(shapes_run).items()))
    worst_gt = _check_trajectory("ext sync", frames, results, ref, gate_gt=False,
                                 tol_m=EXT_TOL["pose_m"])[1]
    readings = ext_readings(ext_record(results, counts, slam, frames[-1]["stamp"]), ref)
    _check_ext("ext sync", readings)
    print(f"[ext] sync: {len(frames)} frames, 0 failed, {sync_launches} k-NN launches "
          f"{sync_by_shape}; median {sync_ms:.2f} ms/frame; extraction kernel "
          f"{_extract_line(extracted)}", flush=True)
    print(f"[ext] sync: {_ext_summary(readings, ref)}; from ground truth "
          f"{worst_gt[0]:.3e} m / {worst_gt[1]:.3e} deg (the JAX reference's own: "
          f"{ref_gt[0]:.3e} m / {ref_gt[1]:.3e} deg)", flush=True)

    slam = _ext_run(cfg, frames[:PROFILED.start], sensors, stream=False)[2]
    sync_prof = _profile(lambda: [slam.add_frame(frames[i]) for i in PROFILED], len(PROFILED))
    print(f"[ext] sync profiled frames {PROFILED.start}-{PROFILED.stop - 1}: device busy "
          f"{sync_prof['busy_ms']:.2f} ms/frame, {sync_prof['kernels']:.1f} device "
          f"kernels/frame, k-NN {sync_prof['knn_ms']:.4f} ms/frame ({card})", flush=True)

    # ---- add_frame_async + flush: every sweep carries sensor blocks in its
    # record of the window
    cuda_knn.LAUNCHES = 0
    with extract_counted("ext stream", len(frames)) as extracted:
        results, counts, slam, stream_ms = _ext_run(cfg, frames, sensors, stream=True)
    calls = cuda_knn.LAUNCHES
    g = slam._graph
    _require(g is not None and g.graph is not None and g.blocks == (True, True),
             "[ext] the stream never captured its graph with both sensor blocks")
    _require(calls == len(EXT_CALLS) * (g.warmup_steps + 1),
             f"[ext] {calls} k-NN wrapper calls in the stream for {g.warmup_steps} "
             f"warm-up steps and 1 capture")
    worst_sgt = _check_trajectory("ext stream", frames, results, sref, gate_gt=False,
                                  tol_m=EXT_TOL["pose_m"])[1]
    sreadings = ext_readings(ext_record(results, counts, slam, frames[-1]["stamp"]), sref)
    _check_ext("ext stream", sreadings)
    print(f"[ext] stream: {len(frames)} frames, 0 failed, {calls} Python k-NN calls "
          f"({g.warmup_steps} warm-up steps and 1 capture, {len(EXT_CALLS)} each); "
          f"{stream_ms:.2f} ms/frame over frames {TIMED.start}-{TIMED.stop - 1}; extraction "
          f"kernel {_extract_line(extracted)}", flush=True)
    print(f"[ext] stream: {_ext_summary(sreadings, sref)}; from ground truth "
          f"{worst_sgt[0]:.3e} m / {worst_sgt[1]:.3e} deg", flush=True)

    # frames 0-16 through the API, frame 17 by hand with its sensor blocks:
    # the eager step (k-NN inputs kept) under sync-debug "error", then one
    # replay from the same state
    slam = Slam(cfg, device="cuda")
    feed_sensors(slam, sensors)
    for f in frames[:PROFILED.start]:
        slam.add_frame_async(f)
    g = slam._graph
    f = frames[PROFILED.start]
    host = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                             cfg.extractor.n_rings, cfg.extractor.max_ring_points,
                             packed=True, device=False)
    extras = slam._stream_extras(float(f["stamp"]))
    _require(len(extras) == 2, f"[ext] frame {PROFILED.start} carries {len(extras)} "
             "sensor blocks, not 2")
    record = g.wire.pack([flatten_packed(host, g.wire.capacity)], [np.float32(f["stamp"])],
                         [extras]).to("cuda")[0]
    flat, stamp, blocks = g.wire.unpack(record)
    held = tuple(b for b, on in zip(blocks, g.blocks) if on)
    before, before_dropped = clone_tree(g.state), clone_tree(g.state)
    blob_call = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (_, packed_eager, _), path_calls = _keeping_first_blob_match(
            lambda: _record_knn_calls(
                lambda: pipeline.process_frame_stream(flat, before, stamp, g.az, cfg,
                                                      slam._map_cfgs_tuple, False, held)),
            blob_call)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the same step with the sensor blocks dropped (inactive, adding 0)
    dropped = tuple(on_device(b, "cuda") for b, on in
                    zip((inactive_odom(), inactive_gravity()), g.blocks) if on)
    packed_dropped = pipeline.process_frame_stream(flat, before_dropped, stamp, g.az, cfg,
                                                   slam._map_cfgs_tuple, False, dropped)[1]
    g.record.copy_(record)
    g.graph.replay()
    packed_graph = g._outputs[0].clone()
    ue = pipeline.unpack_scalars(packed_eager.cpu().numpy()[:pipeline.PACKED_LEN])
    ur = pipeline.unpack_scalars(packed_graph.cpu().numpy()[:pipeline.PACKED_LEN])
    ud = pipeline.unpack_scalars(packed_dropped.cpu().numpy()[:pipeline.PACKED_LEN])
    dt, dr = pose_errors(se3.pose_to_hmat(ur["pose"]), se3.pose_to_hmat(ue["pose"]))
    d_drop = pose_errors(se3.pose_to_hmat(ud["pose"]), se3.pose_to_hmat(ue["pose"]))
    _require(not np.array_equal(ud["pose"], ue["pose"]) and dt <= d_drop[0],
             f"[ext] the sensor blocks do not move the step: without them "
             f"{d_drop[0]} m from it, the replay {dt} m")
    _require(dt <= REPLAY_TOL_M and dr <= REPLAY_TOL_DEG and ue["total"] == ur["total"]
             and (ue["counts"] == ur["counts"]).all()
             and abs(ue["overlap"] - ur["overlap"]) <= 1e-5,
             f"[ext] replay != eager step: {dt} m, {dr} deg, matches {ur['counts']} vs "
             f"{ue['counts']}, overlap {ur['overlap']} vs {ue['overlap']}")
    print(f"[ext] eager step with both sensor blocks under set_sync_debug_mode('error'): "
          f"no sync; replay vs eager: {dt:.3e} m / {dr:.3e} deg, matches "
          f"{ur['counts'].tolist()} == {ue['counts'].tolist()}, overlap {ur['overlap']:.6f} "
          f"/ {ue['overlap']:.6f}", flush=True)
    print(f"[ext] the same step with the sensor blocks dropped: {d_drop[0]:.3e} m / "
          f"{d_drop[1]:.3e} deg from it", flush=True)
    blob = _check_blob_model(blob_call[0])
    print(f"[ext] blob matches of the step's first localization round on the card vs "
          f"the CPU on the same neighbours: A6 within {blob[0]:.3e} of each match's "
          f"largest entry (limit {BLOB_A6_TOL:g}; rounded to bfloat16 {blob[1]:.3e}), P "
          f"within {blob[2]:.3e} m over {blob[5]} matches; {blob[3]} of {blob[4]} "
          f"statuses differ", flush=True)
    got = [(c[3], c[1].shape[0]) for c in path_calls]
    _require([c[3] for c in path_calls] == [k for _, k in EXT_CALLS],
             f"[ext] the step's k-NN calls (k, Q) {got} are not EXT_CALLS")

    window = range(PROFILED.start + 1, PROFILED.start + 1 + WINDOW)
    prof = _profile(lambda: [slam.add_frame_async(frames[i]) for i in window], WINDOW)
    _require(all(n == len(EXT_CALLS) * WINDOW for n in prof["knn"].values()),
             f"[ext] k-NN executions {prof['knn']} in {WINDOW} replays (expected "
             f"{len(EXT_CALLS)} per frame each)")
    slam.flush()
    print(f"[ext] profiled a window of {WINDOW} replays (frames {window.start}-"
          f"{window.stop - 1}): k-NN executions {prof['knn']} (device counts; traced"
          f" {prof['knn_traced']}) ({len(EXT_CALLS)} per frame "
          f"each); device busy {prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} device "
          f"kernels/frame; k-NN {prof['knn_ms']:.4f} ms/frame "
          f"({100 * prof['knn_ms'] / prof['busy_ms']:.2f}% of device busy)", flush=True)
    print(f"[ext-stream-vs-sync] {card}: stream {stream_ms:.2f} ms/frame, sync "
          f"{sync_ms:.2f} ms/frame; "
          f"device busy stream {prof['busy_ms']:.2f} / sync {sync_prof['busy_ms']:.2f} "
          f"ms/frame; kernels/frame stream {prof['kernels']:.1f} / sync "
          f"{sync_prof['kernels']:.1f}; k-NN device ms/frame stream {prof['knn_ms']:.4f} / "
          f"sync {sync_prof['knn_ms']:.4f}", flush=True)

    shapes, seen = [], set()
    labels = [label for label, _ in EXT_CALLS]
    for (label, _), (index, q, q_valid, k, r2) in zip(EXT_CALLS, path_calls):
        if label in seen:
            continue
        seen.add(label)
        shapes.append(_path_call_case(label, labels.count(label), index, q, q_valid, k, r2,
                                      card, tag="ext"))
    per_frame = {key: sum(s_[key] * s_["calls_per_frame"] for s_ in shapes)
                 for key in ("ms", "launch_ms", "device_ms", "plain_ms", "library_ms",
                             "bound_ms")}
    print(f"[ext] k-NN device ms per streamed frame by call shape (graph replay x calls): "
          + ", ".join(f"{s_['name']} {s_['device_ms'] * s_['calls_per_frame']:.4f}"
                      for s_ in shapes)
          + f"; sum {per_frame['device_ms']:.4f} against the profiler's "
          f"{prof['knn_ms']:.4f} ({card})", flush=True)
    return {"sync_launches": sync_launches, "sync_by_shape": sync_by_shape,
            "stream_calls": calls, "stream_executions": prof["knn"],
            "stream_knn_ms": prof["knn_ms"], "sync_knn_ms": sync_prof["knn_ms"],
            "shapes": shapes, "per_frame": per_frame,
            "max_abs_err": max(s_["max_abs_err"] for s_ in shapes)}


RIG_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_rig_ref.npz"
RIG_STREAM_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_rig_stream_ref.npz"
# the k-NN calls of one rig acquisition: full_config's without the overlap
# (a merged keypoint set has no range image to sample)
RIG_CALLS = FULL_CALLS[:10]
RIG_PROFILED = 4            # acquisitions in each of phase 8's profiled windows


def _check_per_type(tag, counts, ref):
    """Per-type match counts within 1% of JAX's on every frame."""
    import numpy as np

    got, want = np.asarray(counts), ref["match_counts"]
    bad = np.argwhere(np.abs(got - want) > 0.01 * want)
    _require(got.shape == want.shape and not len(bad),
             f"[{tag}] per-type n_matches off JAX by > 1% at (frame, type) {bad.tolist()}")


def phase_rig(card: str):
    """The multi-LiDAR rig at full width: rig_config() on 30 acquisitions of
    render_rig (two VLP-16s, device 1 at its offset with its own extractor,
    0.05 s later), through add_frames and add_frames_async + flush, each held
    against its JAX reference (vlp16_rig_ref.npz, vlp16_rig_stream_ref.npz);
    the rig graph's step sync-free and its replay equal to the eager step;
    a profiled window of acquisitions taken with Slam.start_profiling /
    stop_profiling and read back from its trace file; each k-NN call shape
    of the step against the plain version on its own inputs."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.ops import cuda_extract, cuda_knn, pipeline
    from lidarslam_tpu_torch.utils import profiling

    cfg = rig_config()
    t0 = time.perf_counter()
    acq, offset = render_rig(N_FRAMES)
    base = [a[0] for a in acq]
    print(f"[rig] rendered {len(acq)} acquisitions of two VLP-16s in "
          f"{time.perf_counter() - t0:.1f} s; device 1 at {RIG_OFFSET_POSE}, "
          f"{RIG_DT_S} s after device 0", flush=True)
    ref, sref = np.load(RIG_REF_PATH), np.load(RIG_STREAM_REF_PATH)

    def start():
        slam = Slam(cfg, device="cuda")
        slam.set_base_to_lidar_offset(1, offset)
        return slam

    # ---- add_frames
    slam, results, counts, wall = start(), [], [], []

    def run_sync():
        for a in acq:
            t1 = time.perf_counter()
            results.append(slam.add_frames(a))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t1)
            counts.append(slam.match_counts.copy())

    cuda_knn.LAUNCHES = 0
    with extract_counted("rig sync", 2 * len(acq)) as extracted:
        _, shapes_run = _record_knn_calls(run_sync, keep_inputs=False)
    sync_launches = cuda_knn.LAUNCHES
    _require(sync_launches == len(shapes_run) > 0,
             f"[rig] {sync_launches} counted k-NN launches, {len(shapes_run)} seen")
    worst_ref, _ = _check_trajectory("rig sync", base, results, ref, gate_gt=False)
    _check_confidence("rig sync", results, ref)
    _check_per_type("rig sync", counts, ref)
    sync_ms = 1000 * statistics.median(wall[1:])
    sync_log = slam.get_log_memory_usage()
    merged = slam._device_keypoints
    print(f"[rig] sync: {len(acq)} acquisitions, 0 failed, {sync_launches} k-NN launches "
          f"{dict(sorted(collections.Counter(shapes_run).items()))}; median {sync_ms:.2f} "
          f"ms/acquisition; merged keypoints at frame {len(acq)}: "
          f"{[int(k.count) for k in merged]} of {[k.xyz.shape[0] for k in merged]}; "
          f"extraction kernel {_extract_line(extracted)}", flush=True)
    print(f"[rig] sync: max divergence from JAX {worst_ref[0]:.3e} m / {worst_ref[1]:.3e} "
          f"deg; n_matches (total and per type) within 1% on every frame, min "
          f"{min(r['n_matches'] for r in results[1:])} (JAX {int(ref['n_matches'][1:].min())})"
          f"; motion-limit flags equal", flush=True)
    slam = start()
    for a in acq[:PROFILED.start]:
        slam.add_frames(a)
    profiled = range(PROFILED.start, PROFILED.start + RIG_PROFILED)
    sync_prof = _profile(lambda: [slam.add_frames(acq[i]) for i in profiled], RIG_PROFILED,
                         sweeps_per_frame=2)
    print(f"[rig] sync profiled acquisitions {profiled.start}-{profiled.stop - 1}: device "
          f"busy {sync_prof['busy_ms']:.2f} ms/acquisition, {sync_prof['kernels']:.1f} "
          f"device kernels/acquisition; [time] {time.perf_counter() - t0:.1f} s into the "
          "phase", flush=True)

    # ---- add_frames_async + flush
    slam, counts = start(), []
    real = slam._log_state

    def log_state(stamp):       # flush logs each frame after its match counts
        counts.append(slam.match_counts.copy())
        real(stamp)
    slam._log_state = log_state
    cuda_knn.LAUNCHES = 0
    with extract_counted("rig stream", 2 * len(acq)) as stream_extracted:
        stream_ms, results = _stream_run_ms(slam, acq, slam.add_frames_async)
    calls = cuda_knn.LAUNCHES
    rig = slam._rig_graph
    _require(rig is not None and rig.graph is not None and rig.state is slam._graph.state,
             "[rig] the stream never captured the rig graph on the segment's state")
    _require(calls == len(RIG_CALLS) * (rig.warmup_steps + 1),
             f"[rig] {calls} k-NN wrapper calls in the stream for {rig.warmup_steps} "
             "warm-up steps and 1 capture")
    worst_sref, _ = _check_trajectory("rig stream", base, results, sref, gate_gt=False)
    _check_confidence("rig stream", results, sref)
    _check_per_type("rig stream", counts, sref)
    stream_log = slam.get_log_memory_usage()
    for tag, log in (("sync", sync_log), ("stream", stream_log)):
        _require(log["n_frames"] == len(acq) and log["device"] > 0,
                 f"[rig] the {tag} keypoint log holds {log}")
    print(f"[rig] keypoint log (LoggingStorage.DEVICE, logging_timeout -1): "
          f"{sync_log['device'] // len(acq)} B/acquisition on the sync path, "
          f"{stream_log['device'] // len(acq)} B/acquisition in the stream", flush=True)
    print(f"[rig] stream: {len(acq)} acquisitions, 0 failed, {calls} Python k-NN calls "
          f"({rig.warmup_steps} warm-up steps and 1 capture, "
          f"{len(RIG_CALLS)} each); {stream_ms:.2f} ms/acquisition over {TIMED.start}-"
          f"{TIMED.stop - 1}; max divergence from the JAX stream {worst_sref[0]:.3e} m / "
          f"{worst_sref[1]:.3e} deg; n_matches within 1% (total and per type); extraction "
          f"kernel {_extract_line(stream_extracted)}", flush=True)

    # acquisitions 0-16 through the API, 17 by hand: extraction and merge
    # eagerly, then the step eagerly under sync-debug "error" against one
    # replay of the rig graph from the same state
    slam = start()
    for a in acq[:PROFILED.start]:
        slam.add_frames_async(a)
    rig = slam._rig_graph
    a = acq[PROFILED.start]
    kps = slam._extract_merge(a, float(a[0]["stamp"]))
    rig.wire.write(rig.record, kps, float(a[0]["stamp"]))
    record = rig.record.clone()
    path_calls = []
    dt, dr, total = _replay_vs_eager("rig", rig, record, pipeline.process_keypoints_stream,
                                     cfg, slam._map_cfgs_tuple, path_calls)
    _require([c[3] for c in path_calls] == [k for _, k in RIG_CALLS],
             f"[rig] the step's k-NN calls {[(c[3], c[1].shape[0]) for c in path_calls]} "
             "are not RIG_CALLS")
    print(f"[rig] acquisition {PROFILED.start}'s step under set_sync_debug_mode('error'): no "
          f"sync; replay vs eager {dt:.3e} m / {dr:.3e} deg, matches {total}", flush=True)
    # a whole add_frames_async (upload, extraction, merge, record, replay):
    # host syncs counted, not required to be none
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            slam.add_frames_async(acq[PROFILED.start + 1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message).lower()]
    print(f"[rig] one whole add_frames_async: {len(syncs)} host syncs "
          f"{syncs[:2]}", flush=True)

    # a window of acquisitions through Slam.start_profiling / stop_profiling
    window = range(PROFILED.start + 2, PROFILED.start + 2 + RIG_PROFILED)
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        cuda_knn.reset_executions()
        cuda_extract.reset_executions()
        slam.start_profiling(d)
        for i in window:
            slam.add_frames_async(acq[i])
        path = slam.stop_profiling()
        _require(profiling.find_trace(d) == path, "[rig] stop_profiling wrote no trace")
        prof = _readings(path, RIG_PROFILED, cuda_knn.executions(),
                         cuda_extract.executions(), 2 * RIG_PROFILED)
    slam.flush()
    _require(all(n == len(RIG_CALLS) * RIG_PROFILED for n in prof["knn"].values()),
             f"[rig] k-NN executions {prof['knn']} in {RIG_PROFILED} acquisitions (expected "
             f"{len(RIG_CALLS)} per acquisition each)")
    print(f"[rig] profiled {RIG_PROFILED} acquisitions ({window.start}-{window.stop - 1}) through "
          f"Slam.start_profiling / stop_profiling, read from the trace file: k-NN "
          f"executions {prof['knn']} (device counts; traced"
          f" {prof['knn_traced']}) ({len(RIG_CALLS)} per acquisition each), extraction "
          f"kernel {prof['extract']} (traced {prof['extract_traced']}); device busy "
          f"{prof['busy_ms']:.2f} ms/acquisition, {prof['kernels']:.1f} device kernels/"
          f"acquisition (a replay per device's extraction, the merge, a replay of the "
          f"step); "
          f"k-NN {prof['knn_ms']:.4f} ms/acquisition; [time] {time.perf_counter() - t0:.1f} "
          "s into the phase", flush=True)
    print(f"[rig-stream-vs-sync] {card}: stream {stream_ms:.2f} ms/acquisition (idle share "
          f"{100 * (1 - prof['busy_ms'] / stream_ms):.1f}%), sync {sync_ms:.2f} "
          f"ms/acquisition; device busy stream {prof['busy_ms']:.2f} / sync "
          f"{sync_prof['busy_ms']:.2f} ms/acquisition; kernels/acquisition stream "
          f"{prof['kernels']:.1f} / sync {sync_prof['kernels']:.1f}", flush=True)

    shapes, seen = [], set()
    labels = [label for label, _ in RIG_CALLS]
    for (label, _), (index, q, q_valid, k, r2) in zip(RIG_CALLS, path_calls):
        if label in seen:
            continue
        seen.add(label)
        shapes.append(_path_call_case(label, labels.count(label), index, q, q_valid, k, r2,
                                      card, tag="rig"))
    return {"sync_launches": sync_launches, "stream_calls": calls,
            "stream_executions": prof["knn"], "stream_knn_ms": prof["knn_ms"],
            "sync_knn_ms": sync_prof["knn_ms"], "shapes": shapes,
            "max_abs_err": max(s_["max_abs_err"] for s_ in shapes)}


# ---------------------------------------------------------------------------
# Phase 10: the front ends (cli, server, ROS node, ParaView core)
# ---------------------------------------------------------------------------

CLI_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_cli_ref.npz"
CLI_CONFIG = ROOT / "configs" / "slam_config_outdoor.yaml"
CLI_EXTRACT = 5             # sweeps of the extract check (the reference's)
CLI_AGG_M = 1e-4            # `aggregate` against the run's aggregated.pcd [m]
CLI_TIMEOUT_S = 400         # one CLI process on the card
SERVER_SPLIT = 15           # client A streams sweeps 0-14, client B 15-29
FRONT_SWEEPS = 10           # sweeps through the sync server, the ROS node, the core
DIRECT_M = 1e-6             # a front end against a direct Slam on the same sweeps [m]


def write_cli_pcds(frames, directory, save_pcd):
    """The sweeps as the binary PCDs a user's recorder writes (intensity,
    time, laser_id), named in order: (path, sha256) of each. `save_pcd` is
    either package's `io.pcd.save_pcd`; they write the same bytes."""
    import hashlib

    out = []
    for i, f in enumerate(frames):
        path = Path(directory) / f"sweep_{i:04d}.pcd"
        save_pcd(path, f["xyz"], intensity=f["intensity"], time=f["time"],
                 laser_id=f["laser_id"])
        out.append((path, hashlib.sha256(path.read_bytes()).hexdigest()))
    return out


class GraphSteps:
    """While installed, records each step of every captured graph (the
    stream's and add_frame's, `stream_graph._Replayed._step`): the graph,
    whether the step was a
    warm-up, the capture or a replay, the thread it ran in (by name: the
    runtime reuses a finished thread's ident, never its name), and the
    k-NN and extraction wrapper calls made during it (a capture's are the
    calls its graph replays)."""

    def __init__(self):
        # (id(graph), kind, thread name, k-NN wrapper calls, extraction wrapper calls)
        self.events = []

    def __enter__(self):
        import threading

        from lidarslam_tpu_torch.ops import cuda_extract, cuda_knn, stream_graph

        step = self._step = stream_graph._Replayed._step
        events = self.events

        def recorded(graph):
            captured = graph.graph is not None
            before = cuda_knn.LAUNCHES, cuda_extract.LAUNCHES
            out = step(graph)
            kind = "replay" if captured else ("capture" if graph.graph is not None
                                              else "warm-up")
            events.append((id(graph), kind, threading.current_thread().name,
                           cuda_knn.LAUNCHES - before[0], cuda_extract.LAUNCHES - before[1]))
            return out

        stream_graph._Replayed._step = recorded
        return self

    def __exit__(self, *exc):
        from lidarslam_tpu_torch.ops import stream_graph

        stream_graph._Replayed._step = self._step

    def replayed_calls(self, kernel: str = "knn") -> int:
        """Calls of the k-NN (`kernel` "knn") or extraction ("extract")
        kernel the replays ran: each replays the calls its capture recorded
        (the capture itself replays once, its calls counted as wrapper
        calls)."""
        col = {"knn": 3, "extract": 4}[kernel]
        calls = {e[0]: e[col] for e in self.events if e[1] == "capture"}
        return sum(calls[e[0]] for e in self.events if e[1] == "replay")


EXTRACT_COUNTS = {}     # path -> the extraction kernel's counts over it (`extract_counted`)


@contextlib.contextmanager
def extract_counted(tag, sweeps, device="cuda"):
    """Hold the extraction kernel over the block, which feeds `sweeps`
    sweeps from a new Slam: it ran on `device` once per sweep, each run
    either a wrapper call made outside a graph (eagerly, in a warm-up or
    into a capture) or a graph replaying the call its capture recorded
    (`GraphSteps`). The counts (wrapper calls, replayed calls, device
    executions, sweeps) fill the yielded dict and EXTRACT_COUNTS[tag]."""
    import torch

    from lidarslam_tpu_torch.ops import cuda_extract

    torch.cuda.synchronize(device)
    cuda_extract.reset_executions(device)
    cuda_extract.LAUNCHES = 0
    n = {}
    with GraphSteps() as steps:
        yield n
    n.update(calls=cuda_extract.LAUNCHES, replayed=steps.replayed_calls("extract"),
             executions=cuda_extract.executions(device), sweeps=sweeps)
    _require(n["calls"] > 0 and n["executions"] == n["calls"] + n["replayed"] == sweeps,
             f"[{tag}] the extraction kernel: {n['calls']} wrapper calls + {n['replayed']} "
             f"replayed, {n['executions']} device executions for {sweeps} sweeps")
    EXTRACT_COUNTS[tag] = dict(n)


def _extract_line(n) -> str:
    return (f"{n['calls']} wrapper calls + {n['replayed']} replayed = {n['executions']} "
            f"device executions in {n['sweeps']} sweeps")


def _knn_counts(run):
    """Run `run()` with the k-NN counters set to 0 just before and read just
    after: (its result, wrapper calls, device executions of each kernel)."""
    import torch

    from lidarslam_tpu_torch.ops import cuda_knn

    torch.cuda.synchronize()
    cuda_knn.reset_executions()
    cuda_knn.LAUNCHES = 0
    out = run()
    torch.cuda.synchronize()
    return out, cuda_knn.LAUNCHES, cuda_knn.executions()


def _hold_executions(tag, calls, executed, replayed=0):
    """Each k-NN kernel ran once per wrapper call outside a graph, plus the
    calls the graphs replayed, and the path launched it."""
    want = calls + replayed
    _require(calls > 0 and all(n == want for n in executed.values()),
             f"[{tag}] k-NN kernel executions {executed} for {calls} wrapper calls "
             f"and {replayed} replayed calls")


def counted_cli(argv) -> int:
    """`lidarslam_tpu_torch.cli.main(argv)`, what `python -m
    lidarslam_tpu_torch.cli` runs, in this process, with the k-NN and
    extraction counters set to 0 before it and written after it, as JSON,
    to the file named by the environment's KNN_COUNTS (wrapper calls,
    device executions, and the calls the stream's graph replays ran; the
    extraction kernel's under "extract")."""
    import os

    from lidarslam_tpu_torch import cli
    from lidarslam_tpu_torch.ops import cuda_extract, cuda_knn

    cuda_knn.reset_executions()
    cuda_extract.reset_executions()
    cuda_knn.LAUNCHES = cuda_extract.LAUNCHES = 0
    with GraphSteps() as steps:
        rc = cli.main(argv)
    Path(os.environ["KNN_COUNTS"]).write_text(json.dumps({
        "calls": cuda_knn.LAUNCHES, "executions": cuda_knn.executions(),
        "replayed": steps.replayed_calls(),
        "extract": {"calls": cuda_extract.LAUNCHES, "replayed": steps.replayed_calls("extract"),
                    "executions": cuda_extract.executions()}}))
    return rc


def _cli_process(tag, argv, counts: Path, sweeps: int):
    """One CLI command over `sweeps` sweeps in its own process on the card:
    its JSON last line and its k-NN counts, held as `_hold_executions`
    holds them, and the extraction kernel's, as `extract_counted` holds
    them."""
    import os

    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            "sys.exit(chip_smoke.counted_cli(sys.argv[1:]))")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT, capture_output=True,
                       text=True, timeout=CLI_TIMEOUT_S,
                       env={**os.environ, "KNN_COUNTS": str(counts)})
    wall = time.perf_counter() - t0
    _require(r.returncode == 0, f"[{tag}] `cli {' '.join(argv)}` exited {r.returncode}:\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    n = json.loads(counts.read_text())
    _hold_executions(tag, n["calls"], n["executions"], n["replayed"])
    x = {**n["extract"], "sweeps": sweeps}
    _require(x["calls"] > 0 and x["executions"] == x["calls"] + x["replayed"] == sweeps,
             f"[{tag}] the extraction kernel: {_extract_line(x)}")
    EXTRACT_COUNTS[tag] = x
    return json.loads(r.stdout.strip().splitlines()[-1]), n, wall


def _cli_main(argv):
    """An in-process command (aggregate, extract, compare): (rc, JSON last line)."""
    import io

    from lidarslam_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _check_cli_run(tag, out: Path, ref, key, ref_dir: Path):
    """`cli compare` of a run against its JAX reference (0.01 m / 5 deg; the
    reference's times are a CPU's, so the time check is off), no failed
    frame, n_matches within 1% of JAX's on every frame."""
    import numpy as np

    from lidarslam_tpu_torch.io import csv_log

    ref_dir.mkdir()
    np.savetxt(ref_dir / "Poses.csv", ref[f"{key}_poses"], fmt="%.9f")
    rc, cmp = _cli_main(["compare", "--res", str(out), "--ref", str(ref_dir),
                         "--time-threshold", "1e9"])
    _require(rc == 0 and cmp["success"] and cmp["n_compared"] == N_FRAMES,
             f"[{tag}] compare against the JAX reference: rc {rc}, {cmp}")
    ev = csv_log.read_evaluators_csv(out / "Evaluators.csv")
    want = ref[f"{key}_n_matches"]
    _require(np.all(np.abs(ev[:, 2] - want) <= 0.01 * want),
             f"[{tag}] n_matches {ev[:, 2].astype(int).tolist()} against JAX's "
             f"{want.tolist()}")
    with open(out / "Trajectory.csv") as f:
        header = f.readline().strip().split(",")
    failed = int(np.loadtxt(out / "Trajectory.csv", delimiter=",", skiprows=1,
                            ndmin=2)[:, header.index("failure")].sum())
    _require(failed == 0 == int(ref[f"{key}_failed"]), f"[{tag}] {failed} failed frames")
    return cmp


def _check_cli_outputs(out: Path):
    """Every file of the synchronous run parses with the port's readers."""
    import numpy as np

    from lidarslam_tpu_torch.io import csv_log, export, pcd, vtp

    poses = csv_log.read_poses_csv(out / "Poses.csv")
    traj = export.read_trajectory_csv(out / "Trajectory.csv")
    _require(len(poses) == len(traj) == N_FRAMES
             and csv_log.read_evaluators_csv(out / "Evaluators.csv").shape == (N_FRAMES, 4),
             "[cli] Poses.csv / Trajectory.csv / Evaluators.csv rows")
    _require(max(abs(e["time"] - t) + float(np.abs(e["pose"] - H).max())
                 for e, (t, H) in zip(traj, poses)) < 1e-6,
             "[cli] Trajectory.csv disagrees with Poses.csv")
    _require(np.loadtxt(out / "poses_kitti.txt").shape == (N_FRAMES, 12)
             and np.loadtxt(out / "poses_tum.txt").shape == (N_FRAMES, 8),
             "[cli] KITTI / TUM pose files")
    ply = (out / "trajectory.ply").read_text().splitlines()
    end = ply.index("end_header")
    _require(ply[0] == "ply" and f"element vertex {N_FRAMES}" in ply
             and len(ply) == end + 1 + 2 * N_FRAMES - 1, "[cli] trajectory.ply")
    pts, pdata, cells = vtp.read_vtp(str(out / "trajectory.vtp"))
    _require(len(pts) == N_FRAMES and cells["lines"][1].tolist() == [N_FRAMES]
             and pdata["covariance"].shape == (N_FRAMES, 36), "[cli] trajectory.vtp")
    sizes = {}
    for name in ("edge", "plane"):
        m_xyz, m_data, m_cells = vtp.read_vtp(str(out / f"map_{name}.vtp"))
        m_pcd = pcd.load_pcd(out / f"map_{name}s.pcd")
        _require(len(m_xyz) == len(m_pcd["xyz"]) == len(m_data["Intensity"]) > 100
                 and np.abs(m_xyz - m_pcd["xyz"]).max() < 1e-4,
                 f"[cli] map_{name}.vtp against map_{name}s.pcd")
        sizes[name] = len(m_xyz)
    agg = pcd.load_pcd(out / "aggregated.pcd")
    _require(np.isfinite(agg["xyz"]).all() and {"intensity", "time", "label"} <= set(agg),
             "[cli] aggregated.pcd")
    return sizes, agg


class FakeRos:
    """A recording ROS facade (tests/test_ros_node.py's contract)."""

    def __init__(self, params):
        from lidarslam_tpu_torch.ros_node import PointCloud2, PointField

        self.cloud_cls, self.field_cls = PointCloud2, PointField
        self.params = params
        self.published, self.subscribed, self.tf = {}, {}, []

    def get_param(self, key, default=None):
        return self.params if key == "" else self.params.get(key, default)

    def now(self):
        return time.perf_counter()

    def Publisher(self, topic, kind, latch=False):
        self.published.setdefault(topic, [])
        return lambda msg, payload_cloud=None: self.published[topic].append(
            payload_cloud if payload_cloud is not None else msg)

    def Subscriber(self, topic, kind, cb):
        self.subscribed[topic] = cb

    def send_transform(self, msg):
        self.tf.append(msg)


def _within(tag, got, want, tol=DIRECT_M):
    import numpy as np

    _require(len(got) == len(want), f"[{tag}] {len(got)} poses for {len(want)}")
    err = max(float(np.abs(g[:3, 3] - w[:3, 3]).max()) for g, w in zip(got, want))
    rot = max(float(np.abs(g[:3, :3] - w[:3, :3]).max()) for g, w in zip(got, want))
    _require(err <= tol and rot <= 1e-6, f"[{tag}] {err:.3e} m / {rot:.3e} (rotation) from "
             "the direct run")
    return err


def _session_ended(slam, timeout_s=60.0):
    """Wait until the server's handler of a closed client has processed its
    `bye` (whose flush would otherwise end the next client's segment,
    ROADMAP Queue 3, F10) and dropped its subscription."""
    t_end = time.perf_counter() + timeout_s
    while slam._subscribers:
        _require(time.perf_counter() < t_end, "[server] a closed session did not end")
        time.sleep(0.01)


def _serve(slam, frames, steps):
    """Client A streams sweeps 0-14, flushes and says bye; client B, on a
    new connection, streams 15-29 and flushes, downloads the plane map,
    sends command 99 (an `error`, the session stays open), a known command
    (`ok`) and downloads the map again."""
    import numpy as np

    from lidarslam_tpu_torch.config import Keypoint
    from lidarslam_tpu_torch.server import SlamClient, SlamServer

    server = SlamServer(slam, port=0)
    server.serve_background()
    try:
        port = server.server_address[1]
        t0 = time.perf_counter()
        a = SlamClient(port=port)
        for f in frames[:SERVER_SPLIT]:
            a.send_frame(f)
        poses_a = list(a.flush())
        a.close()
        _session_ended(slam)
        n_a = len(steps.events)
        b = SlamClient(port=port)
        for f in frames[SERVER_SPLIT:]:
            b.send_frame(f)
        poses_b = list(b.flush())
        ms = 1000 * (time.perf_counter() - t0) / len(frames)
        plane_map = b.get_map(keypoint=int(Keypoint.PLANE))
        try:
            b.command(99)
            refused = None
        except RuntimeError as exc:
            refused = str(exc)
        b.command(slam.ENABLE_SLAM_MAP_UPDATE)
        again = b.get_map(keypoint=int(Keypoint.PLANE))
        b.close()
    finally:
        server.shutdown()
        server.server_close()
    _require(refused is not None and "unknown SLAM command 99" in refused,
             f"[server] command 99 answered {refused!r}")
    _require(all(np.array_equal(x, y) for x, y in zip(plane_map, again)),
             "[server] the session did not go on after the error")
    return poses_a, poses_b, plane_map, n_a, ms


def phase_frontends(card: str, frames):
    """The front ends on the card, on the 30 distorted sweeps as PCDs:
    `cli run` (sync and `--follow`, each its own process), `aggregate`,
    `extract`, `compare`; the server with two clients one after the other
    and in sync mode; the ROS node; the ParaView core. Returns the k-NN
    calls of each path and the phase's times."""
    import os
    import threading

    import numpy as np
    import yaml

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.config import Keypoint
    from lidarslam_tpu_torch.core.se3 import quat_to_matrix
    from lidarslam_tpu_torch.io import csv_log, native, pcd
    from lidarslam_tpu_torch.io.yaml_config import load_config
    from lidarslam_tpu_torch.ops import stream_graph
    from lidarslam_tpu_torch.paraview_plugin import SlamFilterCore, arrays_to_frame
    from lidarslam_tpu_torch.ros_node import LidarSlamNode, frame_to_cloud

    ref = np.load(CLI_REF_PATH)
    _require(str(ref["ingest"]) == "native" and native.available(),
             "[cli] the reference and the port both take the native ingest")
    cfg = load_config(str(CLI_CONFIG))
    launches, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "pcd").mkdir()
        (tmp / "first").mkdir()
        pcds = write_cli_pcds(frames, tmp / "pcd", pcd.save_pcd)
        got_hash = [h for _, h in pcds]
        _require(got_hash == [str(h) for h in ref["pcd_sha256"]],
                 "[cli] the sweeps' PCDs are not the reference's: the renderer or the "
                 "PCD writer moved")
        for src, _ in pcds[:CLI_EXTRACT]:
            os.link(src, tmp / "first" / src.name)

        # ---- cli run, synchronous, in its own process on the card
        out = tmp / "sync"
        info, n, wall = _cli_process(
            "cli run", ["run", "--config", str(CLI_CONFIG), "--pcd-dir", str(tmp / "pcd"),
                        "--out", str(out), "--log-dir", str(out / "log"), "--aggregate",
                        "--vtp", "--save-maps"], tmp / "sync_counts.json", len(pcds))
        launches["cli run (sync)"] = n["calls"]
        times["cli_sync_ms"] = info["mean_frame_ms"]
        times["cli_sync_wall_s"] = wall
        cmp = _check_cli_run("cli run", out, ref, "sync", tmp / "ref_sync")
        sizes, agg = _check_cli_outputs(out)
        _require(info["aggregated_points"] == len(agg["xyz"]) == int(ref["aggregated_points"]),
                 f"[cli] aggregated {info['aggregated_points']} / {len(agg['xyz'])} points, "
                 f"JAX {int(ref['aggregated_points'])}")
        print(f"[cli] run --config {CLI_CONFIG.name} on {N_FRAMES} PCD sweeps ({card}): "
              f"mean_frame_ms {info['mean_frame_ms']} (the run's own), process {wall:.1f} s; "
              f"{cmp['max_position_error_m']} m / {cmp['max_angle_error_deg']} deg from JAX "
              f"(compare), 0 failed; k-NN {n['calls']} wrapper calls = device executions "
              f"{n['executions']}; maps {sizes}, aggregated {len(agg['xyz'])} points "
              "(= JAX's); every output file parsed", flush=True)

        # ---- the same run on the CPU (`--cpu`, in this process): the card's
        # divergence from the CPU's on the same PCDs, beside each one's from JAX
        t1 = time.perf_counter()
        rc, cinfo = _cli_main(["--cpu", "run", "--config", str(CLI_CONFIG), "--pcd-dir",
                               str(tmp / "pcd"), "--out", str(tmp / "cpu")])
        cpu_wall = time.perf_counter() - t1
        _require(rc == 0 and cinfo["frames"] == N_FRAMES, f"[cli] --cpu run: rc {rc}, {cinfo}")
        rc, vs_cpu = _cli_main(["compare", "--res", str(out), "--ref", str(tmp / "cpu"),
                                "--time-threshold", "1e9"])
        _require(rc == 0 and vs_cpu["success"], f"[cli] card against --cpu: rc {rc}, {vs_cpu}")
        rc, cpu_jax = _cli_main(["compare", "--res", str(tmp / "cpu"), "--ref",
                                 str(tmp / "ref_sync"), "--time-threshold", "1e9"])
        _require(rc == 0 and cpu_jax["success"], f"[cli] --cpu against JAX: rc {rc}, {cpu_jax}")
        gap = [float(np.linalg.norm(a[1][:3, 3] - b[1][:3, 3])) for a, b in zip(
            csv_log.read_poses_csv(out / "Poses.csv"),
            csv_log.read_poses_csv(tmp / "cpu" / "Poses.csv"))]
        times["cli_card_vs_cpu_m"] = vs_cpu["max_position_error_m"]
        times["cli_cpu_vs_jax_m"] = cpu_jax["max_position_error_m"]
        print(f"[cli] the same run with --cpu ({cpu_wall:.1f} s in this process): card "
              f"{vs_cpu['max_position_error_m']} m / {vs_cpu['max_angle_error_deg']} deg from "
              f"the CPU (compare), CPU {cpu_jax['max_position_error_m']} m / "
              f"{cpu_jax['max_angle_error_deg']} deg from JAX, card "
              f"{cmp['max_position_error_m']} m from JAX; card-CPU position gap (norm) at "
              f"sweeps 0/9/19/29 {[f'{gap[i]:.2e}' for i in (0, 9, 19, 29)]}, largest "
              f"{max(gap):.3e} m at sweep {int(np.argmax(gap))} ({card})", flush=True)

        # ---- cli run --follow: the stream and the subscription
        fol = tmp / "follow"
        finfo, fn, fwall = _cli_process(
            "cli run --follow", ["run", "--config", str(CLI_CONFIG), "--pcd-dir",
                                 str(tmp / "pcd"), "--out", str(fol), "--follow"],
            tmp / "follow_counts.json", len(pcds))
        launches["cli run --follow (Python calls)"] = fn["calls"]
        times["cli_follow_ms"] = finfo["mean_frame_ms"]
        fcmp = _check_cli_run("cli run --follow", fol, ref, "follow", tmp / "ref_follow")
        print(f"[cli] run --follow: mean_frame_ms {finfo['mean_frame_ms']} (host clock over "
              f"the stream, flushes every 16), process {fwall:.1f} s; "
              f"{fcmp['max_position_error_m']} m / {fcmp['max_angle_error_deg']} deg from "
              f"JAX's --follow, 0 failed; k-NN {fn['calls']} wrapper calls + "
              f"{fn['replayed']} replayed = device executions {fn['executions']}", flush=True)

        # ---- aggregate and extract (in this process)
        rc, ag = _cli_main(["aggregate", "--log-dir", str(out / "log"), "--trajectory",
                            str(out / "Trajectory.csv"), "--out", str(tmp / "agg.pcd")])
        off = pcd.load_pcd(tmp / "agg.pcd")
        _require(rc == 0 and ag["points"] == len(off["xyz"]) == len(agg["xyz"])
                 == int(ref["aggregate_points"]),
                 f"[cli] aggregate: {ag} against {len(agg['xyz'])} / JAX "
                 f"{int(ref['aggregate_points'])}")
        agg_err = float(np.abs(off["xyz"].astype(np.float64) - agg["xyz"]).max())
        _require(agg_err <= CLI_AGG_M and np.array_equal(off["label"], agg["label"]),
                 f"[cli] aggregate {agg_err:.3e} m from the run's aggregated.pcd")
        with extract_counted("cli extract", CLI_EXTRACT):
            _, ext = _cli_main(["extract", "--config", str(CLI_CONFIG), "--pcd-dir",
                                str(tmp / "first"), "--out", str(tmp / "ext"), "--blobs"])
        summary = json.loads((tmp / "ext" / "extraction.json").read_text())
        counts = np.asarray([[s["edge"], s["plane"], s["blob"]] for s in summary])
        az = np.asarray([s["azimuthal_resolution"] for s in summary])
        _require(ext["frames"] == CLI_EXTRACT and np.array_equal(counts, ref["extract_counts"])
                 and np.abs(az - ref["extract_az"]).max() <= 1e-6,
                 f"[cli] extract {counts.tolist()} / {az.tolist()} against JAX's "
                 f"{ref['extract_counts'].tolist()} / {ref['extract_az'].tolist()}")
        print(f"[cli] aggregate: {ag['points']} points (= JAX's), {agg_err:.3e} m from the "
              f"run's aggregated.pcd point for point; extract on {CLI_EXTRACT} sweeps: "
              f"edge/plane/blob {counts.tolist()} (= JAX's), azimuthal resolution within "
              f"{np.abs(az - ref['extract_az']).max():.1e}", flush=True)

    # ---- direct runs on the card, before the server (never during it)
    def stream_direct():
        s = Slam(cfg, device="cuda")
        for f in frames[:SERVER_SPLIT]:
            s.add_frame_async(f)
        outs = s.flush()
        for f in frames[SERVER_SPLIT:]:
            s.add_frame_async(f)
        outs += s.flush()
        return [o["pose"] for o in outs], s.get_map_points(Keypoint.PLANE)

    def sync_direct(items, record_at=None):
        """Poses of a sync run; with `record_at`, also that sweep's k-NN
        calls with their inputs (`_record_knn_calls`)."""
        s = Slam(cfg, device="cuda")
        poses, calls = [], []
        for i, f in enumerate(items):
            if i == record_at:
                out, calls = _record_knn_calls(lambda: s.add_frame(f))
            else:
                out = s.add_frame(f)
            poses.append(out["pose"])
        return poses, calls

    direct_stream, direct_map = stream_direct()
    head = frames[:FRONT_SWEEPS]
    # the last warm-up step of the live graph: the calls its replays run
    direct_sync, path_calls = sync_direct(head, record_at=stream_graph.WARMUP_STEPS)
    vendor = [(f["xyz"], (np.asarray(f["time"], np.float64) + f["stamp"]) * 1e6,
               f["intensity"], f["laser_id"]) for f in head]
    direct_pv, _ = sync_direct([arrays_to_frame(*a, time_factor=1e-6) for a in vendor])

    # ---- the preset's own k-NN calls (one sweep of the sync path, the last
    # of `head`): every call held against plain_knn, each shape timed
    labels = [f"outdoor: Q={q.shape[0]} k={k} vs {index.pts.shape[0]} slots"
              + ("" if r2 == float("inf") else f", r={r2 ** 0.5:g} m")
              for index, q, _, k, r2 in path_calls]
    _require(len(path_calls) > 0, "[cli] the recorded sweep made no k-NN call")
    shapes, seen = [], set()
    for label, call in zip(labels, path_calls):
        if label in seen:
            _hold_call(label, *call, tag="cli")
            continue
        seen.add(label)
        shapes.append(_path_call_case(label, labels.count(label), *call, card, tag="cli"))
    del path_calls

    # ---- the server: the stream across two clients
    main_thread = threading.current_thread().name
    with extract_counted("server stream", len(frames)), GraphSteps() as steps:
        (poses_a, poses_b, plane_map, n_a, server_ms), calls, executed = _knn_counts(
            lambda: _serve(Slam(cfg, device="cuda"), frames, steps))
    launches["server stream (Python calls)"] = calls
    times["server_ms"] = server_ms
    _hold_executions("server", calls, executed, steps.replayed_calls())
    ev_a, ev_b = steps.events[:n_a], steps.events[n_a:]
    threads_a, threads_b = {e[2] for e in ev_a}, {e[2] for e in ev_b}
    _require([e[1] for e in ev_a].count("capture") == 1
             and all(e[1] != "capture" for e in ev_b)
             and any(e[1] == "replay" for e in ev_b)
             and len(threads_a) == len(threads_b) == 1 and threads_a != threads_b
             and main_thread not in threads_a | threads_b,
             f"[server] the graph was not captured in client A's handler thread and "
             f"replayed in client B's: {[e[1:3] for e in steps.events]}")
    got = [np.asarray(m["pose"]).reshape(4, 4) for m in poses_a + poses_b]
    _require([m["frame_index"] for m in poses_a + poses_b] == list(range(N_FRAMES)),
             "[server] frame indices")
    stream_err = _within("server stream", got, direct_stream)
    jax_err = max(pose_errors(g, _ref_pose(ref["follow_poses"][i]))[0]
                  for i, g in enumerate(got))
    _require(jax_err <= REF_TOL_M, f"[server] {jax_err:.3e} m from JAX's --follow")
    _require(all(np.array_equal(a, b) for a, b in zip(plane_map, direct_map[:2])),
             "[server] get_map(planes) is not the direct run's get_map_points(PLANE)")
    print(f"[server] two clients streamed {SERVER_SPLIT} + {N_FRAMES - SERVER_SPLIT} sweeps "
          f"({card}): {server_ms:.2f} ms/frame (host clock, both clients' sends and "
          f"flushes); graph captured in A's handler thread ({min(threads_a)}), replayed "
          f"{sum(e[1] == 'replay' for e in ev_b)} times in B's ({min(threads_b)}); "
          f"{stream_err:.3e} m from a "
          f"direct stream with the same flushes, {jax_err:.3e} m from JAX's --follow; "
          f"plane map {len(plane_map[0])} points = the direct run's; command 99 -> error, "
          f"session open; k-NN {calls} wrapper calls + {steps.replayed_calls()} replayed = "
          f"device executions {executed}", flush=True)

    # ---- the server in sync mode
    def serve_sync():
        from lidarslam_tpu_torch.server import SlamClient, SlamServer

        server = SlamServer(Slam(cfg, device="cuda"), port=0, stream=False)
        server.serve_background()
        try:
            c = SlamClient(port=server.server_address[1])
            for f in head:
                c.send_frame(f)
            msgs = list(c.flush())
            c.close()
        finally:
            server.shutdown()
            server.server_close()
        return [np.asarray(m["pose"]).reshape(4, 4) for m in msgs]

    with extract_counted("server sync", len(head)), GraphSteps() as steps:
        got, calls, executed = _knn_counts(serve_sync)
    launches["server sync"] = calls
    _hold_executions("server sync", calls, executed, steps.replayed_calls())
    sync_err = _within("server sync", got, direct_sync)

    # ---- the ROS node (its Slam built from the yaml tree, on the card)
    params = yaml.safe_load(CLI_CONFIG.read_text())

    def ros_drive():
        ros = FakeRos(params)
        node = LidarSlamNode(ros)
        _require(node.slam.device.type == "cuda", "[ros] the node's Slam is not on the card")
        for f in head:
            ros.subscribed["lidar_points"](frame_to_cloud(
                f["xyz"], intensity=f["intensity"], time=f["time"], laser_id=f["laser_id"],
                stamp=f["stamp"]))
        return ros

    with extract_counted("ros node", len(head)), GraphSteps() as steps:
        ros, calls, executed = _knn_counts(ros_drive)
    launches["ros node"] = calls
    _hold_executions("ros node", calls, executed, steps.replayed_calls())
    odoms = []
    for m in ros.published["slam_odom"]:
        p, o = m["pose"]["pose"]["position"], m["pose"]["pose"]["orientation"]
        H = np.eye(4)
        H[:3, :3] = quat_to_matrix(np.asarray([o["w"], o["x"], o["y"], o["z"]]))
        H[:3, 3] = [p["x"], p["y"], p["z"]]
        odoms.append(H)
    ros_err = _within("ros node", odoms, direct_sync)
    _require(len(ros.tf) == FRONT_SWEEPS and len(ros.published["maps/planes"]) == FRONT_SWEEPS,
             "[ros] TF and map topics")

    # ---- the ParaView core
    def pv_drive():
        core = SlamFilterCore(slam=Slam(cfg, device="cuda"))
        core.identify(["adjustedtime", "intensity", "laser_id"])
        for a in vendor:
            out = core.process(*a)
        return out["trajectory"]

    with extract_counted("paraview core", len(vendor)), GraphSteps() as steps:
        traj, calls, executed = _knn_counts(pv_drive)
    launches["paraview core"] = calls
    _hold_executions("paraview core", calls, executed, steps.replayed_calls())
    pv = []
    for p, q in zip(traj["points"], traj["Orientation(Quaternion)"]):
        H = np.eye(4)
        H[:3, :3], H[:3, 3] = quat_to_matrix(q), p
        pv.append(H)
    pv_err = _within("paraview core", pv, direct_pv)
    print(f"[front ends] {FRONT_SWEEPS} sweeps each, against direct sync runs on the same "
          f"sweeps: server sync {sync_err:.3e} m, ROS node (PointCloud2 wire, its own "
          f"Slam from the yaml tree) {ros_err:.3e} m, ParaView core (Velodyne arrays) "
          f"{pv_err:.3e} m; k-NN wrapper calls = device executions on each", flush=True)
    return {"launches": launches, "times": times, "shapes": shapes,
            "max_abs_err": max(s_["max_abs_err"] for s_ in shapes)}


MESH_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_mesh_ref.npz"
MESH_GLOO_WORLD = 2         # gloo ranks sharing cuda:0 (NCCL refuses two on one card)
MESH_FRAMES = 30            # bench sweeps per mode
MESH_RIG_ACQ = 10           # rig acquisitions on the mesh
MESH_TIMEOUT_S = 900        # one launch of phase 11's ranks
MESH_TOL_M, MESH_TOL_RAD = 1e-3, 0.01
MESH_PGO_REL = 1e-10        # the sharded Schur against the unsharded one
MESH_MODES = (("kp", {}), ("ext", {"shard_extraction": True}), ("maps", {"shard_maps": True}))
MESH_MAP_BATCHES = ((20000, 0), (20000, 1), (20000, 2))   # seeded points per insert


def _mesh_map_ops(mesh):
    """Insert, k-NN and a migrating roll on the slab-sharded map against the
    port's single-device map, on the card, on seeded points in a 65,536-slot
    window: returns (contents equal, k-NN d2 equal, roll contents equal,
    the number of points that changed slab in the roll)."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch.config import MapConfig
    from lidarslam_tpu_torch.ops import voxel_map
    from lidarslam_tpu_torch.parallel import sharded_map

    cfg = MapConfig(leaf_size=0.3, voxel_resolution=3.0, grid_size=16, capacity=1 << 16)
    dev = mesh.device
    local = sharded_map.empty_slab(cfg, mesh.size, dev)
    single = voxel_map.VoxelMap.empty(cfg, dev)
    half = voxel_map.half_extent(cfg)
    for n, seed in MESH_MAP_BATCHES:
        rng = np.random.default_rng(seed)
        xyz = torch.from_numpy(rng.uniform(-half, half, (n, 3)).astype(np.float32)).to(dev)
        inten = torch.from_numpy(rng.uniform(0, 100, n).astype(np.float32)).to(dev)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        local = sharded_map.add_points_sharded(mesh, local, xyz, inten, float(seed), ones,
                                               float(seed), cfg)
        single = voxel_map.add_points(single, xyz, inten, float(seed), ones, float(seed), cfg)

    def content(m):
        v = m.valid.cpu().numpy()
        a = np.concatenate([m.xyz.cpu().numpy()[v], m.intensity.cpu().numpy()[v, None],
                            m.count.cpu().numpy()[v, None].astype(np.float32)], axis=1)
        return a[np.lexsort(a.T[::-1])]

    same_insert = np.array_equal(content(sharded_map.gather_slabs(mesh, local)),
                                 content(single))
    q = torch.from_numpy(np.random.default_rng(9).uniform(
        -half / 2, half / 2, (4096, 3)).astype(np.float32)).to(dev)
    d2, _, _ = sharded_map.knn_sharded(mesh, local, q, 5, cfg)
    d2_single, _, _ = voxel_map.brute_knn(
        voxel_map.SubmapView(xyz=single.xyz, ring=None, valid=single.valid), q, 5)
    offset = torch.tensor([2, 1, 0], dtype=torch.int32, device=dev)
    kx0, _, _ = voxel_map._leaf_keys(local.xyz, local.valid, cfg)
    rolled = sharded_map.roll_sharded(mesh, local, offset, cfg)
    moved = int(mesh.psum(torch.sum(
        local.valid & (sharded_map.owner_of(kx0 - 2 * 10, cfg, mesh.size) != mesh.rank)
        & (kx0 - 2 * 10 >= 0))))
    same_roll = np.array_equal(content(sharded_map.gather_slabs(mesh, rolled)),
                               content(voxel_map.roll_by_offset(single, offset, cfg)))
    return {"insert": bool(same_insert), "knn": bool(torch.equal(d2, d2_single)),
            "roll": bool(same_roll), "migrated": moved,
            "points": int(single.valid.sum())}


def _mesh_drive(slam, frames, add="add_frame", record_at=None, keep_inputs=False):
    """`frames` through `slam.<add>` with a device sync after each: results,
    the median ms of the frames after the first, and the k-NN calls of frame
    `record_at` with their sites (`_record_knn_calls`; [] when None)."""
    import torch

    results, wall, calls = [], [], []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        if i == record_at:
            r, calls = _record_knn_calls(lambda: getattr(slam, add)(f),
                                         keep_inputs=keep_inputs, site=True)
        else:
            r = getattr(slam, add)(f)
        results.append(r)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return results, 1000 * statistics.median(wall[1:]), calls


def _mesh_call_cases(recorded, card):
    """Each distinct k-NN call shape of the recorded mesh drives ((drive,
    calls) pairs from `_mesh_drive` with inputs) held against plain_knn on
    the path's inputs, timed and bounded (`_path_call_case`), with the
    drives that gave it."""
    seen = {}
    for drive, calls in recorded:
        for site, index, q, q_valid, k, r2 in calls:
            label = (f"{site} Q={q.shape[0]} k={k} slots={index.pts.shape[0]}"
                     + ("" if r2 == float("inf") else f" r={r2 ** 0.5:g} m"))
            entry = seen.setdefault(label, {"drives": {}, "call": (index, q, q_valid, k, r2)})
            entry["drives"][drive] = entry["drives"].get(drive, 0) + 1
    shapes = []
    for label, entry in seen.items():
        per_frame = next(iter(entry["drives"].values()))
        case = _path_call_case(f"{label} ({', '.join(entry['drives'])})", per_frame,
                               *entry["call"], card, tag="mesh")
        shapes.append({**case, "drives": entry["drives"]})
    return shapes


def _mesh_record(results, ms):
    import numpy as np

    return {"poses": np.stack([r["pose"] for r in results]),
            "n_matches": [int(r["n_matches"]) for r in results],
            "overlap": [float(r["overlap"]) for r in results],
            "failed": sum(bool(r["failure"]) for r in results), "ms_frame": ms}


MESH_STREAM_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_mesh_stream_ref.npz"
MESH_STREAM_MODES = (("kp", {}), ("ext", {"shard_extraction": True}),
                     ("maps", {"shard_maps": True}))


def _mesh_stream_executions(cfg, kw) -> int:
    """Executions of each k-NN kernel in one streamed bench frame on a rank:
    one localization call per type with `reuse_knn`; `shard_maps` runs
    without it (`_without_reuse`), so one per type in each ICP round."""
    rounds = cfg.localization_icp_max_iter if kw.get("shard_maps") else 1
    return len(cfg.used_types) * rounds


def _mesh_graph_stream(mesh, name, kw, frames, card):
    """The bench stream on an NCCL mesh in mode `name` through the captured
    graph (one replay of the rank's SPMD step per sweep): timed by
    `_stream_run_ms` over frames TIMED, the frames after them under
    torch.profiler on rank 0 (device busy and each k-NN kernel's executions
    per replay, from the same stream as the time, so the idle share reads
    one stream's own level), then one replay from the stream's last state
    against the eager step under set_sync_debug_mode("error"), bit for bit;
    and its first window eagerly (capture off). Returns plain values."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.ops import cuda_knn
    from lidarslam_tpu_torch.ops.frame import build_range_image, flatten_packed

    tag = f"mesh nccl x{mesh.size} stream {name}"
    cfg = bench_config(16, 1800)
    slam = Slam(cfg, mesh=mesh, **kw)
    torch.cuda.synchronize()
    cuda_knn.LAUNCHES = 0
    cuda_knn.reset_executions(mesh.device)
    prof, calls, executed, n_tail = [], [], [], len(frames) - TIMED.stop

    def tail(fn):   # the profiled frames: their launches are not the stream's
        calls.append(cuda_knn.LAUNCHES)
        executed.append(cuda_knn.executions(mesh.device))
        if mesh.rank != 0:
            return fn()
        prof.append(_profile(fn, n_tail))
    with extract_counted(f"{tag} (graph)", len(frames), mesh.device):
        ms, outs = _stream_run_ms(slam, frames, tail=tail)
    g = slam._graph
    _require(g is not None and g.graph is not None and g.mesh is mesh,
             f"[{tag}] the stream replayed no CUDA graph")
    want = _mesh_stream_executions(cfg, kw)
    _require(not prof or all(n == want * n_tail for n in prof[0]["knn"].values()),
             f"[{tag}] k-NN kernel executions {prof and prof[0]['knn']} in {n_tail} "
             f"replays (expected {want} each a frame)")
    f = frames[-1]
    host = build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                             cfg.extractor.n_rings, cfg.extractor.max_ring_points,
                             packed=True, device=False)
    record = g.wire.pack([flatten_packed(host, g.wire.capacity)],
                         [np.float32(f["stamp"])]).to(mesh.device)[0]
    dt, dr, total = _replay_vs_eager(tag, g, record, g._step_fn, cfg, slam._map_cfgs_tuple,
                                     exact=True)
    # the same stream eagerly over its first window: frame 0, then 8 sweeps
    eager = Slam(cfg, mesh=mesh, **kw)
    eager._stream_captured = lambda: False
    with extract_counted(f"{tag} (eager)", WINDOW + 1, mesh.device):
        for f in frames[:WINDOW + 1]:
            eager.add_frame_async(f)
        outs_eager = eager.flush()
    _require(eager._graph is None, f"[{tag}] the eager stream captured a graph")
    return {**_mesh_record(outs, ms), "eager": _mesh_record(outs_eager, None),
            "calls": calls[0], "executions": executed[0], "replay_vs_eager": (dt, dr, total),
            "profile": prof[0] if prof else None, "profiled": n_tail}


def _mesh_rig_stream(mesh, acq, offset):
    """The rig's acquisitions through `add_frames_async` + `flush` with
    `shard_maps` on an NCCL mesh: replayed (one extraction graph per device
    and the rig's step graph) and eagerly (capture off)."""
    from lidarslam_tpu_torch import Slam

    out = {}
    for captured in (True, False):
        slam = Slam(rig_config(), mesh=mesh, shard_maps=True)
        slam.set_base_to_lidar_offset(1, offset)
        if not captured:
            slam._stream_captured = lambda: False
        with extract_counted(f"mesh {mesh.backend} x{mesh.size} rig stream "
                             f"({'graph' if captured else 'eager'})", 2 * len(acq), mesh.device):
            for a in acq:
                slam.add_frames_async(a)
            outs = slam.flush()
        rig = slam._rig_graph
        _require((rig is not None and rig.graph is not None) == captured,
                 f"[mesh nccl rig stream] captured={captured}, the rig graph {rig}")
        out["graph" if captured else "eager"] = _mesh_record(outs, None)
    return out


def _mesh_rank(mesh, frames_path: str, n_frames: int, card: str):
    """Phase 11 on one rank: the gloo group runs everything below, the NCCL
    group the bench drive with `shard_maps`. Returns plain values. Each
    drive records the k-NN calls of frame PROFILED.start (its inputs on rank
    0), and rank 0 holds each call shape of its group's drives against the
    plain version on those inputs, times it and bounds it."""
    import pickle

    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.backend.posegraph_device import optimize_pose_graph_device
    from lidarslam_tpu_torch.ops import cuda_knn

    gloo = mesh.backend == "gloo"
    group = f"{mesh.backend} x{mesh.size}"
    print(f"[mesh] {mesh.backend} rank {mesh.rank} of {mesh.size} on {mesh.device} "
          f"({torch.cuda.get_device_name(mesh.device)})", flush=True)
    with open(frames_path, "rb") as fh:
        data = pickle.load(fh)
    # the extraction kernel's counts of this rank's drives, each held here
    out = {"device": str(mesh.device), "extract": EXTRACT_COUNTS}
    recorded = []
    keep = mesh.rank == 0
    if gloo:
        out["map_ops"] = _mesh_map_ops(mesh)
    with numpy_ingest():
        for name, kw in (MESH_MODES if gloo else MESH_MODES[2:]):
            slam = Slam(bench_config(16, 1800), mesh=mesh, **kw)
            torch.cuda.synchronize()
            cuda_knn.LAUNCHES = 0
            cuda_knn.reset_executions(mesh.device)
            with extract_counted(f"mesh {group} bench {name}", n_frames, mesh.device):
                res, ms, calls = _mesh_drive(slam, data["bench"][:n_frames],
                                             record_at=PROFILED.start, keep_inputs=keep)
            out[name] = {**_mesh_record(res, ms), "launches": cuda_knn.LAUNCHES,
                         "executions": cuda_knn.executions(mesh.device)}
            recorded.append((f"{group} bench {name}", calls))
            if mesh.rank == 0:
                print(f"[mesh] {group} bench {name}: {ms:.2f} ms/frame, "
                      f"{cuda_knn.LAUNCHES} k-NN wrapper calls ({card})", flush=True)
        if not gloo:
            out["streams"] = {name: _mesh_graph_stream(mesh, name, kw, data["bench"], card)
                              for name, kw in MESH_STREAM_MODES}
        else:   # keypoint-sharded timed over the 30 sweeps, the other modes over a window
            out["streams"] = {}
            for name, kw in MESH_STREAM_MODES:
                slam = Slam(bench_config(16, 1800), mesh=mesh, **kw)
                drive = data["bench"] if name == "kp" else data["bench"][:WINDOW + 1]
                with extract_counted(f"mesh {group} stream {name}", len(drive), mesh.device):
                    if name == "kp":
                        ms, outs = _stream_run_ms(slam, drive)
                    else:
                        ms = None
                        for f in drive:
                            slam.add_frame_async(f)
                        outs = slam.flush()
                _require(slam._graph is None, f"[mesh gloo stream {name}] captured a graph")
                out["streams"][name] = _mesh_record(outs, ms)
    acq, offset = render_rig(MESH_RIG_ACQ)
    if not gloo:
        out["rig_stream"] = _mesh_rig_stream(mesh, acq, offset)
        if keep:
            out["shapes"] = _mesh_call_cases(recorded, card)
        return out
    with numpy_ingest():
        slam = Slam(full_config(), mesh=mesh, shard_maps=True)
        with extract_counted(f"mesh {group} full maps", len(data["full"]), mesh.device):
            results, ms, calls = _mesh_drive(slam, data["full"], record_at=PROFILED.start,
                                             keep_inputs=keep)
        out["full"] = _mesh_record(results, ms)
        recorded.append((f"{group} full maps", calls))
    slam = Slam(rig_config(), mesh=mesh, shard_maps=True)
    slam.set_base_to_lidar_offset(1, offset)
    with extract_counted(f"mesh {group} rig", 2 * len(acq), mesh.device):
        res, ms, _ = _mesh_drive(slam, acq, add="add_frames")
    out["rig"] = _mesh_record(res, ms)

    poses, times, covs, gps, gps_t, _ = pgo_graph(PGO_POSES)

    def solve(m):
        opt, _ = optimize_pose_graph_device(poses, times, covs, gps, gps_t,
                                            n_segments=PGO_SEGMENTS, device=mesh.device, mesh=m)
        return np.stack(opt)

    out["pgo_ms"], sharded_x = _wall_median_ms(lambda: solve(mesh), reps=3)
    if mesh.rank != 0:
        return out
    out["pgo_unsharded_ms"], x = _wall_median_ms(lambda: solve(None), reps=3)
    out["pgo_rel"] = float(np.abs(sharded_x - x).max() / np.abs(x).max())
    out["shapes"] = _mesh_call_cases(recorded, card)
    return out


def _without_reuse(cfg):
    """`cfg` with the localization's `reuse_knn` off: the slab-sharded maps'
    k-NN merges every slab's candidates in each ICP round, so the JAX
    package (and the port) turn reuse off there (`ops/icp.py`), and a
    `shard_maps` run is held against a single-device run without it."""
    import dataclasses

    return dataclasses.replace(cfg, loc_matching=dataclasses.replace(cfg.loc_matching,
                                                                     reuse_knn=False))


def _single_run(cfg, frames):
    """One single-device `add_frame` run on the card, on the numpy ingest:
    its poses."""
    import numpy as np

    from lidarslam_tpu_torch import Slam

    with numpy_ingest():
        slam = Slam(cfg, device="cuda")
        return np.stack([slam.add_frame(f)["pose"] for f in frames])


def _mesh_check_poses(tag, poses, want, what):
    """Every pose within MESH_TOL_M / MESH_TOL_RAD of `want`; the worst."""
    import numpy as np

    errs = [pose_errors(a, b) for a, b in zip(poses, want)]
    worst = (max(e[0] for e in errs), max(e[1] for e in errs))
    _require(len(errs) == len(want) and worst[0] <= MESH_TOL_M
             and np.deg2rad(worst[1]) <= MESH_TOL_RAD,
             f"[{tag}] {worst[0]:.3e} m / {worst[1]:.3e} deg from {what}")
    return worst


def _mesh_ranks_equal(tag, ranks, key):
    import numpy as np

    for r in ranks[1:]:
        _require(np.array_equal(r[key]["poses"], ranks[0][key]["poses"]),
                 f"[{tag}] {key}: the ranks' poses differ")


def phase_mesh(card: str, frames, distorted, sync: dict, full: dict, stream_ms: float):
    """The mesh on the card (see the module docstring, phase 11): a gloo
    group of MESH_GLOO_WORLD ranks sharing cuda:0 and an NCCL group at
    min(device_count, 4), each started by `parallel.launch`."""
    import pickle

    import numpy as np
    import torch

    from lidarslam_tpu_torch.parallel.launch import launch

    ref = np.load(MESH_REF_PATH)
    _require(int(ref["mesh_devices"]) == MESH_GLOO_WORLD,
             f"{MESH_REF_PATH.name} was made on {int(ref['mesh_devices'])} devices")
    n = MESH_FRAMES
    single = np.stack([r["pose"] for r in sync["results"]])
    full_single = np.stack([r["pose"] for r in full["sync_results"]])
    t0 = time.perf_counter()
    no_reuse = _single_run(_without_reuse(bench_config(16, 1800)), frames[:n])
    full_no_reuse = _single_run(_without_reuse(full_config()), distorted)
    print(f"[mesh] single-device runs without reuse_knn (what shard_maps runs): bench "
          f"{_max_position_diff(no_reuse, single[:n]):.3e} m and full "
          f"{_max_position_diff(full_no_reuse, full_single):.3e} m from phases 4 and 6; "
          f"JAX's own mesh run with shard_maps is "
          f"{_max_position_diff(ref['bench_maps_poses'], np.load(REF_PATH)['poses']):.3e} / "
          f"{_max_position_diff(ref['full_maps_poses'], np.load(FULL_REF_PATH)['poses']):.3e} "
          f"m from its single-device references ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "frames.pkl"
        with open(path, "wb") as fh:
            pickle.dump({"bench": frames, "full": distorted}, fh)
        t0 = time.perf_counter()
        gloo = launch(_mesh_rank, MESH_GLOO_WORLD, backend="gloo", device="cuda:0",
                      timeout_s=MESH_TIMEOUT_S, args=(str(path), n, card))
        t_gloo = time.perf_counter() - t0
        world = min(torch.cuda.device_count(), 4)
        t0 = time.perf_counter()
        nccl = launch(_mesh_rank, world, backend="nccl", timeout_s=MESH_TIMEOUT_S,
                      args=(str(path), n, card))
        t_nccl = time.perf_counter() - t0
    print(f"[mesh] gloo: {MESH_GLOO_WORLD} ranks on {[r['device'] for r in gloo]} "
          f"({t_gloo:.1f} s with start-up); nccl: {world} rank(s) on "
          f"{[r['device'] for r in nccl]} ({t_nccl:.1f} s); {n} bench sweeps a mode "
          f"({card}; gloo collectives are host-staged on one card, not NCCL over NVLink)",
          flush=True)

    g0 = gloo[0]
    for r in (g0, nccl[0]):     # each rank held its own counts
        EXTRACT_COUNTS.update((k, v) for k, v in r["extract"].items() if k.startswith("mesh"))
    m = g0["map_ops"]
    _require(all(r["map_ops"] == m for r in gloo) and m["insert"] and m["knn"] and m["roll"]
             and m["migrated"] > 0,
             f"[mesh] map operations at world 2 differ from the single-device map: {m}")
    print(f"[mesh] map at world 2 on the card: {m['points']} points; insert, k-NN (Q=4096 "
          f"k=5) and a roll migrating {m['migrated']} points equal the single-device "
          "map's", flush=True)
    rows = {}
    for group, ranks in (("gloo", gloo), ("nccl", nccl)):
        for name, _ in (MESH_MODES if group == "gloo" else MESH_MODES[2:]):
            tag = f"mesh {group} {name}"
            got = ranks[0][name]
            _require(got["failed"] == 0, f"[{tag}] {got['failed']} failed frames")
            _mesh_ranks_equal(tag, ranks, name)
            # shard_maps against the single-device run of its own algorithm
            base, what = (no_reuse, "the single-device run without reuse_knn") \
                if name == "maps" else (single[:n], "phase 4's single-device run")
            w1 = _mesh_check_poses(tag, got["poses"], base, what)
            w2 = _mesh_check_poses(tag, got["poses"], ref[f"bench_{name}_poses"][:n],
                                   MESH_REF_PATH.name)
            ex = got["executions"]
            _require(got["launches"] > 0 and all(v == got["launches"] for v in ex.values()),
                     f"[{tag}] k-NN wrapper calls {got['launches']}, executions {ex}")
            rows[f"{group} {name}"] = got["ms_frame"]
            print(f"[{tag}] {got['ms_frame']:.2f} ms/frame (single device, phase 4: "
                  f"{sync['ms_frame']:.2f}); {w1[0]:.3e} m / {w1[1]:.3e} deg from {what}, "
                  f"{w2[0]:.3e} m / {w2[1]:.3e} deg from JAX's mesh; {got['launches']} k-NN "
                  f"calls = executions {ex} ({card})", flush=True)
    sref = np.load(MESH_STREAM_REF_PATH)
    _require(int(sref["mesh_devices"]) == MESH_GLOO_WORLD,
             f"{MESH_STREAM_REF_PATH.name} was made on {int(sref['mesh_devices'])} devices")
    for name, _ in MESH_STREAM_MODES:
        tag = f"mesh gloo stream {name}"
        st = g0["streams"][name]
        _require(st["failed"] == 0, f"[{tag}] {st['failed']} failed frames")
        _mesh_ranks_equal(tag, [r["streams"] for r in gloo], name)
        k = min(len(st["poses"]), n)
        ws = _mesh_check_poses(tag, st["poses"][:k], g0[name]["poses"][:k],
                               "the mesh's sync path")
        wj = _mesh_check_poses(tag, st["poses"], sref[f"bench_{name}_poses"][:len(st["poses"])],
                               f"JAX's mesh stream ({MESH_STREAM_REF_PATH.name})")
        timed = "not timed" if st["ms_frame"] is None else \
            f"{st['ms_frame']:.2f} ms/frame over frames {TIMED.start}-{TIMED.stop - 1}"
        if st["ms_frame"] is not None:
            rows[f"gloo stream {name}"] = st["ms_frame"]
        print(f"[{tag}] eager windows of {WINDOW} (gloo stages every collective through the "
              f"host, D10), {len(st['poses'])} sweeps: {timed}; {ws[0]:.3e} m from the mesh's "
              f"sync path, {wj[0]:.3e} m / {wj[1]:.3e} deg from JAX's mesh stream ({card})",
              flush=True)
    streams = _check_nccl_streams(card, nccl, sref, stream_ms=stream_ms)
    for name, st in streams.items():
        rows[f"nccl x{len(nccl)} stream {name} (graph)"] = st["ms_frame"]
    fu = g0["full"]
    _require(fu["failed"] == 0, "[mesh full] failed frames")
    _mesh_ranks_equal("mesh full", gloo, "full")
    wf1 = _mesh_check_poses("mesh full", fu["poses"], full_no_reuse,
                            "phase 6's configuration without reuse_knn")
    wf2 = _mesh_check_poses("mesh full", fu["poses"], ref["full_maps_poses"], MESH_REF_PATH.name)
    d_ov = float(np.abs(np.array(fu["overlap"][1:]) - ref["full_maps_overlap"][1:]).max())
    _require(d_ov <= OVERLAP_TOL, f"[mesh full] overlap {d_ov} from JAX's mesh")
    rows["gloo full shard_maps"] = fu["ms_frame"]
    print(f"[mesh full] shard_maps sync: {fu['ms_frame']:.2f} ms/frame (phase 6 single "
          f"device: {full['sync_ms']:.2f}); {wf1[0]:.3e} m from phase 6's configuration "
          f"without reuse_knn, {wf2[0]:.3e} m from "
          f"JAX's mesh; overlap within {d_ov:.2e} ({card})", flush=True)
    rg = g0["rig"]
    _require(rg["failed"] == 0, "[mesh rig] failed acquisitions")
    _mesh_ranks_equal("mesh rig", gloo, "rig")
    rows["gloo rig shard_maps"] = rg["ms_frame"]
    print(f"[mesh rig] {MESH_RIG_ACQ} acquisitions of add_frames with shard_maps, 0 failed, "
          f"{rg['ms_frame']:.2f} ms/acquisition ({card})", flush=True)
    _require(g0["pgo_rel"] <= MESH_PGO_REL,
             f"[mesh pgo] sharded Schur {g0['pgo_rel']:.2e} relative from the unsharded one")
    print(f"[mesh pgo] {PGO_POSES}-pose Schur over {PGO_SEGMENTS} segments sharded over "
          f"{MESH_GLOO_WORLD} gloo ranks: {g0['pgo_ms']:.1f} ms against unsharded "
          f"{g0['pgo_unsharded_ms']:.1f} ms, {g0['pgo_rel']:.2e} relative ({card})",
          flush=True)
    shapes = g0["shapes"] + nccl[0]["shapes"]
    drives = {d for s in shapes for d in s["drives"]}
    _require(len(drives) == len(MESH_MODES) + 2,
             f"[mesh] k-NN call shapes recorded from {sorted(drives)} only")
    print(f"[mesh] {len(shapes)} k-NN call shapes of {len(drives)} mesh drives, each exact "
          "against plain_knn on rank 0's inputs", flush=True)
    return {"shapes": shapes, "ms_frame": rows, "max_abs_err":
            max(s["max_abs_err"] for s in shapes),
            "launches": {f"mesh {k}": v for k, v in
                         (("gloo kp", g0["kp"]["launches"]), ("gloo ext", g0["ext"]["launches"]),
                          ("gloo maps", g0["maps"]["launches"]),
                          ("nccl maps", nccl[0]["maps"]["launches"]),
                          *((f"nccl stream {name} (Python calls)", st["calls"])
                            for name, st in streams.items()))},
            "streams": streams,
            "pgo_ms": {"sharded": g0["pgo_ms"], "unsharded": g0["pgo_unsharded_ms"]}}


def _check_nccl_streams(card, nccl, sref, stream_ms):
    """Phase 11's checks of the NCCL group's captured streams
    (`_mesh_graph_stream`, `_mesh_rig_stream`); returns each bench mode's
    readings for the kernels line."""
    r0 = nccl[0]
    world = len(nccl)
    smi = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60)
    n_cards = len([ln for ln in smi.stdout.splitlines() if ln.startswith("GPU ")])
    print(f"[mesh nccl] nvidia-smi -L lists {n_cards} card(s): the NCCL group runs "
          f"{world} rank(s)" + (" on one card, so no collective crosses NVLink and "
                                "ppermute's batch_isend_irecv (world 1: a clone) is not in "
                                "its graphs" if world == 1 else " across cards"),
          flush=True)
    out = {}
    for name, kw in MESH_STREAM_MODES:
        tag = f"mesh nccl x{world} stream {name}"
        st = r0["streams"][name]
        _require(st["failed"] == 0 and st["eager"]["failed"] == 0,
                 f"[{tag}] failed frames: {st['failed']} replayed, {st['eager']['failed']} "
                 "eager")
        _mesh_ranks_equal(tag, [r["streams"] for r in nccl], name)
        wj = _mesh_check_poses(tag, st["poses"], sref[f"bench_{name}_poses"],
                               f"JAX's mesh stream ({MESH_STREAM_REF_PATH.name})")
        we = _mesh_check_poses(tag, st["poses"][:WINDOW + 1], st["eager"]["poses"],
                               "the group's eager mesh stream over its first window")
        ex = st["executions"]
        _require(st["calls"] > 0 and all(n > 0 for n in ex.values()),
                 f"[{tag}] k-NN wrapper calls {st['calls']}, device executions {ex}")
        prof, n_tail = st["profile"], st["profiled"]
        per_frame = {k: n / n_tail for k, n in prof["knn"].items()}
        idle = 1.0 - prof["busy_ms"] / st["ms_frame"]
        _, _, total = st["replay_vs_eager"]
        want = _mesh_stream_executions(bench_config(16, 1800), kw)
        print(f"[{tag}] captured graph, one replay per sweep: 0 failed of "
              f"{len(st['poses'])}, {st['ms_frame']:.2f} ms/frame over frames "
              f"{TIMED.start}-{TIMED.stop - 1} (single-device replay, phase 5: "
              f"{stream_ms:.2f}); device busy {prof['busy_ms']:.2f} ms/frame over its "
              f"frames {TIMED.stop}-{TIMED.stop + n_tail - 1} profiled on rank 0, so idle "
              f"share {100 * idle:.1f}%, {prof['kernels']:.1f} device kernels/frame; k-NN "
              f"executions per replayed frame {per_frame} (device counts; {want} expected); "
              f"{st['calls']} k-NN wrapper calls (frame 0, warm-ups, capture) and {ex} device "
              f"executions in frames 0-{TIMED.stop - 1} ({card})", flush=True)
        print(f"[{tag}] replay == eager step from the stream's last state, bit for bit ({total} "
              f"matches); poses {wj[0]:.3e} m / {wj[1]:.3e} deg from JAX's mesh stream, "
              f"{we[0]:.3e} m / {we[1]:.3e} deg from the eager mesh stream over frames "
              f"0-{WINDOW}; ranks bit-equal", flush=True)
        out[name] = {"ms_frame": st["ms_frame"], "busy_ms": prof["busy_ms"], "idle": idle,
                     "kernels": prof["kernels"], "knn_ms": prof["knn_ms"],
                     "executions_per_frame": per_frame, "calls": st["calls"],
                     "from_jax_m": wj[0], "from_eager_m": we[0]}
    rig = r0["rig_stream"]
    _require(rig["graph"]["failed"] == 0 and rig["eager"]["failed"] == 0,
             "[mesh nccl rig stream] failed acquisitions")
    wr = _mesh_check_poses("mesh nccl rig stream", rig["graph"]["poses"],
                           rig["eager"]["poses"], "the eager rig stream")
    print(f"[mesh nccl rig stream] {MESH_RIG_ACQ} acquisitions of add_frames_async with "
          f"shard_maps, the rig's step graph captured on the mesh: 0 failed, {wr[0]:.3e} m "
          f"from the eager rig stream ({card})", flush=True)
    return out


def _ref_pose(row):
    """A Poses.csv row (time x y z rX rY rZ) as a (4,4) pose."""
    from lidarslam_tpu_torch.core import se3

    return se3.pose_to_hmat(row[1:7])


# the helpers whose time each phase's end line splits out (`SPENT`)
TIMED_HELPERS = ("_profile", "_readings", "_path_call_case", "_stream_run_ms",
                 "_replay_vs_eager", "_check_blob_model", "render_frames", "render_rig",
                 "_single_run", "_kernel_case", "_float_stream", "_cli_process",
                 "_mesh_call_cases")


def main() -> int:
    if not (ROOT / "lidarslam_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: lidarslam_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    def done(phase):
        print(f"[time] phase {phase} done at {time.perf_counter() - t_start:.1f} s; in it: "
              f"{_spent_line()}", flush=True)

    from lidarslam_tpu_torch.ops import stream_graph
    for name in TIMED_HELPERS:
        globals()[name] = _timed(globals()[name])
    step = stream_graph._Replayed._step
    timed_step = _timed(step, "graph warm-ups and captures")
    stream_graph._Replayed._step = lambda self, *a, **k: (
        step if self.graph is not None else timed_step)(self, *a, **k)

    card = phase_env()
    phase_build()
    done(2)
    t0 = time.perf_counter()
    frames = render_frames(N_FRAMES)
    print(f"[frames] rendered {len(frames)} VLP-16 sweeps "
          f"(~{len(frames[0]['xyz'])} points each) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rec = phase_kernel(frames, card)
    extract = phase_extract(card)
    done(3)
    print("[ingest] phases 4-7 pin the port's host ingest to numpy, on which their JAX "
          "references were made (ROADMAP Queue 3, F5); phase 5's native runs and phase 8 "
          "take the native ingest", flush=True)
    with numpy_ingest():
        sync = phase_slice(frames)
        done(4)
        stream = phase_stream(frames, card, sync)
    ingest = phase_ingest(frames, card, stream)
    done(5)
    t0 = time.perf_counter()
    distorted = render_frames(N_FRAMES, motion_distortion=True)
    print(f"[full] rendered {len(distorted)} VLP-16 sweeps with motion distortion in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = Path(tmp)
        with numpy_ingest():
            full = phase_full(card, distorted, ckpt_dir)
            done(6)
            ext = phase_ext(card, distorted)
            done(7)
        rig = phase_rig(card)
        done(8)
        with numpy_ingest():    # vlp16_pgo_ref.npz, as phase 6's, on the numpy ingest
            phase_pgo(card, distorted, full, ckpt_dir)
            done(9)
    t0 = time.perf_counter()
    front = phase_frontends(card, distorted)    # the native ingest, as vlp16_cli_ref.npz
    print(f"[time] phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)
    done(10)
    t0 = time.perf_counter()
    mesh = phase_mesh(card, frames, distorted, sync, full, stream["ms_frame"])
    print(f"[time] phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    done(11)
    pf = ext["per_frame"]
    # what sets the per-frame bound: the side holding most of it
    by_ops = sum(s["bound_ms"] * s["calls_per_frame"] for s in ext["shapes"]
                 if s["bound_by"] == "operations")
    bound_by = "operations" if 2 * by_ops >= pf["bound_ms"] else "bytes"
    # the headline numbers: one streamed frame of ext_config, its 14 k-NN
    # calls summed (each shape's own numbers under "shapes"; full_config's
    # under "full_shapes"); launches: this slice's path, add_frame at
    # ext_config
    print(json.dumps({"kernels": [{
        "name": "knn", "route": "cuda", "source": "lidarslam_tpu_torch/csrc/knn.cu",
        "replaces": "lidarslam_tpu/ops/pallas_knn.py:121",
        "launches": ext["sync_launches"],
        "max_abs_err": max(rec["max_abs_err"], full["max_abs_err"], ext["max_abs_err"],
                           rig["max_abs_err"], front["max_abs_err"], mesh["max_abs_err"]),
        "ms": pf["ms"], "plain_ms": pf["plain_ms"], "bound_ms": pf["bound_ms"],
        "bound_by": bound_by, "library_ms": pf["library_ms"],
        "per": f"one streamed frame of ext_config ({len(EXT_CALLS)} calls)",
        "launch_ms": pf["launch_ms"], "device_ms": pf["device_ms"],
        "shapes": ext["shapes"], "full_shapes": full["shapes"],
        "rig_shapes": rig["shapes"], "outdoor_shapes": front["shapes"],
        "mesh_shapes": mesh["shapes"], "mesh_ms_per_frame": mesh["ms_frame"],
        "mesh_pgo_ms": mesh["pgo_ms"], "mesh_nccl_streams": mesh["streams"],
        "launches_by_path": {"bench sync": sync["launches"],
                             "bench stream (Python calls)": stream["calls"],
                             "full sync": full["sync_launches"],
                             "full stream (Python calls)": full["stream_calls"],
                             "ext sync": ext["sync_launches"],
                             "ext stream (Python calls)": ext["stream_calls"],
                             "rig sync": rig["sync_launches"],
                             "rig stream (Python calls)": rig["stream_calls"],
                             **front["launches"], **mesh["launches"]},
        "full_sync_launches_by_shape": full["sync_by_shape"],
        "ext_sync_launches_by_shape": ext["sync_by_shape"],
        "bench_full_map": {"ms": rec["ms"], "plain_ms": rec["plain_ms"],
                           "library_ms": rec["library_ms"], "bound_us": rec["bound_us"],
                           "launch_ms": rec["launch_ms"], "device_ms": rec["device_ms"],
                           "slice_fill_ms": rec["slice_fill_ms"],
                           "edges_unpruned": rec["edges_unpruned"]},
        "stream_knn_device_ms_per_frame": {"bench": stream["knn_ms"],
                                           "full": full["stream_knn_ms"],
                                           "ext": ext["stream_knn_ms"],
                                           "rig": rig["stream_knn_ms"]},
        "sync_knn_device_ms_per_frame": {"bench": sync["knn_ms"],
                                         "full": full["sync_knn_ms"],
                                         "ext": ext["sync_knn_ms"],
                                         "rig": rig["sync_knn_ms"]},
        "stream_executions": {"bench": stream["knn"], "full": full["stream_executions"],
                              "ext": ext["stream_executions"],
                              "rig": rig["stream_executions"]},
        "host_ingest_ms_per_sweep": ingest["ingest_ms"],
        "bench_stream_native_ms": {"inline": ingest["inline_ms"],
                                   "worker": ingest["worker_ms"]},
        "frontends": front["times"],
        "stream_frames_profiled": WINDOW}, {
        "name": "extract", "route": "cuda", "source": "lidarslam_tpu_torch/csrc/extract.cu",
        "replaces": "no TPU kernel: the XLA-fused jnp stencils of "
                    "lidarslam_tpu/ops/extractor.py",
        "max_abs_err": extract["max_abs_err"], "shapes": extract["shapes"],
        "launches": EXTRACT_COUNTS["bench sync"]["calls"],
        "counts_by_path": EXTRACT_COUNTS}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
