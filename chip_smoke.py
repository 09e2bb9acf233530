#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lidarslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, each printed as it goes:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile csrc/knn.cu with nvcc (sm_90a) from this checkout;
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
4. the slice: `Slam(cfg, device="cuda").add_frame` over 30 VLP-16 sweeps at
   the bench configuration, held against the JAX package's trajectory
   (lidarslam_tpu_torch/data/vlp16_bench_ref.npz, made by
   scripts/make_torch_reference.py) and the simulator ground truth, with
   exactly 2 wrapper calls per localized frame; then a torch.profiler
   window over 8 more synchronous frames (device busy time, kernels, each
   k-NN kernel twice per frame and their device ms/frame);
5. the stream: `add_frame_async` x 30 + `flush` at `stream_window=8` on the
   same sweeps, every steady-state frame a CUDA-graph replay, held against
   the JAX package's streaming trajectory (vlp16_bench_stream_ref.npz) and
   the ground truth; ms/frame over the full windows (frames 9-24). On a
   second stream: one eager step under
   `torch.cuda.set_sync_debug_mode("error")` (no host sync), one replay
   against the eager step from the same state, and a torch.profiler window
   over one full window of replays (each of the four k-NN kernels runs
   exactly twice per frame inside the graph; their device ms/frame);
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
   its bound.

Any failure raises and exits non-zero. Without a CUDA device, or without
the package beside this file, it exits non-zero before printing a result.
The last line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
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
KNN_KERNELS = ("knn_plan", "knn_prefix", "knn_scan", "knn_merge")
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
    from lidarslam_tpu_torch.ops import cuda_knn

    t0 = time.perf_counter()
    lib = cuda_knn.build_kernel()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = lib.with_name(lib.name.replace(".so", ".ptxas.txt"))
    if ptxas.is_file():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas {line.strip()}", flush=True)


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
    of `fn` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(KNN_KERNELS, 0.0)
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        t = evt.self_cuda_time_total if t is None else t
        for name in KNN_KERNELS:
            if name in evt.key:
                split[name] += t / reps
    return split


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


def _profile(fn, n_frames: int):
    """torch.profiler over `fn` (which ends in a device sync): device busy
    ms/frame, device kernels/frame, executions of each k-NN kernel, and
    the k-NN kernels' device ms/frame (every device kernel named knn_*)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us, kernels, knn_us = 0.0, 0, 0.0
    knn = dict.fromkeys(KNN_KERNELS, 0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        t = evt.self_cuda_time_total if t is None else t
        busy_us += t
        if not evt.key.startswith(("Memcpy", "Memset")):
            kernels += evt.count
        if "knn_" in evt.key:
            knn_us += t
        for name in KNN_KERNELS:
            if name in evt.key:
                knn[name] += evt.count
    if busy_us <= 0 or kernels == 0:
        raise AssertionError("torch.profiler saw no device time")
    return {"busy_ms": busy_us / 1000.0 / n_frames, "kernels": kernels / n_frames,
            "knn": knn, "knn_ms": knn_us / 1000.0 / n_frames}


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
    from lidarslam_tpu_torch.ops import cuda_knn, icp

    ref = np.load(REF_PATH)
    if ref["poses"].shape[0] != len(frames):
        raise AssertionError(f"{REF_PATH.name} holds {ref['poses'].shape[0]} poses, "
                             f"not {len(frames)}")
    slam = Slam(bench_config(16, 1800), device="cuda")
    cuda_knn.LAUNCHES = 0
    results, wall = [], []
    for f in frames:
        t0 = time.perf_counter()
        results.append(slam.add_frame(f))
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    launches = cuda_knn.LAUNCHES

    worst_ref, worst_gt = _check_trajectory("slice", frames, results, ref)
    localized = len(frames) - 1   # the first frame only seeds the maps
    if launches != 2 * localized:
        raise AssertionError(f"{launches} kernel launches for {localized} localized "
                             "frames (expected 2 each)")
    n_matches = [r["n_matches"] for r in results[1:]]
    ref_matches = [int(v) for v in ref["n_matches"][1:len(frames)]]
    ms_frame = 1000 * statistics.median(wall[1:])
    print(f"[slice] {len(frames)} frames, 0 failed, {launches} kernel "
          f"launches; median {ms_frame:.2f} ms/frame "
          f"(first frame {1000 * wall[0]:.1f} ms)", flush=True)
    print(f"[slice] min n_matches {min(n_matches)} (JAX reference {min(ref_matches)}); "
          f"max pose divergence from the reference {worst_ref[0]:.3e} m / "
          f"{worst_ref[1]:.3e} deg; from ground truth {worst_gt[0]:.3e} m / "
          f"{worst_gt[1]:.3e} deg", flush=True)
    for k, m in slam.maps.items():
        n_valid = int(m.valid.sum())
        print(f"[slice] {k.name} map at frame {len(frames)}: {n_valid} of "
              f"{m.xyz.shape[0]} slots valid ({100 * n_valid / m.xyz.shape[0]:.1f}%), "
              f"overflow {int(slam.map_overflow[int(k)])}", flush=True)

    # profiled: frames 17-24 of a second run, after 17 unprofiled ones; the
    # ICP rounds the host exit let run are counted (the stream runs them all)
    slam = Slam(bench_config(16, 1800), device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame(f)
    rounds = []
    robust_lm = icp.solver.robust_lm
    icp.solver.robust_lm = lambda *a, **k: rounds.append(1) or robust_lm(*a, **k)
    try:
        prof = _profile(lambda: [slam.add_frame(frames[i]) for i in PROFILED],
                        len(PROFILED))
    finally:
        icp.solver.robust_lm = robust_lm
    _check_knn_executions("slice", prof, len(PROFILED))
    print(f"[slice] profiled frames {PROFILED.start}-{PROFILED.stop - 1}: device busy "
          f"{prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} device kernels/frame, "
          f"{len(rounds)} ICP rounds run of "
          f"{slam.cfg.localization_icp_max_iter * len(PROFILED)}; k-NN kernels "
          f"{prof['knn_ms']:.4f} ms/frame ({100 * prof['knn_ms'] / prof['busy_ms']:.2f}% "
          f"of device busy), executions {prof['knn']}", flush=True)
    return {"launches": launches, "ms_frame": ms_frame, **prof}


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
    for i, f in enumerate(frames):
        if i == TIMED.start:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if slam.add_frame_async(f) != i:
            raise AssertionError(f"frame {i} was not enqueued as frame {i}")
        if i == TIMED.stop - 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    results = slam.flush()
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
    ms_frame = 1000 * (t1 - t0) / len(TIMED)
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
          f"(enqueue + device sync); all 30 frames + flush {1000 * wall_all:.1f} ms",
          flush=True)
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
    ue, ur = pipeline.unpack_scalars(e[:64]), pipeline.unpack_scalars(r[:64])
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
          f"{window.stop - 1}): k-NN kernel executions {prof['knn']} (2 per frame "
          f"each); device busy {prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} "
          f"device kernels/frame; k-NN kernels {prof['knn_ms']:.4f} ms/frame "
          f"({100 * prof['knn_ms'] / prof['busy_ms']:.2f}% of device busy)", flush=True)
    print(f"[stream-vs-sync] {card}: stream {ms_frame:.2f} ms/frame, sync "
          f"{sync['ms_frame']:.2f} ms/frame; device busy stream {prof['busy_ms']:.2f} / "
          f"sync {sync['busy_ms']:.2f} ms/frame; kernels/frame stream "
          f"{prof['kernels']:.1f} / sync {sync['kernels']:.1f}; k-NN device ms/frame "
          f"stream {prof['knn_ms']:.4f} / sync {sync['knn_ms']:.4f}", flush=True)
    return {"ms_frame": ms_frame, "calls": calls, **prof}


# the k-NN calls of one step of full_config, in order: 4 ego rounds of
# (edges, planes) against the previous sweep's keypoints, the localization
# pair under reuse_knn, then the overlap 1-NN against each submap
FULL_CALLS = ((("ego edges", 8), ("ego planes", 5)) * 4
              + (("loc edges", 10), ("loc planes", 5), ("overlap, edge map", 1),
                 ("overlap, plane map", 1)))
OVERLAP_TOL = 0.01


def _record_knn_calls(fn, keep_inputs=True):
    """Run `fn` watching every k-NN launch: returns (fn's result, one entry
    per launch in order), the entry a copy of the launch's inputs (index,
    queries, q_valid, k, r2), or with `keep_inputs=False` its shape label."""
    from lidarslam_tpu_torch.ops import cuda_knn

    calls = []
    real = cuda_knn.launch

    def recording(index, queries, q_valid, order, k, r2):
        if keep_inputs:
            calls.append((cuda_knn.KnnIndex(*(t.clone() for t in index)), queries.clone(),
                          q_valid.clone(), k, r2))
        else:
            radius = "" if r2 == float("inf") else f" r={r2 ** 0.5:g} m"
            calls.append(f"Q={queries.shape[0]} k={k} slots={index.pts.shape[0]}{radius}")
        return real(index, queries, q_valid, order, k, r2)

    cuda_knn.launch = recording
    try:
        return fn(), calls
    finally:
        cuda_knn.launch = real


def _path_call_case(label, per_frame, index, q, q_valid, k, r2, card, tag="full"):
    """One k-NN call of the full path on the inputs the path gave it: the
    kernel against plain_knn (bit-equal without a prune radius, equal within
    it with one), its timings and its bound. Returns its record."""
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
    err = float(torch.where(both, (kd - pd).abs(), 0.0).max())

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


def phase_full(card: str, frames):
    """`frames` (30 sweeps rendered with motion distortion) at full_config
    through add_frame and through add_frame_async + flush, each held against
    its JAX reference; the stream's sync-free step, replay == eager, the k-NN
    executions per replayed frame, and each k-NN call shape of the path on
    its own inputs."""
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
        for f in frames:
            t1 = time.perf_counter()
            results.append(slam.add_frame(f))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t1)

    cuda_knn.LAUNCHES = 0
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
          f"{sync_by_shape}; median {sync_ms:.2f} ms/frame", flush=True)
    print(f"[full] sync: min n_matches {min(r['n_matches'] for r in results[1:])} (JAX "
          f"{int(ref['n_matches'][1:].min())}); max divergence from JAX {worst_ref[0]:.3e} m "
          f"/ {worst_ref[1]:.3e} deg; overlap within {d_ov:.2e} of JAX's; motion-limit "
          f"flags equal ({sum(not r['comply_motion_limits'] for r in results)} breaking); "
          f"from ground truth {worst_gt[0]:.3e} m / {worst_gt[1]:.3e} deg (the JAX "
          f"reference's own: {ref_gt[0]:.3e} m / {ref_gt[1]:.3e} deg)", flush=True)
    if sync_launches == 0:
        raise AssertionError("[full] the sync path launched no k-NN kernel")

    slam = Slam(cfg, device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame(f)
    cuda_knn.LAUNCHES = 0
    prof = _profile(lambda: [slam.add_frame(frames[i]) for i in PROFILED], len(PROFILED))
    if any(n != cuda_knn.LAUNCHES for n in prof["knn"].values()):
        raise AssertionError(f"[full] sync profile: executions {prof['knn']} for "
                             f"{cuda_knn.LAUNCHES} wrapper calls")
    sync_prof = {**prof, "ms_frame": sync_ms}
    print(f"[full] sync profiled frames {PROFILED.start}-{PROFILED.stop - 1}: device busy "
          f"{prof['busy_ms']:.2f} ms/frame, {prof['kernels']:.1f} device kernels/frame, "
          f"k-NN executions {prof['knn']} ({cuda_knn.LAUNCHES / len(PROFILED):.2f} calls "
          f"per frame; the ego ICP exits early on a host read), k-NN {prof['knn_ms']:.4f} "
          f"ms/frame", flush=True)

    # ---- add_frame_async + flush
    slam = Slam(cfg, device="cuda")
    cuda_knn.LAUNCHES = 0
    for i, f in enumerate(frames):
        if i == TIMED.start:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        slam.add_frame_async(f)
        if i == TIMED.stop - 1:
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    results = slam.flush()
    calls = cuda_knn.LAUNCHES
    if slam._graph is None or slam._graph.graph is None:
        raise AssertionError("[full] the stream never captured its CUDA graph")
    if calls != len(FULL_CALLS) * (slam._graph.warmup_steps + 1):
        raise AssertionError(f"[full] {calls} k-NN wrapper calls in the stream for "
                             f"{slam._graph.warmup_steps} warm-up steps and 1 capture")
    worst_sref, worst_sgt = _check_trajectory("full stream", frames, results, sref,
                                              gate_gt=False)
    d_sov = _check_confidence("full stream", results, sref)
    stream_ms = 1000 * (t2 - t1) / len(TIMED)
    print(f"[full] stream: {len(frames)} frames, 0 failed, {calls} Python k-NN calls "
          f"({slam._graph.warmup_steps} warm-up steps and 1 capture, {len(FULL_CALLS)} "
          f"each); {stream_ms:.2f} ms/frame over frames {TIMED.start}-{TIMED.stop - 1}",
          flush=True)
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
    ue = pipeline.unpack_scalars(packed_eager.cpu().numpy()[:64])
    ur = pipeline.unpack_scalars(packed_graph.cpu().numpy()[:64])
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
          f"{window.stop - 1}): k-NN executions {prof['knn']} ({len(FULL_CALLS)} per frame "
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
            "max_abs_err": max(s_["max_abs_err"] for s_ in shapes)}


EXT_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_ext_ref.npz"
EXT_STREAM_REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_ext_stream_ref.npz"
# the k-NN calls of one step of ext_config: FULL_CALLS with the blobs'
# localization query (reuse_knn: round 0, after edges and planes) and the
# overlap's 1-NN against the blob submap
EXT_CALLS = (FULL_CALLS[:8] + (("loc edges", 10), ("loc planes", 5), ("loc blobs", 10))
             + (("overlap, edge map", 1), ("overlap, plane map", 1), ("overlap, blob map", 1)))


def _ext_run(cfg, frames, sensors, stream: bool, device: str = "cuda"):
    """One ext_config run on `device` (`sensors` fed first; none when None):
    (results, per-type match counts per frame, the Slam, ms/frame as PERF.md
    defines it: the median over the localized frames of add_frame ending in
    a device sync, or the stream's frames TIMED between two device syncs)."""
    import torch

    from lidarslam_tpu_torch import Slam

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    slam = Slam(cfg, device=device)
    if sensors is not None:
        feed_sensors(slam, sensors)
    if not stream:
        results, counts, wall = [], [], []
        for f in frames:
            t0 = time.perf_counter()
            results.append(slam.add_frame(f))
            sync()
            wall.append(time.perf_counter() - t0)
            counts.append(slam.match_counts.copy())
        return results, counts, slam, 1000 * statistics.median(wall[1:] or wall)
    counts = []
    real = slam._log_state

    def log_state(stamp):       # flush logs each frame after its match counts
        counts.append(slam.match_counts.copy())
        real(stamp)
    slam._log_state = log_state
    t0 = t1 = 0.0
    for i, f in enumerate(frames):
        if i == TIMED.start:
            sync()
            t0 = time.perf_counter()
        slam.add_frame_async(f)
        if i == TIMED.stop - 1:
            sync()
            t1 = time.perf_counter()
    return slam.flush(), counts, slam, 1000 * (t1 - t0) / len(TIMED)


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
          f"{sync_by_shape}; median {sync_ms:.2f} ms/frame", flush=True)
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
          f"{stream_ms:.2f} ms/frame over frames {TIMED.start}-{TIMED.stop - 1}", flush=True)
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
    ue = pipeline.unpack_scalars(packed_eager.cpu().numpy()[:64])
    ur = pipeline.unpack_scalars(packed_graph.cpu().numpy()[:64])
    ud = pipeline.unpack_scalars(packed_dropped.cpu().numpy()[:64])
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
          f"{window.stop - 1}): k-NN executions {prof['knn']} ({len(EXT_CALLS)} per frame "
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
        print(f"[time] phase {phase} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    card = phase_env()
    phase_build()
    done(2)
    t0 = time.perf_counter()
    frames = render_frames(N_FRAMES)
    print(f"[frames] rendered {len(frames)} VLP-16 sweeps "
          f"(~{len(frames[0]['xyz'])} points each) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rec = phase_kernel(frames, card)
    done(3)
    sync = phase_slice(frames)
    done(4)
    stream = phase_stream(frames, card, sync)
    done(5)
    t0 = time.perf_counter()
    distorted = render_frames(N_FRAMES, motion_distortion=True)
    print(f"[full] rendered {len(distorted)} VLP-16 sweeps with motion distortion in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    full = phase_full(card, distorted)
    done(6)
    ext = phase_ext(card, distorted)
    done(7)
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
        "max_abs_err": max(rec["max_abs_err"], full["max_abs_err"], ext["max_abs_err"]),
        "ms": pf["ms"], "plain_ms": pf["plain_ms"], "bound_ms": pf["bound_ms"],
        "bound_by": bound_by, "library_ms": pf["library_ms"],
        "per": f"one streamed frame of ext_config ({len(EXT_CALLS)} calls)",
        "launch_ms": pf["launch_ms"], "device_ms": pf["device_ms"],
        "shapes": ext["shapes"], "full_shapes": full["shapes"],
        "launches_by_path": {"bench sync": sync["launches"],
                             "bench stream (Python calls)": stream["calls"],
                             "full sync": full["sync_launches"],
                             "full stream (Python calls)": full["stream_calls"],
                             "ext sync": ext["sync_launches"],
                             "ext stream (Python calls)": ext["stream_calls"]},
        "full_sync_launches_by_shape": full["sync_by_shape"],
        "ext_sync_launches_by_shape": ext["sync_by_shape"],
        "bench_full_map": {"ms": rec["ms"], "plain_ms": rec["plain_ms"],
                           "library_ms": rec["library_ms"], "bound_us": rec["bound_us"],
                           "launch_ms": rec["launch_ms"], "device_ms": rec["device_ms"],
                           "slice_fill_ms": rec["slice_fill_ms"],
                           "edges_unpruned": rec["edges_unpruned"]},
        "stream_knn_device_ms_per_frame": {"bench": stream["knn_ms"],
                                           "full": full["stream_knn_ms"],
                                           "ext": ext["stream_knn_ms"]},
        "sync_knn_device_ms_per_frame": {"bench": sync["knn_ms"],
                                         "full": full["sync_knn_ms"],
                                         "ext": ext["sync_knn_ms"]},
        "stream_executions": {"bench": stream["knn"], "full": full["stream_executions"],
                              "ext": ext["stream_executions"]},
        "stream_frames_profiled": WINDOW}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
