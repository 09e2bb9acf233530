#!/usr/bin/env python3
"""Write the JAX package's VLP-16 trajectories for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py \
        [--which bench|full|ext|float|rig|pgo|cli|mesh|mesh_stream|extract|all]

Runs the JAX package's `Slam` on the CPU over the first `chip_smoke.N_FRAMES`
(30) sweeps of the bench sequence (weaving street trajectory), through
`Slam.add_frame` per sweep (the synchronous path) and through
`Slam.add_frame_async` for every sweep and one `flush` (the streaming path,
`stream_window=8`, flat wire), and writes into `lidarslam_tpu_torch/data/`:

- `bench` (~2 min): `bench.py::bench_config(16, 1800)` on sweeps without
  motion distortion -> `vlp16_bench_ref.npz`, `vlp16_bench_stream_ref.npz`;
- `full`: the same configuration with REFINED undistortion, ego-motion
  registration after the extrapolation, LCP overlap and motion limits
  (`chip_smoke.full_config`, rebuilt from the JAX package's config) on
  sweeps rendered with motion distortion -> `vlp16_full_ref.npz`,
  `vlp16_full_stream_ref.npz`;
- `ext`: `full` plus blobs, a CENTER_POINT blob map, a CENTROID plane
  map, edge-map decay and wheel-odometry / IMU-gravity residuals
  (`chip_smoke.ext_config`), fed `chip_smoke.sensor_measurements` of the
  drive's ground truth, on the same distorted sweeps ->
  `vlp16_ext_ref.npz`, `vlp16_ext_stream_ref.npz`;
- `float`: the bench stream with `compress_upload=False` (float sweeps
  stacked per window) -> `vlp16_bench_float_stream_ref.npz`;
- `rig`: `chip_smoke.rig_config` on the 30 acquisitions of
  `chip_smoke.render_rig` (two VLP-16s, device 1 at its calibration offset
  with its own extractor), through `Slam.add_frames` and through
  `Slam.add_frames_async` + `flush` -> `vlp16_rig_ref.npz`,
  `vlp16_rig_stream_ref.npz`;
- `pgo`: the `full` configuration's synchronous run, then
  `Slam.run_pose_graph_optimization(use_device_backend=True)` against GPS
  at every sweep from the drive's ground truth relative to frame 0 ->
  `vlp16_pgo_ref.npz`, which holds the logged `times`, `poses_before`
  (4x4) and `covariances` (6x6, as the PGO took them: a zero one replaced
  by 1e-4 I), the `gps` positions, the optimized `poses_after` (re-anchored
  at frame 0, as `Slam` leaves them), each map's valid slots after the
  rebuild (`map_valid`, per Keypoint type), and `resume_m`: the largest
  distance over sweeps 15-29 between the uninterrupted run and a fresh
  Slam continued from the checkpoint written after 15 sweeps, as loaded
  (JAX's checkpoint holds no keypoints) and with the previous sweep's
  keypoints put back by hand (ROADMAP Queue 3, D7);
- `cli` (~4 min): the command line on the CPU, as a user with
  recorded sweeps runs it: the 30 distorted sweeps written as binary PCDs
  (intensity, time, laser_id; `chip_smoke.write_cli_pcds`), then in-process
  `lidarslam_tpu.cli.main(["--cpu", "run", "--config",
  "configs/slam_config_outdoor.yaml", "--pcd-dir", ..., "--log-dir", ...,
  "--aggregate"])`, the same with `--follow`, `aggregate` on the
  synchronous run's keypoint log and Trajectory.csv, and `extract --config
  ... --blobs` on a directory of the first `chip_smoke.CLI_EXTRACT` sweeps
  (the CLI's `--limit` reaches only `--kitti-dir`) -> `vlp16_cli_ref.npz`:
  each PCD's
  sha256 (`pcd_sha256`), both runs' Poses.csv rows (`sync_poses`,
  `follow_poses`: time x y z rX rY rZ), their Evaluators overlap and
  n_matches columns and failed-frame counts (from Trajectory.csv), the
  run's and the command's aggregated point counts (`aggregated_points`,
  `aggregate_points`), the per-frame extraction counts (`extract_counts`:
  edge, plane, blob) and azimuthal resolutions (`extract_az`), and
  `ingest`. The CLI has no ingest switch, so this set takes the native
  ingest, and requires it;
- `mesh` (~8 min): the JAX package's `Slam(cfg, mesh=make_mesh(2))` on a
  2-device CPU mesh (the script sets
  `XLA_FLAGS=--xla_force_host_platform_device_count=2` before jax loads,
  unless the flags already name a device count), through `add_frame`: the
  bench drive keypoint-sharded (`bench_kp_*`), with `shard_extraction`
  (`bench_ext_*`) and with `shard_maps` (`bench_maps_*`), and the full
  drive with `shard_maps` (`full_maps_*`) -> `vlp16_mesh_ref.npz`, each
  run's `_poses`, `_n_matches`, `_failure` and `_overlap`, and `stamps`;
  then the bench drive through `add_frame_async` + `flush` on the same mesh
  (`stream_window=8`), keypoint-sharded (`bench_kp_*`), with
  `shard_extraction` (`bench_ext_*`) and with `shard_maps`
  (`bench_maps_*`) -> `vlp16_mesh_stream_ref.npz`, with the same keys and
  `mesh_devices`. `mesh_stream` (~3.5 min) writes only this second file.
- `extract` (seconds): the JAX extractor alone (`ops/extractor.py`, jitted)
  under the outdoor preset's extractor (configs/slam_config_outdoor.yaml)
  at 2,048 slots a ring, on the sweeps of `chip_smoke.extract_drive` at
  16 and at 64 rings, at `chip_smoke.EXTRACT_AZ` -> `extract_ref.npz`: per ring count R, every
  `Keypoints` field of the edge, plane and blob sets stacked over the
  sweeps (`r{R}_{edges|planes|blobs}_{field}`) and the sha256 of each
  sweep's points (`r{R}_sha256`, `chip_smoke.sweep_sha256`), so that the port's
  extraction on the card, which has no jax, is held to it slot for slot
  (tests/test_torch_cuda.py).

Each holds per frame the poses (float64 4x4), `n_matches`, `failure`,
`overlap`, `comply_motion_limits`, `stamps` and, in the files written
since the rig's, the per-type match counts (`match_counts`); the `ext`
files also each map's valid slots after the last frame (`map_valid`) and
the age of the edge map's oldest removable point then
(`edge_oldest_age`). `chip_smoke.py` holds the port's trajectories on the
GPU against these files, since the GPU machine has no jax.

The single-LiDAR sweeps go through the JAX package's numpy ingest (its
optional native C++ ingest is switched off for those runs): the native and
numpy ingests differ in the rounding of a few quantized coordinates, and
`chip_smoke.py` pins the port to numpy for these references. The rig runs
on the native ingest where it loads; its sweeps take the float planes,
which both ingests fill bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _save(path, results, frames, **extra):
    np.savez_compressed(
        path, poses=np.asarray([r["pose"] for r in results], np.float64),
        n_matches=np.asarray([r["n_matches"] for r in results], np.int64),
        failure=np.asarray([r["failure"] for r in results], bool),
        overlap=np.asarray([r["overlap"] for r in results], np.float64),
        comply_motion_limits=np.asarray([r["comply_motion_limits"] for r in results], bool),
        stamps=np.asarray([f["stamp"] for f in frames], np.float64), **extra)
    print(f"wrote {path} ({len(results)} frames)", file=sys.stderr)


def _map_record(slam, stamp):
    """Each map's valid slots, and the age of the edge map's oldest
    removable point, after the last frame."""
    from lidarslam_tpu.config import Keypoint

    valid = [int(np.asarray(slam.maps[k].valid).sum()) if k in slam.maps else 0
             for k in Keypoint]
    m = slam.maps[Keypoint.EDGE]
    keep = np.asarray(m.valid) & ~np.asarray(m.fixed)
    age = float(np.float32(stamp) - np.asarray(m.time)[keep].min())
    return {"map_valid": np.asarray(valid, np.int64), "edge_oldest_age": np.float64(age)}


def full_jax_config(bench_cfg):
    """chip_smoke.full_config in the JAX package's config classes."""
    import chip_smoke
    from lidarslam_tpu.config import ConfidenceConfig, EgoMotionMode, UndistortionMode

    return dataclasses.replace(
        bench_cfg, undistortion=UndistortionMode.REFINED,
        ego_motion_mode=EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION,
        confidence=ConfidenceConfig(overlap_sampling_ratio=0.25, time_window_duration=0.5,
                                    velocity_limits=chip_smoke.FULL_VELOCITY_LIMITS,
                                    acceleration_limits=chip_smoke.FULL_ACCELERATION_LIMITS))


def _run_both(Slam, cfg, frames, out, sync_name, stream_name, sensors=None,
              offset=None, per_type=False):
    """Both paths; `sensors`: chip_smoke.sensor_measurements fed to each
    Slam first, and the map record and per-type match counts saved;
    `offset`: `frames` are rig acquisitions (lists of frame dicts) through
    add_frames / add_frames_async, device 1 mounted at `offset`;
    `per_type`: save the per-type match counts; `sync_name` None: the
    stream only."""
    import chip_smoke

    def start():
        slam = Slam(cfg)
        if sensors is not None:
            chip_smoke.feed_sensors(slam, sensors)
        if offset is not None:
            slam.set_base_to_lidar_offset(1, offset)
        return slam

    def extra(slam, counts):
        out = {**_map_record(slam, stamped[-1]["stamp"])} if sensors is not None else {}
        if sensors is not None or per_type:
            out["match_counts"] = np.asarray(counts, np.int64)
        return out

    add, add_async = ("add_frames", "add_frames_async") if offset is not None \
        else ("add_frame", "add_frame_async")
    stamped = [f[0] if offset is not None else f for f in frames]
    if sync_name is not None:
        _sync(start(), add, frames, stamped, out / sync_name, extra)
    slam = start()
    for f in frames:
        getattr(slam, add_async)(f)
    counts = []
    real = slam._log_state

    def log_state(stamp):     # flush logs each frame after setting match_counts
        counts.append(slam.match_counts.copy())
        real(stamp)
    slam._log_state = log_state
    results = slam.flush()
    print("stream n_matches " + " ".join(str(r["n_matches"]) for r in results),
          file=sys.stderr)
    _save(out / stream_name, results, stamped, **extra(slam, counts))


def _sync(slam, add, frames, stamped, path, extra):
    results, counts = [], []
    for i, f in enumerate(frames):
        results.append(getattr(slam, add)(f))
        counts.append(slam.match_counts.copy())
        print(f"frame {i}: n_matches {results[-1]['n_matches']} {counts[-1].tolist()} "
              f"failure {results[-1]['failure']} overlap {results[-1]['overlap']:.4f} "
              f"comply {results[-1]['comply_motion_limits']}", file=sys.stderr)
    _save(path, results, stamped, **extra(slam, counts))


def ext_jax_config(bench_cfg):
    """chip_smoke.ext_config in the JAX package's config classes."""
    import chip_smoke
    from lidarslam_tpu.config import SamplingMode

    cfg = full_jax_config(bench_cfg)
    return dataclasses.replace(
        cfg, use_blobs=True,
        blob_map=dataclasses.replace(cfg.blob_map, leaf_size=0.30, capacity=1 << 16,
                                     sampling=SamplingMode.CENTER_POINT),
        plane_map=dataclasses.replace(cfg.plane_map, sampling=SamplingMode.CENTROID),
        edge_map=dataclasses.replace(cfg.edge_map, decaying_threshold=chip_smoke.EXT_DECAY_S),
        wheel_odom_weight=chip_smoke.EXT_ODOM_WEIGHT, imu_weight=chip_smoke.EXT_IMU_WEIGHT)


def _pgo(slam, frames, path):
    """The synchronous run (a checkpoint after chip_smoke.CKPT_AT sweeps,
    resumed twice), then the PGO against ground-truth GPS."""
    import tempfile

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from lidarslam_tpu import Slam
    from lidarslam_tpu.config import Keypoint
    from lidarslam_tpu.core import se3

    results = []
    ckpt = tempfile.mkdtemp()
    for i, f in enumerate(frames):
        if i == chip_smoke.CKPT_AT:
            slam.save_checkpoint(f"{ckpt}/c.npz")
            kps = jax.tree.map(np.array, slam._device_keypoints)
        results.append(slam.add_frame(f))
        print(f"frame {i}: n_matches {results[-1]['n_matches']} failure "
              f"{results[-1]['failure']}", file=sys.stderr)
    resume = []
    for with_keypoints in (False, True):
        b = Slam(slam.cfg)
        b.load_checkpoint(f"{ckpt}/c.npz")
        if with_keypoints:
            b._device_keypoints = jax.tree.map(jnp.asarray, kps)
        resume.append(max(float(np.linalg.norm(b.add_frame(f)["pose"][:3, 3]
                                               - r["pose"][:3, 3]))
                          for f, r in zip(frames[chip_smoke.CKPT_AT:],
                                          results[chip_smoke.CKPT_AT:])))
    print(f"resumed from the checkpoint: {resume[0]:.3e} m as loaded, {resume[1]:.3e} m "
          "with the previous keypoints", file=sys.stderr)
    log = slam.log_trajectory
    times = np.array([e["time"] for e in log])
    before = np.stack([e["pose"] for e in log])
    covs = np.stack([e["covariance"] if np.trace(e["covariance"]) > 0 else np.eye(6) * 1e-4
                     for e in log])
    gt0 = se3.hmat_inverse(frames[0]["gt_pose"])
    gps = np.stack([(gt0 @ f["gt_pose"])[:3, 3] for f in frames])
    if not slam.run_pose_graph_optimization(gps, times, use_device_backend=True):
        raise SystemExit("the JAX package's PGO failed")
    after = np.stack([e["pose"] for e in slam.log_trajectory])
    valid = [int(np.asarray(slam.maps[k].valid).sum()) if k in slam.maps else 0
             for k in Keypoint]
    np.savez_compressed(path, times=times, poses_before=before, covariances=covs, gps=gps,
                        poses_after=after, map_valid=np.asarray(valid, np.int64),
                        resume_m=np.asarray(resume, np.float64))
    print(f"wrote {path}: max PGO move "
          f"{np.abs(after[:, :3, 3] - before[:, :3, 3]).max():.3e} m, maps {valid}",
          file=sys.stderr)


def _cli(frames, path):
    """The JAX package's CLI on the outdoor preset over the sweeps as PCDs
    (see the docstring's `cli`)."""
    import contextlib
    import io
    import json
    import shutil
    import tempfile

    import chip_smoke
    from lidarslam_tpu import cli
    from lidarslam_tpu.io import csv_log, native, pcd

    if not native.available():
        raise SystemExit("the JAX package's native ingest did not load: "
                         "the CLI reference takes it (no ingest switch)")
    tmp = Path(tempfile.mkdtemp())
    (tmp / "pcd").mkdir()
    (tmp / "first").mkdir()
    pcds = chip_smoke.write_cli_pcds(frames, tmp / "pcd", pcd.save_pcd)
    for src, _ in pcds[:chip_smoke.CLI_EXTRACT]:
        shutil.copy(src, tmp / "first" / src.name)
    config = str(ROOT / "configs" / "slam_config_outdoor.yaml")

    def run(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--cpu", *argv])
        if rc:
            raise SystemExit(f"the JAX CLI {argv[0]} exited {rc}")
        print(f"cli {argv[0]}{' --follow' if '--follow' in argv else ''}: "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    rec = {"pcd_sha256": np.asarray([h for _, h in pcds]), "ingest": np.asarray("native")}
    for mode, extra in (("sync", ["--aggregate"]), ("follow", ["--follow"])):
        out = tmp / mode
        info = run("run", "--config", config, "--pcd-dir", str(tmp / "pcd"), "--out",
                   str(out), "--log-dir", str(out / "log"), *extra)
        rows = np.loadtxt(out / "Poses.csv", ndmin=2)
        ev = csv_log.read_evaluators_csv(out / "Evaluators.csv")
        with open(out / "Trajectory.csv") as f:
            header = f.readline().strip().split(",")
        failed = np.loadtxt(out / "Trajectory.csv", delimiter=",", skiprows=1,
                            ndmin=2)[:, header.index("failure")]
        rec.update({f"{mode}_poses": rows, f"{mode}_overlap": ev[:, 1],
                    f"{mode}_n_matches": ev[:, 2].astype(np.int64),
                    f"{mode}_failed": np.int64(failed.sum())})
        if mode == "sync":
            rec["aggregated_points"] = np.int64(info["aggregated_points"])
            agg = run("aggregate", "--log-dir", str(out / "log"), "--trajectory",
                      str(out / "Trajectory.csv"), "--out", str(tmp / "agg.pcd"))
            rec["aggregate_points"] = np.int64(agg["points"])
        print(f"{mode}: {len(rows)} poses, {int(failed.sum())} failed, n_matches "
              f"{ev[:, 2].astype(int).tolist()}", file=sys.stderr)
    run("extract", "--config", config, "--pcd-dir", str(tmp / "first"), "--out",
        str(tmp / "ext"), "--blobs")
    summary = json.loads((tmp / "ext" / "extraction.json").read_text())
    rec["extract_counts"] = np.asarray([[s["edge"], s["plane"], s["blob"]] for s in summary],
                                       np.int64)
    rec["extract_az"] = np.asarray([s["azimuthal_resolution"] for s in summary])
    if rec["aggregate_points"] != rec["aggregated_points"]:
        raise SystemExit(f"aggregate {rec['aggregate_points']} points, the run "
                         f"{rec['aggregated_points']}")
    np.savez_compressed(path, **rec)
    shutil.rmtree(tmp)
    print(f"wrote {path} ({path.stat().st_size} B): aggregated {rec['aggregated_points']}, "
          f"extraction {rec['extract_counts'].tolist()}", file=sys.stderr)


# the mesh references' runs: (key, drive, Slam flags)
MESH_RUNS = (("bench_kp", "bench", {}), ("bench_ext", "bench", {"shard_extraction": True}),
             ("bench_maps", "bench", {"shard_maps": True}),
             ("full_maps", "full", {"shard_maps": True}))
MESH_DEVICES = 2


# the mesh stream references' runs: (key, Slam flags), on the bench drive
MESH_STREAM_RUNS = (("bench_kp", {}), ("bench_ext", {"shard_extraction": True}),
                    ("bench_maps", {"shard_maps": True}))


def _mesh(Slam, cfgs, drives, path, stream=False):
    """`MESH_RUNS` on a `MESH_DEVICES`-device CPU mesh, sync path; with
    `stream`, `MESH_STREAM_RUNS` through `add_frame_async` + one `flush`."""
    from lidarslam_tpu.parallel import sharded

    mesh = sharded.make_mesh(MESH_DEVICES)
    arrs = {}
    runs = tuple((key, "bench", kw) for key, kw in MESH_STREAM_RUNS) if stream else MESH_RUNS
    for key, drive, kw in runs:
        slam = Slam(cfgs[drive], mesh=mesh, **kw)
        if stream:
            for f in drives[drive]:
                slam.add_frame_async(f)
            results = slam.flush()
        else:
            results = [slam.add_frame(f) for f in drives[drive]]
        print(f"{key}: n_matches " + " ".join(str(r["n_matches"]) for r in results),
              file=sys.stderr)
        arrs[f"{key}_poses"] = np.asarray([r["pose"] for r in results], np.float64)
        arrs[f"{key}_n_matches"] = np.asarray([r["n_matches"] for r in results], np.int64)
        arrs[f"{key}_failure"] = np.asarray([r["failure"] for r in results], bool)
        arrs[f"{key}_overlap"] = np.asarray([r["overlap"] for r in results], np.float64)
    arrs["stamps"] = np.asarray([f["stamp"] for f in drives["bench"]], np.float64)
    np.savez_compressed(path, mesh_devices=np.int64(MESH_DEVICES), **arrs)
    print(f"wrote {path}", file=sys.stderr)


def _extract(path):
    import jax
    import jax.numpy as jnp

    from chip_smoke import EXTRACT_AZ, extract_drive, sweep_sha256
    from lidarslam_tpu.io import synthetic
    from lidarslam_tpu.io.yaml_config import load_config
    from lidarslam_tpu.ops import extractor, frame

    preset = load_config(str(ROOT / "configs" / "slam_config_outdoor.yaml")).extractor
    run = jax.jit(extractor.extract_keypoints, static_argnums=2)
    out = {}
    for rings in (16, 64):
        cfg = dataclasses.replace(preset, n_rings=rings, max_ring_points=2048)
        sets = {}
        frames = extract_drive(synthetic, rings)
        for f in frames:
            ri = frame.build_range_image(f["xyz"], f["intensity"], f["laser_id"], f["time"],
                                         rings, 2048, packed=True).unpack()
            ext = run(ri, jnp.float32(np.float32(EXTRACT_AZ)), cfg)
            for name in ("edges", "planes", "blobs"):
                kp = getattr(ext, name)
                for field in kp._fields:
                    sets.setdefault(f"r{rings}_{name}_{field}", []).append(
                        np.asarray(getattr(kp, field)))
        out.update({k: np.stack(v) for k, v in sets.items()})
        out[f"r{rings}_sha256"] = np.asarray([sweep_sha256(f) for f in frames])
        print(f"extract {rings} rings: edges / planes / blobs "
              f"{[out[f'r{rings}_{n}_count'].tolist() for n in ('edges', 'planes', 'blobs')]}",
              file=sys.stderr)
    np.savez_compressed(path, az=np.float32(EXTRACT_AZ), **out)
    print(f"wrote {path}", file=sys.stderr)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(ROOT / "lidarslam_tpu_torch" / "data"))
    ap.add_argument("--which", choices=("bench", "full", "ext", "float", "rig", "pgo", "cli",
                                        "mesh", "mesh_stream", "extract", "all"),
                    default="all")
    args = ap.parse_args()

    if args.which in ("mesh", "mesh_stream", "all") and \
            "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_"
                                   f"platform_device_count={MESH_DEVICES}").strip()
    import jax

    jax.config.update("jax_platform_name", "cpu")
    import bench
    import chip_smoke
    from chip_smoke import N_FRAMES
    from lidarslam_tpu import Slam
    from lidarslam_tpu.io import native, synthetic

    native_available = native.available
    native.available = lambda: False      # numpy ingest (see the docstring)
    cfg = bench.bench_config(16, 1800)
    if cfg.stream_window != 8 or not cfg.flat_wire:
        raise SystemExit("bench_config no longer streams 8-sweep flat-wire windows")
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def frames(distorted):
        return synthetic.generate_sequence(
            n_frames=N_FRAMES, sensor=synthetic.SensorModel(n_rings=16, n_azimuth=1800),
            trajectory=synthetic.weaving_street_trajectory(), motion_distortion=distorted)

    t0 = time.perf_counter()
    if args.which in ("bench", "all"):
        _run_both(Slam, cfg, frames(False), out, "vlp16_bench_ref.npz",
                  "vlp16_bench_stream_ref.npz")
    if args.which in ("full", "all"):
        _run_both(Slam, full_jax_config(cfg), frames(True), out, "vlp16_full_ref.npz",
                  "vlp16_full_stream_ref.npz")
    if args.which in ("ext", "all"):
        sensors = chip_smoke.sensor_measurements(synthetic.weaving_street_trajectory(),
                                                 chip_smoke.SENSOR_END_S)
        _run_both(Slam, ext_jax_config(cfg), frames(True), out, "vlp16_ext_ref.npz",
                  "vlp16_ext_stream_ref.npz", sensors=sensors)
    if args.which in ("float", "all"):
        _run_both(Slam, dataclasses.replace(cfg, compress_upload=False), frames(False), out,
                  None, "vlp16_bench_float_stream_ref.npz", per_type=True)
    if args.which in ("rig", "all"):
        native.available = native_available
        rig_cfg = full_jax_config(cfg)
        rig_cfg = dataclasses.replace(
            rig_cfg, device_extractors=((1, dataclasses.replace(rig_cfg.extractor)),))
        acquisitions, offset = chip_smoke.render_rig(N_FRAMES)
        _run_both(Slam, rig_cfg, acquisitions, out, "vlp16_rig_ref.npz",
                  "vlp16_rig_stream_ref.npz", offset=offset, per_type=True)
    if args.which in ("pgo", "all"):
        native.available = lambda: False
        _pgo(Slam(full_jax_config(cfg)), frames(True), out / "vlp16_pgo_ref.npz")
    if args.which in ("cli", "all"):
        native.available = native_available
        _cli(frames(True), out / "vlp16_cli_ref.npz")
    if args.which in ("mesh", "all"):
        native.available = lambda: False
        _mesh(Slam, {"bench": cfg, "full": full_jax_config(cfg)},
              {"bench": frames(False), "full": frames(True)}, out / "vlp16_mesh_ref.npz")
    if args.which in ("mesh", "mesh_stream", "all"):
        native.available = lambda: False
        _mesh(Slam, {"bench": cfg}, {"bench": frames(False)},
              out / "vlp16_mesh_stream_ref.npz", stream=True)
    if args.which in ("extract", "all"):
        native.available = lambda: False
        _extract(out / "extract_ref.npz")
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
