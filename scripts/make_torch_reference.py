#!/usr/bin/env python3
"""Write the JAX package's VLP-16 trajectories for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py [--which bench|full|ext|all]

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
  `vlp16_ext_ref.npz`, `vlp16_ext_stream_ref.npz`.

Each holds per frame the poses (float64 4x4), `n_matches`, `failure`,
`overlap`, `comply_motion_limits` and `stamps`; the `ext` files also the
per-type match counts (`match_counts`), each map's valid slots after the
last frame (`map_valid`) and the age of the edge map's oldest removable
point then (`edge_oldest_age`). `chip_smoke.py` holds the
port's trajectories on the GPU against these files, since the GPU machine
has no jax.

The sweeps go through the JAX package's numpy ingest (its optional native
C++ ingest is switched off for the run): the port has no native ingest
yet, and the two differ in the rounding of a few quantized coordinates.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _run_both(Slam, cfg, frames, out, sync_name, stream_name, sensors=None):
    """Both paths; `sensors`: chip_smoke.sensor_measurements fed to each
    Slam first, and the map record and per-type match counts saved."""
    import chip_smoke

    def start():
        slam = Slam(cfg)
        if sensors is not None:
            chip_smoke.feed_sensors(slam, sensors)
        return slam

    def extra(slam, counts):
        if sensors is None:
            return {}
        return {**_map_record(slam, frames[-1]["stamp"]),
                "match_counts": np.asarray(counts, np.int64)}

    slam = start()
    results, counts = [], []
    for i, f in enumerate(frames):
        results.append(slam.add_frame(f))
        counts.append(slam.match_counts.copy())
        print(f"frame {i}: n_matches {results[-1]['n_matches']} {counts[-1].tolist()} "
              f"failure {results[-1]['failure']} overlap {results[-1]['overlap']:.4f} "
              f"comply {results[-1]['comply_motion_limits']}", file=sys.stderr)
    _save(out / sync_name, results, frames, **extra(slam, counts))

    slam = start()
    for f in frames:
        slam.add_frame_async(f)
    counts = []
    real = slam._log_state

    def log_state(stamp):     # flush logs each frame after setting match_counts
        counts.append(slam.match_counts.copy())
        real(stamp)
    slam._log_state = log_state
    results = slam.flush()
    print("stream n_matches " + " ".join(str(r["n_matches"]) for r in results),
          file=sys.stderr)
    _save(out / stream_name, results, frames, **extra(slam, counts))


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(ROOT / "lidarslam_tpu_torch" / "data"))
    ap.add_argument("--which", choices=("bench", "full", "ext", "all"), default="all")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platform_name", "cpu")
    import bench
    import chip_smoke
    from chip_smoke import N_FRAMES
    from lidarslam_tpu import Slam
    from lidarslam_tpu.io import native, synthetic

    native.available = lambda: False      # numpy ingest, as the port has
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
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
