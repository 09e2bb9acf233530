#!/usr/bin/env python3
"""Write the JAX package's VLP-16 trajectories for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py [--which bench|full|all]

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
  `vlp16_full_stream_ref.npz`.

Each holds per frame the poses (float64 4x4), `n_matches`, `failure`,
`overlap`, `comply_motion_limits` and `stamps`. `chip_smoke.py` holds the
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


def _save(path, results, frames):
    np.savez_compressed(
        path, poses=np.asarray([r["pose"] for r in results], np.float64),
        n_matches=np.asarray([r["n_matches"] for r in results], np.int64),
        failure=np.asarray([r["failure"] for r in results], bool),
        overlap=np.asarray([r["overlap"] for r in results], np.float64),
        comply_motion_limits=np.asarray([r["comply_motion_limits"] for r in results], bool),
        stamps=np.asarray([f["stamp"] for f in frames], np.float64))
    print(f"wrote {path} ({len(results)} frames)", file=sys.stderr)


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


def _run_both(Slam, cfg, frames, out, sync_name, stream_name):
    slam = Slam(cfg)
    results = []
    for i, f in enumerate(frames):
        results.append(slam.add_frame(f))
        print(f"frame {i}: n_matches {results[-1]['n_matches']} "
              f"failure {results[-1]['failure']} overlap {results[-1]['overlap']:.4f} "
              f"comply {results[-1]['comply_motion_limits']}", file=sys.stderr)
    _save(out / sync_name, results, frames)

    slam = Slam(cfg)
    for f in frames:
        slam.add_frame_async(f)
    results = slam.flush()
    print("stream n_matches " + " ".join(str(r["n_matches"]) for r in results),
          file=sys.stderr)
    _save(out / stream_name, results, frames)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(ROOT / "lidarslam_tpu_torch" / "data"))
    ap.add_argument("--which", choices=("bench", "full", "all"), default="all")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platform_name", "cpu")
    import bench
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
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
