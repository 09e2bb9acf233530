#!/usr/bin/env python3
"""Write the JAX package's VLP-16 bench trajectories for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py

Runs the JAX package's `Slam` at `bench.py::bench_config(16, 1800)` over the
first `chip_smoke.N_FRAMES` (30) sweeps of the bench sequence (weaving
street trajectory, no motion distortion) on the CPU, twice, and writes two
files into `lidarslam_tpu_torch/data/`:

- `vlp16_bench_ref.npz`: `Slam.add_frame` per sweep (the synchronous path);
- `vlp16_bench_stream_ref.npz`: `Slam.add_frame_async` for every sweep and
  one `flush` (the streaming path, `stream_window=8`, flat wire).

Each holds the poses (float64 4x4), `n_matches`, `failure` and `stamps` per
frame. `chip_smoke.py` holds the port's trajectories on the GPU against
these files, since the GPU machine has no jax.

The sweeps go through the JAX package's numpy ingest (its optional native
C++ ingest is switched off for the run): the port has no native ingest
yet, and the two differ in the rounding of a few quantized coordinates.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _save(path, results, frames):
    np.savez_compressed(path, poses=np.asarray([r["pose"] for r in results], np.float64),
                        n_matches=np.asarray([r["n_matches"] for r in results], np.int64),
                        failure=np.asarray([r["failure"] for r in results], bool),
                        stamps=np.asarray([f["stamp"] for f in frames], np.float64))
    print(f"wrote {path} ({len(results)} frames)", file=sys.stderr)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=str(ROOT / "lidarslam_tpu_torch" / "data"))
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
    frames = synthetic.generate_sequence(
        n_frames=N_FRAMES, sensor=synthetic.SensorModel(n_rings=16, n_azimuth=1800),
        trajectory=synthetic.weaving_street_trajectory(), motion_distortion=False)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    slam = Slam(cfg)
    results = []
    for i, f in enumerate(frames):
        results.append(slam.add_frame(f))
        print(f"frame {i}: n_matches {results[-1]['n_matches']} "
              f"failure {results[-1]['failure']}", file=sys.stderr)
    _save(out / "vlp16_bench_ref.npz", results, frames)

    slam = Slam(cfg)
    for f in frames:
        slam.add_frame_async(f)
    results = slam.flush()
    print("stream n_matches " + " ".join(str(r["n_matches"]) for r in results),
          file=sys.stderr)
    _save(out / "vlp16_bench_stream_ref.npz", results, frames)
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
