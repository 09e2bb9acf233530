#!/usr/bin/env python3
"""Write the JAX package's VLP-16 bench trajectory for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py

Runs `lidarslam_tpu.Slam.add_frame` at `bench.py::bench_config(16, 1800)`
over the first `chip_smoke.N_FRAMES` (30) sweeps of the bench sequence
(weaving street trajectory, no motion distortion) on the CPU, and writes
`lidarslam_tpu_torch/data/vlp16_bench_ref.npz`: the poses (float64 4x4),
`n_matches` and `failure` per frame. `chip_smoke.py` holds the port's
trajectory on the GPU against this file, since the GPU machine has no jax.

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "lidarslam_tpu_torch" / "data"
                                         / "vlp16_bench_ref.npz"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platform_name", "cpu")
    import bench
    from chip_smoke import N_FRAMES
    from lidarslam_tpu import Slam
    from lidarslam_tpu.io import native, synthetic

    native.available = lambda: False      # numpy ingest, as the port has
    cfg = bench.bench_config(16, 1800)
    frames = synthetic.generate_sequence(
        n_frames=N_FRAMES, sensor=synthetic.SensorModel(n_rings=16, n_azimuth=1800),
        trajectory=synthetic.weaving_street_trajectory(), motion_distortion=False)
    slam = Slam(cfg)
    poses, n_matches, failure = [], [], []
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        r = slam.add_frame(f)
        poses.append(r["pose"])
        n_matches.append(r["n_matches"])
        failure.append(r["failure"])
        print(f"frame {i}: n_matches {r['n_matches']} failure {r['failure']}",
              file=sys.stderr)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, poses=np.asarray(poses, np.float64),
                        n_matches=np.asarray(n_matches, np.int64),
                        failure=np.asarray(failure, bool),
                        stamps=np.asarray([f["stamp"] for f in frames], np.float64))
    print(f"wrote {args.out} ({len(frames)} frames, "
          f"{time.perf_counter() - t0:.1f} s)", file=sys.stderr)


if __name__ == "__main__":
    main()
