#!/usr/bin/env python3
"""Where the limits of chip_smoke.py phase 7 come from: `chip_smoke.ext_config`
on the phase's 30 VLP-16 sweeps rendered with motion distortion, on one
CUDA card and its host:

    python3 scripts/ext_witness.py

Runs, each through `Slam.add_frame` and through `add_frame_async` + `flush`:

- "cuda": the path phase 7 checks;
- "cpu": the same code on the host's CPU (the plain k-NN, the CPU's
  rounding). It is the witness of how far rounding alone moves a run of
  this drive;
- "no sensors": on the card with no wheel-odometry or IMU reading fed, so
  the sensor blocks are dropped. A control;
- "bf16 blobs": on the card with each blob match's ellipsoid A rounded to
  bfloat16. A control;
- "max-intensity planes": on the card with the plane map on the bench's
  MAX_INTENSITY sampling instead of CENTROID, as a port that ignored the
  mode would run. A control.

It prints each run's `chip_smoke.ext_readings` against the JAX reference
of its path (`vlp16_ext_ref.npz`, `vlp16_ext_stream_ref.npz`) and the CPU
runs' readings against the card's, as one JSON line that it also writes
to `results/ext_witness.json`. A limit of phase 7 (`EXT_TOL`) belongs
above the "cuda" and "cpu" readings and below a control's. The two CPU
runs go to two worker processes, started first; they take most of the
time (~10 min on an 8-core host).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "results"       # the worker runs' records and the result (gitignored)
CPU_THREADS = 4             # per CPU worker; two run at once


def _frames_and_sensors():
    import chip_smoke

    from lidarslam_tpu_torch.io import synthetic

    frames = chip_smoke.render_frames(chip_smoke.N_FRAMES, motion_distortion=True)
    sensors = chip_smoke.sensor_measurements(synthetic.weaving_street_trajectory(),
                                             chip_smoke.SENSOR_END_S)
    return frames, sensors


def _record(cfg, frames, sensors, path, device):
    """One run in ext_record's format."""
    import chip_smoke

    with chip_smoke.numpy_ingest():     # as the JAX references were made
        results, counts, slam, _ = chip_smoke._ext_run(cfg, frames, sensors,
                                                       path == "stream", device)
    return chip_smoke.ext_record(results, counts, slam, frames[-1]["stamp"])


def _bf16_blob_matches(match):
    """`match` with its ellipsoids A rounded to bfloat16."""
    import torch

    def rounded(*args, **kwargs):
        m = match(*args, **kwargs)
        return m._replace(A6=m.A6.to(torch.bfloat16).to(torch.float32))
    return rounded


def cpu_worker(path: str, out: str) -> int:
    """The "cpu" run of `path`, saved to `out` (.npz)."""
    import numpy as np
    import torch

    import chip_smoke

    torch.set_num_threads(CPU_THREADS)
    frames, sensors = _frames_and_sensors()
    t0 = time.perf_counter()
    rec = _record(chip_smoke.ext_config(), frames, sensors, path, "cpu")
    np.savez(out, **rec)
    print(f"[witness] cpu {path}: {len(frames)} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ext_witness.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    from lidarslam_tpu_torch.config import Keypoint, SamplingMode
    from lidarslam_tpu_torch.ops import icp

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    OUT.mkdir(exist_ok=True)
    workers = {path: subprocess.Popen([sys.executable, __file__, "--cpu", path,
                                       str(OUT / f"ext_witness_cpu_{path}.npz")],
                                      env={**os.environ, "OMP_NUM_THREADS": str(CPU_THREADS)})
               for path in ("sync", "stream")}
    try:
        cfg = chip_smoke.ext_config()
        frames, sensors = _frames_and_sensors()
        refs = {"sync": dict(np.load(chip_smoke.EXT_REF_PATH)),
                "stream": dict(np.load(chip_smoke.EXT_STREAM_REF_PATH))}
        runs = {}
        for name in ("cuda", "no sensors", "bf16 blobs", "max-intensity planes"):
            real = icp._MATCH_FNS[Keypoint.BLOB]
            if name == "bf16 blobs":
                icp._MATCH_FNS[Keypoint.BLOB] = _bf16_blob_matches(real)
            run_cfg = cfg if name != "max-intensity planes" else dataclasses.replace(
                cfg, plane_map=dataclasses.replace(cfg.plane_map,
                                                   sampling=SamplingMode.MAX_INTENSITY))
            try:
                for path in ("sync", "stream"):
                    runs[(name, path)] = _record(run_cfg, frames, None if name == "no sensors"
                                                 else sensors, path, "cuda")
                    print(f"[witness] {name} {path} done at "
                          f"{time.perf_counter() - t_start:.1f} s", flush=True)
            finally:
                icp._MATCH_FNS[Keypoint.BLOB] = real
        for path, w in workers.items():
            if w.wait(timeout=2000) != 0:
                raise RuntimeError(f"the CPU {path} run exited {w.returncode}")
            runs[("cpu", path)] = dict(np.load(OUT / f"ext_witness_cpu_{path}.npz"))
    finally:
        for w in workers.values():
            if w.poll() is None:
                w.kill()
                w.wait()
    out = {"card": card, "frames": len(frames),
           "against_jax": {f"{name} {path}": chip_smoke.ext_readings(rec, refs[path])
                           for (name, path), rec in runs.items()},
           "cpu_against_cuda": {path: chip_smoke.ext_readings(runs[("cpu", path)],
                                                              runs[("cuda", path)])
                                for path in ("sync", "stream")},
           "ext_tol": chip_smoke.EXT_TOL, "seconds": time.perf_counter() - t_start}
    line = json.dumps(out)
    (OUT / "ext_witness.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--cpu":
        sys.exit(cpu_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
