"""The program's ego-motion registration held to its plain float64
reference (`ego_reference.py`) on a cell's own drive. Not part of a
benchmark run: `correct` is decided by `check.py` alone.

    python3 slambench/ego_check.py --workload vlp16_outdoor_egoreg.robot-live \\
        --seeds 11,12,13 --seconds 50 [--control bf16] [--every 10] [--out FILE]

Each seed drives the cell as `run.py` does (the lap cast on the card from
the seed, `Slam` built through the port's yaml loader, the mix's warm-up,
then `add_frame` in closed loop for --seconds) and, on every --every-th
sweep of the window, computes the reference in float64 on the card from
the inputs the program had: the sweep's edge and plane keypoints
(`Slam.current_keypoints` after the call), the previous sweep's (before
it) and the prior the call gave the step (`Slam.ego_prior`). The gap
between the program's refined ego-motion (`Slam.ego_motion`) and the
reference's is a translation [m] and a rotation angle [rad]. One JSON line
per seed: the widest gaps, whether they are within `TOLERANCE`, the rounds
and LM trips both counted.

`--control bf16` plants the control underneath: the stage's inputs (both
sweeps' keypoints) and its solve (the pose each LM solve starts from and
returns, H and g of every evaluation) rounded through bfloat16, while the
reference still gets the keypoints unrounded. It has to fail `TOLERANCE`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# The widest gap a sound run may show, per sweep checked. Set between the
# widest gap of sound runs and the narrowest of the bfloat16 control at the
# cell's size on the card, over whole 50 s windows (PERF.md §4): sound
# 1.6e-04 to 6.7e-04 m and 2.4e-05 to 1.2e-04 rad (float32 rounding in the
# matcher's PCA and the LM solve, and the match gates it flips), the
# control 1.7e-02 to 1.8e-02 m and 3.2e-03 to 4.2e-03 rad (bfloat16
# keypoints, 0.06-0.25 m steps at their ranges, and solve). Each limit
# lies about 4.5x above the one and 5.5x below the other.
TOLERANCE = {"trans_m": 3e-3, "rot_rad": 6e-4}


def gaps(a, b) -> dict:
    """Translation [m] and rotation angle [rad] between two xyzrpy poses."""
    import torch

    from slambench import ego_reference as ref

    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    R = ref.rotation(a[3:6]).T @ ref.rotation(b[3:6])
    cos = float(((torch.trace(R) - 1.0) / 2.0).clamp(-1.0, 1.0))
    return {"trans_m": float((a[:3] - b[:3]).norm()), "rot_rad": math.acos(cos)}


def _bf16(x):
    import torch

    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def bf16_ego():
    """The control: the ego stage (`pipeline._ego_registration`) with its
    keypoints and solve rounded through bfloat16. Patched through module
    attributes, so a `Slam` built inside it, and a graph it captures, run
    the rounding."""
    from lidarslam_tpu_torch.ops import pipeline, solver

    real_stage, real_eval, real_lm = pipeline._ego_registration, solver._evaluate, solver.robust_lm

    def evaluate(*a, **k):
        cost, H, g = real_eval(*a, **k)
        return cost, _bf16(H), _bf16(g)

    def lm(blocks, pose0, *a, **k):
        res = real_lm(blocks, _bf16(pose0), *a, **k)
        return res._replace(pose=_bf16(res.pose))

    def stage(kps, prev, prior, *a, **k):
        kps = tuple(kp._replace(xyz=_bf16(kp.xyz)) for kp in kps)
        prev = tuple(kp._replace(xyz=_bf16(kp.xyz)) for kp in prev)
        solver._evaluate, solver.robust_lm = evaluate, lm
        try:
            return real_stage(kps, prev, prior, *a, **k)
        finally:
            solver._evaluate, solver.robust_lm = real_eval, real_lm

    pipeline._ego_registration = stage
    try:
        yield
    finally:
        pipeline._ego_registration = real_stage


def params(cfg_file: dict):
    """The reference's parameters from a configuration file's preset."""
    from slambench import ego_reference as ref

    return ref.EgoParams.from_block(cfg_file["slam"]["ego_motion_registration"])


def held(slam, prev, prm) -> dict:
    """The last add_frame's ego-motion against the reference computed from
    its inputs (`prev`: the previous sweep's keypoints per type)."""
    from lidarslam_tpu_torch.config import Keypoint

    from slambench import ego_reference as ref

    cur = slam.current_keypoints
    e, p = cur[Keypoint.EDGE], cur[Keypoint.PLANE]
    pe, pp = prev[Keypoint.EDGE], prev[Keypoint.PLANE]
    r = ref.register(e.xyz[e.valid], p.xyz[p.valid], pe.xyz[pe.valid], pe.ring[pe.valid],
                     pp.xyz[pp.valid], slam.ego_prior, prm)
    out = gaps(slam.ego_motion, r.motion)
    out.update(rounds=[slam.ego_rounds, r.rounds], lm_steps=[slam.ego_lm_steps, r.lm_steps],
               matches=r.matches, failed=r.failed)
    return out


def check(workload: str, seed: int, seconds: float, every: int = 10, control=None,
          device="cuda", sensor_override=None, lap_sweeps=None) -> dict:
    """One seed's drive of the cell, every `every`-th sweep of its window
    held to the reference (see the module docstring). Tests pass
    `device="cpu"` with a smaller sensor and lap."""
    import dataclasses

    import torch

    from lidarslam_tpu_torch import Slam

    from slambench import circuit as circuit_mod, raycast, run, spec

    wl = spec.workload(spec.benchmark(), workload)
    cfg_file = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    if mix["path"] != "live":
        raise ValueError(f"{workload}: the check drives add_frame, a live mix")
    sensor = dict(cfg_file["sensor"], **(sensor_override or {}))
    device = torch.device(device)
    circ = circuit_mod.make_circuit(mix, sensor)
    if lap_sweeps is not None:
        circ = dataclasses.replace(circ, n_sweeps=int(lap_sweeps))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    drive = run.Drive(circ, raycast.render_lap(circ, sensor, gen, device))
    prm = params(cfg_file)
    with bf16_ego() if control == "bf16" else contextlib.nullcontext():
        slam = Slam(run.slam_config(cfg_file), device=device)
        warm = int(mix["warmup_sweeps"])
        for j in range(warm):
            slam.add_frame(drive.frame(j))
        rows, j = [], warm
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            prev = slam.current_keypoints
            slam.add_frame(drive.frame(j))
            if (j - warm) % every == 0:
                rows.append(held(slam, prev, prm))
            j += 1
    worst = {k: max(r[k] for r in rows) for k in TOLERANCE}
    return {"workload": workload, "seed": seed, "control": control, "sweeps": j - warm,
            "checked": len(rows), "replays": slam.live_replays, "worst": worst,
            "within": all(worst[k] <= TOLERANCE[k] for k in TOLERANCE),
            "rounds": [r["rounds"] for r in rows], "lm_steps": [r["lm_steps"] for r in rows],
            "ref_failed": sum(r["failed"] for r in rows),
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--control", choices=("bf16",), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from slambench import run

    run.use_checkout_caches()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(check(args.workload, seed, args.seconds, args.every, args.control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
