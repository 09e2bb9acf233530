"""Breaks planted in the program underneath the harness, for the control
and the faults that `correct` has to catch (`readings.py` on the card at a
cell's own size, `tests/test_slambench_runs.py` on the CPU).

- `bf16`, the control: the program computing in bfloat16, the precision
  below the float32 that the configurations state. Every sweep's keypoints
  (in the sensor frame, as extraction returns them), every point the map
  update inserts, and the solver's state (the pose each LM solve starts
  from and returns, and the normal equations H and g of every evaluation)
  are rounded through bfloat16;
- `bf16_nopose`: the same with the solver's pose left in float32;
- `icp1`: one localization ICP round where the configuration states 3;
- `once`: undistortion ONCE where the configuration states REFINED (the
  warp is not refined as the pose moves);
- `stuck`: every sweep's answer is the first pose (a step that returns its
  state unchanged);
- `altered`: every other answer moved 0.1 m where it is produced;
- `half`: half of each stream window run, the rest left out.

`planted(kind)` is a context manager; the program is patched through its
module attributes, so a `Slam` built inside it (and a CUDA graph it
captures) runs the break.
"""

from __future__ import annotations

import contextlib
import dataclasses

KINDS = ("bf16", "bf16_nopose", "icp1", "once", "stuck", "altered", "half")


def _bf16(x):
    import torch

    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def planted(kind: str):
    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.config import UndistortionMode
    from lidarslam_tpu_torch.ops import extractor, pipeline, solver, voxel_map

    from slambench import run

    patches = []

    def patch(obj, name, value):
        patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if kind in ("bf16", "bf16_nopose"):
        orig_extract, orig_add, orig_eval, orig_lm = (
            extractor.extract_keypoints, voxel_map.add_points, solver._evaluate,
            solver.robust_lm)

        def extract(*a, **k):
            ext = orig_extract(*a, **k)
            return ext._replace(**{f: getattr(ext, f)._replace(xyz=_bf16(getattr(ext, f).xyz))
                                   for f in ("edges", "planes", "blobs")})

        def add(vmap_, new_xyz, *a, **k):
            return orig_add(vmap_, _bf16(new_xyz), *a, **k)

        def evaluate(*a, **k):
            cost, H, g = orig_eval(*a, **k)
            return cost, _bf16(H), _bf16(g)

        def lm(blocks, pose0, *a, **k):
            res = orig_lm(blocks, _bf16(pose0), *a, **k)
            return res._replace(pose=_bf16(res.pose))

        patch(extractor, "extract_keypoints", extract)
        patch(voxel_map, "add_points", add)
        patch(solver, "_evaluate", evaluate)
        if kind == "bf16":
            patch(solver, "robust_lm", lm)
    elif kind in ("icp1", "once"):
        orig_cfg = run.slam_config
        change = {"icp1": {"localization_icp_max_iter": 1},
                  "once": {"undistortion": UndistortionMode.ONCE}}[kind]
        patch(run, "slam_config", lambda cfg: dataclasses.replace(orig_cfg(cfg), **change))
    elif kind in ("stuck", "altered"):
        orig_unpack = pipeline.unpack_scalars
        seen = {"n": 0}

        def stuck(packed):
            u = orig_unpack(packed)
            u["pose"] = seen.setdefault("pose", u["pose"].copy()).copy()
            return u

        def altered(packed):
            u = orig_unpack(packed)
            seen["n"] += 1
            if seen["n"] % 2 == 0:
                u["pose"] = u["pose"].copy()
                u["pose"][0] += 0.1
            return u

        patch(pipeline, "unpack_scalars", stuck if kind == "stuck" else altered)
    elif kind == "half":
        orig_window = Slam._run_window
        patch(Slam, "_run_window", lambda self, buf: orig_window(self, buf[:max(1, len(buf) // 2)]))
    else:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
    try:
        yield
    finally:
        for obj, name, value in reversed(patches):
            setattr(obj, name, value)
