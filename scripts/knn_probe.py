#!/usr/bin/env python3
"""The k-NN kernel on the port's main paths, for the checkout this script
lies in, on one CUDA card:

    python3 scripts/knn_probe.py

1. stream: 17 sweeps of the VLP-16 bench sequence through
   `Slam.add_frame_async`, then a torch.profiler window over the next 8
   (one window of CUDA-graph replays): device busy ms/frame and the device
   ms/frame of every kernel whose name holds `knn`.
2. pruning: the 30 sweeps through `Slam.add_frame` and through
   `add_frame_async` + `flush`, three times each, with the prune radius set
   per keypoint type whatever the checkout's own policy: planes pruned at
   the matcher's neighbour gate and edges scanned exactly (the path since
   edges stopped pruning), both pruned (the path before), and both exact.
   Each run prints its largest pose divergence from the JAX package's
   trajectory (`chip_smoke.REF_PATH` / `STREAM_REF_PATH`) and the frames
   whose n_matches differ from it, so a divergence can be traced to the
   type whose pruning causes it.

It uses only `chip_smoke.py` and `lidarslam_tpu_torch/` of its own
checkout, so a copy placed in another checkout (an older commit unpacked
with `git archive`) measures that one; run parent, change, change, parent
in one session to compare two trees.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the types the kernel prunes at the matcher's neighbour gate in each run
VARIANTS = (("planes pruned", ("plane",)), ("both pruned", ("edge", "plane")),
            ("both exact", ()))


def _profile_stream(frames, cfg):
    import torch
    from chip_smoke import PROFILED, WINDOW
    from torch.profiler import ProfilerActivity, profile

    from lidarslam_tpu_torch import Slam

    slam = Slam(cfg, device="cuda")
    for f in frames[:PROFILED.start]:
        slam.add_frame_async(f)
    window = range(PROFILED.start, PROFILED.start + WINDOW)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in window:
            slam.add_frame_async(frames[i])
        torch.cuda.synchronize()
    if len(slam.flush()) != window.stop:
        raise AssertionError("the stream did not return every frame")
    busy, knn = 0.0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        t = evt.self_cuda_time_total if t is None else t
        busy += t
        if "knn" in evt.key:
            knn += t
    if busy <= 0 or knn <= 0:
        raise AssertionError(f"the profiler saw {busy} us of device time, {knn} of k-NN")
    return {"frames": [window.start, window.stop - 1], "busy_ms": busy / 1e3 / WINDOW,
            "knn_ms": knn / 1e3 / WINDOW}


def _drive(frames, cfg, stream: bool):
    import torch

    from lidarslam_tpu_torch import Slam

    slam = Slam(cfg, device="cuda")
    if stream:
        for f in frames:
            slam.add_frame_async(f)
        results = slam.flush()
    else:
        results = [slam.add_frame(f) for f in frames]
    torch.cuda.synchronize()
    return results


def _divergence(frames, results, ref):
    from chip_smoke import pose_errors

    if len(results) != len(frames):
        raise AssertionError(f"{len(results)} results for {len(frames)} frames")
    worst = max(pose_errors(r["pose"], ref["poses"][i]) for i, r in enumerate(results))
    off = [i for i, r in enumerate(results) if r["n_matches"] != int(ref["n_matches"][i])]
    failed = sum(bool(r["failure"]) for r in results)
    return {"m": worst[0], "deg": worst[1], "n_matches_off_at": off, "failed": failed}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("knn_probe.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from lidarslam_tpu_torch.ops import matcher

    card = chip_smoke.phase_env()
    frames = chip_smoke.render_frames(chip_smoke.N_FRAMES)
    cfg = chip_smoke.bench_config(16, 1800)
    k_of = {"edge": cfg.loc_matching.edge_nb_neighbors,
            "plane": cfg.loc_matching.plane_nb_neighbors}
    if k_of["edge"] == k_of["plane"]:
        raise AssertionError("edges and planes ask for the same k; k cannot tell them apart")
    # the JAX trajectories were made on numpy ingest (ROADMAP Queue 3, F5);
    # a tree from before the port's native ingest has nothing to pin
    try:
        from lidarslam_tpu_torch.io import native
        native.available = lambda: False
    except ImportError:
        pass
    out = {"tree": str(ROOT), "card": card, "stream": _profile_stream(frames, cfg)}
    print(f"[probe] {ROOT}: stream frames {out['stream']['frames']}: device busy "
          f"{out['stream']['busy_ms']:.4f} ms/frame, k-NN kernels "
          f"{out['stream']['knn_ms']:.4f} ms/frame ({card})", flush=True)

    refs = {False: np.load(chip_smoke.REF_PATH), True: np.load(chip_smoke.STREAM_REF_PATH)}
    brute_knn = matcher.brute_knn
    radius = float(cfg.loc_matching.max_neighbors_distance)
    for name, pruned in VARIANTS:
        pruned_k = {k_of[t] for t in pruned}

        def knn(view, queries, k, prune_radius=None, **kw):
            return brute_knn(view, queries, k,
                             prune_radius=radius if k in pruned_k else None, **kw)

        matcher.brute_knn = knn
        try:
            for stream in (False, True):
                d = _divergence(frames, _drive(frames, cfg, stream), refs[stream])
                path = "stream" if stream else "sync"
                out[f"{path} {name}"] = d
                print(f"[probe] {path} {name}: {d['m']:.3e} m / {d['deg']:.3e} deg from "
                      f"the JAX trajectory; n_matches differ at frames "
                      f"{d['n_matches_off_at']}; {d['failed']} failed", flush=True)
        finally:
            matcher.brute_knn = brute_knn
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
