#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lidarslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, each printed as it goes:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile csrc/knn.cu with nvcc (sm_90a) from this checkout;
3. kernel vs plain: the k-NN kernel against its plain PyTorch version at the
   slice's shapes — (Q=2048, k=10) edges and (Q=4096, k=5) planes — on a
   65,536-slot map filled to capacity from all 30 rendered VLP-16 sweeps
   (the largest a slice map can grow; the slice's own maps' occupancy at
   frame 30 is printed in phase 4): bit-equal without
   pruning, equal wherever the plain neighbour lies within the 5 m prune
   radius, dead queries empty; median of 20 CUDA-event timings of each;
4. the slice: `Slam(cfg, device="cuda").add_frame` over 30 VLP-16 sweeps at
   the bench configuration, held against the JAX package's trajectory
   (lidarslam_tpu_torch/data/vlp16_bench_ref.npz, made by
   scripts/make_torch_reference.py) and the simulator ground truth, with
   exactly 2 kernel launches per localized frame.

Any failure raises and exits non-zero. Without a CUDA device, or without
the package beside this file, it exits non-zero before printing a result.
The last line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF_PATH = ROOT / "lidarslam_tpu_torch" / "data" / "vlp16_bench_ref.npz"
N_FRAMES = 30
PRUNE_RADIUS = 5.0
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


def render_frames(n: int):
    """The bench's VLP-16 sequence: 16 rings x 1800 firings along the
    street-corridor trajectory, no motion distortion (bench.py:232-239)."""
    from lidarslam_tpu_torch.io import synthetic

    sensor = synthetic.SensorModel(n_rings=16, n_azimuth=1800)
    return synthetic.generate_sequence(
        n_frames=n, sensor=sensor,
        trajectory=synthetic.weaving_street_trajectory(),
        motion_distortion=False)


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
    import torch

    fn()  # warm
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


def kernel_test_map(frames, device):
    """A 65,536-slot map filled from rendered sweeps through the port's own
    insert, so its slots are leaf-key sorted as on the path. Its 0.20 m
    leaves (the edge map's are 0.30 m) make 30 VLP-16 sweeps fill every
    slot: the kernel then scans a map as full as a slice map can get."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch.config import MapConfig
    from lidarslam_tpu_torch.ops import voxel_map

    cfg = MapConfig(leaf_size=0.20, capacity=1 << 16)
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


def phase_kernel(frames):
    """Kernel vs plain at the slice's shapes. Returns the kernel record."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch.ops import cuda_knn

    dev = torch.device("cuda")
    m, origin = kernel_test_map(frames, dev)
    n_valid = int(m.valid.sum())
    print(f"[kernel] map from {len(frames)} sweeps: {m.xyz.shape[0]} slots, "
          f"{n_valid} valid ({100 * n_valid / m.xyz.shape[0]:.1f}%), "
          f"{int(m.overflow)} leaves dropped at capacity", flush=True)
    if n_valid != m.xyz.shape[0]:
        raise AssertionError("the kernel's test map is not full")
    index = cuda_knn.prepare_map(m.xyz, m.valid)
    rng = np.random.default_rng(0)
    f = frames[8]
    R, t = f["gt_pose"][:3, :3], f["gt_pose"][:3, 3] - origin
    world = (f["xyz"].astype(np.float64) @ R.T + t).astype(np.float32)

    max_err = 0.0
    ms, plain_ms = {}, {}
    for name, Q, k in (("edges", 2048, 10), ("planes", 4096, 5)):
        pick = rng.choice(len(world), Q, replace=False)
        q = torch.from_numpy(world[pick] + rng.normal(0, 0.05, (Q, 3)).astype(np.float32)).to(dev)
        q_valid = torch.from_numpy(rng.uniform(size=Q) < 0.75).to(dev)

        # no pruning: bit-equal to the plain version
        kd, ki, kn = cuda_knn.kernel_knn(index, q, k, None, q_valid)
        pd, pi, pn = cuda_knn.plain_knn(m.xyz, m.valid, q, k, q_valid=q_valid)
        torch.cuda.synchronize()
        if not (torch.equal(kd, pd) and torch.equal(ki, pi) and torch.equal(kn, pn)):
            bad = int((kd != pd).any(dim=1).sum() + (ki != pi).any(dim=1).sum())
            raise AssertionError(f"{name}: kernel != plain without pruning ({bad} rows)")
        dead = ~q_valid
        if not (torch.isinf(kd[dead]).all() and (ki[dead] == 0).all()
                and (kn[dead] == 0).all()):
            raise AssertionError(f"{name}: dead queries returned neighbours")

        # with the matcher's prune radius: nothing within the radius is lost
        rd, ri_, rn = cuda_knn.kernel_knn(index, q, k, PRUNE_RADIUS, q_valid)
        torch.cuda.synchronize()
        inside = torch.isfinite(pd) & (pd <= PRUNE_RADIUS ** 2)
        if not (torch.equal(rd[inside], pd[inside]) and torch.equal(ri_[inside], pi[inside])
                and torch.equal(rn[inside], pn[inside])):
            raise AssertionError(f"{name}: pruning lost a neighbour within the radius")
        fin = torch.isfinite(rd)
        if not bool(m.valid[ri_[fin].long()].all()):
            raise AssertionError(f"{name}: pruned kernel returned an invalid slot")
        err = float(torch.where(inside, (rd - pd).abs(), 0.0).max())
        max_err = max(max_err, err)
        print(f"[kernel] {name} Q={Q} k={k}: exact without pruning; "
              f"{int(inside.sum())} within-radius neighbours kept; "
              f"{int(q_valid.sum())} live queries", flush=True)

        ms[name] = _median_ms(lambda: cuda_knn.kernel_knn(index, q, k, PRUNE_RADIUS, q_valid))
        plain_ms[name] = _median_ms(
            lambda: cuda_knn.plain_knn(m.xyz, m.valid, q, k, q_valid=q_valid))
        print(f"[kernel] {name} Q={Q} k={k}: kernel {ms[name]:.4f} ms, "
              f"plain {plain_ms[name]:.4f} ms (median of 20)", flush=True)
    return {"max_abs_err": max_err, "ms": ms["edges"] + ms["planes"],
            "plain_ms": plain_ms["edges"] + plain_ms["planes"]}


def phase_slice(frames):
    """30 VLP-16 sweeps through Slam.add_frame on the card."""
    import numpy as np
    import torch

    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.ops import cuda_knn

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

    gt0 = frames[0]["gt_pose"]
    worst_ref, worst_gt = (0.0, 0.0), (0.0, 0.0)
    n_failed = sum(bool(r["failure"]) for r in results)
    for i, (f, r) in enumerate(zip(frames, results)):
        pose = r["pose"]
        if not np.isfinite(pose).all():
            raise AssertionError(f"frame {i}: non-finite pose")
        e_ref = pose_errors(pose, ref["poses"][i])
        e_gt = pose_errors(pose, se3.hmat_inverse(gt0) @ f["gt_pose"])
        worst_ref = tuple(max(a, b) for a, b in zip(worst_ref, e_ref))
        worst_gt = tuple(max(a, b) for a, b in zip(worst_gt, e_gt))
        if e_ref[0] > REF_TOL_M or e_ref[1] > REF_TOL_DEG:
            raise AssertionError(f"frame {i}: {e_ref} from the JAX reference")
        if e_gt[0] > GT_TOL_M or e_gt[1] > GT_TOL_DEG:
            raise AssertionError(f"frame {i}: {e_gt} from ground truth")
    if n_failed:
        raise AssertionError(f"{n_failed} failed frames")
    localized = len(frames) - 1   # the first frame only seeds the maps
    if launches != 2 * localized:
        raise AssertionError(f"{launches} kernel launches for {localized} localized "
                             "frames (expected 2 each)")
    n_matches = [r["n_matches"] for r in results[1:]]
    ref_matches = [int(v) for v in ref["n_matches"][1:len(frames)]]
    print(f"[slice] {len(frames)} frames, {n_failed} failed, {launches} kernel "
          f"launches; median {1000 * statistics.median(wall[1:]):.2f} ms/frame "
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
    return launches


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
    phase_env()
    phase_build()
    t0 = time.perf_counter()
    frames = render_frames(N_FRAMES)
    print(f"[frames] rendered {len(frames)} VLP-16 sweeps "
          f"(~{len(frames[0]['xyz'])} points each) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rec = phase_kernel(frames)
    launches = phase_slice(frames)
    print(json.dumps({"kernels": [{
        "name": "knn", "route": "cuda", "source": "lidarslam_tpu_torch/csrc/knn.cu",
        "replaces": "lidarslam_tpu/ops/pallas_knn.py:121",
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
