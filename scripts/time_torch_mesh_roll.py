"""Time the slab-sharded map's two adaptive rolls
(`parallel/sharded_map.shard_roll` with `max_hops=None`) on the ranks of a
mesh: the host loop it runs eagerly (`_hops_host`), which reads the summed
stray count on the host after each hop and stops, and the loop of fixed
length it runs under CUDA-graph capture (`_hops_sync_free`), which runs all
n hops and keeps each only while that count was above 0. Both run eagerly
on the same slab (each call ended by a device sync), and must agree slot
for slot.

    python3 scripts/time_torch_mesh_roll.py            # gloo x2 on cuda:0, NCCL x1
    python3 scripts/time_torch_mesh_roll.py --cpu      # gloo x2 on the CPU, small

Prints one line per (group, offset) and a JSON line with every median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OFFSETS = ((0, 0, 0), (1, 0, 0), (2, 1, 0))   # nothing migrates / one slab / two


def _rank(mesh, n_points: int, reps: int):
    import numpy as np
    import torch

    from lidarslam_tpu_torch.config import MapConfig
    from lidarslam_tpu_torch.ops import voxel_map
    from lidarslam_tpu_torch.parallel import sharded_map

    dev = mesh.device
    cfg = MapConfig(leaf_size=0.3, voxel_resolution=3.0, grid_size=16, capacity=1 << 16)
    local = sharded_map.empty_slab(cfg, mesh.size, dev)
    half = voxel_map.half_extent(cfg)
    rng = np.random.default_rng(7)
    xyz = torch.from_numpy(rng.uniform(-half, half, (n_points, 3)).astype(np.float32)).to(dev)
    inten = torch.from_numpy(rng.uniform(0, 100, n_points).astype(np.float32)).to(dev)
    ones = torch.ones(n_points, dtype=torch.bool, device=dev)
    local = sharded_map.add_points_sharded(mesh, local, xyz, inten, 1.0, ones, 1.0, cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def fixed(local, offset, cfg, mesh):
        return sharded_map._hops_sync_free(voxel_map.roll_by_offset(local, offset, cfg),
                                           cfg, mesh)

    def host(local, offset, cfg, mesh):
        return sharded_map._hops_host(voxel_map.roll_by_offset(local, offset, cfg), cfg, mesh)

    out = {"points": int(mesh.psum(local.valid.sum(dtype=torch.int32)))}
    for off in OFFSETS:
        offset = torch.tensor(off, dtype=torch.int32, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(fixed(local, offset, cfg, mesh),
                                                     host(local, offset, cfg, mesh)))
        times = {}
        for name, fn in (("fixed", fixed), ("host", host), ("fixed again", fixed),
                         ("host again", host)):
            fn(local, offset, cfg, mesh)       # warm
            sync()
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(local, offset, cfg, mesh)
                sync()
                ms.append(1000 * (time.perf_counter() - t0))
            times[name] = statistics.median(ms)
        out[str(off)] = {"same_slots": bool(same), **times}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU, small map")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()

    import subprocess

    import torch

    from lidarslam_tpu_torch.parallel.launch import launch

    if a.cpu:
        groups = (("gloo", 2, "cpu", 4000),)
        card = "CPU"
    else:
        if not torch.cuda.is_available():
            print("no CUDA device; pass --cpu", file=sys.stderr)
            return 2
        groups = (("gloo", 2, "cuda:0", 60000), ("nccl", min(torch.cuda.device_count(), 4),
                                                 None, 60000))
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    report = {"card": card}
    for backend, world, device, n in groups:
        ranks = launch(_rank, world, backend=backend, device=device, timeout_s=600,
                       args=(n, a.reps))
        r0 = ranks[0]
        key = f"{backend} x{world}"
        report[key] = r0
        for off in OFFSETS:
            t = r0[str(off)]
            if not t["same_slots"]:
                raise AssertionError(f"[{key}] offset {off}: the two rolls differ")
            print(f"[roll] {key}, {r0['points']} points, offset {off}: fixed-length "
                  f"{t['fixed']:.3f} / {t['fixed again']:.3f} ms, host loop {t['host']:.3f} / "
                  f"{t['host again']:.3f} ms (median of {a.reps}, each ended by a device "
                  f"sync); slots equal ({card})", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
