"""SLAM state carried in from numpy arrays.

This engine has no weights; its state is the rolling maps plus the host
bookkeeping. A run of the JAX package (or of this port) that has processed
N sweeps can be exported as plain numpy arrays and continued here, so both
engines can step the same next sweep from the same state.

State dict keys:
- "maps": {Keypoint or int: {"xyz", "intensity", "time", "count", "fixed",
  "valid", "overflow"}} — the VoxelMap fields;
- "map_origin" (3,), "Tworld", "PreviousTworld", "kf_last_pose" (4, 4),
  "kf_counter";
- "trajectory_times" (n,), "trajectory_poses" (n, 4, 4);
- "azimuthal_resolution", "last_stamp";
- optional "prev_keypoints": per type {"xyz", "intensity", "time", "ring",
  "valid", "count"};
- optional "submap_selected": {type: (M,) bool} and "cache_stale": the
  lazily rebuilt submap selection, so the next sweep matches against the
  same submap as the exporting engine would.
"""

from __future__ import annotations

import numpy as np
import torch

from lidarslam_tpu_torch.config import Keypoint
from lidarslam_tpu_torch.ops import voxel_map
from lidarslam_tpu_torch.ops.frame import Keypoints
from lidarslam_tpu_torch.ops.pipeline import SubmapCache

_MAP_DTYPES = {"xyz": torch.float32, "intensity": torch.float32,
               "time": torch.float32, "count": torch.int32,
               "fixed": torch.bool, "valid": torch.bool, "overflow": torch.int32}
_KP_DTYPES = {"xyz": torch.float32, "intensity": torch.float32,
              "time": torch.float32, "ring": torch.int32, "valid": torch.bool,
              "count": torch.int32}


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)


def voxel_map_from_numpy(d: dict, device) -> voxel_map.VoxelMap:
    """A VoxelMap on `device` from its fields as numpy arrays."""
    return voxel_map.VoxelMap(**{f: _tensor(d[f], _MAP_DTYPES[f], device)
                                 for f in voxel_map.VoxelMap._fields})


def keypoints_from_numpy(d: dict, device) -> Keypoints:
    return Keypoints(**{f: _tensor(d[f], _KP_DTYPES[f], device)
                        for f in Keypoints._fields})


def load_numpy_state(slam, state: dict):
    """Replace `slam`'s maps and host bookkeeping by `state` (see module
    docstring)."""
    dev = slam.device
    maps = {Keypoint(int(k)): v for k, v in state["maps"].items()}
    missing = set(slam.cfg.used_types) - set(maps)
    if missing:
        raise ValueError(f"state has no map for {sorted(t.name for t in missing)}")
    for k in slam.cfg.used_types:
        m = voxel_map_from_numpy(maps[k], dev)
        if m.xyz.shape[0] != slam.map_cfgs[k].capacity:
            raise ValueError(f"{k.name} map capacity {m.xyz.shape[0]} != "
                             f"configured {slam.map_cfgs[k].capacity}")
        slam.maps[k] = m
        # re-baseline the overflow tracker: drops before the state are not new
        slam.map_overflow[int(k)] = int(m.overflow)
    slam.map_origin = np.asarray(state["map_origin"], np.float64).copy()
    slam.Tworld = np.asarray(state["Tworld"], np.float64).copy()
    slam.PreviousTworld = np.asarray(state["PreviousTworld"], np.float64).copy()
    slam.kf_last_pose = np.asarray(state["kf_last_pose"], np.float64).copy()
    slam.kf_counter = int(state["kf_counter"])
    slam.azimuthal_resolution = float(state["azimuthal_resolution"])
    slam.last_stamp = state.get("last_stamp")
    times = np.asarray(state["trajectory_times"], np.float64)
    poses = np.asarray(state["trajectory_poses"], np.float64)
    slam.log_trajectory = [{"time": float(t), "pose": p.copy(),
                            "covariance": np.zeros((6, 6))}
                           for t, p in zip(times, poses)]
    slam.n_frames = len(slam.log_trajectory)
    slam._maps_populated = bool(slam.kf_counter > 0)
    if state.get("prev_keypoints") is not None:
        kps = {Keypoint(int(k)): v for k, v in state["prev_keypoints"].items()}
        slam._device_keypoints = tuple(
            keypoints_from_numpy(kps[Keypoint(i)], dev) if Keypoint(i) in kps else None
            for i in range(3))
    slam._invalidate_submaps()
    selected = state.get("submap_selected")
    if selected is not None:
        cache = list(slam._submap_cache)
        for k, sel in selected.items():
            ti = int(k)
            sel_t = _tensor(sel, torch.bool, dev)
            view = voxel_map.SubmapView(xyz=slam.maps[Keypoint(ti)].xyz, ring=None,
                                        valid=sel_t)
            cache[ti] = SubmapCache(selected=sel_t,
                                    index=voxel_map.prepare_knn_index(view))
        slam._submap_cache = tuple(cache)
        slam._cache_stale = bool(state.get("cache_stale", True))
