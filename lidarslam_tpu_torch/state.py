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
  "valid", "count"} — the previous sweep's keypoints, which ego-motion
  registration matches against (the previous stamp, which undistortion
  reads, is the last of "trajectory_times");
- optional "submap_selected": {type: (M,) bool} and "cache_stale": the
  lazily rebuilt submap selection, so the next sweep matches against the
  same submap as the exporting engine would (a type whose map decays keeps
  none: it rebuilds its submap every sweep);
- optional "sensors": {"odom_prev_distance", "odom_prev_pos",
  "gravity_ref"} — the sensor managers' references (the measurements
  themselves are fed through the Slam's sensor API).

`stream_state_from_numpy` does the same for the streaming mode's device
state: a `StreamState` of the JAX package pulled to numpy (for example with
`jax.tree.map(np.asarray, state)`) becomes the port's, so both engines can
step the same next sweep from the same mid-sequence state; its
`prev_keypoints` and `t_prev` carry ego-motion registration and
undistortion across.
"""

from __future__ import annotations

import numpy as np
import torch

from lidarslam_tpu_torch.config import Keypoint
from lidarslam_tpu_torch.ops import voxel_map
from lidarslam_tpu_torch.ops.frame import Keypoints
from lidarslam_tpu_torch.ops.pipeline import StreamState, SubmapCache

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
    sensors = state.get("sensors")
    if sensors is not None:
        d = sensors.get("odom_prev_distance")
        slam.wheel_odom.prev_distance = None if d is None else float(d)
        slam.wheel_odom.prev_pos = np.asarray(sensors["odom_prev_pos"], np.float64).copy()
        slam.imu.gravity_ref = np.asarray(sensors["gravity_ref"], np.float64).copy()
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


def stream_state_from_numpy(st, device) -> StreamState:
    """The port's StreamState on `device` from a streaming state whose leaves
    are numpy arrays, with the JAX package's field names (`maps`,
    `prev_keypoints`, `submap_cache` of (`selected`, ...), the scalars).
    Each cached submap selection gets the k-NN kernel's map index anew."""
    maps = tuple(None if m is None else voxel_map_from_numpy(
        {f: getattr(m, f) for f in voxel_map.VoxelMap._fields}, device) for m in st.maps)
    kps = tuple(keypoints_from_numpy({f: getattr(k, f) for f in Keypoints._fields}, device)
                for k in st.prev_keypoints)
    caches = []
    for m, c in zip(maps, st.submap_cache):
        if c is None:
            caches.append(None)
            continue
        sel = _tensor(c.selected, torch.bool, device)
        view = voxel_map.SubmapView(xyz=m.xyz, ring=None, valid=sel)
        caches.append(SubmapCache(selected=sel, index=voxel_map.prepare_knn_index(view)))
    f32 = torch.float32
    return StreamState(
        maps=maps, prev_keypoints=kps,
        pose=_tensor(st.pose, f32, device), prev_pose=_tensor(st.prev_pose, f32, device),
        t_cur=_tensor(st.t_cur, f32, device), t_prev=_tensor(st.t_prev, f32, device),
        kf_pose=_tensor(st.kf_pose, f32, device),
        kf_counter=_tensor(st.kf_counter, torch.int32, device),
        origin_vox=_tensor(st.origin_vox, torch.int32, device),
        n_frames=_tensor(st.n_frames, torch.int32, device),
        map_update=_tensor(st.map_update, torch.bool, device),
        submap_cache=tuple(caches),
        cache_stale=_tensor(st.cache_stale, torch.bool, device))
