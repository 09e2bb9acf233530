"""YAML configuration loader using the reference's parameter namespace.

The reference's de-facto config schema is the ROS yaml tree
(`slam_config_outdoor.yaml` / `slam_config_indoor.yaml`,
ros_wrapping/lidar_slam/params) bound by `SetSlamParameters`
(LidarSlamNode.cxx:625-817). This loader accepts that same `slam:` namespace
(2d_mode, use_blobs, ego_motion, undistortion, ego_motion_registration.*,
localization.*, keyframes.*, confidence.*, voxel_grid.*, ke.*) and builds a
`SlamConfig`, so existing reference configs port by copy-paste. Unknown keys
are ignored (ROS-output-only sections); TPU capacities come from an optional
`tpu:` section.

The PyTorch port's copy of `lidarslam_tpu/io/yaml_config.py`, binding onto
the port's config dataclasses (PyYAML parses, on both machines the port
runs on). `config_from_tree` binds an already parsed tree.
"""

from __future__ import annotations

import dataclasses

import yaml

from lidarslam_tpu_torch.config import (EgoMotionMode, LoggingStorage, MappingMode,
                                        MatchingConfig, SamplingMode, SlamConfig,
                                        UndistortionMode)


def _matching(d: dict, base: MatchingConfig, single_edge_per_ring: bool) -> MatchingConfig:
    m = {
        "max_neighbors_distance": "max_neighbors_distance",
        "edge_nb_neighbors": "edge_nb_neighbors",
        "edge_min_nb_neighbors": "edge_min_nb_neighbors",
        "edge_max_model_error": "edge_max_model_error",
        "plane_nb_neighbors": "plane_nb_neighbors",
        "planarity_threshold": "planarity_threshold",
        "plane_max_model_error": "plane_max_model_error",
        "blob_nb_neighbors": "blob_nb_neighbors",
        "init_saturation_distance": "init_saturation_distance",
        "final_saturation_distance": "final_saturation_distance",
        # TPU extension (no reference counterpart): one k-NN query per
        # frame, neighbors reused across ICP rounds
        "reuse_knn": "reuse_knn",
    }
    kw = {dst: d[src] for src, dst in m.items() if src in d}
    kw["single_edge_per_ring"] = single_edge_per_ring
    return dataclasses.replace(base, **kw)


def load_config(path=None, text=None, tpu_overrides=None) -> SlamConfig:
    """Build a SlamConfig from a reference-style yaml file or string."""
    if path:
        with open(path) as f:
            text = f.read()
    return config_from_tree(yaml.safe_load(text) or {}, tpu_overrides)


def config_from_tree(tree: dict, tpu_overrides=None) -> SlamConfig:
    """Bind a parsed reference-namespace tree (`slam:`, `tpu:`) onto a
    SlamConfig: what `load_config` does after parsing, and what the ROS
    node's private namespace and the ParaView proxy properties go through
    (the JAX package dumps those to yaml text and loads it back)."""
    s = tree.get("slam", {})
    base = SlamConfig()

    kw = {}
    if "2d_mode" in s:
        kw["two_d_mode"] = bool(s["2d_mode"])
        # the solver reads its own copy of the flag (LocalOptimizer.cxx:89-90
        # holds {Z, rX, rY} constant) — forward it so a ported reference
        # config actually freezes those DoF
        kw["solver"] = dataclasses.replace(base.solver,
                                           two_d_mode=bool(s["2d_mode"]))
    if "use_blobs" in s:
        kw["use_blobs"] = bool(s["use_blobs"])
    if "ego_motion" in s:
        kw["ego_motion_mode"] = EgoMotionMode(int(s["ego_motion"]))
    if "undistortion" in s:
        kw["undistortion"] = UndistortionMode(int(s["undistortion"]))
    if "verbosity" in s:
        kw["verbosity"] = int(s["verbosity"])
    if "logging_timeout" in s:
        kw["logging_timeout"] = float(s["logging_timeout"])
    if "logging_storage" in s:
        # reference values (slam_config_outdoor.yaml logging_storage):
        # 0 PCL in RAM -> HOST, 1 octree-compressed RAM -> OCTREE,
        # 2/3/4 PCD file variants -> DISK
        v = int(s["logging_storage"])
        kw["logging_storage"] = (LoggingStorage.HOST, LoggingStorage.OCTREE,
                                 LoggingStorage.DISK, LoggingStorage.DISK,
                                 LoggingStorage.DISK)[min(v, 4)]
    if "logging_dir" in s:
        kw["logging_dir"] = str(s["logging_dir"])

    ego = s.get("ego_motion_registration", {})
    kw["ego_matching"] = _matching(ego, base.ego_matching, True)
    if "ICP_max_iter" in ego:
        kw["ego_motion_icp_max_iter"] = int(ego["ICP_max_iter"])
    if "LM_max_iter" in ego:
        kw["ego_motion_lm_max_iter"] = int(ego["LM_max_iter"])

    loc = s.get("localization", {})
    kw["loc_matching"] = _matching(loc, base.loc_matching, False)
    if "ICP_max_iter" in loc:
        kw["localization_icp_max_iter"] = int(loc["ICP_max_iter"])
    if "LM_max_iter" in loc:
        kw["localization_lm_max_iter"] = int(loc["LM_max_iter"])

    keyf = s.get("keyframes", {})
    if "distance_threshold" in keyf:
        kw["kf_distance_threshold"] = float(keyf["distance_threshold"])
    if "angle_threshold" in keyf:
        kw["kf_angle_threshold"] = float(keyf["angle_threshold"])

    conf = s.get("confidence", {})
    ckw = {}
    if "overlap" in conf and conf["overlap"] and "sampling_ratio" in conf["overlap"]:
        ckw["overlap_sampling_ratio"] = float(conf["overlap"]["sampling_ratio"])
    ml = conf.get("motion_limits", {})
    if "velocity" in ml:
        ckw["velocity_limits"] = tuple(float(v) for v in ml["velocity"])
    if "acceleration" in ml:
        ckw["acceleration_limits"] = tuple(float(v) for v in ml["acceleration"])
    if "time_window_duration" in ml:
        ckw["time_window_duration"] = float(ml["time_window_duration"])
    kw["confidence"] = dataclasses.replace(base.confidence, **ckw)

    vg = s.get("voxel_grid", {})
    if "update_maps" in vg:
        kw["mapping_mode"] = MappingMode(int(vg["update_maps"]))
    maps = {}
    for name, leaf_key, sampling_key, field in [
            ("edge_map", "leaf_size_edges", "sampling_mode_edges", base.edge_map),
            ("plane_map", "leaf_size_planes", "sampling_mode_planes", base.plane_map),
            ("blob_map", "leaf_size_blobs", "sampling_mode_blobs", base.blob_map)]:
        mkw = {}
        if leaf_key in vg:
            mkw["leaf_size"] = float(vg[leaf_key])
        if sampling_key in vg:
            mkw["sampling"] = SamplingMode(int(vg[sampling_key]))
        if "size" in vg:
            mkw["grid_size"] = int(vg["size"])
        if "resolution" in vg:
            mkw["voxel_resolution"] = float(vg["resolution"])
        if "decaying_threshold" in vg:
            mkw["decaying_threshold"] = float(vg["decaying_threshold"])
        if "min_frames_per_voxel" in vg:
            mkw["min_frames_per_voxel"] = int(vg["min_frames_per_voxel"])
        maps[name] = dataclasses.replace(field, **mkw)
    kw.update(maps)

    ke = s.get("ke", {})
    ekw = {}
    for src, dst in [("min_distance_to_sensor", "min_distance_to_sensor"),
                     ("min_beam_surface_angle", "min_beam_surface_angle"),
                     ("neighbor_width", "neighbor_width"),
                     ("plane_sin_angle_threshold", "plane_sin_angle_threshold"),
                     ("edge_sin_angle_threshold", "edge_sin_angle_threshold"),
                     ("edge_depth_gap_threshold", "edge_depth_gap_threshold"),
                     ("edge_saliency_threshold", "edge_saliency_threshold"),
                     ("edge_intensity_gap_threshold", "edge_intensity_gap_threshold")]:
        if src in ke:
            ekw[dst] = ke[src]
    tpu = tree.get("tpu", {})
    for src in ("n_rings", "max_ring_points", "max_keypoints",
                "max_edge_keypoints", "max_plane_keypoints",
                "max_blob_keypoints"):
        if src in tpu:
            ekw[src] = int(tpu[src])
    kw["extractor"] = dataclasses.replace(base.extractor, **ekw)
    if tpu_overrides:
        kw.update(tpu_overrides)

    ext = s.get("external_sensors", {})
    odo = ext.get("wheel_odometry", ext.get("odometry", {}))
    if "weight" in odo:
        kw["wheel_odom_weight"] = float(odo["weight"])
    if "relative" in odo:
        kw["wheel_odom_relative"] = bool(odo["relative"])
    imu = ext.get("imu", ext.get("gravity", {}))
    if "weight" in imu:
        kw["imu_weight"] = float(imu["weight"])
    if "time_offset" in ext:
        kw["sensor_time_offset"] = float(ext["time_offset"])

    return dataclasses.replace(base, **kw)
