"""ParaView/LidarView plugin: the reference's vtkSlam filter in Python.

The reference ships a C++ vtkPolyDataAlgorithm with 2 input ports (frame
polydata + optional calibration table) and 8 output ports — registered
frame, trajectory polyline, 3 maps, 3 keypoint clouds
(vtkSlam.cxx:47-60) — plus a 1,463-line XML proxy UI (Slam.xml) and a
streaming "offline" manager (vtkSlamManager.cxx:63-146). This module is
the same filter for the TPU engine, split so the environment's missing
ParaView does not block the logic:

- **Pure core** (no vtk import, fully tested): vendor array
  auto-detection with the reference's exact tables and time-unit factors
  (`identify_input_arrays` — vtkSlam.cxx:531-612), polydata-arrays ->
  engine-frame conversion with frame-end time rebasing and null-point
  filtering (`arrays_to_frame` — PolyDataToPointCloud :668-707),
  calibration-table laser re-ranking (`laser_id_mapping` —
  GetLaserIdMapping :615-629), the XML-proxy parameter surface mapped
  onto the engine config (`PROXY_TO_YAML`/`config_from_proxy` — the
  Slam.xml property names resolve through the same reference-namespace
  loader the yaml configs use), and `SlamFilterCore`, the per-timestep
  engine drive that assembles every output port as numpy arrays
  (trajectory arrays exactly as AddCurrentPoseToTrajectory :631-665:
  Time, Orientation(Quaternion) wxyz, Orientation(AxisAngle), Covariance).
- **vtk glue** (import-gated): `make_vtk_slam_classes()` builds
  `vtkSlam`/`vtkSlamManager` as `VTKPythonAlgorithmBase` subclasses
  wrapping the core, decorated for ParaView's Python-plugin loader when
  `paraview.util.vtkAlgorithm` is importable. Load this file directly
  via ParaView's Plugin Manager (Tools > Manage Plugins > Load New) on a
  machine with ParaView/LidarView installed.

The PyTorch port's copy of `lidarslam_tpu/paraview_plugin.py`: the same
core and glue around the port's `Slam`, which `SlamFilterCore` builds on
the CUDA device unless a `Slam` is passed in. As in the JAX file, the
filter declares its optional calibration input but never reads it
(ROADMAP Queue 3, F9): `RequestData` takes only the frame port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from lidarslam_tpu_torch.config import Keypoint

# ---------------------------------------------------------------------------
# vendor auto-detection (vtkSlam::IdentifyInputArrays, vtkSlam.cxx:531-612)
# ---------------------------------------------------------------------------

#: vendor -> (time array, intensity array, laser-id array,
#:            time->seconds factor, calibration vertical-angle column)
VENDOR_TABLE = (
    ("Velodyne", "adjustedtime", "intensity", "laser_id", 1e-6,
     "verticalCorrection"),
    ("Ouster", "Raw Timestamp", "Signal Photons", "Channel", 1e-9,
     "Altitude Angles"),
    ("Hesai", "Timestamp", "Intensity", "LaserID", 1.0, None),
)


@dataclasses.dataclass
class InputArrays:
    vendor: str
    time: str
    intensity: str
    laser_id: str
    time_factor: float
    calib: Optional[str] = None      # vertical-angle column, when present


def identify_input_arrays(point_arrays: Sequence[str],
                          calib_columns: Sequence[str] = ()) -> InputArrays:
    """Auto-detect the LiDAR vendor from available point arrays, in the
    reference's priority order (Velodyne, then Ouster, then Hesai —
    vtkSlam.cxx:573-601). Raises ValueError when none match (:604)."""
    have = set(point_arrays)
    for vendor, time, inten, lid, factor, calib in VENDOR_TABLE:
        if {time, inten, lid} <= have:
            return InputArrays(vendor, time, inten, lid, factor,
                               calib if calib in set(calib_columns) else None)
    raise ValueError("Unable to identify LiDAR arrays to use "
                     f"(available: {sorted(have)})")


def laser_id_mapping(vertical_angles) -> np.ndarray:
    """Calibration-table laser remap: each laser id -> its rank by
    vertical angle (SortIdx(SortIdx(angles)), vtkSlam.cxx:615-629)."""
    order = np.argsort(np.asarray(vertical_angles), kind="stable")
    return np.argsort(order, kind="stable").astype(np.int32)


def arrays_to_frame(xyz, time, intensity, laser_id, time_factor: float = 1.0,
                    mapping: Optional[np.ndarray] = None) -> dict:
    """Point arrays -> engine frame dict (PolyDataToPointCloud,
    vtkSlam.cxx:668-707): (0,0,0) points are dropped (:691), per-point
    times are rebased to the frame-END stamp so they are <= 0 within the
    sweep (:683-697: stamp = max(time)*factor, p.time = (t - max)*factor),
    and the calibration mapping re-ranks laser ids when present."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    time = np.asarray(time, np.float64)
    keep = np.any(xyz != 0.0, axis=1)
    end = float(time.max()) if len(time) else 0.0
    lid = np.asarray(laser_id, np.int64)
    if mapping is not None:
        lid = np.asarray(mapping)[lid]
    return {"xyz": xyz[keep],
            "time": ((time[keep] - end) * time_factor).astype(np.float32),
            "intensity": np.asarray(intensity, np.float32)[keep],
            "laser_id": lid[keep].astype(np.int32),
            "stamp": end * time_factor,
            "all_points_valid": bool(keep.all())}


# ---------------------------------------------------------------------------
# XML proxy parameter surface (Slam.xml -> engine config)
# ---------------------------------------------------------------------------

#: vtkSlam proxy property name (Slam.xml / vtkSlam.h:47-392 macros) ->
#: dotted key in the reference yaml namespace (io/yaml_config.py binds it).
PROXY_TO_YAML = {
    "TwoDMode": "slam.2d_mode",
    "UseBlobs": "slam.use_blobs",
    "EgoMotion": "slam.ego_motion",
    "Undistortion": "slam.undistortion",
    "Verbosity": "slam.verbosity",
    "EgoMotionICPMaxIter": "slam.ego_motion_registration.ICP_max_iter",
    "EgoMotionLMMaxIter": "slam.ego_motion_registration.LM_max_iter",
    "EgoMotionMaxNeighborsDistance":
        "slam.ego_motion_registration.max_neighbors_distance",
    "EgoMotionEdgeNbNeighbors": "slam.ego_motion_registration.edge_nb_neighbors",
    "EgoMotionEdgeMinNbNeighbors":
        "slam.ego_motion_registration.edge_min_nb_neighbors",
    "EgoMotionEdgeMaxModelError":
        "slam.ego_motion_registration.edge_max_model_error",
    "EgoMotionPlaneNbNeighbors":
        "slam.ego_motion_registration.plane_nb_neighbors",
    "EgoMotionPlanarityThreshold":
        "slam.ego_motion_registration.planarity_threshold",
    "EgoMotionPlaneMaxModelError":
        "slam.ego_motion_registration.plane_max_model_error",
    "EgoMotionInitSaturationDistance":
        "slam.ego_motion_registration.init_saturation_distance",
    "EgoMotionFinalSaturationDistance":
        "slam.ego_motion_registration.final_saturation_distance",
    "LocalizationICPMaxIter": "slam.localization.ICP_max_iter",
    "LocalizationLMMaxIter": "slam.localization.LM_max_iter",
    "LocalizationMaxNeighborsDistance":
        "slam.localization.max_neighbors_distance",
    "LocalizationEdgeNbNeighbors": "slam.localization.edge_nb_neighbors",
    "LocalizationEdgeMinNbNeighbors":
        "slam.localization.edge_min_nb_neighbors",
    "LocalizationEdgeMaxModelError":
        "slam.localization.edge_max_model_error",
    "LocalizationPlaneNbNeighbors": "slam.localization.plane_nb_neighbors",
    "LocalizationPlanarityThreshold":
        "slam.localization.planarity_threshold",
    "LocalizationPlaneMaxModelError":
        "slam.localization.plane_max_model_error",
    "LocalizationBlobNbNeighbors": "slam.localization.blob_nb_neighbors",
    "LocalizationInitSaturationDistance":
        "slam.localization.init_saturation_distance",
    "LocalizationFinalSaturationDistance":
        "slam.localization.final_saturation_distance",
    "KeyframeDistanceThreshold": "slam.keyframes.distance_threshold",
    "KeyframeAngleThreshold": "slam.keyframes.angle_threshold",
    "OverlapSamplingRatio": "slam.confidence.overlap.sampling_ratio",
    "TimeWindowDuration": "slam.confidence.motion_limits.time_window_duration",
    "VoxelGridLeafSizeEdges": "slam.voxel_grid.leaf_size_edges",
    "VoxelGridLeafSizePlanes": "slam.voxel_grid.leaf_size_planes",
    "VoxelGridLeafSizeBlobs": "slam.voxel_grid.leaf_size_blobs",
    "VoxelGridSize": "slam.voxel_grid.size",
    "VoxelGridResolution": "slam.voxel_grid.resolution",
    "VoxelGridSamplingModeEdges": "slam.voxel_grid.sampling_mode_edges",
    "VoxelGridSamplingModePlanes": "slam.voxel_grid.sampling_mode_planes",
    "VoxelGridSamplingModeBlobs": "slam.voxel_grid.sampling_mode_blobs",
    "VoxelGridDecayingThreshold": "slam.voxel_grid.decaying_threshold",
    "VoxelGridMinFramesPerVoxel": "slam.voxel_grid.min_frames_per_voxel",
    "NeighborWidth": "slam.ke.neighbor_width",
    "MinDistanceToSensor": "slam.ke.min_distance_to_sensor",
    "MinBeamSurfaceAngle": "slam.ke.min_beam_surface_angle",
    "PlaneSinAngleThreshold": "slam.ke.plane_sin_angle_threshold",
    "EdgeSinAngleThreshold": "slam.ke.edge_sin_angle_threshold",
    "EdgeDepthGapThreshold": "slam.ke.edge_depth_gap_threshold",
    "EdgeSaliencyThreshold": "slam.ke.edge_saliency_threshold",
    "EdgeIntensityGapThreshold": "slam.ke.edge_intensity_gap_threshold",
}


def config_from_proxy(properties: Dict[str, object], tpu_overrides=None):
    """Build a SlamConfig from XML-proxy property values: route each
    known property through the reference yaml namespace and bind with the
    same loader the yaml configs use (unknown names raise — the proxy
    table is exact)."""
    from lidarslam_tpu_torch.io.yaml_config import config_from_tree

    tree: dict = {}
    for name, value in properties.items():
        dotted = PROXY_TO_YAML.get(name)
        if dotted is None:
            raise KeyError(f"unknown vtkSlam proxy property {name!r}")
        node = tree
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return config_from_tree(tree, tpu_overrides=tpu_overrides)


# ---------------------------------------------------------------------------
# the filter core (vtkSlam::RequestData :173-403 without the vtk containers)
# ---------------------------------------------------------------------------

_KP_PORT_NAMES = {Keypoint.EDGE: "edge_keypoints",
                  Keypoint.PLANE: "plane_keypoints",
                  Keypoint.BLOB: "blob_keypoints"}
_MAP_PORT_NAMES = {Keypoint.EDGE: "edge_map", Keypoint.PLANE: "plane_map",
                   Keypoint.BLOB: "blob_map"}


class SlamFilterCore:
    """Engine drive + output-port assembly for one filter instance.

    `process(point_arrays..)` runs one timestep and returns every output
    port as numpy arrays: the vtk glue (or a test) wraps them into
    polydata. Trajectory arrays follow AddCurrentPoseToTrajectory
    (vtkSlam.cxx:631-665) exactly: Time, Orientation(Quaternion) in WXYZ,
    Orientation(AxisAngle) [axis*1 + angle as 4th], Covariance (36,
    row-major)."""

    def __init__(self, slam=None, properties: Optional[dict] = None,
                 advanced_return: bool = False,
                 maps_update_step: int = 1):
        from lidarslam_tpu_torch.slam import Slam

        self.slam = slam or Slam(config_from_proxy(properties or {}))
        self.advanced_return = bool(advanced_return)
        self.maps_update_step = int(maps_update_step)
        self.trajectory: List[dict] = []
        self.n_frames = 0
        self._arrays: Optional[InputArrays] = None
        self._mapping: Optional[np.ndarray] = None

    # -- input side --
    def identify(self, point_arrays: Sequence[str],
                 calib_columns: Sequence[str] = (),
                 calib_angles=None) -> InputArrays:
        self._arrays = identify_input_arrays(point_arrays, calib_columns)
        self._mapping = (laser_id_mapping(calib_angles)
                         if (self._arrays.calib and calib_angles is not None)
                         else None)
        return self._arrays

    def process(self, xyz, time, intensity, laser_id,
                frame: Optional[dict] = None) -> dict:
        """One timestep: convert, AddFrame, assemble the 8 ports."""
        from lidarslam_tpu_torch.core.se3 import quat_from_matrix

        if frame is None:
            factor = self._arrays.time_factor if self._arrays else 1.0
            frame = arrays_to_frame(xyz, time, intensity, laser_id, factor,
                                    self._mapping)
        result = self.slam.add_frame(frame)
        self.n_frames += 1
        pose = np.asarray(self.slam.get_world_transform(), np.float64)
        cov = np.asarray(self.slam.get_covariance(), np.float64)
        q = quat_from_matrix(pose[:3, :3])
        ang = 2.0 * np.arccos(np.clip(q[0], -1.0, 1.0))
        s = np.sqrt(max(1.0 - q[0] * q[0], 1e-30))
        axis = q[1:] / s if s > 1e-10 else np.array([0.0, 0.0, 1.0])
        self.trajectory.append({
            "position": pose[:3, 3], "Time": frame["stamp"],
            "Orientation(Quaternion)": q,
            "Orientation(AxisAngle)": np.concatenate([axis, [ang]]),
            "Covariance": cov.ravel()})

        out = {"result": result,
               "registered_frame": {
                   "xyz": self.slam.get_registered_frame(frame),
                   "intensity": frame.get("intensity")},
               "trajectory": self.trajectory_arrays()}
        publish_maps = (self.maps_update_step > 0
                        and self.n_frames % self.maps_update_step == 0)
        for k in self.slam.cfg.used_types:
            out[_KP_PORT_NAMES[k]] = {"xyz": self.slam.get_keypoints(k, world=True)}
            if publish_maps:
                xyz_m, inten_m, _, _ = self.slam.get_map_points(k)
                out[_MAP_PORT_NAMES[k]] = {"xyz": xyz_m, "intensity": inten_m}
        if self.advanced_return:   # debug arrays (vtkSlam.cxx:327-398)
            out["debug"] = self.slam.get_debug_array()
        return out

    def trajectory_arrays(self) -> dict:
        t = self.trajectory
        return {"points": np.asarray([e["position"] for e in t], np.float64),
                "Time": np.asarray([e["Time"] for e in t], np.float64),
                "Orientation(Quaternion)":
                    np.asarray([e["Orientation(Quaternion)"] for e in t]),
                "Orientation(AxisAngle)":
                    np.asarray([e["Orientation(AxisAngle)"] for e in t]),
                "Covariance": np.asarray([e["Covariance"] for e in t])}

    def reset(self):
        self.slam.reset()
        self.trajectory = []
        self.n_frames = 0


# ---------------------------------------------------------------------------
# vtk / ParaView glue (import-gated)
# ---------------------------------------------------------------------------

def make_vtk_slam_classes():
    """Build (vtkSlam, vtkSlamManager) as VTKPythonAlgorithmBase
    subclasses. Requires vtk; ParaView decorators are applied when
    importable so the classes register as a Python plugin."""
    from vtkmodules.numpy_interface import dataset_adapter as dsa
    from vtkmodules.util import numpy_support as ns
    from vtkmodules.util.vtkAlgorithm import VTKPythonAlgorithmBase
    from vtkmodules.vtkCommonCore import vtkPoints
    from vtkmodules.vtkCommonDataModel import vtkCellArray, vtkPolyData

    def _to_polydata(port: dict, poly: vtkPolyData, as_line=False):
        xyz = np.ascontiguousarray(np.asarray(port.get("xyz",
                                   port.get("points")), np.float64))
        pts = vtkPoints()
        pts.SetData(ns.numpy_to_vtk(xyz, deep=1))
        poly.SetPoints(pts)
        n = len(xyz)
        cells = vtkCellArray()
        if as_line and n:
            cells.InsertNextCell(n, list(range(n)))
            poly.SetLines(cells)
        else:
            for i in range(n):
                cells.InsertNextCell(1, [i])
            poly.SetVerts(cells)
        for name, arr in port.items():
            if name in ("xyz", "points") or arr is None:
                continue
            va = ns.numpy_to_vtk(np.ascontiguousarray(
                np.atleast_2d(np.asarray(arr, np.float64)).reshape(n, -1)),
                deep=1)
            va.SetName(name)
            poly.GetPointData().AddArray(va)

    class vtkSlam(VTKPythonAlgorithmBase):
        """2 inputs (frame, optional calib) / 8 outputs — vtkSlam parity."""

        PORTS = ["registered_frame", "trajectory",
                 "edge_map", "plane_map", "blob_map",
                 "edge_keypoints", "plane_keypoints", "blob_keypoints"]

        def __init__(self):
            super().__init__(nInputPorts=2, nOutputPorts=8,
                             outputType="vtkPolyData")
            self.core = SlamFilterCore()
            self.AutoDetectInputArrays = True

        def FillInputPortInformation(self, port, info):
            info.Set(self.INPUT_REQUIRED_DATA_TYPE(),
                     "vtkPolyData" if port == 0 else "vtkTable")
            if port == 1:
                info.Set(self.INPUT_IS_OPTIONAL(), 1)
            return 1

        def RequestData(self, request, inInfo, outInfo):
            poly = dsa.WrapDataObject(
                vtkPolyData.GetData(inInfo[0].GetInformationObject(0)))
            names = [poly.PointData.GetArray(i).GetName()
                     if hasattr(poly.PointData.GetArray(i), "GetName")
                     else poly.PointData.keys()[i]
                     for i in range(len(poly.PointData.keys()))]
            names = poly.PointData.keys()
            if self.core._arrays is None:
                self.core.identify(names)
            a = self.core._arrays
            out = self.core.process(np.asarray(poly.Points),
                                    np.asarray(poly.PointData[a.time]),
                                    np.asarray(poly.PointData[a.intensity]),
                                    np.asarray(poly.PointData[a.laser_id]))
            for i, port in enumerate(self.PORTS):
                dst = vtkPolyData.GetData(outInfo, i)
                if port == "trajectory":
                    _to_polydata(out["trajectory"], dst, as_line=True)
                elif port in out:
                    _to_polydata(out[port], dst)
            return 1

    class vtkSlamManager(vtkSlam):
        """Offline manager: streams every timestep through the filter via
        CONTINUE_EXECUTING and caches final outputs
        (vtkSlamManager.cxx:63-146)."""

        def __init__(self):
            super().__init__()
            self._step = 0
            self._times = []

        def RequestInformation(self, request, inInfo, outInfo):
            from vtkmodules.vtkCommonExecutionModel import \
                vtkStreamingDemandDrivenPipeline as sddp
            info = inInfo[0].GetInformationObject(0)
            if info.Has(sddp.TIME_STEPS()):
                self._times = [info.Get(sddp.TIME_STEPS(), i)
                               for i in range(info.Length(sddp.TIME_STEPS()))]
            return 1

        def RequestUpdateExtent(self, request, inInfo, outInfo):
            from vtkmodules.vtkCommonExecutionModel import \
                vtkStreamingDemandDrivenPipeline as sddp
            if self._times:
                inInfo[0].GetInformationObject(0).Set(
                    sddp.UPDATE_TIME_STEP(), self._times[self._step])
            return 1

        def RequestData(self, request, inInfo, outInfo):
            super().RequestData(request, inInfo, outInfo)
            if self._step + 1 < len(self._times):
                request.Set(request.CONTINUE_EXECUTING(), 1)
                self._step += 1
            else:
                request.Remove(request.CONTINUE_EXECUTING())
                self._step = 0
            return 1

    # ParaView proxy registration when loaded as a ParaView Python plugin
    try:
        from paraview.util.vtkAlgorithm import (smdomain, smhint, smproperty,
                                                smproxy)
        vtkSlam = smproxy.filter(name="Slam", label="SLAM (CUDA)")(vtkSlam)
        vtkSlamManager = smproxy.filter(
            name="SlamManager", label="SLAM offline (CUDA)")(vtkSlamManager)
    except ImportError:
        pass
    return vtkSlam, vtkSlamManager


try:   # expose plugin classes when vtk exists (ParaView plugin loader path)
    vtkSlam, vtkSlamManager = make_vtk_slam_classes()
except ImportError:
    vtkSlam = vtkSlamManager = None
