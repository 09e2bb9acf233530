"""Live per-frame output stream — the vtkSlam 8-port surface as a
programmatic subscription (vtkSlam.cxx:47-60, LidarSlamNode::PublishOutput
519-622).

`Slam.subscribe(cb)` registers a callback invoked once per processed frame
(synchronous path) or per flushed frame (streaming path) with a
`FrameOutput`: the scalar outputs (pose, covariance, confidence) are host
data already paid for by the frame sync, while the array ports — keypoint
clouds, maps, registered frame — are LAZY: nothing touches the device
unless the subscriber actually reads them, so a pose-only consumer adds
zero device traffic to a streaming run.

PyTorch port of `lidarslam_tpu/outputs.py`: the keypoint ports read either
the sync path's device `Keypoints` or the stream's lazy `KeypointsView`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class FrameOutput:
    """One frame's output ports. Scalars are plain attributes; array ports
    are methods that pull from the device on first access."""

    def __init__(self, slam, stamp: float, frame_index: int, summary: dict,
                 is_keyframe: bool, keypoint_views: Optional[dict] = None):
        self._slam = slam
        self._views = keypoint_views   # per-type view/Keypoints at emission
        self.stamp = float(stamp)
        self.frame_index = int(frame_index)
        self.pose = summary["pose"]                    # (4,4) world, float64
        self.covariance = summary["covariance"]        # (6,6)
        self.n_matches = summary["n_matches"]
        self.overlap = summary["overlap"]
        self.failure = summary["failure"]
        self.comply_motion_limits = summary["comply_motion_limits"]
        self.is_keyframe = bool(is_keyframe)

    # ---- confidence port (Confidence.msg role) ----
    @property
    def confidence(self) -> dict:
        return {"overlap": self.overlap, "nb_matches": self.n_matches,
                "comply_motion_limits": self.comply_motion_limits,
                "covariance": self.covariance}

    # ---- trajectory port ----
    def trajectory(self):
        """The engine's trajectory log up to this frame (list of dicts)."""
        return self._slam.log_trajectory

    # ---- keypoint ports (EDGE/PLANE/BLOB_KEYPOINTS_OUTPUT_PORT) ----
    def keypoints(self, k, world: bool = True) -> np.ndarray:
        """This frame's extracted keypoints of type `k` (lazy device pull).
        `world` applies this frame's optimized pose."""
        kp = self._views[k]
        xyz = _host(kp.xyz)[_host(kp.valid)]
        if world:
            xyz = xyz @ self.pose[:3, :3].T.astype(np.float32) \
                + self.pose[:3, 3].astype(np.float32)
        return xyz

    # ---- map ports (EDGE/PLANE/BLOB_MAP_OUTPUT_PORT) ----
    def map_points(self, k, clean: bool = False) -> np.ndarray:
        """The rolling map of type `k` (lazy device pull). In streaming
        flushes this is the segment-final map (maps advance on device;
        per-frame snapshots would cost a device copy per frame)."""
        return self._slam.get_map_points(k, clean=clean)[0]

    # ---- registered-frame port (SLAM_FRAME_OUTPUT_PORT) ----
    def registered_frame(self, frame: dict) -> np.ndarray:
        """World-registered copy of the raw sweep that produced this frame
        (caller retains the raw sweep; the engine does not keep full sweeps
        on device)."""
        return self._slam.get_registered_frame(frame)
