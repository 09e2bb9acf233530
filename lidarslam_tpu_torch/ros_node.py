"""ROS1 binding: the reference's LidarSlamNode as a Python node.

The reference's production node is `LidarSlamNode` (roscpp,
ros_wrapping/lidar_slam/src/LidarSlamNode.cxx:62-155): it subscribes to
1..N converted `lidar_points` topics, optional `gps_odom`, a
`set_slam_pose` reset topic and a `slam_command` control topic, and
publishes the pose as Odometry + TF, a `Confidence` message, and
map/submap/keypoint/registered PointCloud2 clouds, all gated by
`output/*` params (publisher table LidarSlamNode.cxx:96-127, output enum
:29-55, PublishOutput :519-622).

This module reproduces that node around the TPU engine with the
transport split out, because this environment has no ROS installation:

- **PointCloud2 codec** (`cloud_to_frame` / `frame_to_cloud`): the real
  `sensor_msgs/PointCloud2` binary wire format (fields table + packed
  point records). Works on any object with the message's attribute names
  — a live `sensor_msgs.msg.PointCloud2` under rospy, or the plain
  `PointCloud2` dataclass below in tests. Field names/types follow the
  reference's `LidarPoint` cloud (LidarPoint.h:31-77: x,y,z,time,
  intensity,laser_id,device_id,label).
- **`LidarSlamNode`**: the full callback/publish logic, written against a
  small `ros` facade (`Subscriber/Publisher/get_param/now/send_transform`).
  `RospyFacade` adapts the real rospy API when importable; tests drive
  the node through a recording fake. Message payloads are built as
  nested dicts whose keys mirror the ROS msg fields exactly
  (`nav_msgs/Odometry`, `lidar_slam/Confidence`,
  `geometry_msgs/TransformStamped`), and the facade recursively copies
  them onto real message instances (`fill_msg`) — so the node logic is
  identical with and without ROS on the machine.

Run under ROS1:  rosrun-style `python -m lidarslam_tpu_torch.ros_node` with the
reference's own `slam_config_*.yaml` loaded on the private namespace (the
same files bind through `io/yaml_config.py`).

The PyTorch port's copy of `lidarslam_tpu/ros_node.py`. `LidarSlamNode`
builds its `Slam` on the CUDA device unless a `Slam` is passed in. Two
repairs of the live-rospy glue differ from the JAX file (ROADMAP Queue 3,
D8): `cloud_to_frame` reads a real message's `header.stamp` when it has
no flat `stamp`, and `RospyFacade` turns float stamps into `rospy.Time`
and lists of dicts into lists of message instances when it fills a
message (`fill_msg`'s `time_cls` / `resolve`). Neither changes a result on
the `PointCloud2` twin.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

import numpy as np

from lidarslam_tpu_torch.config import Keypoint

# sensor_msgs/PointField datatype codes
_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}
_PF_CODES = {np.dtype(v): k for k, v in _PF_DTYPES.items()}


@dataclasses.dataclass
class PointField:
    """sensor_msgs/PointField twin (same attribute names)."""
    name: str
    offset: int
    datatype: int
    count: int = 1


@dataclasses.dataclass
class PointCloud2:
    """sensor_msgs/PointCloud2 twin (same attribute names); used by tests
    and by non-ROS callers; under rospy the real message class is used."""
    fields: List[PointField]
    data: bytes
    point_step: int
    width: int
    height: int = 1
    is_bigendian: bool = False
    row_step: int = 0
    is_dense: bool = True
    stamp: float = 0.0           # header.stamp flattened for the twin


def _cloud_dtype(cloud) -> np.dtype:
    names, formats, offsets = [], [], []
    for f in cloud.fields:
        if f.count != 1:     # LidarPoint uses scalar fields only
            raise ValueError(f"unsupported count {f.count} for {f.name}")
        names.append(f.name)
        formats.append(_PF_DTYPES[f.datatype])
        offsets.append(f.offset)
    return np.dtype({"names": names, "formats": formats, "offsets": offsets,
                     "itemsize": cloud.point_step})


def _cloud_stamp(cloud) -> float:
    """The twin's flat `stamp`, else a real message's `header.stamp` (a
    `rospy.Time`, or seconds), else 0."""
    if hasattr(cloud, "stamp"):
        return float(cloud.stamp)
    st = getattr(getattr(cloud, "header", None), "stamp", None)
    if st is None:
        return 0.0
    return float(st.to_sec() if hasattr(st, "to_sec") else st)


def cloud_to_frame(cloud, stamp: Optional[float] = None) -> dict:
    """PointCloud2 (LidarPoint layout) -> engine frame dict.

    Mirrors the conversion the reference does through PCL's
    `fromROSMsg` + the LidarPoint registration (LidarPoint.h:63-77):
    x/y/z/intensity/time/laser_id are required downstream; device_id and
    label default to 0 when the producing converter omitted them.
    """
    if cloud.is_bigendian:
        raise ValueError("big-endian clouds unsupported")
    n = cloud.width * cloud.height
    rec = np.frombuffer(bytes(cloud.data), _cloud_dtype(cloud), n)
    names = rec.dtype.names
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    frame = {
        "xyz": xyz,
        "intensity": (rec["intensity"].astype(np.float32)
                      if "intensity" in names else np.zeros(n, np.float32)),
        "laser_id": (rec["laser_id"].astype(np.int32)
                     if "laser_id" in names else np.zeros(n, np.int32)),
        "time": (rec["time"].astype(np.float32)
                 if "time" in names else np.zeros(n, np.float32)),
        "stamp": _cloud_stamp(cloud) if stamp is None else float(stamp),
    }
    if "device_id" in names:
        dev = np.asarray(rec["device_id"])
        frame["device_id"] = int(dev[0]) if n else 0
    return frame


def frame_to_cloud(xyz, intensity=None, time=None, laser_id=None,
                   device_id: int = 0, label=None, stamp: float = 0.0,
                   cls=PointCloud2, field_cls=PointField):
    """Engine arrays -> PointCloud2 in the reference's LidarPoint layout
    (x,y,z,time,intensity,laser_id,device_id,label — LidarPoint.h:31-64;
    16-byte xyz pad dropped: ROS wire needs no SSE alignment).

    `cls`/`field_cls` take the real sensor_msgs classes under rospy.
    """
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    dt = np.dtype([("x", np.float32), ("y", np.float32), ("z", np.float32),
                   ("time", np.float64), ("intensity", np.float32),
                   ("laser_id", np.uint16), ("device_id", np.uint8),
                   ("label", np.uint8)])
    rec = np.zeros(n, dt)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if time is not None:
        rec["time"] = np.asarray(time, np.float64)
    if intensity is not None:
        rec["intensity"] = np.asarray(intensity, np.float32)
    if laser_id is not None:
        rec["laser_id"] = np.asarray(laser_id, np.uint16)
    rec["device_id"] = device_id
    if label is not None:
        rec["label"] = np.asarray(label, np.uint8)
    fields = [field_cls(name=nm, offset=dt.fields[nm][1],
                        datatype=_PF_CODES[np.dtype(dt.fields[nm][0])],
                        count=1) for nm in dt.names]
    cloud = cls(fields=fields, data=rec.tobytes(), point_step=dt.itemsize,
                width=n, height=1, is_bigendian=False,
                row_step=n * dt.itemsize, is_dense=True)
    try:
        cloud.stamp = float(stamp)
    except AttributeError:        # real msg: stamp lives in header
        pass
    return cloud


# ---------------------------------------------------------------------------
# message builders (nested dicts mirroring the ROS msg field names)
# ---------------------------------------------------------------------------

def _pose_dict(hmat: np.ndarray) -> dict:
    """geometry_msgs/Pose from a 4x4 (Utils::TransformToPoseMsg role)."""
    from lidarslam_tpu_torch.core.se3 import quat_from_matrix

    hmat = np.asarray(hmat, np.float64)
    w, x, y, z = quat_from_matrix(hmat[:3, :3])
    return {"position": {"x": hmat[0, 3], "y": hmat[1, 3], "z": hmat[2, 3]},
            "orientation": {"x": x, "y": y, "z": z, "w": w}}


def odometry_msg(hmat, covariance, stamp: float, frame_id: str,
                 child_frame_id: str) -> dict:
    """nav_msgs/Odometry (PublishOutput, LidarSlamNode.cxx:528-538).

    The reference copies the 6x6 covariance row-major into
    pose.covariance (:536-537); its block order is (position, orientation)
    — the engine's covariance uses the same XYZRPY order.
    """
    return {"header": {"stamp": float(stamp), "frame_id": frame_id},
            "child_frame_id": child_frame_id,
            "pose": {"pose": _pose_dict(hmat),
                     "covariance": np.asarray(covariance, np.float64)
                     .ravel().tolist()}}


def transform_msg(hmat, stamp: float, frame_id: str, child_frame_id: str) -> dict:
    """geometry_msgs/TransformStamped (Utils::TransformToTfMsg role)."""
    p = _pose_dict(hmat)
    return {"header": {"stamp": float(stamp), "frame_id": frame_id},
            "child_frame_id": child_frame_id,
            "transform": {"translation": p["position"],
                          "rotation": p["orientation"]}}


def confidence_msg(out, stamp: float, duration: float = 0.0) -> dict:
    """lidar_slam/Confidence (Confidence.msg:1-32): covariance36 +
    overlap + nb_matches + comply_motion_limits + computation_time."""
    return {"header": {"stamp": float(stamp), "frame_id": ""},
            "covariance": np.asarray(out.covariance, np.float64)
            .ravel().tolist(),
            "overlap": float(out.overlap),
            "nb_matches": int(out.n_matches),
            "comply_motion_limits": bool(out.comply_motion_limits),
            "computation_time": float(duration)}


def _element_type(msg, field: str) -> str:
    """`pkg/Name` of the elements of a message's array field, from the
    generated class's `__slots__` / `_slot_types` (e.g.
    'geometry_msgs/PoseStamped[]' -> 'geometry_msgs/PoseStamped')."""
    t = msg._slot_types[list(msg.__slots__).index(field)]
    return t.split("[", 1)[0]


def fill_msg(msg, d: dict, time_cls, resolve):
    """Recursively copy a nested dict onto a real ROS message instance
    (keys = msg field names). Lets one builder serve both the fake and
    the live transport.

    A number under a `stamp` key becomes `time_cls.from_sec(v)` (time_cls:
    rospy.Time); a list of dicts becomes a list of instances of the field's
    element class, found by `resolve` ('pkg/Name' -> message class), each
    filled the same way."""
    for k, v in d.items():
        if isinstance(v, dict):
            fill_msg(getattr(msg, k), v, time_cls, resolve)
        elif k == "stamp" and isinstance(v, (int, float)):
            setattr(msg, k, time_cls.from_sec(float(v)))
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            cls = resolve(_element_type(msg, k))
            setattr(msg, k, [fill_msg(cls(), item, time_cls, resolve) for item in v])
        else:
            setattr(msg, k, v)
    return msg


# ---------------------------------------------------------------------------
# the node
# ---------------------------------------------------------------------------

# SlamCommand ids (lidar_slam/msg/SlamCommand.msg:1-45)
GPS_SLAM_CALIBRATION = 0
GPS_SLAM_POSE_GRAPH_OPTIMIZATION = 2
SET_SLAM_POSE_FROM_GPS = 4
DISABLE_SLAM_MAP_UPDATE = 8
ENABLE_SLAM_MAP_EXPANSION = 9
ENABLE_SLAM_MAP_UPDATE = 10
SAVE_KEYPOINTS_MAPS = 16
SAVE_FILTERED_KEYPOINTS_MAPS = 17
LOAD_KEYPOINTS_MAPS = 18

_KP_TOPICS = {Keypoint.EDGE: "edges", Keypoint.PLANE: "planes",
              Keypoint.BLOB: "blobs"}


class LidarSlamNode:
    """The reference LidarSlamNode's behavior over a pluggable `ros`
    facade (LidarSlamNode.cxx:62-155 ctor, :158-194 scan callbacks,
    :229-241 pose reset, :244-349 command dispatch, :519-622 publish).

    The facade needs: `get_param(key, default)` (key "" = whole private
    namespace), `Publisher(topic, kind, latch=False) -> callable(dictmsg,
    payload_cloud=None)`, `Subscriber(topic, kind, cb)`,
    `send_transform(dictmsg)`, `now() -> float`, and cloud classes
    `cloud_cls/field_cls` for `frame_to_cloud`.
    """

    def __init__(self, ros, slam=None):
        from lidarslam_tpu_torch.io.yaml_config import config_from_tree
        from lidarslam_tpu_torch.slam import Slam

        self.ros = ros
        params = dict(ros.get_param("", {}))
        self.params = params
        if slam is None:
            # the private namespace is the yaml tree itself: bound as the
            # loader binds a parsed file, on the CUDA device
            slam = Slam(config_from_tree(params))
        self.slam = slam

        # frames (LidarSlamNode.cxx:66-71)
        self.odometry_frame = params.get("odometry_frame", "odom")
        self.tracking_frame = params.get("tracking_frame", "base_link")

        # output gates (publisher table :96-127; defaults mirrored)
        out = params.get("output", {})

        def gate(section, key, default):
            return bool(out.get(section, {}).get(key, default)
                        if isinstance(out.get(section, {}), dict)
                        else default)

        self.publish_tf = gate("pose", "tf", True)
        self.publish_predicted_tf = gate("pose", "predicted_tf", False)
        self.pub_odom = (ros.Publisher("slam_odom", "nav_msgs/Odometry")
                         if gate("pose", "odom", True) else None)
        self.pub_predicted_odom = (
            ros.Publisher("slam_predicted_odom", "nav_msgs/Odometry")
            if gate("pose", "predicted_odom", False) else None)
        # `output/confidence` and `output/registered_points` are scalar
        # bools in the reference yaml (slam_config_outdoor.yaml:25,44)
        self.pub_confidence = (
            ros.Publisher("slam_confidence", "lidar_slam/Confidence")
            if bool(out.get("confidence", True)) else None)
        self.pub_maps, self.pub_keypoints = {}, {}
        for k, name in _KP_TOPICS.items():
            if k not in self.slam.cfg.used_types:
                continue
            if gate("maps", name, True):
                self.pub_maps[k] = ros.Publisher(f"maps/{name}",
                                                 "sensor_msgs/PointCloud2")
            if gate("keypoints", name, True):
                self.pub_keypoints[k] = ros.Publisher(
                    f"keypoints/{name}", "sensor_msgs/PointCloud2")
        self.pub_registered = (
            ros.Publisher("slam_registered_points", "sensor_msgs/PointCloud2")
            if bool(out.get("registered_points", True)) else None)
        # maps are heavy: publish every Nth frame (output/maps/update_step)
        maps_out = out.get("maps", {}) if isinstance(out.get("maps", {}), dict) else {}
        self.maps_update_step = int(maps_out.get("update_step", 1))

        # GPS (ctor :91-94, :150-153; logging :197-226)
        self.use_gps = bool(params.get("gps", {}).get("use_gps", False))
        self.gps_log = []          # (time, position(3), cov(3,3))
        self.pub_pgo_path = (ros.Publisher("pgo_slam_path", "nav_msgs/Path",
                                           latch=True)
                             if self.use_gps else None)

        # initial pose / maps (ctor :73-88)
        init = params.get("maps", {})
        if init.get("initial_maps"):
            self.slam.load_maps_from_pcd(str(init["initial_maps"]))
        pose6 = init.get("initial_pose")
        if pose6 and len(pose6) == 6:
            from lidarslam_tpu_torch.core.se3 import pose_to_hmat
            self.slam.set_world_transform_from_guess(
                pose_to_hmat(np.asarray(pose6, np.float64)))

        # subscribers (ctor :130-153)
        inputs = params.get("input", "lidar_points")
        if isinstance(inputs, str):
            inputs = [inputs]
        self._secondary = {}      # device frames awaiting the main frame
        ros.Subscriber(inputs[0], "sensor_msgs/PointCloud2",
                       self.scan_callback)
        for topic in inputs[1:]:
            ros.Subscriber(topic, "sensor_msgs/PointCloud2",
                           self.secondary_scan_callback)
        ros.Subscriber("set_slam_pose", "geometry_msgs/PoseWithCovarianceStamped",
                       self.set_pose_callback)
        ros.Subscriber("slam_command", "lidar_slam/SlamCommand",
                       self.command_callback)
        if self.use_gps:
            ros.Subscriber("gps_odom", "nav_msgs/Odometry", self.gps_callback)
        self.frame_count = 0

    # ---- scan path (ScanCallback :158-178) ----

    def scan_callback(self, cloud):
        frame = cloud if isinstance(cloud, dict) else cloud_to_frame(cloud)
        frames = [frame]
        if self._secondary:        # MultiLidarFrames aggregation (:181-194)
            frames += [self._secondary.pop(d) for d in sorted(self._secondary)]
        t0 = self.ros.now()
        result = (self.slam.add_frames(frames) if len(frames) > 1
                  else self.slam.add_frame(frame))
        if result.get("skipped"):
            return result
        self.frame_count += 1
        self._publish(frame, result, duration=self.ros.now() - t0)
        return result

    def secondary_scan_callback(self, cloud):
        frame = cloud if isinstance(cloud, dict) else cloud_to_frame(cloud)
        self._secondary[int(frame.get("device_id", 1))] = frame

    # ---- control path ----

    def set_pose_callback(self, msg):
        """SetPoseCallback (:229-241): external pose reset."""
        from lidarslam_tpu_torch.core.se3 import quat_to_matrix

        p = msg["pose"]["pose"] if isinstance(msg, dict) else msg.pose.pose
        if not isinstance(msg, dict):
            p = {"position": {"x": p.position.x, "y": p.position.y,
                              "z": p.position.z},
                 "orientation": {"x": p.orientation.x, "y": p.orientation.y,
                                 "z": p.orientation.z, "w": p.orientation.w}}
        h = np.eye(4)
        o = p["orientation"]
        h[:3, :3] = quat_to_matrix(np.asarray(
            [o["w"], o["x"], o["y"], o["z"]], np.float64))
        h[:3, 3] = [p["position"]["x"], p["position"]["y"], p["position"]["z"]]
        self.slam.set_world_transform_from_guess(h)

    def command_callback(self, msg):
        """SlamCommandCallback (:244-349)."""
        cmd = int(msg["command"] if isinstance(msg, dict) else msg.command)
        arg = str(msg.get("string_arg", "") if isinstance(msg, dict)
                  else getattr(msg, "string_arg", ""))
        if cmd in (GPS_SLAM_CALIBRATION, GPS_SLAM_POSE_GRAPH_OPTIMIZATION,
                   SET_SLAM_POSE_FROM_GPS):
            if not self.gps_log:
                raise ValueError("no GPS positions logged "
                                 "(gps/use_gps off or no gps_odom received)")
            times = np.asarray([g[0] for g in self.gps_log])
            pos = np.asarray([g[1] for g in self.gps_log])
            covs = np.asarray([g[2] for g in self.gps_log])
            if cmd == SET_SLAM_POSE_FROM_GPS:   # :262-282
                h = np.asarray(self.slam.get_world_transform()).copy()
                h[:3, 3] = pos[-1]
                self.slam.set_world_transform_from_guess(h)
                return
            res = self.slam.execute_command(
                cmd, arg, gps_positions=pos, gps_times=times, gps_covariances=covs)
            if cmd == GPS_SLAM_POSE_GRAPH_OPTIMIZATION and self.pub_pgo_path:
                self.pub_pgo_path(
                    {"header": {"stamp": self.ros.now(),
                                "frame_id": self.odometry_frame},
                     "poses": [{"header": {"stamp": t, "frame_id":
                                           self.odometry_frame},
                                "pose": _pose_dict(p)}
                               for t, p in self.slam.get_trajectory()]})
            return res
        return self.slam.execute_command(cmd, arg)

    def gps_callback(self, msg):
        """GpsCallback (:197-226): log world-frame GPS positions+cov."""
        if isinstance(msg, dict):
            p = msg["pose"]["pose"]["position"]
            cov = np.asarray(msg["pose"]["covariance"], np.float64).reshape(6, 6)
            t = float(msg["header"]["stamp"])
        else:
            pp = msg.pose.pose.position
            p = {"x": pp.x, "y": pp.y, "z": pp.z}
            cov = np.asarray(msg.pose.covariance, np.float64).reshape(6, 6)
            t = float(msg.header.stamp.to_sec()
                      if hasattr(msg.header.stamp, "to_sec")
                      else msg.header.stamp)
        self.gps_log.append((t, np.asarray([p["x"], p["y"], p["z"]]),
                             cov[:3, :3]))

    # ---- publish path (PublishOutput :519-622) ----

    def _publish(self, frame: dict, result: dict, duration: float):
        slam, ros = self.slam, self.ros
        stamp = float(frame["stamp"])
        pose = np.asarray(slam.get_world_transform())
        cov = np.asarray(slam.get_covariance())
        if self.pub_odom:
            self.pub_odom(odometry_msg(pose, cov, stamp, self.odometry_frame,
                                       self.tracking_frame))
        if self.publish_tf:
            ros.send_transform(transform_msg(pose, stamp, self.odometry_frame,
                                             self.tracking_frame))
        if self.pub_predicted_odom or self.publish_predicted_tf:
            pred = np.asarray(slam.get_latency_compensated_world_transform())
            if self.pub_predicted_odom:
                self.pub_predicted_odom(odometry_msg(
                    pred, cov, stamp, self.odometry_frame,
                    self.tracking_frame + "_prediction"))
            if self.publish_predicted_tf:
                ros.send_transform(transform_msg(
                    pred, stamp, self.odometry_frame,
                    self.tracking_frame + "_prediction"))
        if self.pub_confidence:
            class _O:     # confidence_msg reads attribute style
                covariance, overlap = cov, result.get("overlap", 0.0)
                n_matches = result.get("n_matches", 0)
                comply_motion_limits = result.get("comply_motion_limits", True)
            self.pub_confidence(confidence_msg(_O, stamp, duration))
        publish_maps = (self.maps_update_step > 0
                        and self.frame_count % self.maps_update_step == 0)
        for k, pub in self.pub_maps.items():
            if not publish_maps:
                break
            xyz, inten, _, _ = slam.get_map_points(k)
            pub(None, payload_cloud=frame_to_cloud(
                xyz, intensity=inten, stamp=stamp, cls=ros.cloud_cls,
                field_cls=ros.field_cls))
        for k, pub in self.pub_keypoints.items():
            xyz = slam.get_keypoints(k, world=True)
            pub(None, payload_cloud=frame_to_cloud(
                xyz, stamp=stamp, cls=ros.cloud_cls, field_cls=ros.field_cls))
        if self.pub_registered:
            xyz = slam.get_registered_frame(frame)
            self.pub_registered(None, payload_cloud=frame_to_cloud(
                xyz, intensity=frame.get("intensity"),
                time=frame.get("time"), laser_id=frame.get("laser_id"),
                stamp=stamp, cls=ros.cloud_cls, field_cls=ros.field_cls))


# ---------------------------------------------------------------------------
# live transport
# ---------------------------------------------------------------------------

class RospyFacade:
    """Adapter binding the node to a live ROS1 system. Import-gated: only
    constructed under `python -m lidarslam_tpu_torch.ros_node` on a machine with
    rospy + lidar_slam msgs installed."""

    def __init__(self, node_name="lidar_slam"):
        import rospy
        from sensor_msgs.msg import PointCloud2 as RosCloud, PointField as RosField

        self.rospy = rospy
        self.cloud_cls, self.field_cls = RosCloud, RosField
        rospy.init_node(node_name)

    def get_param(self, key, default=None):
        return self.rospy.get_param("~" + key if key else "~", default)

    def now(self):
        return self.rospy.Time.now().to_sec()

    def _msg_class(self, kind):
        import importlib
        pkg, name = kind.split("/")
        mod = importlib.import_module(
            pkg + ".msg" if not pkg.endswith("_msgs") else pkg + ".msg")
        return getattr(mod, name)

    def Publisher(self, topic, kind, latch=False):
        cls = self._msg_class(kind)
        pub = self.rospy.Publisher(topic, cls, queue_size=1, latch=latch)

        def send(dictmsg, payload_cloud=None):
            if payload_cloud is not None:
                msg = payload_cloud
                msg.header.stamp = self.rospy.Time.now()
            else:
                msg = self._rosify(cls(), dictmsg)
            pub.publish(msg)
        return send

    def _rosify(self, msg, d):
        """Fill a message instance from a builder dict: float stamps become
        `rospy.Time`, lists of dicts become lists of the field's message
        class (the JAX file sets both as they are, which genpy refuses to
        serialize; ROADMAP Queue 3, D8)."""
        return fill_msg(msg, d, time_cls=self.rospy.Time, resolve=self._msg_class)

    def Subscriber(self, topic, kind, cb):
        return self.rospy.Subscriber(topic, self._msg_class(kind), cb,
                                     queue_size=1)

    def send_transform(self, dictmsg):
        import tf2_ros
        if not hasattr(self, "_tf"):
            self._tf = tf2_ros.TransformBroadcaster()
        from geometry_msgs.msg import TransformStamped
        self._tf.sendTransform(self._rosify(TransformStamped(), dictmsg))

    def spin(self):
        self.rospy.spin()


def main():
    try:
        facade = RospyFacade()
    except ImportError:
        print("rospy is not installed: this entry point needs a ROS1 "
              "environment. The engine itself runs without ROS — see "
              "`python -m lidarslam_tpu_torch.cli serve` for the TCP server.",
              file=sys.stderr)
        return 2
    LidarSlamNode(facade)
    facade.spin()
    return 0


if __name__ == "__main__":
    sys.exit(main())
