"""The port's front ends on the CPU, on the cases of tests/test_ros_node.py
and tests/test_paraview_plugin.py (the TCP server's, of tests/test_server.py,
are in tests/test_torch_server.py, which shares the fixtures here):
`LidarSlamNode` (`ros_node.py`) on a recording facade, and the two repairs of its live-rospy glue
(ROADMAP Queue 3, D8) on genpy-style fakes; `SlamFilterCore`
(`paraview_plugin.py`). Each trajectory is held to a direct port `Slam`
fed the same sweeps within 1e-9 m and to the JAX package's front end on
the same sweeps within the CI's 0.01 m / 5 deg. Both packages take the
numpy ingest (ROADMAP Queue 3, F5)."""

import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import yaml

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu import paraview_plugin as jpv
from lidarslam_tpu import ros_node as jros
from lidarslam_tpu.io import native, synthetic
from lidarslam_tpu.io import yaml_config as jyaml
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch import paraview_plugin as tpv
from lidarslam_tpu_torch import ros_node as tros
from lidarslam_tpu_torch.config import MappingMode
from lidarslam_tpu_torch.core.se3 import quat_to_matrix
from lidarslam_tpu_torch.io import native as tnative
from lidarslam_tpu_torch.io import yaml_config as tyaml
from test_slam_e2e import small_config
from test_torch_config import _norm
from test_torch_slam import _one_torch_thread, _pose_err, _torch_config  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
N = 8             # sweeps: client A streams 0-3, client B 4-7
N_SYNC = 5        # sweeps of the synchronous drives
DIRECT_M = 1e-9   # against a direct port Slam fed the same sweeps
JAX_M, JAX_DEG = 0.01, 5.0


def _tslam():
    return TSlam(_torch_config(small_config()), device="cpu")


def _fields(cfg):
    return _norm(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def frames():
    return synthetic.generate_sequence(n_frames=N, motion_distortion=False,
                                       sensor=synthetic.SensorModel(range_noise=0.005))


@pytest.fixture(scope="module", autouse=True)
def _numpy_ingest():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        yield


def _vendor_frames(frames):
    """The sweeps as Velodyne-shaped arrays (microsecond times), and the
    frames the filter's conversion makes of them."""
    arrays = [(f["xyz"], (np.asarray(f["time"], np.float64) + f["stamp"]) * 1e6,
               f["intensity"], f["laser_id"]) for f in frames]
    return arrays, [tpv.arrays_to_frame(*a, time_factor=1e-6) for a in arrays]


@pytest.fixture(scope="module")
def direct_sync(frames):
    """A direct port Slam's synchronous run over the first N_SYNC sweeps."""
    s = _tslam()
    return [s.add_frame(f)["pose"] for f in frames[:N_SYNC]]


def _check(got, direct, jax):
    assert len(got) == len(direct) == len(jax)
    for i, (g, d, j) in enumerate(zip(got, direct, jax)):
        assert np.abs(g - d).max() <= DIRECT_M, i
        dt, dr = _pose_err(g, j)
        assert dt <= JAX_M and dr <= JAX_DEG, (i, dt, dr)


# ---------------------------------------------------------------------------
# the ROS node
# ---------------------------------------------------------------------------

class FakeRos:
    """Recording facade with the contract LidarSlamNode documents (the one
    of tests/test_ros_node.py)."""

    def __init__(self, params=None, mod=tros):
        self.cloud_cls, self.field_cls = mod.PointCloud2, mod.PointField
        self.params = params or {}
        self.published, self.subscribed, self.tf = {}, {}, []
        self._t = 0.0

    def get_param(self, key, default=None):
        return self.params if key == "" else self.params.get(key, default)

    def now(self):
        self._t += 0.01
        return self._t

    def Publisher(self, topic, kind, latch=False):
        self.published.setdefault(topic, [])

        def send(dictmsg, payload_cloud=None):
            self.published[topic].append(payload_cloud if payload_cloud is not None
                                         else dictmsg)
        return send

    def Subscriber(self, topic, kind, cb):
        self.subscribed[topic] = cb

    def send_transform(self, msg):
        self.tf.append(msg)


def _odom_pose(msg):
    p, o = msg["pose"]["pose"]["position"], msg["pose"]["pose"]["orientation"]
    H = np.eye(4)
    H[:3, :3] = quat_to_matrix(np.asarray([o["w"], o["x"], o["y"], o["z"]]))
    H[:3, 3] = [p["x"], p["y"], p["z"]]
    return H


def _cloud(mod, f):
    return mod.frame_to_cloud(f["xyz"], intensity=f["intensity"], time=f["time"],
                              laser_id=f["laser_id"], stamp=f["stamp"])


def test_pointcloud2_matches_jax(frames):
    f = frames[0]
    kw = {"intensity": f["intensity"], "time": f["time"], "laser_id": f["laser_id"],
          "device_id": 3, "stamp": f["stamp"]}
    cloud = tros.frame_to_cloud(f["xyz"], **kw)
    jcloud = jros.frame_to_cloud(f["xyz"], **kw)
    assert bytes(cloud.data) == bytes(jcloud.data)
    assert [(p.name, p.offset, p.datatype) for p in cloud.fields] == \
        [(p.name, p.offset, p.datatype) for p in jcloud.fields]
    g, j = tros.cloud_to_frame(cloud), jros.cloud_to_frame(jcloud)
    assert g.keys() == j.keys() and g["stamp"] == f["stamp"] and g["device_id"] == 3
    for k in ("xyz", "intensity", "laser_id", "time"):
        np.testing.assert_array_equal(g[k], j[k])
        assert g[k].dtype == j[k].dtype


def test_node_trajectory_and_topics(frames, direct_sync):
    """Sweeps through the PointCloud2 wire into `scan_callback`: the odometry
    and TF poses of the direct run (1e-9 m) and of JAX's node (0.01 m);
    the same topics and message fields as JAX's."""
    nodes = {}
    for mod, slam in ((tros, _tslam()), (jros, JSlam(small_config()))):
        ros = FakeRos(mod=mod)
        mod.LidarSlamNode(ros, slam=slam)
        for f in frames[:N_SYNC]:
            ros.subscribed["lidar_points"](_cloud(mod, f))
        nodes[mod] = ros
    ros, jros_ = nodes[tros], nodes[jros]
    assert set(ros.subscribed) == set(jros_.subscribed) == {"lidar_points", "set_slam_pose",
                                                           "slam_command"}
    assert set(ros.published) == set(jros_.published)
    odoms = ros.published["slam_odom"]
    _check([_odom_pose(m) for m in odoms], direct_sync,
           [_odom_pose(m) for m in jros_.published["slam_odom"]])
    for got, want in zip(odoms, direct_sync):
        assert got["header"]["frame_id"] == "odom" and got["child_frame_id"] == "base_link"
        assert len(got["pose"]["covariance"]) == 36
    for t, want in zip(ros.tf, direct_sync):
        tr = t["transform"]["translation"]
        assert np.abs([tr["x"] - want[0, 3], tr["y"] - want[1, 3],
                       tr["z"] - want[2, 3]]).max() <= DIRECT_M
    conf, jconf = ros.published["slam_confidence"][-1], jros_.published["slam_confidence"][-1]
    assert conf.keys() == jconf.keys() and conf["nb_matches"] > 0
    assert abs(conf["nb_matches"] - jconf["nb_matches"]) <= 0.01 * jconf["nb_matches"]
    reg = ros.published["slam_registered_points"][-1]
    assert reg.width == len(frames[N_SYNC - 1]["xyz"])
    for topic in ("maps/edges", "maps/planes", "keypoints/edges", "keypoints/planes"):
        got, want = ros.published[topic][-1], jros_.published[topic][-1]
        assert abs(got.width - want.width) <= 0.01 * want.width, topic


def test_node_gates_commands_gps_and_rig(frames):
    """Output gates, SlamCommand dispatch, the pose reset, the GPS log with
    SET_SLAM_POSE_FROM_GPS, and a secondary LiDAR aggregated with the main
    one (tests/test_ros_node.py's cases)."""
    params = {"output": {"pose": {"odom": True, "tf": False}, "confidence": False,
                         "registered_points": False,
                         "maps": {"edges": False, "planes": False, "blobs": False}}}
    ros = FakeRos(params)
    node = tros.LidarSlamNode(ros, slam=_tslam())
    assert node.pub_confidence is None and node.pub_registered is None
    assert not node.pub_maps and not node.publish_tf
    for f in frames[:2]:
        ros.subscribed["lidar_points"](dict(f))
    assert len(ros.published["slam_odom"]) == 2 and not ros.tf
    ros.subscribed["slam_command"]({"command": 8})
    assert node.slam.get_map_update() == MappingMode.NONE
    ros.subscribed["slam_command"]({"command": 10})
    assert node.slam.get_map_update() == MappingMode.UPDATE
    ros.subscribed["set_slam_pose"](
        {"pose": {"pose": {"position": {"x": 5.0, "y": -2.0, "z": 0.5},
                           "orientation": {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0}}}})
    np.testing.assert_allclose(node.slam.get_world_transform()[:3, 3], [5.0, -2.0, 0.5],
                               atol=1e-12)

    ros = FakeRos({"gps": {"use_gps": True}, "input": ["lidar_points", "lidar_points_2"]})
    node = tros.LidarSlamNode(ros, slam=_tslam())
    assert {"gps_odom", "lidar_points_2"} <= set(ros.subscribed)
    for i in range(3):
        ros.subscribed["gps_odom"](
            {"header": {"stamp": float(i)},
             "pose": {"pose": {"position": {"x": 1.0 * i, "y": 2.0 * i, "z": 0.0}},
                      "covariance": np.eye(6).ravel().tolist()}})
    ros.subscribed["slam_command"]({"command": 4})
    np.testing.assert_allclose(node.slam.get_world_transform()[:3, 3], [2.0, 4.0, 0.0],
                               atol=1e-12)
    ros.subscribed["lidar_points_2"](dict(frames[1], device_id=1))
    assert 1 in node._secondary
    r = ros.subscribed["lidar_points"](dict(frames[0]))
    assert not node._secondary and not r.get("failure")


def test_node_config_from_the_private_namespace():
    """The private namespace binds as JAX's node binds it (JAX dumps it to
    yaml text and loads that), and a node without a Slam builds one on the
    CUDA device: here, with none, it raises."""
    tree = yaml.safe_load((ROOT / "configs" / "slam_config_outdoor.yaml").read_text())
    tree["output"] = {"pose": {"tf": False}}
    want = jyaml.load_config(text=yaml.safe_dump(tree))
    assert _fields(tyaml.config_from_tree(tree)) == _fields(want)
    with pytest.raises(RuntimeError, match="CUDA"):
        tros.LidarSlamNode(FakeRos(tree))


# -- D8: genpy-style message classes -------------------------------------------

class _GenpyMsg:
    __slots__ = ()
    _slot_types = ()

    def __init__(self):
        for name, t in zip(self.__slots__, self._slot_types):
            setattr(self, name, _TYPES[t]() if t in _TYPES else
                    ([] if t.endswith("[]") else 0.0))


class Time:
    """rospy.Time's shape: secs / nsecs slots, from_sec / to_sec."""
    __slots__ = ("secs", "nsecs")

    def __init__(self, secs=0, nsecs=0):
        self.secs, self.nsecs = secs, nsecs

    @classmethod
    def from_sec(cls, s):
        secs = int(s)
        return cls(secs, int(round((s - secs) * 1e9)))

    def to_sec(self):
        return self.secs + self.nsecs * 1e-9


class Header(_GenpyMsg):
    __slots__ = ("stamp", "frame_id")
    _slot_types = ("time", "string")


class Point(_GenpyMsg):
    __slots__ = ("x", "y", "z")
    _slot_types = ("float64", "float64", "float64")


class Quaternion(_GenpyMsg):
    __slots__ = ("x", "y", "z", "w")
    _slot_types = ("float64",) * 4


class Pose(_GenpyMsg):
    __slots__ = ("position", "orientation")
    _slot_types = ("geometry_msgs/Point", "geometry_msgs/Quaternion")


class PoseStamped(_GenpyMsg):
    __slots__ = ("header", "pose")
    _slot_types = ("std_msgs/Header", "geometry_msgs/Pose")


class Path(_GenpyMsg):
    __slots__ = ("header", "poses")
    _slot_types = ("std_msgs/Header", "geometry_msgs/PoseStamped[]")


_TYPES = {"time": Time, "std_msgs/Header": Header, "geometry_msgs/Point": Point,
          "geometry_msgs/Quaternion": Quaternion, "geometry_msgs/Pose": Pose}


class _GenpyCloud:
    """A PointCloud2 as genpy generates it: the stamp only in the header."""
    __slots__ = ("header", "fields", "data", "point_step", "width", "height",
                 "is_bigendian", "row_step", "is_dense")


def test_cloud_stamp_from_the_header(frames):
    """D8, first repair: a message with no flat `stamp` takes
    `header.stamp.to_sec()` (JAX's reads 0.0); the twin is unchanged."""
    f = frames[2]
    twin = tros.frame_to_cloud(f["xyz"], intensity=f["intensity"], time=f["time"],
                               laser_id=f["laser_id"], stamp=f["stamp"])
    msg = _GenpyCloud()
    for name in msg.__slots__[1:]:
        setattr(msg, name, getattr(twin, name))
    msg.header = Header()
    msg.header.stamp = Time.from_sec(f["stamp"])
    assert tros.cloud_to_frame(msg)["stamp"] == pytest.approx(f["stamp"], abs=1e-9)
    assert jros.cloud_to_frame(msg)["stamp"] == 0.0
    msg.header.stamp = 12.5
    assert tros.cloud_to_frame(msg)["stamp"] == 12.5
    assert tros.cloud_to_frame(msg, stamp=3.0)["stamp"] == 3.0
    assert tros.cloud_to_frame(twin)["stamp"] == jros.cloud_to_frame(twin)["stamp"]


def test_rospy_facade_fills_times_and_message_lists(monkeypatch):
    """D8, second repair: `RospyFacade._rosify` turns float stamps into
    `rospy.Time` and a list of dicts into message instances of the field's
    element class, resolved like the facade's publishers."""
    pkg = types.ModuleType("geometry_msgs")
    msgs = types.ModuleType("geometry_msgs.msg")
    msgs.PoseStamped, msgs.Pose = PoseStamped, Pose
    monkeypatch.setitem(sys.modules, "geometry_msgs", pkg)
    monkeypatch.setitem(sys.modules, "geometry_msgs.msg", msgs)
    facade = object.__new__(tros.RospyFacade)
    facade.rospy = types.SimpleNamespace(Time=Time)
    pose = np.eye(4)
    pose[:3, 3] = [1.0, 2.0, 3.0]
    d = {"header": {"stamp": 12.25, "frame_id": "odom"},
         "poses": [{"header": {"stamp": 0.5 * i, "frame_id": "odom"},
                    "pose": tros._pose_dict(pose)} for i in range(3)]}
    path = facade._rosify(Path(), d)
    assert isinstance(path.header.stamp, Time) and path.header.stamp.to_sec() == 12.25
    assert [type(p) for p in path.poses] == [PoseStamped] * 3
    assert [p.header.stamp.to_sec() for p in path.poses] == [0.0, 0.5, 1.0]
    assert path.poses[2].pose.position.z == 3.0 and path.poses[0].pose.orientation.w == 1.0
    # the builders' other messages: header stamps only
    odom = tros.odometry_msg(pose, np.eye(6), 4.5, "odom", "base_link")
    assert odom["header"]["stamp"] == 4.5


# ---------------------------------------------------------------------------
# the ParaView core
# ---------------------------------------------------------------------------

def test_paraview_input_side_matches_jax():
    for names, calib in ((["adjustedtime", "intensity", "laser_id"], ()),
                         (["Raw Timestamp", "Signal Photons", "Channel"], ["Altitude Angles"]),
                         (["Timestamp", "Intensity", "LaserID"], ()),
                         (["adjustedtime", "intensity", "laser_id", "Timestamp", "Intensity",
                           "LaserID"], ["verticalCorrection"])):
        assert vars(tpv.identify_input_arrays(names, calib)) == \
            vars(jpv.identify_input_arrays(names, calib))
    with pytest.raises(ValueError):
        tpv.identify_input_arrays(["x", "y"])
    angles = [10.0, -30.0, 0.0, -15.0, 0.0]
    np.testing.assert_array_equal(tpv.laser_id_mapping(angles), jpv.laser_id_mapping(angles))
    xyz = np.array([[1, 0, 0], [0, 0, 0], [0, 2, 0]], np.float32)
    args = (xyz, np.array([100.0, 150.0, 300.0]), [7.0, 8.0, 9.0], [0, 1, 2])
    for kw in ({"time_factor": 1e-6, "mapping": np.asarray([5, 6, 7])}, {}):
        g, j = tpv.arrays_to_frame(*args, **kw), jpv.arrays_to_frame(*args, **kw)
        assert g.keys() == j.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], j[k])
    props = {"LocalizationICPMaxIter": 5, "VoxelGridLeafSizePlanes": 0.45,
             "KeyframeDistanceThreshold": 1.25, "EdgeSinAngleThreshold": 0.9,
             "UseBlobs": True, "Undistortion": 2, "VoxelGridSamplingModeEdges": 3}
    assert tpv.PROXY_TO_YAML == jpv.PROXY_TO_YAML
    assert _fields(tpv.config_from_proxy(props)) == _fields(jpv.config_from_proxy(props))
    with pytest.raises(KeyError):
        tpv.config_from_proxy({"NotAProxyProperty": 1})


def test_filter_core_matches_direct_and_jax(frames):
    """Velodyne arrays through `process`: the trajectory port's positions
    and orientations those of a direct run on the frames the conversion
    makes (1e-9) and of JAX's core (0.01 m); the port schema; reset."""
    arrays, converted = _vendor_frames(frames[:N_SYNC])
    s = _tslam()
    direct = [s.add_frame(f)["pose"] for f in converted]
    cores = []
    for mod, slam in ((tpv, _tslam()), (jpv, JSlam(small_config()))):
        core = mod.SlamFilterCore(slam=slam, advanced_return=True)
        core.identify(["adjustedtime", "intensity", "laser_id"])
        cores.append((core, [core.process(*a) for a in arrays]))
    (core, outs), (jcore, jouts) = cores
    traj, jtraj = outs[-1]["trajectory"], jouts[-1]["trajectory"]
    assert traj.keys() == jtraj.keys()
    for k in traj:
        assert traj[k].shape == jtraj[k].shape, k

    def poses(t):
        out = []
        for p, q in zip(t["points"], t["Orientation(Quaternion)"]):
            H = np.eye(4)
            H[:3, :3], H[:3, 3] = quat_to_matrix(q), p
            out.append(H)
        return out
    got = poses(traj)
    for g, d in zip(got, direct):
        assert np.abs(g[:3, 3] - d[:3, 3]).max() <= DIRECT_M
        assert np.abs(g[:3, :3] - d[:3, :3]).max() <= 1e-6     # through the quaternion
    for g, j in zip(got, poses(jtraj)):
        dt, dr = _pose_err(g, j)
        assert dt <= JAX_M and dr <= JAX_DEG
    out = outs[-1]
    assert set(out) == set(jouts[-1])
    assert out["registered_frame"]["xyz"].shape == arrays[-1][0].shape
    assert len(out["edge_map"]["xyz"]) > 0 and out["plane_keypoints"]["xyz"].shape[1] == 3
    assert set(out["debug"]) == set(jouts[-1]["debug"])
    core.reset()
    assert core.trajectory_arrays()["points"].shape == (0,) and core.n_frames == 0


def test_filter_core_needs_the_card_and_vtk():
    """Without a Slam the core builds one on the CUDA device (none here);
    without VTK the filter classes stay unbuilt, as in JAX."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tpv.SlamFilterCore()
    assert tpv.vtkSlam is None and tpv.vtkSlamManager is None
    with pytest.raises(ImportError):
        tpv.make_vtk_slam_classes()
