"""The runtime commands and the output subscription of the PyTorch port's
`Slam`, on the CPU, on the cases of tests/test_runtime_commands.py and
tests/test_outputs.py: one drive through `add_frame_async` / `flush` and
`add_frame` takes every command (the live map-update switches mid-stream,
map save and load, GPS calibration, PGO and the pose reset), while a
subscriber records each frame's `FrameOutput`."""

import numpy as np
import pytest
from scipy.spatial import cKDTree

from lidarslam_tpu.backend import registration as jreg
from lidarslam_tpu.io import native
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.config import Keypoint, MappingMode
from lidarslam_tpu_torch.io import native as tnative
from lidarslam_tpu_torch.ops.frame import KeypointsView
from test_torch_pgo_slam import gps_from_ground_truth
from test_torch_slam import _one_torch_thread, _torch_config  # noqa: F401
from test_torch_stream import _jcfg

N_FRAMES = 16
GPS_ANGLE = 0.3
GPS_SHIFT = np.array([5.0, -2.0, 0.3])


def _plane_points(slam):
    return len(slam.get_map_points(Keypoint.PLANE)[0])


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """Frames 0-3 streamed, DISABLE_SLAM_MAP_UPDATE mid-stream, 4-6 streamed
    and flushed, ENABLE_SLAM_MAP_UPDATE, 7-9 streamed and saved by
    SAVE_KEYPOINTS_MAPS (which flushes), ENABLE_SLAM_MAP_EXPANSION,
    LOAD_KEYPOINTS_MAPS, 10-11 through add_frame, GPS_SLAM_CALIBRATION,
    12-13 streamed, GPS_SLAM_POSE_GRAPH_OPTIMIZATION (which flushes),
    14-15 streamed and flushed, the subscriber dropped, one more add_frame,
    SET_SLAM_POSE_FROM_GPS."""
    d = tmp_path_factory.mktemp("cmd")
    frames = jsyn.generate_sequence(n_frames=N_FRAMES, motion_distortion=False,
                                    sensor=jsyn.SensorModel(range_noise=0.005))
    slam = TSlam(_torch_config(_jcfg()), device="cpu")
    got, facts = [], {}
    unsubscribe = slam.subscribe(got.append)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        for f in frames[:4]:
            slam.add_frame_async(f)
        slam.execute_command(TSlam.DISABLE_SLAM_MAP_UPDATE)        # no flush
        facts["open_after_disable"] = slam._stream_state is not None
        facts["frozen"] = int(slam._stream_state.maps[int(Keypoint.PLANE)].valid.sum())
        for f in frames[4:7]:
            slam.add_frame_async(f)
        facts["outs_frozen"] = slam.flush()
        facts["after_frozen"] = _plane_points(slam)
        slam.execute_command(TSlam.ENABLE_SLAM_MAP_UPDATE)
        for f in frames[7:10]:
            slam.add_frame_async(f)
        prefix = str(d / "cmdmap_")
        slam.execute_command(TSlam.SAVE_KEYPOINTS_MAPS, prefix)     # flushes
        facts["n_frames_at_save"] = slam.n_frames
        facts["after_update"] = _plane_points(slam)
        facts["files"] = sorted(p.name for p in d.iterdir())
        slam.execute_command(TSlam.ENABLE_SLAM_MAP_EXPANSION)
        slam.execute_command(TSlam.LOAD_KEYPOINTS_MAPS, prefix)
        facts["loaded"] = slam.get_map_points(Keypoint.PLANE)
        facts["sync"] = [slam.add_frame(f) for f in frames[10:12]]
        facts["after_expansion"] = _plane_points(slam)
        facts["mode"] = slam.get_map_update()
        xyz = np.stack([e["pose"][:3, 3] for e in slam.log_trajectory])
        R = np.array([[np.cos(GPS_ANGLE), -np.sin(GPS_ANGLE), 0],
                      [np.sin(GPS_ANGLE), np.cos(GPS_ANGLE), 0], [0, 0, 1.0]])
        facts["calib_inputs"] = (xyz, xyz @ R.T + GPS_SHIFT, R)
        facts["calib"] = slam.execute_command(TSlam.GPS_SLAM_CALIBRATION,
                                              gps_positions=xyz @ R.T + GPS_SHIFT)
        for f in frames[12:14]:
            slam.add_frame_async(f)
        gps, stamps = gps_from_ground_truth(frames[:14])
        facts["pgo"] = slam.execute_command(TSlam.GPS_SLAM_POSE_GRAPH_OPTIMIZATION,
                                            gps_positions=gps, gps_times=stamps)
        facts["n_frames_at_pgo"] = slam.n_frames
        facts["open_after_pgo"] = slam._stream_state is not None
        for f in frames[14:]:
            slam.add_frame_async(f)
        facts["outs_after_pgo"] = slam.flush()
        unsubscribe()
        slam.add_frame({**frames[-1], "stamp": frames[-1]["stamp"] + 0.1})
        slam.execute_command(TSlam.SET_SLAM_POSE_FROM_GPS, pose=np.eye(4))
        with pytest.raises(ValueError, match="unknown SLAM command"):
            slam.execute_command(99)
    return slam, frames, got, facts


def test_live_map_update_switch_mid_stream(drive):
    """DISABLE mid-stream leaves the segment open and freezes the map for
    the frames after it; ENABLE makes it grow again; no frame fails."""
    slam, _, _, facts = drive
    assert facts["open_after_disable"]
    assert facts["frozen"] > 200 and facts["after_frozen"] == facts["frozen"]
    assert facts["after_update"] > facts["frozen"]
    assert all(not o["failure"] for o in facts["outs_frozen"])
    assert facts["mode"] == MappingMode.ADD_KPTS_TO_FIXED_MAP


def test_save_and_load_commands_mid_run(drive):
    """SAVE flushes the open stream and writes one PCD per map; under
    ENABLE_SLAM_MAP_EXPANSION the loaded map is fixed, and new keypoints
    still aggregate on the frames after it."""
    _, _, _, facts = drive
    assert facts["n_frames_at_save"] == 10
    assert facts["files"] == ["cmdmap_edges.pcd", "cmdmap_planes.pcd"]
    xyz, _, _, fixed = facts["loaded"]
    assert len(xyz) == facts["after_update"] and fixed.all()
    assert all(not r["failure"] and r["n_matches"] > 100 for r in facts["sync"])
    assert facts["after_expansion"] >= len(xyz)


def test_gps_calibration_command(drive):
    """GPS_SLAM_CALIBRATION returns the rigid WORLD<-ODOM transform, as the
    JAX package's registration computes it on the same trajectory."""
    _, _, _, facts = drive
    xyz, gps, R = facts["calib_inputs"]
    T = facts["calib"]
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-3)
    np.testing.assert_allclose(T[:3, 3], GPS_SHIFT, atol=0.05)
    np.testing.assert_allclose(T, jreg.compute_transform_offset(xyz, gps), atol=1e-12)


def test_pgo_command_flushes_and_the_stream_goes_on(drive):
    """GPS_SLAM_POSE_GRAPH_OPTIMIZATION flushes the open stream, succeeds,
    and the next segment (seeded from the rebuilt maps) tracks without a
    failure; SET_SLAM_POSE_FROM_GPS resets the pose."""
    slam, _, _, facts = drive
    assert facts["pgo"] is True
    assert facts["n_frames_at_pgo"] == 14 and not facts["open_after_pgo"]
    outs = facts["outs_after_pgo"]
    assert len(outs) == 2 and all(not o["failure"] and o["n_matches"] > 100 for o in outs)
    np.testing.assert_array_equal(slam.get_world_transform(), np.eye(4))


def test_subscriber_sees_every_frame_in_order(drive):
    """One FrameOutput per processed frame (sync) or flushed frame (stream),
    in frame order, with the summary's pose; the first frame a keyframe;
    nothing after the unsubscribe."""
    slam, _, got, facts = drive
    assert [o.frame_index for o in got] == list(range(N_FRAMES))     # none after it
    assert slam.n_frames == N_FRAMES + 1
    assert got[0].is_keyframe
    assert len(facts["outs_frozen"]) == 7             # the segment of frames 0-6
    for o, r in zip(got[:7], facts["outs_frozen"]):
        np.testing.assert_array_equal(o.pose, r["pose"])
    for o, r in zip(got[10:12], facts["sync"]):
        np.testing.assert_array_equal(o.pose, r["pose"])
        assert o.n_matches == r["n_matches"] > 0
        assert o.confidence["nb_matches"] == o.n_matches
    assert got[-1].trajectory() is slam.log_trajectory      # the live log, as in JAX


def test_array_ports_stay_lazy(drive):
    """The streamed frames' keypoint ports are views nothing has read (a
    pose-only subscriber moves no keypoints off the device); read, the last
    frame's world keypoints lie on its map."""
    slam, _, got, _ = drive
    views = got[-1]._views
    assert all(isinstance(v, KeypointsView) and v._host is None for v in views.values())
    kp = got[-1].keypoints(Keypoint.PLANE, world=True)
    assert kp.ndim == 2 and kp.shape[1] == 3 and len(kp) > 50
    assert views[Keypoint.PLANE]._host is not None
    mp = got[-1].map_points(Keypoint.PLANE)
    d, _ = cKDTree(mp).query(kp[:200])
    assert len(mp) > 100 and np.median(d) < 0.5


def test_pgo_replays_every_storage_tier(drive, tmp_path):
    """run_pose_graph_optimization restores the logged keypoints from every
    LoggingStorage tier: the drive's DEVICE log put through HOST and DISK
    rebuilds the same maps as DEVICE; through COMPRESSED and OCTREE each
    restored keypoint lies within the quantum (storage.QUANT) of a DEVICE
    keypoint, and
    the rebuilt maps lie on the DEVICE rebuild's (quantizing moves the
    ground's points across the 0.6 m leaf boundary at z = -1.8 m, so their
    leaves, and the point counts, differ by a few percent). (Runs last: it
    rewrites the drive's poses and maps.)"""
    import copy

    from lidarslam_tpu_torch.config import LoggingStorage
    from lidarslam_tpu_torch.io import storage

    slam, _, _, _ = drive
    log = copy.deepcopy(slam.log_trajectory)
    device_log = slam.log_keypoints
    assert len(device_log) == len(log) == N_FRAMES + 1
    times = np.array([e["time"] for e in log])
    gps = np.stack([e["pose"][:3, 3] for e in log]) + 0.01
    maps, kinds = {}, set()
    for tier in LoggingStorage:
        slam.log_trajectory = copy.deepcopy(log)
        slam.log_keypoints = [
            {k: storage.store(e[k], tier, directory=str(tmp_path), tag=f"{i}_{int(k)}")
             for k in e} for i, e in enumerate(device_log)]
        for e, d in zip(slam.log_keypoints, device_log):
            for k in e:
                got, want = storage.restore(e[k]).xyz, storage.restore(d[k]).xyz
                assert got.shape == want.shape
                if len(want):       # OCTREE restores in its own order
                    assert cKDTree(want).query(got)[0].max() <= storage.QUANT, tier.name
        assert slam.run_pose_graph_optimization(gps, times)
        maps[tier] = {k: slam.get_map_points(k)[0] for k in slam.cfg.used_types}
        kinds.add(type(slam.log_keypoints[0][Keypoint.PLANE]).__name__)
    assert {"HostCloud", "CompressedCloud", "OctreeCloud", "DiskCloud"} < kinds
    for tier, m in maps.items():
        for k, want in maps[LoggingStorage.DEVICE].items():
            assert len(want) > 200
            if tier in (LoggingStorage.HOST, LoggingStorage.DISK):
                np.testing.assert_array_equal(m[k], want, err_msg=tier.name)
            else:
                d, _ = cKDTree(want).query(m[k])
                assert np.median(d) < storage.QUANT and abs(len(m[k]) - len(want)) \
                    <= 0.05 * len(want), (tier.name, np.median(d), len(m[k]), len(want))
