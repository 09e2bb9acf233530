"""`Slam.run_pose_graph_optimization` of the PyTorch port against the JAX
package's, on the CPU: 10 synthetic sweeps with undistortion NONE,
optimized against GPS from the ground truth by both backends (the numpy
solver on the host and the float64 torch solver on the Slam's device), the
maps rebuilt from the keypoint log; then a stream after the PGO against
JAX's stream after the same PGO. The same drive rendered with motion
distortion under REFINED undistortion is tests/test_torch_pgo_refined.py,
the runtime commands and the output subscription
tests/test_torch_commands.py. Both packages take their numpy ingest (ROADMAP
Queue 3, F5)."""

import copy
import dataclasses

import numpy as np
import pytest

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import UndistortionMode as JUndistortion
from lidarslam_tpu.io import native
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.core import se3 as tse3
from lidarslam_tpu_torch.io import native as tnative
from test_torch_slam import _one_torch_thread, _pose_err, _torch_config  # noqa: F401
from test_torch_stream import _jcfg

N_FRAMES = 10            # sweeps through add_frame before the PGO
N_STREAM = 4             # sweeps streamed after it
CI_M, CI_DEG = 0.01, 5.0   # the reference CI's per-pose tolerance
BACKEND_M = 1e-5         # the port's two backends against each other
BACKENDS = ("host", "device")


@pytest.fixture(autouse=True, scope="module")
def _numpy_ingest():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        yield


def gps_from_ground_truth(frames):
    """GPS positions of each sweep's ground truth, relative to frame 0, and
    their stamps."""
    gt0 = tse3.hmat_inverse(frames[0]["gt_pose"])
    return (np.stack([(gt0 @ f["gt_pose"])[:3, 3] for f in frames]),
            np.array([f["stamp"] for f in frames]))


def _pgo(slam, frames, backend):
    """Both backends from the same logged run: the log is restored before
    each (the PGO rewrites its poses)."""
    log = copy.deepcopy(slam.log_trajectory)
    out = {}
    for b in backend:
        slam.log_trajectory = copy.deepcopy(log)
        assert slam.run_pose_graph_optimization(*gps_from_ground_truth(frames[:N_FRAMES]),
                                                use_device_backend=b == "device")
        out[b] = {"poses": [e["pose"].copy() for e in slam.log_trajectory],
                  "valid": {int(k): len(slam.get_map_points(k)[0])
                            for k in slam.cfg.used_types},
                  "Tworld": slam.Tworld.copy(), "Trelative": slam.Trelative.copy(),
                  "kf_last_pose": slam.kf_last_pose.copy(),
                  "map_origin": slam.map_origin.copy()}
    return out


def pgo_runs(mode):
    """Both packages over the drive in `mode` (an UndistortionMode name),
    each PGO backend from the same log; on the NONE drive a stream of
    N_STREAM sweeps after the device backend's PGO."""
    frames = jsyn.generate_sequence(n_frames=N_FRAMES + N_STREAM,
                                    motion_distortion=mode != "NONE",
                                    sensor=jsyn.SensorModel(range_noise=0.005))
    jcfg = dataclasses.replace(_jcfg(), undistortion=JUndistortion[mode])
    out = {"frames": frames, "mode": mode}
    for name, slam in (("jax", JSlam(jcfg)), ("torch", TSlam(_torch_config(jcfg),
                                                              device="cpu"))):
        out[name + "_sync"] = [slam.add_frame(f) for f in frames[:N_FRAMES]]
        out[name] = _pgo(slam, frames, BACKENDS)
        if mode == "NONE":      # a stream continues from the device backend's PGO
            for f in frames[N_FRAMES:]:
                assert slam.add_frame_async(f) >= 0
            out[name + "_stream"] = slam.flush()
    return out


@pytest.fixture(scope="module")
def runs():
    return pgo_runs("NONE")


def check_pgo_matches_jax(runs, backend):
    """Each optimized pose within 0.01 m / 5 deg of JAX's on the same
    backend; the rebuilt maps' valid points within 1% of JAX's; the pose
    state set from the optimized trajectory as JAX sets it."""
    t, j = runs["torch"][backend], runs["jax"][backend]
    assert len(t["poses"]) == len(j["poses"]) == N_FRAMES
    for i, (a, b) in enumerate(zip(t["poses"], j["poses"])):
        dt, dr = _pose_err(a, b)
        assert dt < CI_M and dr < CI_DEG, (i, dt, dr)
    np.testing.assert_allclose(t["poses"][0], np.eye(4), atol=1e-12)   # re-anchored
    assert t["valid"].keys() == j["valid"].keys()
    for k, n in j["valid"].items():
        assert n > 200 and abs(t["valid"][k] - n) <= 0.01 * n, (k, t["valid"][k], n)
    np.testing.assert_array_equal(t["Tworld"], t["poses"][-1])
    np.testing.assert_array_equal(t["kf_last_pose"], t["poses"][-1])
    np.testing.assert_allclose(t["Trelative"],
                               tse3.hmat_inverse(t["poses"][-2]) @ t["poses"][-1], atol=1e-12)
    np.testing.assert_allclose(t["map_origin"], j["map_origin"], atol=1e-9)


def check_backends_agree_and_track_ground_truth(runs):
    """The port's host and device backends within 1e-5 m of each other; the
    optimized trajectory within 0.05 m of the ground truth (the bound of
    tests/test_posegraph.py::test_slam_pgo_end_to_end)."""
    host, dev = runs["torch"]["host"], runs["torch"]["device"]
    for a, b in zip(host["poses"], dev["poses"]):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() < BACKEND_M
        assert np.abs(a[:3, :3] - b[:3, :3]).max() < BACKEND_M
    gt, _ = gps_from_ground_truth(runs["frames"][:N_FRAMES])
    err = max(np.linalg.norm(p[:3, 3] - g) for p, g in zip(dev["poses"], gt))
    assert err < 0.05, err


@pytest.mark.parametrize("backend", BACKENDS)
def test_pgo_matches_jax(runs, backend):
    check_pgo_matches_jax(runs, backend)


def test_pgo_backends_agree_and_track_ground_truth(runs):
    check_backends_agree_and_track_ground_truth(runs)


def test_stream_after_pgo_matches_jax(runs):
    """After the PGO replaced the maps, a stream segment seeded from them
    tracks like JAX's stream after the same PGO: 0.01 m / 5 deg, n_matches
    within 1%, no failure."""
    t, j = runs["torch_stream"], runs["jax_stream"]
    assert len(t) == len(j) == N_STREAM
    for i, (a, b) in enumerate(zip(t, j)):
        dt, dr = _pose_err(a["pose"], b["pose"])
        assert dt < CI_M and dr < CI_DEG, (i, dt, dr)
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * b["n_matches"], i
        assert a["failure"] == b["failure"] is False


def test_pgo_refuses_without_a_keypoint_log():
    """PGO needs two logged poses and the keypoint log (logging_timeout != 0),
    as in the JAX package."""
    cfg = _torch_config(dataclasses.replace(_jcfg(), logging_timeout=0.0))
    slam = TSlam(cfg, device="cpu")
    assert not slam.run_pose_graph_optimization(np.zeros((2, 3)), np.zeros(2))
    slam.log_trajectory = [{"time": float(i), "pose": np.eye(4),
                            "covariance": np.zeros((6, 6))} for i in range(3)]
    assert not slam.run_pose_graph_optimization(np.zeros((3, 3)), np.arange(3.0))
