"""The state surface of the PyTorch port's `Slam` against the JAX package's,
on the CPU: checkpoints carried across both ways and round-tripped, PCD maps
and a relocalization in them, the pose getters and setters, and the debug
getters (`get_debug_array`, `extract_debug`, `get_registered_frame`,
`get_debug_information`). Both packages take their numpy ingest (ROADMAP
Queue 3, F5)."""

import dataclasses

import numpy as np
import pytest

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import MappingMode as JMappingMode
from lidarslam_tpu.io import native
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.core import se3 as tse3
from lidarslam_tpu_torch.io import native as tnative
from test_torch_slam import _one_torch_thread, _pose_err, _torch_config  # noqa: F401
from test_torch_stream import _jcfg

N_FRAMES = 8
CKPT_AT = 5              # checkpoint after this many frames
CI_M, CI_DEG = 0.01, 5.0   # the reference CI's per-pose tolerance
ROUNDTRIP_M = 5e-3       # tests/test_mapping_modes.py::test_checkpoint_roundtrip's
# ROADMAP Queue 3, F4: the weights 1 - sqrt(mse) / max_error carry the eigh6
# difference near repeated eigenvalues. Measured after the step below: all
# but 2 of 185 edge weights within 1e-4, those 2 at 2.86e-4.
WEIGHT_TOL, WEIGHT_TOL_ALL = 1e-4, 5e-4
# ROADMAP Queue 3, F3: FMA contraction. Scores within 6e-5, or within two
# float32 steps of the score where it is large (the squared depth gaps reach
# ~700 m^2, where one step is 6.1e-5).
SCORE_TOL, SCORE_RTOL = 6e-5, 2.5e-7


@pytest.fixture(autouse=True, scope="module")
def _numpy_ingest():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        yield


def _continue(slam, frames):
    return [slam.add_frame(f) for f in frames[CKPT_AT:]]


def _check_run(got, want, tol_m=CI_M):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        dt, dr = _pose_err(a["pose"], b["pose"])
        assert dt < tol_m and dr < CI_DEG, (i, dt, dr)
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * b["n_matches"], i
        assert a["failure"] == b["failure"] is False


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX and the port over N_FRAMES sweeps, each writing a checkpoint
    after CKPT_AT; each package then loads both checkpoints into a fresh
    Slam and continues, keeping the first continued step's debug surface."""
    d = tmp_path_factory.mktemp("state")
    frames = jsyn.generate_sequence(n_frames=N_FRAMES, motion_distortion=False,
                                    sensor=jsyn.SensorModel(range_noise=0.005))
    jcfg = _jcfg()
    out = {"frames": frames, "jcfg": jcfg, "cfg": _torch_config(jcfg), "dir": d}
    for name, slam in (("jax", JSlam(jcfg)), ("torch", TSlam(out["cfg"], device="cpu"))):
        res = []
        for i, f in enumerate(frames):
            if i == CKPT_AT:
                slam.save_checkpoint(str(d / f"{name}.npz"))
                slam.save_maps_to_pcd(str(d / f"{name}_"))
                if name == "torch":
                    out["torch_prev_keypoints"] = [
                        {f: t.numpy().copy() for f, t in zip(kp._fields, kp)}
                        for kp in slam._device_keypoints]
            res.append(slam.add_frame(f))
        out[name] = res
        out[name + "_slam"] = slam
    for src in ("jax", "torch"):
        for name, slam in (("jax", JSlam(jcfg)), ("torch", TSlam(out["cfg"], device="cpu"))):
            slam.load_checkpoint(str(d / f"{src}.npz"))
            if (name, src) == ("torch", "jax"):    # JAX's maps, saved by the port
                slam.save_maps_to_pcd(str(d / "torch_from_jax_"))
            loaded = {"n_frames": slam.n_frames, "Tworld": slam.get_world_transform(),
                      "prev_keypoints": slam._device_keypoints,
                      "Trelative": slam.Trelative.copy(),
                      "overflow": slam.map_overflow.copy(),
                      "traj": [p for _, p in slam.get_trajectory()],
                      "map_points": {k: slam.get_map_points(k)[0] for k in slam.cfg.used_types}}
            first = slam.add_frame(frames[CKPT_AT])
            out[f"{name}_from_{src}_debug"] = (slam.get_debug_array(),
                                               slam.get_debug_information(),
                                               slam.get_registered_frame(frames[CKPT_AT]))
            out[f"{name}_from_{src}"] = [first] + [slam.add_frame(f)
                                                   for f in frames[CKPT_AT + 1:]]
            out[f"{name}_from_{src}_loaded"] = loaded
    return out


def test_jax_checkpoint_continued_by_the_port(runs):
    """A checkpoint written by JAX, loaded by the port and continued, against
    JAX continued from it: 0.01 m / 5 deg, n_matches within 1%."""
    _check_run(runs["torch_from_jax"], runs["jax_from_jax"])


def test_port_checkpoint_loaded_by_jax(runs):
    """A checkpoint written by the port, loaded and continued by JAX, against
    JAX's own uninterrupted run, and against the port continuing it."""
    _check_run(runs["jax_from_torch"], runs["jax"][CKPT_AT:])
    _check_run(runs["torch_from_torch"], runs["jax_from_torch"])


def test_port_checkpoint_round_trip(runs):
    """The port's own checkpoint: the loaded state is the saved one (pose,
    Trelative, trajectory, maps, overflow tracker re-baselined, the previous
    sweep's keypoints, which only the port's file holds: ROADMAP D7) and
    the continuation stays within ROUNDTRIP_M of the uninterrupted run."""
    loaded = runs["torch_from_torch_loaded"]
    js = runs["jax_from_torch_loaded"]
    assert loaded["n_frames"] == js["n_frames"] == CKPT_AT
    ts = runs["torch_slam"]
    np.testing.assert_array_equal(loaded["Tworld"], ts.log_trajectory[CKPT_AT - 1]["pose"])
    np.testing.assert_array_equal(loaded["Trelative"], js["Trelative"])
    assert not np.allclose(loaded["Trelative"], np.eye(4))
    for a, b in zip(loaded["traj"], ts.log_trajectory[:CKPT_AT]):
        np.testing.assert_array_equal(a, b["pose"])
    np.testing.assert_array_equal(loaded["overflow"], js["overflow"])
    assert js["prev_keypoints"] is None
    assert runs["torch_from_jax_loaded"]["prev_keypoints"] is None
    for kp, want in zip(loaded["prev_keypoints"], runs["torch_prev_keypoints"]):
        for f, v in want.items():
            np.testing.assert_array_equal(getattr(kp, f).numpy(), v, err_msg=f)
    for k, pts in loaded["map_points"].items():
        assert len(pts) > 200
        np.testing.assert_array_equal(pts, js["map_points"][k])
    _check_run(runs["torch_from_torch"], runs["torch"][CKPT_AT:], tol_m=ROUNDTRIP_M)


def test_checkpoint_keys_and_capacity_check(runs, tmp_path):
    """The port writes JAX's keys, and the previous sweep's keypoints beside
    them (6 fields of 3 types); a checkpoint of other map capacities is
    refused."""
    d = runs["dir"]
    port, jax_keys = set(np.load(d / "torch.npz").files), set(np.load(d / "jax.npz").files)
    assert jax_keys < port
    assert sorted(port - jax_keys) == sorted(f"prev_keypoints{i}_{f}" for i in range(3)
                                             for f in ("xyz", "intensity", "time", "ring",
                                                       "valid", "count"))
    cfg = runs["cfg"]
    small = cfg.replace(plane_map=dataclasses.replace(cfg.plane_map, capacity=1 << 12))
    with pytest.raises(ValueError, match="capacity"):
        TSlam(small, device="cpu").load_checkpoint(str(d / "jax.npz"))


def test_pcd_maps_equal_jax(runs):
    """The maps at the checkpoint saved as PCD: JAX's maps (its checkpoint
    loaded by the port) saved by the port are JAX's files byte for byte; the
    port's own maps hold JAX's point counts within 1%; JAX's files loaded
    into a fresh Slam by each package (fixed under NONE) give the same
    valid points."""
    from lidarslam_tpu_torch.io import pcd as tpcd

    d = runs["dir"]
    for name in ("edge", "plane"):
        want = (d / f"jax_{name}s.pcd").read_bytes()
        assert (d / f"torch_from_jax_{name}s.pcd").read_bytes() == want
        a, b = tpcd.load_pcd(d / f"torch_{name}s.pcd"), tpcd.load_pcd(d / f"jax_{name}s.pcd")
        assert a.keys() == b.keys()
        assert abs(len(a["xyz"]) - len(b["xyz"])) <= 0.01 * len(b["xyz"])
    jcfg = runs["jcfg"].replace(mapping_mode=JMappingMode.NONE)
    js = JSlam(jcfg)
    js.load_maps_from_pcd(str(d / "jax_"))
    ts = TSlam(_torch_config(jcfg), device="cpu")
    ts.load_maps_from_pcd(str(d / "jax_"))
    assert ts._maps_populated and ts._cache_stale
    for k in ts.cfg.used_types:
        a = ts.get_map_points(k)
        b = js.get_map_points(k)
        assert len(a[0]) > 200 and a[3].all()           # fixed points
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_relocalization_in_pcd_maps(runs):
    """A localization-only Slam (MappingMode.NONE) loads JAX's PCD maps,
    takes the pose of the last saved frame as its guess and tracks the rest
    of the drive like JAX's: 0.01 m / 5 deg, n_matches within 1%, and the
    map untouched."""
    d, frames = runs["dir"], runs["frames"]
    jcfg = runs["jcfg"].replace(mapping_mode=JMappingMode.NONE)
    guess = runs["jax"][CKPT_AT - 1]["pose"]
    out = {}
    for name, slam in (("jax", JSlam(jcfg)), ("torch", TSlam(_torch_config(jcfg),
                                                              device="cpu"))):
        slam.load_maps_from_pcd(str(d / "jax_"))
        n0 = len(slam.get_map_points(slam.cfg.used_types[1])[0])
        slam.set_world_transform_from_guess(guess)
        out[name] = _continue(slam, frames)
        assert len(slam.get_map_points(slam.cfg.used_types[1])[0]) == n0
    _check_run(out["torch"], out["jax"])
    for r, want in zip(out["torch"], runs["jax"][CKPT_AT:]):
        assert _pose_err(r["pose"], want["pose"])[0] < 0.05


def test_pose_getters_and_setters(runs):
    """set_world_transform_from_guess sets both poses and drops the previous
    sweep's keypoints; get_latency_compensated_world_transform extrapolates
    the last two logged poses by the latency, as JAX's does on the same
    log, and returns the pose when the latency is too long."""
    js, ts = runs["jax_slam"], runs["torch_slam"]
    assert ts._device_keypoints is not None
    for latency in (0.0, 0.03, 0.5):
        js.latency = ts.latency = latency
        np.testing.assert_allclose(ts.get_latency_compensated_world_transform(),
                                   js.get_latency_compensated_world_transform(),
                                   atol=CI_M)
    ts.latency = 0.03
    dt = ts.log_trajectory[-1]["time"] - ts.log_trajectory[-2]["time"]
    want = tse3.interpolate_hmat(ts.log_trajectory[-2]["pose"], ts.log_trajectory[-1]["pose"],
                                 ts.log_trajectory[-1]["time"] + 0.03,
                                 ts.log_trajectory[-2]["time"], ts.log_trajectory[-1]["time"])
    np.testing.assert_array_equal(ts.get_latency_compensated_world_transform(), want)
    ts.latency = 10.0 * dt * ts.cfg.max_extrapolation_ratio
    np.testing.assert_array_equal(ts.get_latency_compensated_world_transform(), ts.Tworld)
    guess = tse3.pose_to_hmat([1.0, 2.0, 3.0, 0.0, 0.0, 0.5])
    fresh = TSlam(runs["cfg"], device="cpu")
    fresh._device_keypoints = ts._device_keypoints
    fresh.set_world_transform_from_guess(guess)
    np.testing.assert_array_equal(fresh.get_world_transform(), guess)
    np.testing.assert_array_equal(fresh.PreviousTworld, guess)
    assert fresh._device_keypoints is None
    np.testing.assert_array_equal(fresh.get_latency_compensated_world_transform(), guess)


def test_debug_array_matches_jax(runs):
    """get_debug_array after the first step from JAX's checkpoint: statuses
    equal, per used type and keypoint count; 98% of the weights within
    F4's 1e-4, every one within 5e-4."""
    got, _, _ = runs["torch_from_jax_debug"]
    want, _, _ = runs["jax_from_jax_debug"]
    assert sorted(got) == sorted(want) == ["edge_match_status", "edge_match_weight",
                                           "plane_match_status", "plane_match_weight"]
    for k in want:
        a, b = got[k], np.asarray(want[k])
        assert a.shape == b.shape and len(a) > 100, k
        if k.endswith("status"):
            np.testing.assert_array_equal(a, b)
        else:
            d = np.abs(a - b)
            assert d.max() < WEIGHT_TOL_ALL, (k, d.max())
            assert (d < WEIGHT_TOL).mean() >= 0.98, (k, (d >= WEIGHT_TOL).sum())
    assert (got["plane_match_status"] == 0).sum() > 100          # MatchStatus.SUCCESS
    assert TSlam(runs["cfg"], device="cpu").get_debug_array() == {}


def test_debug_information_and_registered_frame_match_jax(runs):
    """get_debug_information's keys and counters equal JAX's after the same
    step; get_registered_frame (the sweep in WORLD) within 0.01 m of JAX's."""
    _, tinfo, tframe_ = runs["torch_from_jax_debug"]
    _, jinfo, jframe_ = runs["jax_from_jax_debug"]
    assert tinfo.keys() == jinfo.keys()
    for k in ("map_overflow_edge", "map_overflow_plane", "map_overflow_blob", "failure",
              "comply_motion_limits"):
        assert tinfo[k] == jinfo[k], k
    for k in ("total_matched_keypoints", "edge_matches", "plane_matches"):
        assert abs(tinfo[k] - jinfo[k]) <= 0.01 * jinfo[k], k
    frame = runs["frames"][CKPT_AT]
    assert tframe_.shape == jframe_.shape == (len(frame["xyz"]), 3)
    assert tframe_.dtype == np.float32
    assert np.abs(tframe_ - jframe_).max() < CI_M


def test_extract_debug_matches_jax(runs):
    """extract_debug's per-point grids on the last sweep: the score grids
    within F3's 6e-5 (two float32 steps where a score is large), the label
    grids equal."""
    js, ts = runs["jax_slam"], runs["torch_slam"]
    f = runs["frames"][-1]
    got, want = ts.extract_debug(f), js.extract_debug(f)
    assert sorted(got) == sorted(want)
    for k, b in want.items():
        a = got[k]
        assert a.shape == b.shape == (16, 1024), k
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=SCORE_RTOL, atol=SCORE_TOL, err_msg=k)
    assert got["plane_keypoint"].sum() > 100
