"""The slice end to end: `Slam.add_frame` of the PyTorch port against the JAX
package on the same synthetic sequence, and a JAX run's state continued by
the port."""

import dataclasses

import numpy as np
import pytest
import torch

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import MatchingConfig as JMatching
from lidarslam_tpu.io import native
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch import config as tcfg
from lidarslam_tpu_torch.core import se3
from test_slam_e2e import small_config

N_FRAMES = 8
STATE_AFTER = 5
# the reference CI's per-pose tolerance (io/csv_log.py: 0.01 m / 5 deg)
CI_M, CI_DEG = 0.01, 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool per process as wide as the machine oversubscribes its
    cores (the small eager ops here gain nothing from threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_config(jcfg):
    """The same SlamConfig, rebuilt from the port's config classes."""
    def conv(obj):
        if dataclasses.is_dataclass(obj):
            cls = getattr(tcfg, type(obj).__name__)
            return cls(**{f.name: conv(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)})
        if isinstance(obj, tuple):
            return tuple(conv(x) for x in obj)
        if hasattr(obj, "name") and hasattr(tcfg, type(obj).__name__):
            return getattr(tcfg, type(obj).__name__)[obj.name]
        return obj
    return conv(jcfg)


def _pose_err(a, b):
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    dR = b[:3, :3].T @ a[:3, :3]
    return dt, float(np.rad2deg(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))


def _jax_state(js):
    """A JAX Slam's state as numpy arrays (state.py's format), copied out
    before the next step donates the device buffers."""
    def arr(x):
        return np.array(x, copy=True)
    return dict(
        maps={int(k): {f: arr(getattr(m, f)) for f in m._fields}
              for k, m in js.maps.items()},
        map_origin=js.map_origin.copy(), Tworld=js.Tworld.copy(),
        PreviousTworld=js.PreviousTworld.copy(), kf_last_pose=js.kf_last_pose.copy(),
        kf_counter=js.kf_counter,
        trajectory_times=np.array([e["time"] for e in js.log_trajectory]),
        trajectory_poses=np.array([e["pose"] for e in js.log_trajectory]),
        azimuthal_resolution=js.azimuthal_resolution, last_stamp=js.last_stamp,
        prev_keypoints={i: {f: arr(getattr(kp, f)) for f in kp._fields}
                        for i, kp in enumerate(js._device_keypoints)},
        submap_selected={i: arr(c.selected) for i, c in enumerate(js._submap_cache)
                         if c is not None},
        cache_stale=bool(np.asarray(js._cache_stale)))


@pytest.fixture(scope="module")
def runs():
    frames = jsyn.generate_sequence(n_frames=N_FRAMES, motion_distortion=False,
                                    sensor=jsyn.SensorModel(range_noise=0.005))
    jcfg = small_config().replace(loc_matching=JMatching(reuse_knn=True))
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's numpy ingest: the port has no native ingest yet
        mp.setattr(native, "available", lambda: False)
        js = JSlam(jcfg)
        jres, state = [], None
        for i, f in enumerate(frames):
            jres.append(js.add_frame(f))
            if i == STATE_AFTER:
                state = _jax_state(js)
    ts = TSlam(_torch_config(jcfg), device="cpu")
    tres = [ts.add_frame(f) for f in frames]
    return frames, jres, tres, state, _torch_config(jcfg)


def test_torch_config_conversion_is_exact(runs):
    *_, cfg = runs
    want = dataclasses.asdict(small_config().replace(loc_matching=JMatching(reuse_knn=True)))
    assert dataclasses.asdict(cfg) == want


def test_poses_within_ci_tolerance_of_jax(runs):
    _, jres, tres, _, _ = runs
    errs = [_pose_err(t["pose"], j["pose"]) for t, j in zip(tres, jres)]
    dt, dr = max(e[0] for e in errs), max(e[1] for e in errs)
    assert dt < CI_M and dr < CI_DEG, errs


def test_failure_flags_equal(runs):
    _, jres, tres, _, _ = runs
    assert [t["failure"] for t in tres] == [j["failure"] for j in jres]
    assert not any(t["failure"] for t in tres)


def test_n_matches_within_one_percent(runs):
    _, jres, tres, _, _ = runs
    for i, (t, j) in enumerate(zip(tres, jres)):
        assert abs(t["n_matches"] - j["n_matches"]) <= 0.01 * j["n_matches"], i
    assert min(t["n_matches"] for t in tres[1:]) > 100


def test_port_tracks_ground_truth(runs):
    """The bounds of tests/test_slam_e2e.py, on the port alone."""
    frames, _, tres, _, _ = runs
    gt0 = frames[0]["gt_pose"]
    for f, t in zip(frames, tres):
        dt, dr = _pose_err(t["pose"], se3.hmat_inverse(gt0) @ f["gt_pose"])
        assert dt < 0.07 and dr < 0.8


def test_state_carry_steps_like_jax(runs):
    """JAX state after frame 5 loaded into the port; frame 6 stepped by both."""
    frames, jres, _, state, cfg = runs
    ts = TSlam(cfg, device="cpu")
    ts.load_numpy_state(state)
    r = ts.add_frame(frames[STATE_AFTER + 1])
    dt, dr = _pose_err(r["pose"], jres[STATE_AFTER + 1]["pose"])
    assert dt < 5e-4 and dr < 0.01, (dt, dr)
    assert r["n_matches"] == pytest.approx(jres[STATE_AFTER + 1]["n_matches"], rel=0.01)
    assert len(ts.get_trajectory()) == STATE_AFTER + 2


def test_map_points_and_getters(runs):
    *_, cfg = runs
    frames = runs[0]
    ts = TSlam(cfg, device="cpu")
    for f in frames[:3]:
        ts.add_frame(f)
    for k in (tcfg.Keypoint.EDGE, tcfg.Keypoint.PLANE):
        pts, inten, t, fixed = ts.get_map_points(k)
        assert len(pts) > 200 and np.isfinite(pts).all() and not fixed.any()
    assert ts.get_world_transform().shape == (4, 4)
    assert np.isfinite(ts.get_covariance()).all()
    assert ts.add_frame(frames[2]) == {"skipped": "duplicate stamp"}


def test_map_overflow_tracked_after_insert(runs, capsys):
    """Maps too small for one sweep: the tracker holds the count after each
    frame's insert (as the JAX package's does) and warns when it grows."""
    frames, *_ = runs
    jcfg = small_config().replace(
        edge_map=dataclasses.replace(small_config().edge_map, capacity=256),
        plane_map=dataclasses.replace(small_config().plane_map, capacity=256),
        verbosity=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        js = JSlam(jcfg)
        js.add_frame(frames[0])
    ts = TSlam(_torch_config(jcfg), device="cpu")
    ts.add_frame(frames[0])
    assert ts.map_overflow[int(tcfg.Keypoint.PLANE)] > 0
    assert ts.map_overflow.tolist() == js.map_overflow.tolist()
    capsys.readouterr()
    for f in frames[1:3]:
        before = ts.map_overflow.copy()
        ts.add_frame(f)
        now = [int(ts.maps[k].overflow) if k in ts.maps else 0 for k in tcfg.Keypoint]
        assert ts.map_overflow.tolist() == now
        if (ts.map_overflow > before).any():
            assert "map dropped" in capsys.readouterr().out


def test_slam_needs_a_device():
    with pytest.raises(TypeError, match="device"):
        TSlam(tcfg.SlamConfig())
