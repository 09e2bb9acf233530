"""The port's aggregated-cloud and trajectory export (io/export.py, io/vtp.py's
trajectory writer) against the JAX package's, after the same 6 synthetic
sweeps of tests/test_export.py through each package's `Slam.add_frame`
(both on the numpy ingest, ROADMAP Queue 3, F5). Extraction agrees exactly
(F3), so the aggregates hold the same points in the same order; the poses
differ by float rounding (F3 / F4), so points and positions are held to
1e-4 m."""

import dataclasses

import numpy as np
import pytest

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import ExtractorConfig, LoggingStorage, MapConfig, SlamConfig
from lidarslam_tpu.io import export as jexport
from lidarslam_tpu.io import native, synthetic
from lidarslam_tpu.io import vtp as jvtp
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.io import export as texport
from lidarslam_tpu_torch.io import native as tnative
from lidarslam_tpu_torch.io import pcd as tpcd
from lidarslam_tpu_torch.io import vtp as tvtp
from test_torch_slam import _one_torch_thread, _torch_config  # noqa: F401

TOL_M = 1e-4


def _cfg(**kw):
    return SlamConfig(
        extractor=ExtractorConfig(n_rings=16, max_ring_points=1024, max_keypoints=1024),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 15, grid_size=26),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX with its default (device) log; the port with its default log and
    with the DISK log."""
    log_dir = str(tmp_path_factory.mktemp("kplog"))
    frames = synthetic.generate_sequence(n_frames=6, motion_distortion=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        js = JSlam(_cfg())
        jouts = [js.add_frame(f) for f in frames]
        ts = TSlam(_torch_config(_cfg()), device="cpu")
        touts = [ts.add_frame(f) for f in frames]
        disk = TSlam(_torch_config(_cfg(logging_storage=LoggingStorage.DISK,
                                        logging_dir=log_dir)), device="cpu")
        for f in frames:
            disk.add_frame(f)
    return {"jax": js, "jouts": jouts, "port": ts, "touts": touts, "disk": disk,
            "log_dir": log_dir}


def _same_cloud(got, want, tol=TOL_M):
    assert len(got["xyz"]) == len(want["xyz"]) > 1000
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["frame_id"], want["frame_id"])
    np.testing.assert_array_equal(got["intensity"], want["intensity"])
    np.testing.assert_allclose(got["time"], want["time"], rtol=0, atol=1e-9)
    err = float(np.abs(got["xyz"].astype(np.float64) - want["xyz"]).max())
    assert err <= tol, err
    for k in want:
        assert got[k].dtype == want[k].dtype, k


def test_aggregate_logged_frames_matches_jax(runs):
    want = jexport.aggregate_logged_frames(runs["jax"])
    _same_cloud(texport.aggregate_logged_frames(runs["port"]), want)
    _same_cloud(texport.aggregate_logged_frames(runs["port"], types=[0]),
                jexport.aggregate_logged_frames(runs["jax"], types=[0]))
    # the DISK tier's log restores the same points
    _same_cloud(texport.aggregate_logged_frames(runs["disk"]), want)


def test_disk_log_aggregate_matches_jax(runs, tmp_path):
    """The offline aggregate of the port's DISK log and Trajectory.csv
    equals JAX's live aggregate; both packages' `aggregate_disk_log` on
    the same files give the same points, undistorted or not."""
    texport.write_trajectory_csv(tmp_path / "T.csv", runs["disk"])
    traj = texport.read_trajectory_csv(tmp_path / "T.csv")
    jtraj = jexport.read_trajectory_csv(tmp_path / "T.csv")
    for a, b in zip(traj, jtraj):
        assert a["time"] == b["time"]
        np.testing.assert_array_equal(a["pose"], b["pose"])
        np.testing.assert_array_equal(a["covariance"], b["covariance"])
    off = texport.aggregate_disk_log(runs["log_dir"], traj, undistort=False)
    _same_cloud(off, jexport.aggregate_logged_frames(runs["jax"]))
    for undistort in (False, True):
        for types in (None, ["plane"]):
            got = texport.aggregate_disk_log(runs["log_dir"], traj, types=types,
                                             undistort=undistort)
            want = jexport.aggregate_disk_log(runs["log_dir"], jtraj, types=types,
                                              undistort=undistort)
            _same_cloud(got, want, tol=1e-12)
    with pytest.raises(ValueError, match="no kp_"):
        texport.aggregate_disk_log(str(tmp_path), traj)


def test_undistort_between_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 10, (200, 3))
    t_rel = rng.uniform(-0.1, 0.0, 200)
    H0 = np.eye(4)
    from lidarslam_tpu.core import se3 as jse3
    H1 = jse3.pose_to_hmat([1.0, 0.2, -0.1, 0.02, -0.01, 0.3])
    for t0, t1, b in ((0.0, 0.1, H1), (0.0, 0.1, H0), (0.1, 0.1, H1)):
        np.testing.assert_allclose(texport.undistort_between(pts, t_rel, t0, H0, t1, b),
                                   jexport.undistort_between(pts, t_rel, t0, H0, t1, b),
                                   rtol=0, atol=1e-12)


def _csv(path):
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = np.array([[float(v) for v in line.split(",")] for line in f])
    return header, rows


def test_trajectory_csv_and_ply_match_jax(runs, tmp_path):
    """The same columns; time, position, quaternion, rotation vector (axis
    times angle: the axis of a near-zero rotation is ill-conditioned) and
    the scalar extras within 1e-4 (the measured `duration` aside); the
    PLY's header and vertex positions, times and position variances."""
    texport.write_trajectory_csv(tmp_path / "t.csv", runs["port"], extras=runs["touts"])
    jexport.write_trajectory_csv(tmp_path / "j.csv", runs["jax"], extras=runs["jouts"])
    th, tr = _csv(tmp_path / "t.csv")
    jh, jr = _csv(tmp_path / "j.csv")
    assert th == jh and tr.shape == jr.shape == (6, len(jh))
    for c in ("overlap", "n_matches", "failure", "comply_motion_limits"):
        assert c in th
    cols = [i for i, c in enumerate(th)
            if not c.startswith(("cov", "axis_")) and c != "duration"]
    np.testing.assert_allclose(tr[:, cols], jr[:, cols], rtol=0, atol=TOL_M)
    axis = [th.index(f"axis_{c}") for c in "xyz"]
    angle = th.index("angle")
    np.testing.assert_allclose(tr[:, axis] * tr[:, [angle]], jr[:, axis] * jr[:, [angle]],
                               rtol=0, atol=TOL_M)
    # the covariance: a float32 pseudo-inverse in the port (ROADMAP D2),
    # at slightly different poses: held to 1e-4 of each entry or 1e-5 of
    # the largest
    cov = [i for i, c in enumerate(th) if c.startswith("cov")]
    np.testing.assert_allclose(tr[:, cov], jr[:, cov], rtol=1e-4,
                               atol=1e-5 * np.abs(jr[:, cov]).max())
    assert texport.save_trajectory_ply(tmp_path / "t.ply", runs["port"]) == \
        jexport.save_trajectory_ply(tmp_path / "j.ply", runs["jax"]) == 6
    tl = (tmp_path / "t.ply").read_text().splitlines()
    jl = (tmp_path / "j.ply").read_text().splitlines()
    end = jl.index("end_header")
    assert tl[:end + 1] == jl[:end + 1] and tl[end + 7:] == jl[end + 7:]
    tv = np.array([[float(v) for v in line.split()] for line in tl[end + 1:end + 7]])
    jv = np.array([[float(v) for v in line.split()] for line in jl[end + 1:end + 7]])
    np.testing.assert_allclose(tv[:, :4], jv[:, :4], rtol=0, atol=TOL_M)
    np.testing.assert_allclose(tv[:, 4], jv[:, 4], rtol=1e-4, atol=1e-5 * jv[:, 4].max())


def test_aggregated_pcd_and_trajectory_vtp_match_jax(runs, tmp_path):
    n = texport.save_aggregated_pcd(tmp_path / "t.pcd", runs["port"])
    assert n == jexport.save_aggregated_pcd(tmp_path / "j.pcd", runs["jax"])
    got, want = tpcd.load_pcd(tmp_path / "t.pcd"), tpcd.load_pcd(tmp_path / "j.pcd")
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["xyz"], want["xyz"], rtol=0, atol=TOL_M)
    np.testing.assert_array_equal(got["label"], want["label"])
    tvtp.write_trajectory_vtp(str(tmp_path / "t.vtp"), runs["port"])
    jvtp.write_trajectory_vtp(str(tmp_path / "j.vtp"), runs["jax"])
    tp, td, tc = tvtp.read_vtp(str(tmp_path / "t.vtp"))
    jp, jd, jc = jvtp.read_vtp(str(tmp_path / "j.vtp"))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL_M)
    assert td.keys() == jd.keys()
    for k in ("time", "quaternion_wxyz"):
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=TOL_M)
    np.testing.assert_allclose(td["axis_angle"][:, :3] * td["axis_angle"][:, 3:],
                               jd["axis_angle"][:, :3] * jd["axis_angle"][:, 3:],
                               rtol=0, atol=TOL_M)
    np.testing.assert_array_equal(tc["lines"][0], jc["lines"][0])
    arrays = texport.trajectory_arrays(runs["port"], extras=runs["touts"][2:])
    assert np.isnan(arrays["n_matches"][:2]).all()
    np.testing.assert_array_equal(arrays["n_matches"][2:],
                                  [r["n_matches"] for r in runs["touts"][2:]])
    assert dataclasses.is_dataclass(runs["port"].cfg)
