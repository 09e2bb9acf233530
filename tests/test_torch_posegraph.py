"""The pose-graph back end of the PyTorch port against the JAX package's, on
the CPU: the numpy and batched-torch SE(3) helpers, the trajectory
registration, the numpy PGO (drift, the no-GPS gauge) and its g2o dump, both
block-tridiagonal solvers on the JAX tests' own cases, the device PGO (with
and without GPS, Schur against the loop, two GPS fixes on one vertex) and
the ATE / RPE metrics."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lidarslam_tpu import evaluation as jeval
from lidarslam_tpu.backend import posegraph as jpg
from lidarslam_tpu.backend import posegraph_device as jpd
from lidarslam_tpu.backend import registration as jreg
from lidarslam_tpu.core import se3 as jse3
from lidarslam_tpu_torch import evaluation as teval
from lidarslam_tpu_torch.backend import posegraph as tpg
from lidarslam_tpu_torch.backend import posegraph_device as tpd
from lidarslam_tpu_torch.backend import registration as treg
from lidarslam_tpu_torch.core import se3 as tse3
from test_posegraph_device import _dense, _make_graph, _random_spd_tridiag
from test_torch_slam import _one_torch_thread  # noqa: F401

SOLVE_TOL = 1e-8         # the solvers against the dense solve
PGO_TOL = 1e-5           # the device and numpy PGO against JAX's


def _hmats(n, rng, scale_rot=0.8, scale_t=2.0):
    out = []
    for _ in range(n):
        H = np.eye(4)
        H[:3, :3] = jse3.so3_exp(rng.normal(0, scale_rot, 3))
        H[:3, 3] = rng.normal(0, scale_t, 3)
        out.append(H)
    return np.stack(out)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
#   SE(3) helpers
# ---------------------------------------------------------------------------

def test_numpy_se3_helpers_equal_jax():
    """hat, so3/se3 log and exp, adjoint, rpy and quaternion conversions and
    interpolate_rt: the port's numpy float64 helpers against JAX's."""
    rng = np.random.default_rng(0)
    Hs = _hmats(16, rng)
    for H in Hs:
        xi = jse3.se3_log(H)
        np.testing.assert_allclose(tse3.se3_log(H), xi, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tse3.se3_exp(xi), jse3.se3_exp(xi), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tse3.so3_log(H[:3, :3]), jse3.so3_log(H[:3, :3]),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(tse3.so3_exp(xi[3:]), jse3.so3_exp(xi[3:]),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(tse3.hat(xi[:3]), jse3.hat(xi[:3]))
        np.testing.assert_allclose(tse3.adjoint(H), jse3.adjoint(H), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tse3.matrix_to_rpy(H[:3, :3]), jse3.matrix_to_rpy(H[:3, :3]),
                                   rtol=0, atol=1e-12)
        rpy = jse3.matrix_to_rpy(H[:3, :3])
        np.testing.assert_allclose(tse3.rpy_to_matrix(rpy), jse3.rpy_to_matrix(rpy),
                                   rtol=0, atol=1e-12)
        q = jse3.quat_from_matrix(H[:3, :3])
        np.testing.assert_allclose(tse3.quat_from_matrix(H[:3, :3]), q, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tse3.quat_to_matrix(q), jse3.quat_to_matrix(q),
                                   rtol=0, atol=1e-12)
    # the near-pi and near-zero branches of so3_log
    axis = np.array([0.6, -0.64, 0.48])
    for theta in (1e-10, np.pi - 1e-7):
        R = jse3.so3_exp(theta * axis / np.linalg.norm(axis))
        np.testing.assert_allclose(tse3.so3_log(R), jse3.so3_log(R), rtol=0, atol=1e-12)
    # per-point interpolation (the PGO replay's undistortion)
    t = np.linspace(-0.1, 0.0, 7) + 1.0
    R, tv = tse3.interpolate_rt(Hs[0][:3, :3], Hs[0][:3, 3], Hs[1][:3, :3], Hs[1][:3, 3],
                                t, 0.9, 1.0)
    Rj, tj = jse3._interpolate_rt(np, Hs[0][:3, :3], Hs[0][:3, 3], Hs[1][:3, :3],
                                  Hs[1][:3, 3], t, 0.9, 1.0)
    np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tv, tj, rtol=0, atol=1e-12)


def test_batched_torch_se3_helpers_match_jax():
    """jhat, jso3_log/exp, jse3_log/exp, jhmat_inverse and jadjoint in float64
    against JAX's batched helpers under x64, on 32 random isometries."""
    Hs = _hmats(32, np.random.default_rng(1))
    tH = torch.from_numpy(Hs)
    with jax.enable_x64(True):
        jH = jnp.asarray(Hs)
        logs = np.array(jse3.jse3_log(jH))
        want = {"log": logs, "exp": np.asarray(jse3.jse3_exp(jnp.asarray(logs))),
                "inv": np.asarray(jse3.jhmat_inverse(jH)),
                "adj": np.asarray(jse3.jadjoint(jH)),
                "hat": np.asarray(jse3.jhat(jH[:, :3, 3])),
                "so3_log": np.asarray(jse3.jso3_log(jH[:, :3, :3])),
                "so3_exp": np.asarray(jse3.jso3_exp(jnp.asarray(logs[:, 3:])))}
    got = {"log": tse3.jse3_log(tH), "exp": tse3.jse3_exp(torch.from_numpy(logs)),
           "inv": tse3.jhmat_inverse(tH), "adj": tse3.jadjoint(tH),
           "hat": tse3.jhat(tH[:, :3, 3]), "so3_log": tse3.jso3_log(tH[:, :3, :3]),
           "so3_exp": tse3.jso3_exp(torch.from_numpy(logs[:, 3:]))}
    for k, v in got.items():
        assert v.dtype == torch.float64, k
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)
    for i, H in enumerate(Hs):
        np.testing.assert_allclose(got["log"][i].numpy(), tse3.se3_log(H), atol=1e-9)


@pytest.mark.parametrize("theta", [1e-9, 1e-6, 0.5, 2.0, np.pi - 0.01])
def test_jso3_log_small_and_large_angles(theta):
    """tests/test_posegraph_device.py's angles, near 0 and near pi: the
    rotation vector within 1e-6, and equal to JAX's within 1e-12."""
    axis = np.array([0.6, -0.64, 0.48])
    axis /= np.linalg.norm(axis)
    R = tse3.so3_exp(theta * axis)
    w = tse3.jso3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(w, theta * axis, atol=1e-6)
    with jax.enable_x64(True):
        np.testing.assert_allclose(w, np.asarray(jse3.jso3_log(jnp.asarray(R))), rtol=0,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
#   Registration, numpy PGO, g2o
# ---------------------------------------------------------------------------

def test_registration_matches_jax():
    """compute_transform_offset (with and without no_roll) on
    tests/test_posegraph.py's trajectory."""
    rng = np.random.default_rng(2)
    t = np.linspace(0, 10, 60)
    traj = np.stack([t, np.sin(t * 0.5) * 3, 0.05 * t], axis=1)
    T_true = jse3.pose_to_hmat([4.0, -2.0, 0.5, 0.02, -0.01, 0.8])
    moved = traj @ T_true[:3, :3].T + T_true[:3, 3] + rng.normal(0, 0.01, traj.shape)
    for no_roll in (False, True):
        got = treg.compute_transform_offset(traj, moved, no_roll=no_roll)
        want = jreg.compute_transform_offset(traj, moved, no_roll=no_roll)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(treg.compute_transform_offset(traj, moved), T_true, atol=0.05)


def _drift_case():
    """tests/test_posegraph.py::test_pose_graph_corrects_drift's graph."""
    rng = np.random.default_rng(3)
    N = 60
    gt = [jse3.pose_to_hmat([10 * np.sin(i * 0.05), 10 * (1 - np.cos(i * 0.05)), 0, 0, 0,
                             i * 0.05]) for i in range(N)]
    times = np.arange(N) * 0.5
    drift = jse3.pose_to_hmat([0.02, 0.005, 0, 0, 0, 0.002])
    odo = [gt[0]]
    for i in range(1, N):
        odo.append(odo[-1] @ jse3.hmat_inverse(gt[i - 1]) @ gt[i] @ drift)
    covs = [np.eye(6) * 1e-3 for _ in range(N)]
    idx = np.arange(0, N, 5)
    gps = np.stack([gt[i][:3, 3] for i in idx]) + rng.normal(0, 0.02, (len(idx), 3))
    return odo, times, covs, dict(gps_positions=gps, gps_times=times[idx],
                                  gps_covariances=np.broadcast_to(np.eye(3) * 1e-4,
                                                                  (len(idx), 3, 3))), gt


def test_numpy_pgo_matches_jax():
    """optimize_pose_graph on the drifting arc with GPS and on the no-GPS
    gauge chain: poses within PGO_TOL of JAX's, the same cost; the drift
    corrected as tests/test_posegraph.py asks."""
    odo, times, covs, gps, gt = _drift_case()
    got, c_got = tpg.optimize_pose_graph(odo, times, covs, **gps)
    want, c_want = jpg.optimize_pose_graph(odo, times, covs, **gps)
    assert _max_diff(got, want) < PGO_TOL
    assert c_got == pytest.approx(c_want, rel=1e-9)
    assert max(np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(got, gt)) < 0.12
    poses = [jse3.pose_to_hmat([i * 0.5, 0, 0, 0, 0, 0]) for i in range(10)]
    covs = [np.eye(6) * 1e-3] * 10
    got, _ = tpg.optimize_pose_graph(poses, np.arange(10.0), covs)
    want, _ = jpg.optimize_pose_graph(poses, np.arange(10.0), covs)
    assert _max_diff(got, want) < PGO_TOL
    np.testing.assert_allclose(got[0], poses[0], atol=1e-4)


def test_save_g2o_text_equal_to_jax(tmp_path):
    """The g2o dump of tests/test_posegraph_device.py's 10-pose graph with
    its GPS priors and a GPS<->sensor offset: the same text."""
    noisy, times, covs, gps_p, gps_t, _ = _make_graph(10)
    vertex = [int(np.argmin(np.abs(times - t))) for t in gps_t]
    kw = dict(rel_information=[np.linalg.inv(c) for c in covs[1:]], gps_positions=gps_p,
              gps_vertex=vertex, gps_information=[np.eye(3) * 100.0] * len(gps_p),
              gps_to_sensor_offset=jse3.pose_to_hmat([0.1, 0.0, 0.5, 0.0, 0.0, 0.1]))
    tpg.save_g2o(str(tmp_path / "t.g2o"), noisy, times, **kw)
    jpg.save_g2o(str(tmp_path / "j.g2o"), noisy, times, **kw)
    text = (tmp_path / "t.g2o").read_text()
    assert text == (tmp_path / "j.g2o").read_text()
    assert text.count("VERTEX_SE3:QUAT") == 10 and text.count("EDGE_SE3_TRACKXYZ") == 2


# ---------------------------------------------------------------------------
#   Block-tridiagonal solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 40])
def test_scan_solve_matches_dense_and_jax(n):
    D, U = _random_spd_tridiag(n, rng=np.random.default_rng(10 + n))
    rhs = np.random.default_rng(n).normal(0, 1, (n, 6))
    x = tpd.solve_block_tridiag_scan(torch.from_numpy(D), torch.from_numpy(U),
                                     torch.from_numpy(rhs)).numpy()
    ref = np.linalg.solve(_dense(D, U), rhs.ravel()).reshape(n, 6)
    np.testing.assert_allclose(x, ref, rtol=0, atol=SOLVE_TOL)
    with jax.enable_x64(True):
        j = np.asarray(jpd.solve_block_tridiag_scan(jnp.asarray(D), jnp.asarray(U),
                                                     jnp.asarray(rhs)))
    np.testing.assert_allclose(x, j, rtol=0, atol=SOLVE_TOL)


@pytest.mark.parametrize("n,s", [(7, 2), (40, 4), (41, 4), (64, 8), (9, 3)])
def test_schur_solve_matches_dense_and_jax(n, s):
    D, U = _random_spd_tridiag(n, rng=np.random.default_rng(100 + n))
    rhs = np.random.default_rng(s).normal(0, 1, (n, 6))
    x = tpd.solve_block_tridiag_schur(torch.from_numpy(D), torch.from_numpy(U),
                                      torch.from_numpy(rhs), s).numpy()
    ref = np.linalg.solve(_dense(D, U), rhs.ravel()).reshape(n, 6)
    np.testing.assert_allclose(x, ref, rtol=0, atol=SOLVE_TOL)
    with jax.enable_x64(True):
        j = np.asarray(jpd.solve_block_tridiag_schur(jnp.asarray(D), jnp.asarray(U),
                                                      jnp.asarray(rhs), s))
    np.testing.assert_allclose(x, j, rtol=0, atol=SOLVE_TOL)


def test_scan_solve_batches_independent_systems():
    """Leading dimensions are independent systems (the Schur interiors),
    with several right-hand sides each."""
    rng = np.random.default_rng(5)
    systems = [_random_spd_tridiag(9, rng=rng) for _ in range(3)]
    rhs = rng.normal(0, 1, (3, 9, 6, 4))
    x = tpd.solve_block_tridiag_scan(torch.from_numpy(np.stack([d for d, _ in systems])),
                                     torch.from_numpy(np.stack([u for _, u in systems])),
                                     torch.from_numpy(rhs)).numpy()
    for (D, U), r, got in zip(systems, rhs, x):
        ref = np.linalg.solve(_dense(D, U), r.reshape(54, 4)).reshape(9, 6, 4)
        np.testing.assert_allclose(got, ref, rtol=0, atol=SOLVE_TOL)


# ---------------------------------------------------------------------------
#   Device PGO
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph50():
    return _make_graph(50)


@pytest.mark.parametrize("segments", [0, 4])
def test_device_pgo_matches_jax_and_numpy(graph50, segments):
    """optimize_pose_graph_device with GPS (the loop, and Schur over 4
    segments) on the 50-pose graph: poses within PGO_TOL of JAX's device
    PGO and of the numpy oracle, the same cost, and near ground truth."""
    noisy, times, covs, gps_p, gps_t, gt = graph50
    kw = dict(gps_positions=gps_p, gps_times=gps_t, n_segments=segments)
    got, c_got = tpd.optimize_pose_graph_device(noisy, times, covs, **kw, device="cpu")
    want, c_want = jpd.optimize_pose_graph_device(noisy, times, covs, **kw)
    oracle, c_oracle = tpg.optimize_pose_graph(noisy, times, covs, gps_positions=gps_p,
                                               gps_times=gps_t)
    assert _max_diff(got, want) < PGO_TOL and _max_diff(got, oracle) < PGO_TOL
    assert c_got == pytest.approx(c_want, rel=1e-9) == pytest.approx(c_oracle, rel=1e-9)
    assert max(np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(got, gt)) < 0.15


def test_device_pgo_schur_matches_loop():
    noisy, times, covs, gps_p, gps_t, _ = _make_graph(47)
    a, _ = tpd.optimize_pose_graph_device(noisy, times, covs, gps_positions=gps_p,
                                          gps_times=gps_t, n_segments=0, device="cpu")
    b, _ = tpd.optimize_pose_graph_device(noisy, times, covs, gps_positions=gps_p,
                                          gps_times=gps_t, n_segments=4, device="cpu")
    assert _max_diff(a, b) < 1e-9


def test_device_pgo_no_gps_gauge_matches_jax():
    noisy, times, covs, _, _, _ = _make_graph(20)
    got, c_got = tpd.optimize_pose_graph_device(noisy, times, covs, device="cpu")
    want, c_want = jpd.optimize_pose_graph_device(noisy, times, covs)
    oracle, _ = tpg.optimize_pose_graph(noisy, times, covs)
    assert _max_diff(got, want) < PGO_TOL and _max_diff(got, oracle) < PGO_TOL
    assert c_got == pytest.approx(c_want, rel=1e-9)


def test_device_pgo_sums_gps_fixes_on_one_vertex():
    """GPS at 20 Hz on a 10 Hz graph: pairs of fixes share their nearest
    vertex, whose blocks must both be added (index_add_, as JAX's
    .at[].add). Against JAX and the numpy oracle within PGO_TOL, and apart
    from a graph that keeps one fix per vertex."""
    noisy, times, covs, _, _, gt = _make_graph(30)
    rng = np.random.default_rng(11)
    gps_t = np.arange(0, times[-1], 0.05)[:40]
    gt_xyz = np.stack([g[:3, 3] for g in gt])
    nearest = np.array([int(np.argmin(np.abs(times - t))) for t in gps_t])
    assert len(np.unique(nearest)) < len(nearest)          # repeats
    gps_p = gt_xyz[nearest] + rng.normal(0, 0.05, (len(gps_t), 3))
    kw = dict(gps_positions=gps_p, gps_times=gps_t)
    got, c_got = tpd.optimize_pose_graph_device(noisy, times, covs, **kw, device="cpu")
    want, c_want = jpd.optimize_pose_graph_device(noisy, times, covs, **kw)
    oracle, c_oracle = tpg.optimize_pose_graph(noisy, times, covs, **kw)
    assert _max_diff(got, want) < PGO_TOL and _max_diff(got, oracle) < PGO_TOL
    assert c_got == pytest.approx(c_want, rel=1e-9) == pytest.approx(c_oracle, rel=1e-9)
    # keeping one fix per repeated vertex (what indexed += would do) moves
    # the result well beyond the tolerance
    _, first = np.unique(nearest, return_index=True)
    one, _ = tpd.optimize_pose_graph_device(noisy, times, covs, gps_positions=gps_p[first],
                                            gps_times=gps_t[first], device="cpu")
    assert _max_diff(got, one) > 100 * PGO_TOL


def test_device_pgo_needs_a_device(monkeypatch):
    """Like Slam, the device PGO runs on the card unless the CPU is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    noisy, times, covs, *_ = _make_graph(5)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpd.optimize_pose_graph_device(noisy, times, covs)


# ---------------------------------------------------------------------------
#   Evaluation
# ---------------------------------------------------------------------------

def test_ate_and_rpe_equal_jax():
    """absolute_trajectory_error (aligned and not) and relative_pose_error
    at deltas 1 and 3, on a noisy drifting arc against its ground truth."""
    rng = np.random.default_rng(4)
    gt = [jse3.pose_to_hmat([10 * np.sin(i * 0.05), 10 * (1 - np.cos(i * 0.05)), 0.1 * i,
                             0, 0, i * 0.05]) for i in range(30)]
    drift = jse3.pose_to_hmat([0.02, 0, 0, 0, 0, 0.001])
    est = [gt[0]]
    for i in range(1, 30):
        est.append(est[-1] @ jse3.hmat_inverse(gt[i - 1]) @ gt[i] @ drift)
    est = [e @ jse3.pose_to_hmat(np.r_[rng.normal(0, 0.02, 3), 0, 0, 0]) for e in est]
    for align in (True, False):
        a = teval.absolute_trajectory_error(est, gt, align=align)
        b = jeval.absolute_trajectory_error(est, gt, align=align)
        assert a.n == b.n == 30
        np.testing.assert_allclose([a.rmse, a.mean, a.median, a.max],
                                   [b.rmse, b.mean, b.median, b.max], rtol=1e-12)
    for delta in (1, 3):
        for a, b in zip(teval.relative_pose_error(est, gt, delta),
                        jeval.relative_pose_error(est, gt, delta)):
            np.testing.assert_allclose([a.rmse, a.mean, a.median, a.max, a.n],
                                       [b.rmse, b.mean, b.median, b.max, b.n], rtol=1e-12)
    np.testing.assert_allclose(teval.align_trajectories([e[:3, 3] for e in est],
                                                        [g[:3, 3] for g in gt]),
                               jeval.align_trajectories([e[:3, 3] for e in est],
                                                        [g[:3, 3] for g in gt]), atol=1e-12)
