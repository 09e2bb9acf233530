"""Port parity: matcher, robust LM and the ICP loop (PyTorch) against the
JAX package and the sequential numpy oracle (tests/oracle_localization.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_localization as oracle
from lidarslam_tpu.config import Keypoint as JKeypoint
from lidarslam_tpu.config import MatchingConfig as JMatching
from lidarslam_tpu.config import SolverConfig as JSolver
from lidarslam_tpu.ops import icp as jicp
from lidarslam_tpu.ops import matcher as jmatcher
from lidarslam_tpu.ops import solver as jsolver
from lidarslam_tpu.ops.voxel_map import SubmapView as JView
from lidarslam_tpu_torch.config import Keypoint as TKeypoint
from lidarslam_tpu_torch.config import MatchingConfig as TMatching
from lidarslam_tpu_torch.config import SolverConfig as TSolver
from lidarslam_tpu_torch.ops import icp as ticp
from lidarslam_tpu_torch.ops import matcher as tmatcher
from lidarslam_tpu_torch.ops import solver as tsolver
from lidarslam_tpu_torch.ops.voxel_map import SubmapView as TView
from test_oracle_localization import _scene

ATOL = 1e-5


def _jview(pts):
    return JView(xyz=jnp.asarray(pts, jnp.float32), ring=jnp.zeros(len(pts), jnp.int32),
                 valid=jnp.ones(len(pts), bool))


def _tview(pts):
    return TView(xyz=torch.from_numpy(np.asarray(pts, np.float32)), ring=None,
                 valid=torch.ones(len(pts), dtype=torch.bool))


def _kp(kp, q_dead=5):
    valid = np.ones(len(kp), bool)
    valid[:q_dead] = False
    return np.asarray(kp, np.float32), valid


@pytest.mark.parametrize("kind", ["edges", "planes"])
@pytest.mark.parametrize("reuse", [False, True])
def test_matchers_match_jax(kind, reuse):
    edge_map, plane_map, kp_e, kp_p = _scene(7)
    kp, valid = _kp(kp_e if kind == "edges" else kp_p)
    mp = edge_map if kind == "edges" else plane_map
    pose = np.array([0.03, -0.02, 0.01, 0.005, -0.004, 0.008], np.float32)
    jfn = jmatcher.match_edges if kind == "edges" else jmatcher.match_planes
    tfn = tmatcher.match_edges if kind == "edges" else tmatcher.match_planes
    jp, tp = JMatching(), TMatching()
    k = jp.edge_nb_neighbors if kind == "edges" else jp.plane_nb_neighbors
    jknn = tknn = None
    if reuse:   # neighbours cached at a nearby pose, distances re-posed
        pose0 = pose + np.float32(0.01)
        from lidarslam_tpu.core import se3 as jse3
        from lidarslam_tpu_torch.core import se3 as tse3
        _, jn, jr, jf = jmatcher.knn_query(_jview(mp), jse3.japply_pose(
            jnp.asarray(pose0), jnp.asarray(kp)), k, jp, None, jnp.asarray(valid))
        kind = TKeypoint.EDGE if kind == "edges" else TKeypoint.PLANE
        _, tn, tr, tf = tmatcher.knn_query(_tview(mp), tse3.japply_pose(
            torch.from_numpy(pose0), torch.from_numpy(kp)), k,
            tmatcher.knn_radius(kind, tp), torch.from_numpy(valid))
        jknn, tknn = (jn, jr, jf), (tn, tr, tf)
    mj = jfn(jnp.asarray(kp), jnp.asarray(valid), _jview(mp), jnp.asarray(pose), jp,
             None, knn=jknn)
    mt = tfn(torch.from_numpy(kp), torch.from_numpy(valid), _tview(mp),
             torch.from_numpy(pose), tp, knn=tknn)
    np.testing.assert_array_equal(mt.status.numpy(), np.asarray(mj.status))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert int(mt.n_matches) > 40
    for name in ("A6", "P", "weight"):
        np.testing.assert_allclose(getattr(mt, name).numpy(),
                                   np.asarray(getattr(mj, name)), atol=ATOL, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(
        tmatcher.rejection_histogram(mt).numpy(),
        np.asarray(jmatcher.rejection_histogram(mj)))


def _lm_problem():
    rng = np.random.default_rng(11)
    q = 120
    P = rng.normal(0, 5, (q, 3))
    normals = rng.normal(0, 1, (q, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    true_pose = np.array([0.05, -0.04, 0.03, 0.01, -0.02, 0.015])
    R, t = oracle.pose_to_rt(true_pose)
    X = (R.T @ (P - t).T).T + normals * rng.normal(0, 0.002, (q, 1))
    weights = rng.uniform(0.5, 1.0, q)
    A = np.einsum("qi,qj->qij", normals, normals)
    A6 = np.stack([A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2],
                   A[:, 2, 2]]).astype(np.float32)
    valid = np.ones(q, bool)
    valid[::17] = False
    return dict(A6=A6, P=P.astype(np.float32), X=X.astype(np.float32),
                weight=weights.astype(np.float32), status=np.zeros(q, np.uint8),
                valid=valid)


def test_robust_lm_matches_jax():
    prob = _lm_problem()
    mj = jmatcher.Matches(**{k: jnp.asarray(v) for k, v in prob.items()})
    mt = tmatcher.Matches(**{k: torch.from_numpy(v) for k, v in prob.items()})
    for sat in (1.0, 0.5):
        rj = jsolver.robust_lm([mj], jnp.zeros(6, jnp.float32), jnp.float32(sat),
                               JSolver(), 15)
        rt = tsolver.robust_lm([mt], torch.zeros(6), torch.tensor(sat), TSolver(), 15)
        np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=ATOL, rtol=0)
        # accepted-step counts may differ by a last rounding-level step; the
        # ICP early exit reads only whether any step was accepted
        assert (int(rt.n_success) == 1) == (int(rj.n_success) == 1)
        np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=1e-4, atol=1e-3)
        ej, et = jsolver.registration_error(rj.H), tsolver.registration_error(rt.H)
        np.testing.assert_allclose(et.covariance.numpy(), np.asarray(ej.covariance),
                                   rtol=1e-3, atol=1e-7)
        np.testing.assert_allclose(float(et.position_error), float(ej.position_error),
                                   rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("reuse", [False, True])
def test_icp_register_matches_jax_and_oracle(seed, reuse):
    edge_map, plane_map, kp_e, kp_p = _scene(seed)
    rng = np.random.default_rng(100 + seed)
    pose0 = np.concatenate([rng.uniform(-0.08, 0.08, 3),
                            rng.uniform(-0.02, 0.02, 3)]).astype(np.float32)
    q = len(kp_e)
    ones = np.ones(q, bool)
    jres = jicp.icp_register(
        jicp.ICPInputs(kp_xyz=(jnp.asarray(kp_e, jnp.float32),
                               jnp.asarray(kp_p, jnp.float32), None),
                       kp_valid=(jnp.asarray(ones), jnp.asarray(ones), None),
                       index=(_jview(edge_map), _jview(plane_map), None)),
        types=(JKeypoint.EDGE, JKeypoint.PLANE), pose0=jnp.asarray(pose0),
        params=JMatching(reuse_knn=reuse), solver_cfg=JSolver(), icp_iters=3,
        lm_max_iter=15, min_matches=20, geoms=(None, None, None))
    tres = ticp.icp_register(
        ticp.ICPInputs(kp_xyz=(torch.from_numpy(kp_e.astype(np.float32)),
                               torch.from_numpy(kp_p.astype(np.float32)), None),
                       kp_valid=(torch.from_numpy(ones), torch.from_numpy(ones), None),
                       index=(_tview(edge_map), _tview(plane_map), None)),
        types=(TKeypoint.EDGE, TKeypoint.PLANE), pose0=torch.from_numpy(pose0),
        params=TMatching(reuse_knn=reuse), solver_cfg=TSolver(), icp_iters=3,
        lm_max_iter=15, min_matches=20)
    pose_t = tres.pose.numpy().astype(np.float64)
    np.testing.assert_allclose(pose_t, np.asarray(jres.pose), atol=ATOL, rtol=0)
    assert bool(tres.failed) == bool(jres.failed) is False
    np.testing.assert_array_equal(tres.match_counts.numpy(), np.asarray(jres.match_counts))
    for st, sj in zip(tres.statuses, jres.statuses):
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if not reuse:   # the oracle re-queries every round
        pose_o, failed_o, _, _ = oracle.icp_register_oracle(
            kp_e, ones, edge_map, kp_p, ones, plane_map, pose0.astype(np.float64),
            JMatching(), JSolver(), icp_iters=3, lm_max_iter=15, min_matches=20)
        assert not failed_o
        # the oracle test's own tolerance (tests/test_oracle_localization.py)
        assert np.abs(pose_t - pose_o).max() < 1e-4, (pose_t, pose_o)


def test_min_match_guard_fails_and_keeps_pose():
    edge_map, plane_map, kp_e, kp_p = _scene(3)
    q = len(kp_e)
    valid = np.zeros(q, bool)
    valid[:5] = True
    pose0 = torch.tensor([0.01, 0.0, 0.0, 0.0, 0.0, 0.0])
    res = ticp.icp_register(
        ticp.ICPInputs(kp_xyz=(torch.from_numpy(kp_e.astype(np.float32)),
                               torch.from_numpy(kp_p.astype(np.float32)), None),
                       kp_valid=(torch.from_numpy(valid), torch.from_numpy(valid), None),
                       index=(_tview(edge_map), _tview(plane_map), None)),
        types=(TKeypoint.EDGE, TKeypoint.PLANE), pose0=pose0,
        params=TMatching(), solver_cfg=TSolver(), icp_iters=3, lm_max_iter=15,
        min_matches=20)
    assert bool(res.failed)
    assert torch.equal(res.pose, pose0)
