"""Undistortion in the PyTorch port against the JAX package, on the CPU: the
quaternion helpers, the sweep warp, the ONCE / REFINED ICP loop and whole
`Slam.add_frame` runs on sweeps rendered with motion distortion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import Keypoint as JKeypoint
from lidarslam_tpu.config import MatchingConfig as JMatching
from lidarslam_tpu.config import SolverConfig as JSolver
from lidarslam_tpu.config import UndistortionMode as JUndistortion
from lidarslam_tpu.core import se3 as jse3
from lidarslam_tpu.io import native
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu.ops import icp as jicp
from lidarslam_tpu.ops import undistortion as jund
from lidarslam_tpu.ops.voxel_map import SubmapView as JView
from lidarslam_tpu_torch.io import native as tnative
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.config import Keypoint as TKeypoint
from lidarslam_tpu_torch.config import MatchingConfig as TMatching
from lidarslam_tpu_torch.config import SolverConfig as TSolver
from lidarslam_tpu_torch.config import UndistortionMode as TUndistortion
from lidarslam_tpu_torch.core import se3 as tse3
from lidarslam_tpu_torch.ops import icp as ticp
from lidarslam_tpu_torch.ops import undistortion as tund
from lidarslam_tpu_torch.ops.voxel_map import SubmapView as TView
from test_oracle_localization import _scene
from test_slam_e2e import small_config
from test_torch_slam import _one_torch_thread, _pose_err, _torch_config  # noqa: F401

ATOL = 1e-5
N_FRAMES = 8
CI_M, CI_DEG = 0.01, 5.0   # the reference CI's per-pose tolerance
# matches a frame may differ from JAX by: keypoints whose gate value lies
# within float rounding of its threshold (XLA fuses a*b+c into FMAs)
MATCH_FLIPS = 3


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quaternion_helpers_match_jax():
    """jquat_from_matrix / jquat_to_matrix / jquat_slerp on (N, 4): random
    pairs, pairs at dot ~ +1 and ~ -1 (the lerp fallback and the sign flip),
    and u in [-2, 3] as warp_points clips it."""
    rng = np.random.default_rng(0)
    n = 256
    q0 = _unit_quats(rng, n)
    q1 = _unit_quats(rng, n)
    q1[:64] = q0[:64] + rng.normal(0, 1e-7, (64, 4)).astype(np.float32)   # dot ~ +1
    q1[64:128] = -q0[64:128] + rng.normal(0, 1e-7, (64, 4)).astype(np.float32)  # ~ -1
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    u = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    js = np.asarray(jax.jit(jse3.jquat_slerp)(q0, q1, u))
    ts = tse3.jquat_slerp(_t(q0), _t(q1), _t(u)).numpy()
    np.testing.assert_allclose(ts, js, atol=ATOL, rtol=0)
    R = np.asarray(jax.jit(jse3.jquat_to_matrix)(q0))
    np.testing.assert_allclose(tse3.jquat_to_matrix(_t(q0)).numpy(), R, atol=ATOL, rtol=0)
    # every Shepperd branch: rotations near 0 and near pi about each axis
    Rs = np.concatenate([R, np.stack([np.diag(d).astype(np.float32) for d in
                                      ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])])
    np.testing.assert_allclose(tse3.jquat_from_matrix(_t(Rs)).numpy(),
                               np.asarray(jax.jit(jse3.jquat_from_matrix)(Rs)),
                               atol=ATOL, rtol=0)


def _warp_pair(prev, cur, t_prev, t_cur, time0, time1, ratio=3.0):
    j = jax.jit(jund.compute_warp, static_argnums=6)(
        *(jnp.float32(x) if np.ndim(x) == 0 else jnp.asarray(x, jnp.float32)
          for x in (prev, cur, t_prev, t_cur, time0, time1)), ratio)
    t = tund.compute_warp(*(torch.tensor(np.float32(x)) if np.ndim(x) == 0
                            else _t(np.asarray(x, np.float32))
                            for x in (prev, cur, t_prev, t_cur, time0, time1)), ratio)
    return t, j


@pytest.mark.parametrize("case", ["moving", "degenerate_time_base", "beyond_ratio",
                                  "empty_sweep"])
def test_compute_warp_and_warp_points_match_jax(case):
    rng = np.random.default_rng(1)
    cur = np.array([2.0, -1.0, 0.1, 0.02, -0.01, 0.4])
    prev = cur - np.array([0.2, 0.05, 0.0, 0.003, 0.002, 0.03])
    t_prev, t_cur = 10.0, 10.1
    time0, time1 = -0.1, 0.0
    if case == "degenerate_time_base":
        t_prev = t_cur                       # a repeated stamp
    elif case == "beyond_ratio":
        time0, time1 = 0.5, 0.6              # 5-6 spans past t_cur > ratio 3
    elif case == "empty_sweep":
        time0, time1 = 3e38, -3e38           # no valid keypoint: disabled
    t, j = _warp_pair(prev, cur, t_prev, t_cur, time0, time1)
    for name in tund.WarpParams._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    if case in ("degenerate_time_base", "beyond_ratio"):
        # the `bad` branch: both ends are the current pose, the identity in BASE
        for q, tv in ((t.q0, t.t0v), (t.q1, t.t1v)):
            np.testing.assert_allclose(np.abs(q.numpy()), [1, 0, 0, 0], atol=1e-6)
            np.testing.assert_allclose(tv.numpy(), 0.0, atol=1e-5)
    assert bool(t.enabled) == (case != "empty_sweep")

    xyz = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    times = rng.uniform(-0.35, 0.25, 500).astype(np.float32)   # u beyond [-2, 3] too
    jw = np.asarray(jax.jit(jund.warp_points)(jnp.asarray(xyz), jnp.asarray(times), j))
    tw = tund.warp_points(_t(xyz), _t(times), t).numpy()
    np.testing.assert_allclose(tw, jw, atol=ATOL * 20, rtol=0)   # 20 m coordinates
    if case == "empty_sweep":
        assert np.array_equal(tw, xyz)


def test_identity_warp_matches_jax():
    t, j = tund.identity_warp("cpu"), jund.identity_warp()
    for name in tund.WarpParams._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    xyz = np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32)
    assert torch.equal(tund.warp_points(_t(xyz), torch.zeros(50), t), _t(xyz))


def _icp_runs(seed, mode_t, mode_j):
    """The ICP of _scene's keypoints with per-point times over a 0.1 s
    sweep, a previous pose 0.2 m / 2 deg behind, in both packages: (JAX's
    result, the port's)."""
    edge_map, plane_map, kp_e, kp_p = _scene(seed)
    rng = np.random.default_rng(50 + seed)
    q = len(kp_e)
    te, tp = (rng.uniform(-0.1, 0.0, q).astype(np.float32) for _ in range(2))
    ones = np.ones(q, bool)
    ones[:3] = False
    pose0 = np.array([0.03, -0.02, 0.01, 0.004, -0.003, 0.01], np.float32)
    prev = (pose0 - np.array([0.2, 0.04, 0.0, 0.0, 0.0, 0.035])).astype(np.float32)
    trange = (np.float32(min(te[ones].min(), tp[ones].min())),
              np.float32(max(te[ones].max(), tp[ones].max())))
    kw = dict(icp_iters=3, lm_max_iter=15, min_matches=20)

    def jview(p):
        return JView(xyz=jnp.asarray(p, jnp.float32), ring=jnp.zeros(len(p), jnp.int32),
                     valid=jnp.ones(len(p), bool))

    def tview(p):
        return TView(xyz=_t(np.asarray(p, np.float32)), ring=None,
                     valid=torch.ones(len(p), dtype=torch.bool))
    j = jicp.icp_register(
        jicp.ICPInputs(kp_xyz=(jnp.asarray(kp_e, jnp.float32), jnp.asarray(kp_p, jnp.float32),
                               None), kp_valid=(jnp.asarray(ones), jnp.asarray(ones), None),
                       index=(jview(edge_map), jview(plane_map), None),
                       kp_time=(jnp.asarray(te), jnp.asarray(tp), None)),
        types=(JKeypoint.EDGE, JKeypoint.PLANE), pose0=jnp.asarray(pose0),
        params=JMatching(reuse_knn=True), solver_cfg=JSolver(), geoms=(None, None, None),
        undistort_mode=mode_j, prev_pose=jnp.asarray(prev), t_prev=jnp.float32(9.9),
        t_cur=jnp.float32(10.0), time_range=tuple(jnp.float32(x) for x in trange), **kw)
    t = ticp.icp_register(
        ticp.ICPInputs(kp_xyz=(_t(kp_e.astype(np.float32)), _t(kp_p.astype(np.float32)),
                               None), kp_valid=(_t(ones), _t(ones), None),
                       index=(tview(edge_map), tview(plane_map), None),
                       kp_time=(_t(te), _t(tp), None)),
        types=(TKeypoint.EDGE, TKeypoint.PLANE), pose0=_t(pose0),
        params=TMatching(reuse_knn=True), solver_cfg=TSolver(), undistort_mode=mode_t,
        prev_pose=_t(prev), t_prev=torch.tensor(np.float32(9.9)),
        t_cur=torch.tensor(np.float32(10.0)),
        time_range=tuple(torch.tensor(x) for x in trange), **kw)
    return j, t


@pytest.mark.parametrize("mode", ["ONCE", "REFINED"])
@pytest.mark.parametrize("seed", [0, 1])
def test_icp_undistortion_matches_jax(mode, seed):
    """ONCE and REFINED: pose within 1e-4 m of JAX, statuses and counts
    equal, and a final warp that agrees."""
    j, t = _icp_runs(seed, TUndistortion[mode], JUndistortion[mode])
    np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=1e-4, rtol=0)
    assert bool(t.failed) == bool(j.failed) is False
    np.testing.assert_array_equal(t.match_counts.numpy(), np.asarray(j.match_counts))
    for st, sj in zip(t.statuses, j.statuses):
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for name in tund.WarpParams._fields:
        np.testing.assert_allclose(getattr(t.warp, name).numpy(),
                                   np.asarray(getattr(j.warp, name)), atol=1e-4, rtol=0,
                                   err_msg=name)


def _distorted_frames():
    return jsyn.generate_sequence(n_frames=N_FRAMES, motion_distortion=True,
                                  sensor=jsyn.SensorModel(range_noise=0.005))


@pytest.mark.parametrize("mode", ["ONCE", "REFINED"])
def test_distorted_add_frame_matches_jax(mode):
    """8 sweeps with motion distortion through add_frame: every pose within
    the CI tolerance of JAX (measured ~1e-5 m), n_matches equal but for
    rounding-level gate flips (at most MATCH_FLIPS a frame; measured with
    one torch thread: every frame equal under ONCE, 3 of 1054 and 1 of 1084
    apart at REFINED frames 3 and 5), the last frame's warp kept as
    current_warp."""
    frames = _distorted_frames()
    jcfg = small_config().replace(loc_matching=JMatching(reuse_knn=True),
                                  undistortion=JUndistortion[mode])
    with pytest.MonkeyPatch.context() as mp:
        # both packages on their numpy ingest (ROADMAP Queue 3, F5)
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        js = JSlam(jcfg)
        jres = [js.add_frame(f) for f in frames]
        ts = TSlam(_torch_config(jcfg), device="cpu")
        tres = [ts.add_frame(f) for f in frames]
    for i, (t, j) in enumerate(zip(tres, jres)):
        dt, dr = _pose_err(t["pose"], j["pose"])
        assert dt < CI_M and dr < CI_DEG, (i, dt, dr)
        assert dt < 1e-3, (i, dt)          # far inside the CI tolerance in practice
        assert abs(t["n_matches"] - j["n_matches"]) <= MATCH_FLIPS, (i, t["n_matches"],
                                                                     j["n_matches"])
        assert t["failure"] == j["failure"] is False
    assert min(t["n_matches"] for t in tres[1:]) > 100
    for name in tund.WarpParams._fields:
        np.testing.assert_allclose(getattr(ts.current_warp, name).numpy(),
                                   np.asarray(getattr(js.current_warp, name)), atol=1e-4,
                                   rtol=0, err_msg=name)
