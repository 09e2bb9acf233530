"""The streaming path of the PyTorch port (`Slam.add_frame_async`/`flush`)
against the JAX package's, on the CPU: the window wires, the in-graph pose
extrapolation, the gated ICP loop, the sync-free covariance, whole streamed
sequences (full, partial flush, seeded segment) and a JAX stream state
carried into the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import ExtractorConfig, MapConfig, SlamConfig
from lidarslam_tpu.config import MatchingConfig as JMatching
from lidarslam_tpu.core import se3 as jse3
from lidarslam_tpu.io import native
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu.ops import frame as jframe
from lidarslam_tpu.ops import pipeline as jpipe
from lidarslam_tpu.ops import undistortion as jund
from lidarslam_tpu_torch.io import native as tnative
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch import state as tstate
from lidarslam_tpu_torch.config import Keypoint as TKeypoint
from lidarslam_tpu_torch.config import MatchingConfig as TMatching
from lidarslam_tpu_torch.config import SolverConfig as TSolver
from lidarslam_tpu_torch.core import se3 as tse3
from lidarslam_tpu_torch.ops import frame as tframe
from lidarslam_tpu_torch.ops import icp as ticp
from lidarslam_tpu_torch.ops import pipeline as tpipe
from lidarslam_tpu_torch.ops import solver as tsolver
from lidarslam_tpu_torch.ops import stream_graph
from lidarslam_tpu_torch.ops import undistortion as tund
from lidarslam_tpu_torch.ops.voxel_map import SubmapView as TView
from test_oracle_localization import _scene
from test_torch_slam import _one_torch_thread, _pose_err, _torch_config  # noqa: F401

N_FRAMES = 10
WINDOW = 4
CARRY_AT = 5            # JAX stream state carried after this frame
CI_M, CI_DEG = 0.01, 5.0   # the reference CI's per-pose tolerance


def _jcfg():
    """tests/test_streaming.py's 16-ring config, with the bench's reuse_knn
    and a window of 4."""
    return SlamConfig(
        extractor=ExtractorConfig(n_rings=16, max_ring_points=1024, max_keypoints=1024),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 15, grid_size=26),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        loc_matching=JMatching(reuse_knn=True), stream_window=WINDOW)


def _stream(slam, frames, split=None, sync_first=0):
    """Stream `frames` (after `sync_first` add_frame calls); flush at `split`
    and at the end. Returns the flushed results of the streamed frames."""
    for f in frames[:sync_first]:
        slam.add_frame(f)
    outs = []
    for i, f in enumerate(frames[sync_first:], sync_first):
        if i == split:
            outs += slam.flush()
        assert slam.add_frame_async(f) >= 0
    return outs + slam.flush()


@pytest.fixture(scope="module")
def runs():
    frames = jsyn.generate_sequence(n_frames=N_FRAMES, motion_distortion=False,
                                    sensor=jsyn.SensorModel(range_noise=0.005))
    jcfg = _jcfg()
    out = {"frames": frames, "cfg": _torch_config(jcfg)}
    with pytest.MonkeyPatch.context() as mp:
        # both packages on their numpy ingest: the native one rounds a few
        # quantized coordinates differently (ROADMAP Queue 3, F5)
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        js = JSlam(jcfg)
        out["jax"] = _stream(js, frames)
        out["jax_kf"] = js.kf_counter
        out["jax_trel"] = js.Trelative.copy()
        out["jax_partial"] = _stream(JSlam(jcfg), frames, split=4)
        out["jax_seeded"] = _stream(JSlam(jcfg), frames, sync_first=2)
        # a JAX stream state stepped per frame, as the per-frame path does,
        # through the Slam's own (already compiled) streaming step
        az = np.float32(js.azimuthal_resolution)
        st = jpipe.init_stream_state(jcfg, js._map_cfgs_tuple)
        wires = []
        for i, f in enumerate(frames[:CARRY_AT + 2]):
            planes = jframe.build_range_image(f["xyz"], f["intensity"], f["laser_id"],
                                              f["time"], 16, 1024, packed=True,
                                              device=False)
            wires.append(planes)
            ri = js._build_ri(f) if i == 0 else jframe.to_device_range_image(planes)
            if i == CARRY_AT + 1:
                out["carried"] = jax.tree.map(np.asarray, st)
            st, packed, _ = js._process_stream(ri, st, np.float32(f["stamp"]), az, jcfg,
                                               js._map_cfgs_tuple, i == 0, ())
        out["carry_packed"] = np.asarray(packed)
        out["carry_wire"], out["az"] = wires[-1], float(az)
        ts = TSlam(out["cfg"], device="cpu")
        out["torch"] = _stream(ts, frames)
        out["torch_kf"] = ts.kf_counter
        out["torch_trel"] = ts.Trelative.copy()
        out["torch_slam"] = ts
        out["torch_partial"] = _stream(TSlam(out["cfg"], device="cpu"), frames, split=4)
        out["torch_seeded"] = _stream(TSlam(out["cfg"], device="cpu"), frames, sync_first=2)
    return out


def _max_err(a, b):
    errs = [_pose_err(x["pose"], y["pose"]) for x, y in zip(a, b)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


@pytest.mark.parametrize("case", ["", "_partial", "_seeded"])
def test_stream_matches_jax(runs, case):
    """Poses within the CI tolerance (measured: < 1e-4 m on this sequence),
    n_matches within 1%, failure flags equal — for one segment, a flush
    after 4 sweeps, and a segment seeded after two add_frame calls."""
    t, j = runs["torch" + case], runs["jax" + case]
    assert len(t) == len(j) == N_FRAMES - (2 if case == "_seeded" else 0)
    dt, dr = _max_err(t, j)
    assert dt < CI_M and dr < CI_DEG, (dt, dr)
    assert dt < 1e-3, dt     # far inside the CI tolerance in practice
    for i, (a, b) in enumerate(zip(t, j)):
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * b["n_matches"], i
    assert [a["failure"] for a in t] == [b["failure"] for b in j]
    assert not any(a["failure"] for a in t)


def test_stream_keyframes_logs_and_maps(runs):
    ts = runs["torch_slam"]
    assert runs["torch_kf"] == runs["jax_kf"] > 1
    assert len(ts.get_trajectory()) == N_FRAMES
    # every flushed frame logs its keypoints (logging_timeout=-1, DEVICE tier)
    assert len(ts.log_keypoints) == N_FRAMES
    assert all(sorted(e) == [TKeypoint.EDGE, TKeypoint.PLANE] for e in ts.log_keypoints)
    for k in (TKeypoint.EDGE, TKeypoint.PLANE):
        kv = ts.current_keypoints[k]
        n = int(kv.count)
        assert n > 50 and kv.valid[:n].all() and not kv.valid[n:].any()
        assert np.isfinite(kv.xyz[:n]).all()
        pts, *_ = ts.get_map_points(k)
        assert len(pts) > 200
    assert ts.flush() == []


def test_stream_trelative_matches_jax(runs):
    """Slam.Trelative after the flush (the last streamed sweep's relative
    motion) within 1e-3 m / 0.1 deg of JAX's."""
    t, j = runs["torch_trel"], runs["jax_trel"]
    dt, dr = _pose_err(t, j)
    assert dt < 1e-3 and dr < 0.1, (dt, dr)
    assert np.linalg.norm(t[:3, 3]) > 0.05


def test_flush_without_pending_is_empty(runs):
    slam = TSlam(runs["cfg"], device="cpu")
    assert slam.flush() == []
    assert slam.add_frame_async(runs["frames"][0]) == 0
    assert len(slam.flush()) == 1
    assert slam.flush() == []


def test_add_frame_after_stream_and_duplicate_skip(runs):
    """Mixing with add_frame across a flush: the sync path continues from
    the streamed state; a repeated stamp is skipped."""
    frames = runs["frames"]
    slam = TSlam(runs["cfg"], device="cpu")
    outs = _stream(slam, frames[:4])
    assert slam.add_frame_async(frames[3]) == -1       # duplicate stamp
    r = slam.add_frame(frames[4])
    assert not r["failure"]
    # the host's float64 prior against the stream's float32 one
    dt, dr = _pose_err(r["pose"], runs["torch"][4]["pose"])
    assert dt < CI_M and dr < CI_DEG
    assert len(outs) == 4 and len(slam.get_trajectory()) == 5


def test_stream_state_carry_steps_like_jax(runs):
    """A JAX StreamState after frame 5 through stream_state_from_numpy; the
    port steps frame 6 from it as JAX does."""
    cfg = runs["cfg"]
    slam = TSlam(cfg, device="cpu")
    st = tstate.stream_state_from_numpy(runs["carried"], "cpu")
    wire = tframe.to_device_range_image(tframe.PackedRangeImage(*runs["carry_wire"]))
    f = runs["frames"][CARRY_AT + 1]
    _, packed, kps_flat = tpipe.process_frame_stream(
        wire, st, torch.tensor(f["stamp"], dtype=torch.float32),
        torch.tensor(runs["az"], dtype=torch.float32), cfg, slam._map_cfgs_tuple, False)
    t = tpipe.unpack_scalars(packed.numpy())
    j = jpipe.unpack_scalars(runs["carry_packed"])
    dt, dr = _pose_err(tse3.pose_to_hmat(t["pose"]), tse3.pose_to_hmat(j["pose"]))
    assert dt < 5e-4 and dr < 0.01, (dt, dr)
    assert t["total"] == pytest.approx(j["total"], rel=0.01)
    assert t["failed"] == j["failed"] is False
    # the origin after the frame follows the packed scalars (JAX's 64, the
    # port's PACKED_LEN with the ego-motion registration's estimate and counts)
    np.testing.assert_array_equal(packed.numpy()[tpipe.PACKED_LEN:], runs["carry_packed"][64:])
    assert packed.shape == (tpipe.PACKED_LEN + 3,) and len(kps_flat) == 3


# ----------------------------------------------------------------------------
#   wires
# ----------------------------------------------------------------------------

def _planes(frame, both=True):
    args = (frame["xyz"], frame["intensity"], frame["laser_id"], frame["time"], 16, 1024)
    with pytest.MonkeyPatch.context() as mp:
        # both packages on their numpy ingest (ROADMAP Queue 3, F5)
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        t = tframe.build_range_image(*args, packed=True, device=False)
        if not both:
            return t
        j = jframe.build_range_image(*args, packed=True, device=False)
    return t, j


def test_packed_planes_and_flat_bytes_equal_jax(runs):
    t, j = _planes(runs["frames"][3])
    for name in jframe.PackedRangeImage._fields:
        a, b = np.asarray(getattr(t, name)), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    total = int(np.asarray(t.counts).sum())
    for cap in (0, total // 2):        # lossless, and water-filled at half
        ft, fj = tframe.flatten_packed(t, cap), jframe.flatten_packed(j, cap)
        for name in tframe.FlatRangeImage.FIELDS:
            a, b = np.asarray(getattr(ft, name)), np.asarray(getattr(fj, name))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (cap, name)


def test_water_fill_cap_equals_jax():
    rng = np.random.default_rng(5)
    for _ in range(50):
        counts = rng.integers(0, 1024, size=16)
        budget = int(rng.integers(0, counts.sum() + 100))
        np.testing.assert_array_equal(tframe._water_fill_cap(counts, budget),
                                      jframe._water_fill_cap(counts, budget))


def _assert_ri_equal(t, j):
    for name in tframe.RangeImage._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


def test_unpack_equals_jax(runs):
    t, j = _planes(runs["frames"][4])
    _assert_ri_equal(tframe.to_device_range_image(t).unpack(),
                     jframe.to_device_range_image(j).unpack())
    cap = int(np.asarray(t.counts).sum()) * 3 // 4
    _assert_ri_equal(tframe.to_device_range_image(tframe.flatten_packed(t, cap)).unpack(),
                     jframe.to_device_range_image(jframe.flatten_packed(j, cap)).unpack())


def test_window_stack_and_wire_record_roundtrip(runs):
    """The stacked flat wire and the graph's byte records carry each sweep
    unchanged."""
    flats = [tframe.flatten_packed(_planes(f, both=False)) for f in runs["frames"][:3]]
    stamps = [np.float32(f["stamp"]) for f in runs["frames"][:3]]
    stack = tframe.stack_range_images(flats)
    wire = stream_graph.WireRecord(16, 1024, 16 * 1024)
    records = wire.pack(flats, stamps)
    assert records.shape == (3, wire.nbytes) and wire.nbytes % 16 == 0
    for w, flat in enumerate(flats):
        want = tframe.to_device_range_image(flat).unpack()
        _assert_ri_equal(tpipe.window_frame(stack, w).unpack(), want)
        rec, stamp, (odom, grav) = wire.unpack(records[w])
        _assert_ri_equal(rec.unpack(), want)
        assert float(stamp) == stamps[w]
        assert not bool(odom.valid) and not bool(grav.valid)   # no sensor blocks


def test_flatten_keypoints_roundtrip():
    rng = np.random.default_rng(2)
    K, n = 64, 40
    kp = tframe.Keypoints(
        xyz=torch.from_numpy(rng.normal(size=(K, 3)).astype(np.float32)),
        intensity=torch.from_numpy(rng.uniform(0, 255, K).astype(np.float32)),
        time=torch.from_numpy(rng.uniform(0, 0.1, K).astype(np.float32)),
        ring=torch.from_numpy(rng.integers(0, 16, K).astype(np.int32)),
        valid=torch.arange(K) < n, count=torch.tensor(n, dtype=torch.int32))
    buf = tframe.flatten_keypoints(kp)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jframe.flatten_keypoints(
        jframe.Keypoints(*(jnp.asarray(a.numpy()) for a in kp)))))
    for view in (tframe.KeypointsView(buf), tframe.KeypointsView(torch.stack([buf, buf]), 1)):
        assert view.capacity == K and view.count == n
        for name in ("xyz", "intensity", "time", "ring", "valid"):
            np.testing.assert_array_equal(getattr(view, name), getattr(kp, name).numpy())


# ----------------------------------------------------------------------------
#   in-graph extrapolation, gated ICP, sync-free covariance
# ----------------------------------------------------------------------------

def _random_pose(rng):
    return np.concatenate([rng.uniform(-5, 5, 3), rng.uniform(-np.pi / 2, np.pi / 2, 3)])


def test_jinterpolate_matches_jax():
    rng = np.random.default_rng(8)
    j_interp_pose = jax.jit(jund.jinterpolate_pose, static_argnums=5)
    j_interp_rt = jax.jit(jse3.jinterpolate_rt)
    for i in range(40):
        a = _random_pose(rng).astype(np.float32)
        b = (a + rng.normal(0, 0.2, 6)).astype(np.float32)
        ta, tb = np.float32(1.0), np.float32(1.1)
        if i % 4 == 1:
            tb = ta                                   # degenerate time base
        t = np.float32(tb + rng.uniform(-0.05, 0.15))
        if i % 4 == 2:
            t = np.float32(tb + 0.5)                  # beyond max_extrapolation_ratio
        Rt, tt = tund.jinterpolate_pose(*(torch.from_numpy(np.array(x)) for x in
                                          (a, b, t, ta, tb)), 3.0)
        Rj, tj = j_interp_pose(*(jnp.asarray(x) for x in (a, b, t, ta, tb)), 3.0)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6, rtol=0)
        if i % 4 in (1, 2):       # falls back to pose b
            Rb, tb_ = tse3.jpose_to_rt(torch.from_numpy(b))
            assert torch.equal(Rt, Rb) and torch.equal(tt, tb_)
        Ra, tva = tse3.jpose_to_rt(torch.from_numpy(a))
        Rb, tvb = tse3.jpose_to_rt(torch.from_numpy(b))
        u = np.float32(rng.uniform(-0.5, 1.5))
        Rt2, tt2 = tse3.jinterpolate_rt(Ra, tva, Rb, tvb, torch.tensor(u),
                                        torch.tensor(0.0), torch.tensor(1.0))
        Rj2, tj2 = j_interp_rt(*(jnp.asarray(x.numpy()) for x in (Ra, tva, Rb, tvb)),
                               u, np.float32(0.0), np.float32(1.0))
        np.testing.assert_allclose(Rt2.numpy(), np.asarray(Rj2), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tt2.numpy(), np.asarray(tj2), atol=1e-6, rtol=0)


def _tview(pts):
    return TView(xyz=torch.from_numpy(np.asarray(pts, np.float32)), ring=None,
                 valid=torch.ones(len(pts), dtype=torch.bool))


def _icp(seed, pose0, reuse, min_matches, icp_iters=3):
    edge_map, plane_map, kp_e, kp_p = _scene(seed)
    ones = torch.ones(len(kp_e), dtype=torch.bool)
    return ticp.icp_register(
        ticp.ICPInputs(kp_xyz=(torch.from_numpy(kp_e.astype(np.float32)),
                               torch.from_numpy(kp_p.astype(np.float32)), None),
                       kp_valid=(ones, ones, None),
                       index=(_tview(edge_map), _tview(plane_map), None)),
        types=(TKeypoint.EDGE, TKeypoint.PLANE), pose0=pose0,
        params=TMatching(reuse_knn=reuse), solver_cfg=TSolver(), icp_iters=icp_iters,
        lm_max_iter=15, min_matches=min_matches, count=True)


def _jax_icp(seed, pose0, reuse, min_matches, icp_iters=3):
    from lidarslam_tpu.config import Keypoint as JKeypoint
    from lidarslam_tpu.config import SolverConfig as JSolver
    from lidarslam_tpu.ops import icp as jicp
    from lidarslam_tpu.ops.voxel_map import SubmapView as JView

    edge_map, plane_map, kp_e, kp_p = _scene(seed)
    ones = np.ones(len(kp_e), bool)

    def jview(p):
        return JView(xyz=jnp.asarray(p, jnp.float32), ring=jnp.zeros(len(p), jnp.int32),
                     valid=jnp.ones(len(p), bool))
    return jicp.icp_register(
        jicp.ICPInputs(kp_xyz=(jnp.asarray(kp_e, jnp.float32), jnp.asarray(kp_p, jnp.float32),
                               None), kp_valid=(jnp.asarray(ones), jnp.asarray(ones), None),
                       index=(jview(edge_map), jview(plane_map), None)),
        types=(JKeypoint.EDGE, JKeypoint.PLANE), pose0=jnp.asarray(pose0),
        params=JMatching(reuse_knn=reuse), solver_cfg=JSolver(), icp_iters=icp_iters,
        lm_max_iter=15, min_matches=min_matches, geoms=(None, None, None))


def _converged_start(side):
    """A start where round 0's LM accepts no step: each side's own one-round
    result (a step accepted or not is decided at rounding level)."""
    if side == "jax":
        return np.asarray(_jax_icp(0, np.zeros(6, np.float32), True, 20, icp_iters=1).pose)
    return _icp(0, torch.zeros(6), True, 20, icp_iters=1).pose.numpy()


_LOC_START = np.array([0.05, -0.04, 0.02, 0.01, -0.01, 0.015], np.float32)

# (scene seed, start pose per side, reuse_knn, min_matches, rounds begun
# with the gate open: the reference breaks after the last)
_EXITS = {
    "round0": (0, _converged_start, True, 20, 1),   # LM cannot improve: converged
    "round1": (1, lambda side: _LOC_START, False, 187, 2),  # too few matches in round 1
    "never": (0, lambda side: np.zeros(6, np.float32), True, 20, 3),
    "localization": (1, lambda side: _LOC_START, True, 20, 3),  # the localization tests'
}


@pytest.mark.parametrize("case", sorted(_EXITS))
def test_gated_icp_matches_jax(case, monkeypatch):
    """The gated loop runs every round and counts the rounds begun with the
    gate open, which end where the reference breaks; its result is the JAX
    while_loop's at the localization tests' tolerance
    (tests/test_torch_localization.py)."""
    seed, start, reuse, min_matches, rounds = _EXITS[case]
    pose_t, pose_j = torch.from_numpy(start("torch")), start("jax")
    calls = []
    real = tsolver.robust_lm
    monkeypatch.setattr(ticp.solver, "robust_lm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    t = _icp(seed, pose_t, reuse, min_matches)
    assert len(calls) == 3 and int(t.rounds) == rounds
    j = _jax_icp(seed, pose_j, reuse, min_matches)
    np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.match_counts.numpy(), np.asarray(j.match_counts))
    assert bool(t.failed) == bool(j.failed) == (case == "round1")


def test_jacobi_covariance_matches_pinv():
    rng = np.random.default_rng(3)
    for i in range(20):
        J = rng.normal(size=(60, 6)) * np.array([1, 1, 1, 10, 10, 10])
        H = (J.T @ J).astype(np.float32)
        if i % 5 == 0:
            H[:, 2] = H[2, :] = 0.0           # an unobservable direction
        ref = np.linalg.pinv(H.astype(np.float64), rcond=1e-10, hermitian=True)
        got = tsolver.pose_covariance(torch.from_numpy(H)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert torch.equal(tsolver.pose_covariance(torch.zeros(6, 6)),
                       torch.zeros(6, 6))


def test_stream_step_reads_nothing_on_host(runs, monkeypatch):
    """One streaming step with every Python-level host read of a tensor
    made to raise: the step decides nothing on the host. (On the card,
    chip_smoke.py runs it under torch.cuda.set_sync_debug_mode("error").)"""
    cfg = runs["cfg"]
    slam = TSlam(cfg, device="cpu")
    _stream(slam, runs["frames"][:1])
    slam._ensure_stream_state()
    st = slam._stream_state
    flat = tframe.to_device_range_image(
        tframe.flatten_packed(_planes(runs["frames"][3], both=False)))
    stamp = torch.tensor(runs["frames"][3]["stamp"], dtype=torch.float32)
    az = torch.tensor(slam.azimuthal_resolution, dtype=torch.float32)

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor inside the streaming step")
    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
                 "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    _, packed, _ = tpipe.process_frame_stream(flat, st, stamp, az, cfg,
                                              slam._map_cfgs_tuple, False)
    monkeypatch.undo()
    assert int(tpipe.unpack_scalars(packed.numpy()[:tpipe.PACKED_LEN])["total"]) > 100


def test_add_frame_next_frame_prefetch_is_identical(runs):
    frames = runs["frames"][:2]
    a, b = TSlam(runs["cfg"], device="cpu"), TSlam(runs["cfg"], device="cpu")
    ra = [a.add_frame(f) for f in frames]
    rb = [b.add_frame(f, next_frame=n) for f, n in zip(frames, frames[1:] + [None])]
    for x, y in zip(ra, rb):
        assert np.array_equal(x["pose"], y["pose"]) and x["n_matches"] == y["n_matches"]


@pytest.mark.parametrize("change", [
    dict(compress_upload=False),
])
def test_stream_unported_options_raise(runs, change):
    """The stream refuses no single-LiDAR option any more:
    compress_upload=False, which raised NotImplementedError before the float
    window was ported, streams (tests/test_torch_native.py holds it against
    JAX)."""
    slam = TSlam(dataclasses.replace(runs["cfg"], **change), device="cpu")
    assert [slam.add_frame_async(f) for f in runs["frames"][:2]] == [0, 1]
    out = slam.flush()
    assert len(out) == 2 and not any(o["failure"] for o in out)


# the live graph's step (ops/stream_graph.FrameGraph) against add_frame's
# eager step: (undistortion, keyframe thresholds (m, deg), what happens
# between the sweeps MID and MID + 1, scan-to-scan ego-motion registration
# on)
_LIVE_MID = 3
_LIVE_CASES = {
    "keyframe_every_sweep": ("NONE", (0.0, 0.0), None, False),
    "refined_keyframe_every_sweep": ("REFINED", (0.0, 0.0), None, False),
    "few_keyframes": ("NONE", (50.0, 180.0), None, False),
    "refined_few_keyframes": ("REFINED", (50.0, 180.0), None, False),
    "stale_submap_forced": ("NONE", (50.0, 180.0), "stale", False),
    "stream_segment_between": ("REFINED", (0.0, 0.0), "segment", False),
    "ego_refined_keyframe_every_sweep": ("REFINED", (0.0, 0.0), None, True),
    "ego_stream_segment_between": ("REFINED", (0.0, 0.0), "segment", True),
}


def _live_config(undistortion, kf, ego=False):
    from lidarslam_tpu_torch.config import EgoMotionMode as TEgo
    from lidarslam_tpu_torch.config import ExtractorConfig as TExtractor
    from lidarslam_tpu_torch.config import MapConfig as TMap
    from lidarslam_tpu_torch.config import SlamConfig as TConfig
    from lidarslam_tpu_torch.config import UndistortionMode as TUndistortion

    return TConfig(
        extractor=TExtractor(n_rings=16, max_ring_points=512, max_keypoints=256),
        edge_map=TMap(leaf_size=0.30, capacity=1 << 13, grid_size=26),
        plane_map=TMap(leaf_size=0.60, capacity=1 << 13, grid_size=26),
        blob_map=TMap(leaf_size=0.30, capacity=1 << 13, grid_size=26),
        loc_matching=TMatching(reuse_knn=True), undistortion=TUndistortion[undistortion],
        kf_distance_threshold=kf[0], kf_angle_threshold=kf[1],
        ego_motion_mode=TEgo.MOTION_EXTRAPOLATION_AND_REGISTRATION if ego
        else TEgo.MOTION_EXTRAPOLATION)


@pytest.mark.parametrize("case", sorted(_LIVE_CASES))
def test_live_graph_step_equals_the_eager_step(case, monkeypatch):
    """add_frame's step through the live graph's body (`FrameGraph._body`,
    called directly: the CPU has no graph to capture) against the eager
    step, the same function: the graph's plumbing (its input record, the
    seeding, the state buffers written in place) changes nothing. From the
    same host state every sweep: the same packed scalars, poses, maps and
    keypoints. Between two sweeps a case forces the submap stale, or runs a
    stream segment, after which the graph's state is reseeded. With
    ego-motion registration the packed scalars carry its estimate and its
    device counts; the segment's first sweep registers against empty
    previous keypoints and keeps its prior."""
    from lidarslam_tpu_torch.io import synthetic as tsyn

    undistortion, kf, event, ego = _LIVE_CASES[case]
    cfg = _live_config(undistortion, kf, ego)
    frames = tsyn.generate_sequence(n_frames=8, motion_distortion=undistortion != "NONE",
                                    sensor=tsyn.SensorModel(n_azimuth=500))
    monkeypatch.setattr(stream_graph.FrameGraph, "_step", stream_graph.FrameGraph._body)
    seeds = []
    real_seed = stream_graph.FrameGraph.seed
    monkeypatch.setattr(stream_graph.FrameGraph, "seed",
                        lambda g, *a: seeds.append(len(rows[1])) or real_seed(g, *a))
    slams = (TSlam(cfg, device="cpu"), TSlam(cfg, device="cpu"))
    slams[1]._frame_captured = lambda: True
    rows = ([], [])
    for s, r in zip(slams, rows):
        s._apply_result = (lambda res, *a, real=s._apply_result, r=r:
                           r.append((res.packed.clone(), res.is_keyframe)) or real(res, *a))
    kfs, ego_counts, ego_notes = [], [], ([], [])
    for s, notes in zip(slams, ego_notes):
        s._note_ego = (lambda u, real=s._note_ego, notes=notes:
                       notes.append((u["ego_rounds"], u["ego_lm_steps"])) or real(u))
    for i, f in enumerate(frames):
        if i == _LIVE_MID + 1 and event == "stale":
            for s in slams:
                s._invalidate_submaps()
        if i in (_LIVE_MID + 1, _LIVE_MID + 2) and event == "segment":
            for s in slams:
                s.add_frame_async(f)
            if i == _LIVE_MID + 2:
                for s, notes in zip(slams, ego_notes):
                    s.flush()
                    # the segment's first sweep registers against empty
                    # previous keypoints: its one round matches nothing
                    assert notes[-2:][0][0] == (1 if ego else 0)
            continue
        outs = [s.add_frame(f) for s in slams]
        (pa, kfa), (pb, kfb) = rows[0][-1], rows[1][-1]
        np.testing.assert_array_equal(pa, pb)
        assert np.array_equal(outs[0]["pose"], outs[1]["pose"])
        for k in cfg.used_types:
            for a, b in zip(slams[0].maps[k], slams[1].maps[k]):
                assert torch.equal(a, b)
            for a, b in zip(slams[0].current_keypoints[k], slams[1].current_keypoints[k]):
                assert torch.equal(a, b)
        kfs.append(bool(kfa))
        assert bool(kfa) == bool(kfb)
        ego_counts.append((slams[1].ego_rounds, slams[1].ego_lm_steps))
        assert np.array_equal(slams[0].ego_motion, slams[1].ego_motion)
    graph = slams[1]._frame_graph
    assert graph is not None and slams[1]._device_keypoints is graph.state[1]
    assert all(a is b for a, b in zip((slams[1].maps[k] for k in cfg.used_types),
                                      (graph.state[0][int(k)] for k in cfg.used_types)))
    assert seeds[0] == 1                         # built on the second sweep
    if event is not None:                        # the event's state was copied in
        assert seeds[1:] == [_LIVE_MID + 1]
    else:
        assert seeds == [1]
    if kf == (0.0, 0.0):
        assert all(kfs)
    else:
        assert not all(kfs[1:])
    if ego:   # every sweep after the first registers, within its budget
        assert ego_counts[0] == (0, 0)
        assert all(1 <= r <= cfg.ego_motion_icp_max_iter
                   and r <= n <= r * cfg.ego_motion_lm_max_iter for r, n in ego_counts[1:])
    else:
        assert set(ego_counts) == {(0, 0)}
