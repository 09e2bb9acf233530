"""The port's scan-to-scan ego-motion registration against its plain
float64 reference (`slambench/ego_reference.py`), on the CPU at a small
size.

A distorted drive through `Slam.add_frame` with the mode
MOTION_EXTRAPOLATION_AND_REGISTRATION records each sweep's call of the
stage (`pipeline._ego_registration`): its keypoints, the previous sweep's
and the prior. The stage, called by the eager step and by the live
graph's body (`FrameGraph._body`, run eagerly), is held to the reference
computed from the same inputs; the same stage with its inputs and solve
rounded through bfloat16 (the control, `slambench/ego_check.bf16_ego`)
fails the same tolerances. The counts the
stage packs reach the trace as spans that the benchmark's readers count.

Tolerances: the widest gap of the port over the drive's sweeps was
1.6e-05 m and 7.7e-07 rad, float32 rounding in the matcher's PCA and the
LM solve; the control's narrowest was 1.1e-03 m and 1.7e-04 rad. The
limits sit about 6x and 26x above the first and 11x and 9x below the
second.
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidarslam_tpu_torch import Slam
from lidarslam_tpu_torch.config import (EgoMotionMode, ExtractorConfig, Keypoint, MapConfig,
                                        SlamConfig, UndistortionMode)
from lidarslam_tpu_torch.io import synthetic as tsyn
from lidarslam_tpu_torch.ops import cuda_knn, pipeline, stream_graph
from lidarslam_tpu_torch.ops.frame import Keypoints
from lidarslam_tpu_torch.utils import timer
from test_torch_slam import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from slambench import ego_check, spec, traceread  # noqa: E402
from slambench import ego_reference as ref  # noqa: E402

TRANS_TOL_M = 1e-4
ROT_TOL_RAD = 2e-5
REGISTER = EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION


def _config(mode=REGISTER):
    return SlamConfig(
        extractor=ExtractorConfig(n_rings=16, max_ring_points=512, max_keypoints=256),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 13, grid_size=26),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 13, grid_size=26),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 13, grid_size=26),
        ego_motion_mode=mode, undistortion=UndistortionMode.REFINED)


def _params(cfg):
    m = cfg.ego_matching
    return ref.EgoParams(
        max_neighbors_distance=m.max_neighbors_distance,
        edge_nb_neighbors=m.edge_nb_neighbors, edge_min_nb_neighbors=m.edge_min_nb_neighbors,
        edge_max_model_error=m.edge_max_model_error, plane_nb_neighbors=m.plane_nb_neighbors,
        planarity_threshold=m.planarity_threshold, plane_max_model_error=m.plane_max_model_error,
        icp_max_iter=cfg.ego_motion_icp_max_iter, lm_max_iter=cfg.ego_motion_lm_max_iter,
        init_saturation_distance=m.init_saturation_distance,
        final_saturation_distance=m.final_saturation_distance,
        min_matches=cfg.min_nb_matched_keypoints,
        function_tolerance=cfg.solver.function_tolerance,
        initial_lm_lambda=cfg.solver.initial_lm_lambda)


def _reference(kps, prev, prior, prm):
    e, p = kps[int(Keypoint.EDGE)], kps[int(Keypoint.PLANE)]
    pe, pp = prev[int(Keypoint.EDGE)], prev[int(Keypoint.PLANE)]
    return ref.register(e.xyz[e.valid], p.xyz[p.valid], pe.xyz[pe.valid], pe.ring[pe.valid],
                        pp.xyz[pp.valid], prior, prm)


def _recorded_drive(cfg, frames, graph=False):
    """`frames` through `Slam.add_frame`, each call of the stage recorded:
    ([(keypoints, previous keypoints, prior, (estimate, counts))], the
    Slam). `graph`: every sweep after the first steps through the live
    graph's body (`FrameGraph._body`, called directly: the CPU has no graph
    to capture)."""
    calls = []
    real = pipeline._ego_registration

    def record(kps, prev, prior, *a, **k):   # copies: the graph's state is written in place
        out = real(kps, prev, prior, *a, **k)
        calls.append(stream_graph.clone_tree((kps, prev, prior, out)))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(pipeline, "_ego_registration", record)
    if graph:
        mp.setattr(stream_graph.FrameGraph, "_step", stream_graph.FrameGraph._body)
    try:
        slam = Slam(cfg, device="cpu")
        if graph:
            slam._frame_captured = lambda: True
        for f in frames:
            slam.add_frame(f)
    finally:
        mp.undo()
    assert (slam._frame_graph is not None) == graph
    return calls, slam


@pytest.fixture(scope="module")
def drive():
    """Each registering sweep's stage call of a 7-sweep distorted drive
    through add_frame: (keypoints, previous keypoints, prior, (estimate,
    counts)), and the Slam after it."""
    cfg = _config()
    frames = tsyn.generate_sequence(n_frames=7, motion_distortion=True,
                                    sensor=tsyn.SensorModel(n_azimuth=500))
    calls, slam = _recorded_drive(cfg, frames)
    return cfg, calls, slam, frames


@pytest.fixture(scope="module")
def graph_calls(drive):
    """The same drive's stage calls through the live graph's body."""
    cfg, _, _, frames = drive
    return _recorded_drive(cfg, frames, graph=True)[0]


@pytest.mark.parametrize("path", ["gated", "frame_graph"])
def test_port_ego_stage_holds_to_the_reference(drive, graph_calls, path):
    cfg, calls, _, _ = drive
    if path == "frame_graph":
        calls = graph_calls
    prm = _params(cfg)
    assert len(calls) == 6
    for kps, prev, prior, (est, counts) in calls:
        r = _reference(kps, prev, prior, prm)
        assert not r.failed and r.matches >= cfg.min_nb_matched_keypoints
        g = ego_check.gaps(est, r.motion)
        assert g["trans_m"] < TRANS_TOL_M and g["rot_rad"] < ROT_TOL_RAD, g
        rounds, steps = counts.tolist()
        assert rounds == r.rounds
        # the trips are the same rule in both, but float32 rarely meets the
        # solve's relative tolerance, where float64 does, so they differ
        assert rounds <= steps <= rounds * cfg.ego_motion_lm_max_iter
        assert r.rounds <= r.lm_steps <= r.rounds * prm.lm_max_iter


def test_bf16_control_fails_the_tolerances(drive):
    cfg, calls, _, _ = drive
    prm = _params(cfg)
    for kps, prev, prior, _ in calls:
        with ego_check.bf16_ego():
            est, _ = pipeline._ego_registration(kps, prev, prior, cfg)
        g = ego_check.gaps(est, _reference(kps, prev, prior, prm).motion)
        assert g["trans_m"] > TRANS_TOL_M or g["rot_rad"] > ROT_TOL_RAD, g


def test_empty_previous_keypoints_give_the_prior():
    """A segment's first sweep: nothing to match, so the stage fails in its
    first round and returns the prior, as the reference does."""
    cfg = _config()
    gen = torch.Generator().manual_seed(20121)
    kps = []
    for i in range(3):
        K = cfg.extractor.kp_capacity(i)
        xyz = (torch.rand((K, 3), generator=gen) - 0.5) * 40.0
        kps.append(Keypoints(xyz=xyz, intensity=torch.zeros(K), time=torch.zeros(K),
                             ring=torch.randint(0, 16, (K,), generator=gen, dtype=torch.int32),
                             valid=torch.ones(K, dtype=torch.bool),
                             count=torch.tensor(K, dtype=torch.int32)))
    prev = tuple(Keypoints.empty(cfg.extractor.kp_capacity(i), "cpu") for i in range(3))
    prior = torch.tensor([0.2, -0.01, 0.003, 0.001, -0.002, 0.02])
    est, counts = pipeline._ego_registration(tuple(kps), prev, prior, cfg)
    assert torch.equal(est, prior)
    assert counts.tolist() == [1, cfg.ego_motion_lm_max_iter]
    r = _reference(kps, prev, prior, _params(cfg))
    assert r.failed and r.matches == 0 and (r.rounds, r.lm_steps) == (1, 15)
    assert torch.equal(r.motion, prior.double())


def _exact_scene(gen, n_per_patch):
    """Points on three flat patches (the ground, two walls) and on four
    vertical poles, each pole point on its own laser ring: every model the
    matcher fits there is exact. Returns (planes (n, 3), edges (m, 3),
    edge rings (m,)) in float64."""
    def patch(lo, hi, fixed_axis, value):
        u = lo + (hi - lo) * torch.rand((n_per_patch, 2), generator=gen, dtype=torch.float64)
        cols = [u[:, 0], u[:, 1]]
        cols.insert(fixed_axis, torch.full((n_per_patch,), value, dtype=torch.float64))
        return torch.stack(cols, dim=1)

    lo, hi = torch.tensor([-6.0, -6.0]), torch.tensor([6.0, 6.0])
    planes = torch.cat([patch(lo, hi, 2, -1.8),                        # ground
                        patch(torch.tensor([-5.0, -1.0]), torch.tensor([5.0, 3.0]), 0, 12.0),
                        patch(torch.tensor([-5.0, -1.0]), torch.tensor([5.0, 3.0]), 1, 11.0)])
    edges, rings = [], []
    for x, y in ((4.0, 5.0), (-5.0, 4.0), (5.0, -6.0), (-3.0, -7.0)):
        z = -1.5 + 0.25 * torch.arange(16, dtype=torch.float64)
        z = z + 0.2 * torch.rand(16, generator=gen, dtype=torch.float64)
        edges.append(torch.stack([torch.full_like(z, x), torch.full_like(z, y), z], dim=1))
        rings.append(torch.arange(16))
    return planes, torch.cat(edges), torch.cat(rings)


def test_reference_recovers_a_known_motion(drive):
    """The reference alone, on a scene where every model is exact: this
    sweep's keypoints, another sample of the same surfaces and poles seen
    from the moved sensor, come back to the known motion from an identity
    prior."""
    cfg, _, _, _ = drive
    gen = torch.Generator().manual_seed(7)
    prev_planes, prev_edges, prev_rings = _exact_scene(gen, 400)
    planes, edges, _ = _exact_scene(gen, 400)
    motion = torch.tensor([0.21, -0.04, 0.01, 0.004, -0.003, 0.03], dtype=torch.float64)
    R, t = ref.rotation(motion[3:6]), motion[:3]
    # x = R^T (y - t): world points seen from the moved sensor
    r = ref.register((edges - t) @ R, (planes - t) @ R, prev_edges, prev_rings, prev_planes,
                     torch.zeros(6), _params(cfg))
    assert not r.failed and r.matches > 1000
    assert float((r.motion - motion).abs().max()) < 1e-6


def test_reference_imports_nothing_of_the_port():
    """The reference imports torch alone: no kernel of the port, no JAX."""
    names = set()
    for node in ast.walk(ast.parse((ROOT / "slambench" / "ego_reference.py").read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"__future__", "typing", "torch"}
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_slam_keeps_the_stage_and_its_counts(drive):
    cfg, calls, slam, _ = drive
    _, _, prior, (est, counts) = calls[-1]
    assert np.array_equal(slam.ego_motion, est.numpy().astype(np.float64))
    assert np.array_equal(np.float32(slam.ego_prior), prior.numpy())
    assert [slam.ego_rounds, slam.ego_lm_steps] == counts.tolist()


def _traced(cfg, frames):
    slam = Slam(cfg, device="cpu")
    for f in frames[:3]:
        slam.add_frame(f)
    counts = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in frames[3:6]:
            slam.add_frame(f)
            counts.append((slam.ego_rounds, slam.ego_lm_steps))
    return traceread.from_profile(prof, sweeps=3, path="live",
                                  untraced_ms_per_sweep=1.0), counts


@pytest.mark.parametrize("mode", ["MOTION_EXTRAPOLATION", "MOTION_EXTRAPOLATION_AND_REGISTRATION"])
def test_count_spans_reach_the_readers(drive, mode):
    """The packed counts come back as spans under `slam.add_frame`; the
    benchmark's readers count them per sweep. No stage, no spans: None. On
    the CPU no marker kernel runs, so the device reader has nothing."""
    _, _, _, frames = drive
    t, counts = _traced(_config(EgoMotionMode[mode]), frames)
    rounds = spec.reader("ego_rounds_per_sweep.live")(t)
    steps = spec.reader("ego_lm_steps_per_sweep.live")(t)
    assert spec.reader("ego_device_ms_per_sweep.live")(t) is None
    if mode == "MOTION_EXTRAPOLATION":
        assert rounds is None and steps is None and set(counts) == {(0, 0)}
        return
    assert rounds == pytest.approx(sum(r for r, _ in counts) / 3)
    assert steps == pytest.approx(sum(s for _, s in counts) / 3)
    assert 1 <= rounds <= 4 and rounds <= steps <= 60


def test_device_marks_name_the_kernels():
    """The markers' names are kernels of csrc/knn.cu, the ones the device
    readers of their stage pair; off CUDA a mark does nothing."""
    src = (ROOT / "lidarslam_tpu_torch" / "csrc" / "knn.cu").read_text()
    metrics = ROOT / "slambench" / "metrics"
    readers = {"ego": ("ego_device_ms_per_sweep.py",),
               "extract": ("extract_device_ms_per_sweep.py", "extract_kernels_per_sweep.py")}
    for name in cuda_knn.MARKS:
        assert f'extern "C" __global__ void slam_mark_{name}()' in src
        for reader in readers[name.rsplit("_", 1)[0]]:
            assert f'"slam_mark_{name}"' in (metrics / reader).read_text()
    timer.device_mark("ego_begin", "cpu")
