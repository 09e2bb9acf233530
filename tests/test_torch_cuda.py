"""Tests of the port that need an NVIDIA GPU (they skip without one).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest
"""

import functools

import numpy as np
import pytest
import torch

from lidarslam_tpu_torch import Slam
from lidarslam_tpu_torch.config import (ExtractorConfig, MapConfig, MatchingConfig,
                                        SlamConfig)
from lidarslam_tpu_torch.io import synthetic
from lidarslam_tpu_torch.ops import cuda_knn, stream_graph
from lidarslam_tpu_torch.ops import voxel_map as tvm

RADIUS = 5.0   # the matcher's neighbour gate, used as the kernel's prune radius


def knn_scene(seed=0, capacity=8192, q=256):
    """A leaf-key sorted map built from rendered sweeps (as on the path),
    with duplicated slots (exact distance ties) and invalid slots, plus
    noisy queries off another sweep, 30% of them dead."""
    rng = np.random.default_rng(seed)
    frames = synthetic.generate_sequence(
        n_frames=4, seed=seed, motion_distortion=False,
        sensor=synthetic.SensorModel(n_rings=16, n_azimuth=300))
    cfg = MapConfig(leaf_size=0.3, capacity=capacity, grid_size=20, voxel_resolution=5.0)
    m = tvm.VoxelMap.empty(cfg, "cpu")
    origin = frames[0]["gt_pose"][:3, 3]
    for f in frames[:3]:
        w = (f["xyz"] @ f["gt_pose"][:3, :3].T + f["gt_pose"][:3, 3] - origin)
        m = tvm.add_points(m, torch.from_numpy(w.astype(np.float32)),
                           torch.from_numpy(f["intensity"]), torch.zeros(len(w)),
                           torch.ones(len(w), dtype=torch.bool), 0.0, cfg)
    xyz = m.xyz.numpy().copy()
    valid = m.valid.numpy().copy()
    n = int(valid.sum())
    xyz[n - 40:n] = xyz[n - 80:n - 40]        # exact duplicates -> d2 ties
    valid[rng.choice(n, n // 20, replace=False)] = False
    f = frames[3]
    w = f["xyz"] @ f["gt_pose"][:3, :3].T + f["gt_pose"][:3, 3] - origin
    queries = (w[rng.choice(len(w), q, replace=False)]
               + rng.normal(0, 0.05, (q, 3))).astype(np.float32)
    queries[:8] = xyz[n - 80:n - 72]          # queries on the duplicated slots
    q_valid = rng.uniform(size=q) < 0.7
    return xyz, valid, queries, q_valid


@functools.lru_cache(maxsize=1)
def _scene():
    return knn_scene()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    xyz, valid, queries, q_valid = knn_scene()
    x, v = torch.from_numpy(xyz).to(cuda), torch.from_numpy(valid).to(cuda)
    q, qv = torch.from_numpy(queries).to(cuda), torch.from_numpy(q_valid).to(cuda)
    index = cuda_knn.prepare_map(x, v)
    for k in (1, 5, 10, 16):
        kd, ki, kn = cuda_knn.kernel_knn(index, q, k, None, qv)
        pd, pi, pn = cuda_knn.plain_knn(x, v, q, k, q_valid=qv)
        assert torch.equal(kd, pd) and torch.equal(ki, pi) and torch.equal(kn, pn)
        rd, ri, rn = cuda_knn.kernel_knn(index, q, k, RADIUS, qv)
        inside = torch.isfinite(pd) & (pd <= RADIUS ** 2)
        assert torch.equal(rd[inside], pd[inside]) and torch.equal(ri[inside], pi[inside])
        assert torch.equal(rn[inside], pn[inside])
        assert torch.isinf(rd[~qv]).all() and (ri[~qv] == 0).all()


def _queries_off(xyz, valid, q, seed):
    """q noisy queries around valid map slots, ~25% of them dead."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(np.flatnonzero(valid), q, replace=q > valid.sum())
    queries = (xyz[pick] + rng.normal(0, 0.3, (q, 3))).astype(np.float32)
    return queries, rng.uniform(size=q) < 0.75


def tie_scene(capacity=8192, q=2048, seed=0):
    """Integer-grid slots, each coordinate repeated in several sub-blocks
    far apart in slot order (so the copies land in different scan warps),
    and queries on grid points: many exactly equal d2."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-6, 7, (capacity // 8, 3)).astype(np.float32)
    xyz = np.concatenate([base[rng.permutation(len(base))] for _ in range(8)])
    valid = rng.uniform(size=capacity) < 0.9
    queries = (rng.integers(-6, 7, (q, 3)) + 0.5 * (rng.uniform(size=(q, 1)) < 0.3)
               ).astype(np.float32)
    return xyz, valid, queries, rng.uniform(size=q) < 0.8


def _check_kernel(cuda, xyz, valid, queries, q_valid, k, radius=RADIUS):
    """Kernel against plain_knn: bit-equal without pruning, equal within the
    prune radius, dead queries empty, valid slots only."""
    x, v = torch.from_numpy(xyz).to(cuda), torch.from_numpy(valid).to(cuda)
    q, qv = torch.from_numpy(queries).to(cuda), torch.from_numpy(q_valid).to(cuda)
    index = cuda_knn.prepare_map(x, v)
    kd, ki, kn = cuda_knn.kernel_knn(index, q, k, None, qv)
    pd, pi, pn = cuda_knn.plain_knn(x, v, q, k, q_valid=qv)
    assert torch.equal(kd, pd) and torch.equal(ki, pi) and torch.equal(kn, pn)
    rd, ri, rn = cuda_knn.kernel_knn(index, q, k, radius, qv)
    inside = torch.isfinite(pd) & (pd <= radius ** 2)
    assert torch.equal(rd[inside], pd[inside]) and torch.equal(ri[inside], pi[inside])
    assert torch.equal(rn[inside], pn[inside])
    assert torch.isinf(rd[~qv]).all() and (ri[~qv] == 0).all() and (rn[~qv] == 0).all()
    assert bool(v[ri[torch.isfinite(rd)].long()].all())
    return index, q, qv


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 10, 16])
@pytest.mark.parametrize("Q", [1, 31, 33, 2048, 4096])
def test_cuda_kernel_bit_equal_over_k_and_q(cuda, k, Q):
    xyz, valid, _, _ = _scene()
    queries, q_valid = _queries_off(xyz, valid, Q, seed=Q + k)
    _check_kernel(cuda, xyz, valid, queries, q_valid, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 10, 16])
def test_cuda_kernel_ties(cuda, k):
    _check_kernel(cuda, *tie_scene(), k, radius=2.0)


@pytest.mark.cuda
def test_cuda_kernel_empty_map_and_dead_queries(cuda):
    xyz, valid, queries, q_valid = _scene()
    for v, qv in ((np.zeros_like(valid), q_valid), (valid, np.zeros_like(q_valid))):
        index, q, qvt = _check_kernel(cuda, xyz, v, queries, qv, 5)
        d2, idx, nbr = cuda_knn.kernel_knn(index, q, 5, RADIUS, qvt)
        assert torch.isinf(d2).all() and (idx == 0).all() and (nbr == 0).all()


@pytest.mark.cuda
def test_cuda_plan_matches_plain_work_list(cuda):
    """The plan kernel's work lists are exactly the plain version's
    sub-blocks, in ascending order, and the prefix adds them up."""
    xyz, valid, _, _ = _scene()
    queries, q_valid = _queries_off(xyz, valid, 2048, seed=5)
    x, v = torch.from_numpy(xyz).to(cuda), torch.from_numpy(valid).to(cuda)
    q, qv = torch.from_numpy(queries).to(cuda), torch.from_numpy(q_valid).to(cuda)
    index = cuda_knn.prepare_map(x, v)
    order = cuda_knn.spatial_order(q, RADIUS, qv)
    for r2 in (RADIUS ** 2, float("inf")):
        run = cuda_knn.launch(index, q, qv, order, 10, r2)
        want = cuda_knn.plain_work_list(index, q, qv, order, r2)
        assert torch.equal(run.count, want.sum(1).to(torch.int32))
        assert int(run.start[0]) == 0
        assert torch.equal(run.start[1:], torch.cumsum(run.count, 0).to(torch.int32))
        for t in range(want.shape[0]):
            n = int(run.count[t])
            assert torch.equal(run.work[t, :n].long(), torch.nonzero(want[t])[:, 0])
        assigned = run.stats[:, 0]
        assert int(assigned.sum()) == int(run.start[-1])
        assert bool((run.stats[:, 1] <= assigned).all())


@pytest.mark.cuda
def test_cuda_kernel_repeated_launches_bit_identical(cuda):
    xyz, valid, queries, q_valid = tie_scene()
    index, q, qv = _check_kernel(cuda, xyz, valid, queries, q_valid, 10, radius=2.0)
    first = cuda_knn.kernel_knn(index, q, 10, 2.0, qv)
    for _ in range(10):
        again = cuda_knn.kernel_knn(index, q, 10, 2.0, qv)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_cuda_kernel_in_cuda_graph(cuda):
    """The four launches capture in a CUDA graph; a replay on new query
    values equals the eager call on them."""
    xyz, valid, _, _ = _scene()
    queries, q_valid = _queries_off(xyz, valid, 2048, seed=7)
    index, q, qv = _check_kernel(cuda, xyz, valid, queries, q_valid, 10)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_knn.kernel_knn(index, q, 10, RADIUS, qv)   # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_knn.kernel_knn(index, q, 10, RADIUS, qv)
    new_q, new_qv = _queries_off(xyz, valid, 2048, seed=8)
    q.copy_(torch.from_numpy(new_q))
    qv.copy_(torch.from_numpy(new_qv))
    graph.replay()
    eager = cuda_knn.kernel_knn(index, q, 10, RADIUS, qv)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.cuda
def test_cuda_kernels_count_their_executions(cuda):
    """Each kernel counts its own executions on the device: once per eager
    call and once per graph replay, and `reset_executions` clears them."""
    xyz, valid, _, _ = _scene()
    queries, q_valid = _queries_off(xyz, valid, 512, seed=9)
    index, q, qv = _check_kernel(cuda, xyz, valid, queries, q_valid, 5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_knn.kernel_knn(index, q, 5, RADIUS, qv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cuda_knn.kernel_knn(index, q, 5, RADIUS, qv)
    cuda_knn.reset_executions()
    assert cuda_knn.executions() == dict.fromkeys(cuda_knn.KERNELS, 0)
    for _ in range(3):
        cuda_knn.kernel_knn(index, q, 5, RADIUS, qv)
    for _ in range(4):
        graph.replay()
    assert cuda_knn.executions() == dict.fromkeys(cuda_knn.KERNELS, 7)


@pytest.mark.cuda
def test_cuda_wrapper_checks_inputs(cuda):
    x = torch.zeros(100, 3, device=cuda)
    v = torch.ones(100, dtype=torch.bool, device=cuda)
    index = cuda_knn.prepare_map(x, v)
    with pytest.raises(TypeError):
        cuda_knn.kernel_knn(index, torch.zeros(4, 3, dtype=torch.float64, device=cuda), 2)
    with pytest.raises(ValueError):
        cuda_knn.kernel_knn(index, torch.zeros(4, 3), 2)                     # CPU queries
    with pytest.raises(ValueError):
        cuda_knn.kernel_knn(index, torch.zeros(4, 3, device=cuda), cuda_knn.MAX_K + 1)


@pytest.mark.cuda
def test_cuda_slice_matches_cpu_slice(cuda):
    """The same small run on the card (kernel) and on the CPU (plain
    versions): the reference CI's pose tolerance, n_matches within 1%, and
    each k-NN kernel run twice per localized frame (on the card the live
    graph's warm-up steps and its capture call the wrapper, and its
    replays run the captured calls)."""
    cfg = SlamConfig(
        extractor=ExtractorConfig(n_rings=16, max_ring_points=1024, max_keypoints=1024),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 15, grid_size=26),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        loc_matching=MatchingConfig(reuse_knn=True))
    frames = synthetic.generate_sequence(
        n_frames=5, motion_distortion=False,
        sensor=synthetic.SensorModel(range_noise=0.005))
    gpu, cpu = Slam(cfg, device=cuda), Slam(cfg, device="cpu")
    torch.cuda.synchronize()
    cuda_knn.reset_executions()
    cuda_knn.LAUNCHES = 0
    rg = [gpu.add_frame(f) for f in frames]
    launches = cuda_knn.LAUNCHES
    executed = cuda_knn.executions()
    rc = [cpu.add_frame(f) for f in frames]
    assert launches == 2 * (1 + stream_graph.WARMUP_STEPS)
    assert executed == {k: 2 * (len(frames) - 1) for k in cuda_knn.KERNELS}
    for a, b in zip(rg, rc):
        assert not a["failure"] and not b["failure"]
        assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 0.01
        dR = b["pose"][:3, :3].T @ a["pose"][:3, :3]
        assert np.rad2deg(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 5.0
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * max(b["n_matches"], 1)


def _small_stream_cfg():
    return SlamConfig(
        extractor=ExtractorConfig(n_rings=16, max_ring_points=1024, max_keypoints=1024),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 15, grid_size=26),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        loc_matching=MatchingConfig(reuse_knn=True), stream_window=4)


def _stream(slam, frames, split):
    outs = []
    for i, f in enumerate(frames):
        if i == split:
            outs += slam.flush()
        assert slam.add_frame_async(f) == (i if split is None or i < split else i - split)
    return outs + slam.flush()


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 5])
def test_cuda_stream_replays_graph_and_matches_cpu(cuda, split):
    """The stream on the card (CUDA-graph replays) against the same stream
    on the CPU (eager), in one segment and across a flush: the second
    segment is seeded into the graph's own buffers (copy_, same storage)."""
    cfg = _small_stream_cfg()
    frames = synthetic.generate_sequence(
        n_frames=10, motion_distortion=False,
        sensor=synthetic.SensorModel(range_noise=0.005))
    gpu, cpu = Slam(cfg, device=cuda), Slam(cfg, device="cpu")
    if split is None:
        rg = _stream(gpu, frames, None)
    else:
        rg = _stream(gpu, frames[:split], None)
        g = gpu._graph
        ptrs = [t.data_ptr() for t in stream_graph._leaves(g.state)]
        rg += _stream(gpu, frames[split:], None)
        assert gpu._graph is g
        assert [t.data_ptr() for t in stream_graph._leaves(g.state)] == ptrs
    rc = _stream(cpu, frames, split)
    assert gpu._graph.graph is not None            # steady state was replayed
    assert len(rg) == len(rc) == len(frames)
    for a, b in zip(rg, rc):
        assert not a["failure"] and not b["failure"]
        assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 0.01
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * max(b["n_matches"], 1)


@pytest.mark.cuda
def test_cuda_kernel_overlap_and_ego_shapes(cuda):
    """The new call shapes of the path: the overlap's 1-NN (Q=8192, k=1,
    prune radius 2 m) against a leaf-sorted map, and the ego-motion k-NN
    (Q=2048, k=8, unpruned) against a 2048-slot index of keypoints in
    extraction order (not leaf order), slot indices included."""
    xyz, valid, _, _ = _scene()
    queries, q_valid = _queries_off(xyz, valid, 8192, seed=11)
    _check_kernel(cuda, xyz, valid, queries, q_valid, 1, radius=2.0)
    rng = np.random.default_rng(12)
    pick = rng.permutation(np.flatnonzero(valid))[:2048]
    kp_xyz = (xyz[pick] + rng.normal(0, 0.02, (2048, 3))).astype(np.float32)
    kp_valid = rng.uniform(size=2048) < 0.9
    queries, q_valid = _queries_off(kp_xyz, kp_valid, 2048, seed=13)
    x, v = torch.from_numpy(kp_xyz).to(cuda), torch.from_numpy(kp_valid).to(cuda)
    q, qv = torch.from_numpy(queries).to(cuda), torch.from_numpy(q_valid).to(cuda)
    got = cuda_knn.kernel_knn(cuda_knn.prepare_map(x, v), q, 8, None, qv)
    want = cuda_knn.plain_knn(x, v, q, 8, q_valid=qv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("reuse", [False, True])
def test_cuda_edge_matches_equal_plain(cuda, reuse, monkeypatch):
    """Localization edges on a slice-like map: the kernel path (unpruned)
    gives exactly the statuses, weights and A6 of the plain scan on the same
    card (the matcher's brute_knn swapped for plain_knn, so only the k-NN
    differs between the two runs)."""
    from lidarslam_tpu_torch.config import Keypoint
    from lidarslam_tpu_torch.core import se3
    from lidarslam_tpu_torch.ops import matcher

    xyz, valid, _, _ = _scene()
    queries, q_valid = _queries_off(xyz, valid, 2048, seed=14)
    params = MatchingConfig()
    view = tvm.SubmapView(xyz=torch.from_numpy(xyz).to(cuda), ring=None,
                          valid=torch.from_numpy(valid).to(cuda))
    q, qv = torch.from_numpy(queries).to(cuda), torch.from_numpy(q_valid).to(cuda)
    pose = torch.tensor([0.02, -0.01, 0.0, 0.002, 0.0, -0.003], device=cuda)
    prepared = tvm.prepare_knn_index(view)

    def run():
        knn = None
        if reuse:
            _, nbr, rings, found = matcher.knn_query(
                view, se3.japply_pose(pose + 0.01, q), params.edge_nb_neighbors,
                matcher.knn_radius(Keypoint.EDGE, params), qv, prepared)
            knn = (nbr, rings, found)
        return matcher.match_edges(q, qv, view, pose, params, prepared=prepared, knn=knn)

    radii, launch = [], cuda_knn.launch

    def recording(index, queries, q_valid, order, k, r2):
        radii.append(r2)
        return launch(index, queries, q_valid, order, k, r2)

    monkeypatch.setattr(cuda_knn, "launch", recording)
    kernel = run()
    assert radii == [float("inf")]                                  # unpruned
    monkeypatch.setattr(matcher, "brute_knn", lambda v, qq, k, prune_radius=None,
                        q_valid=None, prepared=None: cuda_knn.plain_knn(
                            v.xyz, v.valid, qq, k, q_valid=q_valid))
    plain = run()
    assert int(plain.n_matches) > 100
    for name in ("status", "A6", "P", "weight"):
        assert torch.equal(getattr(kernel, name), getattr(plain, name)), name


@pytest.mark.cuda
def test_cuda_full_pipeline_matches_cpu(cuda):
    """REFINED undistortion, ego registration, overlap and motion limits on
    the card against the CPU, through add_frame and through the stream."""
    from lidarslam_tpu_torch.config import (ConfidenceConfig, EgoMotionMode,
                                            UndistortionMode)

    cfg = _small_stream_cfg().replace(
        undistortion=UndistortionMode.REFINED,
        ego_motion_mode=EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION,
        confidence=ConfidenceConfig(overlap_sampling_ratio=0.25, time_window_duration=0.5,
                                    velocity_limits=(5.0, 45.0),
                                    acceleration_limits=(10.0, 90.0)))
    frames = synthetic.generate_sequence(
        n_frames=8, motion_distortion=True, sensor=synthetic.SensorModel(range_noise=0.005))
    runs = {}
    for name, dev in (("gpu", cuda), ("cpu", "cpu")):
        slam = Slam(cfg, device=dev)
        runs[name + "_sync"] = [slam.add_frame(f) for f in frames]
        runs[name + "_stream"] = _stream(Slam(cfg, device=dev), frames, None)
    for path in ("_sync", "_stream"):
        for a, b in zip(runs["gpu" + path], runs["cpu" + path]):
            assert not a["failure"] and not b["failure"]
            assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 0.01
            assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * max(b["n_matches"], 1)
            assert abs(a["overlap"] - b["overlap"]) < 1e-3
            assert a["comply_motion_limits"] == b["comply_motion_limits"]


def _ext_cfg(blobs):
    """The extended settings at the test size (tests/test_torch_blobs_sensors.py
    holds them against JAX on the CPU): a CENTROID plane map, an edge map on
    CENTER_POINT decaying after 0.35 s, both sensors; `blobs`: blobs on a
    CENTER_POINT blob map."""
    import dataclasses

    from lidarslam_tpu_torch.config import ConfidenceConfig, SamplingMode

    cfg = _small_stream_cfg().replace(
        stream_window=2,
        confidence=ConfidenceConfig(overlap_sampling_ratio=0.125, time_window_duration=0.5,
                                    velocity_limits=(5.0, 45.0),
                                    acceleration_limits=(10.0, 90.0)),
        wheel_odom_weight=1.0, wheel_odom_relative=True, imu_weight=0.5)
    cfg = cfg.replace(
        plane_map=dataclasses.replace(cfg.plane_map, sampling=SamplingMode.CENTROID),
        edge_map=dataclasses.replace(cfg.edge_map, sampling=SamplingMode.CENTER_POINT,
                                     decaying_threshold=0.35))
    if blobs:
        cfg = cfg.replace(use_blobs=True, blob_map=dataclasses.replace(
            cfg.blob_map, sampling=SamplingMode.CENTER_POINT))
    return cfg


def _ext_frames(n):
    import chip_smoke

    frames = synthetic.generate_sequence(
        n_frames=n, motion_distortion=True, sensor=synthetic.SensorModel(range_noise=0.005))
    return frames, chip_smoke.sensor_measurements(
        synthetic.straight_then_turn_trajectory(), 0.35)


@pytest.mark.cuda
def test_cuda_kernel_blob_shapes(cuda):
    """The blobs' two call shapes against a 0.30 m CENTER_POINT map: the
    localization query (Q=2048, k=10, pruned at the 5 m gate) and the
    overlap's 1-NN against the blob submap (Q=8192, k=1, pruned at 2 m)."""
    from lidarslam_tpu_torch.config import SamplingMode

    frames = synthetic.generate_sequence(
        n_frames=3, motion_distortion=False, sensor=synthetic.SensorModel(n_azimuth=900))
    cfg = MapConfig(leaf_size=0.3, capacity=1 << 15, grid_size=20, voxel_resolution=5.0,
                    sampling=SamplingMode.CENTER_POINT)
    m = tvm.VoxelMap.empty(cfg, cuda)
    origin = frames[0]["gt_pose"][:3, 3]
    for f in frames[:2]:
        w = f["xyz"] @ f["gt_pose"][:3, :3].T + f["gt_pose"][:3, 3] - origin
        m = tvm.add_points(m, torch.from_numpy(w.astype(np.float32)).to(cuda),
                           torch.from_numpy(f["intensity"]).to(cuda),
                           torch.zeros(len(w), device=cuda),
                           torch.ones(len(w), dtype=torch.bool, device=cuda), 0.0, cfg)
    xyz, valid = m.xyz.cpu().numpy(), m.valid.cpu().numpy()
    assert valid.sum() > 5000
    for q, k, radius, seed in ((2048, 10, RADIUS, 21), (8192, 1, 2.0, 22)):
        queries, q_valid = _queries_off(xyz, valid, q, seed=seed)
        _check_kernel(cuda, xyz, valid, queries, q_valid, k, radius=radius)


@pytest.mark.cuda
@pytest.mark.parametrize("blobs", [False, True])
def test_cuda_ext_pipeline_matches_cpu(cuda, blobs):
    """The extended settings on the card against the CPU, through add_frame
    and through the stream (windows whose records carry both sensor
    blocks, replayed by a graph holding both).
    Without blobs 8 sweeps within 0.01 m; with blobs the first localization
    from equal maps within 1e-3 m (the blob PCA gate reads rounding noise
    on 4 mm-planar neighbourhoods, and later sweeps amplify it, as between
    the JAX package and the port: tests/test_torch_blobs_sensors.py)."""
    cfg = _ext_cfg(blobs)
    frames, meas = _ext_frames(2 if blobs else 8)
    tol, flips = (1e-3, 0.03) if blobs else (0.01, 0.01)
    runs = {}
    for name, dev in (("gpu", cuda), ("cpu", "cpu")):
        for path in ("sync", "stream"):
            slam = Slam(cfg, device=dev)
            for t, d, a in zip(*meas):
                slam.add_wheel_odom_measurement(float(t), float(d))
                slam.add_gravity_measurement(float(t), a)
            if path == "sync":
                runs[name + path] = [slam.add_frame(f) for f in frames]
            else:
                runs[name + path] = _stream(slam, frames, None)
                if name == "gpu":
                    assert slam._graph.blocks == (True, True)
    for path in ("sync", "stream"):
        for a, b in zip(runs["gpu" + path], runs["cpu" + path]):
            assert not a["failure"] and not b["failure"]
            assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < tol
            assert abs(a["n_matches"] - b["n_matches"]) <= flips * max(b["n_matches"], 1)
            assert abs(a["overlap"] - b["overlap"]) < 1e-3
            assert a["comply_motion_limits"] == b["comply_motion_limits"]


def _split_rig(frame, offset):
    """tests/test_multilidar_debug.py's two-LiDAR split of one sweep."""
    from lidarslam_tpu_torch.core import se3

    xyz = frame["xyz"]
    front = xyz[:, 0] >= 0
    inv = se3.hmat_inverse(offset)
    f0 = {k: frame[k][front] for k in ("xyz", "intensity", "laser_id", "time")}
    f1 = {k: frame[k][~front] for k in ("intensity", "laser_id", "time")}
    f1["xyz"] = (xyz[~front] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    f0.update(stamp=frame["stamp"], device_id=0)
    f1.update(stamp=frame["stamp"] + 0.02, device_id=1)
    return [f0, f1]


@pytest.mark.cuda
def test_cuda_rig_matches_cpu(cuda):
    """A two-LiDAR rig (device 1 at a calibration offset, 20 ms later) on the
    card against the CPU, through add_frames and through add_frames_async
    + flush with a single sweep between acquisitions: each device's
    extraction and the rig's step replay as CUDA graphs, the step's graph
    sharing the segment's state with the sweep graph."""
    from lidarslam_tpu_torch.core import se3

    offset = se3.pose_to_hmat([0.5, 0.2, 0.1, 0.0, 0.0, 0.3])
    cfg = _small_stream_cfg()
    frames = synthetic.generate_sequence(
        n_frames=8, motion_distortion=False, sensor=synthetic.SensorModel(range_noise=0.005))
    runs = {}
    for name, dev in (("gpu", cuda), ("cpu", "cpu")):
        slam = Slam(cfg, device=dev)
        slam.set_base_to_lidar_offset(1, offset)
        runs[name + "_sync"] = [slam.add_frames(_split_rig(f, offset)) for f in frames]
        slam = Slam(cfg, device=dev)
        slam.set_base_to_lidar_offset(1, offset)
        for i, f in enumerate(frames):
            if i == 5:
                slam.add_frame_async(f)
            else:
                slam.add_frames_async(_split_rig(f, offset))
        runs[name + "_stream"] = slam.flush()
        if dev == cuda:
            assert slam._rig_graph.graph is not None
            assert slam._rig_graph.state is slam._graph.state
            assert all(g.graph is not None for g in slam._extract_graphs.values())
    for path in ("_sync", "_stream"):
        for a, b in zip(runs["gpu" + path], runs["cpu" + path]):
            assert not a["failure"] and not b["failure"]
            assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 0.01
            assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * max(b["n_matches"], 1)


@pytest.mark.cuda
def test_cuda_float_wire_stream_matches_cpu(cuda):
    """compress_upload=False on the card: the float sweeps go up as
    FloatRecords and replay in their own graph, against the CPU's eager
    float windows; one replay equals the eager step from the same state."""
    cfg = _small_stream_cfg().replace(compress_upload=False)
    frames = synthetic.generate_sequence(
        n_frames=10, motion_distortion=False, sensor=synthetic.SensorModel(range_noise=0.005))
    gpu = Slam(cfg, device=cuda)
    rg = _stream(gpu, frames, None)
    rc = _stream(Slam(cfg, device="cpu"), frames, None)
    assert isinstance(gpu._graph.wire, stream_graph.FloatRecord)
    assert gpu._graph.graph is not None
    for a, b in zip(rg, rc):
        assert not a["failure"] and not b["failure"]
        assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 0.01
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * max(b["n_matches"], 1)


@pytest.mark.cuda
def test_cuda_logged_keypoints_are_the_logs_own(cuda):
    """A DEVICE-tier log entry of add_frame and of a replayed stream
    sweep keeps its values while later frames and replays run."""
    cfg = _small_stream_cfg()
    frames = synthetic.generate_sequence(n_frames=12, motion_distortion=False)
    slam = Slam(cfg, device=cuda)
    slam.add_frame(frames[0])
    slam.add_frame(frames[1])
    for f in frames[2:7]:
        slam.add_frame_async(f)
    slam.flush()
    kept = [(e, [t.clone() for t in e]) for e in
            (slam.log_keypoints[1][k] for k in slam.cfg.used_types)]
    views = [(e, e._buf.clone()) for e in
             (slam.log_keypoints[6][k] for k in slam.cfg.used_types)]
    for f in frames[7:]:
        slam.add_frame_async(f)
    slam.flush()
    assert all(torch.equal(a, b) for e, c in kept for a, b in zip(e, c))
    assert all(torch.equal(e._buf, c) for e, c in views)


def _live_pair(cfg, cuda):
    """Two Slams on the card: one replays add_frame's step from the live
    graph, the other runs it op by op (the eager sync path)."""
    replay, eager = Slam(cfg, device=cuda), Slam(cfg, device=cuda)
    eager._frame_captured = lambda: False
    return replay, eager


def _same_sweep(replay, eager, a, b):
    assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 1e-5
    assert a["n_matches"] == b["n_matches"] and a["failure"] == b["failure"]
    assert np.array_equal(replay.match_counts, eager.match_counts)
    assert replay.kf_counter == eager.kf_counter


@pytest.mark.cuda
def test_cuda_add_frame_replays_the_live_graph(cuda):
    """add_frame replays its captured step after the first sweep and the
    warm-up steps, and holds to the eager sync path on the card: poses
    within 1e-5 m, the same keyframes and match counts (REFINED
    undistortion on distorted sweeps); the maps, keypoints and debug
    arrays read the same."""
    from lidarslam_tpu_torch.config import UndistortionMode

    cfg = _small_stream_cfg().replace(undistortion=UndistortionMode.REFINED)
    frames = synthetic.generate_sequence(
        n_frames=30, motion_distortion=True, sensor=synthetic.SensorModel(range_noise=0.005))
    replay, eager = _live_pair(cfg, cuda)
    for f in frames:
        _same_sweep(replay, eager, replay.add_frame(f), eager.add_frame(f))
    assert replay.live_replays == len(frames) - (1 + stream_graph.WARMUP_STEPS)
    assert replay._frame_graph.graph is not None
    assert eager._frame_graph is None and eager.live_replays == 0
    assert replay.kf_counter > 1
    for k in cfg.used_types:
        pa, pb = replay.get_map_points(k)[0], eager.get_map_points(k)[0]
        assert pa.shape == pb.shape and np.abs(pa - pb).max() < 1e-4
        np.testing.assert_allclose(replay.get_keypoints(k, world=True),
                                   eager.get_keypoints(k, world=True), atol=1e-4)
    da, db = replay.get_debug_array(), eager.get_debug_array()
    assert set(da) == set(db) and all(np.array_equal(da[n], db[n]) for n in da if "status" in n)


@pytest.mark.cuda
def test_cuda_live_graph_reseeds_and_recaptures(cuda, tmp_path):
    """The live graph against the eager sync path on the card through a
    stream segment and its flush, a reset with the maps loaded back from
    PCD (each state copied into the graph's buffers), and wheel odometry
    that starts mid-run (a block the graph lacks: captured anew)."""
    import chip_smoke

    frames = synthetic.generate_sequence(
        n_frames=30, motion_distortion=False, sensor=synthetic.SensorModel(range_noise=0.005))
    times, odo, _ = chip_smoke.sensor_measurements(synthetic.straight_then_turn_trajectory(),
                                                   3.1)
    replay, eager = _live_pair(_small_stream_cfg(), cuda)
    pair = (replay, eager)
    graphs, n_sync = [], 0
    for i, f in enumerate(frames):
        if 8 <= i < 12:       # a stream segment, flushed before sweep 12
            assert [s.add_frame_async(f) for s in pair] == [i - 8] * 2
            if i == 11:
                for a, b in zip(*(s.flush() for s in pair)):
                    _same_sweep(replay, eager, a, b)
            continue
        if i == 18:           # a reset, the maps loaded back, the pose given
            for s, name in ((replay, "replay_"), (eager, "eager_")):
                pose = s.get_world_transform()
                s.save_maps_to_pcd(str(tmp_path / name))
                s.reset()
                s.load_maps_from_pcd(str(tmp_path / name))
                s.set_world_transform_from_guess(pose)
        if i == 24:           # wheel odometry from here on
            for s in pair:
                s.set_wheel_odom_weight(1.0)
                for t, d in zip(times, odo):
                    s.add_wheel_odom_measurement(float(t), float(d))
        _same_sweep(replay, eager, replay.add_frame(f), eager.add_frame(f))
        n_sync += 1
        g = replay._frame_graph
        graphs.append(g)
        # the first sweep, and the one after the reset (which estimates the
        # azimuthal resolution anew), run eagerly; the others leave the
        # maps in the graph's buffers
        if i not in (0, 18):
            assert all(replay.maps[k] is g.state[0][int(k)] for k in replay.cfg.used_types)
    # sync sweeps 0-7 and 12-29; the odometer's first reading (sweep 24)
    # sets its origin, so the blocks arrive from sweep 25 (graphs[21])
    first, second = graphs[1], graphs[-1]
    assert all(g is first for g in graphs[1:21]) and first.blocks == (False, False)
    assert all(g is second for g in graphs[21:]) and second.blocks == (True, False)
    assert second.graph is not None and second.state is first.state
    assert replay.live_replays == n_sync - 2 - 2 * stream_graph.WARMUP_STEPS


def _pgo_graph(n=200, seed=7):
    """A drifting odometry chain with GPS every fifth pose (the recipe of
    tests/test_posegraph_device.py::_make_graph, without jax)."""
    from lidarslam_tpu_torch.core import se3

    rng = np.random.default_rng(seed)
    gt, noisy = [np.eye(4)], [np.eye(4)]
    step = np.eye(4)
    step[:3, :3] = se3.so3_exp([0, 0, 0.02])
    step[0, 3] = 1.0
    for _ in range(1, n):
        gt.append(gt[-1] @ step)
        nstep = step.copy()
        nstep[:3, 3] += rng.normal(0, 0.02, 3)
        nstep[:3, :3] = nstep[:3, :3] @ se3.so3_exp(rng.normal(0, 0.002, 3))
        noisy.append(noisy[-1] @ nstep)
    times = np.arange(n) * 0.1
    gps = np.stack([g[:3, 3] for g in gt[::5]]) + rng.normal(0, 0.01, (len(gt[::5]), 3))
    return noisy, times, [np.eye(6) * 1e-3] * n, gps, times[::5]


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 8])
def test_cuda_device_pgo_matches_cpu(cuda, segments):
    """The float64 PGO on the card (the block-LDL loop, and Schur over 8
    segments) against the same solve on the CPU and the numpy oracle."""
    from lidarslam_tpu_torch.backend import posegraph, posegraph_device

    noisy, times, covs, gps, gps_t = _pgo_graph()
    kw = dict(gps_positions=gps, gps_times=gps_t)
    on_card, c_card = posegraph_device.optimize_pose_graph_device(
        noisy, times, covs, **kw, n_segments=segments, device=cuda)
    on_cpu, c_cpu = posegraph_device.optimize_pose_graph_device(
        noisy, times, covs, **kw, n_segments=segments, device="cpu")
    oracle, _ = posegraph.optimize_pose_graph(noisy, times, covs, **kw)
    assert max(np.abs(a - b).max() for a, b in zip(on_card, on_cpu)) < 1e-8
    assert max(np.abs(a - b).max() for a, b in zip(on_card, oracle)) < 1e-5
    assert c_card == pytest.approx(c_cpu, rel=1e-9)


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_and_pgo(cuda, tmp_path):
    """A checkpoint written on the card after 5 sweeps, loaded into a fresh
    Slam on the card and continued, within 5e-3 m of the uninterrupted run;
    the same checkpoint continued on the CPU within 0.01 m; then PGO on the
    card against GPS from the ground truth, and a stream after it (seeded
    into the captured graph from the rebuilt maps) without a failure."""
    from lidarslam_tpu_torch.core import se3

    cfg = _small_stream_cfg()
    frames = synthetic.generate_sequence(n_frames=16, motion_distortion=False,
                                         sensor=synthetic.SensorModel(range_noise=0.005))
    a = Slam(cfg, device=cuda)
    for f in frames[:5]:
        a.add_frame(f)
    a.save_checkpoint(str(tmp_path / "s.npz"))
    ra = [a.add_frame(f) for f in frames[5:8]]
    for dev, tol in ((cuda, 5e-3), ("cpu", 0.01)):
        b = Slam(cfg, device=dev)
        b.load_checkpoint(str(tmp_path / "s.npz"))
        for x, f in zip(ra, frames[5:8]):
            y = b.add_frame(f)
            assert np.linalg.norm(x["pose"][:3, 3] - y["pose"][:3, 3]) < tol
    # a graph captured before the PGO is re-seeded after it
    for f in frames[8:12]:
        a.add_frame_async(f)
    a.flush()
    graph = a._graph
    assert graph.graph is not None
    gt0 = se3.hmat_inverse(frames[0]["gt_pose"])
    gps = np.stack([(gt0 @ f["gt_pose"])[:3, 3] for f in frames[:12]])
    assert a.execute_command(Slam.GPS_SLAM_POSE_GRAPH_OPTIMIZATION, gps_positions=gps,
                             gps_times=[f["stamp"] for f in frames[:12]],
                             use_device_backend=True)
    for f in frames[12:]:
        a.add_frame_async(f)
    outs = a.flush()
    assert a._graph is graph
    assert len(outs) == 4 and all(not o["failure"] for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("follow", [False, True])
def test_cuda_cli_run_matches_cpu(cuda, tmp_path, capsys, follow):
    """`cli run` on the card (no `--cpu`) against `--cpu` on the same 5
    synthetic sweeps, held by `cli compare` to the CI's 0.01 m / 5 deg;
    `extract`'s counts equal on both devices."""
    import json

    from lidarslam_tpu_torch import cli

    run = ["run", "--synthetic", "5", "--max-ring-points", "1024", "--max-keypoints", "1024"]
    run += ["--follow"] if follow else ["--aggregate", "--log-dir", str(tmp_path / "log")]
    assert cli.main(run + ["--out", str(tmp_path / "gpu")]) == 0
    assert cli.main(["--cpu", *run, "--out", str(tmp_path / "cpu")]) == 0
    capsys.readouterr()
    assert cli.main(["compare", "--res", str(tmp_path / "gpu"), "--ref", str(tmp_path / "cpu"),
                     "--time-threshold", "1e9"]) == 0
    cmp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cmp["success"] and cmp["n_compared"] == 5, cmp
    with capsys.disabled():
        print(f"\n[cli run{' --follow' if follow else ''}] card against --cpu on 5 synthetic "
              f"sweeps: {cmp['max_position_error_m']} m / {cmp['max_angle_error_deg']} deg")
    for dev in ([], ["--cpu"]):
        assert cli.main([*dev, "extract", "--synthetic", "2", "--blobs",
                         "--out", str(tmp_path / f"ext{len(dev)}")]) == 0
    got, want = ((tmp_path / f"ext{i}" / "extraction.json").read_text() for i in (0, 1))
    for g, w in zip(json.loads(got), json.loads(want)):
        assert abs(g.pop("azimuthal_resolution") - w.pop("azimuthal_resolution")) < 1e-6
        assert g == w


def _mesh_against_single(cuda, world, backend, modes, n=6):
    """`slam_modes` (tests/torch_mesh_ranks.py) on `world` ranks of
    `backend` on the card against a single-device run on the card: every
    rank's sync and stream poses within 1e-3 m, and the ranks bit-equal."""
    import torch_mesh_ranks as R
    from lidarslam_tpu_torch.parallel.launch import launch

    ranks = launch(R.slam_modes, world, backend=backend,
                   device="cuda:0" if backend == "gloo" else None, timeout_s=600,
                   args=(modes, n, n))
    single = Slam(R.small_config(), device=cuda)
    ref = R.pose_stack([single.add_frame(f) for f in R.golden(n)])
    for mode in modes:
        for res in ranks:
            got = res[mode]
            assert not any(got["failed"])
            assert R.pose_divergence(got["poses"], ref)[0] < R.POSE_M, mode
            assert R.pose_divergence(got["stream"], got["poses"])[0] < R.POSE_M, mode
            np.testing.assert_array_equal(got["poses"], ranks[0][mode]["poses"])


@pytest.mark.cuda
def test_cuda_mesh_gloo_two_ranks_share_the_card(cuda):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card): the
    collectives stage through pinned host memory, the k-NN runs on the
    card in each rank; both the keypoint-sharded and slab-sharded modes."""
    _mesh_against_single(cuda, 2, "gloo", ("kp", "maps"))


@pytest.mark.cuda
def test_cuda_mesh_nccl(cuda):
    """NCCL at the card count (capped at 4): world 1 on a one-card
    machine, whose collectives still go through NCCL."""
    _mesh_against_single(cuda, min(torch.cuda.device_count(), 4), "nccl", ("maps",))


MESH_STREAM_MODES = ("kp", "ext", "maps")


@pytest.mark.cuda
def test_cuda_mesh_nccl_stream_captured(cuda):
    """The NCCL mesh stream (world 1 on a one-card machine) replays a
    captured graph per sweep, keypoint-sharded, with `shard_extraction` and
    with `shard_maps`, and ends within 1e-6 m of the same stream run
    eagerly; a gloo mesh on the card streams eagerly."""
    import torch_mesh_ranks as R
    from lidarslam_tpu_torch.parallel.launch import launch

    world = min(torch.cuda.device_count(), 4)
    ranks = launch(R.captured_and_eager_streams, world, backend="nccl", timeout_s=600,
                   args=(MESH_STREAM_MODES, 12))
    for mode in MESH_STREAM_MODES:
        for res in ranks:
            graph, eager = res[mode][True], res[mode][False]
            assert graph["graph"] and not eager["graph"], mode
            assert not any(graph["failed"]) and not any(eager["failed"]), mode
            assert R.pose_divergence(graph["poses"], eager["poses"])[0] < 1e-6, mode
            np.testing.assert_array_equal(graph["poses"], ranks[0][mode][True]["poses"])
    gloo = launch(R.captured_and_eager_streams, 2, backend="gloo", device="cuda:0",
                  timeout_s=600, args=(("kp",), 4))
    assert not any(r["kp"][True]["graph"] for r in gloo)


@pytest.mark.cuda
def test_cuda_profile_readings_match_key_averages(cuda):
    """`utils/profiling` reads a torch.profiler profile's raw records: each
    device kernel and copy with the executions and device time torch's own
    `key_averages()` gives it, and their sum as device busy."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from lidarslam_tpu_torch.utils import profiling

    x = torch.randn(1 << 20, device=cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            (x * 2).sum().cpu()
            x.add_(1.0)
        torch.cuda.synchronize()
    dur, cnt, _ = profiling.op_totals(prof)
    want_ms, want_n = collections.Counter(), collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            want_ms[evt.key] += evt.self_device_time_total / 1000.0
            want_n[evt.key] += evt.count
    assert cnt == want_n and len(cnt) >= 3
    for name, ms in want_ms.items():
        assert dur[name] == pytest.approx(ms, rel=1e-6, abs=1e-6), name
    assert profiling.device_busy_ms(prof) == pytest.approx(sum(want_ms.values()), rel=1e-6)
