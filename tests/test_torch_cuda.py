"""Tests of the port that need an NVIDIA GPU (they skip without one).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest
"""

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
    two kernel launches per localized frame."""
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
    cuda_knn.LAUNCHES = 0
    rg = [gpu.add_frame(f) for f in frames]
    launches = cuda_knn.LAUNCHES
    rc = [cpu.add_frame(f) for f in frames]
    assert launches == 2 * (len(frames) - 1)
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
