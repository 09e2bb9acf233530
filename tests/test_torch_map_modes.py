"""Port parity: the CENTROID and CENTER_POINT leaf sampling, the doubling
segment scan under CENTROID and the map decay (`clear_old_points`) of the
PyTorch port against the JAX package, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarslam_tpu.config import MapConfig as JMapConfig
from lidarslam_tpu.config import SamplingMode as JSampling
from lidarslam_tpu.ops import prims as jprims
from lidarslam_tpu.ops import voxel_map as jvm
from lidarslam_tpu_torch.config import MapConfig as TMapConfig
from lidarslam_tpu_torch.config import SamplingMode as TSampling
from lidarslam_tpu_torch.ops import voxel_map as tvm
from test_torch_voxel_map import _assert_same, _batch, _cfgs

MODES = ["CENTROID", "CENTER_POINT"]


def _ties(rng, cfg, n):
    """n pairs of points mirrored through their leaf's center: both sit at
    exactly the same distance from it (CENTER_POINT ties)."""
    half = tvm.half_extent(cfg)
    leaf = cfg.leaf_size
    li = rng.integers(5, int(2 * half / leaf) - 5, (n, 3)).astype(np.float64)
    center = (li + 0.5) * leaf - half
    d = rng.uniform(-0.4, 0.4, (n, 3)) * leaf
    d = np.round(d * 64) / 64          # exact in float32, so the mirror is exact
    return np.concatenate([center + d, center - d]).astype(np.float32)


def _insert(jm, tm, jc, tc, xyz, inten, tim, val, stamp, fixed=False):
    jm = jvm.add_points(jm, jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(tim),
                        jnp.asarray(val), stamp, jc, fixed=fixed)
    tm = tvm.add_points(tm, torch.from_numpy(xyz), torch.from_numpy(inten),
                        torch.from_numpy(tim), torch.from_numpy(val), stamp, tc,
                        fixed=fixed)
    _assert_same(jm, tm)
    return jm, tm


@pytest.mark.parametrize("mode", MODES)
def test_add_points_bit_identical(mode):
    """Six roll + insert rounds: shared leaves within a batch, mirrored
    CENTER_POINT ties, a fixed batch, re-inserts into occupied leaves (the
    CENTROID blend) and a capacity small enough that the last rounds
    evict."""
    jc, tc = _cfgs(mode, 1024)
    rng = np.random.default_rng(MODES.index(mode) + 10)
    jm, tm = jvm.VoxelMap.empty(jc), tvm.VoxelMap.empty(tc, "cpu")
    prev, max_count = None, 0
    for r in range(6):
        xyz, inten, tim, val = _batch(rng, 700)
        xyz[:200] = _ties(rng, tc, 100)
        if prev is not None:           # land in leaves the map already holds
            xyz[200:400] = prev[:200] + rng.normal(0, 0.02, (200, 3)).astype(np.float32)
        prev = xyz.copy()
        off = rng.integers(-1, 2, 3).astype(np.int32)
        jm = jvm.roll_by_offset(jm, jnp.asarray(off), jc)
        tm = tvm.roll_by_offset(tm, torch.from_numpy(off), tc)
        prev -= off.astype(np.float32) * np.float32(tvm.effective_resolution(tc))
        _assert_same(jm, tm)
        jm, tm = _insert(jm, tm, jc, tc, xyz, inten, tim, val, float(r) + 0.5,
                         fixed=r == 1)
        max_count = max(max_count, int(tm.count.max()))
    assert int(jm.overflow) > 0          # eviction ran
    assert bool(np.asarray(jm.fixed).any())
    assert max_count > 1                 # leaves touched again


def test_center_point_keeps_the_point_nearest_the_leaf_center():
    _, tc = _cfgs("CENTER_POINT", 64)
    center = np.float32(0.15)          # the center of leaf [0, 0.3) of every axis
    pts = np.array([[0.29, 0.29, 0.29], [center + 0.01, center, center],
                    [0.01, 0.02, 0.03]], np.float32)
    m = tvm.add_points(tvm.VoxelMap.empty(tc, "cpu"), torch.from_numpy(pts),
                       torch.zeros(3), torch.zeros(3), torch.ones(3, dtype=torch.bool),
                       0.0, tc)
    assert int(m.valid.sum()) == 1
    np.testing.assert_array_equal(m.xyz[0].numpy(), pts[1])


def test_centroid_mean_and_blend():
    """A leaf's batch mean, then the old point blended with the next batch's
    mean as one more sample: (old * count + mean) / (count + 1)."""
    jc, tc = _cfgs("CENTROID", 64)
    a = np.array([[0.05, 0.05, 0.05], [0.25, 0.05, 0.15], [0.10, 0.20, 0.05]], np.float32)
    b = np.array([[0.20, 0.20, 0.20]], np.float32)
    one = np.ones(3, bool)
    jm, tm = jvm.VoxelMap.empty(jc), tvm.VoxelMap.empty(tc, "cpu")
    jm, tm = _insert(jm, tm, jc, tc, a, np.zeros(3, np.float32), np.zeros(3, np.float32),
                     one, 0.0)
    np.testing.assert_allclose(tm.xyz[0].numpy(), a.mean(0), rtol=1e-6)
    jm, tm = _insert(jm, tm, jc, tc, b, np.zeros(1, np.float32), np.zeros(1, np.float32),
                     one[:1], 1.0)
    np.testing.assert_allclose(tm.xyz[0].numpy(), (a.mean(0) + b[0]) / 2, rtol=1e-6)
    assert int(tm.count[0]) == 2


@pytest.mark.parametrize("n", [1, 7, 2048])
def test_rev_segment_scan_bit_identical(n):
    """Runs of every length up to n (sorted run ids, one tail run like the
    BIGKEY entries), values at map-coordinate magnitudes."""
    rng = np.random.default_rng(n)
    seg = np.sort(rng.integers(0, max(n // 3, 1), n)).astype(np.int32)
    xs = [rng.uniform(-120, 120, n).astype(np.float32) for _ in range(3)]
    want = jprims.rev_segment_scan(jnp.asarray(seg), [(jnp.asarray(x), jnp.add, 0.0)
                                                      for x in xs])
    got = tvm.rev_segment_scan(torch.from_numpy(seg), [torch.from_numpy(x) for x in xs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_clear_old_points_identical():
    """Ages on both sides of the threshold (and exactly at it), fixed points
    older than it, invalid slots."""
    kw = dict(leaf_size=0.3, capacity=512, grid_size=10, voxel_resolution=3.0,
              decaying_threshold=2.0)
    jc, tc = JMapConfig(**kw), TMapConfig(**kw)
    rng = np.random.default_rng(3)
    jm, tm = jvm.VoxelMap.empty(jc), tvm.VoxelMap.empty(tc, "cpu")
    for r in range(4):
        xyz, inten, tim, val = _batch(rng, 300)
        jm, tm = _insert(jm, tm, jc, tc, xyz, inten, tim, val, float(r), fixed=r == 0)
    for stamp in (3.0, 4.0, 5.5, np.float32(3.0000002)):
        jd = jvm.clear_old_points(jm, jnp.float32(stamp), jc)
        td = tvm.clear_old_points(tm, float(stamp), tc)
        _assert_same(jd, td)
        kept = td.valid.numpy()
        assert 0 < kept.sum() < tm.valid.numpy().sum() or stamp == 3.0
        assert (kept | ~(tm.valid.numpy() & tm.fixed.numpy())).all()   # fixed stay
