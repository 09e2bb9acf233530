"""Port parity: the rolling voxel map (PyTorch) against the JAX package —
insert, roll, eviction and submap selection, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarslam_tpu.config import MapConfig as JMapConfig
from lidarslam_tpu.config import SamplingMode as JSampling
from lidarslam_tpu.ops import voxel_map as jvm
from lidarslam_tpu_torch.config import MapConfig as TMapConfig
from lidarslam_tpu_torch.config import SamplingMode as TSampling
from lidarslam_tpu_torch.ops import voxel_map as tvm


def _cfgs(mode, capacity):
    kw = dict(leaf_size=0.3, capacity=capacity, grid_size=10, voxel_resolution=3.0)
    return (JMapConfig(sampling=JSampling[mode], **kw),
            TMapConfig(sampling=TSampling[mode], **kw))


def _assert_same(jm, tm):
    for f in jvm.VoxelMap._fields:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _batch(rng, K):
    xyz = rng.uniform(-16, 16, (K, 3)).astype(np.float32)
    xyz[::5] = xyz[1::5][:len(xyz[::5])] + 0.01     # shared leaves within a batch
    inten = rng.integers(0, 4, K).astype(np.float32)  # many intensity ties
    tim = rng.uniform(0, 1, K).astype(np.float32)
    val = rng.uniform(size=K) < 0.9
    return xyz, inten, tim, val


@pytest.mark.parametrize("mode", ["MAX_INTENSITY", "FIRST", "LAST"])
def test_roll_and_add_points_bit_identical(mode):
    """Five roll + insert rounds: leaf ties, intensity ties, a fixed batch,
    and a capacity small enough that the last rounds evict."""
    jc, tc = _cfgs(mode, 1024)
    rng = np.random.default_rng(["MAX_INTENSITY", "FIRST", "LAST"].index(mode))
    jm, tm = jvm.VoxelMap.empty(jc), tvm.VoxelMap.empty(tc, "cpu")
    for r in range(5):
        xyz, inten, tim, val = _batch(rng, 700)
        off = rng.integers(-1, 2, 3).astype(np.int32)
        jm = jvm.roll_by_offset(jm, jnp.asarray(off), jc)
        tm = tvm.roll_by_offset(tm, torch.from_numpy(off), tc)
        _assert_same(jm, tm)
        fixed = r == 1
        jm = jvm.add_points(jm, jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(tim),
                            jnp.asarray(val), float(r) + 0.5, jc, fixed=fixed)
        tm = tvm.add_points(tm, torch.from_numpy(xyz), torch.from_numpy(inten),
                            torch.from_numpy(tim), torch.from_numpy(val),
                            float(r) + 0.5, tc, fixed=fixed)
        _assert_same(jm, tm)
    assert int(jm.overflow) > 0          # eviction ran
    assert bool(np.asarray(jm.fixed).any())


def test_compute_roll_offset_identical():
    jc, tc = _cfgs("MAX_INTENSITY", 64)
    rng = np.random.default_rng(9)
    for _ in range(20):
        lo = rng.uniform(-40, 10, 3).astype(np.float32)
        hi = lo + rng.uniform(0, 30, 3).astype(np.float32)
        np.testing.assert_array_equal(
            tvm.compute_roll_offset(torch.from_numpy(lo), torch.from_numpy(hi), tc).numpy(),
            np.asarray(jvm.compute_roll_offset(jnp.asarray(lo), jnp.asarray(hi), jc)))


@pytest.mark.parametrize("min_frames", [0, 2])
def test_extract_submap_view_masks_equal(min_frames):
    kw = dict(leaf_size=0.3, capacity=2048, grid_size=10, voxel_resolution=3.0,
              min_frames_per_voxel=min_frames)
    jc, tc = JMapConfig(**kw), TMapConfig(**kw)
    rng = np.random.default_rng(4)
    jm, tm = jvm.VoxelMap.empty(jc), tvm.VoxelMap.empty(tc, "cpu")
    for r in range(3):
        xyz, inten, tim, val = _batch(rng, 600)
        jm = jvm.add_points(jm, jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(tim),
                            jnp.asarray(val), float(r), jc)
        tm = tvm.add_points(tm, torch.from_numpy(xyz), torch.from_numpy(inten),
                            torch.from_numpy(tim), torch.from_numpy(val), float(r), tc)
    for lo, hi, nmin in (((-5, -5, -5), (6, 4, 3), 10), ((-20, -20, -20), (20, 20, 20), 5000),
                         ((-1, -1, -1), (1, 1, 1), -1)):
        lo, hi = np.float32(lo), np.float32(hi)
        vj = jvm.extract_submap_view(jm, jnp.asarray(lo), jnp.asarray(hi),
                                     jnp.int32(nmin), jc)
        vt = tvm.extract_submap_view(tm, torch.from_numpy(lo), torch.from_numpy(hi),
                                     torch.tensor(nmin, dtype=torch.int32), tc)
        np.testing.assert_array_equal(vt.valid.numpy(), np.asarray(vj.valid))
        assert 0 < int(vt.valid.sum()) <= int(tm.valid.sum())
