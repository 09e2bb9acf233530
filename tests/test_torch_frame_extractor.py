"""Port parity: the sweep wire, index selection and keypoint extraction
(PyTorch) against the JAX package on the same sweeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarslam_tpu.config import ExtractorConfig as JExtractorConfig
from lidarslam_tpu.io import native
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu.ops import extractor as jext
from lidarslam_tpu.ops import frame as jframe
from lidarslam_tpu.ops import prims as jprims
from lidarslam_tpu_torch.io import native as tnative
from lidarslam_tpu_torch.config import ExtractorConfig as TExtractorConfig
from lidarslam_tpu_torch.ops import extractor as text
from lidarslam_tpu_torch.ops import frame as tframe
from lidarslam_tpu_torch.ops import prims as tprims


@pytest.fixture
def numpy_ingest(monkeypatch):
    """Both packages on their numpy ingest (the native C++ one rounds a few
    quantized coordinates differently, ROADMAP Queue 3, F5)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _sweep(rings, azimuth, seed):
    sensor = jsyn.SensorModel(n_rings=rings, n_azimuth=azimuth, range_noise=0.01)
    return jsyn.generate_sequence(n_frames=1, sensor=sensor, seed=seed,
                                  motion_distortion=False)[0]


def test_byte_wire_unpack_bit_identical(numpy_ingest):
    f = _sweep(16, 300, 1)
    C = 512
    jb = jframe.build_range_image(f["xyz"], f["intensity"], f["laser_id"],
                                  f["time"], 16, C, packed=True)
    tb = tframe.build_range_image(f["xyz"], f["intensity"], f["laser_id"],
                                  f["time"], 16, C, packed=True)
    np.testing.assert_array_equal(tb.buf.numpy(), np.asarray(jb.buf))
    rj = jb.unpack()
    rt = tframe.ByteRangeImage(torch.from_numpy(np.asarray(jb.buf).copy()),
                               jb.shape).unpack()
    for name in tframe.RangeImage._fields:
        a, b = np.asarray(getattr(rj, name)), getattr(rt, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert tframe.estimate_azimuthal_resolution(rt) == \
        jframe.estimate_azimuthal_resolution(rj)


@pytest.mark.parametrize("shape,density", [((8, 96), 0.3), ((1000,), 0.5)])
@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_spread_k_indices_identical(shape, density, where):
    rng = np.random.default_rng(len(shape))
    mask = rng.uniform(size=shape) < density
    n = int(mask.sum())
    capacity = {"below": n + 17, "at": n, "above": max(n * 2 // 3, 1)}[where]
    ij, cj = jax.jit(jprims.spread_k_indices, static_argnums=1)(jnp.asarray(mask),
                                                                 capacity)
    it, ct = tprims.spread_k_indices(torch.from_numpy(mask), capacity)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(ct) == int(cj)
    if where == "above":
        assert int(ct) <= capacity < n


@pytest.mark.parametrize("rings,azimuth,cap", [(16, 500, 384), (64, 200, 512)])
def test_extract_keypoints_identical(rings, azimuth, cap, numpy_ingest):
    """Edge and plane sets equal slot for slot (xyz, ring, count, ...) —
    including the even thinning past capacity."""
    f = _sweep(rings, azimuth, 3)
    C = 1 << (azimuth - 1).bit_length()
    kw = dict(n_rings=rings, max_ring_points=C, max_keypoints=cap)
    jb = jframe.build_range_image(f["xyz"], f["intensity"], f["laser_id"],
                                  f["time"], rings, C, packed=True)
    rj = jb.unpack()
    rt = tframe.ByteRangeImage(torch.from_numpy(np.asarray(jb.buf).copy()),
                               jb.shape).unpack()
    az = np.float32(jframe.estimate_azimuthal_resolution(rj))
    ej = jax.jit(jext.extract_keypoints, static_argnums=2)(
        rj, jnp.float32(az), JExtractorConfig(**kw))
    et = text.extract_keypoints(rt, float(az), TExtractorConfig(**kw))
    for name in ("edges", "planes", "blobs"):
        kj, kt = getattr(ej, name), getattr(et, name)
        assert int(kj.count) > 20, name
        for field in tframe.Keypoints._fields:
            np.testing.assert_array_equal(getattr(kt, field).numpy(),
                                          np.asarray(getattr(kj, field)),
                                          err_msg=f"{name}.{field}")
    assert int(ej.planes.count) == cap     # the saturated, thinned branch ran
