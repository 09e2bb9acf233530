"""Keypoint logs and their five storage tiers in the PyTorch port against the
JAX package, on the CPU: every tier's store / restore / memory size, the
OCTREE, PCD and LZF bytes on the cases of tests/test_octree.py and
tests/test_pcd_compressed.py, the log a Slam keeps on both paths and in
every tier, its timeout pruning, `get_log_memory_usage`, and a logged frame
that stays as it was when the next frame runs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import LoggingStorage as JStorage
from lidarslam_tpu.io import lzf as jlzf
from lidarslam_tpu.io import octree as joctree
from lidarslam_tpu.io import pcd as jpcd
from lidarslam_tpu.io import storage as jstorage
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu.ops import frame as jframe
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.config import Keypoint as TKeypoint
from lidarslam_tpu_torch.config import LoggingStorage as TStorage
from lidarslam_tpu_torch.io import lzf as tlzf
from lidarslam_tpu_torch.io import octree as toctree
from lidarslam_tpu_torch.io import pcd as tpcd
from lidarslam_tpu_torch.io import storage as tstorage
from lidarslam_tpu_torch.ops import frame as tframe
from test_slam_e2e import small_config
from test_torch_native import jax_native_lib
from test_torch_slam import _one_torch_thread, _torch_config  # noqa: F401

TIERS = ("DEVICE", "HOST", "COMPRESSED", "OCTREE", "DISK")
N_FRAMES = 3


def _log_jcfg():
    """small_config narrowed for the log runs: 16 rings x 512 firings, 256
    keypoints a type, 8,192-slot maps, windows of 2."""
    cfg = small_config()
    return cfg.replace(
        extractor=dataclasses.replace(cfg.extractor, max_ring_points=512, max_keypoints=256),
        edge_map=dataclasses.replace(cfg.edge_map, capacity=1 << 13),
        plane_map=dataclasses.replace(cfg.plane_map, capacity=1 << 13),
        blob_map=dataclasses.replace(cfg.blob_map, capacity=1 << 13), stream_window=2)


def _frames(n):
    return jsyn.generate_sequence(n_frames=n, motion_distortion=False,
                                  sensor=jsyn.SensorModel(n_azimuth=500, range_noise=0.005))


def _keypoints(rng, K=300, n=217):
    """One keypoint set of capacity K with n valid slots, in both packages."""
    f = dict(xyz=rng.uniform(-30, 30, (K, 3)).astype(np.float32),
             intensity=rng.uniform(0, 300, K).astype(np.float32),
             time=rng.uniform(0, 0.1, K).astype(np.float32),
             ring=rng.integers(0, 300, K).astype(np.int32),
             valid=np.arange(K) < n, count=np.int32(n))
    return (jframe.Keypoints(**{k: jnp.asarray(v) for k, v in f.items()}),
            tframe.Keypoints(**{k: torch.as_tensor(v) for k, v in f.items()}))


def _equal_clouds(a, b):
    assert type(a).__name__ == type(b).__name__ == "HostCloud"
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("source", ["keypoints", "view"])
@pytest.mark.parametrize("tier", TIERS)
def test_store_restore_every_tier_equal_to_jax(tmp_path, tier, source):
    """Each tier stores a keypoint set (or a stream's flat-buffer view of
    one) and restores it to the same host arrays as JAX's, with the same
    memory size; OCTREE blobs and DISK files byte for byte."""
    jk, tk = _keypoints(np.random.default_rng(3))
    if source == "view":
        jk = jframe.KeypointsView(jframe.flatten_keypoints(jk))
        tk = tframe.KeypointsView(tframe.flatten_keypoints(tk))
    j = jstorage.store(jk, JStorage[tier], directory=str(tmp_path / "j"), tag="000001_edge")
    t = tstorage.store(tk, TStorage[tier], directory=str(tmp_path / "t"), tag="000001_edge")
    _equal_clouds(tstorage.restore(t), jstorage.restore(j))
    assert tstorage.memory_size(t) == jstorage.memory_size(j)
    if tier == "DEVICE" and source == "keypoints":
        assert all(isinstance(a, torch.Tensor) for a in t)
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(t, tk) if a.numel())
    if tier == "OCTREE":
        assert t.blob == j.blob
    if tier == "DISK":
        assert open(t.path, "rb").read() == open(j.path, "rb").read()


@pytest.mark.parametrize("case", ["n0", "n1", "n7", "n5000", "duplicates", "coherent"])
def test_octree_bytes_equal_jax(case):
    """tests/test_octree.py's clouds: the port's blob is JAX's, and decodes
    to the same arrays."""
    rng = np.random.default_rng(int(case[1:]) if case.startswith("n") else 3)
    if case.startswith("n"):
        n = int(case[1:])
        xyz = rng.uniform(-40, 40, size=(n, 3))
        kw = dict(intensity=rng.uniform(0, 200, size=n).astype(np.float32),
                  time=rng.uniform(-0.05, 0.05, size=n).astype(np.float32),
                  ring=rng.integers(0, 64, size=n).astype(np.int32))
    elif case == "duplicates":
        xyz = np.concatenate([np.zeros((300, 3)) + [1.0, 2.0, 3.0], [[5.0, 5.0, 5.0]]])
        kw = {}
    else:
        t = np.linspace(0, 60, 20000)
        xyz = np.stack([t, 3 * np.sin(t * 0.3), 0.05 * t], 1)
        xyz += rng.normal(scale=0.15, size=xyz.shape)
        kw = dict(intensity=rng.uniform(0, 100, len(xyz)).astype(np.float32),
                  time=np.linspace(0, 0.1, len(xyz)).astype(np.float32),
                  ring=(np.arange(len(xyz)) % 16).astype(np.int32))
    a, b = toctree.encode(xyz, **kw), joctree.encode(xyz, **kw)
    assert a.blob == b.blob and a.n == b.n
    da, db = toctree.decode(a), joctree.decode(b)
    for k in db:
        assert np.array_equal(da[k], db[k]), k


@pytest.mark.parametrize("n", [0, 1, 5, 1000, 65537, "structured"])
def test_lzf_bytes_equal_jax(n):
    """tests/test_pcd_compressed.py's streams: the port's LZF (native build
    and pure-Python encoder) writes JAX's bytes, and both decoders read them."""
    if n == "structured":
        data = b"\x01\x02\x03\x04" * 5000
    else:
        rng = np.random.default_rng(n)
        data = (rng.integers(0, 4, n // 2, dtype=np.uint8).tobytes()
                + rng.integers(0, 256, n - n // 2, dtype=np.uint8).tobytes())
    comp = tlzf.compress(data)
    assert comp == jlzf.compress(data)
    assert tlzf._compress_py(data) == jlzf._compress_py(data)
    assert tlzf.decompress(comp, len(data)) == data
    assert tlzf._decompress_py(comp, len(data)) == data
    assert tlzf.decompress(b"\x00a\xc0\x00", 9) == b"a" * 9
    assert tlzf.decompress(b"\x00b\xe0\x03\x00", 13) == b"b" * 13


@pytest.mark.parametrize("encoding", ["ascii", "binary", "binary_compressed", "fields"])
def test_pcd_bytes_equal_jax(tmp_path, encoding):
    """tests/test_pcd_compressed.py's clouds written by both packages: the
    same file, byte for byte, read back to the same fields."""
    rng = np.random.default_rng(0)
    n = 1234
    xyz = rng.normal(0, 10, (n, 3)).astype(np.float32)
    kw = dict(intensity=rng.uniform(0, 255, n).astype(np.float32),
              time=rng.uniform(0, 0.1, n).astype(np.float64),
              laser_id=rng.integers(0, 16, n).astype(np.uint16),
              label=rng.integers(0, 2, n).astype(np.uint8))
    paths = [tmp_path / "t.pcd", tmp_path / "j.pcd"]
    for mod, p in zip((tpcd, jpcd), paths):
        if encoding == "fields":
            mod.save_pcd_fields(p, xyz[:77], extra={"curvature": kw["intensity"][:77]},
                                compressed=True)
        else:
            mod.save_pcd(p, xyz, **kw, binary=encoding != "ascii",
                         compressed=encoding == "binary_compressed")
    assert paths[0].read_bytes() == paths[1].read_bytes()
    a, b = tpcd.load_pcd(paths[0]), jpcd.load_pcd(paths[1])
    assert a.keys() == b.keys()
    for k in b:
        assert np.array_equal(a[k], b[k]), k


def _run(slam, frames, stream):
    if stream:
        for f in frames:
            slam.add_frame_async(f)
        slam.flush()
    else:
        for f in frames:
            slam.add_frame(f)
    return slam


@pytest.fixture(scope="module")
def jax_logs():
    """JAX's keypoint log on both paths (DEVICE tier) over N_FRAMES sweeps;
    both packages on their native ingest."""
    jax_native_lib()
    frames = _frames(N_FRAMES)
    jcfg = _log_jcfg()
    return frames, jcfg, {p: _run(JSlam(jcfg), frames, p == "stream")
                          for p in ("sync", "stream")}


@pytest.mark.parametrize("path", ["sync", "stream"])
@pytest.mark.parametrize("tier", TIERS)
def test_keypoint_log_equal_to_jax(tmp_path, jax_logs, path, tier):
    """With logging_timeout=-1 the port logs every frame's keypoints in the
    configured tier: each entry restores to JAX's (its DEVICE entry put
    through the same tier), and get_log_memory_usage equals JAX's."""
    frames, jcfg, runs = jax_logs
    js = runs[path]
    cfg = dataclasses.replace(_torch_config(jcfg), logging_storage=TStorage[tier],
                              logging_dir=str(tmp_path / "t"))
    ts = _run(TSlam(cfg, device="cpu"), frames, path == "stream")
    assert len(ts.log_keypoints) == len(js.log_keypoints) == N_FRAMES
    jmem = {"ram": 0, "disk": 0, "device": 0}
    for i, (te, je) in enumerate(zip(ts.log_keypoints, js.log_keypoints)):
        assert sorted(te) == [TKeypoint(int(k)) for k in sorted(je)]
        for k in je:
            j = jstorage.store(je[k], JStorage[tier], directory=str(tmp_path / "j"),
                               tag=f"{i:06d}_{k.name.lower()}")
            for name, b in jstorage.memory_size(j).items():
                jmem[name] += b
            _equal_clouds(tstorage.restore(te[TKeypoint(int(k))]), jstorage.restore(j))
    assert ts.get_log_memory_usage() == {**jmem, "n_frames": N_FRAMES}
    if tier == "DEVICE":
        assert ts.get_log_memory_usage() == js.get_log_memory_usage()


def test_logging_timeout_prunes_both_logs():
    """logging_timeout > 0 drops entries older than the timeout from the
    trajectory and the keypoint log together, keeping at least two
    (Slam::LogCurrentFrameState); 0 keeps two poses and no keypoints."""
    frames = _frames(4)
    cfg = _torch_config(_log_jcfg())
    ts = _run(TSlam(dataclasses.replace(cfg, logging_timeout=0.15), device="cpu"), frames,
              False)
    assert [e["time"] for e in ts.log_trajectory] == [f["stamp"] for f in frames[2:]]
    assert len(ts.log_keypoints) == 2
    ts = _run(TSlam(dataclasses.replace(cfg, logging_timeout=0.0), device="cpu"), frames,
              False)
    assert len(ts.log_trajectory) == 2 and ts.log_keypoints == []


def test_logged_frame_unchanged_by_the_next_frame():
    """A DEVICE-tier entry holds tensors of its own: after more frames (and
    a flush of a stream segment) its values are the ones logged."""
    frames = _frames(4)
    ts = TSlam(_torch_config(_log_jcfg()), device="cpu")
    ts.add_frame(frames[0])
    ts.add_frame(frames[1])
    entry = ts.log_keypoints[1][TKeypoint.EDGE]
    kept = [a.clone() for a in entry]
    live = ts._device_keypoints[int(TKeypoint.EDGE)]
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(entry, live))
    ts.add_frame(frames[2])
    for f in frames[3:]:
        ts.add_frame_async(f)
    ts.flush()
    assert all(torch.equal(a, b) for a, b in zip(entry, kept))
    assert not torch.equal(ts.log_keypoints[2][TKeypoint.EDGE].xyz, entry.xyz)
