"""The heterogeneous rig of tests/test_multilidar_streaming.py (a 16-ring
LiDAR and an 8-ring one mounted at OFFSET, each with its own extractor)
through the PyTorch port's `Slam.add_frames` and `add_frames_async` +
`flush`, against the JAX package's same paths on the CPU; and the rules by
which both entry points delegate to the single-LiDAR ones."""

import numpy as np
import pytest

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.config import ExtractorConfig
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch import config as tcfg
from test_multilidar_streaming import OFFSET, _cfg, _two_sensor_sequences
from test_torch_multilidar import (N_FRAMES, STREAM_M, SYNC_M, _drive, check_merged,
                                   check_rig)
from test_torch_native import jax_native_lib
from test_torch_slam import _one_torch_thread, _torch_config  # noqa: F401


@pytest.fixture(scope="module")
def rig_runs():
    """Both packages on their native ingest."""
    jax_native_lib()
    f0, f1 = _two_sensor_sequences(N_FRAMES)
    acq = [[a, b] for a, b in zip(f0, f1)]
    jcfg = _cfg(device_extractors=(
        (1, ExtractorConfig(n_rings=8, max_ring_points=1024, max_keypoints=1024)),))
    out = {"jax_merged": [], "torch_merged": []}
    for path in ("sync", "stream"):
        out["jax_" + path] = _drive(JSlam(jcfg), acq, path == "stream", OFFSET,
                                    out["jax_merged"])
        out["torch_" + path] = _drive(TSlam(_torch_config(jcfg), device="cpu"), acq,
                                      path == "stream", OFFSET, out["torch_merged"])
    return out


def test_heterogeneous_rig_merged_keypoints_bit_equal_to_jax(rig_runs):
    check_merged(rig_runs)


@pytest.mark.parametrize("path, tol", [("sync", SYNC_M), ("stream", STREAM_M)])
def test_heterogeneous_rig_matches_jax(rig_runs, path, tol):
    """Each device extracted with its own ExtractorConfig and azimuthal
    resolution, merged in BASE: poses within tol of JAX, n_matches within
    1%, no failure."""
    check_rig(rig_runs["torch_" + path], rig_runs["jax_" + path], tol)


def test_heterogeneous_rig_stream_matches_sync(rig_runs):
    """The port's stream lands on its synchronous path (the JAX test allows
    3 cm; measured below 1e-6 m)."""
    for a, b in zip(rig_runs["torch_stream"], rig_runs["torch_sync"]):
        assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 1e-4


def test_add_frames_delegation_rules(monkeypatch):
    """add_frames: a lone frame of an uncalibrated device goes to add_frame
    (a calibrated one does not); add_frames_async: a lone uncalibrated
    frame on the default extractor goes to add_frame_async, but one from a
    device with its own ExtractorConfig keeps the keypoint path, whose 8-ring
    frames then run with that extractor (tests/test_multilidar_streaming.py)."""
    e8 = tcfg.ExtractorConfig(n_rings=8, max_ring_points=1024, max_keypoints=1024)
    cfg = _torch_config(_cfg())
    slam = TSlam(cfg, device="cpu")
    calls = []
    monkeypatch.setattr(slam, "add_frame", lambda f: calls.append("add_frame") or {})
    monkeypatch.setattr(slam, "add_frame_async", lambda f: calls.append("async") or 0)
    f0, f1 = _two_sensor_sequences(3)
    slam.add_frames([f0[0]])
    slam.add_frames_async([f0[0]])
    assert calls == ["add_frame", "async"]

    own = TSlam(cfg.replace(device_extractors=((1, e8),)), device="cpu")
    monkeypatch.setattr(own, "add_frame_async", lambda f: pytest.fail("delegated"))
    for f in f1:
        assert own.add_frames_async([f]) >= 0
    outs = own.flush()
    assert len(outs) == 3 and own.n_frames == 3
    assert not any(o["failure"] for o in outs[1:])

    calibrated = TSlam(cfg, device="cpu")
    calibrated.set_base_to_lidar_offset(0, np.eye(4))
    monkeypatch.setattr(calibrated, "add_frame", lambda f: pytest.fail("delegated"))
    r = calibrated.add_frames([f0[0]])
    assert r["failure"] is False and calibrated.n_frames == 1
