"""Multi-LiDAR in the PyTorch port against the JAX package, on the CPU:
`transform_keypoints` and `merge_keypoints` (over capacity too), the
two-LiDAR rig of tests/test_multilidar_debug.py through `Slam.add_frames` and
`add_frames_async` + `flush`. The heterogeneous 16+8-ring rig and the rules
by which both entry points delegate to the single-LiDAR ones are
tests/test_torch_multilidar_rig.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.core import se3 as jse3
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu.ops import frame as jframe
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.ops import frame as tframe
from test_multilidar_debug import _cfg as _split_jcfg
from test_multilidar_debug import _split_frame
from test_torch_native import jax_native_lib
from test_torch_slam import _one_torch_thread, _pose_err, _torch_config  # noqa: F401

N_FRAMES = 6            # acquisitions per run (the JAX tests take 8; 6 keep
                        # each file under a minute)
# The 8-sweep port tests' limits against JAX: 1e-4 m (sync) and 1e-3 m
# (stream), with n_matches within 1% on every frame. The rigs hold the
# merged keypoints bit-equal to JAX's on every frame. Measured over 6
# acquisitions (one torch thread): sync 1.96e-05 (split) and 8.01e-05 m
# (16+8 rig), stream 9.0e-06 and 1.11e-05 m, n_matches equal. (Over the
# JAX tests' 8 acquisitions a plane gate flip from float rounding, ROADMAP
# Queue 3 F3 / F4, moves the split rig's sync path 3.28e-04 m at frame 7.)
SYNC_M, STREAM_M = 1e-4, 1e-3
SPLIT_OFFSET = jse3.pose_to_hmat([0.5, 0.2, 0.1, 0.0, 0.0, 0.3])


def _keypoint_sets(rng, K, n_sets, p_valid):
    """n_sets random keypoint sets of capacity K, as (numpy fields, JAX
    Keypoints, port Keypoints)."""
    out = []
    for _ in range(n_sets):
        f = dict(xyz=rng.uniform(-20, 20, (K, 3)).astype(np.float32),
                 intensity=rng.uniform(0, 255, K).astype(np.float32),
                 time=rng.uniform(0, 0.1, K).astype(np.float32),
                 ring=rng.integers(0, 16, K).astype(np.int32),
                 valid=rng.uniform(size=K) < p_valid)
        f["count"] = np.int32(f["valid"].sum())
        out.append((f, jframe.Keypoints(**{k: jnp.asarray(v) for k, v in f.items()}),
                    tframe.Keypoints(**{k: torch.as_tensor(v) for k, v in f.items()})))
    return out


def test_transform_keypoints_matches_jax():
    """The calibration transform and the time rebase: times bit-equal,
    coordinates within float32 rounding of JAX's matmul."""
    (_, jk, tk), = _keypoint_sets(np.random.default_rng(0), 256, 1, 0.7)
    pose = np.array([0.4, 0.15, 0.05, 0.02, -0.01, 0.25])
    j = jframe.transform_keypoints(jk, jnp.asarray(pose, jnp.float32), 0.05)
    t = tframe.transform_keypoints(tk, torch.tensor(pose, dtype=torch.float32), 0.05)
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), rtol=0, atol=4e-6)
    np.testing.assert_array_equal(t.time.numpy(), np.asarray(j.time))
    for name in ("intensity", "ring", "valid", "count"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("capacity", [64, 96, 128])
def test_merge_keypoints_matches_jax(capacity):
    """Two sets of 64 slots with 46 and 35 valid: 81 valid slots truncated to
    64 (over capacity: the first set's 46, then the second's first 18), kept
    whole at 96 and 128. Every field of every slot bit-equal to JAX's."""
    sets = _keypoint_sets(np.random.default_rng(1), 64, 2, 0.65)
    assert [int(f["count"]) for f, _, _ in sets] == [46, 35]
    j = jframe.merge_keypoints([s[1] for s in sets], capacity)
    t = tframe.merge_keypoints([s[2] for s in sets], capacity)
    for name in jframe.Keypoints._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert int(t.count) == min(81, capacity)
    first = sets[0][0]
    np.testing.assert_array_equal(t.xyz.numpy()[:46], first["xyz"][first["valid"]])


def _drive(slam, acquisitions, stream, offset, merged=None):
    """The acquisitions through one path; `merged` collects each sync
    step's merged keypoints (numpy fields per type)."""
    slam.set_base_to_lidar_offset(1, offset)
    if not stream:
        out = []
        for a in acquisitions:
            out.append(slam.add_frames(a))
            if merged is not None:
                merged.append([{f: np.array(getattr(kp, f)) for f in kp._fields}
                               for kp in slam._device_keypoints])
        return out
    for a in acquisitions:
        assert slam.add_frames_async(a) >= 0
    return slam.flush()


@pytest.fixture(scope="module")
def split_runs():
    """tests/test_multilidar_debug.py's rig: one sweep split in two, the
    rear half seen by device 1 in its own frame, both on the default
    extractor; both packages on their native ingest."""
    jax_native_lib()
    frames = jsyn.generate_sequence(n_frames=N_FRAMES, motion_distortion=False)
    acq = [_split_frame(f, SPLIT_OFFSET) for f in frames]
    jcfg = _split_jcfg()
    out = {"frames": frames}
    out["jax_merged"], out["torch_merged"] = [], []
    for path in ("sync", "stream"):
        out["jax_" + path] = _drive(JSlam(jcfg), acq, path == "stream", SPLIT_OFFSET,
                                    out["jax_merged"])
        out["torch_" + path] = _drive(TSlam(_torch_config(jcfg), device="cpu"), acq,
                                      path == "stream", SPLIT_OFFSET, out["torch_merged"])
    return out


def check_merged(runs):
    """Every sync step's merged keypoints (each device's extraction, the
    calibration transform, the time rebase and the merge) bit-equal to JAX's."""
    assert len(runs["torch_merged"]) == len(runs["jax_merged"]) == N_FRAMES
    for i, (t, j) in enumerate(zip(runs["torch_merged"], runs["jax_merged"])):
        for ti, (a, b) in enumerate(zip(t, j)):
            for f in a:
                assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), (i, ti, f)


def check_rig(t, j, tol_m):
    """Poses within tol_m of JAX, n_matches within 1%, no failure."""
    assert len(t) == len(j) == N_FRAMES
    for i, (a, b) in enumerate(zip(t, j)):
        dt, dr = _pose_err(a["pose"], b["pose"])
        assert dt < tol_m and dr < 5.0, (i, dt, dr)
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * b["n_matches"], i
        assert a["failure"] == b["failure"] is False
        assert a["overlap"] == b["overlap"] == -1.0      # no range image, no overlap


@pytest.mark.parametrize("path, tol", [("sync", SYNC_M), ("stream", STREAM_M)])
def test_split_rig_matches_jax(split_runs, path, tol):
    """The split rig through add_frames / add_frames_async + flush against
    JAX's same path."""
    check_rig(split_runs["torch_" + path], split_runs["jax_" + path], tol)


def test_split_rig_merged_keypoints_bit_equal_to_jax(split_runs):
    check_merged(split_runs)
    assert int(split_runs["torch_merged"][-1][1]["count"]) == 1024  # planes at capacity


def test_split_rig_stream_matches_sync(split_runs):
    """The port's stream lands on its synchronous path (the JAX tests allow
    3 cm; measured below 1e-6 m)."""
    for a, b in zip(split_runs["torch_stream"], split_runs["torch_sync"]):
        assert np.linalg.norm(a["pose"][:3, 3] - b["pose"][:3, 3]) < 1e-4
