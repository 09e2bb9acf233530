"""The port's mesh stream (`Slam(cfg, mesh=...).add_frame_async` +
`flush`) on 4 gloo CPU ranks against the JAX package's mesh stream on its
make_mesh(4) CPU devices (each window one sharded dispatch there), one
mode a file: keypoint-sharded here; tests/test_torch_mesh_stream_maps.py
and tests/test_torch_mesh_stream_extraction.py import these tests for
`shard_maps` and `shard_extraction` (`MODE`). The JAX stream compiles its
own programs, so these runs live apart from tests/test_torch_mesh_slam.py's
to keep each file under a minute.

On 9 golden sweeps (the first, then one full window): every rank's poses
within 1e-3 m / 0.01 deg of JAX's mesh stream, 0 failed frames, the ranks
bit-equal, and one streaming step on the mesh with every Python-level host
read of a tensor refused (the step an NCCL mesh captures as a CUDA graph,
its roll in the captured loop; on the card chip_smoke.py's phase 11
replays it)."""

import numpy as np
import pytest

import torch_mesh_ranks as R
from test_torch_mesh_slam import WORLD, _config
from test_torch_parallel import _jax_config
from test_torch_slam import _one_torch_thread  # noqa: F401

MODE = "kp"
# the first sweep, then one full window of stream_window (8): the JAX
# package compiles its first-frame step and its window program
N_FRAMES = 9


def _jax_mesh_stream(mode):
    from lidarslam_tpu.parallel import sharded
    from lidarslam_tpu.slam import Slam as JSlam
    from test_multichip import _golden

    slam = JSlam(_jax_config(_config(mode)), mesh=sharded.make_mesh(WORLD), **R.MODES[mode])
    for f in _golden(N_FRAMES):
        slam.add_frame_async(f)
    return R.pose_stack(slam.flush())


@pytest.fixture(scope="module")
def streams(request):
    """(the ranks' `mesh_stream` results, JAX's mesh stream poses) for the
    importing module's MODE."""
    mode = request.module.MODE
    return R.launch_beside(R.mesh_stream, WORLD, (mode, N_FRAMES),
                           lambda: _jax_mesh_stream(mode))


def test_mesh_stream_matches_jax_mesh_stream(streams):
    ranks, jax_poses = streams
    assert not any(ranks[0]["failed"])
    dt, ang = R.pose_divergence(ranks[0]["poses"], jax_poses)
    assert dt < R.POSE_M and ang < R.POSE_DEG, (dt, ang)


def test_mesh_stream_ranks_bit_equal(streams):
    ranks, _ = streams
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["poses"], ranks[0]["poses"])


def test_mesh_stream_step_reads_nothing_on_host(streams):
    """No rank's SPMD streaming step reads a tensor on the host, and the
    step still matches."""
    ranks, _ = streams
    for res in ranks:
        assert res["host_read"] is None, res["host_read"]
        assert res["total"] > 100


@pytest.mark.parametrize("device,backend,captured", [
    ("cuda", None, True), ("cuda", "nccl", True), ("cuda", "gloo", False),
    ("cpu", None, False), ("cpu", "gloo", False)])
def test_slam_captures_the_stream_on_a_card_alone_or_on_nccl(device, backend, captured):
    """Which streams `Slam` replays as CUDA graphs: on a card alone or on
    an NCCL mesh; a gloo mesh and the CPU step eagerly."""
    from types import SimpleNamespace

    import torch

    from lidarslam_tpu_torch import Slam

    mesh = None if backend is None else SimpleNamespace(backend=backend)
    fake = SimpleNamespace(device=torch.device(device), mesh=mesh)
    assert Slam._stream_captured(fake) is captured
