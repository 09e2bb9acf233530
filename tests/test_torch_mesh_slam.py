"""`Slam(cfg, mesh=...)` of the port on 4 gloo CPU ranks, keypoint-sharded
with replicated maps: the counterpart of tests/test_multichip.py's
keypoint-sharded runs. tests/test_torch_mesh_maps.py and
tests/test_torch_mesh_extraction.py import these tests for the other two
modes (`MODE`), one mode a file so each file's JAX compiles fit its time.

On 15 golden sweeps (8 with ring-sharded extraction): every rank's poses within 1e-3 m / 0.01 deg of the
port's single-device run and of the JAX package's mesh run (make_mesh(4)
on its CPU devices), n_matches and map sizes within max(10, 2%) of the
single-device run, the stream on the mesh within 1e-3 m of the sync path
on the mesh, the ranks bit-equal, the debug arrays reassembled. The ranks
run tests/torch_mesh_ranks.py::slam_modes once for the file, beside the
JAX run."""

import numpy as np
import pytest

import torch_mesh_ranks as R
from lidarslam_tpu_torch import Slam as TSlam
from test_torch_parallel import _jax_config
from test_torch_slam import _one_torch_thread  # noqa: F401

MODE = "kp"
WORLD = 4
# golden sweeps per mode: ring-sharded extraction runs at 4x the keypoints
# (the headroom above), so 8 of them keep its file under a minute
N_FRAMES = {"kp": 15, "maps": 15, "ext": 8}


def _config(mode):
    return R.unsaturated_config() if mode == "ext" else R.small_config()


def _jax_mesh_run(mode):
    from lidarslam_tpu.parallel import sharded
    from lidarslam_tpu.slam import Slam as JSlam
    from test_multichip import _golden

    slam = JSlam(_jax_config(_config(mode)), mesh=sharded.make_mesh(WORLD), **R.MODES[mode])
    return R.pose_stack([slam.add_frame(f) for f in _golden(N_FRAMES[mode])])


@pytest.fixture(scope="module")
def runs(request):
    """(the ranks' results, this process's: JAX's mesh run and the port's
    single-device run) for the importing module's MODE."""
    mode = request.module.MODE

    def here():
        single = TSlam(_config(mode), device="cpu")
        res = [single.add_frame(f) for f in R.golden(N_FRAMES[mode])]
        sizes = {int(k): len(single.get_map_points(k)[0]) for k in single.maps}
        return {"jax": _jax_mesh_run(mode), "single": R.pose_stack(res),
                "single_matches": [r["n_matches"] for r in res], "single_sizes": sizes}

    n = N_FRAMES[mode]
    ranks, local = R.launch_beside(R.slam_modes, WORLD, ((mode,), n, n), here)
    return [r[mode] for r in ranks], local


def test_mesh_poses_match_single_device(runs):
    ranks, local = runs
    assert not any(ranks[0]["failed"])
    dt, ang = R.pose_divergence(ranks[0]["poses"], local["single"])
    assert dt < R.POSE_M and ang < R.POSE_DEG, (dt, ang)


def test_mesh_poses_match_jax_mesh(runs):
    ranks, local = runs
    dt, ang = R.pose_divergence(ranks[0]["poses"], local["jax"])
    assert dt < R.POSE_M and ang < R.POSE_DEG, (dt, ang)


def test_mesh_matches_and_map_sizes(runs):
    ranks, local = runs
    got = ranks[0]
    assert R.within_matches(got["matches"], local["single_matches"])
    for k, n in local["single_sizes"].items():
        assert abs(got["sizes"][k] - n) <= max(10, 0.02 * n), (k, got["sizes"][k], n)


def test_mesh_stream_matches_mesh_sync(runs):
    """add_frame_async + flush on the mesh (eager windows of 8) against
    add_frame on the mesh."""
    got = runs[0][0]
    dt, _ = R.pose_divergence(got["stream"], got["poses"])
    assert dt < R.POSE_M, dt


def test_mesh_ranks_bit_equal(runs):
    ranks, _ = runs
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["poses"], ranks[0]["poses"])
        np.testing.assert_array_equal(res["stream"], ranks[0]["stream"])
        assert res["sizes"] == ranks[0]["sizes"]


def test_mesh_debug_array_reassembled(runs):
    """The per-keypoint debug surface is gathered back to full size."""
    dbg = runs[0][0]["debug"]
    assert dbg and all(v > 0 for v in dbg.values())
