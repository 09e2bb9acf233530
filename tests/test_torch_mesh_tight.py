"""`__graft_entry__.dryrun_multichip` for the port: the mesh modes under
operational pressure, on 4 gloo CPU ranks, against the port's
single-device engine; and the multi-LiDAR rig on the mesh.

14 sweeps at 4 m/s through a 12-voxel x 2.4 m window with 1024-slot maps,
so the window rolls and the maps evict: the keypoint-sharded and
ring-sharded modes within 1e-3 m of the single-device run with the same
map size (and, keypoint-sharded, the same n_matches and origin); the
slab-sharded maps within 1e-3 m with 8192-slot maps (rolls and ring
migration are exact) and within 5e-2 m at 1024 slots, where each slab
evicts on its own (JAX's bounds). The split two-LiDAR rig of
tests/test_multilidar_debug.py, 5 acquisitions of `add_frames` with the
maps slab-sharded, within 1e-3 m of the single-device rig. The ranks run
tests/torch_mesh_ranks.py::tight_and_rig once for the file."""

import numpy as np
import pytest

import torch_mesh_ranks as R
from lidarslam_tpu_torch import Slam as TSlam
from test_torch_slam import _one_torch_thread  # noqa: F401

WORLD = 4
CAP, ROOMY = 1 << 10, 1 << 13
EVICTION_M = 5e-2     # dryrun_multichip: slab-local eviction is approximate
RIG_ACQ = 5


@pytest.fixture(scope="module")
def runs():
    def here():
        frames = R.tight_frames()
        return {"tight": R.tight_run(TSlam(R.tight_config(CAP), device="cpu"), frames),
                "roomy": R.tight_run(TSlam(R.tight_config(ROOMY), device="cpu"), frames),
                "rig": R.rig_run(RIG_ACQ, device="cpu")}

    return R.launch_beside(R.tight_and_rig, WORLD, (RIG_ACQ,), here)


def test_single_device_window_rolls_and_evicts(runs):
    _, single = runs
    assert single["tight"]["origin"] > 0, "the window never rolled"
    assert single["tight"]["fill"] >= CAP, "no capacity eviction"
    assert single["roomy"]["origin"] > 0 and single["roomy"]["fill"] < ROOMY


@pytest.mark.parametrize("name", [n for n, _, _ in R.TIGHT_RUNS])
def test_tight_mesh_run_tracks(runs, name):
    """No failed sweep, and every rank's poses bit-equal."""
    ranks, _ = runs
    got = ranks[0]["tight"][name]
    assert not any(got["failed"]) and got["matches"][-1] > 0
    assert np.all(np.isfinite(got["poses"]))
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["tight"][name]["poses"], got["poses"])


def test_tight_keypoint_sharded_matches_single(runs):
    ranks, single = runs
    got, ref = ranks[0]["tight"]["kp"], single["tight"]
    div_t = np.abs(got["poses"][:, :3, 3] - ref["poses"][:, :3, 3]).max()
    div_R = np.abs(got["poses"][:, :3, :3] - ref["poses"][:, :3, :3]).max()
    assert div_t <= R.POSE_M and div_R <= 1e-3, (div_t, div_R)
    assert got["map"] == ref["map"]
    assert got["matches"] == ref["matches"]
    assert got["origin"] == ref["origin"]


def test_tight_shard_extraction_matches_single(runs):
    ranks, single = runs
    got, ref = ranks[0]["tight"]["ext"], single["tight"]
    assert np.abs(got["poses"][:, :3, 3] - ref["poses"][:, :3, 3]).max() <= R.POSE_M
    assert got["map"] == ref["map"]


def test_tight_slab_maps_roll_exactly(runs):
    """8192-slot slabs: the rolls and the ring migration are exact."""
    ranks, single = runs
    got, ref = ranks[0]["tight"]["maps_roomy"], single["roomy"]
    assert np.abs(got["poses"][:, :3, 3] - ref["poses"][:, :3, 3]).max() <= R.POSE_M
    assert got["map"] == ref["map"] and got["origin"] == ref["origin"]


def test_tight_slab_maps_under_eviction(runs):
    ranks, single = runs
    got, ref = ranks[0]["tight"]["maps"], single["tight"]
    assert np.abs(got["poses"][:, :3, 3] - ref["poses"][:, :3, 3]).max() <= EVICTION_M
    assert got["origin"] == ref["origin"]


def test_rig_on_sharded_maps_matches_single(runs):
    """`add_frames` of the split rig with the maps slab-sharded."""
    ranks, single = runs
    for res in ranks:
        assert not any(res["rig"]["failed"])
        dt, _ = R.pose_divergence(res["rig"]["poses"], single["rig"]["poses"])
        assert dt < R.POSE_M, dt
