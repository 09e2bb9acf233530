"""`Slam(cfg, mesh=..., shard_maps=True)` of the port on 4 gloo CPU ranks:
the rolling maps slab-sharded over the ranks (`parallel/sharded_map.py`),
the counterpart of tests/test_multichip.py::
test_sharded_map_pipeline_matches_single_device. The checks are
tests/test_torch_mesh_slam.py's, on this mode, plus the slabs' ownership."""


from test_torch_mesh_slam import (runs, test_mesh_debug_array_reassembled,  # noqa: F401
                                  test_mesh_matches_and_map_sizes,
                                  test_mesh_poses_match_jax_mesh,
                                  test_mesh_poses_match_single_device,
                                  test_mesh_ranks_bit_equal,
                                  test_mesh_stream_matches_mesh_sync)
from test_torch_slam import _one_torch_thread  # noqa: F401

MODE = "maps"


def test_shard_maps_slabs_own_their_leaves(runs):  # noqa: F811
    """Every rank's slab holds only the leaves it owns, and nothing was
    dropped."""
    ranks, _ = runs
    for res in ranks:
        assert res["owns"]
        assert res["overflow"] == 0
