"""`Slam(cfg, mesh=..., shard_extraction=True)` of the port on 4 gloo CPU
ranks: ring-sharded extraction (each rank extracts 4 of the 16 rings with
a quarter of the keypoint budget, the sets gathered and compacted), the
counterpart of tests/test_multichip.py::
test_shard_extraction_matches_single_device. The checks are
tests/test_torch_mesh_slam.py's, on this mode, over 8 golden sweeps at
small_config with the keypoint headroom the JAX test gives it (4096): at
saturation the per-rank budgets keep other keypoints than the global
compaction."""


from test_torch_mesh_slam import (runs, test_mesh_debug_array_reassembled,  # noqa: F401
                                  test_mesh_matches_and_map_sizes,
                                  test_mesh_poses_match_jax_mesh,
                                  test_mesh_poses_match_single_device,
                                  test_mesh_ranks_bit_equal,
                                  test_mesh_stream_matches_mesh_sync)
from test_torch_slam import _one_torch_thread  # noqa: F401

MODE = "ext"
