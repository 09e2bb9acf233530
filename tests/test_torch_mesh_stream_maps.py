"""The mesh stream with `shard_maps` (the slabs' roll migrates in a loop
of fixed length there) against the JAX package's mesh stream: the checks
of tests/test_torch_mesh_stream.py on this mode."""

from test_torch_mesh_stream import (streams, test_mesh_stream_matches_jax_mesh_stream,  # noqa: F401
                                    test_mesh_stream_ranks_bit_equal,
                                    test_mesh_stream_step_reads_nothing_on_host)
from test_torch_slam import _one_torch_thread  # noqa: F401

MODE = "maps"
