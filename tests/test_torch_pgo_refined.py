"""`Slam.run_pose_graph_optimization` of the PyTorch port against the JAX
package's on tests/test_torch_pgo_slam.py's drive rendered with motion
distortion, under REFINED undistortion: the map rebuild replays each logged
sweep's undistortion between consecutive optimized poses (`_replay_undistort`).
Both PGO backends; both packages on their numpy ingest."""

import pytest

from test_torch_pgo_slam import (BACKENDS, _numpy_ingest,  # noqa: F401
                                 check_backends_agree_and_track_ground_truth,
                                 check_pgo_matches_jax, pgo_runs)
from test_torch_slam import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return pgo_runs("REFINED")


@pytest.mark.parametrize("backend", BACKENDS)
def test_refined_pgo_matches_jax(runs, backend):
    check_pgo_matches_jax(runs, backend)


def test_refined_pgo_backends_agree_and_track_ground_truth(runs):
    check_backends_agree_and_track_ground_truth(runs)
