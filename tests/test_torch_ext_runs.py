"""The PyTorch port at the extended settings (CENTROID and CENTER_POINT
maps, edge decay, relative wheel odometry and IMU gravity on every sweep)
through `add_frame`, 8 sweeps against the JAX package on the CPU; the
settings, the drive and the checks are tests/test_torch_blobs_sensors.py's."""

import pytest

from test_torch_blobs_sensors import (SYNC_TOL_M, check_ext_run, check_maps_and_getters,
                                      ext_runs)
from test_torch_slam import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return ext_runs("sync")


def test_ext_runs_match_jax(runs):
    """Poses within SYNC_TOL_M of JAX, n_matches within MATCH_FLIPS a
    frame, overlap within 1e-3, equal motion-limit flags, no failure.
    Measured: 4e-05 m, n_matches equal."""
    check_ext_run(runs, SYNC_TOL_M)


def test_ext_maps_and_getters_match_jax(runs):
    """Map slots, the decay, get_keypoints and get_target_submap as JAX's
    after the run."""
    check_maps_and_getters(runs)
