"""The PyTorch port at the extended settings (CENTROID and CENTER_POINT
maps, edge decay, relative wheel odometry and IMU gravity) through the
stream against the JAX package on the CPU: one sweep through `add_frame`,
three streamed sweeps with sensor blocks (each alone), then two windows of
2 without them with the map update switched off between them
(`set_map_update`), and one flush; and the relative-odometry quirk of the
JAX stream, which the port mirrors. The settings, the drive and the
checks are tests/test_torch_blobs_sensors.py's."""

import numpy as np
import pytest

from test_torch_blobs_sensors import (N_FRAMES, STREAM_SYNC, STREAM_TOL_M, check_ext_run,
                                      check_maps_and_getters, ext_runs)
from test_torch_slam import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return ext_runs("stream")


def test_ext_stream_matches_jax(runs):
    """Poses within STREAM_TOL_M of JAX, n_matches within MATCH_FLIPS a
    frame, overlap within 1e-3, equal motion-limit flags, no failure."""
    check_ext_run(runs, STREAM_TOL_M)


def test_ext_stream_maps_and_getters_match_jax(runs):
    """Map slots, the decay, get_keypoints and get_target_submap as JAX's
    after the flush; the submap targeted mid-stream (from the device state)
    within 1e-3 m; the map update off after set_map_update."""
    check_maps_and_getters(runs)
    tp, jp = runs["torch_probes"], runs["jax_probes"]
    np.testing.assert_allclose(tp["submap_mid_stream"], jp["submap_mid_stream"], atol=1e-3)
    assert tp["map_update"] == jp["map_update"] == 0


def test_relative_odometry_in_the_stream_measures_from_the_last_add_frame(runs):
    """The JAX package moves the relative odometer's reference only in
    add_frame (`_apply_result`), and computes a streamed sweep's block at
    enqueue time: every streamed sweep's `prev_pos` is the pose of the last
    add_frame, not of the sweep before it. The port mirrors that (ROADMAP
    Queue 3): the same blocks, one `prev_pos` through the stream (within
    1e-4 m of JAX's, which starts from its own last pose; every other field
    bit for bit)."""
    tl, jl = (runs[k + "_probes"]["extras"] for k in ("torch", "jax"))
    assert len(tl) == len(jl) == N_FRAMES - STREAM_SYNC
    for (a, oa), (b, ob) in zip(tl, jl):
        np.testing.assert_array_equal(oa, ob)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for f in x:
                if f == "prev_pos":
                    np.testing.assert_allclose(x[f], y[f], atol=1e-4, rtol=0)
                else:
                    np.testing.assert_array_equal(x[f], y[f], err_msg=f)
    odom = [(e[0], origin) for e, origin in tl if e and "distance" in e[0]]
    assert len(odom) >= 2
    assert all(np.array_equal(o["prev_pos"], odom[0][0]["prev_pos"]) for o, _ in odom)
    last_sync = runs["torch"][STREAM_SYNC - 1]["pose"][:3, 3]
    np.testing.assert_allclose(odom[0][0]["prev_pos"] + odom[0][1], last_sync, atol=1e-4)
    # the sweep before the last one with a block had moved away from it
    before_last = runs["torch"][STREAM_SYNC + len(odom) - 2]["pose"][:3, 3]
    assert np.linalg.norm(before_last - last_sync) > 0.05
    assert not any(tl[-1][0])    # past the measurements: no blocks, so windows run
