"""The port's TCP server (`server.py`) on the CPU, on the cases of
tests/test_server.py: both modes, two clients one after the other (the
stream continues across them), the commands, the map download, the error
replies and the routing of poses to their client. The trajectories are
held to a direct port `Slam` fed the same sweeps within 1e-9 m and to the
JAX package's server on the same sweeps within the CI's 0.01 m / 5 deg.
Both packages take the numpy ingest (ROADMAP Queue 3, F5); the sweeps and
the synchronous reference are tests/test_torch_frontends.py's fixtures."""

import time

import numpy as np
import pytest

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu import server as jserver
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch import server as tserver
from lidarslam_tpu_torch.config import Keypoint, MappingMode
from test_slam_e2e import small_config
from test_torch_frontends import (N, N_SYNC, _check, _numpy_ingest,  # noqa: F401
                                  _tslam, direct_sync, frames)
from test_torch_slam import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def direct_stream(frames):
    """A direct port Slam streaming the sweeps with the two clients'
    flushes (after sweep 3 and at the end), and its plane map then."""
    s = _tslam()
    for f in frames[:4]:
        s.add_frame_async(f)
    stream = s.flush()
    for f in frames[4:]:
        s.add_frame_async(f)
    stream += s.flush()
    return [o["pose"] for o in stream], s.get_map_points(Keypoint.PLANE)


def _session_ended(slam, timeout_s=60.0):
    """Wait until the handler of a closed client has processed its `bye`
    (whose flush would otherwise end the next client's segment, ROADMAP
    Queue 3, F10)."""
    t_end = time.monotonic() + timeout_s
    while slam._subscribers:
        assert time.monotonic() < t_end, "a closed session did not end"
        time.sleep(0.01)


def _serve_two_clients(server_mod, slam, frames):
    """Client A streams sweeps 0-3, flushes and says bye; client B, on a
    new connection, streams 4-7 and flushes, then downloads the plane map.
    Returns both clients' pose messages and the map."""
    server = server_mod.SlamServer(slam, port=0)
    server.serve_background()
    try:
        port = server.server_address[1]
        a = server_mod.SlamClient(port=port)
        for f in frames[:4]:
            a.send_frame(f)
        poses_a = list(a.flush())
        a.close()
        _session_ended(slam)
        b = server_mod.SlamClient(port=port)
        for f in frames[4:]:
            b.send_frame(f)
        poses_b = list(b.flush())
        plane_map = b.get_map(keypoint=int(Keypoint.PLANE))
        b.close()
    finally:
        server.shutdown()
        server.server_close()
    return poses_a, poses_b, plane_map


def _poses(msgs):
    return [np.asarray(m["pose"]).reshape(4, 4) for m in msgs]


def test_frame_codec_matches_jax(frames):
    f = dict(frames[0], seq=7, device_id=2)
    header, payload = tserver.frame_payload(f)
    assert (header, payload) == jserver.frame_payload(f)
    g = tserver.decode_frame(header, payload)
    for k, v in jserver.decode_frame(header, payload).items():
        np.testing.assert_array_equal(g[k], v)
        assert type(g[k]) is type(v)


def test_server_stream_two_clients(frames, direct_stream):
    """The stream continues across the two connections; each client gets
    only its own frames' poses; the plane map is the direct run's."""
    a, b, (xyz, inten) = _serve_two_clients(tserver, _tslam(), frames)
    ja, jb, _ = _serve_two_clients(jserver, JSlam(small_config()), frames)
    assert [m["frame_index"] for m in a + b] == list(range(N))
    assert [m["frame_index"] for m in ja + jb] == list(range(N))
    assert a[0].keys() == ja[0].keys()
    assert all(not m["failure"] and len(m["covariance"]) == 36 for m in a + b)
    poses, plane_map = direct_stream
    _check(_poses(a + b), poses, _poses(ja + jb))
    want_xyz, want_inten, _, _ = plane_map
    np.testing.assert_array_equal(xyz, want_xyz)
    np.testing.assert_array_equal(inten, want_inten)


def test_server_sync_mode(frames, direct_sync):
    """`stream=False`: one pose per frame, as it is processed."""
    got = []
    for mod, slam in ((tserver, _tslam()), (jserver, JSlam(small_config()))):
        server = mod.SlamServer(slam, port=0, stream=False)
        server.serve_background()
        try:
            c = mod.SlamClient(port=server.server_address[1])
            for f in frames[:N_SYNC]:
                c.send_frame(f)
            got.append(_poses(c.flush()))
            c.close()
        finally:
            server.shutdown()
            server.server_close()
    _check(got[0], direct_sync, got[1])


def test_server_commands_errors_and_routing(frames):
    """Map freeze and resume through SlamCommand ids; unknown commands,
    message types and unused map types get an `error` and the session
    goes on; a second connected client receives no other client's poses."""
    slam = _tslam()
    server = tserver.SlamServer(slam, port=0)
    server.serve_background()
    try:
        port = server.server_address[1]
        viewer = tserver.SlamClient(port=port)
        c = tserver.SlamClient(port=port)
        with pytest.raises(RuntimeError, match="unknown SLAM command 99"):
            c.command(99)
        with pytest.raises(RuntimeError, match="BLOB"):
            c.get_map(keypoint=int(Keypoint.BLOB))
        tserver._send(c.sock, {"type": "nonsense"})
        with pytest.raises(RuntimeError, match="unknown type"):
            c._drain_until("ok")
        for f in frames[:2]:
            c.send_frame(f)
        assert len(c.flush()) == 2
        n0 = len(c.get_map(keypoint=1)[0])
        c.command(TSlam.DISABLE_SLAM_MAP_UPDATE)
        assert slam.get_map_update() == MappingMode.NONE
        c.send_frame(frames[2])
        c.flush()
        assert len(c.get_map(keypoint=1)[0]) == n0
        c.command(TSlam.ENABLE_SLAM_MAP_UPDATE)
        c.send_frame(frames[3])
        assert len(c.flush()) == 4
        assert len(c.get_map(keypoint=1)[0]) > n0
        viewer.get_map(keypoint=1)
        viewer.flush()
        assert viewer.poses == []
        assert sorted(tserver._KNOWN_COMMANDS) == sorted(jserver._KNOWN_COMMANDS)
        c.close()
        viewer.close()
    finally:
        server.shutdown()
        server.server_close()
