"""The port's native host ingest (`lidarslam_tpu_torch/io/native.py`) against
the JAX package's, the float wire in the stream, and the stream's window
order, on the CPU: the three C++ entry points bit-equal to JAX's on
tests/test_native.py's cases; native against numpy ingest (ROADMAP Queue 3,
F5); an 8-sweep stream on native ingest on both sides, and one with
`compress_upload=False`, against JAX's; the stream's order across a mixed
sequence, and a window step's exception."""

import ctypes
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from lidarslam_tpu import Slam as JSlam
from lidarslam_tpu.io import native as jnative
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.core import se3 as tse3
from lidarslam_tpu_torch.io import native as tnative
from lidarslam_tpu_torch.io import synthetic as tsyn
from lidarslam_tpu_torch.ops import frame as tframe
from lidarslam_tpu_torch.ops import pipeline as tpipe
from test_native import _data
from test_torch_slam import _one_torch_thread, _pose_err, _torch_config  # noqa: F401
from test_torch_stream import _jcfg, _stream

N_FRAMES = 8
STREAM_M = 1e-3          # the 8-sweep stream tests' limit against JAX
SCALE = tframe.XYZ_QUANT_SCALE


NATIVE_WAIT_S = 120.0    # how long jax_native_lib waits out a concurrent build


def jax_native_lib(deadline_s: float = NATIVE_WAIT_S):
    """The JAX package's native library, loaded in this process.

    That loader builds `native/liblidarslam_native.so` in place when the
    file is missing and keeps a failed load for the rest of the process.
    Several test processes start on a tree without the library at once, so
    one of them can open the file while another's compiler still writes it,
    and then runs its whole session on the numpy ingest (ROADMAP Queue 3,
    F8). When the loader has failed, this waits until the file loads
    through ctypes here (its size unchanged over a second, so no writer is
    left), clears the loader's kept failure and loads again; it fails the
    test with the reason if the library still does not load."""
    if jnative.available():
        return jnative
    t_end = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < t_end:
        try:
            size = os.path.getsize(jnative._SO)
            time.sleep(1.0)
            if os.path.getsize(jnative._SO) == size:
                ctypes.CDLL(jnative._SO)
                break
        except OSError as e:        # missing, or still being written
            last = e
            time.sleep(1.0)
    jnative._TRIED = False
    if not jnative.available():
        pytest.fail(f"the JAX package's native library {jnative._SO} does not load "
                    f"after {deadline_s:.0f} s: {last}")
    return jnative


@pytest.fixture(scope="module")
def libs():
    """Both packages' native libraries (each built from native/*.cpp)."""
    j = jax_native_lib()
    assert tnative.available(), tnative.last_error()
    return j, tnative


def test_jax_native_lib_recovers_a_failed_load(monkeypatch):
    """With the JAX loader left in its failed state (as a process that
    opened a half-written library is), the helper loads the library again."""
    jax_native_lib()
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    assert not jnative.available()
    assert jax_native_lib(deadline_s=5.0) is jnative
    assert jnative.available() and jnative._LIB is not None


def _packed2_case():
    """tests/test_native.py::test_packed2_wire_format_matches_python's sweep."""
    rng = np.random.default_rng(1)
    n = 20000
    return (rng.normal(0, 10, (n, 3)).astype(np.float32),
            rng.uniform(0, 300, n).astype(np.float32),
            rng.integers(0, 16, n).astype(np.int64),
            rng.uniform(-0.1, 0.0, n).astype(np.float32))


@pytest.mark.parametrize("entry, case, shape", [
    ("build_range_image_native", dict(), (16, 256)),
    ("build_range_image_packed_native", dict(n=2000), (16, 256)),
    ("build_range_image_packed2_native", None, (16, 2048)),
])
def test_native_entry_points_bit_equal_to_jax(libs, entry, case, shape):
    """Each C++ entry point of the port's build against the JAX package's,
    byte for byte, on tests/test_native.py's inputs (out-of-range ring ids
    and ring overflow included)."""
    j, t = libs
    args = _packed2_case() if case is None else _data(**case)
    extra = () if entry == "build_range_image_native" else (SCALE,)
    got = getattr(t, entry)(*args, *shape, *extra)
    want = getattr(j, entry)(*args, *shape, *extra)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_native_build_into_the_port_build_dir(libs):
    """The port builds its own library under lidarslam_tpu_torch/_build/,
    never the JAX package's under native/."""
    build, name = os.path.split(tnative._SO)
    assert build.endswith("lidarslam_tpu_torch/_build")
    assert name.startswith("liblidarslam_native_") and name.endswith(".so")
    assert tnative._SO == tnative._so_path()     # keyed on this host's target
    assert tnative.last_error() is None


# frame 0 of the bench drive: the VLP-16 sweep of chip_smoke.py
F5_COORDS = 7


def test_native_against_numpy_ingest_differs_in_f5_coordinates_only(libs):
    """Native and numpy ingest of a VLP-16 sweep (16 rings x 1800 firings):
    the window planes and the per-sweep byte wire agree but for F5_COORDS
    quantized coordinates, each one 4 mm step apart where x / 0.004 lies on
    a rounding tie (C++ multiplies by 1/0.004, numpy divides)."""
    f = tsyn.generate_sequence(n_frames=1, motion_distortion=False,
                               sensor=tsyn.SensorModel(n_rings=16, n_azimuth=1800),
                               trajectory=tsyn.weaving_street_trajectory())[0]
    args = (f["xyz"], f["intensity"], f["laser_id"], f["time"], 16, 2048)
    nat = tframe.build_range_image(*args, packed=True, device=False)
    nat_wire = tframe.build_range_image(*args, packed=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "available", lambda: False)
        ref = tframe.build_range_image(*args, packed=True, device=False)
        ref_wire = tframe.build_range_image(*args, packed=True)
        plain = tframe.build_range_image(*args)
    for name in ("intensity", "t_q", "t_min", "t_scale", "counts"):
        assert np.array_equal(getattr(nat, name), getattr(ref, name)), name
    diff = nat.xyz_q != ref.xyz_q
    assert int(diff.sum()) == F5_COORDS
    assert (np.abs(nat.xyz_q.astype(np.int32) - ref.xyz_q)[diff] == 1).all()
    x = plain.xyz.numpy()[diff] / np.float32(SCALE)
    assert (np.abs(np.abs(x - np.floor(x)) - 0.5) < 1e-3).all()
    # the byte wire: the same coordinates, two bytes each at most
    assert 0 < int((nat_wire.buf != ref_wire.buf).sum()) <= 2 * F5_COORDS
    # the float planes are the same scatter either way
    nat_plain = tframe.build_range_image(*args)
    for a, b in zip(nat_plain, plain):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def streams():
    """JAX and the port streamed over N_FRAMES sweeps at test_torch_stream's
    config, each package on its native ingest; and with compress_upload=False."""
    jax_native_lib()
    frames = jsyn.generate_sequence(n_frames=N_FRAMES, motion_distortion=False,
                                    sensor=jsyn.SensorModel(range_noise=0.005))
    out = {}
    for name, jcfg in (("packed", _jcfg()),
                       ("float", dataclasses.replace(_jcfg(), compress_upload=False))):
        out["jax_" + name] = _stream(JSlam(jcfg), frames)
        out["torch_" + name] = _stream(TSlam(_torch_config(jcfg), device="cpu"), frames)
    return out


@pytest.mark.parametrize("wire", ["packed", "float"])
def test_stream_on_native_ingest_matches_jax(libs, streams, wire):
    """Poses within STREAM_M of JAX's stream (measured below 1e-4 m), n_matches
    within 1%, failure flags equal: on the native ingest of both packages,
    and with the float planes stacked per window (compress_upload=False)."""
    t, j = streams["torch_" + wire], streams["jax_" + wire]
    assert len(t) == len(j) == N_FRAMES
    for i, (a, b) in enumerate(zip(t, j)):
        dt, dr = _pose_err(a["pose"], b["pose"])
        assert dt < STREAM_M and dr < 5.0, (i, dt, dr)
        assert abs(a["n_matches"] - b["n_matches"]) <= 0.01 * b["n_matches"], i
        assert a["failure"] == b["failure"] is False


def test_float_and_packed_streams_differ(streams):
    """The float wire is not the quantized one: the two streams part."""
    d = max(_pose_err(a["pose"], b["pose"])[0]
            for a, b in zip(streams["torch_float"], streams["torch_packed"]))
    assert d > 1e-5


def _small_cfg(window):
    """A fast config for the order checks: 16 rings x 512 firings."""
    jcfg = dataclasses.replace(_jcfg(), stream_window=window)
    cfg = _torch_config(jcfg)
    return dataclasses.replace(cfg, extractor=dataclasses.replace(
        cfg.extractor, max_ring_points=512, max_keypoints=256))


def _rig(frame, offset):
    """tests/test_multilidar_debug.py's two-LiDAR split of one sweep."""
    xyz = frame["xyz"]
    front = xyz[:, 0] >= 0
    inv = tse3.hmat_inverse(offset)
    f0 = {k: frame[k][front] for k in ("xyz", "intensity", "laser_id", "time")}
    f1 = {k: frame[k][~front] for k in ("intensity", "laser_id", "time")}
    f1["xyz"] = (xyz[~front] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    f0.update(stamp=frame["stamp"], device_id=0)
    f1.update(stamp=frame["stamp"], device_id=1)
    return [f0, f1]


def _mixed(slam, frames, offset):
    """Single sweeps filling windows of 2, a rig acquisition between them,
    and a flush mid-way: the results in enqueue order."""
    slam.set_base_to_lidar_offset(1, offset)
    outs = []
    for i, f in enumerate(frames):
        if i == 5:
            outs += slam.flush()
        if i in (3, 6):
            assert slam.add_frames_async(_rig(f, offset)) >= 0
        else:
            assert slam.add_frame_async(f) >= 0
    return outs + slam.flush()


def test_stream_keeps_order_across_a_mixed_sequence():
    """A mixed sequence of add_frame_async (windows of 2), add_frames_async
    (which runs a buffered partial window first) and a flush mid-way: the
    results come back in enqueue order, each pose within STREAM_M of the
    sync path's (add_frame / add_frames) on the same sequence. A sweep
    stepped out of order would land a frame's motion away."""
    frames = tsyn.generate_sequence(n_frames=8, motion_distortion=False,
                                    sensor=tsyn.SensorModel(n_azimuth=500))
    offset = tse3.pose_to_hmat([0.5, 0.2, 0.1, 0.0, 0.0, 0.3])
    stream = TSlam(_small_cfg(2), device="cpu")
    got = _mixed(stream, frames, offset)
    sync = TSlam(_small_cfg(2), device="cpu")
    sync.set_base_to_lidar_offset(1, offset)
    want = [sync.add_frames(_rig(f, offset)) if i in (3, 6) else sync.add_frame(f)
            for i, f in enumerate(frames)]
    assert len(got) == len(want) == len(frames)
    step = min(_pose_err(a["pose"], b["pose"])[0] for a, b in zip(want, want[1:]))
    assert step > 10 * STREAM_M
    for i, (a, b) in enumerate(zip(got, want)):
        dt, dr = _pose_err(a["pose"], b["pose"])
        assert dt < STREAM_M and dr < 5.0, (i, dt, dr)
    assert [e["time"] for e in stream.log_trajectory] == [f["stamp"] for f in frames]


def test_window_step_exception_surfaces_at_its_enqueue(monkeypatch):
    """Full windows run inline: a window step that raises does so out of
    the add_frame_async call that filled the window."""
    frames = tsyn.generate_sequence(n_frames=3, motion_distortion=False,
                                    sensor=tsyn.SensorModel(n_azimuth=500))
    slam = TSlam(_small_cfg(2), device="cpu")

    def boom(*a, **k):
        raise RuntimeError("window step failed")
    monkeypatch.setattr(tpipe, "process_stream_window", boom)
    assert slam.add_frame_async(frames[0]) == 0     # a segment's first sweep: alone
    assert slam.add_frame_async(frames[1]) == 1     # buffered
    with pytest.raises(RuntimeError, match="window step failed"):
        slam.add_frame_async(frames[2])
