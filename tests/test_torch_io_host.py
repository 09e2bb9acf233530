"""The port's host I/O modules against the JAX package's, on the cases of
tests/test_conversions.py, test_gps.py, test_kitti.py, test_assembler.py,
test_yaml_config.py, test_io_cli.py and test_vtp.py: the same inputs give
the same outputs within 1e-12 (the same dtypes), and the files the writers
make are the same bytes."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import yaml

from lidarslam_tpu import config as jcfg
from lidarslam_tpu.core import se3 as jse3
from lidarslam_tpu.io import assembler as jasm
from lidarslam_tpu.io import conversions as jcv
from lidarslam_tpu.io import csv_log as jcsv
from lidarslam_tpu.io import gps as jgps
from lidarslam_tpu.io import kitti as jkitti
from lidarslam_tpu.io import vtp as jvtp
from lidarslam_tpu.io import yaml_config as jyaml
from lidarslam_tpu_torch import config as tcfg
from lidarslam_tpu_torch.io import assembler as tasm
from lidarslam_tpu_torch.io import conversions as tcv
from lidarslam_tpu_torch.io import csv_log as tcsv
from lidarslam_tpu_torch.io import gps as tgps
from lidarslam_tpu_torch.io import kitti as tkitti
from lidarslam_tpu_torch.io import vtp as tvtp
from lidarslam_tpu_torch.io import yaml_config as tyaml
from test_torch_config import _norm

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-12


def _same(a, b, path="out"):
    """Equal structure; arrays of one dtype within TOL; scalars within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (float, np.floating)):
        assert abs(float(a) - float(b)) <= TOL, (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def _spin_cloud(n=3600, rings=4):
    az = -np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.arange(n) % rings
    pts = np.stack([10.0 * np.cos(az), 10.0 * np.sin(az), 0.2 * ring], axis=1)
    return pts, ring


def _vendor_arrays(vendor, n=100, rings=8):
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 10, (n, 3))
    xyz[5] = 0.0
    lid = rng.integers(0, rings, n)
    inten = rng.uniform(0, 255, n)
    t_s = np.linspace(100.0, 100.1, n)
    return xyz, {"velodyne": {"adjustedtime": t_s * 1e6, "intensity": inten,
                              "laser_id": lid},
                 "ouster": {"Raw Timestamp": t_s * 1e9, "Signal Photons": inten,
                            "Channel": lid},
                 "hesai": {"Timestamp": t_s, "Intensity": inten, "LaserID": lid}}[vendor]


def test_vendor_frames_match_jax():
    """Frame advancement, the Velodyne / RoboSense / Leishen converters (NaN
    drop, dual-return dedup, the RS16 table and its 16-laser gate, vertical
    angle remaps) equal JAX's."""
    pts, rings = _spin_cloud()
    _same(tcv.estimate_frame_advancement(pts), jcv.estimate_frame_advancement(pts))
    pts[5] = np.nan
    inten = np.full(len(pts), 10.0)
    for kw in ({}, {"time": np.linspace(0, 0.1, len(pts)), "seq": 3, "device_id": 2}):
        _same(tcv.velodyne_to_frame(pts, inten, rings, 1.5, **kw),
              jcv.velodyne_to_frame(pts, inten, rings, 1.5, **kw))
    d_pts, d_rings = _spin_cloud(n=100, rings=16)
    d_pts, d_rings = np.repeat(d_pts, 2, axis=0), np.repeat(d_rings, 2, axis=0)
    p32, r32 = _spin_cloud(n=128, rings=32)
    angles = np.concatenate([np.arange(16), -1.0 - np.arange(16)])
    rng = np.random.default_rng(3)
    xyz15 = rng.normal(size=(64, 3)) * 5 + np.array([10.0, 0, 0])
    for args, kw in (((d_pts, np.zeros(len(d_pts)), d_rings, 0.0), {}),
                     ((p32, np.zeros(len(p32)), r32, 0.0), {}),
                     ((p32, np.zeros(len(p32)), r32, 0.0), {"vertical_angles": angles}),
                     ((xyz15, np.ones(64), np.arange(64) % 15, 0.0), {"n_lasers": 16}),
                     ((xyz15, np.ones(64), np.arange(64) % 15, 0.0),
                      {"ring_remap": np.arange(16)[::-1], "seq": 4})):
        _same(tcv.robosense_to_frame(*args, **kw), jcv.robosense_to_frame(*args, **kw))
    p32[3] = np.nan
    lsc = np.empty(32)
    lsc[0::2], lsc[1::2] = -16.0 + np.arange(16), np.arange(16.0)
    for kw in ({"vertical_angles": lsc}, {"time": np.linspace(0, 0.1, 128)}):
        _same(tcv.leishen_to_frame(p32, np.zeros(128), r32, 2.0, **kw),
              jcv.leishen_to_frame(p32, np.zeros(128), r32, 2.0, **kw))
    _same(tcv.RS16_RING_REMAP, jcv.RS16_RING_REMAP)
    _same(tcv.laser_id_mapping(angles), jcv.laser_id_mapping(angles))


@pytest.mark.parametrize("vendor", ["velodyne", "ouster", "hesai"])
def test_autodetect_frame_matches_jax(vendor):
    xyz, arrays = _vendor_arrays(vendor, rings=4)
    _same(tcv.identify_vendor(arrays), jcv.identify_vendor(arrays))
    for calib in (None, {"Altitude Angles": np.array([15.0, -5.0, 5.0, -15.0]),
                         "verticalCorrection": np.array([1.0, -1.0, 3.0])}):
        _same(tcv.autodetect_frame(xyz, arrays, calibration=calib, seq=2),
              jcv.autodetect_frame(xyz, arrays, calibration=calib, seq=2))
    for ext in (jcfg.ExtractorConfig(), jcfg.ExtractorConfig(
            edge_intensity_gap_threshold=2e6, neighbor_width=6, min_distance_to_sensor=0.5)):
        text = tcfg.ExtractorConfig(**dataclasses.asdict(ext))
        assert tcv.advise_extractor_params(vendor, text) == \
            jcv.advise_extractor_params(vendor, ext)
    with pytest.raises(ValueError, match="unable to identify"):
        tcv.autodetect_frame(np.zeros((4, 3)), {"foo": np.zeros(4)})


def test_gps_to_utm_matches_jax():
    for lat, lon in ((48.0, 3.0), (89.99999, 3.0), (45.0, 3.0), (-33.8568, 151.2153),
                     (48.8584, 2.2945), (0.0, -179.5), (-79.9, 0.0)):
        _same(tcv.gps_to_utm(lat, lon), jcv.gps_to_utm(lat, lon))
    lat = np.array([45.0, -20.0, 60.5])
    lon = np.array([4.0, 30.0, -120.25])
    _same(tcv.gps_to_utm(lat, lon), jcv.gps_to_utm(lat, lon))


# ---------------------------------------------------------------------------
# gps
# ---------------------------------------------------------------------------

def _walk_fixes(headings_deg, step=2.0, lat0=45.0, lon0=4.0, alt=100.0):
    e, n, _, _ = jcv.gps_to_utm(lat0, lon0)
    e, n = float(e), float(n)
    fixes = [{"lat": lat0, "lon": lon0, "alt": alt, "stamp": 0.0}]
    zone = int(np.floor((lon0 + 180) / 6) % 60) + 1
    for i, h in enumerate(np.deg2rad(headings_deg)):
        e += step * np.cos(h)
        n += step * np.sin(h)
        la, lo, _ = jgps.utm_to_gps(e, n, zone, "N")
        fixes.append({"lat": float(la), "lon": float(lo), "alt": alt, "stamp": (i + 1) * 0.1})
    return fixes


def test_utm_to_gps_round_trips_match_jax():
    for lat, lon in ((45.7640, 4.8357), (-33.8688, 151.2093), (50.0, 3.0)):
        e, n, zone, band = jcv.gps_to_utm(lat, lon)
        got = tgps.utm_to_gps(e, n, zone, band)
        _same(got, jgps.utm_to_gps(e, n, zone, band))
        assert abs(float(got[0]) - lat) < 1e-8 and abs(float(got[1]) - lon) < 1e-8
    _same(tgps.utm_to_gps(500000.0, 5538630.7, 31, "U", alt=3.0),
          jgps.utm_to_gps(500000.0, 5538630.7, 31, "U", alt=3.0))


def test_gps_to_utm_converter_stream_matches_jax():
    """A stream with heading from motion, low-speed smoothing, the +-pi
    seam, a time jump, full orientations and bearings, with and without
    the first-pose origin."""
    fixes = (_walk_fixes([0.0, 0.0, 90.0], step=0.1)
             + [dict(f, stamp=f["stamp"] + 1.0) for f in _walk_fixes([45.0, 45.0, 45.0])]
             + [dict(f, stamp=f["stamp"] + 5.0)
                for f in _walk_fixes([179.0, -179.0, 179.0, -179.0], step=0.1)])
    fixes[5]["stamp"] += 100.0
    fixes += [{"lat": 45.0, "lon": 4.0, "alt": 0.0, "stamp": 300.0, "roll": 1.0,
               "pitch": 2.0, "dip": 30.0, "err_roll": 2.0, "speed": 3.5,
               "position_covariance": np.diag([0.1, 0.2, 0.3])},
              {"lat": 45.0, "lon": 4.0, "alt": 0.0, "stamp": 300.1, "track": 0.0},
              {"lat": 45.0, "lon": 4.0, "alt": 0.0, "stamp": 300.2, "roll": 0.0,
               "pitch": 0.0, "dip": 0.0}]
    for kw in ({}, {"origin_on_first_pose": True, "time_offset": 0.25}):
        t, j = tgps.GpsToUtmConverter(**kw), jgps.GpsToUtmConverter(**kw)
        outs = [(t.process(dict(f)), j.process(dict(f))) for f in fixes]
        assert sum(a is not None for a, _ in outs) > 10
        for a, b in outs:
            _same(a, b)
        assert (t.zone, t.band) == (j.zone, j.band)


def test_odom_to_gps_matches_jax():
    conv = jgps.GpsToUtmConverter()
    out = conv.process({"lat": 45.764, "lon": 4.8357, "alt": 200.0, "stamp": 0.0,
                        "track": 30.0})
    cov = np.zeros((6, 6))
    cov[:3, :3] = np.eye(3) * 0.25
    cov[5, 5] = 0.01
    e0, n0, zone, band = jcv.gps_to_utm(45.0, 4.0)
    T = np.eye(4)
    T[:3, :3] = jse3.rpy_to_matrix(np.array([0.1, -0.05, np.pi / 2]))
    T[:3, 3] = [float(e0), float(n0), 50.0]
    for args, kw in (((out["position"],), {"quaternion": out["quaternion"], "covariance": cov,
                                           "zone": conv.zone, "band": conv.band}),
                     ((np.array([100.0, 0.0, 0.0]),), {"rotation": np.eye(3), "zone": zone,
                                                       "band": band, "T_utm_from_odom": T,
                                                       "covariance": cov})):
        _same(tgps.odom_to_gps(*args, **kw), jgps.odom_to_gps(*args, **kw))
    with pytest.raises(ValueError):
        tgps.odom_to_gps(np.zeros(3), rotation=np.eye(3))


# ---------------------------------------------------------------------------
# kitti
# ---------------------------------------------------------------------------

def _synth_bin(path, n_rings=64, n_az=360, seed=0):
    rng = np.random.default_rng(seed)
    pts = []
    for ring in range(n_rings):
        elev = np.deg2rad(2.0) - ring * np.deg2rad(26.8) / (n_rings - 1)
        az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
        r = 20.0 + rng.uniform(-1, 1, n_az)
        pts.append(np.stack([r * np.cos(elev) * np.cos(az), r * np.cos(elev) * np.sin(az),
                             r * np.sin(elev), rng.uniform(0, 1, n_az)], 1))
    arr = np.concatenate(pts).astype(np.float32)
    arr.tofile(path)
    return arr


def test_kitti_matches_jax(tmp_path):
    """.bin reading, ring recovery (scan order and the elevation fallback),
    frames and the sequence loader, and read_poses with calibration."""
    seq = tmp_path / "velodyne"
    seq.mkdir()
    arr = _synth_bin(seq / "000000.bin")
    _synth_bin(seq / "000001.bin", n_az=300, seed=1)
    _same(tkitti.read_velodyne_bin(seq / "000000.bin"), jkitti.read_velodyne_bin(seq / "000000.bin"))
    perm = np.random.default_rng(1).permutation(len(arr))
    for xyz in (arr[:, :3], arr[perm, :3]):
        _same(tkitti.rings_from_scan_order(xyz), jkitti.rings_from_scan_order(xyz))
        _same(tkitti.rings_from_elevation(xyz), jkitti.rings_from_elevation(xyz))
    _same(tkitti.bin_to_frame(seq / "000000.bin", stamp=1.0, seq=7),
          jkitti.bin_to_frame(seq / "000000.bin", stamp=1.0, seq=7))
    _same(list(tkitti.load_sequence(str(seq), rate=5.0)),
          list(jkitti.load_sequence(str(seq), rate=5.0)))
    _same(list(tkitti.load_sequence(str(seq), limit=1)),
          list(jkitti.load_sequence(str(seq), limit=1)))
    rows = np.zeros((3, 12))
    for i in range(3):
        P = jse3.pose_to_hmat([i, -0.5 * i, 0.1 * i, 0.01 * i, 0.02, -0.03 * i])
        rows[i] = P[:3].ravel()
    np.savetxt(tmp_path / "00.txt", rows)
    Tr = np.array([[0, -1, 0, 0.2], [0, 0, -1, -0.1], [1, 0, 0, 0.3]])
    (tmp_path / "calib.txt").write_text(
        "P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: " + " ".join(str(v) for v in Tr.ravel()) + "\n")
    for calib in (None, tmp_path / "calib.txt"):
        _same(tkitti.read_poses(tmp_path / "00.txt", calib),
              jkitti.read_poses(tmp_path / "00.txt", calib))


# ---------------------------------------------------------------------------
# assembler
# ---------------------------------------------------------------------------

def _sweep(dev, stamp, i):
    return {"xyz": np.full((3 + dev, 3), float(i), np.float32), "stamp": float(stamp),
            "device_id": dev, "seq": i}


def _stream(rng, n=8, drop=(), skew=0.0, jitter=0.02, swap=True):
    msgs = [(0.1 * i + rng.uniform(0, jitter), _sweep(0, 0.1 * i, i)) for i in range(n)]
    msgs += [(0.1 * i + 0.01 + rng.uniform(0, jitter), _sweep(1, 0.1 * i + 0.01 - skew, i))
             for i in range(n) if i not in drop]
    msgs.sort(key=lambda m: m[0])
    out = [m[1] for m in msgs]
    if swap:
        out[2], out[3] = out[3], out[2]
    return out


def _key(acq):
    return [(f["device_id"], f["seq"], f["stamp"]) for f in acq]


class _RecordingSlam:
    def __init__(self):
        self.calls = []

    def set_base_to_lidar_offset(self, d, cal):
        self.calls.append(("offset", d, np.asarray(cal).tolist()))

    def add_frames_async(self, acq):
        self.calls.append(("async", _key(acq)))
        return len(self.calls)

    def add_frames(self, acq):
        self.calls.append(("sync", _key(acq)))
        return {"n": len(self.calls)}


@pytest.mark.parametrize("case", ["jitter", "drops", "skew", "dropout"])
def test_assembler_pairs_like_jax(case):
    """The same acquisitions, emitted in the same order, from a shuffled and
    delayed two-device stream; the counters and the buffers after it."""
    rng = np.random.default_rng({"jitter": 0, "drops": 1, "skew": 2, "dropout": 3}[case])
    kw = {"main_device": 0, "max_stamp_diff": 0.05}
    if case == "jitter":
        stream = _stream(rng)
    elif case == "drops":
        stream = _stream(rng, drop={2, 3})
        kw["expected_devices"] = (1,)
    elif case == "skew":
        stream = _stream(rng, skew=0.5, jitter=0.0, swap=False)
        kw["time_offsets"] = {1: 0.5}
    else:
        stream = [f for f in _stream(rng, n=3) if f["device_id"] == 1] * 5
        kw["max_buffer"] = 4
    got = []
    for asm in (tasm.FrameAssembler(**kw), jasm.FrameAssembler(**kw)):
        acqs = [a for f in stream for a in asm.push(f)] + asm.flush()
        got.append(([_key(a) for a in acqs], asm.n_triggers, asm.n_unmatched,
                    {d: [f["seq"] for f in q] for d, q in asm._buffers.items()}))
    assert got[0] == got[1]
    if case == "jitter":
        assert len(got[0][0]) == 8 and sum(len(a) == 2 for a in got[0][0]) >= 7


def test_assembler_process_feeds_the_engine_like_jax():
    stream = _stream(np.random.default_rng(4))
    calib = {0: np.eye(4), 1: jse3.pose_to_hmat([0.4, 0.15, 0.05, 0, 0, 0.25])}
    calls = []
    for mod in (tasm, jasm):
        for streaming in (True, False):
            slam = _RecordingSlam()
            asm = mod.FrameAssembler(calibration_provider=calib.get)
            rets = [r for f in stream for r in asm.process(slam, f, streaming=streaming)]
            calls.append((slam.calls, rets))
    assert calls[:2] == calls[2:]


# ---------------------------------------------------------------------------
# yaml_config
# ---------------------------------------------------------------------------

_TEXTS = (
    "slam:\n  use_blobs: true\n",
    "",
    "slam:\n  2d_mode: true\n  ego_motion: 3\n  logging_storage: 1\n  logging_dir: /tmp/kp\n"
    "  confidence:\n    overlap:\n    motion_limits:\n      velocity: [1., .inf]\n"
    "  voxel_grid:\n    update_maps: 1\n    sampling_mode_planes: 3\n"
    "  external_sensors:\n    time_offset: 0.05\n    wheel_odometry: {weight: 2., relative: true}\n"
    "    imu: {weight: 0.5}\ntpu:\n  n_rings: 32\n  max_blob_keypoints: 512\n",
    "slam:\n  logging_storage: 4\n  external_sensors:\n    odometry:\n      weight: 1.\n"
    "    gravity:\n      weight: 3.\n",
)


def _cfg_tree(cfg):
    return _norm(dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", ["slam_config_outdoor.yaml", "slam_config_indoor.yaml"])
def test_yaml_presets_match_jax(name):
    path = ROOT / "configs" / name
    got = tyaml.load_config(str(path))
    assert isinstance(got, tcfg.SlamConfig)
    assert _cfg_tree(got) == _cfg_tree(jyaml.load_config(str(path)))
    over = {"stream_window": 4}
    assert _cfg_tree(tyaml.load_config(str(path), tpu_overrides=over)) == \
        _cfg_tree(jyaml.load_config(str(path), tpu_overrides=over))


def test_yaml_texts_and_trees_match_jax():
    """Text cases: a partial file, an empty one, every section the loader
    reads; `config_from_tree` on the parsed tree equals the text's load."""
    for text in _TEXTS:
        got = tyaml.load_config(text=text)
        assert _cfg_tree(got) == _cfg_tree(jyaml.load_config(text=text)), text
        assert _cfg_tree(tyaml.config_from_tree(yaml.safe_load(text) or {})) == _cfg_tree(got)
    assert tyaml.load_config(text=_TEXTS[0]).use_blobs is True


# ---------------------------------------------------------------------------
# csv_log and vtp: the same bytes
# ---------------------------------------------------------------------------

def _entries():
    return [(0.1 * i + 1e-7 * i * i, jse3.pose_to_hmat([i, 2 - 0.3 * i, 0.05 * i,
                                                        0.1 * i, -0.2, 0.3 * i - 1.0]))
            for i in range(7)]


def test_csv_logs_same_bytes_as_jax(tmp_path):
    entries = _entries()
    evals = [(t, 0.5 + 0.01 * i, 1000 + i, 0.02 * i) for i, (t, _) in enumerate(entries)]
    for name, args in (("write_poses_csv", entries), ("write_kitti_poses", entries),
                       ("write_tum_poses", entries), ("write_evaluators_csv", evals)):
        getattr(tcsv, name)(tmp_path / f"t_{name}", args)
        getattr(jcsv, name)(tmp_path / f"j_{name}", args)
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    _same(tcsv.read_poses_csv(tmp_path / "t_write_poses_csv"),
          jcsv.read_poses_csv(tmp_path / "t_write_poses_csv"))
    _same(tcsv.read_evaluators_csv(tmp_path / "t_write_evaluators_csv"),
          jcsv.read_evaluators_csv(tmp_path / "t_write_evaluators_csv"))


def test_compare_to_reference_matches_jax():
    ref = [(i * 0.1, jse3.pose_to_hmat([i * 0.2, 0, 0, 0, 0, 0])) for i in range(10)]
    good = [(t, H.copy()) for t, H in ref]
    good[3] = (good[3][0], jse3.pose_to_hmat([0.605, 0, 0, 0, 0, 0]))
    bad = [(t, H.copy()) for t, H in ref]
    bad[5] = (bad[5][0], jse3.pose_to_hmat([1.05, 0, 0, 0, 0, 0.2]))
    dropped = [(t + 1e-4, H) for t, H in good[::2]] + [(5.0, ref[0][1])]
    ev = np.array([[0.1 * i, 0.5, 1000, 0.01] for i in range(10)])
    slow = ev.copy()
    slow[:, 3] += 0.01
    for res, kw in ((good, {}), (bad, {}), (dropped, {}),
                    (good, {"res_eval": slow, "ref_eval": ev}),
                    (good, {"res_eval": slow, "ref_eval": ev, "time_threshold": 1e9}),
                    (bad, {"position_threshold": 0.1, "angle_threshold_deg": 20.0})):
        a = tcsv.compare_to_reference(res, ref, **kw)
        b = jcsv.compare_to_reference(res, ref, **kw)
        _same(dataclasses.asdict(a), dataclasses.asdict(b))
    assert tcsv.compare_to_reference(good, ref).success
    assert not tcsv.compare_to_reference(bad, ref).success


def test_vtp_same_bytes_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    pdata = {"Intensity": rng.uniform(0, 255, 50).astype(np.float32),
             "label": rng.integers(0, 3, 50).astype(np.uint8),
             "frame": np.arange(50, dtype=np.int32), "t": rng.normal(size=50)}
    traj = {"time": np.arange(9.0), "covariance": rng.normal(size=(9, 36))}
    for mod, tag in ((tvtp, "t"), (jvtp, "j")):
        mod.write_point_cloud_vtp(str(tmp_path / f"{tag}_cloud.vtp"), xyz, pdata)
        mod.write_point_cloud_vtp(str(tmp_path / f"{tag}_empty.vtp"), np.zeros((0, 3)))
        mod.write_trajectory_vtp(str(tmp_path / f"{tag}_traj.vtp"), positions=xyz[:9],
                                 point_data=traj)
        mod.write_trajectory_vtp(str(tmp_path / f"{tag}_one.vtp"), positions=xyz[:1])
    for name in ("cloud", "empty", "traj", "one"):
        assert (tmp_path / f"t_{name}.vtp").read_bytes() == \
            (tmp_path / f"j_{name}.vtp").read_bytes(), name
        _same(tvtp.read_vtp(str(tmp_path / f"t_{name}.vtp")),
              jvtp.read_vtp(str(tmp_path / f"t_{name}.vtp")))
    points, got, cells = tvtp.read_vtp(str(tmp_path / "t_cloud.vtp"))
    np.testing.assert_array_equal(points, xyz)
    np.testing.assert_array_equal(cells["verts"][1], np.arange(1, 51))
