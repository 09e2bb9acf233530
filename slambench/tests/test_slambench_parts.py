"""CPU tests of the benchmark's parts: the caster against the simulator, the
configurations against the preset, the percentile, the trace arithmetic and
readers, the module checks. Run from the repository root:

    python -m pytest slambench/tests -q -o addopts="" -p no:cacheprovider
"""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench import check, circuit, raycast, run, spec, traceread  # noqa: E402
from slambench.tests import synthetic_np  # noqa: E402

CONFIGS = ["vlp16_outdoor", "hdl64_kitti"]


def _world(circ):
    return {"ground_z": circ.ground_z, "ground_intensity": circ.ground_intensity,
            "boxes": circ.boxes, "box_intensity": circ.box_intensity,
            "cylinders": circ.cylinders, "cyl_intensity": circ.cyl_intensity}


@pytest.mark.parametrize("config,mix", [("vlp16_outdoor", "robot-live"),
                                        ("hdl64_kitti", "car-log")])
def test_caster_matches_the_simulator(config, mix):
    """Three sweeps of the PyTorch caster against the frozen numpy copy of
    render_sweep on a small sensor, with the same range noise."""
    sensor = dict(spec.config(config)["sensor"], n_azimuth=120)
    circ = dataclasses.replace(circuit.make_circuit(spec.traffic(mix), sensor), n_sweeps=3)
    gen = torch.Generator()
    gen.manual_seed(5)
    lap = raycast.render_lap(circ, sensor, gen, "cpu")
    gen.manual_seed(5)
    R, A = sensor["n_rings"], sensor["n_azimuth"]
    noise = (torch.randn(3 * R * A, generator=gen, dtype=torch.float64)
             * sensor["range_noise"]).reshape(3, R, A).numpy()

    def pose_at(t):
        return circ.poses(torch.tensor(t, dtype=torch.float64)).numpy()

    for j in range(3):
        ref = synthetic_np.render_sweep(_world(circ), sensor, pose_at, j * sensor["sweep_duration"],
                                        noise[j])
        o0, o1 = lap["offsets"][j], lap["offsets"][j + 1]
        assert o1 - o0 == len(ref["time"]) > 0.5 * R * A
        np.testing.assert_array_equal(lap["laser_id"][o0:o1], ref["laser_id"])
        np.testing.assert_array_equal(lap["time"][o0:o1], ref["time"])
        np.testing.assert_array_equal(lap["intensity"][o0:o1], ref["intensity"])
        np.testing.assert_allclose(lap["xyz"][o0:o1], ref["xyz"], rtol=0, atol=1e-5)


def test_circuit_is_closed_and_clear():
    """A lap is a whole number of sweeps, the pose after it is the first
    again, and no building or pole stands within 2.5 m of the path."""
    for config, mix in [("vlp16_outdoor", "robot-live"), ("hdl64_kitti", "car-live")]:
        sensor = spec.config(config)["sensor"]
        circ = circuit.make_circuit(spec.traffic(mix), sensor)
        T = circ.n_sweeps * circ.sweep_duration
        ends = circ.poses(torch.tensor([0.0, T], dtype=torch.float64)).numpy()
        np.testing.assert_allclose(ends[0], ends[1], atol=1e-9)
        t = torch.arange(0, T, 0.05, dtype=torch.float64)
        xy = circ.poses(t)[:, :2, 3].numpy()
        lo, hi = circ.boxes[:, :2], circ.boxes[:, 3:5]
        gap = np.maximum(np.maximum(lo[None] - xy[:, None], xy[:, None] - hi[None]), 0)
        assert np.sqrt((gap ** 2).sum(-1)).min() > 2.5
        d = np.linalg.norm(xy[:, None] - circ.cylinders[None, :, :2], axis=-1)
        assert (d - circ.cylinders[None, :, 2]).min() > 2.5
        assert abs(circ.speed - spec.traffic(mix)["speed_mps"]) < 0.01


@pytest.mark.parametrize("name", CONFIGS)
def test_config_is_the_outdoor_preset(name):
    """The file's SlamConfig is the upstream outdoor preset's, as
    `cli run --config configs/slam_config_outdoor.yaml` builds it with the
    file's tpu block, and its values are pinned."""
    from lidarslam_tpu_torch.config import (EgoMotionMode, LoggingStorage, MappingMode,
                                            SamplingMode, UndistortionMode)
    from lidarslam_tpu_torch.io import yaml_config

    f = spec.config(name)
    cfg = run.slam_config(f)
    with open(ROOT / "configs" / "slam_config_outdoor.yaml") as fh:
        tree = yaml.safe_load(fh)
    tree["tpu"] = f["tpu"]
    assert yaml_config.config_from_tree(tree) == cfg
    assert cfg.undistortion == UndistortionMode.REFINED
    assert cfg.ego_motion_mode == EgoMotionMode.MOTION_EXTRAPOLATION
    assert (cfg.localization_icp_max_iter, cfg.localization_lm_max_iter) == (3, 15)
    assert (cfg.edge_map.leaf_size, cfg.plane_map.leaf_size) == (0.30, 0.60)
    assert cfg.edge_map.sampling == cfg.plane_map.sampling == SamplingMode.MAX_INTENSITY
    assert (cfg.kf_distance_threshold, cfg.kf_angle_threshold) == (0.5, 5.0)
    assert not cfg.loc_matching.reuse_knn and not cfg.ego_matching.reuse_knn
    assert cfg.edge_map.capacity == cfg.plane_map.capacity == 131072
    assert cfg.stream_window == 8
    assert cfg.mapping_mode == MappingMode.UPDATE
    assert cfg.logging_storage == LoggingStorage.HOST
    assert (cfg.use_edges, cfg.use_planes, cfg.use_blobs) == (True, True, False)
    assert cfg.confidence.overlap_sampling_ratio == 0.0
    assert cfg.extractor.n_rings == f["sensor"]["n_rings"]
    assert cfg.extractor.max_ring_points >= f["sensor"]["n_azimuth"]
    caps = {"vlp16_outdoor": (16, 2048, 2048), "hdl64_kitti": (64, 8192, 16384)}[name]
    assert (cfg.extractor.n_rings, cfg.extractor.kp_capacity(0),
            cfg.extractor.kp_capacity(1)) == caps


def test_percentile_takes_every_sample():
    assert run.percentile(list(range(1, 101)), 90) == pytest.approx(90.1)
    assert run.percentile(list(range(1, 101)), 50) == pytest.approx(50.5)
    # one slow call in ten is the tail
    assert run.percentile([0.1] * 9 + [1.0], 90) == pytest.approx(0.19)


class _FakeSlam:
    def __init__(self):
        self.calls = 0

    def add_frame(self, frame):
        self.calls += 1
        time.sleep(0.02 if self.calls % 5 else 0.05)
        return {"pose": np.eye(4), "failure": False}


class _FakeDrive:
    def frame(self, j):
        return {"stamp": j}


def test_live_window_times_every_call():
    """Every call of the window is a sample, and the percentile is taken
    over all of them."""
    slam, rec = _FakeSlam(), run.Run()
    samples, j = run._live(slam, _FakeDrive(), rec, 3, 0.5)
    assert len(samples) == slam.calls == j - 3 == len(rec.poses)
    assert run.percentile(samples, 90) == pytest.approx(np.percentile(samples, 90))
    assert max(samples) >= 0.05 > run.percentile(samples, 50)


def _trace(device, host=(), path="live", sweeps=2, ms=10.0):
    return traceread.Trace(device=list(device), host=list(host), sweeps=sweeps, path=path,
                           untraced_ms_per_sweep=ms)


def test_busy_is_the_union_of_device_intervals():
    ms = 1_000_000
    dev = [("k1", 0, 4 * ms), ("k2", 2 * ms, 6 * ms),        # overlap on two streams
           ("knn_scan", 8 * ms, 9 * ms), ("Memcpy HtoD", 9 * ms, 10 * ms)]
    assert traceread.union_ns([(s, e) for _, s, e in dev]) == 8 * ms
    t = _trace(dev, host=[("aten::item", 5 * ms, 9 * ms),
                          ("cudaStreamSynchronize", 6 * ms, 8 * ms)])
    assert t.busy_ms() == pytest.approx(8.0)           # a plain sum would read 10
    assert t.kernels() == 3
    assert t.ms_named("knn_") == pytest.approx(1.0)
    assert t.idle_gaps() == [["cudaStreamSynchronize", pytest.approx(0.002)]]
    assert t.top_ops(1) == [["k1", pytest.approx(0.004)]]
    read = spec.reader
    assert read("device_busy_ms_per_sweep.live")(t) == pytest.approx(4.0)
    assert read("device_idle_share.live")(t) == pytest.approx(60.0)
    assert read("kernels_per_sweep.live")(t) == pytest.approx(1.5)
    assert read("knn_device_ms_per_sweep.live")(t) == pytest.approx(0.5)
    # a reader of the other path, or one that finds nothing, returns nothing
    assert read("device_idle_share.log")(t) is None
    empty = _trace([], path="log")
    for name in ("device_idle_share.log", "device_busy_ms_per_sweep.log",
                 "kernels_per_sweep.log", "knn_device_ms_per_sweep.log"):
        assert read(name)(empty) is None


def test_every_listed_metric_has_its_reader():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        spec.config(w["config"]), spec.traffic(w["traffic"])
        lim = spec.limits(w["name"])
        assert {"step_m", "missing"} <= set(lim) <= {"step_m", "step_deg", "drift_m", "missing"}
        assert lim["missing"] == 0
        assert {"setup_s"} < {m["name"] for m in spec.metrics_for(bench, w["name"], "end_to_end")}
        assert spec.metrics_for(bench, w["name"], "per_layer")


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["lidarslam_tpu_torch", "lidarslam_tpu_torch.ops.icp",
                                  "jax_like", "numpy"]) == []
    assert run.forbidden_modules(["lidarslam_tpu.ops", "jaxlib.xla_client", "flax",
                                  "jax"]) == ["flax", "jax", "jaxlib", "lidarslam_tpu"]


def test_reference_loads_nothing_of_the_program():
    """The reference (check.py and the circuit it reads) and the caster load
    neither the program nor JAX."""
    code = ("import sys, torch; sys.path.insert(0, %r)\n"
            "from slambench import check, circuit, raycast, spec\n"
            "c = circuit.make_circuit(spec.traffic('robot-live'), "
            "spec.config('vlp16_outdoor')['sensor'])\n"
            "ref = c.sweep_poses(30).numpy()\n"
            "check.judge(check.readings(ref, ref, 10), {'step_m': 0.0})\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'lidarslam_tpu', 'lidarslam_tpu_torch'})\n"
            "print(bad)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_motion_gaps_read_a_known_offset():
    ref = np.stack([np.eye(4)] * 5)
    ref[:, 0, 3] = np.arange(5) * 0.2
    got = ref.copy()
    got[3, 1, 3] += 0.05
    v = check.readings(got, ref, first_judged=2)
    assert v["step_m"] == pytest.approx(0.05) and v["missing"] == 0
    got[4] = np.nan
    assert check.readings(got, ref, first_judged=2)["missing"] == 1
    ok, checks = check.judge({"step_m": 0.01, "missing": 0}, {"step_m": 0.02, "missing": 0})
    assert ok and list(checks) == ["step_m", "missing"]


@pytest.mark.cuda
def test_caster_on_the_card_matches_the_cpu(cuda_device):
    sensor = dict(spec.config("hdl64_kitti")["sensor"], range_noise=0.0)
    circ = dataclasses.replace(
        circuit.make_circuit(spec.traffic("car-log"), sensor), n_sweeps=10)
    laps = []
    for dev in ("cpu", cuda_device):
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        laps.append(raycast.render_lap(circ, sensor, g, dev))
    np.testing.assert_array_equal(laps[0]["offsets"], laps[1]["offsets"])
    np.testing.assert_allclose(laps[0]["xyz"], laps[1]["xyz"], rtol=0, atol=1e-5)
