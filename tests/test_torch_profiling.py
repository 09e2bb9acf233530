"""The port's timers and profiler hooks on the CPU: `utils/timer.py` (as the
JAX package's), `utils/profiling.py` (`find_trace`, `device_busy_ms`,
`op_totals`) on a Chrome trace with device events and on a CPU trace, and
`Slam.start_profiling` / `stop_profiling` / `get_timing_summary`."""

import dataclasses
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidarslam_tpu.utils import timer as jtimer
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.io import synthetic as tsyn
from lidarslam_tpu_torch.utils import profiling, timer
from test_slam_e2e import small_config
from test_torch_slam import _one_torch_thread, _torch_config  # noqa: F401


def test_timer_accumulates_as_jax(capsys, monkeypatch):
    """init / stop / stop_and_display / summary on a fake clock, against the
    JAX package's timer on the same clock."""
    now = [0.0]
    monkeypatch.setattr(timer.time, "perf_counter", lambda: now[0])
    for mod in (timer, jtimer):
        mod.reset()
        for start, stop, fn in ((1.0, 1.25, mod.stop), (2.0, 2.5, mod.stop_and_display)):
            now[0] = start
            mod.init("step")
            now[0] = stop
            assert fn("step") == stop - start
        assert "-> step took : 500.000 ms (average : 375.000 ms)" in capsys.readouterr().out
    assert timer.summary() == jtimer.summary() == {
        "step": {"calls": 2, "total_s": 0.75, "average_ms": 375.0}}
    timer.reset()
    assert timer.summary() == {} and timer.average_ms("step") == 0.0


def _trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_find_trace_returns_the_newest(tmp_path):
    assert profiling.find_trace(str(tmp_path)) is None
    old = _trace(tmp_path / "a.pt.trace.json", [])
    os.makedirs(tmp_path / "sub")
    new = _trace(tmp_path / "sub" / "b.pt.trace.json", [])
    os.utime(old, (1, 1))
    assert profiling.find_trace(str(tmp_path)) == new


def test_device_busy_and_op_totals_of_a_trace_file(tmp_path):
    """Kernels, copies and memsets count, each by its category; host ops,
    runtime calls and non-complete events do not."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void knn_scan<10>(...)", "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void knn_scan<10>(...)", "dur": 6.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128>()",
         "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "void cub::DeviceRadixSortOnesweepKernel()",
         "dur": 3.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "dur": 2.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 50.0},
        {"ph": "f", "cat": "ac2g", "name": "flow"},
    ]
    path = _trace(tmp_path / "t.json", ev)
    assert profiling.device_busy_ms(path) == pytest.approx(0.027)
    dur, cnt, cat = profiling.op_totals(path)
    assert cnt["void knn_scan<10>(...)"] == 2 and dur["void knn_scan<10>(...)"] == 0.016
    assert dict(cat) == pytest.approx({"knn": 0.016, "elementwise": 0.005, "sort": 0.003,
                                       "memcpy": 0.002, "memset": 0.001})
    assert "aten::add" not in cnt and "cudaLaunchKernel" not in cnt
    assert profiling.category("void some_fused_thing()") == "other"


def test_cpu_trace_has_no_device_time(tmp_path):
    """A torch.profiler run on the CPU, read from the profile object and from
    its exported trace: host ops only, so no device time and no kernels."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = str(tmp_path / "cpu.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    for source in (prof, path):
        assert profiling.device_busy_ms(source) == 0.0
        assert all(not c for c in profiling.op_totals(source))


def test_slam_profiling_hooks_and_timing_summary(tmp_path, capsys):
    """start_profiling / stop_profiling write a Chrome trace of the frames
    in between under log_dir, the stage spans among its host ops; at
    verbosity 3 add_frame times its stage spans, reported by
    get_timing_summary and printed once a sweep."""
    frames = tsyn.generate_sequence(n_frames=2, motion_distortion=False,
                                    sensor=tsyn.SensorModel(n_azimuth=500))
    cfg = _torch_config(small_config())
    cfg = dataclasses.replace(cfg, verbosity=3, extractor=dataclasses.replace(
        cfg.extractor, max_ring_points=512, max_keypoints=256))
    timer.reset()
    slam = TSlam(cfg, device="cpu")
    log_dir = str(tmp_path / "prof")
    slam.start_profiling(log_dir)
    for f in frames:
        slam.add_frame(f)
    path = slam.stop_profiling()
    assert os.path.dirname(path) == log_dir and profiling.find_trace(log_dir) == path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("cat") == "cpu_op" for e in events) > 100
    assert sum(e.get("name") == "slam.add_frame" for e in events) == 2
    assert profiling.device_busy_ms(path) == 0.0
    summary = slam.get_timing_summary()
    assert summary["slam.add_frame"]["calls"] == 2 and summary["slam.add_frame"]["total_s"] > 0
    assert {"slam.ingest", "slam.step", "slam.extract", "slam.icp", "slam.icp.round",
            "slam.sync"} <= set(summary)
    assert all(name.startswith("slam.") for name in summary)
    assert capsys.readouterr().out.count("-> slam.add_frame took") == 2
