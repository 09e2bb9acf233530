"""The port's stage spans (`utils/timer.span`) on the CPU, and the
benchmark's readers of them (`slambench/spanread.py`,
`slambench/metrics/*`).

Under torch.profiler, `add_frame` and `add_frame_async` + `flush` give
the span tree `Slam.start_profiling` documents, every host read of a
device result sits in a `slam.sync` span of its own, and the spans reach
`slambench.traceread.from_profile(...).host`. Each reader gives its
number on a hand-built trace and nothing where the spans are absent. The
timers stay off, and `get_timing_summary` empty, below verbosity 3."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidarslam_tpu_torch import Slam
from lidarslam_tpu_torch.config import ExtractorConfig, MapConfig, SlamConfig
from lidarslam_tpu_torch.io import synthetic as tsyn
from lidarslam_tpu_torch.utils import timer
from test_torch_slam import _one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from slambench import spanread, spec, traceread  # noqa: E402

READ = "test.read"     # the probe's record around a read of a tensor's value
UPLOAD = "test.upload"  # and around a tensor made from host data on a device
# Tensor methods that read a value back to the host (on a card: a sync)
READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__float__")


def _config(**kw):
    return SlamConfig(
        extractor=ExtractorConfig(n_rings=16, max_ring_points=512, max_keypoints=256),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 13, grid_size=26),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 13, grid_size=26),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 13, grid_size=26), **kw)


@pytest.fixture(scope="module")
def frames():
    return tsyn.generate_sequence(n_frames=7, motion_distortion=False,
                                  sensor=tsyn.SensorModel(n_azimuth=500))


def _probed(fn, name=READ, needs=None):
    def probe(*args, **kw):
        if needs is not None and needs not in kw:
            return fn(*args, **kw)
        with torch._C._profiler._RecordFunctionFast(name):
            return fn(*args, **kw)
    return probe


def _profiled(run, path, sweeps):
    """A Trace of `run()` under the CPU profiler, with a `test.read` record
    around every read of a tensor's value and a `test.upload` one around
    `torch.tensor(..., device=...)` (from pageable memory on a card: a
    blocking copy)."""
    mp = pytest.MonkeyPatch()
    try:
        for name in READS:
            mp.setattr(torch.Tensor, name, _probed(getattr(torch.Tensor, name)))
        mp.setattr(torch, "tensor", _probed(torch.tensor, UPLOAD, needs="device"))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    finally:
        mp.undo()
    return traceread.from_profile(prof, sweeps=sweeps, path=path, untraced_ms_per_sweep=1.0)


@pytest.fixture(scope="module")
def live(frames):
    cfg = _config()
    slam = Slam(cfg, device="cpu")
    for f in frames[:3]:
        slam.add_frame(f)

    def run():
        for f in frames[3:6]:
            slam.add_frame(f)
    return cfg, _profiled(run, "live", 3)


@pytest.fixture(scope="module")
def log(frames):
    """The first segment opens on an empty map (an eager first step); a
    window of 2 dispatches every second sweep, and the flush drains the
    last sweep's partial window."""
    slam = Slam(_config(stream_window=2), device="cpu")

    def run():
        for f in frames[:6]:
            slam.add_frame_async(f)
        slam.flush()
    return _profiled(run, "log", 6)


def _names(spans):
    return [s.name for s in spans]


def test_spans_are_host_ops_of_the_trace(live):
    """The spans reach `from_profile`'s host list (no user annotations),
    all named `slam.*`, each add_frame one root."""
    _, t = live
    names = {n for n, _, _ in t.host}
    assert {"slam.add_frame", "slam.step", "slam.icp.round", "slam.sync"} <= names
    assert not any(n.startswith("slam.") for n, _, _ in t.device)
    assert _names(spanread.tree(t)) == ["slam.add_frame"] * 3
    assert all(s.name.startswith("slam.") for r in spanread.tree(t) for s in r.walk())


def test_live_span_tree(live):
    """The eager step reads nothing back: every ICP round runs, the map
    update is computed on every sweep, and the root reads the packed
    scalars once after the step."""
    cfg, t = live
    for root in spanread.roots(t):
        kids = _names(root.children)
        # the three pose uploads of the inputs, the step, its one read
        assert kids[-5:] == ["slam.sync"] * 3 + ["slam.step", "slam.sync"]
        assert set(kids[:-5]) <= {"slam.ingest"}
        (step,) = [c for c in root.children if c.name == "slam.step"]
        assert _names(step.children) == ["slam.extract", "slam.submap", "slam.icp",
                                         "slam.map_update"]
        assert not spanread.named([step], "slam.sync")
        (icp,) = [c for c in step.children if c.name == "slam.icp"]
        assert len(icp.children) == cfg.localization_icp_max_iter
        for rnd in icp.children:
            assert rnd.name == "slam.icp.round"
            assert _names(rnd.children) == ["slam.icp.match", "slam.icp.solve"]


def test_log_span_tree(log):
    roots = spanread.roots(log)
    assert _names(roots) == ["slam.add_frame_async"] * 6 + ["slam.flush"]
    first, *rest = roots[:6]
    # the first sweep estimates the azimuthal resolution from its points
    assert _names(first.children) == ["slam.ingest", "slam.sync", "slam.step"]
    for i, r in enumerate(rest):
        assert _names(r.children) == ["slam.ingest"] + ["slam.dispatch"] * (i % 2)
    assert _names(roots[-1].children) == ["slam.step", "slam.sync"]
    steps = spanread.named(roots, "slam.step") + spanread.named(roots, "slam.dispatch")
    assert len(spanread.named(steps, "slam.extract")) == 6
    # the streaming step reads nothing back: past the first sweep, the
    # flush's copy is the one read
    assert len(spanread.named(roots[1:], "slam.sync")) == 1


@pytest.mark.parametrize("path", ["live", "log"])
def test_every_host_read_is_in_a_sync_span(path, live, log):
    """Every read of a tensor's value lies in a `slam.sync` span, and every
    such span holds a read or a blocking upload."""
    t = live[1] if path == "live" else log
    syncs = spanread.named(spanread.roots(t), "slam.sync")
    reads = [r for r in t.host if r[0] == READ]
    uploads = [r for r in t.host if r[0] == UPLOAD]
    assert reads and syncs
    assert spanread.starting_inside(reads, syncs) == reads
    for s in syncs:
        assert spanread.starting_inside(reads + uploads, [s])


def test_timers_off_keep_the_summary_empty(frames, capsys):
    timer.reset()
    slam = Slam(_config(), device="cpu")
    for f in frames[:2]:
        slam.add_frame(f)
    for f in frames[2:4]:
        slam.add_frame_async(f)
    slam.flush()
    assert slam.get_timing_summary() == {}
    assert "took" not in capsys.readouterr().out


def test_span_times_while_the_timers_are_on(capsys, monkeypatch):
    """Off, a span is the profiler record itself; on, it adds its time to
    the named totals and prints the outermost span's call, one line per
    name in the order the spans opened."""
    now = [0.0]
    monkeypatch.setattr(timer.time, "perf_counter", lambda: now[0])
    timer.reset()
    timer.enable(False)
    assert isinstance(timer.span("slam.a"), torch._C._profiler._RecordFunctionFast)
    timer.enable(True)
    try:
        with timer.span("slam.a"):
            for _ in range(2):
                with timer.span("slam.b"):
                    now[0] += 0.25
            now[0] += 0.5
        assert capsys.readouterr().out.splitlines() == [
            "  -> slam.a took : 1000.000 ms (average : 1000.000 ms)",
            "  -> slam.b took : 500.000 ms in 2 spans (average : 250.000 ms)"]
        assert timer.summary() == {
            "slam.a": {"calls": 1, "total_s": 1.0, "average_ms": 1000.0},
            "slam.b": {"calls": 2, "total_s": 0.5, "average_ms": 250.0}}
    finally:
        timer.enable(False)
        timer.reset()


MS = 1_000_000


def _hand_built(path):
    """One root's spans, launches and device records over two sweeps, in ms."""
    if path == "live":
        spans = [("slam.add_frame", 0, 100), ("slam.ingest", 1, 3), ("slam.step", 5, 90),
                 ("slam.extract", 6, 16), ("slam.icp", 20, 70),
                 ("slam.icp.round", 20, 45), ("slam.icp.match", 21, 30),
                 ("slam.icp.solve", 31, 40), ("slam.sync", 41, 44),
                 ("slam.icp.round", 46, 70), ("slam.icp.match", 47, 55),
                 ("slam.icp.solve", 56, 65), ("slam.sync", 66, 69),
                 ("slam.sync", 72, 76), ("slam.map_update", 78, 88), ("slam.sync", 85, 87),
                 ("slam.replay", 88, 89)]
        other = [("aten::mul", 22, 23), ("cudaLaunchKernel", 22, 22),
                 ("cuLaunchKernel", 50, 50), ("cudaLaunchKernelExC", 60, 60),
                 ("cudaLaunchKernel", 8, 8), ("cudaMemcpyAsync", 30, 30)]
        device = [("k1", 23, 25), ("k2", 24, 26), ("knn_scan", 51, 52), ("k3", 69, 72),
                  ("k4", 71, 73), ("k5", 9, 10)]
    else:
        spans = [("slam.add_frame_async", 0, 10), ("slam.ingest", 1, 3),
                 ("slam.add_frame_async", 10, 30), ("slam.ingest", 11, 12),
                 ("slam.dispatch", 13, 28), ("slam.flush", 40, 60),
                 ("slam.dispatch", 41, 45), ("slam.sync", 50, 58)]
        other = [("cudaGraphLaunch", 14, 20)]
        device = [("k1", 15, 30)]
    ms = [(n, s * MS, e * MS) for n, s, e in spans + other]
    return traceread.Trace(device=[(n, s * MS, e * MS) for n, s, e in device], host=ms,
                           sweeps=2, path=path, untraced_ms_per_sweep=50.0)


# each new reader on `_hand_built`, per sweep of its two
SPAN_READINGS = {
    "session_host_ms_per_sweep.live": 13 / 2,        # 100 - ingest 2 - step 85
    "ingest_host_ms_per_sweep.live": 2 / 2,
    "extract_host_ms_per_sweep.live": 10 / 2,
    "icp_host_ms_per_sweep.live": (50 - 3 - 3) / 2,   # less the rounds' syncs
    "map_update_host_ms_per_sweep.live": (10 - 2) / 2,
    "sync_wait_ms_per_sweep.live": (3 + 3 + 4 + 2) / 2,
    "syncs_per_sweep.live": 4 / 2,
    "icp_rounds_per_sweep.live": 2 / 2,
    "icp_launches_per_sweep.live": 3 / 2,             # not the extractor's, not a copy
    "icp_device_ms_per_sweep.live": (3 + 1 + 3) / 2,  # union of k1 k2, knn_scan, k3
    "session_host_ms_per_sweep.log": (8 + 4 + 8) / 2,
    "ingest_host_ms_per_sweep.log": 3 / 2,
    "sync_wait_ms_per_sweep.log": 8 / 2,
    "dispatch_host_ms_per_sweep.log": 19 / 2,
    "live_replays_per_sweep.live": 1 / 2,
}


def test_every_span_metric_is_listed_with_its_cells():
    bench = spec.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    assert set(SPAN_READINGS) <= set(listed)
    for name in SPAN_READINGS:
        m = listed[name]
        assert m["source"] == "device_trace" and m["workloads"]
        path = name.rpartition(".")[2]
        assert all(spec.traffic(spec.workload(bench, w)["traffic"])["path"] == path
                   for w in m["workloads"])


@pytest.mark.parametrize("name", sorted(SPAN_READINGS))
def test_reader_of_the_spans(name):
    path = name.rpartition(".")[2]
    read = spec.reader(name)
    assert read(_hand_built(path)) == pytest.approx(SPAN_READINGS[name])
    # the other path's run, and a program without spans, give nothing
    assert read(_hand_built("log" if path == "live" else "live")) is None
    bare = _hand_built(path)
    bare.host = [h for h in bare.host if not h[0].startswith(spanread.PREFIX)]
    assert read(bare) is None


def test_readers_on_a_profiled_run(live, log):
    """On the CPU runs above: the numbers that need no device."""
    _, t = live
    read = spec.reader
    rounds = read("icp_rounds_per_sweep.live")(t)
    assert 1 <= rounds <= 3
    assert read("syncs_per_sweep.live")(t) >= rounds + 1
    assert read("icp_launches_per_sweep.live")(t) == 0.0   # no kernel on the CPU
    for name in ("session_host_ms_per_sweep.live", "extract_host_ms_per_sweep.live",
                 "icp_host_ms_per_sweep.live"):
        assert read(name)(t) > 0
    assert read("session_host_ms_per_sweep.log")(log) > 0
    assert read("dispatch_host_ms_per_sweep.log")(log) > 0
