"""torch.profiler readings: device-busy time and per-kernel tables (the
counterpart of the JAX package's xplane parser, `lidarslam_tpu/utils/profiling.py`).

A source is either a `torch.profiler.profile` that has stopped or the path
of the Chrome trace it exported (`Slam.stop_profiling` writes one). Device
work is every CUDA kernel, memcpy and memset the trace records on the
device's streams; `device_busy_ms` sums their durations, so kernels that
overlap on two streams count twice (the port launches on one).
"""

from __future__ import annotations

import collections
import glob
import json
import os

# Chrome-trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel-name fragments (lower case) -> category, first match wins
_CATEGORIES = (("knn_", "knn"), ("memcpy", "memcpy"), ("memset", "memset"),
               ("gemm", "gemm"), ("gemv", "gemm"), ("cutlass", "gemm"),
               ("sort", "sort"), ("scan", "scan"), ("reduce", "reduce"),
               ("index", "index"), ("scatter", "index"), ("gather", "index"),
               ("elementwise", "elementwise"))


def find_trace(logdir: str):
    """Newest Chrome trace (*.json) under `logdir`, or None."""
    paths = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def category(name: str) -> str:
    """The category of a device kernel's name: knn, memcpy, memset, gemm,
    sort, scan, reduce, index, elementwise or other."""
    low = name.lower()
    return next((cat for frag, cat in _CATEGORIES if frag in low), "other")


def _device_events(source):
    """(name, microseconds, executions) of the source's device work."""
    if isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            events = json.load(f).get("traceEvents", [])
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS:
                yield ev["name"], float(ev.get("dur", 0.0)), 1
        return
    import torch

    # the profiler's raw records: `key_averages()` would first build a
    # FunctionEvent tree of every record in Python, ~0.2 ms each (tens of
    # seconds for a window of stream frames of ~40k kernels each)
    cuda = torch.autograd.DeviceType.CUDA
    for evt in source.profiler.kineto_results.events():
        if evt.device_type() == cuda and not evt.is_user_annotation():
            yield evt.name(), (evt.end_ns() - evt.start_ns()) / 1000.0, 1


def device_busy_ms(source) -> float:
    """Total device-occupied time (ms): the kernels, copies and memsets."""
    return sum(us for _, us, _ in _device_events(source)) / 1000.0


def op_totals(source):
    """Per-kernel totals: (ms Counter by kernel name, executions Counter by
    kernel name, ms Counter by `category`)."""
    dur = collections.Counter()
    cnt = collections.Counter()
    cat = collections.Counter()
    for name, us, n in _device_events(source):
        dur[name] += us / 1000.0
        cnt[name] += n
        cat[category(name)] += us / 1000.0
    return dur, cnt, cat
