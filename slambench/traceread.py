"""Readings of a torch.profiler window: device busy, kernels, idle gaps.

A frozen copy of the arithmetic of `lidarslam_tpu_torch/utils/profiling.py`
(device work is every CUDA kernel, memcpy and memset the profiler records
on the device, read from its raw records rather than `key_averages()`), with
one change: busy time is the union of the device intervals, so two kernels
that overlap on two streams count once (`device_busy_ms` there sums them).

`Trace` holds plain (name, start_ns, end_ns) lists, so the per-layer
readers in `slambench/metrics/` and the tests need no profiler.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass

_LOOKBACK = 64


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_ns(intervals) -> int:
    """Length covered by the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


@dataclass
class Trace:
    """One profiled stretch of a run: its device work and host ops as
    (name, start_ns, end_ns), how many sweeps it covered, which path
    ("live" or "log"), and the same run's untraced ms per sweep timed just
    before it."""

    device: list
    host: list
    sweeps: int
    path: str
    untraced_ms_per_sweep: float

    def busy_ms(self) -> float:
        return union_ns((s, e) for _, s, e in self.device) / 1e6

    def kernels(self) -> int:
        return sum(1 for name, _, _ in self.device if not is_copy(name))

    def ms_named(self, fragment: str) -> float:
        """Device ms of the kernels whose name holds `fragment` (one stream:
        a plain sum)."""
        return sum(e - s for name, s, e in self.device if fragment in name.lower()) / 1e6

    def top_ops(self, n: int = 10):
        """[name, seconds] of the device operations that took the most."""
        tot = collections.Counter()
        for name, s, e in self.device:
            tot[name] += (e - s) / 1e9
        return [[k, v] for k, v in tot.most_common(n)]

    def idle_gaps(self, n: int = 10):
        """[host op, seconds]: the device's idle gaps inside the profiled
        stretch, each named by the innermost host op running at its middle
        ("no host op" where none was), summed by name, longest first."""
        busy = merged((s, e) for _, s, e in self.device)
        if not busy:
            return []
        lo = min([busy[0][0]] + [s for _, s, _ in self.host])
        hi = max([busy[-1][1]] + [e for _, _, e in self.host])
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot = collections.Counter()
        for s, e in gaps:
            mid = (s + e) // 2
            best = None
            # the last _LOOKBACK host ops that started before the middle:
            # the innermost one still running is among them
            i = bisect.bisect_right(starts, mid)
            for name, hs, he in host[max(0, i - _LOOKBACK):i]:
                if he >= mid and (best is None or he - hs < best[1]):
                    best = (name, he - hs)
            tot[best[0] if best else "no host op"] += (e - s) / 1e9
        return [[k, v] for k, v in tot.most_common(n)]


def from_profile(prof, **kw) -> Trace:
    """A Trace of a stopped `torch.profiler.profile`, from its raw records
    (`key_averages()` would first build a Python event tree of every one)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for evt in prof.profiler.kineto_results.events():
        if evt.is_user_annotation():
            continue
        rec = (evt.name(), int(evt.start_ns()), int(evt.end_ns()))
        (device if evt.device_type() == cuda else host).append(rec)
    return Trace(device=device, host=host, **kw)
