"""The program's own stage spans in a profiled stretch (`traceread.Trace`).

The port brackets each stage of its per-sweep path in a span named
`slam.*` (`lidarslam_tpu_torch/utils/timer.py`), recorded as a host op on
the profiler's clock, so the spans arrive in `Trace.host` beside the aten
ops and the runtime calls. Spans nest by time on the calling thread:
`tree` rebuilds that nesting by containment. A span's host time is its
duration minus the `slam.sync` spans inside it (where the host waited on
the device); its self time, its duration minus its child spans'.

Each reader in `slambench/metrics/` that uses this module returns None
where the run holds no root span of its path: a program without spans has
nothing to read.
"""

from __future__ import annotations

import bisect

from slambench import traceread

PREFIX = "slam."
SYNC = "slam.sync"
# the spans that open each public call of a path
ROOTS = {"live": ("slam.add_frame",), "log": ("slam.add_frame_async", "slam.flush")}
# runtime calls that launch a kernel
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


class Span:
    __slots__ = ("name", "start", "end", "children")

    def __init__(self, name: str, start: int, end: int):
        self.name, self.start, self.end = name, start, end
        self.children = []

    def walk(self):
        """This span and every span inside it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def ns(self) -> int:
        return self.end - self.start

    def host_ns(self) -> int:
        """Duration less the `slam.sync` spans inside it (outermost ones)."""
        if self.name == SYNC:
            return 0
        return self.ns() - sum(c.ns() if c.name == SYNC else c.ns() - c.host_ns()
                               for c in self.children)

    def self_ns(self) -> int:
        return self.ns() - sum(c.ns() for c in self.children)


def tree(trace) -> list:
    """The outermost `slam.*` spans of the trace, each holding the spans
    inside it, in order of start."""
    recs = sorted((r for r in trace.host if r[0].startswith(PREFIX)),
                  key=lambda r: (r[1], -r[2]))
    roots, stack = [], []
    for name, s, e in recs:
        sp = Span(name, s, e)
        while stack and not (s >= stack[-1].start and e <= stack[-1].end):
            stack.pop()
        (stack[-1].children if stack else roots).append(sp)
        stack.append(sp)
    return roots


def roots(trace) -> list:
    """The root spans of the trace's path (`ROOTS`), or [] where none."""
    return [r for r in tree(trace) if r.name in ROOTS.get(trace.path, ())]


def named(spans, name: str) -> list:
    """Every span called `name` at or under `spans`."""
    return [s for r in spans for s in r.walk() if s.name == name]


def starting_inside(records, spans) -> list:
    """The (name, start, end) records whose start lies inside one of the
    spans."""
    ivs = traceread.merged((s.start, s.end) for s in spans)
    lows = [lo for lo, _ in ivs]
    out = []
    for rec in records:
        i = bisect.bisect_right(lows, rec[1]) - 1
        if i >= 0 and rec[1] <= ivs[i][1]:
            out.append(rec)
    return out


def launches(trace) -> list:
    """The host's runtime calls that launch a kernel."""
    return [r for r in trace.host if r[0].startswith(LAUNCH_PREFIXES)]


def per_sweep(trace, total):
    """`total(roots)` of the path's root spans over the sweeps profiled:
    None where the run holds no root."""
    rs = roots(trace)
    if not rs or trace.sweeps <= 0:
        return None
    return total(rs) / trace.sweeps


def host_ms_of(trace, name: str):
    """Host ms per sweep of the spans called `name` under the path's roots
    (0 where there are none)."""
    return per_sweep(trace, lambda rs: sum(s.host_ns() for s in named(rs, name)) / 1e6)
