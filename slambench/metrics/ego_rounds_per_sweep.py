"""Ego-motion registration rounds per profiled sweep that began with the
gate open, out of the preset's `ICP_max_iter` (4): the program counts them
on the device, reads them with the sweep's packed scalars and records one
`slam.ego.round` span per round inside a `slam.ego.counts` span. None
where the trace holds no `slam.ego.counts` span (a program without the
counters, or without the stage)."""

from slambench import spanread


def read(trace):
    counted = spanread.named(spanread.roots(trace), "slam.ego.counts")
    if not counted or trace.sweeps <= 0:
        return None
    return len(spanread.named(counted, "slam.ego.round")) / trace.sweeps
