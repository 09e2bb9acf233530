"""Replays of `Slam.add_frame`'s captured step per profiled sweep: the
count of `slam.replay` spans under `slam.add_frame` (0 where every sweep's
step is launched op by op from the host)."""

from slambench import spanread


def read(trace):
    return spanread.per_sweep(trace, lambda roots: len(spanread.named(roots, "slam.replay")))
