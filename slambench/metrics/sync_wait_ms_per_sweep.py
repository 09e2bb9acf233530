"""Ms per profiled sweep the host spent in `slam.sync` spans, waiting on
the device: reading a result back (the ICP's early exit, the packed
scalars, a keyframe's overflow counts, a host log tier's keypoints; on the
log path the flush's one copy) or a blocking copy from pageable memory
(the live path's three input poses)."""

from slambench import spanread


def read(trace):
    return spanread.per_sweep(
        trace, lambda roots: sum(s.ns() for s in spanread.named(roots, spanread.SYNC)) / 1e6)
