"""Host waits on the device per profiled sweep: the count of `slam.sync`
spans under the path's root spans."""

from slambench import spanread


def read(trace):
    return spanread.per_sweep(trace, lambda roots: len(spanread.named(roots, spanread.SYNC)))
