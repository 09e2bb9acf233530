"""Host ms per profiled sweep in `slam.extract` spans, less the
`slam.sync` waits inside them: keypoint extraction (the launches of its
kernels)."""

from slambench import spanread


def read(trace):
    return spanread.host_ms_of(trace, "slam.extract")
