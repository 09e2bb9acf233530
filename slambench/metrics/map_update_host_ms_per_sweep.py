"""Host ms per profiled sweep in `slam.map_update` spans, less the
`slam.sync` waits inside them: a keyframe's map update (the roll and
`add_points` of each map); 0 over sweeps that made no keyframe."""

from slambench import spanread


def read(trace):
    return spanread.host_ms_of(trace, "slam.map_update")
