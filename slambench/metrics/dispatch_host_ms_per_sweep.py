"""Host ms per profiled sweep in `slam.dispatch` spans, less the
`slam.sync` waits inside them: a streamed window's pack, upload and
CUDA-graph replays, time blocked in `cudaGraphLaunch` included."""

from slambench import spanread


def read(trace):
    return spanread.host_ms_of(trace, "slam.dispatch")
