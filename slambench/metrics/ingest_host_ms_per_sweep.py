"""Host ms per profiled sweep in `slam.ingest` spans, less the `slam.sync`
waits inside them: the sweep's build and upload (`Slam._build_ri`: the
native ingest and its copy to the card)."""

from slambench import spanread


def read(trace):
    return spanread.host_ms_of(trace, "slam.ingest")
