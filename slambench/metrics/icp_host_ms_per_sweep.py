"""Host ms per profiled sweep in `slam.icp` spans, less the `slam.sync`
waits inside them: the localization ICP (`icp_register`: its rounds of
matching and LM, the launches of their kernels)."""

from slambench import spanread


def read(trace):
    return spanread.host_ms_of(trace, "slam.icp")
