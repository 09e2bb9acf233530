"""Device ms per profiled sweep of the localization ICP: the union of the
device's kernel, copy and memset intervals that start inside a `slam.icp`
span. Sound where the device mostly idles (the live path), so a kernel
starts within microseconds of its launch."""

from slambench import spanread, traceread


def read(trace):
    return spanread.per_sweep(trace, lambda roots: traceread.union_ns(
        (s, e) for _, s, e in spanread.starting_inside(
            trace.device, spanread.named(roots, "slam.icp"))) / 1e6)
