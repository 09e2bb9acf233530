"""Kernels the localization ICP issued per profiled sweep: the runtime's
launch calls on the host (names starting `cudaLaunch` or `cuLaunch`) that
start inside a `slam.icp` span."""

from slambench import spanread


def read(trace):
    return spanread.per_sweep(trace, lambda roots: len(spanread.starting_inside(
        spanread.launches(trace), spanread.named(roots, "slam.icp"))))
