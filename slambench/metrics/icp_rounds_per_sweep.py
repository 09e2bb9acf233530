"""Localization ICP rounds run per profiled sweep: the count of
`slam.icp.round` spans inside `slam.icp` (the host's early exit ends the
loop before `localization_icp_max_iter` rounds)."""

from slambench import spanread


def read(trace):
    return spanread.per_sweep(trace, lambda roots: len(
        spanread.named(spanread.named(roots, "slam.icp"), "slam.icp.round")))
