"""Ego-motion registration LM trips per profiled sweep that began before
their solve converged, in the rounds begun with the gate open, out of
`ICP_max_iter` x `LM_max_iter` (60): counted on the device, read with the
sweep's packed scalars, one `slam.ego.lm_step` span each inside a
`slam.ego.counts` span. None where the trace holds no `slam.ego.counts`
span."""

from slambench import spanread


def read(trace):
    counted = spanread.named(spanread.roots(trace), "slam.ego.counts")
    if not counted or trace.sweeps <= 0:
        return None
    return len(spanread.named(counted, "slam.ego.lm_step")) / trace.sweeps
