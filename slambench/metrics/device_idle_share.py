"""Device idle share of a path [%]: 1 - (the union of the
device's kernel, copy and memset intervals per profiled sweep) / (the same
run's untraced ms per sweep, timed just before the profiled sweeps). The
profiled stretch's own wall time is not the denominator: the profiler
stretches it."""


def read(trace):
    if trace.sweeps <= 0 or trace.untraced_ms_per_sweep <= 0:
        return None
    busy = trace.busy_ms() / trace.sweeps
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / trace.untraced_ms_per_sweep)
