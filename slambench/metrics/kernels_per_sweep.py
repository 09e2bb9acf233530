"""Device kernels per profiled sweep of a path (copies and
memsets not counted)."""


def read(trace):
    if trace.sweeps <= 0:
        return None
    n = trace.kernels()
    return n / trace.sweeps if n > 0 else None
