"""Device busy ms per profiled sweep of a path: the union of the
device's kernel, copy and memset intervals over the sweeps profiled."""


def read(trace):
    if trace.sweeps <= 0:
        return None
    busy = trace.busy_ms()
    return busy / trace.sweeps if busy > 0 else None
