"""Device ms per profiled sweep of the hand-written k-NN kernels (every
kernel whose name holds knn_: knn_plan, knn_prefix, knn_scan, knn_merge) on
a path."""


def read(trace):
    if trace.sweeps <= 0:
        return None
    ms = trace.ms_named("knn_")
    return ms / trace.sweeps if ms > 0 else None
