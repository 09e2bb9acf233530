"""Host session ms per profiled sweep of a path: the self time of the
program's root spans (`slam.add_frame`; `slam.add_frame_async` and
`slam.flush`), their duration less the spans inside them (`slam.ingest`,
`slam.step`, `slam.dispatch`, `slam.sync`): the float64 bookkeeping, logs,
confidence and outputs, and on the log path the enqueue and the flush's
per-sweep apply."""

from slambench import spanread


def read(trace):
    return spanread.per_sweep(trace, lambda roots: sum(r.self_ns() for r in roots) / 1e6)
