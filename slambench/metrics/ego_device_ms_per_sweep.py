"""Device ms per profiled sweep of the ego-motion registration: the union
of the device's kernel, copy and memset intervals between each of the
program's marker kernels `slam_mark_ego_begin` and the next
`slam_mark_ego_end` (launched at the ends of the stage, captured into the
live graph with it), clipped to that stretch. None where the trace holds no
such pair: a program without the markers, or without the stage."""

from slambench import traceread

BEGIN, END = "slam_mark_ego_begin", "slam_mark_ego_end"


def stretches(device):
    """(start, end) ns of each begin marker's start to the next end
    marker's end, in order."""
    marks = sorted((s, e, BEGIN in name) for name, s, e in device
                   if BEGIN in name or END in name)
    out, open_at = [], None
    for s, e, begin in marks:
        if begin:
            open_at = s
        elif open_at is not None:
            out.append((open_at, e))
            open_at = None
    return out


def read(trace):
    spans = stretches(trace.device)
    if not spans or trace.sweeps <= 0:
        return None
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in trace.device for lo, hi in spans
               if s < hi and e > lo]
    return traceread.union_ns(clipped) / 1e6 / trace.sweeps
