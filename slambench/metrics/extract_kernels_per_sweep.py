"""Device kernels per profiled sweep of keypoint extraction: the kernels
(copies and memsets not counted) that start after each of the program's
marker kernels `slam_mark_extract_begin` ends and end before the next
`slam_mark_extract_end` starts, the markers themselves not counted. None
where the trace holds no such pair: a program without the markers."""

from slambench import markers, traceread

BEGIN, END = "slam_mark_extract_begin", "slam_mark_extract_end"


def read(trace):
    gaps = [(b[1], e[0]) for b, e in markers.pairs(trace.device, BEGIN, END)]
    if not gaps or trace.sweeps <= 0:
        return None
    n = sum(1 for name, s, e in trace.device if not traceread.is_copy(name)
            for lo, hi in gaps if s >= lo and e <= hi)
    return n / trace.sweeps
