"""Device ms per profiled sweep of keypoint extraction: the union of the
device's kernel, copy and memset intervals from each of the program's
marker kernels `slam_mark_extract_begin` to the next
`slam_mark_extract_end` (launched at the ends of the stage, compaction
included, and captured into the graphs with it), clipped to that stretch.
None where the trace holds no such pair: a program without the markers."""

from slambench import markers, traceread

BEGIN, END = "slam_mark_extract_begin", "slam_mark_extract_end"


def read(trace):
    spans = [(b[0], e[1]) for b, e in markers.pairs(trace.device, BEGIN, END)]
    if not spans or trace.sweeps <= 0:
        return None
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in trace.device for lo, hi in spans
               if s < hi and e > lo]
    return traceread.union_ns(clipped) / 1e6 / trace.sweeps
