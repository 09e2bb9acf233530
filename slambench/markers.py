"""Pairs of the program's stage marker kernels in a device trace: empty
kernels named `slam_mark_<stage>_begin` / `slam_mark_<stage>_end`, launched
at a stage's two ends and captured into the graphs with it."""


def pairs(device, begin: str, end: str):
    """(begin marker, end marker) as two (start, end) ns intervals for each
    begin marker and the next end marker after it, in order. An end with no
    begin open before it, and a begin left open, pair with nothing."""
    marks = sorted((s, e, begin in name) for name, s, e in device
                   if begin in name or end in name)
    out, open_at = [], None
    for s, e, is_begin in marks:
        if is_begin:
            open_at = (s, e)
        elif open_at is not None:
            out.append((open_at, (s, e)))
            open_at = None
    return out
