"""Named accumulating timers (Utils::Timer parity, Utilities.h:353-399): a
copy of `lidarslam_tpu/utils/timer.py`, plus the port's stage spans.

Per-stage host wall-clock timing with running totals/averages. `init` /
`stop` / `stop_and_display` are the JAX package's timers. `span(name)`
brackets one stage of the port's per-sweep path (`slam.add_frame`,
`slam.icp.round`, ...):

- it always enters a `torch._C._profiler._RecordFunctionFast`, a no-op
  unless a torch.profiler is recording; under one the span is a host op on
  the profiler's clock, beside the aten ops and the device records it
  covers (`Slam.start_profiling`, `slambench/spanread.py`);
- while the timers are on (`enable`; `Slam` turns them on at verbosity
  >= 3) it also adds its host wall time to the named totals that `summary`
  returns, and when the outermost span closes it prints each span's time
  over that call, as the reference's `Utils::Timer` lines.

Spans add no device synchronization: a stage's time is the host's time in
it, waiting on the device only where the stage itself reads a result
(`slam.sync`).

A replayed CUDA graph is one host call, so host spans cannot split its
device time. `device_mark(name, device)` launches on a CUDA device the
empty kernel `slam_mark_<name>` (`ops/cuda_knn.mark`), which a graph
captures like any other kernel and a device trace names where it ran; on
the CPU it does nothing. The port marks the ends of the ego-motion
registration (`ego_begin`, `ego_end`).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast

_starts: dict = {}
_totals: dict = defaultdict(float)
_calls: dict = defaultdict(int)
_on = False        # span() feeds _totals / _calls
_depth = 0         # spans open while the timers are on
_call: dict = {}   # name -> [seconds, calls] within the open outermost span


def reset():
    _starts.clear()
    _totals.clear()
    _calls.clear()
    _call.clear()


def init(name: str):
    _starts[name] = time.perf_counter()


def stop(name: str) -> float:
    dt = time.perf_counter() - _starts.get(name, time.perf_counter())
    _totals[name] += dt
    _calls[name] += 1
    return dt


def stop_and_display(name: str, digits: int = 3) -> float:
    dt = stop(name)
    print(f"  -> {name} took : {dt*1000:.{digits}f} ms "
          f"(average : {average_ms(name):.{digits}f} ms)")
    return dt


def average_ms(name: str) -> float:
    c = _calls.get(name, 0)
    return _totals[name] * 1000.0 / c if c else 0.0


def summary() -> dict:
    return {name: {"calls": _calls[name], "total_s": _totals[name],
                   "average_ms": average_ms(name)} for name in _totals}


def enable(on: bool):
    """Turn the timers of `span` on or off (its profiler record is kept
    either way)."""
    global _on
    _on = bool(on)


def span(name: str):
    """A context manager over one stage: a profiler record named `name`,
    timed as well while the timers are on. Off, it costs one flag test and
    the record's no-op."""
    return _TimedSpan(name) if _on else _RecordFunctionFast(name)


def device_mark(name: str, device) -> None:
    """The device-side marker `slam_mark_<name>` on `device`'s current
    stream (a no-op off CUDA): always on, no work, no synchronization."""
    if torch.device(device).type == "cuda":
        from lidarslam_tpu_torch.ops import cuda_knn

        cuda_knn.mark(name, device)


class _TimedSpan:
    __slots__ = ("name", "_rec", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rec = _RecordFunctionFast(name)

    def __enter__(self):
        global _depth
        self._rec.__enter__()
        _call.setdefault(self.name, [0.0, 0])   # lines in the order spans open
        _depth += 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _depth
        dt = time.perf_counter() - self._t0
        _depth -= 1
        _totals[self.name] += dt
        _calls[self.name] += 1
        acc = _call[self.name]
        acc[0] += dt
        acc[1] += 1
        if _depth == 0:
            _display_call()
        self._rec.__exit__(*exc)
        return False


def _display_call(digits: int = 3):
    """One `Utils::Timer` line per span name of the call that just ended."""
    for name, (dt, n) in _call.items():
        times = f" in {n} spans" if n > 1 else ""
        print(f"  -> {name} took : {dt*1000:.{digits}f} ms{times} "
              f"(average : {average_ms(name):.{digits}f} ms)")
    _call.clear()
