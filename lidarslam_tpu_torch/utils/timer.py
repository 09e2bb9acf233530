"""Named accumulating timers (Utils::Timer parity, Utilities.h:353-399): a
copy of `lidarslam_tpu/utils/timer.py`.

Per-stage host wall-clock timing with running totals/averages, used by the
orchestrator's verbosity instrumentation. For device-side profiles use
`Slam.start_profiling` (torch.profiler, `utils/profiling.py`); these timers
bracket device synchronizations, so they measure what the user experiences
per pipeline stage.
"""

from __future__ import annotations

import time
from collections import defaultdict

_starts: dict = {}
_totals: dict = defaultdict(float)
_calls: dict = defaultdict(int)


def reset():
    _starts.clear()
    _totals.clear()
    _calls.clear()


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
