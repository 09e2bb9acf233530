"""Whole runs of a cell at a tiny size on the CPU (the program's plain
versions), past the harness's look for a chip: a run prints its last line;
a cell made of existing files needs its `workloads` entry and its limits
file; and with the timed path broken underneath (`faults.py`), `correct`
comes out false. On a card, at each cell's own size over a whole window:
the control, the program in bfloat16, is not correct. ~3 min on the CPU:

    python -m pytest slambench/tests -q -o addopts="" -p no:cacheprovider
"""

import contextlib
import copy
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench import faults, readings, run, spec  # noqa: E402

# a VLP-16 cut to 360 firings a ring, and the first sweeps of the lap
TINY = readings.TINY
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(workload, seconds=2.0, trace=False, bench=None, seed=2**31 + 99):
    return run.execute(workload, seed, seconds, trace, bench=bench, **TINY)


def test_a_run_prints_its_last_line():
    res = _run("vlp16_outdoor.robot-live", trace=True)
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.emit(res)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device", "breakdown"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["window_s"] > 0
    assert set(line["checks"]) == {"step_m", "step_deg", "drift_m", "missing"}


def test_a_new_cell_of_existing_files_needs_its_entry_and_limits_file(tmp_path, monkeypatch):
    """A cell made of an existing configuration and mix: its `workloads`
    entry and its own limits file, both new; no existing file changes."""
    bench = copy.deepcopy(spec.benchmark())
    name = "vlp16_outdoor.car-live"
    assert name not in {w["name"] for w in bench["workloads"]}
    bench["workloads"].append({"name": name, "config": "vlp16_outdoor", "traffic": "car-live",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("live_"):
            m["workloads"].append(name)
    for f in spec.LIMITS.glob("*.json"):
        (tmp_path / f.name).write_text(f.read_text())
    monkeypatch.setattr(spec, "LIMITS", tmp_path)
    with pytest.raises(KeyError, match="no limits file"):
        _run(name, bench=bench)
    (tmp_path / f"{name}.json").write_text(
        (spec.LIMITS / "hdl64_kitti.car-live.json").read_text())
    res = _run(name, bench=bench)
    assert set(res["metrics"]) == {"live_p50_ms", "live_p90_ms", "setup_s"}
    assert res["correct"] is True


@pytest.fixture
def broken():
    """Break the program's timed path underneath the harness
    (`faults.planted`), undone after the test."""
    with contextlib.ExitStack() as stack:
        yield lambda kind: stack.enter_context(faults.planted(kind))


@pytest.mark.parametrize("workload,fault", [
    ("vlp16_outdoor.robot-live", "stuck"), ("vlp16_outdoor.robot-live", "altered"),
    ("vlp16_outdoor.robot-live", "once"),
    ("vlp16_outdoor.robot-log", "stuck"), ("vlp16_outdoor.robot-log", "altered"),
    ("vlp16_outdoor.robot-log", "half"), ("vlp16_outdoor.robot-log", "once")])
def test_a_broken_timed_path_is_not_correct(workload, fault, broken):
    broken(fault)
    res = _run(workload, seconds=1.5)
    assert res["correct"] is False, res["checks"]


def test_a_sound_log_run_is_correct():
    res = _run("vlp16_outdoor.robot-log", seconds=1.5)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and set(res["metrics"]) == {"log_sweeps_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_every_cell(workload, cuda_device):
    """The control, the program computing in bfloat16 (`faults.py`: the
    precision below the float32 that the configurations state), at the
    cell's own size over a whole window (`run_seconds`), comparing as many
    sweeps as a run does: not correct."""
    seconds = float(spec.benchmark()["run_seconds"])
    row = readings.reading(workload, "bf16", 3_000_000_017, seconds)
    assert row["correct"] is False, row
