"""What a run is made of, found by name.

`BENCHMARK.json` (at the checkout's root) lists each cell as a configuration
and a traffic mix, and each metric with its unit. A configuration is
`slambench/configs/<config>.json`, a mix `slambench/traffic/<traffic>.json`,
a cell's limits on the numbers that decide `correct`
`slambench/limits/<workload name>.json` (set from that cell's own
readings), and a per-layer metric the reader `slambench/metrics/<metric
name>.py`, or `slambench/metrics/<base>.py` for a metric named
`<base>.<path>`, read only on runs of that traffic path (`live`, `log`).
A reader's `read(trace)` returns a number, or None where the run has
nothing to read. A new cell made of existing configuration and mix files
needs its `workloads` entry and its limits file, both new.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
LIMITS = HERE / "limits"
PATHS = ("live", "log")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    """The cell's limit on each number that decides `correct`."""
    path = LIMITS / f"{workload_name}.json"
    if not path.exists():
        raise KeyError(f"cell {workload_name!r} has no limits file {path.name} under "
                       f"slambench/limits/: set its limits from its own readings")
    return load_json(path)["limits"]


def metrics_for(bench: dict, workload_name: str, kind: str) -> list:
    """The cell's `end_to_end` or `per_layer` metric entries: those that
    list it, and those that list no workloads at all."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload_name in m["workloads"]]


def reader(metric_name: str):
    """The metric's reader: `read` of `slambench/metrics/<metric_name>.py`,
    or, for `<base>.<path>` with no file of its own, `read` of
    `slambench/metrics/<base>.py` on runs of that path (None on others)."""
    base, _, path = metric_name.rpartition(".")
    own = HERE / "metrics" / f"{metric_name}.py"
    if own.exists() or path not in PATHS:
        return _load_read(own)
    read = _load_read(HERE / "metrics" / f"{base}.py")
    return lambda trace: read(trace) if trace.path == path else None


def _load_read(path: Path):
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
