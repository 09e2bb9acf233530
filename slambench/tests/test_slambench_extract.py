"""The readers of the extraction layer: the device time and the kernel
count between `slam_mark_extract_begin` and `slam_mark_extract_end`, read
from a hand-built trace. Run from the repository root:

    python -m pytest slambench/tests -q -o addopts="" -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench import markers, spec, traceread  # noqa: E402

MS = 1_000_000

# two sweeps of extraction between its markers: the kernel and two of the
# compaction's kernels inside, a copy, work before and after each stretch
EXTRACT = [("k0", 0, 2), ("slam_mark_extract_begin", 3, 4), ("extract_rings", 4, 6),
           ("cumsum", 6, 7), ("Memcpy DtoD", 7, 8), ("gather", 8, 9),
           ("slam_mark_extract_end", 9, 10), ("k1", 9, 12),
           ("slam_mark_extract_begin", 20, 21), ("extract_rings", 21, 23),
           ("slam_mark_extract_end", 23, 24), ("k2", 24, 25)]


def _trace(device=(), sweeps=2, path="live"):
    return traceread.Trace(device=[(n, s * MS, e * MS) for n, s, e in device], host=[],
                           sweeps=sweeps, path=path, untraced_ms_per_sweep=50.0)


@pytest.mark.parametrize("name,value", [
    # from 3 to 10: begin, the kernel, cumsum, the copy, gather, end and
    # k1 clipped to 10 (3-10); from 20 to 24: begin, kernel, end (4 ms)
    ("extract_device_ms_per_sweep.live", (7 + 4) / 2),
    ("extract_device_ms_per_sweep.log", (7 + 4) / 2),
    # strictly between the markers, copies and the markers not counted:
    # extract_rings, cumsum, gather; then extract_rings
    ("extract_kernels_per_sweep.live", (3 + 1) / 2),
    ("extract_kernels_per_sweep.log", (3 + 1) / 2),
])
def test_extract_readers_on_a_hand_built_trace(name, value):
    read = spec.reader(name)
    path = name.rsplit(".", 1)[1]
    assert read(_trace(EXTRACT, path=path)) == pytest.approx(value)
    # a program without the markers (the torch form before them) reads
    # nothing, and neither does a run of the other path
    bare = [d for d in EXTRACT if "slam_mark" not in d[0]]
    assert read(_trace(bare, path=path)) is None
    other = "log" if path == "live" else "live"
    assert read(_trace(EXTRACT, path=other)) is None


def test_extract_markers_pair_each_begin_with_the_next_end():
    begin, end = "slam_mark_extract_begin", "slam_mark_extract_end"
    pairs = [((3 * MS, 4 * MS), (9 * MS, 10 * MS)), ((20 * MS, 21 * MS), (23 * MS, 24 * MS))]
    assert markers.pairs(_trace(EXTRACT).device, begin, end) == pairs
    # an end with no begin before it, a begin left open, and the ego
    # stage's markers pair with nothing
    stray = [("slam_mark_extract_end", 1, 2), ("slam_mark_extract_begin", 40, 41),
             ("slam_mark_ego_begin", 13, 14), ("slam_mark_ego_end", 15, 16)]
    assert markers.pairs(_trace(EXTRACT + stray).device, begin, end) == pairs


def test_extract_metrics_are_listed_for_every_cell():
    bench = spec.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for path, moves in (("live", "live_p50_ms"), ("log", "log_sweeps_per_s")):
        cells = [w["name"] for w in bench["workloads"]
                 if spec.traffic(w["traffic"])["path"] == path]
        for base in ("extract_device_ms_per_sweep", "extract_kernels_per_sweep"):
            m = listed[f"{base}.{path}"]
            assert m["workloads"] == cells and m["layer"] == "extraction"
            assert (m["source"], m["moves"]) == ("device_trace", moves)
