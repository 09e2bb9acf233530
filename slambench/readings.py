"""Readings of the numbers that decide `correct`, for setting their limits:
sound runs of a cell and runs with a break planted underneath
(`faults.py`: the bfloat16 control, the faults), several seeds in one
process. Not part of a benchmark run.

    python3 slambench/readings.py --workload vlp16_outdoor.robot-live \\
        --seeds 11,12,13 --seconds 15 --kinds sound,bf16,icp1,once [--out FILE]

prints one JSON line per run (the cell, the kind, the seed, `correct`
against the cell's limits as they stand, the compared numbers, sweeps
handed in and failed) and appends it to FILE. A run that raises prints its
error instead of numbers: a control that crashes has failed. `--tiny`
runs the tests' CPU size (360 firings a ring, a 40-sweep lap) on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TINY = {"sensor_override": {"n_azimuth": 360}, "lap_sweeps": 40, "device": "cpu"}


def reading(workload: str, kind: str, seed: int, seconds: float, tiny: bool = False) -> dict:
    from slambench import faults, run

    ctx = contextlib.nullcontext() if kind == "sound" else faults.planted(kind)
    t0 = time.perf_counter()
    row = {"workload": workload, "kind": kind, "seed": seed, "seconds": seconds}
    try:
        with ctx:
            res = run.execute(workload, seed, seconds, False, **(TINY if tiny else {}))
        row.update(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
                   values={k: c["value"] for k, c in res["checks"].items()},
                   limits={k: c["limit"] for k, c in res["checks"].items()},
                   metrics={k: m["value"] for k, m in res["metrics"].items()})
    except Exception as exc:   # a control that crashes has failed
        row.update(correct=False, error=f"{type(exc).__name__}: {exc}",
                   trace=traceback.format_exc()[-1500:])
    row["wall_s"] = time.perf_counter() - t0
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--kinds", default="sound,bf16", help="sound and/or faults.KINDS")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    from slambench import run

    run.use_checkout_caches()
    for kind in args.kinds.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            row = reading(args.workload, kind, seed, args.seconds, args.tiny)
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
