#!/usr/bin/env python3
"""Host-clock ms/frame of the full and ext configurations on one CUDA card,
for a tree of the port, with its variants in turns:

    python3 scripts/stream_probe.py [TREE]

TREE is a checkout whose `lidarslam_tpu_torch/` is measured (by default the
one this script lies in); the helpers always come from this script's own
`chip_smoke.py`, so an older commit unpacked with `git archive` is measured
the same way. On `chip_smoke.render_frames`' 30 motion-distorted sweeps, on
numpy ingest (as chip_smoke's phases 6 and 7), each variant twice in turns:

- first, so that every tree reaches it with the same history in its
  process, the sync path (`add_frame`, median over the localized frames)
  of `full_config()` and `ext_config()`, with the logs as configured and,
  where the tree keeps a keypoint log, off (`logging_timeout=0`);
- then the stream (`add_frame_async` + `flush`, frames 9-24 between two
  device syncs, `chip_smoke._stream_run_ms`) of both: windows dispatched
  inline; on a worker thread, where the tree has `Slam._run_window`; and
  with the logs off, where the tree keeps a keypoint log.

Prints one JSON line. To tell a change from the spread between runs, run
parent, change, change, parent in one session.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TURNS = 2


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever tree is measured."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("stream_probe.py: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    import lidarslam_tpu_torch
    from lidarslam_tpu_torch import Slam
    from lidarslam_tpu_torch.io import synthetic

    if Path(lidarslam_tpu_torch.__file__).resolve().parent.parent != tree:
        raise AssertionError(f"imported {lidarslam_tpu_torch.__file__}, not {tree}'s")
    try:        # a tree from before the port's native ingest has nothing to pin
        from lidarslam_tpu_torch.io import native
        native.available = lambda: False
    except ImportError:
        pass
    card = cs.phase_env()
    frames = cs.render_frames(cs.N_FRAMES, motion_distortion=True)
    sensors = cs.sensor_measurements(synthetic.weaving_street_trajectory(), cs.SENSOR_END_S)
    logs = hasattr(Slam, "get_log_memory_usage")
    variants = [("inline", False, False)]
    if hasattr(Slam, "_run_window"):
        variants.append(("worker", True, False))
    if logs:
        variants.append(("no log", False, True))
    configs = {"full": (cs.full_config(), None), "ext": (cs.ext_config(), sensors)}

    def run(name, stream, worker=False, no_log=False):
        cfg, sens = configs[name]
        if no_log:
            cfg = dataclasses.replace(cfg, logging_timeout=0)
        results, _, _, ms = cs._ext_run(cfg, frames, sens, stream, worker=worker)
        failed = sum(bool(r["failure"]) for r in results)
        cs._require(failed == 0, f"[probe] {name}: {failed} failed frames")
        return ms

    sync_variants = [("logs", False)] + ([("no log", True)] if logs else [])
    sync = {name: {v: [] for v, _ in sync_variants} for name in configs}
    for _ in range(TURNS):
        for v, no_log in sync_variants:
            for name in configs:
                sync[name][v].append(run(name, False, no_log=no_log))
    stream = {name: {v: [] for v, _, _ in variants} for name in configs}
    for _ in range(TURNS):
        for v, worker, no_log in variants:
            for name in configs:
                stream[name][v].append(run(name, True, worker, no_log))
    out = {"tree": str(tree), "card": card, "stream_ms": stream, "sync_ms": sync}
    for name in configs:
        print(f"[probe] {tree.name} {name}: stream "
              + "; ".join(f"{v} {', '.join(f'{m:.2f}' for m in ms)}"
                          for v, ms in stream[name].items())
              + " ms/frame; sync "
              + "; ".join(f"{v} {', '.join(f'{m:.2f}' for m in ms)}"
                          for v, ms in sync[name].items())
              + f" ms/frame ({card})", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
