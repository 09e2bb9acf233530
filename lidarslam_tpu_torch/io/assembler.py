"""Asynchronous multi-LiDAR frame assembly.

The host-side buffering/triggering layer every real multi-LiDAR deployment
needs — the role the reference's production node plays
(LidarSlamNode.cxx:158-194): secondary-device sweeps arrive asynchronously
and are buffered; a main-device sweep *triggers* an acquisition pairing it
with the best-matching buffered sweep of every other device. On top of the
reference's bare accumulate-and-flush, this assembler:

- matches secondaries to the trigger by STAMP (closest, within
  `max_stamp_diff` after per-device time offsets), so reordered, delayed or
  dropped messages never pair a stale sweep with the wrong trigger;
- holds a trigger back (bounded) while a known device's matching sweep may
  still arrive — message jitter then costs assembly latency, not pairing;
- prunes stale buffers (bounded memory on device dropout);
- re-reads per-device calibration at every emission via an optional
  provider callback — the per-frame BASE<-LIDAR TF refresh
  (LidarSlamNode.cxx:505-516).

`process(slam, frame)` is the production entry: push + for each emitted
acquisition, refresh calibrations and feed `Slam.add_frames_async` (or
`add_frames`).

A copy of `lidarslam_tpu/io/assembler.py` (numpy on the host), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class FrameAssembler:
    def __init__(self, main_device: int = 0, max_stamp_diff: float = 0.05,
                 time_offsets: Optional[Dict[int, float]] = None,
                 calibration_provider: Optional[Callable[[int], np.ndarray]] = None,
                 max_buffer: int = 10, expected_devices=(),
                 reorder_margin: Optional[float] = None):
        """`time_offsets[dev]` is ADDED to that device's stamps (clock skew
        correction); `calibration_provider(dev) -> (4,4)` is polled at each
        emission; `max_buffer` bounds the per-device queue. Devices are
        learned from the stream; pre-declare the rig with
        `expected_devices` so even the first trigger holds for them.
        `reorder_margin` [s] (default = max_stamp_diff): how far past the
        match window a device's newest arrival must be before a held
        trigger gives up on that device — tolerance for messages
        reordering WITHIN one device's stream."""
        self.main_device = int(main_device)
        self.max_stamp_diff = float(max_stamp_diff)
        self.reorder_margin = float(max_stamp_diff if reorder_margin is None
                                    else reorder_margin)
        self.time_offsets = dict(time_offsets or {})
        self.calibration_provider = calibration_provider
        self.max_buffer = int(max_buffer)
        self._buffers: Dict[int, List[dict]] = {
            int(d): [] for d in expected_devices if int(d) != self.main_device}
        self._pending: Optional[dict] = None        # held main-device trigger
        self.n_triggers = 0
        self.n_unmatched = 0   # emissions where >=1 known device had no match

    def _stamp(self, frame) -> float:
        dev = int(frame.get("device_id", 0))
        return float(frame["stamp"]) + self.time_offsets.get(dev, 0.0)

    def push(self, frame: dict) -> List[List[dict]]:
        """Feed one arriving sweep; returns the acquisitions that became
        ready (usually none or one; two when a new trigger forces out a held
        incomplete one). Each acquisition lists the main-device sweep first
        (Slam::AddFrames expects the tracked device at position 0)."""
        if frame["xyz"] is None or len(frame["xyz"]) == 0:
            return []
        dev = int(frame.get("device_id", 0))
        out = []
        if dev == self.main_device:
            self.n_triggers += 1
            if self._pending is not None:
                # a newer trigger forces the held acquisition out as-is
                out.append(self._emit(self._pending))
            self._pending = frame
        else:
            q = self._buffers.setdefault(dev, [])
            q.append(frame)
            if len(q) > self.max_buffer:
                q.pop(0)
        if self._pending is not None and self._complete(self._pending):
            out.append(self._emit(self._pending))
            self._pending = None
        return out

    def _match(self, q: List[dict], t_main: float):
        """Index of the closest-by-stamp frame within tolerance, else None."""
        if not q:
            return None
        diffs = [abs(self._stamp(f) - t_main) for f in q]
        best = int(np.argmin(diffs))
        return best if diffs[best] <= self.max_stamp_diff else None

    def _complete(self, trigger: dict) -> bool:
        """True when every known device either has a match or almost surely
        never will: a sweep newer than the match window PLUS the reorder
        margin arrived — so even a sweep delayed behind its successor
        (intra-device reordering) still gets its chance to pair."""
        t_main = self._stamp(trigger)
        horizon = t_main + self.max_stamp_diff + self.reorder_margin
        for q in self._buffers.values():
            if self._match(q, t_main) is not None:
                continue
            if not any(self._stamp(f) > horizon for f in q):
                return False   # the matching sweep may still arrive: hold
        return True

    def _emit(self, trigger: dict) -> List[dict]:
        t_main = self._stamp(trigger)
        acq = [trigger]
        for d, q in self._buffers.items():
            best = self._match(q, t_main)
            if best is not None:
                chosen = q[best]
                # stamps aligned to the main clock so the engine's
                # time-rebase uses the corrected inter-device offset
                if self.time_offsets.get(d, 0.0) != 0.0:
                    chosen = dict(chosen)
                    chosen["stamp"] = self._stamp(q[best])
                acq.append(chosen)
                # consume through the match: older sweeps can never match
                # a later trigger
                del q[:best + 1]
            else:
                self.n_unmatched += 1
                # prune sweeps too old to ever match again
                q[:] = [f for f in q
                        if self._stamp(f) >= t_main - self.max_stamp_diff]
        return acq

    def flush(self) -> List[List[dict]]:
        """Emit any held trigger (end of stream)."""
        if self._pending is None:
            return []
        acq = self._emit(self._pending)
        self._pending = None
        return [acq]

    def process(self, slam, frame: dict, streaming: bool = True) -> list:
        """Push; for each ready acquisition, refresh per-device calibrations
        and feed the engine. Returns the engine return values."""
        rets = []
        for acq in self.push(frame):
            if self.calibration_provider is not None:
                for f in acq:
                    d = int(f.get("device_id", 0))
                    cal = self.calibration_provider(d)
                    if cal is not None:
                        slam.set_base_to_lidar_offset(d, cal)
            rets.append(slam.add_frames_async(acq) if streaming
                        else slam.add_frames(acq))
        return rets
