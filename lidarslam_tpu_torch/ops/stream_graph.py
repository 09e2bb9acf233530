"""CUDA-graph replay of the streaming step: the counterpart, on one NVIDIA
GPU, of the JAX package's `jax.jit(process_stream_window,
donate_argnums=...)`.

The streaming step (`pipeline.process_frame_stream` at `first_frame=False`)
reads nothing on the host, so one steady-state step can be captured as a
`torch.cuda.CUDAGraph` and replayed once per sweep: the ~18-38k small kernels
of a frame then launch as one graph instead of one Python call each.

- Static buffers: the `StreamState` tensors, one input record of bytes per
  sweep (`WireRecord`: the flat wire at a fixed capacity P plus the stamp,
  so the graph's shapes never change) and the azimuthal resolution. The
  step writes the new state into the state buffers in place; a new segment
  `seed`s them with `copy_`, never by rebinding.
- Warm-up: the first `WARMUP_STEPS` steady-state steps are real sweeps of
  the stream, run eagerly on a side stream through the same functions.
  Then one step is captured (capture runs nothing, so the state does not
  advance) and replayed for that sweep.
- A window of W sweeps is one host->device copy of the stacked records
  from pinned memory, then per sweep one device copy into the input record
  and one replay. Each sweep's packed scalars and keypoint log buffers are
  copied out of the graph's static outputs into the window's own tensors.

Nothing falls back to eager execution: a capture or replay failure raises.
The k-NN kernels (csrc/knn.cu) launch on the current stream, which is the
capturing stream during capture, so the graph contains them, with the
workspace the wrapper allocates from the graph's pool;
`cuda_knn.LAUNCHES` counts Python calls (warm-up and capture), not replays.
"""

from __future__ import annotations

import numpy as np
import torch

from lidarslam_tpu_torch.config import SlamConfig
from lidarslam_tpu_torch.ops import pipeline
from lidarslam_tpu_torch.ops.frame import FlatRangeImage

WARMUP_STEPS = 2


class WireRecord:
    """Byte layout of one sweep on the graph's input, for R rings of C
    firings and a flat-wire capacity of P points:

        [t_min f32 | t_scale f32 | stamp f32 | counts i32 (R)]
        [xyz_q i16 (P, 3)] [meta u8 (P, 2)]   padded to 16 bytes

    Every field starts at a multiple of its own size, so the fields are
    views of one uint8 buffer."""

    def __init__(self, n_rings: int, max_points: int, capacity: int):
        self.shape = (n_rings, max_points)
        self.capacity = capacity
        self._xyz = 12 + 4 * n_rings
        self._meta = self._xyz + 6 * capacity
        self.nbytes = -(-(self._meta + 2 * capacity) // 16) * 16

    def pack(self, flats, stamps) -> torch.Tensor:
        """(n, nbytes) uint8 records of n FlatRangeImages (numpy, capacity
        P) and their stamps, in pinned host memory where there is a GPU."""
        out = torch.zeros((len(flats), self.nbytes), dtype=torch.uint8,
                          pin_memory=torch.cuda.is_available())
        rows = out.numpy()
        R, P = self.shape[0], self.capacity
        for row, flat, stamp in zip(rows, flats, stamps):
            if flat.xyz_q.shape != (P, 3):
                raise ValueError(f"flat wire of capacity {flat.xyz_q.shape[0]}, "
                                 f"the record holds {P}")
            row[0:12].view(np.float32)[:] = (flat.t_min, flat.t_scale, stamp)
            row[12:self._xyz].view(np.int32)[:] = flat.counts
            row[self._xyz:self._meta].view(np.int16)[:] = flat.xyz_q.reshape(-1)
            row[self._meta:self._meta + 2 * P] = flat.meta.reshape(-1)
        return out

    def unpack(self, buf: torch.Tensor):
        """(FlatRangeImage, stamp ()) as views of one record `buf`."""
        R, P = self.shape[0], self.capacity
        head = buf[0:12].view(torch.float32)
        flat = FlatRangeImage(
            xyz_q=buf[self._xyz:self._meta].view(torch.int16).view(P, 3),
            meta=buf[self._meta:self._meta + 2 * P].view(P, 2),
            t_min=head[0], t_scale=head[1],
            counts=buf[12:self._xyz].view(torch.int32), shape=self.shape)
        return flat, head[2]


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def clone_tree(tree):
    """Deep copy of a (Named)tuple tree of tensors (None leaves kept)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    vals = [clone_tree(t) for t in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def assign_tree(dst, src):
    """Copy the tensors of `src` into the same-structured `dst` in place.
    A source leaf that is one of dst's buffers (a field carried through
    unchanged, or moved to another field, as t_cur -> t_prev) is cloned
    first, so no copy reads a buffer that an earlier copy overwrote."""
    d, s = _leaves(dst), _leaves(src)
    if len(d) != len(s) or any(a.shape != b.shape or a.dtype != b.dtype
                               for a, b in zip(d, s)):
        raise ValueError("the stream state's structure changed")
    owned = {t.untyped_storage().data_ptr() for t in d}
    s = [t.clone() if t.untyped_storage().data_ptr() in owned else t for t in s]
    for a, b in zip(d, s):
        a.copy_(b)


class StreamGraph:
    """The streaming step on one CUDA device, replayed as a CUDA graph.
    Owns the static state; see the module docstring."""

    def __init__(self, cfg: SlamConfig, map_cfgs: tuple, device, wire: WireRecord):
        self.cfg = cfg
        self.map_cfgs = map_cfgs
        self.device = torch.device(device)
        self.wire = wire
        self.record = torch.zeros(wire.nbytes, dtype=torch.uint8, device=self.device)
        self.az = torch.zeros((), dtype=torch.float32, device=self.device)
        self.state = None
        self.graph = None
        self._outputs = None
        self.warmup_steps = 0

    def seed(self, state: pipeline.StreamState, az_resolution: float):
        """Load a segment's state (and the sensor's azimuthal resolution)
        into the static buffers."""
        if self.state is None:
            self.state = clone_tree(state)
        else:
            assign_tree(self.state, state)
        self.set_az(az_resolution)

    def set_az(self, az_resolution: float):
        self.az.fill_(float(np.float32(az_resolution)))

    def eager_step(self, ri, stamp: float, first_frame: bool):
        """One step outside the graph (a segment's first sweep, on the
        per-sweep wire). Returns (packed (67,), kps_flat)."""
        stamp_t = torch.full((), stamp, dtype=torch.float32, device=self.device)
        new, packed, kps_flat = pipeline.process_frame_stream(
            ri, self.state, stamp_t, self.az, self.cfg, self.map_cfgs, first_frame)
        assign_tree(self.state, new)
        return packed, kps_flat

    def run(self, records: torch.Tensor):
        """Step every record of a (n, nbytes) uint8 device window in order.
        Returns (packed (n, 67), kps_flat — per type (n, 7K+1))."""
        n = records.shape[0]
        packed_out, kps_out = None, None
        for w in range(n):
            self.record.copy_(records[w])
            packed, kps_flat = self._step()
            if packed_out is None:
                packed_out = torch.empty((n,) + tuple(packed.shape), dtype=packed.dtype,
                                         device=self.device)
                kps_out = tuple(torch.empty((n,) + tuple(k.shape), dtype=k.dtype,
                                            device=self.device) for k in kps_flat)
            packed_out[w].copy_(packed)
            for dst, k in zip(kps_out, kps_flat):
                dst[w].copy_(k)
        return packed_out, kps_out

    def _body(self):
        flat, stamp = self.wire.unpack(self.record)
        new, packed, kps_flat = pipeline.process_frame_stream(
            flat, self.state, stamp, self.az, self.cfg, self.map_cfgs, False)
        assign_tree(self.state, new)
        return packed, kps_flat

    def _step(self):
        if self.graph is None and self.warmup_steps < WARMUP_STEPS:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self._body()
            cur.wait_stream(side)
            self.warmup_steps += 1
            return out
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._outputs = self._body()
            self.graph = graph
        self.graph.replay()
        return self._outputs
