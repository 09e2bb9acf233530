"""CUDA-graph replay of the streaming step: the counterpart, on one NVIDIA
GPU, of the JAX package's `jax.jit(process_stream_window,
donate_argnums=...)`.

The streaming step (`pipeline.process_frame_stream` at `first_frame=False`)
reads nothing on the host, so one steady-state step can be captured as a
`torch.cuda.CUDAGraph` and replayed once per sweep: the ~18-38k small kernels
of a frame then launch as one graph instead of one Python call each.

- Static buffers: the `StreamState` tensors, one input record of bytes per
  sweep and the azimuthal resolution. A record has a fixed layout, so the
  graph's shapes never change: `WireRecord` (the flat wire at a fixed
  capacity P), `FloatRecord` (the float planes of `compress_upload=False`)
  or `KeypointRecord` (a multi-LiDAR acquisition's merged keypoints at
  their capacities, stepped by `process_keypoints_stream`), each with the
  stamp and the sensor residual blocks. One graph steps one record kind; a
  rig's graph shares the sweep graph's state buffers (`share`), so the two
  kinds interleave in one segment. The graph holds the blocks of the kinds
  it was built with (`blocks`); a sweep without a measurement carries its
  block with `valid` off, which adds exactly nothing to the solve. The
  step writes the new state into the state buffers in place; a new segment
  `seed`s them with `copy_`, never by rebinding.
- A rig's per-device extraction and calibration transform is a graph of
  its own per device (`ExtractGraph`, input a FloatRecord of the device's
  sweep), so an acquisition launches two extraction replays, the merge,
  and one replay of the step.
- Warm-up: the first `WARMUP_STEPS` steady-state steps are real sweeps of
  the stream, run eagerly on a side stream through the same functions.
  Then one step is captured (capture runs nothing, so the state does not
  advance) and replayed for that sweep.
- A window of W sweeps is one host->device copy of the stacked records
  from pinned memory, then per sweep one device copy into the input record
  and one replay. Each sweep's packed scalars and keypoint log buffers are
  copied out of the graph's static outputs into the window's own tensors.

Nothing falls back to eager execution: a capture or replay failure raises.

`FrameGraph` replays `Slam.add_frame`'s step the same way on one device
with no mesh: `pipeline.process_frame` on the sweep's own wire (the
`ByteRangeImage` buffer `add_frame` uploads, or its float planes), with
the host's float64-computed inputs in one `FrameRecord` that goes up from
pinned memory. Its state is the maps, the previous
sweep's keypoints and the submap cache with its device staleness flag,
written in place by each step; `Slam` reseeds it when its own state is not
the graph's buffers.

On a mesh (`parallel/sharded.py`) the graph holds this rank's SPMD step
(`process_frame_stream_spmd` / `process_keypoints_stream_spmd`) with its
collectives, the counterpart of the JAX package's one sharded dispatch
per window. Only NCCL collectives are device work that a graph can hold;
gloo stages each one through host memory (ROADMAP Queue 3, D10), so
`StreamGraph` refuses a gloo mesh and `Slam` streams there eagerly. Every
rank warms up, captures and replays the same steps, so the ranks capture
the same kernels and collectives in the same order; the eager warm-up
steps create the NCCL communicator before the capture. The step reads
nothing on the host on a mesh either: the slab-sharded maps' roll runs
its migration hops as a loop of fixed length (`sharded_map.shard_roll`).
The k-NN kernels (csrc/knn.cu) launch on the current stream, which is the
capturing stream during capture, so the graph contains them, with the
workspace the wrapper allocates from the graph's pool;
`cuda_knn.LAUNCHES` counts Python calls (warm-up and capture), not replays.
The extraction kernel (csrc/extract.cu, `cuda_extract.LAUNCHES`) is
captured the same way, once per step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lidarslam_tpu_torch.config import SlamConfig
from lidarslam_tpu_torch.ops import extractor, pipeline
from lidarslam_tpu_torch.ops.frame import (ByteRangeImage, FlatRangeImage, Keypoints,
                                           RangeImage, transform_keypoints)
from lidarslam_tpu_torch.sensors.constraints import (GravityResidual, OdomResidual,
                                                     inactive_gravity, inactive_odom)

WARMUP_STEPS = 2
# the sensor blocks a record carries, in order, and their inactive values
BLOCK_KINDS = (OdomResidual, GravityResidual)
_INACTIVE = (inactive_odom(), inactive_gravity())
_BLOCK_LEN = 16   # float32 slots of the record's block area: 6 odometry + 8 gravity


def _block_values(extras) -> np.ndarray:
    """The record's block area (_BLOCK_LEN float32) of one sweep's host
    residuals: a kind missing is written inactive."""
    blocks = [next((e for e in extras if isinstance(e, kind)), inactive)
              for kind, inactive in zip(BLOCK_KINDS, _INACTIVE)]
    vals = np.zeros(_BLOCK_LEN, np.float32)
    flat = np.concatenate([np.asarray(v, np.float32).reshape(-1) for b in blocks for v in b])
    vals[:len(flat)] = flat
    return vals


def _unpack_blocks(b: torch.Tensor):
    """(OdomResidual, GravityResidual) as views of a block area."""
    odom = OdomResidual(prev_pos=b[0:3], distance=b[3], weight=b[4], valid=b[5] > 0.5)
    grav = GravityResidual(g_ref=b[6:9], g_cur=b[9:12], weight=b[12], valid=b[13] > 0.5)
    return odom, grav


def _pinned(n: int, nbytes: int) -> torch.Tensor:
    """(n, nbytes) zero uint8 host rows, pinned where there is a GPU."""
    return torch.zeros((n, nbytes), dtype=torch.uint8, pin_memory=torch.cuda.is_available())


class WireRecord:
    """Byte layout of one sweep on the graph's input, for R rings of C
    firings and a flat-wire capacity of P points:

        [t_min f32 | t_scale f32 | stamp f32 | counts i32 (R)]
        [sensor blocks f32 (16): odometry prev_pos (3), distance, weight,
         valid | gravity g_ref (3), g_cur (3), weight, valid | 2 unused]
        [xyz_q i16 (P, 3)] [meta u8 (P, 2)]   padded to 16 bytes

    Every field starts at a multiple of its own size, so the fields are
    views of one uint8 buffer."""

    def __init__(self, n_rings: int, max_points: int, capacity: int):
        self.shape = (n_rings, max_points)
        self.capacity = capacity
        self._blocks = 12 + 4 * n_rings
        self._xyz = self._blocks + 4 * _BLOCK_LEN
        self._meta = self._xyz + 6 * capacity
        self.nbytes = -(-(self._meta + 2 * capacity) // 16) * 16

    def pack(self, flats, stamps, extras=None) -> torch.Tensor:
        """(n, nbytes) uint8 records of n FlatRangeImages (numpy, capacity
        P), their stamps and their sensor residual blocks (per sweep a
        sequence of host residuals; a kind missing is written inactive), in
        pinned host memory where there is a GPU."""
        out = _pinned(len(flats), self.nbytes)
        rows = out.numpy()
        P = self.capacity
        extras = extras or [()] * len(flats)
        for row, flat, stamp, ex in zip(rows, flats, stamps, extras):
            if flat.xyz_q.shape != (P, 3):
                raise ValueError(f"flat wire of capacity {flat.xyz_q.shape[0]}, "
                                 f"the record holds {P}")
            row[0:12].view(np.float32)[:] = (flat.t_min, flat.t_scale, stamp)
            row[12:self._blocks].view(np.int32)[:] = flat.counts
            row[self._blocks:self._xyz].view(np.float32)[:] = _block_values(ex)
            row[self._xyz:self._meta].view(np.int16)[:] = flat.xyz_q.reshape(-1)
            row[self._meta:self._meta + 2 * P] = flat.meta.reshape(-1)
        return out

    def unpack(self, buf: torch.Tensor):
        """(FlatRangeImage, stamp (), (OdomResidual, GravityResidual)) as
        views of one record `buf` (each `valid` a comparison of its slot)."""
        P = self.capacity
        head = buf[0:12].view(torch.float32)
        flat = FlatRangeImage(
            xyz_q=buf[self._xyz:self._meta].view(torch.int16).view(P, 3),
            meta=buf[self._meta:self._meta + 2 * P].view(P, 2),
            t_min=head[0], t_scale=head[1],
            counts=buf[12:self._blocks].view(torch.int32), shape=self.shape)
        return flat, head[2], _unpack_blocks(buf[self._blocks:self._xyz].view(torch.float32))


class FloatRecord:
    """Byte layout of one float sweep (`compress_upload=False`) on the
    graph's input, for R rings of C firings (n = R*C):

        [stamp f32] [sensor blocks f32 (16)] [xyz f32 (n, 3)]
        [intensity f32 (n)] [time f32 (n)] [valid u8 (n)]   padded to 16 bytes

    688,208 B for a VLP-16 sweep (16 rings at C = 2048 slots)."""

    def __init__(self, n_rings: int, max_points: int):
        self.shape = (n_rings, max_points)
        n = n_rings * max_points
        self._xyz = 4 + 4 * _BLOCK_LEN
        self._inten = self._xyz + 12 * n
        self._time = self._inten + 4 * n
        self._valid = self._time + 4 * n
        self.nbytes = -(-(self._valid + n) // 16) * 16

    def pack(self, ris, stamps, extras=None) -> torch.Tensor:
        """(n, nbytes) uint8 records of n host RangeImages (numpy planes of
        `shape`), their stamps and sensor residual blocks."""
        out = _pinned(len(ris), self.nbytes)
        extras = extras or [()] * len(ris)
        for row, ri, stamp, ex in zip(out.numpy(), ris, stamps, extras):
            if np.shape(ri.valid) != self.shape:
                raise ValueError(f"sweep of shape {np.shape(ri.valid)}, the record "
                                 f"holds {self.shape}")
            row[0:4].view(np.float32)[0] = stamp
            row[4:self._xyz].view(np.float32)[:] = _block_values(ex)
            row[self._xyz:self._inten].view(np.float32)[:] = np.asarray(ri.xyz).reshape(-1)
            row[self._inten:self._time].view(np.float32)[:] = np.asarray(ri.intensity).reshape(-1)
            row[self._time:self._valid].view(np.float32)[:] = np.asarray(ri.time).reshape(-1)
            row[self._valid:self._valid + ri.valid.size] = np.asarray(ri.valid).reshape(-1)
        return out

    def unpack(self, buf: torch.Tensor):
        """(RangeImage, stamp (), blocks) as views of one record `buf`."""
        R, C = self.shape
        n = R * C
        ri = RangeImage(
            xyz=buf[self._xyz:self._inten].view(torch.float32).view(R, C, 3),
            intensity=buf[self._inten:self._time].view(torch.float32).view(R, C),
            time=buf[self._time:self._valid].view(torch.float32).view(R, C),
            valid=buf[self._valid:self._valid + n].view(R, C) != 0)
        return ri, buf[0:4].view(torch.float32)[0], _unpack_blocks(
            buf[4:self._xyz].view(torch.float32))


class KeypointRecord:
    """Byte layout of one multi-LiDAR acquisition on the graph's input: the
    merged keypoints of the three types at their capacities K0, K1, K2.

        [stamp f32] [sensor blocks f32 (16)]
        per type: [xyz f32 (K, 3)] [intensity f32 (K)] [time f32 (K)]
                  [ring i32 (K)] [count i32]
        per type: [valid u8 (K)]                  padded to 16 bytes

    `write` fills a device record from device tensors, so an acquisition
    reaches the graph without a host round trip."""

    def __init__(self, capacities):
        self.capacities = tuple(capacities)
        off = 4 + 4 * _BLOCK_LEN
        self._fields = []
        for K in self.capacities:
            self._fields.append((off, K))
            off += 4 * (6 * K + 1)
        self._valid = []
        for K in self.capacities:
            self._valid.append(off)
            off += K
        self.nbytes = -(-off // 16) * 16

    def _views(self, buf, i):
        off, K = self._fields[i]
        f = buf[off:off + 4 * (6 * K + 1)]
        xyz = f[:12 * K].view(torch.float32).view(K, 3)
        inten = f[12 * K:16 * K].view(torch.float32)
        time = f[16 * K:20 * K].view(torch.float32)
        ring = f[20 * K:24 * K].view(torch.int32)
        count = f[24 * K:24 * K + 4].view(torch.int32)
        return xyz, inten, time, ring, count, buf[self._valid[i]:self._valid[i] + K]

    def write(self, buf: torch.Tensor, kps, stamp: float, extras=()):
        """Fill the record `buf` (on the keypoints' device) with the merged
        `kps` (one Keypoints per type), the stamp and the host residuals
        `extras`; the head goes up from pinned memory without a sync."""
        head = _pinned(1, 4 + 4 * _BLOCK_LEN)[0]
        h = head.numpy()
        h[0:4].view(np.float32)[0] = stamp
        h[4:].view(np.float32)[:] = _block_values(extras)
        buf[:head.shape[0]].copy_(head, non_blocking=True)
        for i, kp in enumerate(kps):
            xyz, inten, time, ring, count, valid = self._views(buf, i)
            xyz.copy_(kp.xyz)
            inten.copy_(kp.intensity)
            time.copy_(kp.time)
            ring.copy_(kp.ring)
            count.copy_(kp.count.reshape(1))
            valid.copy_(kp.valid)

    def unpack(self, buf: torch.Tensor):
        """(Keypoints per type, stamp (), blocks) as views of one record."""
        kps = []
        for i in range(len(self.capacities)):
            xyz, inten, time, ring, count, valid = self._views(buf, i)
            kps.append(Keypoints(xyz=xyz, intensity=inten, time=time, ring=ring,
                                 valid=valid != 0, count=count[0]))
        return tuple(kps), buf[0:4].view(torch.float32)[0], _unpack_blocks(
            buf[4:4 + 4 * _BLOCK_LEN].view(torch.float32))


class FrameRecord:
    """Byte layout of one live sweep's host inputs on `FrameGraph`'s input,
    in 4-byte slots:

        [trel_prior f32 (6) | prev_pose f32 (6) | kf_last_pose f32 (6)]
        [stamp f32 | t_prev f32 | az_resolution f32 | kf_counter i32]
        [map_update f32 | force_stale f32]
        [sensor blocks f32 (16), as in WireRecord]

    The poses are the host's float64 values (MAP frame, xyzrpy) rounded to
    float32, as `Slam._pose_tensor` rounds them."""

    nbytes = 4 * (24 + _BLOCK_LEN)

    @staticmethod
    def pack(trel_prior, prev_pose, kf_last_pose, stamp, t_prev, az_resolution,
             kf_counter, map_update, force_stale, extras=()) -> torch.Tensor:
        """(nbytes,) uint8 record in pinned host memory where there is a GPU;
        `extras`: the sweep's host sensor residuals (a kind missing is
        written inactive)."""
        out = _pinned(1, FrameRecord.nbytes)[0]
        f = out.numpy().view(np.float32)
        f[0:18] = np.concatenate([np.asarray(p, np.float64).reshape(6)
                                  for p in (trel_prior, prev_pose, kf_last_pose)])
        f[18:21] = (stamp, t_prev, az_resolution)
        f[21:22].view(np.int32)[0] = kf_counter
        f[22:24] = (float(map_update), float(force_stale))
        f[24:] = _block_values(extras)
        return out

    @staticmethod
    def unpack(buf: torch.Tensor):
        """(FrameInputs without the submap cache, force_stale (), blocks) as
        views of one record `buf`."""
        f = buf.view(torch.float32)
        inp = pipeline.FrameInputs(
            trel_prior=f[0:6], prev_pose=f[6:12], kf_last_pose=f[12:18], stamp=f[18],
            t_prev=f[19], az_resolution=f[20], kf_counter=f[21:22].view(torch.int32)[0],
            map_update=f[22] > 0.5)
        return inp, f[23] > 0.5, _unpack_blocks(f[24:])


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


class _Replayed:
    """A step (`_body`) run eagerly on a side stream for its first
    WARMUP_STEPS calls, then captured once and replayed: `_step` returns
    its outputs (the graph's static outputs once captured)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = None
        self._outputs = None
        self.warmup_steps = 0

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
            # thread-local: on an NCCL mesh the process group's watchdog
            # thread queries its events while this thread captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._outputs = self._body()
            self.graph = graph
        self.graph.replay()
        return self._outputs


class ExtractGraph(_Replayed):
    """One LiDAR device's keypoint extraction and calibration transform
    (`Slam._extract_merge` on CUDA), replayed as a CUDA graph per device:
    the input is a FloatRecord of the device's float planes (its stamp
    field the sweep's time offset to the acquisition's stamp), the static
    azimuthal resolution and BASE <- LIDAR pose; the output the device's
    keypoints in BASE, copied out per call (a rig may list a device
    twice)."""

    def __init__(self, ecfg, device):
        super().__init__(device)
        self.ecfg = ecfg
        self.wire = FloatRecord(ecfg.n_rings, ecfg.max_ring_points)
        self.record = torch.zeros(self.wire.nbytes, dtype=torch.uint8, device=self.device)
        self.az = torch.zeros((), dtype=torch.float32, device=self.device)
        self.pose = torch.zeros(6, dtype=torch.float32, device=self.device)

    def run(self, ri, dt: float, az: float, pose6: np.ndarray):
        """Keypoints per type of one host sweep `ri` (a RangeImage of numpy
        planes) shifted by `dt`, at azimuthal resolution `az`, moved by
        `pose6` (xyzrpy); the inputs go up from pinned memory."""
        head = _pinned(1, 4 * 6)[0]
        head.numpy().view(np.float32)[:] = pose6
        self.pose.copy_(head.view(torch.float32), non_blocking=True)
        self.record.copy_(self.wire.pack([ri], [dt])[0], non_blocking=True)
        self.az.fill_(float(np.float32(az)))
        return clone_tree(self._step())

    def _body(self):
        ri, dt, _ = self.wire.unpack(self.record)
        ext = extractor.extract_keypoints(ri, self.az, self.ecfg)
        return tuple(transform_keypoints(kp, self.pose, dt)
                     for kp in (ext.edges, ext.planes, ext.blobs))


class StreamGraph(_Replayed):
    """The streaming step of one record kind (`wire`: a WireRecord,
    FloatRecord or KeypointRecord) on one CUDA device, replayed as a CUDA
    graph. Owns the static state, or shares another graph's; see the module
    docstring."""

    def __init__(self, cfg: SlamConfig, map_cfgs: tuple, device, wire,
                 blocks=(False, False), mesh=None, shard_maps: bool = False,
                 shard_extraction: bool = False):
        rig = isinstance(wire, KeypointRecord)
        if mesh is None:
            step = pipeline.process_keypoints_stream if rig else pipeline.process_frame_stream
        elif mesh.backend != "nccl":
            raise ValueError(f"StreamGraph captures a mesh step only on NCCL: {mesh.backend} "
                             "stages every collective through host memory (ROADMAP Queue "
                             "3, D10); run that mesh stream eagerly")
        else:
            from lidarslam_tpu_torch.parallel import sharded

            kw = {"mesh": mesh, "shard_maps": shard_maps}
            if not rig:
                kw["shard_extraction"] = shard_extraction
            step = functools.partial(sharded.process_keypoints_stream_spmd if rig
                                     else sharded.process_frame_stream_spmd, **kw)
        super().__init__(device)
        self.cfg = cfg
        self.blocks = tuple(blocks)   # per BLOCK_KINDS: the graph holds that block
        self.map_cfgs = map_cfgs
        self.wire = wire
        self.mesh = mesh
        self._step_fn = step
        self.record = torch.zeros(wire.nbytes, dtype=torch.uint8, device=self.device)
        self.az = torch.zeros((), dtype=torch.float32, device=self.device)
        self.state = None

    def share(self, other: "StreamGraph"):
        """Step `other`'s state and azimuthal-resolution buffers (before the
        first step): both graphs then read and write the same segment."""
        self.state, self.az = other.state, other.az

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

    def eager_step(self, inp, stamp: float, first_frame: bool, extras=()):
        """One step outside the graph (a segment's first sweep on its
        per-sweep wire, or an acquisition's merged keypoints; `extras` its
        sensor blocks as device tensors). Returns (packed (PACKED_LEN + 3,), kps_flat)."""
        stamp_t = torch.full((), stamp, dtype=torch.float32, device=self.device)
        new, packed, kps_flat = self._step_fn(
            inp, self.state, stamp_t, self.az, self.cfg, self.map_cfgs, first_frame, extras)
        assign_tree(self.state, new)
        return packed, kps_flat

    def run(self, records: torch.Tensor):
        """Step every record of a (n, nbytes) uint8 device window in order.
        Returns (packed (n, PACKED_LEN + 3), kps_flat — per type (n, 7K+1))."""
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

    def step(self):
        """Step the record already written into `record` (a KeypointRecord's
        `write`). Returns copies of (packed (PACKED_LEN + 3,), kps_flat)."""
        packed, kps_flat = self._step()
        return packed.clone(), tuple(k.clone() for k in kps_flat)

    def _body(self):
        inp, stamp, blocks = self.wire.unpack(self.record)
        extras = tuple(b for b, held in zip(blocks, self.blocks) if held)
        new, packed, kps_flat = self._step_fn(
            inp, self.state, stamp, self.az, self.cfg, self.map_cfgs, False, extras)
        assign_tree(self.state, new)
        return packed, kps_flat


def _empty_wire(ri):
    """Static buffers of the shape of one sweep's wire (a ByteRangeImage,
    or a RangeImage of tensors)."""
    if isinstance(ri, ByteRangeImage):
        return ByteRangeImage(torch.empty_like(ri.buf), ri.shape)
    return type(ri)(*(torch.empty_like(a) for a in ri))


def _copy_wire(dst, src):
    if isinstance(dst, ByteRangeImage):
        dst.buf.copy_(src.buf)
    else:
        for a, b in zip(dst, src):
            a.copy_(b)


class FrameGraph(_Replayed):
    """`Slam.add_frame`'s per-sweep step on one CUDA device (no mesh):
    `pipeline.process_frame` replayed as a CUDA graph.

    Static inputs: the sweep's wire as `add_frame` builds it (`wire`, the
    template), copied in on the device, and a `FrameRecord` of the host's
    inputs, one copy from pinned memory. Static state (`state`): the maps,
    the previous sweep's keypoints, the submap cache and its device
    staleness flag, written in place by each step (`seed` loads them from
    the host). A step rebuilds the submap where the flag of the step before,
    or the record's force-stale flag, says. `blocks`: the sensor blocks the
    graph holds, as in StreamGraph. `step` returns the step's FrameResult,
    its maps, keypoints, cache and flag being the state's buffers."""

    def __init__(self, cfg: SlamConfig, map_cfgs: tuple, device, wire,
                 blocks=(False, False)):
        super().__init__(device)
        self.cfg = cfg
        self.map_cfgs = map_cfgs
        self.blocks = tuple(blocks)
        self.sweep = _empty_wire(wire)
        self.record = torch.zeros(FrameRecord.nbytes, dtype=torch.uint8, device=self.device)
        self.state = None   # (maps, prev_keypoints, submap_cache, cache_stale)

    @property
    def replays_next(self) -> bool:
        """Whether the next `step` replays the graph (not a warm-up step)."""
        return self.graph is not None or self.warmup_steps >= WARMUP_STEPS

    def seed(self, maps, prev_keypoints, submap_cache, cache_stale):
        """Load the host's state into the static buffers (`cache_stale` a
        bool or a () tensor)."""
        if not isinstance(cache_stale, torch.Tensor):
            cache_stale = torch.full((), bool(cache_stale), dtype=torch.bool,
                                     device=self.device)
        st = (tuple(maps), tuple(prev_keypoints), tuple(submap_cache), cache_stale)
        if self.state is None:
            self.state = clone_tree(st)
        else:
            assign_tree(self.state, st)

    def step(self, ri, record: torch.Tensor) -> pipeline.FrameResult:
        """Step the sweep `ri` (on the device, of the template's wire) with
        the host record `record` (FrameRecord.pack)."""
        self.record.copy_(record, non_blocking=True)
        _copy_wire(self.sweep, ri)
        return self._step()

    def _body(self):
        inp, force_stale, blocks = FrameRecord.unpack(self.record)
        maps, prev, cache, stale = self.state
        inp = inp._replace(extras=tuple(b for b, held in zip(blocks, self.blocks) if held),
                           submap_cache=cache, cache_stale=stale | force_stale)
        res = pipeline.process_frame(self.sweep, maps, prev, inp, self.cfg, self.map_cfgs,
                                     False)
        assign_tree(self.state, (res.maps, res.keypoints, res.submap_cache, res.cache_stale))
        return res._replace(maps=maps, keypoints=prev, submap_cache=cache, cache_stale=stale)
