"""Fixed-shape sweep containers (PyTorch port of `lidarslam_tpu/ops/frame.py`).

A sweep is a ring-major range image: (R, C) tensors, row = laser ring,
column = firing index within the ring, packed left, with a validity mask.
Keypoint sets are fixed-capacity (K,) struct-of-arrays with a count.

The host->device wires are the JAX package's, byte for byte, so the port
sees bit-identically the same quantized sweep as the reference:
- `ByteRangeImage`: one buffer of 4 mm int16 coordinates, u8 intensity,
  f16 per-point time and u8 validity (the per-sweep path);
- `PackedRangeImage`: the same planes with u8 times over the sweep's span
  and per-ring counts instead of the validity plane (host-built window
  sweeps), and `FlatRangeImage`, its valid points only, prefix-packed into
  a fixed capacity P (the windowed streaming wire).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidarslam_tpu_torch.io import native

XYZ_QUANT_SCALE = 0.004  # [m] upload quantization step (~sensor noise / 5)


class RangeImage(NamedTuple):
    """A sweep as a ring-major range image (all tensors (R, C) except xyz)."""

    xyz: torch.Tensor        # (R, C, 3) float32, LIDAR sensor frame (spin axis = Z)
    intensity: torch.Tensor  # (R, C) float32
    time: torch.Tensor       # (R, C) float32 — offset [s] from the frame stamp
    valid: torch.Tensor      # (R, C) bool — packed left per row

    @property
    def n_rings(self):
        return self.xyz.shape[0]

    @property
    def max_points(self):
        return self.xyz.shape[1]


class PackedRangeImage(NamedTuple):
    """Wire-compact sweep: int16 coordinates (4 mm), u8 intensity, u8 times
    over the sweep's [t_min, t_max] span, and per-ring counts in place of
    the validity plane (rows are left-packed). Built on the host as numpy
    planes (`build_range_image(..., packed=True, device=False)`);
    `unpack` takes it as tensors (`to_device_range_image`)."""

    xyz_q: torch.Tensor      # (R, C, 3) int16
    intensity: torch.Tensor  # (R, C) uint8
    t_q: torch.Tensor        # (R, C) uint8
    t_min: torch.Tensor      # () float32
    t_scale: torch.Tensor    # () float32
    counts: torch.Tensor     # (R,) int32 — valid points per ring, left-packed

    def unpack(self) -> RangeImage:
        C = self.intensity.shape[-1]
        col = torch.arange(C, dtype=torch.int32, device=self.counts.device)
        valid = col[None, :] < self.counts[:, None]
        time = self.t_min + self.t_q.to(torch.float32) * self.t_scale
        return RangeImage(
            xyz=self.xyz_q.to(torch.float32) * XYZ_QUANT_SCALE,
            intensity=self.intensity.to(torch.float32),
            time=torch.where(valid, time, 0.0),
            valid=valid)


def _pack_planes(q, inten8, time_plane, valid8) -> PackedRangeImage:
    """Host-side PackedRangeImage (numpy planes) from quantized planes."""
    valid = valid8.astype(bool)
    if valid.any():
        vals = np.asarray(time_plane, np.float32)[valid]
        t_min = float(vals.min())
        span = float(vals.max()) - t_min
    else:
        t_min, span = 0.0, 0.0
    scale = span / 255.0 if span > 0 else 1.0
    t_q = np.clip(np.round((np.asarray(time_plane, np.float32) - t_min) / scale),
                  0, 255).astype(np.uint8)
    return PackedRangeImage(
        xyz_q=q, intensity=inten8, t_q=t_q,
        t_min=np.float32(t_min), t_scale=np.float32(scale),
        counts=valid.sum(axis=1).astype(np.int32))


class FlatRangeImage:
    """Prefix-packed wire: only the valid points of a PackedRangeImage, as
    the concatenation of the per-ring prefixes, in a fixed capacity P.

    P is `SlamConfig.wire_capacity`, or R*C when that is 0 (lossless). A
    sweep above P keeps a uniform per-ring cap (`_water_fill_cap`): the
    tail columns of its fullest rings are dropped. Layout: xyz_q (P, 3)
    int16, meta (P, 2) uint8 [intensity, t_q], t_min/t_scale () float32,
    counts (R,) int32; `shape` = (R, C). Fields are numpy arrays on the
    host and tensors (possibly with a leading window axis) after upload."""

    __slots__ = ("xyz_q", "meta", "t_min", "t_scale", "counts", "shape")
    FIELDS = ("xyz_q", "meta", "t_min", "t_scale", "counts")

    def __init__(self, xyz_q, meta, t_min, t_scale, counts, shape):
        self.xyz_q = xyz_q
        self.meta = meta
        self.t_min = t_min
        self.t_scale = t_scale
        self.counts = counts
        self.shape = tuple(shape)

    @property
    def n_rings(self):
        return self.shape[0]

    @property
    def max_points(self):
        return self.shape[1]

    def unpack(self) -> RangeImage:
        R, C = self.shape
        P = self.xyz_q.shape[-2]
        dev = self.counts.device
        counts = self.counts
        starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
        col = torch.arange(C, dtype=torch.int32, device=dev)
        valid = col[None, :] < counts[:, None]
        idx = torch.clamp(starts[:, None] + col[None, :], max=P - 1).reshape(-1).to(torch.int64)
        xyz = self.xyz_q[idx].reshape(R, C, 3)
        meta = self.meta[idx].reshape(R, C, 2)
        xyz = torch.where(valid[..., None], xyz.to(torch.float32) * XYZ_QUANT_SCALE, 0.0)
        inten = torch.where(valid, meta[..., 0].to(torch.float32), 0.0)
        time = self.t_min + meta[..., 1].to(torch.float32) * self.t_scale
        return RangeImage(xyz=xyz, intensity=inten,
                          time=torch.where(valid, time, 0.0), valid=valid)


def _water_fill_cap(counts: np.ndarray, budget: int) -> np.ndarray:
    """Largest uniform per-ring cap k with sum(min(counts, k)) <= budget."""
    if counts.sum() <= budget:
        return counts
    lo, hi = 0, int(counts.max())
    while lo < hi:                      # bisect on k (<= 12 iterations)
        mid = (lo + hi + 1) // 2
        if int(np.minimum(counts, mid).sum()) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return np.minimum(counts, lo)


def flatten_packed(ri: PackedRangeImage, wire_capacity: int = 0) -> FlatRangeImage:
    """Host-side PackedRangeImage -> FlatRangeImage (see FlatRangeImage)."""
    q = np.asarray(ri.xyz_q)
    R, C = q.shape[:2]
    counts = np.asarray(ri.counts).astype(np.int64)
    P = int(wire_capacity) if wire_capacity else R * C
    kept = _water_fill_cap(counts, P)
    mask = np.arange(C)[None, :] < kept[:, None]
    n = int(kept.sum())
    xyz_q = np.zeros((P, 3), np.int16)
    meta = np.zeros((P, 2), np.uint8)
    xyz_q[:n] = q[mask]
    meta[:n, 0] = np.asarray(ri.intensity)[mask]
    meta[:n, 1] = np.asarray(ri.t_q)[mask]
    return FlatRangeImage(xyz_q=xyz_q, meta=meta, t_min=np.float32(ri.t_min),
                          t_scale=np.float32(ri.t_scale),
                          counts=kept.astype(np.int32), shape=(R, C))


class ByteRangeImage:
    """One quantized sweep in ONE uint8 buffer (one host->device copy).
    Layout, for n = R*C: [xyz_q i16 (6n)] [intensity u8 (n)] [time f16 (2n)]
    [valid u8 (n)], little-endian — the JAX package's wire."""

    __slots__ = ("buf", "shape")

    def __init__(self, buf: torch.Tensor, shape):
        self.buf = buf
        self.shape = tuple(shape)

    @property
    def n_rings(self):
        return self.shape[0]

    @property
    def max_points(self):
        return self.shape[1]

    def unpack(self) -> RangeImage:
        R, C = self.shape
        n = R * C
        b = self.buf
        q = b[:6 * n].view(torch.int16).reshape(R, C, 3)
        inten = b[6 * n:7 * n].reshape(R, C)
        t = b[7 * n:9 * n].view(torch.float16).reshape(R, C)
        valid = b[9 * n:10 * n].reshape(R, C) != 0
        return RangeImage(
            xyz=q.to(torch.float32) * XYZ_QUANT_SCALE,
            intensity=inten.to(torch.float32),
            time=t.to(torch.float32),
            valid=valid)


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device` (None: kept on the host). To a GPU it goes
    from pinned memory without waiting for the work queued before it."""
    if device is None:
        return t
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pack_range_image_bytes(q, inten8, t16, valid8, device=None) -> ByteRangeImage:
    """One wire buffer from the quantized host planes. With `device` the
    buffer is uploaded (one copy); otherwise it stays a CPU tensor."""
    buf = np.concatenate([
        np.ascontiguousarray(q, np.int16).view(np.uint8).ravel(),
        np.ascontiguousarray(inten8, np.uint8).ravel(),
        np.ascontiguousarray(t16, np.float16).view(np.uint8).ravel(),
        np.ascontiguousarray(valid8, np.uint8).ravel()])
    return ByteRangeImage(upload(torch.from_numpy(buf), device), q.shape[:2])


def ensure_range_image(ri) -> RangeImage:
    if isinstance(ri, (ByteRangeImage, PackedRangeImage, FlatRangeImage)):
        return ri.unpack()
    return ri


def stack_range_images(ris, device=None):
    """Stack host-built sweeps (numpy fields) into one leading-axis-W
    container with one tensor per field, on `device` when given."""
    r0 = ris[0]
    fields = FlatRangeImage.FIELDS if isinstance(r0, FlatRangeImage) else type(r0)._fields

    def stack(name):
        t = torch.from_numpy(np.stack([np.asarray(getattr(r, name)) for r in ris]))
        return t if device is None else t.to(device)
    if isinstance(r0, FlatRangeImage):
        return FlatRangeImage(*(stack(f) for f in fields), r0.shape)
    return type(r0)(*(stack(f) for f in fields))


def to_device_range_image(ri, device=None):
    """One host-built sweep (numpy fields) as tensors on `device`."""
    def up(a):
        t = torch.from_numpy(np.asarray(a))
        return t if device is None else t.to(device)
    if isinstance(ri, FlatRangeImage):
        return FlatRangeImage(*(up(getattr(ri, f)) for f in FlatRangeImage.FIELDS),
                              ri.shape)
    return type(ri)(*(up(a) for a in ri))


class Keypoints(NamedTuple):
    """Fixed-capacity compacted keypoint set (one instance per keypoint type)."""

    xyz: torch.Tensor        # (K, 3) float32
    intensity: torch.Tensor  # (K,) float32
    time: torch.Tensor       # (K,) float32
    ring: torch.Tensor       # (K,) int32 — laser ring the point came from
    valid: torch.Tensor      # (K,) bool
    count: torch.Tensor      # () int32

    @classmethod
    def empty(cls, capacity: int, device):
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(xyz=z((capacity, 3), torch.float32), intensity=z((capacity,), torch.float32),
                   time=z((capacity,), torch.float32), ring=z((capacity,), torch.int32),
                   valid=z((capacity,), torch.bool), count=z((), torch.int32))


def flatten_keypoints(kp: Keypoints) -> torch.Tensor:
    """One (7K+1,) float32 log buffer per keypoint set, a fresh tensor apart
    from the stream state. Layout: x(K) y(K) z(K) intensity(K) time(K)
    ring(K) valid(K) count(1)."""
    f = torch.float32
    return torch.cat([kp.xyz[:, 0], kp.xyz[:, 1], kp.xyz[:, 2], kp.intensity, kp.time,
                      kp.ring.to(f), kp.valid.to(f), kp.count.to(f)[None]])


class KeypointsView:
    """Lazy host view over a flattened keypoint log buffer: the `Keypoints`
    attribute surface as numpy arrays, copied from the device once, at the
    first access. `row` picks one sweep of a window-stacked (W, 7K+1)
    buffer."""

    __slots__ = ("_buf", "_host", "_row")

    def __init__(self, buf, row=None):
        self._buf = buf
        self._row = row
        self._host = None

    def _h(self):
        if self._host is None:
            b = self._buf if self._row is None else self._buf[self._row]
            self._host = b.cpu().numpy()
        return self._host

    @property
    def capacity(self):
        return (self._buf.shape[-1] - 1) // 7

    @property
    def xyz(self):
        h, K = self._h(), self.capacity
        return np.stack([h[:K], h[K:2 * K], h[2 * K:3 * K]], axis=-1)

    @property
    def intensity(self):
        h, K = self._h(), self.capacity
        return h[3 * K:4 * K]

    @property
    def time(self):
        h, K = self._h(), self.capacity
        return h[4 * K:5 * K]

    @property
    def ring(self):
        h, K = self._h(), self.capacity
        return h[5 * K:6 * K].astype(np.int32)

    @property
    def valid(self):
        h, K = self._h(), self.capacity
        return h[6 * K:7 * K] != 0.0

    @property
    def count(self):
        return np.int32(self._h()[-1])

    @property
    def device_nbytes(self):
        # a row view accounts only its own share of the stacked buffer
        return int(self._buf.shape[-1]) * 4


def transform_keypoints(kp: Keypoints, pose6: torch.Tensor, time_offset=0.0) -> Keypoints:
    """Rigidly transform a keypoint set (LIDAR->BASE calibration) and shift
    its point times (AggregateFrames semantics, Slam.cxx:1512-1578). The
    rotation is three float32 multiply-adds per coordinate, never a matmul,
    so no TF32 path can round it."""
    from lidarslam_tpu_torch.core import se3

    R, t = se3.jpose_to_rt(pose6.to(torch.float32))
    x = kp.xyz
    xyz = x[:, 0:1] * R[:, 0] + x[:, 1:2] * R[:, 1] + x[:, 2:3] * R[:, 2] + t
    return kp._replace(xyz=xyz, time=kp.time + time_offset)


def merge_keypoints(sets, capacity: int) -> Keypoints:
    """Concatenate keypoint sets from several devices into one
    fixed-capacity set, valid slots first in their concatenation order (a
    stable sort on ~valid, as the JAX package's `lax.sort`), truncated to
    `capacity`."""
    xyz = torch.cat([s.xyz for s in sets])
    valid = torch.cat([s.valid for s in sets])
    _, order = torch.sort((~valid).to(torch.int32), stable=True)
    crow = order[:capacity]
    count = torch.clamp(valid.sum(), max=capacity).to(torch.int32)
    slot_valid = torch.arange(capacity, device=xyz.device) < count
    return Keypoints(xyz=xyz[crow], intensity=torch.cat([s.intensity for s in sets])[crow],
                     time=torch.cat([s.time for s in sets])[crow],
                     ring=torch.cat([s.ring for s in sets])[crow], valid=slot_valid,
                     count=count)


def build_range_image(xyz, intensity, laser_id, time, n_rings: int,
                      max_ring_points: int, packed: bool = False, device=None):
    """Host-side bucketing of an unordered point list into a range image.

    Points are appended to their ring in input order (SSKE.cxx:139-161);
    points beyond `max_ring_points` per ring and rings >= n_rings are
    dropped. `packed=True` returns the quantized `ByteRangeImage` wire,
    otherwise a float32 `RangeImage`; tensors go to `device` when given.
    `device=False` keeps numpy planes on the host (the window path: several
    sweeps stack into one upload): a `PackedRangeImage` when packed, a
    `RangeImage` of numpy arrays otherwise.

    The scatter runs in C++ (`io/native.py`) where its library loads, as in
    the JAX package; the numpy path below is the same scatter. The two
    quantize differently in a few coordinates (C++ multiplies by 1/0.004
    where numpy divides by 0.004): 7 of a VLP-16 sweep's, one step each."""
    xyz = np.asarray(xyz, np.float32)
    laser_id = np.asarray(laser_id, np.int64)

    def up(a):
        return a if device is False else upload(torch.from_numpy(a), device)

    if native.available():
        if packed and device is False:
            out = native.build_range_image_packed2_native(
                xyz, intensity, laser_id, time, n_rings, max_ring_points, XYZ_QUANT_SCALE)
            q, inten8, t_q, t_min, t_scale, counts = out
            return PackedRangeImage(xyz_q=q, intensity=inten8, t_q=t_q, t_min=t_min,
                                    t_scale=t_scale, counts=counts)
        if packed:
            q, inten8, t16, valid8 = native.build_range_image_packed_native(
                xyz, intensity, laser_id, time, n_rings, max_ring_points, XYZ_QUANT_SCALE)
            return pack_range_image_bytes(q, inten8, t16, valid8, device=device)
        oxyz, ointen, otime, ovalid = native.build_range_image_native(
            xyz, intensity, laser_id, time, n_rings, max_ring_points)
        return RangeImage(xyz=up(oxyz), intensity=up(ointen), time=up(otime),
                          valid=up(ovalid.astype(bool)))
    keep = (laser_id >= 0) & (laser_id < n_rings)

    lid_kept = laser_id[keep]
    order = np.argsort(lid_kept, kind="stable")
    sorted_lid = lid_kept[order]
    start = np.searchsorted(sorted_lid, np.arange(n_rings), side="left")
    run = np.arange(len(sorted_lid)) - start[sorted_lid]
    cols_kept = np.empty(len(lid_kept), np.int64)
    cols_kept[order] = run

    keep_idx = np.flatnonzero(keep)
    in_cap = cols_kept < max_ring_points
    keep_idx = keep_idx[in_cap]
    rows = laser_id[keep_idx]
    cols_f = cols_kept[in_cap]

    img_xyz = np.zeros((n_rings, max_ring_points, 3), np.float32)
    img_int = np.zeros((n_rings, max_ring_points), np.float32)
    img_time = np.zeros((n_rings, max_ring_points), np.float32)
    img_valid = np.zeros((n_rings, max_ring_points), bool)
    img_xyz[rows, cols_f] = xyz[keep_idx]
    img_int[rows, cols_f] = np.asarray(intensity, np.float32)[keep_idx]
    img_time[rows, cols_f] = np.asarray(time, np.float32)[keep_idx]
    img_valid[rows, cols_f] = True

    if packed:
        q = np.clip(np.round(img_xyz / XYZ_QUANT_SCALE), -32767, 32767).astype(np.int16)
        inten8 = np.clip(img_int, 0, 255).astype(np.uint8)
        if device is False:
            return _pack_planes(q, inten8, img_time, img_valid.astype(np.uint8))
        return pack_range_image_bytes(q, inten8, img_time.astype(np.float16),
                                      img_valid.astype(np.uint8), device=device)

    return RangeImage(xyz=up(img_xyz), intensity=up(img_int),
                      time=up(img_time), valid=up(img_valid))


def estimate_azimuthal_resolution(ri: RangeImage) -> float:
    """Host-side estimate of the sensor's azimuthal resolution [rad]:
    median-shrinking estimator over horizontal angles between successive
    firings of the same ring (SSKE.cxx:593-637)."""
    xy = ri.xyz.detach().cpu().numpy()[..., :2]
    valid = ri.valid.detach().cpu().numpy()
    a, b = xy[:, :-1], xy[:, 1:]
    pair_valid = valid[:, :-1] & valid[:, 1:]
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    denom = np.maximum(na * nb, 1e-12)
    cosang = np.clip(np.sum(a * b, axis=-1) / denom, -1.0, 1.0)
    ang = np.abs(np.arccos(cosang))[pair_valid]
    ang = ang[ang > 1e-4]
    if len(ang) < 100:
        return np.deg2rad(0.2)  # fallback default (SSKE.cxx:217-218)
    ang = np.sort(ang)
    hi = len(ang)
    max_angle = np.deg2rad(5.0)
    median = 0.0
    while max_angle > 1.8 * median:
        hi = int(np.searchsorted(ang[:hi], max_angle, side="right"))
        if hi == 0:
            return np.deg2rad(0.2)
        median = float(ang[hi // 2])
        max_angle = min(median * 2.0, max_angle / 1.8)
    return median
