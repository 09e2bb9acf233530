"""Fixed-shape sweep containers (PyTorch port of `lidarslam_tpu/ops/frame.py`).

A sweep is a ring-major range image: (R, C) tensors, row = laser ring,
column = firing index within the ring, packed left, with a validity mask.
Keypoint sets are fixed-capacity (K,) struct-of-arrays with a count.

The host->device wire is the JAX package's `ByteRangeImage` byte layout
(4 mm int16 coordinates, u8 intensity, f16 per-point time, u8 validity), so
the port sees bit-identically the same quantized sweep as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

XYZ_QUANT_SCALE = 0.004  # [m] upload quantization step (~sensor noise / 5)


class RangeImage(NamedTuple):
    """A sweep as a ring-major range image (all tensors (R, C) except xyz)."""

    xyz: torch.Tensor        # (R, C, 3) float32, LIDAR sensor frame (spin axis = Z)
    intensity: torch.Tensor  # (R, C) float32
    time: torch.Tensor       # (R, C) float32 — offset [s] from the frame stamp
    valid: torch.Tensor      # (R, C) bool — packed left per row


class ByteRangeImage:
    """One quantized sweep in ONE uint8 buffer (one host->device copy).
    Layout, for n = R*C: [xyz_q i16 (6n)] [intensity u8 (n)] [time f16 (2n)]
    [valid u8 (n)], little-endian — the JAX package's wire."""

    __slots__ = ("buf", "shape")

    def __init__(self, buf: torch.Tensor, shape):
        self.buf = buf
        self.shape = tuple(shape)

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


def pack_range_image_bytes(q, inten8, t16, valid8, device=None) -> ByteRangeImage:
    """One wire buffer from the quantized host planes. With `device` the
    buffer is uploaded (one copy); otherwise it stays a CPU tensor."""
    buf = np.concatenate([
        np.ascontiguousarray(q, np.int16).view(np.uint8).ravel(),
        np.ascontiguousarray(inten8, np.uint8).ravel(),
        np.ascontiguousarray(t16, np.float16).view(np.uint8).ravel(),
        np.ascontiguousarray(valid8, np.uint8).ravel()])
    t = torch.from_numpy(buf)
    if device is not None:
        t = t.to(device)
    return ByteRangeImage(t, q.shape[:2])


def ensure_range_image(ri) -> RangeImage:
    if isinstance(ri, ByteRangeImage):
        return ri.unpack()
    return ri


class Keypoints(NamedTuple):
    """Fixed-capacity compacted keypoint set (one instance per keypoint type)."""

    xyz: torch.Tensor        # (K, 3) float32
    intensity: torch.Tensor  # (K,) float32
    time: torch.Tensor       # (K,) float32
    ring: torch.Tensor       # (K,) int32 — laser ring the point came from
    valid: torch.Tensor      # (K,) bool
    count: torch.Tensor      # () int32


def build_range_image(xyz, intensity, laser_id, time, n_rings: int,
                      max_ring_points: int, packed: bool = False, device=None):
    """Host-side bucketing of an unordered point list into a range image.

    Points are appended to their ring in input order (SSKE.cxx:139-161);
    points beyond `max_ring_points` per ring and rings >= n_rings are
    dropped. `packed=True` returns the quantized `ByteRangeImage` wire,
    otherwise a float32 `RangeImage`; tensors go to `device` when given."""
    xyz = np.asarray(xyz, np.float32)
    laser_id = np.asarray(laser_id, np.int64)
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
        return pack_range_image_bytes(q, inten8, img_time.astype(np.float16),
                                      img_valid.astype(np.uint8), device=device)

    def up(a):
        t = torch.from_numpy(a)
        return t if device is None else t.to(device)
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
