"""Octree point-cloud compression (PointCloudStorage.h:169-242 analog): a copy
of `lidarslam_tpu/io/octree.py`.

The reference's OCTREE_COMPRESSED logging backend wraps PCL's
`OctreePointCloudCompression` (~5x smaller than raw, ~3 ms/frame). This is
our own codec with the same contract — lossy positions at a fixed leaf
resolution, lossless per-point attributes, in-RAM byte blob:

- quantize to the leaf grid, Morton-interleave, sort; points are stored in
  Morton order (spatially coherent clouds become near-sequential codes);
- the set of occupied leaves is encoded as breadth-first **occupancy
  bytes**: one byte per occupied node per level marking which of its 8
  children exist (the classic octree-compression layout);
- per-leaf point multiplicity as u8 with a u32 escape, per-point
  attributes (u8 intensity, f16 time, u8 ring) in Morton order;
- the whole stream is DEFLATE-compressed (occupancy bytes and coherent
  attributes are highly redundant).

Decoded positions are leaf centers: error <= res/2 per axis (2 mm at the
default 4 mm leaf — the same bound as the int16 COMPRESSED backend, but
~2-3x smaller again because shared prefixes of nearby points are stored
once). Everything is vectorized numpy; encode cost is O(n log n) in the
Morton sort.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

_MAGIC = b"LSOC1"
_AXIS_BITS = 21  # 3 x 21 = 63 bits of Morton code in uint64


class OctreeCloud(NamedTuple):
    """One compressed cloud: the blob plus the uncompressed point count."""

    blob: bytes
    n: int


def _spread3(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each uint64 so consecutive bits land 3 apart."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _compact3(v: np.ndarray) -> np.ndarray:
    """Inverse of _spread3: gather every 3rd bit back into the low 21 bits."""
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def morton_encode(q: np.ndarray) -> np.ndarray:
    """(n, 3) non-negative integer grid coords -> (n,) uint64 Morton codes."""
    q = np.asarray(q, np.uint64)
    return _spread3(q[:, 0]) | (_spread3(q[:, 1]) << np.uint64(1)) | (
        _spread3(q[:, 2]) << np.uint64(2))


def morton_decode(codes: np.ndarray) -> np.ndarray:
    """(n,) uint64 Morton codes -> (n, 3) uint32 grid coords."""
    codes = np.asarray(codes, np.uint64)
    return np.stack([_compact3(codes),
                     _compact3(codes >> np.uint64(1)),
                     _compact3(codes >> np.uint64(2))], axis=1).astype(np.uint32)


def _occupancy_bytes(leaf_codes: np.ndarray, depth: int) -> np.ndarray:
    """Breadth-first occupancy bytes of the octree over sorted unique leaves.

    Level L holds the unique code prefixes `leaf >> 3*(depth-L)`; each node
    at level L emits one byte whose bit c is set iff child `(node<<3)|c`
    exists at level L+1. The root (level 0) is always the single code 0
    prefix, so the stream needs no node ids at all — the decoder regrows
    the code lists level by level from the bytes alone.
    """
    streams = []
    child = leaf_codes  # unique, sorted
    for level in range(depth, 0, -1):
        parent = child >> np.uint64(3)
        # sorted unique parents + the inverse map child -> parent slot
        nodes, inv = np.unique(parent, return_inverse=True)
        bits = (child & np.uint64(7)).astype(np.uint8)
        bytes_ = np.zeros(len(nodes), np.uint8)
        np.bitwise_or.at(bytes_, inv, np.uint8(1) << bits)
        streams.append(bytes_)
        child = nodes
    # child is now the level-0 node list == [0]
    return np.concatenate(streams[::-1]) if streams else np.zeros(0, np.uint8)


def _grow_codes(occ: np.ndarray, depth: int) -> np.ndarray:
    """Inverse of _occupancy_bytes: regrow sorted unique leaf codes."""
    codes = np.zeros(1, np.uint64)
    pos = 0
    for _ in range(depth):
        level_bytes = occ[pos:pos + len(codes)]
        pos += len(codes)
        # expand each byte's set bits to child codes, preserving sort order
        bits = np.unpackbits(level_bytes[:, None], axis=1, bitorder="little")
        node_idx, child_bit = np.nonzero(bits)
        codes = (codes[node_idx] << np.uint64(3)) | child_bit.astype(np.uint64)
    return codes


def encode(xyz, intensity=None, time=None, ring=None,
           resolution: float = 0.004) -> OctreeCloud:
    """Compress a cloud to an octree blob at the given leaf resolution [m]."""
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    if n == 0:
        head = _MAGIC + struct.pack("<IIB", 0, 0, 0) + struct.pack(
            "<4d", 0.0, 0.0, 0.0, resolution)
        return OctreeCloud(blob=zlib.compress(head), n=0)

    origin = xyz.min(axis=0)
    q = np.floor((xyz - origin) / resolution).astype(np.int64)
    q = np.clip(q, 0, (1 << _AXIS_BITS) - 1).astype(np.uint64)
    codes = morton_encode(q)
    order = np.argsort(codes, kind="stable")
    codes = codes[order]

    leaves, counts = np.unique(codes, return_counts=True)
    max_code = int(leaves[-1]) if len(leaves) else 0
    depth = max(1, (max_code.bit_length() + 2) // 3)
    occ = _occupancy_bytes(leaves, depth)

    # per-leaf multiplicity: u8 with a u32 escape for counts >= 255
    cnt8 = np.minimum(counts, 255).astype(np.uint8)
    overflow = counts[counts >= 255].astype(np.uint32)

    def _attr(a, dtype, default):
        if a is None:
            return np.full(0, default, dtype)
        return np.asarray(a)[order].astype(dtype)

    inten = _attr(np.clip(intensity, 0, 255) if intensity is not None else None,
                  np.uint8, 0)
    tim = _attr(time, np.float16, 0)
    rng = _attr(np.clip(ring, 0, 255) if ring is not None else None, np.uint8, 0)

    flags = (1 if len(inten) else 0) | (2 if len(tim) else 0) | (4 if len(rng) else 0)
    head = _MAGIC + struct.pack("<IIB", n, len(leaves), depth)
    head += struct.pack("<4d", *origin, resolution)
    head += struct.pack("<BI", flags, len(overflow))
    raw = b"".join([head, occ.tobytes(), cnt8.tobytes(), overflow.tobytes(),
                    inten.tobytes(), tim.tobytes(), rng.tobytes()])
    # level 1: within 5% of level 6's ratio at half the encode time
    # (5.2x vs 5.5x on a 24k-point sweep, 15 ms vs 31 ms)
    return OctreeCloud(blob=zlib.compress(raw, level=1), n=n)


def decode(oc: OctreeCloud) -> dict:
    """Decompress to {'xyz' f32 (n,3) leaf centers, 'intensity', 'time', 'ring'}.

    Points come back in Morton order (a spatial resort of the input); all
    attributes follow the same order.
    """
    raw = zlib.decompress(oc.blob)
    if raw[:5] != _MAGIC:
        raise ValueError("not an octree blob")
    n, n_leaves, depth = struct.unpack_from("<IIB", raw, 5)
    origin = np.array(struct.unpack_from("<3d", raw, 14))
    (resolution,) = struct.unpack_from("<d", raw, 38)
    if n == 0:
        z = np.zeros(0, np.float32)
        return {"xyz": np.zeros((0, 3), np.float32), "intensity": z,
                "time": z, "ring": np.zeros(0, np.int32)}
    flags, n_over = struct.unpack_from("<BI", raw, 46)
    pos = 51

    # occupancy stream length = sum of node counts per level; regrow to get it
    # (the decoder walks the same level sizes the encoder wrote)
    codes = np.zeros(1, np.uint64)
    occ_len = 0
    occ_all = np.frombuffer(raw, np.uint8, offset=pos)
    for _ in range(depth):
        level = occ_all[occ_len:occ_len + len(codes)]
        occ_len += len(codes)
        bits = np.unpackbits(level[:, None], axis=1, bitorder="little")
        node_idx, child_bit = np.nonzero(bits)
        codes = (codes[node_idx] << np.uint64(3)) | child_bit.astype(np.uint64)
    assert len(codes) == n_leaves, (len(codes), n_leaves)
    pos += occ_len

    cnt = np.frombuffer(raw, np.uint8, count=n_leaves, offset=pos).astype(np.int64)
    pos += n_leaves
    overflow = np.frombuffer(raw, np.uint32, count=n_over, offset=pos)
    pos += 4 * n_over
    if n_over:
        cnt[cnt == 255] = overflow
    assert cnt.sum() == n, (cnt.sum(), n)

    q = morton_decode(codes).astype(np.float64)
    centers = origin + (q + 0.5) * resolution
    xyz = np.repeat(centers, cnt, axis=0).astype(np.float32)

    def _read(dtype, present, cast):
        nonlocal pos
        if not present:
            return np.zeros(n, cast)
        a = np.frombuffer(raw, dtype, count=n, offset=pos)
        pos += n * np.dtype(dtype).itemsize
        return a.astype(cast)

    return {"xyz": xyz,
            "intensity": _read(np.uint8, flags & 1, np.float32),
            "time": _read(np.float16, flags & 2, np.float32),
            "ring": _read(np.uint8, flags & 4, np.int32)}
