"""ctypes binding to the native host ingest (`native/range_image.cpp`) and
LZF codec (`native/lzf.cpp`): the port's copy of `lidarslam_tpu/io/native.py`.

At first use the library is compiled from the repository's `native/*.cpp`
with the compiler line of `native/build.sh` into `lidarslam_tpu_torch/_build/`
and loaded from there; the JAX package's own build product under `native/`
is never written or loaded. Where no compiler is found the callers take the
numpy path, and `last_error()` says why the library did not load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_ERROR = None
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = tuple(os.path.join(_ROOT, "native", f) for f in ("range_image.cpp", "lzf.cpp"))
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_SO = None      # the library's path, once built or found


def _so_path() -> str:
    """The library's path for this host: named by a hash of the compiler
    line and of the target options `-march=native` resolves to here, so a
    library built on another CPU (carried in a copy of the tree) is never
    loaded."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"], check=True,
                            capture_output=True, timeout=60).stdout
    key = hashlib.sha256(" ".join(_FLAGS).encode() + target).hexdigest()[:16]
    return os.path.join(_BUILD, f"liblidarslam_native_{key}.so")


def _build() -> str:
    """Compile the sources into `_build/` unless this host's library there
    is newer than every source; returns its path."""
    global _SO
    so = _so_path()
    if not (os.path.exists(so) and all(os.path.getmtime(so) >= os.path.getmtime(s)
                                       for s in _SRC)):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_FLAGS, *_SRC, "-o", tmp], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, so)
    _SO = so
    return so


def _load():
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(_build())
        i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
        p = ctypes.c_void_p
        lib.lst_build_range_image.restype = i64
        lib.lst_build_range_image.argtypes = [p, p, p, p, i64, i32, i32, p, p, p, p]
        lib.lst_build_range_image_packed.restype = i64
        lib.lst_build_range_image_packed.argtypes = [p, p, p, p, i64, i32, i32,
                                                     f32, p, p, p, p]
        lib.lst_build_range_image_packed2.restype = i64
        lib.lst_build_range_image_packed2.argtypes = [
            p, p, p, p, i64, i32, i32, f32, p, p, p, p, p]
        lib.lst_lzf_compress.restype = i64
        lib.lst_lzf_compress.argtypes = [p, i64, p, i64]
        lib.lst_lzf_decompress.restype = i64
        lib.lst_lzf_decompress.argtypes = [p, i64, p, i64]
        _LIB = lib
    except (OSError, subprocess.SubprocessError, AttributeError) as e:
        detail = getattr(e, "stderr", b"") or b""
        _ERROR = f"{type(e).__name__}: {e} {detail.decode(errors='replace')}".strip()
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def last_error():
    """Why the library did not load (None when it did, or was not tried)."""
    return _ERROR


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _inputs(xyz, intensity, laser_id, time):
    return (np.ascontiguousarray(xyz, np.float32), np.ascontiguousarray(intensity, np.float32),
            np.ascontiguousarray(laser_id, np.int32), np.ascontiguousarray(time, np.float32))


def build_range_image_native(xyz, intensity, laser_id, time, n_rings, max_ring_points):
    """-> (xyz (R,C,3) f32, intensity (R,C) f32, time (R,C) f32, valid (R,C) u8)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    xyz, inten, lid, t = _inputs(xyz, intensity, laser_id, time)
    R, C = n_rings, max_ring_points
    out_xyz = np.zeros((R, C, 3), np.float32)
    out_int = np.zeros((R, C), np.float32)
    out_time = np.zeros((R, C), np.float32)
    out_valid = np.zeros((R, C), np.uint8)
    lib.lst_build_range_image(_ptr(xyz), _ptr(inten), _ptr(lid), _ptr(t),
                              len(lid), R, C, _ptr(out_xyz), _ptr(out_int),
                              _ptr(out_time), _ptr(out_valid))
    return out_xyz, out_int, out_time, out_valid


def build_range_image_packed2_native(xyz, intensity, laser_id, time, n_rings,
                                     max_ring_points, scale):
    """-> (xyz_q (R,C,3) i16, intensity (R,C) u8, t_q (R,C) u8, t_min f32,
    t_scale f32, counts (R,) i32): the window sweep's wire, assembled in C++;
    None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    xyz, inten, lid, t = _inputs(xyz, intensity, laser_id, time)
    R, C = n_rings, max_ring_points
    out_xyz = np.zeros((R, C, 3), np.int16)
    out_int = np.zeros((R, C), np.uint8)
    out_tq = np.zeros((R, C), np.uint8)
    out_counts = np.zeros((R,), np.int32)
    tmeta = np.zeros((2,), np.float32)
    lib.lst_build_range_image_packed2(
        _ptr(xyz), _ptr(inten), _ptr(lid), _ptr(t), len(lid), R, C,
        1.0 / scale, _ptr(out_xyz), _ptr(out_int), _ptr(out_tq),
        _ptr(out_counts), _ptr(tmeta))
    return (out_xyz, out_int, out_tq, np.float32(tmeta[0]),
            np.float32(tmeta[1]), out_counts)


def build_range_image_packed_native(xyz, intensity, laser_id, time, n_rings,
                                    max_ring_points, scale):
    """-> (xyz_q (R,C,3) i16, intensity (R,C) u8, time (R,C) f16, valid u8)
    or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    xyz, inten, lid, t = _inputs(xyz, intensity, laser_id, time)
    R, C = n_rings, max_ring_points
    out_xyz = np.zeros((R, C, 3), np.int16)
    out_int = np.zeros((R, C), np.uint8)
    out_time = np.zeros((R, C), np.uint16)
    out_valid = np.zeros((R, C), np.uint8)
    lib.lst_build_range_image_packed(_ptr(xyz), _ptr(inten), _ptr(lid), _ptr(t),
                                     len(lid), R, C, 1.0 / scale, _ptr(out_xyz),
                                     _ptr(out_int), _ptr(out_time), _ptr(out_valid))
    return out_xyz, out_int, out_time.view(np.float16), out_valid
