"""LZF block codec — the compression inside PCL's `binary_compressed` PCD
encoding (PointCloudStorage.h:249-312, pcl::lzfCompress/lzfDecompress): a
copy of `lidarslam_tpu/io/lzf.py`.

Native C++ kernel (native/lzf.cpp, built and loaded by the port's
io/native.py) with a pure-Python fallback,
so compressed maps/logs written by LidarView/PCL round-trip even without a
compiler. The stream format: control byte < 32 = literal run of ctrl+1
bytes; >= 32 = back-reference with 3-bit length (7 -> +1 extension byte)
and 13-bit distance."""

from __future__ import annotations

import numpy as np

from lidarslam_tpu_torch.io import native as native_mod


def _native():
    """The native library (its LZF entry points declared at load), or None."""
    return native_mod._load()


def compress(data: bytes) -> bytes:
    """LZF-compress. Always succeeds (worst case ~3% expansion)."""
    data = bytes(data)
    n = len(data)
    if n == 0:
        return b""
    cap = n + n // 16 + 64
    lib = _native()
    if lib is not None:
        src = np.frombuffer(data, np.uint8)
        out = np.empty(cap, np.uint8)
        m = lib.lst_lzf_compress(native_mod._ptr(src), n, native_mod._ptr(out), cap)
        if m > 0:
            return out[:m].tobytes()
    return _compress_py(data)


def decompress(data: bytes, out_len: int) -> bytes:
    """Decompress to exactly `out_len` bytes (raises on malformed input)."""
    if out_len == 0:
        return b""
    lib = _native()
    if lib is not None:
        src = np.frombuffer(bytes(data), np.uint8)
        out = np.empty(out_len, np.uint8)
        m = lib.lst_lzf_decompress(native_mod._ptr(src), len(src),
                                   native_mod._ptr(out), out_len)
        if m != out_len:
            raise ValueError(f"LZF decompress: got {m}, expected {out_len}")
        return out.tobytes()
    return _decompress_py(data, out_len)


# ---------------------------------------------------------------------------
# pure-Python fallback (correct, slower)
# ---------------------------------------------------------------------------

_HLOG = 14
_MAX_OFF = 1 << 13
_MAX_REF = 264
_MAX_LIT = 32


def _compress_py(data: bytes) -> bytes:
    n = len(data)
    table = {}
    out = bytearray()
    ip = 0
    lit_start = 0

    def flush(end):
        s = lit_start
        while s < end:
            run = min(end - s, _MAX_LIT)
            out.append(run - 1)
            out.extend(data[s:s + run])
            s += run

    while ip + 2 < n:
        key = data[ip:ip + 3]
        ref = table.get(key, -1)
        table[key] = ip
        off = ip - ref - 1
        if ref >= 0 and off < _MAX_OFF:
            maxlen = min(n - ip, _MAX_REF)
            length = 3
            while length < maxlen and data[ref + length] == data[ip + length]:
                length += 1
            flush(ip)
            lit_start = ip + length
            l = length - 2
            if l < 7:
                out.append((off >> 8) | (l << 5))
            else:
                out.append((off >> 8) | (7 << 5))
                out.append(l - 7)
            out.append(off & 0xFF)
            ip += length
        else:
            ip += 1
    flush(n)
    return bytes(out)


def _decompress_py(data: bytes, out_len: int) -> bytes:
    out = bytearray()
    ip = 0
    n = len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:
            run = ctrl + 1
            out += data[ip:ip + run]
            ip += run
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[ip]
                ip += 1
            length += 2
            off = ((ctrl & 0x1F) << 8) | data[ip]
            ip += 1
            ref = len(out) - off - 1
            if ref < 0:
                raise ValueError("LZF: bad back-reference")
            for _ in range(length):   # may self-overlap
                out.append(out[ref])
                ref += 1
    if len(out) != out_len:
        raise ValueError(f"LZF decompress: got {len(out)}, expected {out_len}")
    return bytes(out)
