"""PCD point-cloud file I/O (interop with the reference's map files): a copy of
`lidarslam_tpu/io/pcd.py`.

Supports the `LidarPoint` field layout the reference writes via
`savePointCloudToPCD` (PointCloudStorage.h:85-115): x y z intensity time
laser_id device_id label, in ascii, binary, or PCL `binary_compressed`
encoding (LZF over field-major data — io/lzf.py), plus plain xyz[i]
clouds from other tools. Host-side numpy, no PCL dependency.
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
           ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def _write_body(f, rec, names, encoding):
    """Write the data section. `binary_compressed` is PCL's layout: two LE
    uint32 (compressed size, uncompressed size), then LZF over the
    FIELD-MAJOR reordering of the records (all x, then all y, ...)."""
    if encoding == "binary":
        f.write(rec.tobytes())
    elif encoding == "binary_compressed":
        from lidarslam_tpu_torch.io import lzf

        raw = b"".join(np.ascontiguousarray(rec[name]).tobytes() for name in names)
        comp = lzf.compress(raw)
        f.write(struct.pack("<II", len(comp), len(raw)))
        f.write(comp)
    else:
        np.savetxt(f, np.stack([rec[name].astype(np.float64) for name in names], 1),
                   fmt="%.7g")


def _encoding(binary, compressed):
    return "binary_compressed" if compressed else ("binary" if binary else "ascii")


def save_pcd(path, xyz, intensity=None, time=None, laser_id=None, label=None,
             binary=True, compressed=False):
    """Write a PCD v0.7 file with the reference-compatible field set.
    `compressed=True` writes PCL `binary_compressed` (LZF)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = [("x", "f4", xyz[:, 0]), ("y", "f4", xyz[:, 1]), ("z", "f4", xyz[:, 2])]
    if intensity is not None:
        fields.append(("intensity", "f4", np.asarray(intensity, np.float32)))
    if time is not None:
        fields.append(("time", "f8", np.asarray(time, np.float64)))
    if laser_id is not None:
        fields.append(("laser_id", "u2", np.asarray(laser_id, np.uint16)))
    if label is not None:
        fields.append(("label", "u1", np.asarray(label, np.uint8)))

    names = " ".join(f[0] for f in fields)
    sizes = " ".join(str(np.dtype(f[1]).itemsize) for f in fields)
    types = " ".join({"f": "F", "i": "I", "u": "U"}[np.dtype(f[1]).kind] for f in fields)
    counts = " ".join("1" for _ in fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {names}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {_encoding(binary, compressed)}\n"
    )
    rec = np.zeros(n, dtype=[(f[0], f[1]) for f in fields])
    for name, _, data in fields:
        rec[name] = data
    with open(path, "wb") as f:
        f.write(header.encode())
        _write_body(f, rec, [f_[0] for f_ in fields], _encoding(binary, compressed))


def save_pcd_fields(path, xyz, extra=None, binary=True, compressed=False):
    """Write a PCD v0.7 file with arbitrary extra per-point float32 fields.

    Used for the extractor debug-cloud export (the advanced-return arrays
    vtkSlam attaches to its outputs, vtkSlam.cxx:327-398): `extra` maps field
    name -> (N,) array, written as f4 after x y z.
    """
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = [("x", "f4", xyz[:, 0]), ("y", "f4", xyz[:, 1]), ("z", "f4", xyz[:, 2])]
    for name, data in (extra or {}).items():
        fields.append((name, "f4", np.asarray(data, np.float32)))

    names = " ".join(f[0] for f in fields)
    sizes = " ".join(str(np.dtype(f[1]).itemsize) for f in fields)
    types = " ".join({"f": "F", "i": "I", "u": "U"}[np.dtype(f[1]).kind] for f in fields)
    counts = " ".join("1" for _ in fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {names}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {_encoding(binary, compressed)}\n"
    )
    rec = np.zeros(n, dtype=[(f[0], f[1]) for f in fields])
    for name, _, data in fields:
        rec[name] = data
    with open(path, "wb") as f:
        f.write(header.encode())
        _write_body(f, rec, [f_[0] for f_ in fields], _encoding(binary, compressed))


def load_pcd(path):
    """Read a PCD file -> dict of field arrays (at least x/y/z -> 'xyz')."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        names = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join("1" * len(names))).split()]
        n = int(header["POINTS"])
        dt = []
        for name, t, s, c in zip(names, types, sizes, counts):
            base = _DTYPES[(t, s)]
            dt.append((name, base, (c,)) if c > 1 else (name, base))
        if header["DATA"] == "binary":
            rec = np.frombuffer(f.read(n * np.dtype(dt).itemsize), dtype=dt, count=n)
        elif header["DATA"] == "binary_compressed":
            # PCL layout: u32 compressed size, u32 uncompressed size, LZF
            # payload of the FIELD-MAJOR data (all x, then all y, ...)
            from lidarslam_tpu_torch.io import lzf

            comp_len, raw_len = np.frombuffer(f.read(8), "<u4")
            raw = lzf.decompress(f.read(int(comp_len)), int(raw_len))
            rec = np.zeros(n, dtype=dt)
            off = 0
            for name, t, s, c in zip(names, types, sizes, counts):
                nb = n * c * s
                col = np.frombuffer(raw[off:off + nb], _DTYPES[(t, s)])
                rec[name] = col.reshape(n, c) if c > 1 else col
                off += nb
        elif header["DATA"] == "ascii":
            raw = np.loadtxt(f, ndmin=2)
            rec = np.zeros(n, dtype=dt)
            col = 0
            for name, t, s, c in zip(names, types, sizes, counts):
                rec[name] = raw[:, col] if c == 1 else raw[:, col:col + c]
                col += c
        else:
            raise ValueError(f"unsupported PCD encoding {header['DATA']}")
    out = {name: np.array(rec[name]) for name in names}
    out["xyz"] = np.stack([out.pop("x"), out.pop("y"), out.pop("z")], axis=1).astype(np.float32)
    return out
