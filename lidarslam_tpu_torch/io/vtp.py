"""VTK XML PolyData (.vtp) writer — ParaView-consumable outputs, no vtk dep.

The reference's ParaView plugin serves its 8 output ports as vtkPolyData
(vtkSlam.cxx:47-60: registered frame, trajectory polyline with
orientation/covariance arrays, 3 maps, 3 keypoint clouds). This module
writes the same payloads as standalone `.vtp` files in the standard VTK
XML PolyData format (inline base64 "binary" encoding, little-endian,
UInt32 headers) so an actual ParaView/LidarView user can open this
engine's maps and trajectory directly — the environment has no vtk/UI,
but the FILE format needs neither.

Writers:
- `write_point_cloud_vtp(path, xyz, point_data=...)`: cloud as one vert
  cell per point (how LidarView renders maps/keypoints).
- `write_trajectory_vtp(path, slam_or_arrays)`: the trajectory port — a
  polyline through the poses carrying Time, Orientation(Quaternion) in
  wxyz order (matching the reference's trajectory output: vtkSlam.cxx
  :643-644 also inserts w,x,y,z — only its ROS odometry messages use
  xyzw), AxisAngle and the row-major 36-float Covariance arrays (vtkSlam
  trajectory arrays parity).

A minimal reader (`read_vtp`) round-trips what these writers emit (tests);
it is NOT a general VTK parser.

A copy of `lidarslam_tpu/io/vtp.py` (numpy on the host), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import struct
import xml.etree.ElementTree as ET

import numpy as np

_VTK_TYPE = {np.dtype(np.float32): "Float32", np.dtype(np.float64): "Float64",
             np.dtype(np.int32): "Int32", np.dtype(np.int64): "Int64",
             np.dtype(np.uint8): "UInt8"}


def _encode(arr: np.ndarray) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _data_array(name: str | None, arr: np.ndarray) -> ET.Element:
    arr = np.asarray(arr)
    ncomp = 1 if arr.ndim == 1 else arr.shape[1]
    el = ET.Element("DataArray", type=_VTK_TYPE[arr.dtype],
                    NumberOfComponents=str(ncomp), format="binary")
    if name:
        el.set("Name", name)
    el.text = _encode(arr)
    return el


def _piece(points: np.ndarray, point_data: dict | None):
    piece = ET.Element("Piece", NumberOfPoints=str(len(points)),
                       NumberOfVerts="0", NumberOfLines="0",
                       NumberOfStrips="0", NumberOfPolys="0")
    pts_el = ET.SubElement(piece, "Points")
    pts_el.append(_data_array(None, np.asarray(points, np.float32)))
    pd = ET.SubElement(piece, "PointData")
    for name, arr in (point_data or {}).items():
        pd.append(_data_array(name, arr))
    return piece


def _write(path: str, piece: ET.Element) -> None:
    root = ET.Element("VTKFile", type="PolyData", version="0.1",
                      byte_order="LittleEndian", header_type="UInt32")
    ET.SubElement(root, "PolyData").append(piece)
    ET.ElementTree(root).write(path, xml_declaration=True, encoding="UTF-8")


def write_point_cloud_vtp(path: str, xyz, point_data: dict | None = None):
    """Point cloud -> .vtp with one vert cell per point (map/keypoint ports)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    piece = _piece(xyz, point_data)
    n = len(xyz)
    piece.set("NumberOfVerts", str(n))
    verts = ET.SubElement(piece, "Verts")
    verts.append(_data_array("connectivity", np.arange(n, dtype=np.int64)))
    verts.append(_data_array("offsets", np.arange(1, n + 1, dtype=np.int64)))
    _write(path, piece)


def write_trajectory_vtp(path: str, slam=None, *, positions=None,
                         point_data: dict | None = None):
    """Trajectory port -> .vtp polyline with the vtkSlam trajectory arrays
    (Time, Orientation(Quaternion) wxyz, Orientation(AxisAngle), Covariance
    row-major 36 — vtkSlam.cxx:631-665 parity via export.trajectory_arrays)."""
    if slam is not None:
        from lidarslam_tpu_torch.io import export

        arrays = export.trajectory_arrays(slam)
        positions = arrays.pop("position")
        point_data = {k: np.asarray(v) for k, v in arrays.items()}
    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    piece = _piece(positions, point_data)
    n = len(positions)
    piece.set("NumberOfLines", "1" if n > 1 else "0")
    lines = ET.SubElement(piece, "Lines")
    lines.append(_data_array("connectivity", np.arange(n, dtype=np.int64)))
    lines.append(_data_array("offsets", np.asarray([n], np.int64)))
    _write(path, piece)


def _decode(el: ET.Element) -> np.ndarray:
    dt = {v: k for k, v in _VTK_TYPE.items()}[el.get("type")]
    raw = base64.b64decode(el.text.strip())
    (nbytes,) = struct.unpack("<I", raw[:4])
    arr = np.frombuffer(raw[4:4 + nbytes], dt)
    ncomp = int(el.get("NumberOfComponents", "1"))
    return arr.reshape(-1, ncomp) if ncomp > 1 else arr


def read_vtp(path: str):
    """Round-trip reader for the writers above: returns (points,
    {point-data name: array}, {'verts'|'lines': (connectivity, offsets)})."""
    root = ET.parse(path).getroot()
    piece = root.find("PolyData/Piece")
    points = _decode(piece.find("Points/DataArray"))
    pdata = {el.get("Name"): _decode(el)
             for el in piece.find("PointData").iter("DataArray")}
    cells = {}
    for kind in ("Verts", "Lines"):
        sec = piece.find(kind)
        if sec is not None:
            arrs = {el.get("Name"): _decode(el) for el in sec.iter("DataArray")}
            cells[kind.lower()] = (arrs["connectivity"], arrs["offsets"])
    return points, pdata, cells
