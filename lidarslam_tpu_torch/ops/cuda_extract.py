"""Keypoint labelling of one sweep by the hand-written CUDA kernel
(`csrc/extract.cu`): one launch, one CTA per ring.

It computes what `ops/extractor.label_grids` (the torch form, the CPU path
and the kernel's reference) computes: the edge, plane and blob labels, the
point validity, the edge validity and the four scores, each (R, C). The
kernel replaces no TPU kernel: it does in one launch what the torch form
does in ~4.5k (see the note at the top of the source).

`extract_keypoints` calls `launch` for a sweep on a CUDA device; there is
no fallback. The kernel is instantiated for neighbor_width 1..MAX_W and
rings of at most MAX_C slots, and `launch` raises beyond them. It runs on
the current stream, allocates nothing (the two output tensors come from
`torch.empty`) and reads the azimuthal resolution from its device scalar,
so a CUDA graph captures it like any kernel. Each launch adds one to
`LAUNCHES`; the kernel counts its own executions on the device, graph
replays included (`executions`, `reset_executions`). The library is
`ops/cuda_knn`'s, built from both sources.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lidarslam_tpu_torch.config import ExtractorConfig
from lidarslam_tpu_torch.ops import cuda_knn

MAX_W = 8          # csrc/extract.cu kMaxW
MAX_C = 4096       # csrc/extract.cu kMaxC
LAUNCHES = 0       # kernel launches made through `launch`

_i64x2 = ctypes.c_longlong * 2


class _Args(ctypes.Structure):
    """csrc/extract.cu ExtractArgs, field for field."""
    _fields_ = [
        ("xyz", ctypes.c_void_p), ("intensity", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("az", ctypes.c_void_p),
        ("labels", ctypes.c_void_p), ("scores", ctypes.c_void_p),
        ("xyz_stride", ctypes.c_longlong * 3), ("intensity_stride", _i64x2),
        ("valid_stride", _i64x2),
        ("R", ctypes.c_int), ("C", ctypes.c_int), ("W", ctypes.c_int),
        ("rounds", ctypes.c_int), ("blob_stride", ctypes.c_int),
        ("az_value", ctypes.c_float), ("angle_beam_normal", ctypes.c_float),
        ("min_distance", ctypes.c_float), ("max_sin", ctypes.c_float),
        ("sq_line_max_distance", ctypes.c_float),
        ("sq_dist_line_threshold", ctypes.c_float),
        ("depth_gap_threshold", ctypes.c_float),
        ("sin_angle_threshold", ctypes.c_float),
        ("saliency_threshold", ctypes.c_float),
        ("intensity_gap_threshold", ctypes.c_float),
        ("plane_threshold", ctypes.c_float),
    ]


_checked = False


def _library():
    global _checked
    lib = cuda_knn._library()
    if not _checked:
        if (lib.extract_max_w(), lib.extract_max_c(), lib.extract_args_bytes()) != (
                MAX_W, MAX_C, ctypes.sizeof(_Args)):
            raise RuntimeError("csrc/extract.cu constants disagree with cuda_extract.py")
        _checked = True
    return lib


def launch(ri, azimuthal_resolution, cfg: ExtractorConfig):
    """Label the sweep `ri` (a RangeImage on one CUDA device) at
    `azimuthal_resolution` (a float32 device scalar on the same device, or a
    host number). Returns (labels (5, R, C) bool: edge, plane, blob, point
    validity, edge validity; scores (4, R, C) f32: sin_angle, saliency,
    depth_gap, intensity_gap)."""
    global LAUNCHES
    xyz, intensity, valid = ri.xyz, ri.intensity, ri.valid
    if not xyz.is_cuda:
        raise ValueError(f"the extraction kernel takes CUDA tensors, got {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (R, C, 3), got {tuple(xyz.shape)}")
    R, C = xyz.shape[:2]
    W = cfg.neighbor_width
    if not 1 <= W <= MAX_W:
        raise ValueError(f"neighbor_width={W} outside the kernel's range 1..{MAX_W}")
    if C > MAX_C:
        raise ValueError(f"{C} slots a ring: the kernel takes at most {MAX_C}")
    if cfg.nms_rounds < 0 or cfg.blob_stride < 1:
        raise ValueError(f"nms_rounds={cfg.nms_rounds} and blob_stride={cfg.blob_stride} "
                         "must be >= 0 and >= 1")
    dev = xyz.device
    for name, t, dtype in (("xyz", xyz, torch.float32),
                           ("intensity", intensity, torch.float32),
                           ("valid", valid, torch.bool)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, xyz on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape[:2]) != (R, C):
            raise ValueError(f"{name} must be ({R}, {C}, ...), got {tuple(t.shape)}")
    az_ptr, az_value = None, 0.0
    if isinstance(azimuthal_resolution, torch.Tensor):
        az = azimuthal_resolution
        if az.device != dev or az.dtype != torch.float32 or az.numel() != 1:
            raise ValueError("the azimuthal resolution must be one float32 on "
                             f"{dev}, got {az.dtype} {tuple(az.shape)} on {az.device}")
        az_ptr = az.data_ptr()
    else:
        az_value = float(azimuthal_resolution)

    labels = torch.empty((5, R, C), dtype=torch.bool, device=dev)
    scores = torch.empty((4, R, C), dtype=torch.float32, device=dev)
    args = _Args(
        xyz=xyz.data_ptr(), intensity=intensity.data_ptr(), valid=valid.data_ptr(),
        az=az_ptr, labels=labels.data_ptr(), scores=scores.data_ptr(),
        xyz_stride=(ctypes.c_longlong * 3)(*xyz.stride()),
        intensity_stride=_i64x2(*intensity.stride()), valid_stride=_i64x2(*valid.stride()),
        R=R, C=C, W=W, rounds=cfg.nms_rounds, blob_stride=cfg.blob_stride,
        az_value=az_value,
        angle_beam_normal=math.radians(90.0 - cfg.min_beam_surface_angle),
        min_distance=cfg.min_distance_to_sensor,
        max_sin=math.sin(math.radians(cfg.line_max_angle_deg)),
        sq_line_max_distance=cfg.line_max_distance ** 2,
        sq_dist_line_threshold=cfg.dist_to_line_threshold ** 2,
        depth_gap_threshold=cfg.edge_depth_gap_threshold ** 2,
        sin_angle_threshold=cfg.edge_sin_angle_threshold,
        saliency_threshold=cfg.edge_saliency_threshold ** 2,
        intensity_gap_threshold=cfg.edge_intensity_gap_threshold,
        plane_threshold=cfg.plane_sin_angle_threshold)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = _library().extract_launch(ctypes.byref(args), stream)
    else:
        with torch.cuda.device(dev):
            rc = _library().extract_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"extract_launch failed: cudaError {rc}")
    LAUNCHES += 1
    return labels, scores


def executions(device="cuda") -> int:
    """How often the kernel ran on `device` since the last
    `reset_executions`, counted by the kernel itself; waits for the device
    first."""
    out = ctypes.c_ulonglong(0)
    with torch.cuda.device(torch.device(device)):
        rc = _library().extract_executions(ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"extract_executions failed: cudaError {rc}")
    return int(out.value)


def reset_executions(device="cuda") -> None:
    """Set the kernel's device execution count on `device` to 0 (after
    waiting for the device)."""
    with torch.cuda.device(torch.device(device)):
        rc = _library().extract_reset_executions()
    if rc != 0:
        raise RuntimeError(f"extract_reset_executions failed: cudaError {rc}")
