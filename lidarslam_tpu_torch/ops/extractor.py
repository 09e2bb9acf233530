"""Spinning-sensor keypoint extraction as batched stencils (PyTorch port of
`lidarslam_tpu/ops/extractor.py`).

The reference's per-ring loops (SpinningSensorKeypointExtractor.cxx:118-590)
are masked, shift-based stencils over the whole (rings x firings) range
image: occlusion-border invalidation unrolled over the +-neighbor_width
window, line fits by the closed-form batched PCA, the four scores
(sin-angle, depth gap, saliency, intensity gap) for every point at once, and
the greedy sorted non-max-suppression as an iterated local-peak fixpoint run
for a fixed `nms_rounds` (ties break toward the smaller column, as the
reference's stable sort does).

Scores keep the reference's units: depth gap and saliency are squared
distances, angle scores are sines.

These stencils (`label_grids`) are the CPU path and the reference of the
CUDA path, which labels a sweep in one launch of `csrc/extract.cu`
(`ops/cuda_extract.py`) with the same results; both compact alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from lidarslam_tpu_torch.config import ExtractorConfig
from lidarslam_tpu_torch.core import pca
from lidarslam_tpu_torch.ops import cuda_extract, prims
from lidarslam_tpu_torch.ops.frame import Keypoints, RangeImage
from lidarslam_tpu_torch.utils.timer import device_mark

_NEG = -3.0e38
_POS = 3.0e38
_IMAX = 2**31 - 1


def _shift(x, d, fill=0.0):
    """out[:, c] = x[:, c - d] (d > 0 pulls from the left), filling borders."""
    if d == 0:
        return x
    C = x.shape[1]
    out = torch.full_like(x, fill)
    if abs(d) >= C:
        return out
    if d > 0:
        out[:, d:] = x[:, :C - d]
    else:
        out[:, :C + d] = x[:, -d:]
    return out


def _window_max(x, w, fill=_NEG):
    out = x
    for d in range(1, w + 1):
        out = torch.maximum(out, _shift(x, d, fill))
        out = torch.maximum(out, _shift(x, -d, fill))
    return out


def _window_min(x, w, fill=_POS):
    out = x
    for d in range(1, w + 1):
        out = torch.minimum(out, _shift(x, d, fill))
        out = torch.minimum(out, _shift(x, -d, fill))
    return out


def _dilate(mask, w):
    out = mask
    for d in range(1, w + 1):
        out = out | _shift(mask, d, False)
        out = out | _shift(mask, -d, False)
    return out


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


class ExtractionResult(NamedTuple):
    edges: Keypoints
    planes: Keypoints
    blobs: Keypoints
    # per-point score/label grids (GetDebugArray parity, SSKE.cxx:668-679),
    # with `with_debug` only
    debug: Optional[dict] = None


class LabelGrids(NamedTuple):
    """The per-point outputs of extraction, each (R, C): the three label
    masks, the point validity, the edge validity after the four edge passes
    (selected edges included) and the four scores."""
    edge: torch.Tensor
    plane: torch.Tensor
    blob: torch.Tensor
    point_valid: torch.Tensor
    edge_validity: torch.Tensor
    sin_angle: torch.Tensor
    saliency: torch.Tensor
    depth_gap: torch.Tensor
    intensity_gap: torch.Tensor


def extract_keypoints(ri: RangeImage, azimuthal_resolution: float,
                      cfg: ExtractorConfig, with_debug: bool = False) -> ExtractionResult:
    """Full extraction pipeline on one sweep; `with_debug` also returns the
    per-point score and label grids (`Slam.extract_debug`).

    A sweep on a CUDA device is labelled by one launch of the kernel in
    `csrc/extract.cu` (`ops/cuda_extract.py`), a sweep on the CPU by the
    stencils of `label_grids`; both compact the labels alike. On CUDA the
    whole stage, compaction included, sits between the marker kernels
    `slam_mark_extract_begin` / `_end` (utils/timer.device_mark)."""
    if not ri.xyz.is_cuda:
        return _result(ri, label_grids(ri, azimuthal_resolution, cfg), cfg, with_debug)
    device_mark("extract_begin", ri.xyz.device)
    labels, scores = cuda_extract.launch(ri, azimuthal_resolution, cfg)
    out = _result(ri, LabelGrids(*labels, *scores), cfg, with_debug)
    device_mark("extract_end", ri.xyz.device)
    return out


def _result(ri: RangeImage, g: LabelGrids, cfg: ExtractorConfig,
            with_debug: bool) -> ExtractionResult:
    debug = None
    if with_debug:
        debug = {
            "sin_angle": g.sin_angle,
            "saliency": g.saliency,
            "depth_gap": g.depth_gap,
            "intensity_gap": g.intensity_gap,
            "edge_keypoint": g.edge,
            "plane_keypoint": g.plane,
            "blob_keypoint": g.blob,
            "edge_validity": g.edge_validity,
            "point_validity": g.point_valid,
        }
    return ExtractionResult(
        edges=_compact(ri, g.edge, cfg.kp_capacity(0)),
        planes=_compact(ri, g.plane, cfg.kp_capacity(1)),
        blobs=_compact(ri, g.blob, cfg.kp_capacity(2)),
        debug=debug,
    )


def label_grids(ri: RangeImage, azimuthal_resolution, cfg: ExtractorConfig) -> LabelGrids:
    """The torch form of the labelling: shifted-copy stencils over the whole
    range image and the NMS fixpoint. The CPU path, and the reference the
    CUDA kernel is held to."""
    xyz, intensity, valid = ri.xyz, ri.intensity, ri.valid
    R, C = valid.shape
    W = cfg.neighbor_width
    dev = xyz.device

    col = torch.arange(C, dtype=torch.int32, device=dev)[None, :].expand(R, C)
    n_ring = torch.sum(valid, dim=1).to(torch.int32)                # packed-left lengths
    ring_ok = n_ring >= 2 * W + 1                                   # SSKE.h:119
    core = (col >= W) & (col < (n_ring[:, None] - W)) & ring_ok[:, None] & valid

    L = _norm(xyz)

    # ---------------- invalidation (SSKE.cxx:207-308) ----------------
    angle_beam_normal = math.radians(90.0 - cfg.min_beam_surface_angle)
    # a device scalar in the streaming step; a host float is filled in on
    # the device (no host->device copy)
    az = (azimuthal_resolution if isinstance(azimuthal_resolution, torch.Tensor)
          else torch.full((), azimuthal_resolution, dtype=torch.float32, device=dev))
    coeff = torch.sin(az) / torch.cos(az + angle_beam_normal)
    max_pos_diff = torch.clamp(L * coeff, min=0.02)
    sq_thr = max_pos_diff * max_pos_diff                            # per outer point

    nxt = _shift(xyz, -1)
    sq_next = torch.sum((nxt - xyz) ** 2, dim=-1)                   # pair (c, c+1)
    pair_in = valid & _shift(valid, -1, False)

    gap0 = (sq_next > sq_thr) & pair_in & core
    closer = L < _shift(L, -1, fill=_POS)
    fwd = gap0 & closer
    bwd = gap0 & ~closer

    inv = _shift(fwd, 1, False)
    ok_f = torch.ones((R, C), dtype=torch.bool, device=dev)
    for k in range(1, W):
        ok_f = ok_f & (_shift(sq_next, -k) <= sq_thr)               # pair at i+k vs thr(i)
        inv = inv | _shift(fwd & ok_f, k + 1, False)
    inv = inv | bwd
    ok_b = torch.ones((R, C), dtype=torch.bool, device=dev)
    for k in range(1, W):
        ok_b = ok_b & (_shift(sq_next, k) <= sq_thr)                # pair at i-k vs thr(i)
        inv = inv | _shift(bwd & ok_b, -k, False)

    too_close = L < cfg.min_distance_to_sensor
    point_valid = core & ~too_close & ~inv

    # ---------------- curvature scores (SSKE.cxx:311-471) ----------------
    left = torch.stack([_shift(xyz, d) for d in range(1, W + 1)], dim=2)    # (R,C,W,3) near->far
    right = torch.stack([_shift(xyz, -d) for d in range(1, W + 1)], dim=2)

    max_sin = math.sin(math.radians(cfg.line_max_angle_deg))
    sq_line_max_dist = cfg.line_max_distance ** 2

    def unit(v):
        return v / torch.clamp(_norm(v)[..., None], min=1e-12)

    def side_fit(nbrs):
        # consistency: chord vs consecutive segments (SSKE.cxx:87-108)
        chord = unit(nbrs[..., W - 1, :] - nbrs[..., 0, :])
        consistent = torch.ones((R, C), dtype=torch.bool, device=dev)
        for k in range(W - 1):
            seg = unit(nbrs[..., k + 1, :] - nbrs[..., k, :])
            sin_a = _norm(torch.linalg.cross(chord, seg))
            consistent = consistent & (sin_a <= max_sin)
        pos, direction, _, _ = pca.line_fit(
            nbrs, torch.ones(nbrs.shape[:-1], dtype=torch.bool, device=dev))
        d2 = pca.sq_dist_to_line(nbrs, pos[..., None, :], direction[..., None, :])
        accurate = torch.amax(d2, dim=-1) <= sq_line_max_dist
        return pos, direction, consistent & accurate

    lpos, ldir, lflat = side_fit(left)
    rpos, rdir, rflat = side_fit(right)

    dl_pt = pca.sq_dist_to_line(xyz, lpos, ldir)
    dr_pt = pca.sq_dist_to_line(xyz, rpos, rdir)

    sq_dist_line_thr = cfg.dist_to_line_threshold ** 2
    both = lflat & rflat
    angle_ok = both & (dl_pt < sq_dist_line_thr) & (dr_pt < sq_dist_line_thr)
    sin_angle = torch.where(angle_ok, _norm(torch.linalg.cross(ldir, rdir)), 0.0)

    # mixed cases: min distance of the non-flat side's neighbors to the flat line, x0.25
    d_left_to_rline = pca.sq_dist_to_line(left, rpos[..., None, :], rdir[..., None, :])
    d_right_to_lline = pca.sq_dist_to_line(right, lpos[..., None, :], ldir[..., None, :])
    dist_left = torch.where(~lflat & rflat, 0.25 * torch.amin(d_left_to_rline, dim=-1),
                            torch.where(both, dl_pt, 0.0))
    dist_right = torch.where(lflat & ~rflat, 0.25 * torch.amin(d_right_to_lline, dim=-1),
                             torch.where(both, dr_pt, 0.0))
    depth_gap = torch.maximum(dist_left, dist_right)

    # saliency (neither side flat): consecutive far-neighbor run (SSKE.cxx:419-464)
    sq_depth = L * L
    min_depth_gap = 1.5  # [m^2 quirk kept from SSKE.cxx:315]

    def far_run(nbrs):
        far = torch.abs(torch.sum(nbrs * nbrs, dim=-1) - sq_depth[..., None]) > min_depth_gap
        flag = torch.zeros((R, C), dtype=torch.bool, device=dev)
        stopped = torch.zeros((R, C), dtype=torch.bool, device=dev)
        incl = []
        for k in range(W):
            fk = far[..., k]
            incl.append(fk & ~stopped)
            stopped = stopped | (flag & ~fk)
            flag = flag | fk
        return torch.stack(incl, dim=-1)

    far_mask = torch.cat([far_run(left), far_run(right)], dim=-1)   # (R,C,2W)
    far_pts = torch.cat([left, right], dim=-2)
    fpos, fdir, _, fcount = pca.line_fit(far_pts, far_mask)
    sal_ok = ~lflat & ~rflat & (fcount > W)
    saliency = torch.where(sal_ok, pca.sq_dist_to_line(xyz, fpos, fdir), 0.0)

    intensity_gap = torch.abs(_shift(intensity, -1) - _shift(intensity, 1))

    # zero scores for skipped (invalid) points (SSKE.cxx:336-339)
    sin_angle = torch.where(point_valid, sin_angle, 0.0)
    depth_gap = torch.where(point_valid, depth_gap, 0.0)
    saliency = torch.where(point_valid, saliency, 0.0)
    intensity_gap = torch.where(point_valid, intensity_gap, 0.0)

    # ---------------- labeling (SSKE.cxx:474-573) ----------------
    valid_edge = point_valid
    label_edge = torch.zeros((R, C), dtype=torch.bool, device=dev)
    criteria = (
        (depth_gap, cfg.edge_depth_gap_threshold ** 2, W - 1),
        (sin_angle, cfg.edge_sin_angle_threshold, W),
        (saliency, cfg.edge_saliency_threshold ** 2, W - 1),
        (intensity_gap, cfg.edge_intensity_gap_threshold, 1),
    )
    for score, thr, w in criteria:
        sel, valid_edge = _nms(score, valid_edge & (score >= thr), w, cfg.nms_rounds,
                               col, valid_edge, maximize=True)
        label_edge = label_edge | sel

    cand_plane = point_valid & (sin_angle <= cfg.plane_sin_angle_threshold) & (sin_angle >= 1e-6)
    label_plane, _ = _nms(sin_angle, cand_plane, 4, cfg.nms_rounds, col, point_valid,
                          maximize=False)

    label_blob = point_valid & (col % cfg.blob_stride == 0)
    return LabelGrids(edge=label_edge, plane=label_plane, blob=label_blob,
                      point_valid=point_valid, edge_validity=valid_edge | label_edge,
                      sin_angle=sin_angle, saliency=saliency, depth_gap=depth_gap,
                      intensity_gap=intensity_gap)


def _nms(score, cand, w, rounds, col, persistent_valid, maximize):
    """Iterated local-peak fixpoint == greedy sorted NMS (SSKE.cxx:499-563).

    Each round selects every candidate that dominates its +-w window (ties
    broken toward the smaller column), then suppresses +-w neighborhoods.
    Returns (selected, persistent_valid after suppression)."""
    sgn = 1.0 if maximize else -1.0
    selected = torch.zeros_like(cand)
    for _ in range(rounds):
        s = torch.where(cand, sgn * score, _NEG)
        m = _window_max(s, w)
        is_max = cand & (s >= m) & (s > _NEG)
        c_sel = torch.where(is_max, col, _IMAX)
        c_min = _window_min(c_sel, w, fill=_IMAX)
        peak = is_max & (col <= c_min)
        selected = selected | peak
        cand = cand & ~_dilate(peak, w)
    return selected, persistent_valid & ~_dilate(selected, w)


def _compact(ri: RangeImage, mask, capacity: int) -> Keypoints:
    """Flatten a (R, C) label mask into a fixed-capacity Keypoints set in
    ring-major order (keypoint push order, SSKE.cxx:575-589). Beyond
    capacity the selection thins evenly over the sweep
    (prims.spread_k_indices)."""
    R, C = mask.shape
    idx, count = prims.spread_k_indices(mask, capacity)
    n = torch.clamp(count, max=capacity)
    slot_valid = torch.arange(capacity, dtype=torch.int32, device=mask.device) < n
    li = idx.to(torch.int64)
    return Keypoints(
        xyz=ri.xyz.reshape(-1, 3)[li],
        intensity=ri.intensity.reshape(-1)[li],
        time=ri.time.reshape(-1)[li],
        ring=torch.div(idx, C, rounding_mode="floor").to(torch.int32),
        valid=slot_valid,
        count=n.to(torch.int32),
    )
