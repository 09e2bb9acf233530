"""Rolling voxel-grid local map + exact k-NN (PyTorch port of
`lidarslam_tpu/ops/voxel_map.py`).

The map is a set of <= capacity point slots, at most one per leaf cell,
holding point, intensity, time stamp, frames-per-voxel count and fixed
flag (RollingGrid.cxx:117-442 semantics):

- **Insert** (`add_points`): map slots and the leaf-reduced batch are
  lexicographically sorted by (leaf key, sampling priority); each leaf's
  first entry wins. `torch.sort` is stable on one key only, so the JAX
  package's 3-key stable sort is an LSD chain of stable sorts (priority,
  then kyz, then kx) carrying one permutation that gathers the payload.
  Compaction is a stable sort on the drop flag, which keeps the kept slots
  in leaf-key order — the k-NN kernel's block pruning relies on that.
  CENTROID keeps the old point of a leaf and blends the batch's run mean
  into it; CENTER_POINT keeps the point nearest the leaf center.
- **Roll**: shift the window by whole outer voxels; coordinates stay
  origin-relative float32 (the host tracks the float64 origin).
- **Decay** (`clear_old_points`): removable points older than
  `decaying_threshold` leave the map.
- **Submap**: a masked view over the map slots (bbox + moving-object filter).
- **k-NN**: `brute_knn` goes through `cuda_knn.knn` (kernel on CUDA,
  chunked exact scan on CPU).

Every branch the JAX package takes under `lax.cond` on device (eviction
at capacity) is computed and `where`-selected here, so no host sync
decides it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from lidarslam_tpu_torch.config import MapConfig, SamplingMode
from lidarslam_tpu_torch.ops import cuda_knn

_BIGKEY = 2**31 - 1


class VoxelMap(NamedTuple):
    """Device state of one rolling map (coordinates are origin-relative)."""

    xyz: torch.Tensor        # (M, 3) f32
    intensity: torch.Tensor  # (M,) f32
    time: torch.Tensor       # (M,) f32 — absolute stamp of last touch
    count: torch.Tensor      # (M,) i32 — frames-per-voxel counter
    fixed: torch.Tensor      # (M,) bool — immutable map points
    valid: torch.Tensor      # (M,) bool
    overflow: torch.Tensor   # () i32 — cumulative leaves dropped at capacity

    @property
    def n_points(self):
        return torch.sum(self.valid)

    @classmethod
    def empty(cls, cfg: MapConfig, device):
        m = cfg.capacity
        return cls(
            xyz=torch.zeros((m, 3), dtype=torch.float32, device=device),
            intensity=torch.zeros((m,), dtype=torch.float32, device=device),
            time=torch.zeros((m,), dtype=torch.float32, device=device),
            count=torch.zeros((m,), dtype=torch.int32, device=device),
            fixed=torch.zeros((m,), dtype=torch.bool, device=device),
            valid=torch.zeros((m,), dtype=torch.bool, device=device),
            overflow=torch.zeros((), dtype=torch.int32, device=device),
        )


def effective_resolution(cfg: MapConfig) -> float:
    """Outer voxel edge, snapped to a whole number of leaves."""
    return int(cfg.voxel_resolution / cfg.leaf_size) * cfg.leaf_size


def half_extent(cfg: MapConfig) -> float:
    return cfg.grid_size / 2.0 * effective_resolution(cfg)


def device_f32(x, device):
    """A float32 tensor of `x` on `device`: a tensor is converted in place
    on its device, a host number filled in on the device (no host->device
    copy, so it is safe inside a captured CUDA graph)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _leaf_keys(xyz, valid, cfg: MapConfig):
    """Two-part lexicographic leaf key (kx, kyz); invalid/out-of-window
    points get (BIG, BIG)."""
    half = half_extent(cfg)
    inv_leaf = 1.0 / cfg.leaf_size
    li = torch.floor((xyz + half) * inv_leaf).to(torch.int32)
    n_leaf = int(math.ceil(2.0 * half / cfg.leaf_size)) + 1
    inb = valid & torch.all((li >= 0) & (li < n_leaf), dim=-1)
    kx = torch.where(inb, li[..., 0], _BIGKEY)
    kyz = torch.where(inb, li[..., 1] * n_leaf + li[..., 2], _BIGKEY)
    return kx, kyz, inb


def _stable_lexsort(keys):
    """Permutation sorting by `keys` lexicographically (most significant
    first), stable: an LSD chain of stable single-key sorts."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        p = torch.sort(k, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm


def _sampling_prio(xyz, inten, order, mode, cfg: MapConfig):
    """Winner priority per sampling mode (ascending: smaller wins).
    CENTER_POINT measures from the leaf center with the JAX package's
    floor((xyz + half) / leaf) — a division, not `_leaf_keys`' product by
    the inverse, whose different rounding would flip ties."""
    if mode in (SamplingMode.FIRST, SamplingMode.CENTROID):
        return order
    if mode == SamplingMode.LAST:
        return -order
    if mode == SamplingMode.MAX_INTENSITY:
        return -inten
    half = half_extent(cfg)
    li = torch.floor((xyz + half) / cfg.leaf_size)
    d = xyz - _fma(li + 0.5, cfg.leaf_size, -half)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.sqrt(_fma(z, z, _fma(y, y, x * x)))


def _fma(a, b, c):
    """a * b + c in float32 rounded once, as XLA:CPU contracts the JAX
    package's center and norm: a product of two float32 is exact in
    float64, so only the sum rounds (twice, which differs from one
    rounding with odds of ~2^-28). Equal distances then rank as there.
    Python numbers stand for their float32 values."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else float(np.float32(v))
    return (f64(a) * f64(b) + f64(c)).float()


def rev_segment_scan(seg, xs):
    """Suffix sums within equal-`seg` runs (runs contiguous): out[i] = sum of
    x[i..e) where e is the end of i's run, so a run's first element holds
    the run's total. The JAX package's Hillis-Steele doubling scan
    (`prims.rev_segment_scan` with add), kept for its summation order: the
    CENTROID means are then bit-equal to JAX's, which neither a cumsum
    difference (it cancels at map coordinates) nor `index_add_` (atomics
    on CUDA, an order that varies from run to run) would give."""
    n = seg.shape[0]
    out = list(xs)
    s = 1
    while s < n:
        pad = torch.full((s,), -1, dtype=seg.dtype, device=seg.device)
        same = torch.cat([seg[s:], pad]) == seg
        out = [torch.where(same, x + torch.cat([x[s:], torch.zeros_like(x[:s])]), x)
               for x in out]
        s *= 2
    return out


def _reduce_batch(new_xyz, new_intensity, new_valid, cfg: MapConfig):
    """Per-leaf reduction of the incoming batch alone: one winner per leaf
    by `cfg.sampling` (CENTROID: the winner's coordinates become the run's
    mean, weighted downstream as one sample); losers' keys become BIGKEY."""
    K = new_xyz.shape[0]
    mode = cfg.sampling
    xyz = new_xyz.to(torch.float32)
    inten = new_intensity.to(torch.float32)
    kx, kyz, _ = _leaf_keys(xyz, new_valid, cfg)
    order = torch.arange(K, dtype=torch.float32, device=xyz.device)
    prio = _sampling_prio(xyz, inten, order, mode, cfg)
    perm = _stable_lexsort((kx, kyz, prio))
    skx, skyz = kx[perm], kyz[perm]
    sxyz, sint = xyz[perm], inten[perm]
    key_ok = skx != _BIGKEY
    big = torch.full((1,), _BIGKEY, dtype=torch.int32, device=xyz.device)
    prv_kx = torch.cat([big, skx[:-1]])
    prv_kyz = torch.cat([big, skyz[:-1]])
    first = key_ok & ~((skx == prv_kx) & (skyz == prv_kyz))
    sx, sy, sz = sxyz[:, 0], sxyz[:, 1], sxyz[:, 2]
    if mode == SamplingMode.CENTROID:
        seg = torch.where(key_ok, torch.cumsum(first.to(torch.int32), 0) - 1, K)
        okf = key_ok.to(torch.float32)
        sums = rev_segment_scan(seg, [sx * okf, sy * okf, sz * okf, okf])
        n = torch.clamp(sums[3], min=1.0)
        sx, sy, sz = sums[0] / n, sums[1] / n, sums[2] / n
    wkx = torch.where(first, skx, _BIGKEY)
    wkyz = torch.where(first, skyz, _BIGKEY)
    return wkx, wkyz, sx, sy, sz, sint


def add_points(vmap_: VoxelMap, new_xyz, new_intensity, new_time, new_valid,
               current_time, cfg: MapConfig, fixed: bool = False) -> VoxelMap:
    """Merge a batch of points into the map (RollingGrid::Add semantics).

    One point per leaf survives, selected by `cfg.sampling`; fixed leaves are
    never modified; each leaf touched by >=1 new point gets its
    frames-per-voxel count bumped once and its stamp set to `current_time`.
    At capacity the winners farthest from the window center are evicted
    (never fixed points)."""
    dev = vmap_.xyz.device
    M = vmap_.xyz.shape[0]
    K = new_xyz.shape[0]
    N = M + K
    mode = cfg.sampling

    bkx, bkyz, bx, by, bz, bint = _reduce_batch(new_xyz, new_intensity, new_valid, cfg)

    mkx, mkyz, _ = _leaf_keys(vmap_.xyz, vmap_.valid, cfg)
    kx = torch.cat([mkx, bkx])
    kyz = torch.cat([mkyz, bkyz])
    x = torch.cat([vmap_.xyz[:, 0], bx])
    y = torch.cat([vmap_.xyz[:, 1], by])
    z = torch.cat([vmap_.xyz[:, 2], bz])
    inten = torch.cat([vmap_.intensity, bint])
    tim = torch.cat([vmap_.time, device_f32(new_time, dev).expand(K)])
    cnt = torch.cat([vmap_.count, torch.zeros((K,), dtype=torch.int32, device=dev)])
    fix = torch.cat([vmap_.fixed, torch.full((K,), bool(fixed), device=dev)]).to(torch.int32)
    is_new = (torch.arange(N, device=dev) >= M).to(torch.int32)

    if mode in (SamplingMode.FIRST, SamplingMode.CENTROID):
        prio = is_new.to(torch.float32)          # old wins
    elif mode == SamplingMode.LAST:
        prio = -is_new.to(torch.float32)         # new wins
    else:
        prio = _sampling_prio(torch.stack([x, y, z], dim=-1), inten, None, mode, cfg)
    # existing fixed points always win their leaf (RollingGrid.cxx:218-219)
    prio = torch.where((fix == 1) & (is_new == 0), float("-inf"), prio)

    perm = _stable_lexsort((kx, kyz, prio))
    skx, skyz = kx[perm], kyz[perm]
    sx, sy, sz = x[perm], y[perm], z[perm]
    sint, stim, scnt = inten[perm], tim[perm], cnt[perm]
    sfix, snew = fix[perm], is_new[perm]

    key_ok = skx != _BIGKEY
    big = torch.full((1,), _BIGKEY, dtype=torch.int32, device=dev)
    prv_kx = torch.cat([big, skx[:-1]])
    prv_kyz = torch.cat([big, skyz[:-1]])
    winner = key_ok & ~((skx == prv_kx) & (skyz == prv_kyz))

    # pair combine: runs have length <= 2 (both sources are leaf-unique),
    # so each winner's only possible loser is its immediate successor
    def nxt(a, fill):
        return torch.cat([a[1:], torch.full((1,), fill, dtype=a.dtype, device=dev)])

    nxt_same = key_ok & (nxt(skx, _BIGKEY) == skx) & (nxt(skyz, _BIGKEY) == skyz)
    l_new = nxt_same & (nxt(snew, 0) == 1)
    l_old = nxt_same & (nxt(snew, 0) == 0)
    any_new = (snew == 1) | l_new
    old_cnt = torch.maximum(torch.where(snew == 0, scnt, 0),
                            torch.where(l_old, nxt(scnt, 0), 0))
    has_fixed_old = ((sfix == 1) & (snew == 0)) | (l_old & (nxt(sfix, 0) == 1))
    touched = winner & any_new & ~has_fixed_old

    if mode == SamplingMode.CENTROID:
        # the winner is the old point where there is one (old wins); its
        # loser carries the batch's run mean, weighted as one sample
        c = scnt.to(torch.float32)
        blend = touched & (snew == 0) & l_new
        sx = torch.where(blend, (sx * c + nxt(sx, 0.0)) / (c + 1.0), sx)
        sy = torch.where(blend, (sy * c + nxt(sy, 0.0)) / (c + 1.0), sy)
        sz = torch.where(blend, (sz * c + nxt(sz, 0.0)) / (c + 1.0), sz)

    cur_t = device_f32(current_time, dev)
    out_time = torch.where(touched, cur_t, stim)
    out_fix = torch.where(touched, int(fixed), sfix)
    out_cnt = torch.where(touched, old_cnt + 1, scnt)

    # --- compact winners into the first M slots. At capacity, evict the
    # winners FARTHEST from the window center (never fixed points). The
    # eviction ranking is always computed and selected by `where`.
    n_winners = torch.sum(winner, dtype=torch.int32)
    d2 = sx * sx + sy * sy + sz * sz
    eprio = torch.where(out_fix == 1, float("-inf"), d2)
    eprio = torch.where(winner, eprio, float("inf"))
    sidx = torch.sort(eprio, stable=True).indices
    over = (torch.arange(N, device=dev) >= M) & winner[sidx]
    ranked_over = torch.zeros(N, dtype=torch.bool, device=dev)
    ranked_over[sidx] = over
    evict = ranked_over & (n_winners > M)
    drop = ((~winner) | evict).to(torch.int32)
    keep = torch.sort(drop, stable=True).indices[:M]

    n_keep = torch.clamp(n_winners, max=M)
    slot_ok = torch.arange(M, dtype=torch.int32, device=dev) < n_keep
    dropped = torch.clamp(n_winners - M, min=0)
    return VoxelMap(
        xyz=torch.stack([sx[keep], sy[keep], sz[keep]], dim=-1),
        intensity=sint[keep],
        time=out_time[keep],
        count=out_cnt[keep],
        fixed=out_fix[keep].to(torch.bool),
        valid=slot_ok,
        overflow=vmap_.overflow + dropped,
    )


def clear_old_points(vmap_: VoxelMap, current_time, cfg: MapConfig) -> VoxelMap:
    """Drop the removable points older than `cfg.decaying_threshold`
    (RollingGrid::ClearOldPoints); fixed points stay."""
    age = device_f32(current_time, vmap_.time.device) - vmap_.time
    keep = vmap_.valid & (vmap_.fixed | (age <= cfg.decaying_threshold))
    return vmap_._replace(valid=keep)


def compute_roll_offset(bbox_min, bbox_max, cfg: MapConfig):
    """Whole-voxel window shift needed to fit [bbox_min, bbox_max]."""
    res = effective_resolution(cfg)
    half = half_extent(cfg)
    down = bbox_min - (-half)
    up = bbox_max - half
    offset = (up + down) / 2.0
    offset = torch.minimum(torch.maximum(offset, torch.clamp(down, max=0.0)),
                           torch.clamp(up, min=0.0))
    return torch.round(offset / res).to(torch.int32)


def roll_by_offset(vmap_: VoxelMap, vox_offset, cfg: MapConfig) -> VoxelMap:
    """Apply a precomputed whole-voxel window shift."""
    res = effective_resolution(cfg)
    half = half_extent(cfg)
    vi = torch.floor((vmap_.xyz + half) / res).to(torch.int32)
    vi_new = vi - vox_offset
    keep = vmap_.valid & torch.all((vi_new >= 0) & (vi_new < cfg.grid_size), dim=-1)
    new_xyz = vmap_.xyz - vox_offset.to(torch.float32) * res
    return vmap_._replace(xyz=new_xyz, valid=keep)


# -----------------------------------------------------------------------------
#   Submap view + exact k-NN
# -----------------------------------------------------------------------------

class SubmapView(NamedTuple):
    """A masked view over the map's point slots for exact neighbor search."""

    xyz: torch.Tensor     # (M, 3) f32
    ring: torch.Tensor    # (M,) i32
    valid: torch.Tensor   # (M,) bool


def prepare_knn_index(view: SubmapView) -> Optional[cuda_knn.KnnIndex]:
    """The kernel's map-side inputs for a CUDA view (None on the CPU, where
    the plain scan needs none). Build it once per submap rebuild, not in the
    ICP loop."""
    if not view.xyz.is_cuda:
        return None
    return cuda_knn.prepare_map(view.xyz, view.valid)


def brute_knn(view: SubmapView, queries, k: int,
              prune_radius: Optional[float] = None, q_valid=None,
              prepared: Optional[cuda_knn.KnnIndex] = None):
    """k nearest valid slots of the view per query: (sq_dists (Q, k)
    ascending with +inf for missing, rows (Q, k), neighbour coordinates
    (Q, k, 3), 0 where missing). CUDA queries run the kernel (sub-blocks
    beyond `prune_radius` skipped), CPU queries the exact scan."""
    return cuda_knn.knn(view.xyz, view.valid, queries, k,
                        prune_radius=prune_radius, q_valid=q_valid,
                        prepared=prepared)


def extract_submap_view(vmap_: VoxelMap, bbox_min, bbox_max, min_nb_points,
                        cfg: MapConfig) -> SubmapView:
    """Submap selection (bbox + moving-object filter with fallback,
    BuildSubMapKdTree 362-442 semantics) as a masked view."""
    res = effective_resolution(cfg)
    half = half_extent(cfg)
    lo = torch.clamp(torch.floor((bbox_min + half) / res), min=0.0)
    hi = torch.clamp(torch.floor((bbox_max + half) / res), max=float(cfg.grid_size - 1))
    vi = torch.floor((vmap_.xyz + half) / res)
    in_bbox = vmap_.valid & torch.all((vi >= lo) & (vi <= hi), dim=-1)
    if cfg.min_frames_per_voxel > 1:
        still = vmap_.count >= cfg.min_frames_per_voxel
        clean = in_bbox & (still | vmap_.fixed)
        n_clean = torch.sum(clean)
        use_all = (min_nb_points < 0) | (n_clean < min_nb_points)
        selected = torch.where(use_all, in_bbox, clean)
    else:
        selected = in_bbox
    return SubmapView(xyz=vmap_.xyz,
                      ring=torch.zeros(vmap_.xyz.shape[0], dtype=torch.int32,
                                       device=vmap_.xyz.device),
                      valid=selected)


def gather_valid_points(vmap_: VoxelMap, clean: bool, cfg: MapConfig):
    """Host-side extraction of stored points (RollingGrid::Get 95-114).
    Returns numpy (n, 3) xyz plus (intensity, time, fixed) arrays."""
    valid = vmap_.valid.cpu().numpy()
    if clean and cfg.min_frames_per_voxel > 1:
        valid = valid & ((vmap_.count.cpu().numpy() >= cfg.min_frames_per_voxel)
                         | vmap_.fixed.cpu().numpy())
    return (vmap_.xyz.cpu().numpy()[valid], vmap_.intensity.cpu().numpy()[valid],
            vmap_.time.cpu().numpy()[valid], vmap_.fixed.cpu().numpy()[valid])
