"""Map-block sharding: the rolling voxel map distributed over the ranks
(PyTorch port of `lidarslam_tpu/parallel/sharded_map.py`).

The map's fixed-capacity point slots shard over the mesh, so both map
memory and the map-side hot loops scale with the number of ranks:

- **Ownership** is by contiguous leaf-key ranges: the leaf grid's x axis
  splits into `n` equal slabs and rank d owns every leaf whose kx falls in
  slab d. Each rank's slab (capacity / n slots) stays sorted by (kx, kyz),
  so the concatenation of the slabs in rank order IS the globally
  key-sorted map: the JAX package's global slab-sharded `VoxelMap`.
- **Insert** (`shard_add_points`): the sweep's keypoints are replicated;
  each rank masks the subset in its slab and runs the normal sort-merge
  insert on its slots. No communication.
- **Query** (`shard_knn`): each rank scans all queries against its slab
  (the k-NN kernel, K1, on the card), the per-rank top-k candidates are
  `all_gather`ed and a stable sort keeps the k nearest: the exact global
  k-NN, with the coordinates travelling beside the distances.
- **Roll** (`shard_roll`): every rank rebases its slab, then points whose
  new kx leaves the slab migrate to the neighbouring rank over
  `ppermute` rings, one slab per hop: by default until no rank holds a
  stray (a host loop over the summed stray count; under CUDA-graph
  capture a loop of fixed length that selects on the device), or a fixed
  `max_hops` with the leftovers counted into `overflow`. Migrants keep
  their count, fixed flag and stamp.

The local functions take this rank's slab and a `sharded.Mesh`; the
per-rank forms of the JAX package's global API (`add_points_sharded`,
`roll_sharded`, `knn_sharded`) keep `overflow` as the global total. The
state crosses between the two layouts with `reshard_host` (repack a
global map into slab order), `local_slab` (a rank's slab of a global map,
e.g. `np.asarray` of a JAX sharded map or a checkpoint) and `gather_slabs`
(the global map back from every rank's slab).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lidarslam_tpu_torch.config import MapConfig
from lidarslam_tpu_torch.ops import voxel_map
from lidarslam_tpu_torch.ops.voxel_map import _BIGKEY, SubmapView, VoxelMap, _leaf_keys


def n_leaves(cfg: MapConfig) -> int:
    """Leaf-grid extent per axis (matches `_leaf_keys`)."""
    half = voxel_map.half_extent(cfg)
    return int(math.ceil(2.0 * half / cfg.leaf_size)) + 1


def slab_width(cfg: MapConfig, n_shards: int) -> int:
    return -(-n_leaves(cfg) // n_shards)   # ceil div


def local_kx_range(cfg: MapConfig, rank: int, n_shards: int):
    """[lo, hi) leaf-x ownership range of `rank`."""
    w = slab_width(cfg, n_shards)
    return rank * w, rank * w + w


def owner_of(kx, cfg: MapConfig, n_shards: int):
    """Owning rank of each leaf-x index (the tail slab takes the rest)."""
    w = slab_width(cfg, n_shards)
    if isinstance(kx, torch.Tensor):
        return torch.clamp(torch.div(kx, w, rounding_mode="floor"), 0, n_shards - 1)
    return np.clip(np.asarray(kx) // w, 0, n_shards - 1)


def shard_add_points(local: VoxelMap, new_xyz, new_intensity, new_time, new_valid,
                     current_time, cfg: MapConfig, fixed: bool, mesh) -> VoxelMap:
    """RollingGrid::Add over the sharded map: mask the (replicated) batch
    to this rank's slab, then the normal sort-merge insert."""
    kx, _, inb = _leaf_keys(new_xyz, new_valid, cfg)
    lo, hi = local_kx_range(cfg, mesh.rank, mesh.size)
    mine = inb & (kx >= lo) & (kx < hi)
    return voxel_map.add_points(local, new_xyz, new_intensity, new_time, mine, current_time,
                                cfg, fixed=fixed)


def shard_knn(view: SubmapView, queries, k: int, mesh, prepared=None):
    """Exact global k-NN over the sharded map.

    Each rank scans its slab for all Q queries (`brute_knn`: K1 on the
    card, unpruned, as the JAX package scans); the per-rank winners
    (distance, coordinates, ring) are gathered in one `all_gather` and a
    stable sort over the n*k candidates keeps the k nearest, ties to the
    lower rank as `lax.top_k` keeps them. Returns (d2 (Q, k) ascending,
    +inf where missing; nbr_xyz (Q, k, 3), 0 where missing; nbr_ring (Q, k))."""
    d2, rows, nbr = voxel_map.brute_knn(view, queries, k, prepared=prepared)
    ring = torch.zeros_like(rows) if view.ring is None else view.ring[rows.long()]
    Q = d2.shape[0]
    # one gather: (Q, k, 5) of float32 bits [d2, x, y, z, ring]
    cand = torch.cat([d2[..., None], nbr, ring.to(torch.int32).view(torch.float32)[..., None]],
                     dim=-1)
    allc = mesh.all_gather(cand)                         # (n, Q, k, 5)
    flat = allc.permute(1, 0, 2, 3).reshape(Q, mesh.size * k, 5)
    sel = torch.sort(flat[..., 0], dim=1, stable=True).indices[:, :k]
    best = torch.gather(flat, 1, sel[..., None].expand(Q, k, 5))
    return (best[..., 0].contiguous(), best[..., 1:4].contiguous(),
            best[..., 4].contiguous().view(torch.int32))


def _compact_merge(local: VoxelMap, imm: VoxelMap, cfg: MapConfig) -> VoxelMap:
    """Merge immigrant points into the slab with every attribute kept (no
    count bump, no stamp: migration is not observation). A leaf lives on
    one rank, so keys cannot collide across slabs; a collision would keep
    the resident. Sorted by (kx, kyz, resident-first, row): the JAX
    package's 4-key order, slot for slot."""
    M = local.xyz.shape[0]
    dev = local.xyz.device
    xyz = torch.cat([local.xyz, imm.xyz])
    inten = torch.cat([local.intensity, imm.intensity])
    tim = torch.cat([local.time, imm.time])
    cnt = torch.cat([local.count, imm.count])
    fix = torch.cat([local.fixed, imm.fixed])
    val = torch.cat([local.valid, imm.valid])
    prio = torch.cat([torch.zeros(M, dtype=torch.int32, device=dev),
                      torch.ones(imm.xyz.shape[0], dtype=torch.int32, device=dev)])
    kx, kyz, _ = _leaf_keys(xyz, val, cfg)
    # the row is the last key: a stable sort on the other three
    srow = voxel_map._stable_lexsort((kx, kyz, prio))
    skx, skyz = kx[srow], kyz[srow]
    key_ok = skx != _BIGKEY
    first = key_ok & ~((skx == torch.roll(skx, 1)) & (skyz == torch.roll(skyz, 1)))
    first[0] = key_ok[0]
    crow = torch.sort((~first).to(torch.int32), stable=True).indices[:M]
    take = srow[crow]
    dropped = torch.clamp(torch.sum(first, dtype=torch.int32) - M, min=0)
    return VoxelMap(xyz=xyz[take], intensity=inten[take], time=tim[take], count=cnt[take],
                    fixed=fix[take], valid=first[crow],
                    overflow=local.overflow + imm.overflow + dropped)


def _pack(m: VoxelMap) -> torch.Tensor:
    """A slab's slots as one (M, 8) int32 tensor of their bits: one ring
    message per hop instead of six."""
    f = torch.cat([m.xyz, m.intensity[:, None], m.time[:, None]], dim=1)
    return torch.cat([f.view(torch.int32), m.count[:, None].to(torch.int32),
                      m.fixed[:, None].to(torch.int32), m.valid[:, None].to(torch.int32)],
                     dim=1)


def _unpack(p: torch.Tensor) -> VoxelMap:
    f = p[:, :5].contiguous().view(torch.float32)
    return VoxelMap(xyz=f[:, :3].contiguous(), intensity=f[:, 3].contiguous(),
                    time=f[:, 4].contiguous(), count=p[:, 5].contiguous(),
                    fixed=p[:, 6] != 0, valid=p[:, 7] != 0,
                    overflow=torch.zeros((), dtype=torch.int32, device=p.device))


def _emigrants(local: VoxelMap, cfg: MapConfig, mesh):
    kx, _, _ = _leaf_keys(local.xyz, local.valid, cfg)
    lo, hi = local_kx_range(cfg, mesh.rank, mesh.size)
    return local.valid & (kx < lo), local.valid & (kx >= hi)


def _hop(local: VoxelMap, cfg: MapConfig, mesh) -> VoxelMap:
    """One migration hop: this slab's emigrants below its range go one rank
    down, those above one rank up (each ring merged before the next, the
    masks taken before either, as in the JAX package). A ring step that
    wraps from slab 0 to slab n-1 (or back) can only carry points outside
    the window; `_leaf_keys` re-checks the window, so they land invalid."""
    out_lo, out_hi = _emigrants(local, cfg, mesh)
    local = local._replace(valid=local.valid & ~out_lo & ~out_hi)
    for mask, shift in ((out_lo, -1), (out_hi, +1)):
        em = local._replace(valid=mask)
        imm = _unpack(mesh.ppermute(_pack(em), shift))
        local = _compact_merge(local, imm, cfg)
    return local


def _n_stray(local: VoxelMap, cfg: MapConfig, mesh) -> torch.Tensor:
    """Strays on all ranks (an int32 device scalar), summed before anyone
    tests it, so every rank takes the same number of hops."""
    lo_m, hi_m = _emigrants(local, cfg, mesh)
    return mesh.psum(torch.sum(lo_m | hi_m, dtype=torch.int32))


def shard_roll(local: VoxelMap, vox_offset, cfg: MapConfig, mesh, max_hops=None) -> VoxelMap:
    """RollingGrid::Roll over the sharded map: rebase locally, then migrate
    slab-crossing points over the rings.

    `max_hops=None`: hops repeat while any rank holds a stray, at most n
    times (each hop moves every stray one slab toward its owner), so any
    roll is exact. Under CUDA-graph capture the loop reads nothing on the
    host (`_hops_sync_free`); everywhere else it reads the summed stray
    count after each hop and stops (`_hops_host`), which skips the hops
    when nothing migrates (on an H100, 1.8 against 19.2 ms a roll on gloo
    x2, 0.7 against 3.7 on NCCL x1: scripts/time_torch_mesh_roll.py). The
    two agree slot for slot. An int `max_hops` runs exactly that many hops
    and drops the leftovers into `overflow` (bounded latency)."""
    local = voxel_map.roll_by_offset(local, vox_offset, cfg)
    if max_hops is None:
        hops = _hops_sync_free if _capturing(local.valid) else _hops_host
        return hops(local, cfg, mesh)
    for _ in range(max_hops):
        local = _hop(local, cfg, mesh)
    lo_m, hi_m = _emigrants(local, cfg, mesh)
    stray = lo_m | hi_m
    return local._replace(valid=local.valid & ~stray,
                          overflow=local.overflow + torch.sum(stray, dtype=torch.int32))


def _capturing(t: torch.Tensor) -> bool:
    """Whether `t`'s CUDA stream is capturing a graph (a CPU tensor's never
    is; a torch built without CUDA raises on the question)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _hops_host(local: VoxelMap, cfg: MapConfig, mesh) -> VoxelMap:
    """The adaptive hops with a host read of the summed stray count before
    each."""
    stray, hops = int(_n_stray(local, cfg, mesh)), 0
    while stray > 0 and hops < mesh.size:
        local = _hop(local, cfg, mesh)
        stray, hops = int(_n_stray(local, cfg, mesh)), hops + 1
    return local


def _hops_sync_free(local: VoxelMap, cfg: MapConfig, mesh) -> VoxelMap:
    """The adaptive hops with no host read: all n run, each kept only while
    the summed stray count before it is above 0."""
    for _ in range(mesh.size):
        moving = _n_stray(local, cfg, mesh) > 0
        local = VoxelMap(*(torch.where(moving, a, b)
                           for a, b in zip(_hop(local, cfg, mesh), local)))
    return local


# ----------------------------------------------------------------------
# The global layout: repack, one rank's slab of it, and back.
# ----------------------------------------------------------------------

def _fields(m):
    """(field -> numpy array) of a VoxelMap of tensors or arrays, or of a
    dict of its fields."""
    get = m.get if isinstance(m, dict) else (lambda f: getattr(m, f))
    out = {}
    for f in VoxelMap._fields:
        v = get(f)
        out[f] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def reshard_host(m, cfg: MapConfig, n_shards: int, device=None) -> VoxelMap:
    """Repack a global (host-built, globally key-sorted) map into slab
    layout: segment d of capacity/n holds exactly rank d's keys, sorted
    (`np.lexsort((kyz, kx))`, as the JAX package orders them). Used when
    maps enter a shard-maps Slam from outside the sharded step (PCD load,
    PGO rebuild, checkpoint restore). Idempotent; a slab's overrun is
    dropped into `overflow`. Returns the global map on `device` (default:
    `m`'s, or the CPU)."""
    a = _fields(m)
    if device is None:
        device = m.xyz.device if isinstance(getattr(m, "xyz", None), torch.Tensor) else "cpu"
    M = a["xyz"].shape[0]
    cap = M // n_shards
    kx, kyz, _ = (t.numpy() for t in _leaf_keys(torch.from_numpy(a["xyz"]),
                                                 torch.from_numpy(a["valid"]), cfg))
    owner = owner_of(kx, cfg, n_shards)
    out = {f: np.zeros_like(a[f]) for f in VoxelMap._fields if f != "overflow"}
    dropped = 0
    for d in range(n_shards):
        rows = np.nonzero(a["valid"] & (owner == d) & (kx != _BIGKEY))[0]
        rows = rows[np.lexsort((kyz[rows], kx[rows]))]
        if len(rows) > cap:
            dropped += len(rows) - cap
            rows = rows[:cap]
        seg = slice(d * cap, d * cap + len(rows))
        for f in out:
            out[f][seg] = a[f][rows]
        out["valid"][seg] = True
    out["overflow"] = np.asarray(int(a["overflow"]) + dropped, np.int32)
    return VoxelMap(*(torch.tensor(out[f], device=device) for f in VoxelMap._fields))


def local_slab(m, rank: int, n_shards: int, device=None) -> VoxelMap:
    """Rank `rank`'s slab of a global slab-layout map (a VoxelMap of
    tensors or numpy arrays, or a dict of its fields: `np.asarray` of a JAX
    sharded map's fields, or a checkpoint's); `overflow` stays the global
    total."""
    a = _fields(m)
    cap = a["xyz"].shape[0] // n_shards
    seg = slice(rank * cap, (rank + 1) * cap)
    return VoxelMap(*(torch.tensor(a[f] if f == "overflow" else a[f][seg],
                                   device=device or "cpu") for f in VoxelMap._fields))


def gather_slabs(mesh, local: VoxelMap) -> VoxelMap:
    """The global slab-layout map from every rank's slab (a collective):
    the slabs concatenated in rank order, `overflow` the global total each
    rank already holds."""
    return VoxelMap(*(mesh.all_gather(v, tiled=True) for v in local[:-1]),
                    overflow=local.overflow.clone())


def empty_slab(cfg: MapConfig, n_shards: int, device) -> VoxelMap:
    """An empty slab: capacity / n_shards slots."""
    return VoxelMap.empty(dataclasses.replace(cfg, capacity=cfg.capacity // n_shards), device)


# ----------------------------------------------------------------------
# Per-rank forms of the JAX package's global API: each rank passes its slab,
# `overflow` is kept as the global total.
# ----------------------------------------------------------------------

def _with_global_overflow(fn, mesh):
    """Run a slab op with the slab's own overflow, returning the summed
    total on top of the prior (replicated) counter."""
    def wrapped(local, *args, **kw):
        prior = local.overflow
        out = fn(local._replace(overflow=torch.zeros_like(local.overflow)), *args, **kw)
        return out._replace(overflow=prior + mesh.psum(out.overflow))
    return wrapped


def add_points_sharded(mesh, local: VoxelMap, new_xyz, new_intensity, new_time, new_valid,
                       current_time, cfg: MapConfig, fixed: bool = False) -> VoxelMap:
    """RollingGrid::Add on this rank's slab (replicated point batch)."""
    return _with_global_overflow(shard_add_points, mesh)(
        local, new_xyz, new_intensity, new_time, new_valid, current_time, cfg, fixed, mesh)


def roll_sharded(mesh, local: VoxelMap, vox_offset, cfg: MapConfig, max_hops=None) -> VoxelMap:
    """RollingGrid::Roll on this rank's slab, with ring migration."""
    off = torch.as_tensor(vox_offset, dtype=torch.int32, device=local.xyz.device)
    return _with_global_overflow(shard_roll, mesh)(local, off, cfg, mesh, max_hops=max_hops)


def knn_sharded(mesh, local: VoxelMap, queries, k: int, cfg: MapConfig):
    """Exact global k-NN against the sharded map (replicated queries):
    (d2 (Q, k), nbr_xyz (Q, k, 3), nbr_ring (Q, k)), replicated."""
    view = SubmapView(xyz=local.xyz, ring=None, valid=local.valid)
    return shard_knn(view, queries, k, mesh, prepared=voxel_map.prepare_knn_index(view))
