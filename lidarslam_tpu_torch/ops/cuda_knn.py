"""Exact k-NN over the map slots: the hand-written CUDA kernel
(`csrc/knn.cu`) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas TPU kernel
(`lidarslam_tpu/ops/pallas_knn.py::_knn_kernel`, launched by
`bucketed_knn`). Both versions here compute the same thing: for each query
the k nearest VALID map slots in (d2, slot) order — ties go to the lower
slot — with d2 = dx*dx + dy*dy + dz*dz evaluated in that order in float32,
so on the same inputs they agree bit for bit. Missing neighbours (fewer
than k valid slots, a dead query, or a sub-block pruned away) come back as
d2 = +inf, slot 0 and coordinates 0. With a prune radius the kernel agrees
with the plain version on every neighbour within the radius; which slots
beyond it come back may differ.

`knn` dispatches on where the queries live: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel; anything else raises. There is no
fallback from one to the other.

The kernel is built from the sources in this package at first use with
nvcc for sm_90a, into `lidarslam_tpu_torch/_build/`, and loaded with ctypes.
Each wrapper call that launches it adds one to `LAUNCHES`. One call is four
launches (plan, prefix, scan, merge; see the note at the top of
`csrc/knn.cu`) with a workspace the wrapper allocates on the current
stream, so the call can be captured in a CUDA graph. The kernels also
count their own executions on the device, graph replays included:
`executions` reads those counts and `reset_executions` clears them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

SUB_BLOCK = 64     # map slots per pruning sub-block (csrc/knn.cu kSub)
TILE = 32          # queries per tile, one per lane (kTile)
SCAN_WARPS = 8     # warps per scan CTA (kScanWarps)
MAX_K = 16         # largest k the kernel is instantiated for (kMaxK)
PLAIN_CHUNK = 4096  # map slots per step of the plain scan
_INT_MAX = 2**31 - 1

LAUNCHES = 0       # kernel launches made through `launch`
KERNELS = ("knn_plan", "knn_prefix", "knn_scan", "knn_merge")  # csrc/knn.cu

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "knn.cu"
_BUILD_DIR = _PKG / "_build"
_lib = None
_lib_lock = threading.Lock()
_grid_warps = {}   # (device index, k) -> warps in the scan grid


class KnnIndex(NamedTuple):
    """Map-side kernel inputs, built once per submap rebuild.

    pts: (NS * SUB_BLOCK, 4) slots as x, y, z, 0, with +inf coordinates
    where the slot is invalid or padding (one 16-byte load per slot).
    sub_lo/sub_hi: (NS, 4) AABB of each sub-block's valid slots in x, y, z
    (w = 0), +inf/-inf for a sub-block without one. The slot order is the
    map's own: ties and the map's compaction depend on it."""

    pts: torch.Tensor
    sub_lo: torch.Tensor
    sub_hi: torch.Tensor

    @property
    def n_sub(self) -> int:
        return self.sub_lo.shape[0]


def prepare_map(xyz: torch.Tensor, valid: torch.Tensor) -> KnnIndex:
    """Build the kernel's map-side inputs (see KnnIndex). Plain tensor ops,
    on the map's own device."""
    M = xyz.shape[0]
    ns = max(-(-M // SUB_BLOCK), 1)
    inf = float("inf")
    p = torch.where(valid[:, None], xyz.to(torch.float32), inf)
    p = torch.nn.functional.pad(p, (0, 0, 0, ns * SUB_BLOCK - M), value=inf)
    blocks = p.reshape(ns, SUB_BLOCK, 3)
    lo = blocks.amin(dim=1)
    hi = torch.where(blocks.isfinite(), blocks, -inf).amax(dim=1)

    def four(t):
        return torch.nn.functional.pad(t, (0, 1), value=0.0).contiguous()

    return KnnIndex(pts=four(p), sub_lo=four(lo), sub_hi=four(hi))


def _box_d2(lo, hi, q_lo, q_hi):
    """Squared distance between boxes [lo, hi] and [q_lo, q_hi] (broadcast
    over leading dims, xyz last), in the kernel's float order."""
    g = torch.clamp(torch.maximum(lo - q_hi, q_lo - hi), min=0.0)
    return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]


def plain_work_list(index: KnnIndex, queries, q_valid, order, r2: float):
    """The kernel's plan step as plain tensor ops: (T, NS) bool, True where
    tile t's work list holds the sub-block (the kernel lists them in
    ascending order). Tile t is the queries order[32 t : 32 t + 32]; a
    sub-block is listed when it holds a valid slot and its box distance to
    the AABB of the tile's live queries is at most r2."""
    Q = queries.shape[0]
    T = -(-Q // TILE)
    inf = float("inf")
    order = order.long()
    live = torch.nn.functional.pad(q_valid[order], (0, T * TILE - Q), value=False)
    live = live.reshape(T, TILE)
    qs = torch.nn.functional.pad(queries[order], (0, 0, 0, T * TILE - Q)).reshape(T, TILE, 3)
    t_lo = torch.where(live[..., None], qs, inf).amin(dim=1)
    t_hi = torch.where(live[..., None], qs, -inf).amax(dim=1)
    lo, hi = index.sub_lo[:, :3], index.sub_hi[:, :3]
    box = _box_d2(lo[None], hi[None], t_lo[:, None], t_hi[:, None])
    nonempty = lo[:, 0] <= hi[:, 0]
    return (box <= r2) & nonempty[None, :] & live.any(dim=1)[:, None]


# -----------------------------------------------------------------------------
#   Plain PyTorch version
# -----------------------------------------------------------------------------

def plain_knn(xyz, valid, queries, k: int, q_valid=None):
    """Chunked exact scan with the kernel's contract (see module docstring).

    The (d2, slot) order is one int64 key per candidate: the float bits of a
    non-negative d2 order like the value, so (bits << 32) | slot sorts
    lexicographically and `topk` never meets a tie. Each chunk writes its
    keys word by word (little-endian: slot low, d2 bits high) behind the
    running best k of one reused candidate buffer, and d2 is built in place
    in the same float order.

    Returns (d2 (Q, k) f32, idx (Q, k) i32, nbr (Q, k, 3) f32)."""
    if sys.byteorder != "little":
        raise RuntimeError("plain_knn writes its int64 keys as little-endian words")
    M = xyz.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    qx, qy, qz = queries[:, 0:1], queries[:, 1:2], queries[:, 2:3]
    inf = float("inf")
    chunk = min(PLAIN_CHUNK, M)
    cand = torch.empty((Q, k + chunk), dtype=torch.int64, device=dev)
    words = cand.view(torch.int32).view(Q, k + chunk, 2)
    d2 = torch.empty((Q, chunk), dtype=torch.float32, device=dev)
    sq = torch.empty((Q, chunk), dtype=torch.float32, device=dev)
    slots = torch.arange(0, M, dtype=torch.int32, device=dev)
    cand[:, :k] = 0x7F800000 << 32
    for c0 in range(0, M, chunk):
        c1 = min(c0 + chunk, M)
        n = c1 - c0
        d, s = d2[:, :n], sq[:, :n]
        torch.sub(qx, xyz[c0:c1, 0][None, :], out=d)
        d.mul_(d)
        torch.sub(qy, xyz[c0:c1, 1][None, :], out=s)
        d.add_(s.mul_(s))
        torch.sub(qz, xyz[c0:c1, 2][None, :], out=s)
        d.add_(s.mul_(s))
        d.masked_fill_(~valid[c0:c1][None, :], inf)
        words[:, k:k + n, 0] = slots[None, c0:c1]
        words[:, k:k + n, 1] = d.view(torch.int32)
        cand[:, :k] = torch.topk(cand[:, :k + n], k, dim=1, largest=False,
                                 sorted=True).values
    best = cand[:, :k]
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    if q_valid is not None:
        d2 = torch.where(q_valid[:, None], d2, inf)
    found = torch.isfinite(d2)
    idx = torch.where(found, best & 0xFFFFFFFF, 0).to(torch.int32)
    nbr = torch.where(found[..., None], xyz[idx.to(torch.int64)], 0.0)
    return d2, idx, nbr


# -----------------------------------------------------------------------------
#   CUDA kernel
# -----------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the k-NN kernel is built from "
                           "csrc/knn.cu at first use and needs the CUDA toolkit")
    return found


def build_kernel() -> Path:
    """Compile csrc/knn.cu for sm_90a into _build/ (once per source
    content) and return the shared library's path."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    out = _BUILD_DIR / f"libknn_{tag}.so"
    if out.is_file():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    (_BUILD_DIR / f"libknn_{tag}.ptxas.txt").write_text(proc.stderr)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernel()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.knn_launch.restype = i32
            lib.knn_launch.argtypes = (
                [ptr] * 3 + [i32] + [ptr] * 3 + [i32, i32, ctypes.c_float]
                + [ptr] * 3 + [i32] + [ptr] * 7)
            lib.knn_grid_warps.argtypes = [i32]
            lib.knn_grid_warps.restype = i32
            lib.knn_executions.argtypes = [ptr]
            lib.knn_executions.restype = i32
            lib.knn_reset_executions.argtypes = []
            lib.knn_reset_executions.restype = i32
            consts = (lib.knn_sub_block, lib.knn_tile, lib.knn_max_k,
                      lib.knn_scan_warps_per_cta)
            for const in consts:
                const.argtypes = []
                const.restype = i32
            if (lib.knn_sub_block(), lib.knn_tile(), lib.knn_max_k(),
                    lib.knn_scan_warps_per_cta()) != (SUB_BLOCK, TILE, MAX_K, SCAN_WARPS):
                raise RuntimeError("csrc/knn.cu constants disagree with cuda_knn.py")
            _lib = lib
        return _lib


def executions(device="cuda") -> dict:
    """How often each kernel (KERNELS) ran on `device` since the last
    `reset_executions`, counted by the kernels themselves; waits for the
    device first."""
    out = (ctypes.c_ulonglong * len(KERNELS))()
    with torch.cuda.device(torch.device(device)):
        rc = _library().knn_executions(out)
    if rc != 0:
        raise RuntimeError(f"knn_executions failed: cudaError {rc}")
    return dict(zip(KERNELS, map(int, out)))


def reset_executions(device="cuda") -> None:
    """Set the kernels' device execution counts on `device` to 0 (after
    waiting for the device)."""
    with torch.cuda.device(torch.device(device)):
        rc = _library().knn_reset_executions()
    if rc != 0:
        raise RuntimeError(f"knn_reset_executions failed: cudaError {rc}")


def grid_warps(k: int, device) -> int:
    """Warps in the scan kernel's persistent grid for this k on `device`:
    as many CTAs as fit on every SM at once (from the card, not the data)."""
    dev = torch.device(device)
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), k)
    if key not in _grid_warps:
        lib = _library()
        with torch.cuda.device(dev):
            n = lib.knn_grid_warps(k)
        if n <= 0:
            raise RuntimeError(f"knn_grid_warps({k}) failed on {dev}")
        _grid_warps[key] = n
    return _grid_warps[key]


def _morton10(x):
    """Spread the low 10 bits of x over every 3rd bit (Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


_spread = {}       # device -> (1024, 3) int64: _morton10(i) << axis


def _spread_table(device):
    """_morton10 of every 10-bit cell index, shifted into place per axis,
    built on `device` with no host copy. A table built while a CUDA graph
    is being captured holds its values only in replays, so it is not kept."""
    table = _spread.get(device)
    if table is None:
        i = torch.arange(1024, dtype=torch.int64, device=device)
        table = _morton10(i)[:, None] << torch.arange(3, device=device)
        if not (table.is_cuda and torch.cuda.is_current_stream_capturing()):
            _spread[device] = table
    return table


def spatial_order(queries, cell: float, q_valid=None):
    """Morton order (int64) of the live queries at `cell` granularity from
    their lower corner, dead queries (q_valid False) last so whole tiles of
    them skip the scan. Any order gives the same neighbours within the
    prune radius; a compact tile prunes more."""
    inf = float("inf")
    live = queries if q_valid is None else torch.where(q_valid[:, None], queries, inf)
    # to int64 first: NaN and +-inf convert to an end of the range, which the
    # clamp folds onto a valid cell
    cells = ((queries - live.amin(dim=0)) * (1.0 / cell)).to(torch.int64).clamp_(0, 1023)
    table = _spread_table(queries.device)
    code = table.gather(0, cells).sum(dim=1)   # the axes' bits do not overlap
    if q_valid is not None:
        code = torch.where(q_valid, code, _INT_MAX)
    return torch.argsort(code, stable=True)


def _check(t, name, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class KnnRun(NamedTuple):
    """One launch's outputs (by query row) and its workspace: the tiles'
    work lists (T, NS) with their lengths and prefix, and per scan CTA the
    sub-blocks it was given and those it scanned (stats (CTAs, 2))."""

    d2: torch.Tensor
    idx: torch.Tensor
    nbr: torch.Tensor
    work: torch.Tensor
    count: torch.Tensor
    start: torch.Tensor
    stats: torch.Tensor


def launch(index: KnnIndex, queries, q_valid, order, k: int, r2: float) -> KnnRun:
    """Launch csrc/knn.cu on prepared inputs: `queries` (Q, 3) f32,
    `q_valid` (Q,) bool, `order` (Q,) int64 scan order (spatial_order), `r2`
    the squared prune radius (+inf: none). All on one CUDA device."""
    global LAUNCHES
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    Q = queries.shape[0]
    dev = queries.device
    ns = index.n_sub
    _check(queries, "queries", torch.float32, (Q, 3))
    _check(q_valid, "q_valid", torch.bool, (Q,))
    _check(order, "order", torch.int64, (Q,))
    _check(index.pts, "pts", torch.float32, (ns * SUB_BLOCK, 4))
    _check(index.sub_lo, "sub_lo", torch.float32, (ns, 4))
    _check(index.sub_hi, "sub_hi", torch.float32, (ns, 4))
    for name in ("pts", "sub_lo", "sub_hi"):
        t = getattr(index, name)
        if t.device != dev:
            raise ValueError(f"map on {t.device}, queries on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    T = -(-Q // TILE)
    warps = grid_warps(k, dev)
    ctas = warps // SCAN_WARPS
    n_part = (warps + T) * k * TILE
    if T * ns > _INT_MAX or n_part > _INT_MAX:
        raise ValueError(f"Q={Q} queries against {ns} sub-blocks overflow the "
                         "kernel's int32 workspace indices")

    d2 = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    nbr = torch.empty((Q, k, 3), dtype=torch.float32, device=dev)
    # one int32 workspace: work lists, counts, prefix, partial d2 (as float
    # bits) and slots, per-CTA stats
    offs = [0]
    for n in (T * ns, T, T + 1, n_part, n_part, 2 * ctas):
        offs.append(offs[-1] + n)
    ws = torch.empty(offs[-1], dtype=torch.int32, device=dev)
    if Q:
        base = ws.data_ptr()
        work, count, start, part_d2, part_slot, stats = (base + 4 * o for o in offs[:-1])
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (index.pts.data_ptr(), index.sub_lo.data_ptr(), index.sub_hi.data_ptr(),
                ns, queries.data_ptr(), q_valid.data_ptr(), order.data_ptr(), Q, k, r2,
                work, count, start, warps, part_d2, part_slot, stats,
                d2.data_ptr(), idx.data_ptr(), nbr.data_ptr(), stream)
        if dev.index is None or dev.index == torch.cuda.current_device():
            rc = _library().knn_launch(*args)
        else:
            with torch.cuda.device(dev):
                rc = _library().knn_launch(*args)
        if rc != 0:
            raise RuntimeError(f"knn_launch failed: cudaError {rc}")
        LAUNCHES += 1
    return KnnRun(d2, idx, nbr, ws[:offs[1]].view(T, ns), ws[offs[1]:offs[2]],
                  ws[offs[2]:offs[3]], ws[offs[5]:offs[6]].view(ctas, 2))


def kernel_knn(index: KnnIndex, queries, k: int,
               prune_radius: Optional[float] = None, q_valid=None):
    """Launch csrc/knn.cu on `queries` (CUDA) against a prepared map.

    Returns (d2 (Q, k) f32, idx (Q, k) i32, nbr (Q, k, 3) f32)."""
    Q = queries.shape[0]
    _check(queries, "queries", torch.float32, (Q, 3))
    if q_valid is None:
        qv = torch.ones(Q, dtype=torch.bool, device=queries.device)
    else:
        _check(q_valid, "q_valid", torch.bool, (Q,))
        qv = q_valid
    cell = max(float(prune_radius), 1e-3) if prune_radius is not None else 1.0
    order = spatial_order(queries, cell, q_valid)
    r2 = float("inf") if prune_radius is None else float(prune_radius) ** 2
    run = launch(index, queries, qv, order, k, r2)
    return run.d2, run.idx, run.nbr


def knn(xyz, valid, queries, k: int, prune_radius: Optional[float] = None,
        q_valid=None, prepared: Optional[KnnIndex] = None):
    """k nearest valid map slots per query: the plain version for CPU
    queries, the CUDA kernel for CUDA queries (`prune_radius` only prunes
    on the kernel path). Returns (d2, idx, nbr) as `plain_knn`."""
    if queries.device.type == "cpu":
        return plain_knn(xyz, valid, queries, k, q_valid=q_valid)
    if queries.is_cuda:
        index = prepared if prepared is not None else prepare_map(xyz, valid)
        return kernel_knn(index, queries.contiguous(), k, prune_radius, q_valid)
    raise ValueError(f"no k-NN for tensors on {queries.device}")
