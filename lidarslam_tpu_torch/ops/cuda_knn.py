"""Exact k-NN over the map slots: the hand-written CUDA kernel
(`csrc/knn.cu`) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas TPU kernel
(`lidarslam_tpu/ops/pallas_knn.py::_knn_kernel`, launched by
`bucketed_knn`). Both versions here compute the same thing: for each query
the k nearest VALID map slots in (d2, slot) order — ties go to the lower
slot — with d2 = dx*dx + dy*dy + dz*dz evaluated in that order in float32,
so on the same inputs they agree bit for bit. Missing neighbours (fewer
than k valid slots, a dead query, or a block pruned away) come back as
d2 = +inf, slot 0 and coordinates 0.

`knn` dispatches on where the queries live: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel; anything else raises. There is no
fallback from one to the other.

The kernel is built from the sources in this package at first use with
nvcc for sm_90a, into `lidarslam_tpu_torch/_build/`, and loaded with ctypes.
Each wrapper call that launches it adds one to `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

MAP_BLOCK = 1024   # map slots per pruning block (csrc/knn.cu kMapBlock)
MAX_K = 16         # largest k the kernel is instantiated for (kMaxK)
PLAIN_CHUNK = 4096  # map slots per step of the plain scan
_INT_MAX = 2**31 - 1

LAUNCHES = 0       # kernel launches made through `kernel_knn`

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "knn.cu"
_BUILD_DIR = _PKG / "_build"
_lib = None
_lib_lock = threading.Lock()


class KnnIndex(NamedTuple):
    """Map-side kernel inputs, built once per submap rebuild.

    px/py/pz: (NB * MAP_BLOCK,) coordinates, +inf where the slot is invalid
    or padding. bmin/bmax: (NB, 3) AABBs of each block's valid slots
    (+inf/-inf for a block without one)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    bmin: torch.Tensor
    bmax: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.bmin.shape[0]


def prepare_map(xyz: torch.Tensor, valid: torch.Tensor) -> KnnIndex:
    """Build the kernel's map-side inputs (see KnnIndex). Plain tensor ops,
    on the map's own device."""
    M = xyz.shape[0]
    nb = max(-(-M // MAP_BLOCK), 1)
    pad = nb * MAP_BLOCK - M
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=xyz.device)
    p = torch.where(valid[:, None], xyz.to(torch.float32), inf)
    p = torch.nn.functional.pad(p, (0, 0, 0, pad), value=float("inf"))
    blocks = p.reshape(nb, MAP_BLOCK, 3)
    bmin = blocks.amin(dim=1)
    bmax = torch.where(blocks.isfinite(), blocks, -inf).amax(dim=1)
    return KnnIndex(px=p[:, 0].contiguous(), py=p[:, 1].contiguous(),
                    pz=p[:, 2].contiguous(), bmin=bmin.contiguous(),
                    bmax=bmax.contiguous())


# -----------------------------------------------------------------------------
#   Plain PyTorch version
# -----------------------------------------------------------------------------

def plain_knn(xyz, valid, queries, k: int, q_valid=None):
    """Chunked exact scan with the kernel's contract (see module docstring).

    The (d2, slot) order is one int64 key per candidate: the float bits of a
    non-negative d2 order like the value, so (bits << 32) | slot sorts
    lexicographically and `topk` never meets a tie.

    Returns (d2 (Q, k) f32, idx (Q, k) i32, nbr (Q, k, 3) f32)."""
    M = xyz.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    qx, qy, qz = queries[:, 0:1], queries[:, 1:2], queries[:, 2:3]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    best = torch.full((Q, k), (0x7F800000 << 32), dtype=torch.int64, device=dev)
    for c0 in range(0, M, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, M)
        px = xyz[c0:c1, 0][None, :]
        py = xyz[c0:c1, 1][None, :]
        pz = xyz[c0:c1, 2][None, :]
        dx = qx - px
        dy = qy - py
        dz = qz - pz
        d2 = dx * dx
        d2 = d2 + dy * dy
        d2 = d2 + dz * dz
        d2 = torch.where(valid[c0:c1][None, :], d2, inf)
        slot = torch.arange(c0, c1, dtype=torch.int64, device=dev)[None, :]
        key = (d2.view(torch.int32).to(torch.int64) << 32) | slot
        cand = torch.cat([best, key], dim=1)
        best = torch.topk(cand, k, dim=1, largest=False, sorted=True).values
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
            lib.knn_launch.restype = ctypes.c_int
            lib.knn_launch.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float]
                + [ctypes.c_void_p] * 4)
            for const in (lib.knn_map_block, lib.knn_max_k):
                const.argtypes = []
                const.restype = ctypes.c_int
            if lib.knn_map_block() != MAP_BLOCK or lib.knn_max_k() != MAX_K:
                raise RuntimeError("csrc/knn.cu constants disagree with cuda_knn.py")
            _lib = lib
        return _lib


def _morton10(x):
    """Spread the low 10 bits of x over every 3rd bit (Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def spatial_order(queries, cell: float, q_valid=None):
    """Morton order of the query cloud at `cell` granularity, dead queries
    (q_valid False) last so whole tiles of them skip the scan."""
    qmin = queries.amin(dim=0)
    q = torch.clamp(((queries - qmin) / cell).to(torch.int32), 0, 1023)
    code = _morton10(q[:, 0]) | (_morton10(q[:, 1]) << 1) | (_morton10(q[:, 2]) << 2)
    if q_valid is not None:
        code = torch.where(q_valid, code, _INT_MAX)
    return torch.argsort(code, stable=True).to(torch.int32)


def _check(t, name, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_knn(index: KnnIndex, queries, k: int,
               prune_radius: Optional[float] = None, q_valid=None):
    """Launch csrc/knn.cu on `queries` (CUDA) against a prepared map.

    Returns (d2 (Q, k) f32, idx (Q, k) i32, nbr (Q, k, 3) f32)."""
    global LAUNCHES
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    Q = queries.shape[0]
    dev = queries.device
    nb = index.n_blocks
    _check(queries, "queries", torch.float32, (Q, 3))
    for name in ("px", "py", "pz"):
        _check(getattr(index, name), name, torch.float32, (nb * MAP_BLOCK,))
    _check(index.bmin, "bmin", torch.float32, (nb, 3))
    _check(index.bmax, "bmax", torch.float32, (nb, 3))
    if index.px.device != dev:
        raise ValueError(f"map on {index.px.device}, queries on {dev}")
    if q_valid is None:
        qv = torch.ones(Q, dtype=torch.uint8, device=dev)
    else:
        _check(q_valid, "q_valid", torch.bool, (Q,))
        qv = q_valid.to(torch.uint8)
    cell = max(float(prune_radius), 1e-3) if prune_radius is not None else 1.0
    order = spatial_order(queries, cell, q_valid)
    r2 = float("inf") if prune_radius is None else float(prune_radius) ** 2

    d2 = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    nbr = torch.empty((Q, k, 3), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_launch(index.px.data_ptr(), index.py.data_ptr(),
                            index.pz.data_ptr(), index.bmin.data_ptr(),
                            index.bmax.data_ptr(), nb, queries.data_ptr(),
                            qv.data_ptr(), order.data_ptr(), Q, k, r2,
                            d2.data_ptr(), idx.data_ptr(), nbr.data_ptr(),
                            stream)
    if rc != 0:
        raise RuntimeError(f"knn_launch failed: cudaError {rc}")
    LAUNCHES += 1
    return d2, idx, nbr


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
