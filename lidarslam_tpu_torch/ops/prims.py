"""Scan and index-selection primitives (PyTorch port of
`lidarslam_tpu/ops/prims.py`).

The JAX module exists because `cumsum` and sized `nonzero` lower poorly on
the TPU. Here the selections are a `torch.cumsum` plus a fixed-capacity
scatter (`first_k_indices`); nothing uses `torch.nonzero`, which
synchronizes with the host to size its output. `prefix_shift` and
`rev_segment_scan` keep the JAX package's log-shift (Hillis-Steele) order
of additions, so their float results are bit-equal to JAX's: the map's
CENTROID means depend on it (`voxel_map`).
"""

from __future__ import annotations

import torch


def prefix_shift(x):
    """Inclusive prefix sum along the last axis via log-shift adds."""
    n = x.shape[-1]
    s = 1
    while s < n:
        x = x + torch.cat([torch.zeros_like(x[..., :s]), x[..., :-s]], dim=-1)
        s *= 2
    return x


def rev_segment_scan(seg, xs):
    """Suffix combines within equal-`seg` runs (runs contiguous, e.g. ids
    over sort-grouped keys): out[i] = combine(x[i..e)) where e is the end
    of i's run, so a run's first element holds the run's aggregate.

    Args:
      seg: (N,) int run ids (only equality of neighbours is used).
      xs: list of (tensor (N, ...), combine fn, pad value) triples.

    Returns the list of scanned tensors."""
    n = seg.shape[0]
    res = [x for x, _, _ in xs]
    s = 1
    while s < n:
        pad = torch.full((s,), -1, dtype=seg.dtype, device=seg.device)
        same = torch.cat([seg[s:], pad]) == seg
        new = []
        for x, (_, op, fill) in zip(res, xs):
            shifted = torch.cat([x[s:], torch.full_like(x[:s], fill)])
            m = same.reshape(same.shape + (1,) * (x.dim() - 1))
            new.append(torch.where(m, op(x, shifted), x))
        res = new
        s *= 2
    return res


def first_k_indices(mask, capacity: int):
    """Flat (row-major) indices of the first `capacity` set bits of `mask`,
    plus the total set-bit count.

    Returns (idx (capacity,) int32 — 0-filled past `count`, count () int32)."""
    flat = mask.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int32), dim=0)          # inclusive
    count = rank[-1]
    take = flat & (rank <= capacity)
    # every kept bit lands on its own slot rank-1; the rest go to a spill
    # slot past the end that is cut off
    dst = torch.where(take, rank - 1, capacity).to(torch.int64)
    pos = torch.arange(flat.numel(), dtype=torch.int32, device=mask.device)
    out = torch.zeros(capacity + 1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dst, torch.where(take, pos, 0))
    return out[:capacity], count.to(torch.int32)


def spread_k_indices(mask, capacity: int):
    """Flat indices of ~`capacity` EVENLY-SPACED set bits of `mask` (1-D or
    2-D, row-major order), plus the kept count.

    Under capacity this is `first_k_indices`. Above it, bit j (1-based rank)
    survives where floor(j * ratio) != floor((j-1) * ratio) with the f32
    ratio capacity / count — the JAX package's exact rule, which decides
    which keypoints survive at saturation. The branch is a `where`, so no
    host sync decides it."""
    flat = mask.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int32), dim=0)
    count = rank[-1]
    ratio = torch.full((), float(capacity), dtype=torch.float32,
                       device=mask.device) / torch.clamp(count, min=1).to(torch.float32)
    bkt = torch.floor(rank.to(torch.float32) * ratio)
    bkt_prev = torch.floor((rank - 1).to(torch.float32) * ratio)
    thinned = flat & (bkt != bkt_prev)
    keep = torch.where(count > capacity, thinned, flat)
    return first_k_indices(keep, capacity)
