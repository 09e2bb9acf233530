"""Multi-device scale-out over `torch.distributed` (PyTorch port of
`lidarslam_tpu/parallel/sharded.py`).

The JAX package is single-controller: its per-sweep step runs under
`shard_map` over a `Mesh(('kp',))` of devices. Here every rank is a process
(`parallel/launch.py`, or `torchrun`) that runs the same host logic on the
same sweeps, and the ranks meet in collectives of a process group. `Mesh`
holds that group and the five collectives the step uses, one for each of
the JAX body's primitives:

| JAX (`shard_map` body) | `Mesh` (one rank per process) |
|---|---|
| `lax.axis_index` | `rank` |
| `lax.psum` | `psum` (`all_reduce` SUM) |
| `lax.pmin` | `pmin` (`all_reduce` MIN) |
| `lax.all_gather(tiled=)` | `all_gather(tiled=)` |
| `lax.ppermute` ring | `ppermute(shift=+1/-1)` (`batch_isend_irecv`) |

Keypoints shard over the ranks (each matches a contiguous 1/n of every
keypoint type), the solver's 6x6 normal equations are `psum`-reduced at
every LM evaluation, and every output is replicated: all ranks step the
same pose. NCCL and gloo hand every rank the same reduced bits, so the
ranks stay bit-equal as long as each rank's own work is deterministic.

Backends: NCCL on the card (the default of `launch`), gloo where the
caller asks for it (CPU ranks, or ranks that share one card, which NCCL
refuses). gloo's rule for CUDA tensors: each collective stages them
through pinned host memory inside the method, and the result comes back
to the tensor's device. Under NCCL nothing is staged and every collective
is device work on the current stream, so a CUDA graph captures it: the
mesh stream replays one graph per sweep there (`ops/stream_graph.py`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

# the device `launch` gave this rank (read by `make_mesh`)
_RANK_DEVICE = None


class Mesh:
    """The default process group and the collectives of the sharded step.

    `rank`, `size`: this process's place in the group; `device`: the
    device its tensors live on; `backend`: "nccl" or "gloo". Every method
    is a collective: every rank calls it, in the same order, with tensors
    of the same shape and dtype."""

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.device = torch.device(device)

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, backend={self.backend}, " \
               f"device={self.device})"

    # gloo moves host memory: a CUDA tensor goes through a pinned copy
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        if self.backend == "gloo" and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            return h
        return t.clone()

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device) if h.device != like.device else h

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        h = self._stage(t.contiguous())
        dist.all_reduce(h, op=op)
        return self._back(h, t)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (`lax.psum`); a new tensor, `t` is untouched."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the ranks (`lax.pmin`)."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def all_gather(self, t: torch.Tensor, tiled: bool = False) -> torch.Tensor:
        """Every rank's `t` in rank order: stacked on a new leading dim, or
        concatenated along dim 0 with `tiled` (`lax.all_gather(tiled=)`).
        Bool tensors travel as uint8."""
        is_bool = t.dtype == torch.bool
        x = self._stage((t.to(torch.uint8) if is_bool else t).contiguous())
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        out = torch.cat(parts) if tiled else torch.stack(parts)
        out = self._back(out, t)
        return out.to(torch.bool) if is_bool else out

    def ppermute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """The ring step of `lax.ppermute` with perm [(i, (i + shift) % n)]:
        send `t` to rank + shift, receive the tensor of rank - shift. The
        send and the receive go out in one `batch_isend_irecv`, so a
        two-rank ring, whose up and down neighbour are the same rank,
        needs no ordering between them."""
        if self.size == 1:
            return t.clone()
        is_bool = t.dtype == torch.bool
        x = self._stage((t.to(torch.uint8) if is_bool else t).contiguous())
        buf = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (self.rank + shift) % self.size),
               dist.P2POp(dist.irecv, buf, (self.rank - shift) % self.size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = self._back(buf, t)
        return out.to(torch.bool) if is_bool else out

    def shard_slice(self, arr):
        """This rank's contiguous chunk of a keypoint-capacity array
        (`pipeline._shard_slice`)."""
        if arr is None:
            return None
        chunk = arr.shape[0] // self.size
        return arr[self.rank * chunk:(self.rank + 1) * chunk]


def _default_device():
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError("make_mesh: no device for this rank; pass device= (a gloo "
                       "group started outside parallel.launch names its own)")


def make_mesh(n_devices=None, device=None) -> Mesh:
    """A `Mesh` over the default process group, which must already be
    initialised (`parallel.launch`, or `torchrun` and
    `init_process_group`). Raises, as the JAX package's `make_mesh` does,
    when no group exists or when its size is not `n_devices`."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(start the ranks with parallel.launch, or torchrun)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise RuntimeError(f"requested a {n_devices}-device mesh but the process group "
                           f"has {size} ranks")
    return Mesh(_default_device() if device is None else device)


# ----------------------------------------------------------------------
# SPMD entry points: the JAX package's shard_map wrappers, here the
# pipeline steps with the mesh passed in (`Slam` steps through them on a
# mesh). Every rank calls them with the same (replicated) inputs; the
# outputs are replicated.
# ----------------------------------------------------------------------

def sharded_icp_register(mesh: Mesh, inputs, types: Sequence, pose0, params, solver_cfg,
                         icp_iters: int, lm_max_iter: int, min_matches: int,
                         map_shard: bool = False, **kw):
    """ICP registration with the keypoints sharded over the ranks: each
    rank matches its 1/n slice of every type against the (replicated)
    index, and the match counts and the normal equations are summed over
    the ranks, so all step the same pose. The keypoint capacities must be
    divisible by the mesh size; `inputs` are the full (replicated) arrays,
    and the per-keypoint statuses and weights come back full. `map_shard`:
    the indices are this rank's slabs of slab-sharded maps."""
    from lidarslam_tpu_torch.ops import icp

    for t in types:
        if inputs.kp_xyz[int(t)].shape[0] % mesh.size:
            raise ValueError(f"keypoint capacity ({inputs.kp_xyz[int(t)].shape[0]}) must "
                             f"be divisible by the mesh size ({mesh.size})")
    local = icp.ICPInputs(kp_xyz=tuple(mesh.shard_slice(x) for x in inputs.kp_xyz),
                          kp_valid=tuple(mesh.shard_slice(x) for x in inputs.kp_valid),
                          index=inputs.index,
                          kp_time=tuple(mesh.shard_slice(x) for x in inputs.kp_time))
    res = icp.icp_register(local, types, pose0, params, solver_cfg, icp_iters, lm_max_iter,
                           min_matches, mesh=mesh, map_shard=map_shard, **kw)
    return res._replace(
        statuses=tuple(mesh.all_gather(s, tiled=True) for s in res.statuses),
        weights=tuple(mesh.all_gather(w, tiled=True) for w in res.weights))


def process_frame_spmd(ri, maps, prev_kp, inp, cfg, map_cfgs, first_frame, *, mesh: Mesh,
                       shard_maps: bool = False, shard_extraction: bool = False):
    """SPMD `pipeline.process_frame` (the step `Slam.add_frame` runs).
    With `shard_maps`, `maps` are this rank's slabs."""
    from lidarslam_tpu_torch.ops import pipeline

    return pipeline.process_frame(ri, maps, prev_kp, inp, cfg, map_cfgs, first_frame,
                                  mesh=mesh, shard_maps=shard_maps,
                                  shard_extraction=shard_extraction)


def process_keypoints_spmd(kps, ri, maps, prev_kp, inp, cfg, map_cfgs, first_frame, *,
                           mesh: Mesh, shard_maps: bool = False):
    """SPMD `pipeline.process_keypoints` (the multi-LiDAR merged-keypoint
    path)."""
    from lidarslam_tpu_torch.ops import pipeline

    return pipeline.process_keypoints(kps, ri, maps, prev_kp, inp, cfg, map_cfgs,
                                      first_frame, mesh=mesh, shard_maps=shard_maps)


def process_frame_stream_spmd(ri, state, stamp, az_res, cfg, map_cfgs, first_frame, extras=(),
                              *, mesh: Mesh, shard_maps: bool = False,
                              shard_extraction: bool = False):
    """SPMD streaming step: the chained state (the maps replicated or this
    rank's slabs) advances in lock-step on every rank."""
    from lidarslam_tpu_torch.ops import pipeline

    return pipeline.process_frame_stream(ri, state, stamp, az_res, cfg, map_cfgs,
                                         first_frame, extras, mesh=mesh,
                                         shard_maps=shard_maps,
                                         shard_extraction=shard_extraction)


def process_stream_window_spmd(ri_stack, state, stamps, az_res, cfg, map_cfgs, *, mesh: Mesh,
                               shard_maps: bool = False, shard_extraction: bool = False):
    """SPMD window: the window's steps one after another on each rank (the
    JAX package's `lax.scan` inside `shard_map`), each with its
    collectives."""
    from lidarslam_tpu_torch.ops import pipeline

    return pipeline.process_stream_window(ri_stack, state, stamps, az_res, cfg, map_cfgs,
                                          mesh=mesh, shard_maps=shard_maps,
                                          shard_extraction=shard_extraction)


def process_keypoints_stream_spmd(kps, state, stamp, az_res, cfg, map_cfgs, first_frame,
                                  extras=(), *, mesh: Mesh, shard_maps: bool = False):
    """SPMD streaming step from pre-extracted merged keypoints (a rig)."""
    from lidarslam_tpu_torch.ops import pipeline

    return pipeline.process_keypoints_stream(kps, state, stamp, az_res, cfg, map_cfgs,
                                             first_frame, extras, mesh=mesh,
                                             shard_maps=shard_maps)
