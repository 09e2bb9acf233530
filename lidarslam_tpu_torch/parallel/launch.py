"""Start the ranks of a mesh: one process per rank, each in its own process
group membership, calling one function.

    from lidarslam_tpu_torch.parallel.launch import launch
    results = launch(fn, world=2)                  # NCCL, cuda:{rank % cards}
    results = launch(fn, world=4, backend="gloo", device="cpu")

`fn(mesh, *args)` runs on every rank with that rank's `sharded.Mesh`; its
return values (picklable) come back as a list in rank order. `fn` must be
importable by name (a module-level function): the ranks are spawned.

The rendezvous is a `file://` store in a fresh temporary directory, so
concurrent launches (test workers) never race for a port. A rank's device
is `cuda:{rank % torch.cuda.device_count()}` unless the caller names one;
CPU ranks run one intra-op thread each. Once a rank fails, or the timeout
runs out, every rank is ended and `launch` raises with the failing rank's
traceback: a rank that raises while the others wait in a collective never
hangs the caller.

Under `torchrun` (`RANK`, `WORLD_SIZE` and `LOCAL_RANK` set) nothing is
spawned: this process is the rank, it joins the group `torchrun` set up
(`env://`, device `cuda:{LOCAL_RANK}` unless named), runs `fn`, and every
rank gets the list of all ranks' results.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lidarslam_tpu_torch.parallel import sharded


def _rank_device(rank: int, device):
    if device is not None:
        return torch.device(device)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("launch: no CUDA device for the ranks; pass device='cpu' "
                           "(with backend='gloo') to run them on the CPU")
    return torch.device("cuda", rank % n)


def _join(fn, args, rank: int, world: int, backend: str, device, init_method: str,
          timeout_s: float):
    """Join the group as `rank`, run `fn(mesh, *args)`, leave the group."""
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    # the group's own timeout lies past launch's, which ends the ranks first
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s + 60))
    sharded._RANK_DEVICE = dev
    out = fn(sharded.make_mesh(world), *args)
    return out


def _rank_main(rank, fn, args, world, backend, device, init_method, timeout_s, results):
    try:
        out = _join(fn, args, rank, world, backend, device, init_method, timeout_s)
    except BaseException:   # reported to the parent, which ends every rank
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


def _end(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        if p.pid is None:       # never started (an earlier start raised)
            continue
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def launch(fn, world: int, backend: str = "nccl", device=None, timeout_s: float = 600.0,
           args: tuple = ()):
    """Run `fn(mesh, *args)` on `world` ranks; returns their results in rank
    order (see the module docstring)."""
    if _torchrun_env() and not dist.is_initialized():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} ranks, not {world}")
        rank = int(os.environ["RANK"])
        dev = device if device is not None else \
            torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        out = _join(fn, args, rank, world, backend, dev, "env://", timeout_s)
        gathered = [None] * world
        dist.all_gather_object(gathered, out)
        dist.destroy_process_group()
        return gathered

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="lidarslam_mesh_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, args, world, backend, device, init_method, timeout_s,
                               results), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: {world - len(got)} of {world} ranks gave no "
                                   f"result within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        raise RuntimeError(f"launch: rank {r} exited with code "
                                           f"{p.exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(world)]
    finally:
        _end(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
