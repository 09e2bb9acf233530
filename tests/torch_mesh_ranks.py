"""Rank functions of the port's multi-device tests (`tests/test_torch_*.py`
that start ranks with `lidarslam_tpu_torch.parallel.launch`).

The ranks are spawned processes, so what they run lives here, in a module
that imports neither jax nor the JAX package: the JAX side of each
comparison runs in the pytest process, which hands inputs over as .npz
files and compares the numpy results the ranks return. Every function
takes the rank's `Mesh` first and returns plain numpy / Python values.
"""

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lidarslam_tpu_torch import Slam
from lidarslam_tpu_torch.config import (ExtractorConfig, Keypoint, MapConfig,
                                        MatchingConfig, SlamConfig, SolverConfig)
from lidarslam_tpu_torch.core import se3
from lidarslam_tpu_torch.io import synthetic
from lidarslam_tpu_torch.ops import icp, pipeline, voxel_map
from lidarslam_tpu_torch.parallel import sharded, sharded_map
from lidarslam_tpu_torch.parallel.launch import launch

RANK_TIMEOUT_S = 300
# tests/test_multichip.py's bounds on a mesh run against a single-device
# one: float32 reassociation across the psum fed back through ICP
POSE_M, POSE_DEG = 1e-3, 0.01


@contextlib.contextmanager
def as_captured():
    """`sharded_map.shard_roll` taking the loop it takes under CUDA-graph
    capture (the fixed-length loop, no host read) on any device."""
    real = sharded_map._capturing
    sharded_map._capturing = lambda t: True
    try:
        yield
    finally:
        sharded_map._capturing = real


def launch_beside(fn, world, args, local):
    """Start `world` gloo CPU ranks running `fn(mesh, *args)` and, while
    they run, `local()` in this process (the JAX side and the
    single-device port runs). Returns (the ranks' results, local's)."""
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(launch, fn, world, "gloo", "cpu", RANK_TIMEOUT_S, args)
        here = local()
        return fut.result(), here


def pose_divergence(a, b):
    """Largest translation [m] and rotation [deg] differences of two pose
    stacks (n, 4, 4)."""
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max()
    dR = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    ang = np.rad2deg(np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    return float(dt), float(ang.max())


def within_matches(got, want):
    """n_matches within max(10, 2%) of `want`, frame by frame."""
    return all(abs(g - w) <= max(10, 0.02 * w) for g, w in zip(got, want))


def small_config():
    """tests/test_slam_e2e.py::small_config, in the port's classes."""
    return SlamConfig(
        extractor=ExtractorConfig(n_rings=16, max_ring_points=1024, max_keypoints=1024),
        edge_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26),
        plane_map=MapConfig(leaf_size=0.60, capacity=1 << 15, grid_size=26),
        blob_map=MapConfig(leaf_size=0.30, capacity=1 << 15, grid_size=26))


def unsaturated_config():
    """small_config with keypoint headroom: at saturation ring-sharded
    extraction keeps other keypoints than the global compaction
    (`pipeline.extract_sharded`), so its equivalence needs room
    (tests/test_multichip.py::test_shard_extraction_matches_single_device)."""
    cfg = small_config()
    return dataclasses.replace(
        cfg, extractor=dataclasses.replace(cfg.extractor, max_keypoints=4096))


def golden(n_frames):
    """The golden sequence of tests/test_multichip.py::_golden."""
    return synthetic.generate_sequence(n_frames=n_frames, motion_distortion=False,
                                       sensor=synthetic.SensorModel(range_noise=0.005))


# ----------------------------------------------------------------------
# collectives, registration, Schur, errors (tests/test_torch_parallel.py)
# ----------------------------------------------------------------------

def collective_inputs(rank: int):
    """The tensors rank `rank` of a mesh contributes (the test rebuilds
    them with numpy)."""
    return {"f": np.arange(6, dtype=np.float32).reshape(2, 3) * (rank + 1) + 10 * rank,
            "i": np.arange(4, dtype=np.int32) - 3 * rank,
            "b": np.array([rank % 2 == 0, True, rank == 1])}


def _collectives(mesh):
    t = {k: torch.from_numpy(v) for k, v in collective_inputs(mesh.rank).items()}
    out = {"psum": mesh.psum(t["f"]), "psum_i": mesh.psum(t["i"]), "pmin": mesh.pmin(t["f"]),
           "gather": mesh.all_gather(t["f"]), "tiled": mesh.all_gather(t["f"], tiled=True),
           "gather_b": mesh.all_gather(t["b"]), "up": mesh.ppermute(t["f"], +1),
           "down": mesh.ppermute(t["f"], -1), "up_b": mesh.ppermute(t["b"], +1)}
    return {k: v.numpy() for k, v in out.items()}


def _icp(mesh, npz_path):
    """sharded_icp_register on __graft_entry__._tiny_icp_setup's inputs, and
    the port's single-device icp_register on them."""
    z = np.load(npz_path)

    def view(pts):
        n = len(pts)
        return voxel_map.SubmapView(xyz=torch.from_numpy(pts),
                                    ring=torch.zeros(n, dtype=torch.int32),
                                    valid=torch.ones(n, dtype=torch.bool))

    q = z["kp_e"].shape[0]
    inputs = icp.ICPInputs(
        kp_xyz=(torch.from_numpy(z["kp_e"]), torch.from_numpy(z["kp_p"]), None),
        kp_valid=(torch.ones(q, dtype=torch.bool), torch.ones(q, dtype=torch.bool), None),
        index=(view(z["edge_pts"]), view(z["plane_pts"]), None))
    pose0 = torch.from_numpy(z["pose0"])
    args = ((Keypoint.EDGE, Keypoint.PLANE), pose0, MatchingConfig(), SolverConfig(), 3, 15, 20)
    multi = sharded.sharded_icp_register(mesh, inputs, *args)
    single = icp.icp_register(inputs, *args)
    return {"pose": multi.pose.numpy(), "total": int(multi.total_matches),
            "statuses": [s.numpy() for s in multi.statuses],
            "single_pose": single.pose.numpy(), "single_total": int(single.total_matches),
            "single_statuses": [s.numpy() for s in single.statuses]}


def tridiag_system(N=103, B=6, seed=0):
    rng = np.random.default_rng(seed)
    D = np.stack([np.eye(B) * 10 + (lambda a: a @ a.T)(rng.normal(size=(B, B)))
                  for _ in range(N)])
    return D, rng.normal(size=(N - 1, B, B)) * 0.5, rng.normal(size=(N, B))


def pose_graph(n=120, seed=3):
    """A random-walk drive of `n` poses with GPS on every fifth."""
    rng = np.random.default_rng(seed)
    poses, H = [], np.eye(4)
    for _ in range(n):
        poses.append(H.copy())
        H = H @ se3.pose_to_hmat([1.0, rng.normal(0, 0.05), 0.0, 0.0, 0.0,
                                  rng.normal(0, 0.02)])
    times = np.arange(n) * 0.1
    covs = [np.eye(6) * 1e-4] * n
    gps_idx = np.arange(0, n, 5)
    gps = np.stack([poses[i][:3, 3] for i in gps_idx]) + rng.normal(0, 0.3, (len(gps_idx), 3))
    return poses, times, covs, gps, times[gps_idx]


def _schur(mesh):
    from lidarslam_tpu_torch.backend import posegraph_device as pgd

    D, U, rhs = (torch.from_numpy(a) for a in tridiag_system())
    out = {f"S{S}": pgd.solve_block_tridiag_schur(D, U, rhs, S, mesh=mesh).numpy()
           for S in (7, 8, 13)}
    poses, times, covs, gps, gps_t = pose_graph()
    opt, cost = pgd.optimize_pose_graph_device(poses, times, covs, gps, gps_t, device="cpu",
                                               mesh=mesh)
    out["pgo"] = np.stack(opt)
    out["pgo_cost"] = cost
    return out


def _raises(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def mesh_error_configs():
    """(name, config, Slam kwargs) that a 4-rank mesh must refuse."""
    cfg = small_config()
    return [
        ("kp_capacity", dataclasses.replace(
            cfg, extractor=dataclasses.replace(cfg.extractor, max_keypoints=1022)), {}),
        ("map_capacity", dataclasses.replace(
            cfg, plane_map=dataclasses.replace(cfg.plane_map, capacity=1002)),
         {"shard_maps": True}),
        ("n_rings", dataclasses.replace(
            cfg, extractor=dataclasses.replace(cfg.extractor, n_rings=18)),
         {"shard_extraction": True}),
    ]


def _errors(mesh):
    out = {"make_mesh": _raises(lambda: sharded.make_mesh(mesh.size + 1))}
    for name, cfg, kw in mesh_error_configs():
        out[name] = _raises(lambda: Slam(cfg, mesh=mesh, **kw))
    return out


STATE_FRAMES = 5   # sweeps of the state-surface drive (the last after a reload)


def gps_from_ground_truth(frames):
    """tests/test_torch_pgo_slam.py::gps_from_ground_truth."""
    gt0 = se3.hmat_inverse(frames[0]["gt_pose"])
    return (np.stack([(gt0 @ f["gt_pose"])[:3, 3] for f in frames]),
            np.array([f["stamp"] for f in frames]))


def _points(slam):
    """Every map's WORLD points, rows sorted (a collective under
    shard_maps)."""
    out = {}
    for k in slam.maps:
        xyz = slam.get_map_points(k)[0]
        out[int(k)] = xyz[np.lexsort(xyz.T[::-1])]
    return out


def state_drive(slam, state_dir):
    """The state surface after STATE_FRAMES - 1 sweeps: a checkpoint
    reloaded into a fresh Slam and both stepped once more, the maps through
    PCD files, and the PGO against GPS from the ground truth (the map
    rebuild). Runs single-device (rank 0's files) or on a mesh."""
    import os

    frames = golden(STATE_FRAMES)
    make = (lambda: Slam(small_config(), mesh=slam.mesh, shard_maps=slam.shard_maps)) \
        if slam.mesh is not None else (lambda: Slam(small_config(), device="cpu"))
    for f in frames[:-1]:
        slam.add_frame(f)
    out = {"points": _points(slam)}
    ck = os.path.join(state_dir, "checkpoint.npz")
    slam.save_checkpoint(ck)
    resumed = make()
    resumed.load_checkpoint(ck)
    out["resumed_points"] = _points(resumed)
    out["next"] = slam.add_frame(frames[-1])["pose"]
    out["resumed_next"] = resumed.add_frame(frames[-1])["pose"]
    prefix = os.path.join(state_dir, "maps_")
    slam.save_maps_to_pcd(prefix)
    loaded = make()
    loaded.load_maps_from_pcd(prefix)
    out["pcd_points"], out["saved_points"] = _points(loaded), _points(slam)
    assert slam.run_pose_graph_optimization(*gps_from_ground_truth(frames),
                                            use_device_backend=True)
    out["pgo_poses"] = np.stack([e["pose"] for e in slam.log_trajectory])
    out["pgo_points"] = _points(slam)
    out["owns"] = [_owns_slabs(s) for s in (slam, resumed, loaded)] \
        if slam.shard_maps else []
    return out


def collective_checks(mesh):
    """The collectives of tests/test_torch_parallel.py at this launch's
    world."""
    return _collectives(mesh)


def parallel_checks(mesh, icp_npz, state_dir):
    """What tests/test_torch_parallel.py holds of one launch of 4 ranks: the
    collectives; the sharded registration; the sharded Schur; the errors;
    the state surface with shard_maps (files in `state_dir`)."""
    return {"collectives": _collectives(mesh),
            "icp": _icp(mesh, icp_npz), "schur": _schur(mesh), "errors": _errors(mesh),
            "state": state_drive(Slam(small_config(), mesh=mesh, shard_maps=True), state_dir)}


def fail_on_rank_1(mesh):
    """Rank 1 raises while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.psum(torch.ones(1))
    return "unreachable"


def hang_on_rank_1(mesh):
    """Rank 1 never joins rank 0's collective."""
    if mesh.rank == 1:
        import time
        time.sleep(3600)
    mesh.psum(torch.ones(1))
    return "unreachable"


# ----------------------------------------------------------------------
# the sharded map (tests/test_torch_sharded_map.py)
# ----------------------------------------------------------------------

# tests/test_sharded_map.py::CFG
MAP_CFG = MapConfig(leaf_size=0.5, voxel_resolution=2.0, grid_size=8,
                    capacity=1 << 13, submap_capacity=1 << 11)
# 3 voxels = 12 leaves: beyond one 9-leaf slab of a 4-rank mesh, so a
# single hop leaves stragglers
FEW_HOPS_OFFSET = (3, 0, 0)
ROLL_CASES = (((1, 0, 0), 1), ((-1, 2, 0), 1), ((2, 0, 1), 2), ((2, 0, 1), None),
              ((-3, 1, 0), None))


def points(n, seed, lo=-7.5, hi=7.5):
    """tests/test_sharded_map.py::_points."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    inten = rng.uniform(0, 100, n).astype(np.float32)
    return xyz, inten


def _insert(mesh, local, batches):
    for batch, seed in batches:
        xyz, inten = points(batch, seed)
        t = torch.tensor(float(seed))
        local = sharded_map.add_points_sharded(
            mesh, local, torch.from_numpy(xyz), torch.from_numpy(inten), t,
            torch.ones(batch, dtype=torch.bool), t, MAP_CFG)
    return local


def _global(mesh, local):
    return {f: v.numpy() for f, v in zip(voxel_map.VoxelMap._fields,
                                         sharded_map.gather_slabs(mesh, local))}


def _owns(mesh, local):
    kx, _, _ = voxel_map._leaf_keys(local.xyz, local.valid, MAP_CFG)
    owner = sharded_map.owner_of(kx, MAP_CFG, mesh.size)
    return bool((owner[local.valid] == mesh.rank).all())


def sharded_map_checks(mesh, jax_npz):
    """Everything tests/test_torch_sharded_map.py holds, from one launch:
    insert, k-NN, the rolls of ROLL_CASES, too few hops, slab ownership,
    and JAX's sharded map (from `jax_npz`) carried in with `local_slab`,
    gathered back and queried."""
    dev = mesh.device
    empty = sharded_map.empty_slab(MAP_CFG, mesh.size, dev)
    out = {"insert": _global(mesh, _insert(mesh, empty, ((2000, 0), (1500, 1))))}

    knn_map = _insert(mesh, empty, ((3000, 2),))
    q, _ = points(256, 3, lo=-6.0, hi=6.0)
    d2, nbr, ring = sharded_map.knn_sharded(mesh, knn_map, torch.from_numpy(q), 8, MAP_CFG)
    out["knn"] = {"d2": d2.numpy(), "nbr": nbr.numpy(), "ring": ring.numpy()}

    roll_map = _insert(mesh, empty, ((2500, 4), (1000, 5)))
    out["roll"], out["owns"], out["roll_sync_free"] = [], [_owns(mesh, roll_map)], []
    for offset, hops in ROLL_CASES:
        r = sharded_map.roll_sharded(mesh, roll_map, offset, MAP_CFG, max_hops=hops)
        out["roll"].append(_global(mesh, r))
        out["owns"].append(_owns(mesh, r))
        # the adaptive roll as a CUDA graph captures it: hops of fixed count
        with as_captured():
            out["roll_sync_free"].append(None if hops is not None else _global(
                mesh, sharded_map._with_global_overflow(sharded_map.shard_roll, mesh)(
                    roll_map, torch.as_tensor(offset, dtype=torch.int32), MAP_CFG, mesh)))

    few = sharded_map.roll_sharded(mesh, _insert(mesh, empty, ((2000, 6),)), FEW_HOPS_OFFSET,
                                   MAP_CFG, max_hops=1)
    out["few_hops"] = _global(mesh, few)
    out["owns"].append(_owns(mesh, few))

    z = np.load(jax_npz)
    jmap = {f: z[f"insert_{f}"] for f in voxel_map.VoxelMap._fields}
    local = sharded_map.local_slab(jmap, mesh.rank, mesh.size, dev)
    out["jax_roundtrip"] = _global(mesh, local)
    d2j, nbrj, _ = sharded_map.knn_sharded(mesh, local, torch.from_numpy(q), 8, MAP_CFG)
    out["jax_knn"] = {"d2": d2j.numpy(), "nbr": nbrj.numpy()}
    return out


# ----------------------------------------------------------------------
# Slam on a mesh (tests/test_torch_mesh_*.py)
# ----------------------------------------------------------------------

MODES = {"kp": {}, "ext": {"shard_extraction": True}, "maps": {"shard_maps": True}}


def pose_stack(outs):
    return np.stack([np.asarray(o["pose"]) for o in outs])


def _owns_slabs(slam):
    """Under shard_maps: every slab holds only keys its rank owns."""
    mesh = slam.mesh
    ok = True
    for k, m in slam.maps.items():
        mc = slam.map_cfgs[k]
        kx, _, _ = voxel_map._leaf_keys(m.xyz, m.valid, mc)
        owner = sharded_map.owner_of(kx, mc, mesh.size)
        ok &= bool((owner[m.valid] == mesh.rank).all())
    return ok


def slam_modes(mesh, modes, n_frames, stream_frames):
    """Per mode of `modes`: the sync run's poses, n_matches and map sizes over
    `n_frames` golden sweeps, the debug array's sizes, slab ownership, the
    plane map's overflow, and the stream's poses over `stream_frames`
    (`add_frame_async` + `flush`)."""
    frames = golden(max(n_frames, stream_frames))
    out = {}
    for mode in modes:
        cfg = unsaturated_config() if mode == "ext" else small_config()
        slam = Slam(cfg, mesh=mesh, **MODES[mode])
        res = [slam.add_frame(f) for f in frames[:n_frames]]
        sizes = {int(k): len(slam.get_map_points(k)[0]) for k in slam.maps}
        dbg = slam.get_debug_array()
        stream = Slam(cfg, mesh=mesh, **MODES[mode])
        for f in frames[:stream_frames]:
            stream.add_frame_async(f)
        outs = stream.flush()
        out[mode] = {"poses": pose_stack(res), "matches": [r["n_matches"] for r in res],
                     "failed": [bool(r["failure"]) for r in res], "sizes": sizes,
                     "debug": {k: v.size for k, v in dbg.items()},
                     "owns": _owns_slabs(slam) if mode == "maps" else True,
                     "overflow": slam.get_debug_information()["map_overflow_plane"],
                     "stream": pose_stack(outs)}
    return out


def tight_config(capacity=1 << 10):
    """__graft_entry__.dryrun_multichip's window: 12 voxels x 2.4 m and
    `capacity` slots per map."""
    cfg = SlamConfig()
    maps = {name: dataclasses.replace(getattr(cfg, name), grid_size=12, voxel_resolution=2.4,
                                      capacity=capacity, submap_capacity=capacity)
            for name in ("edge_map", "plane_map", "blob_map")}
    return dataclasses.replace(cfg, **maps)


def tight_frames():
    return synthetic.generate_sequence(
        n_frames=14, motion_distortion=False,
        trajectory=synthetic.weaving_street_trajectory(speed=4.0))


def tight_run(slam, frames):
    """dryrun_multichip's `run`: poses, n_matches, the first map's size,
    the largest map fill seen, the origin's norm, the overflow."""
    poses, matches, failed, max_fill = [], [], [], 0
    for f in frames:
        out = slam.add_frame(f)
        poses.append(np.asarray(out["pose"]))
        matches.append(out["n_matches"])
        failed.append(bool(out["failure"]))
        max_fill = max(max_fill, *(len(slam.get_map_points(k)[0]) for k in slam.maps))
    k = list(slam.maps)[0]
    return {"poses": np.stack(poses), "matches": matches, "failed": failed,
            "map": len(slam.get_map_points(k)[0]), "fill": max_fill,
            "origin": float(np.linalg.norm(slam.map_origin)),
            "overflow": int(np.sum(slam.map_overflow))}


TIGHT_RUNS = (("kp", 1 << 10, {}), ("ext", 1 << 10, {"shard_extraction": True}),
              ("maps_roomy", 1 << 13, {"shard_maps": True}),
              ("maps", 1 << 10, {"shard_maps": True}))


def tight_window(mesh):
    """dryrun_multichip's mesh runs: each of TIGHT_RUNS."""
    frames = tight_frames()
    return {name: tight_run(Slam(tight_config(cap), mesh=mesh, **kw), frames)
            for name, cap, kw in TIGHT_RUNS}


RIG_OFFSET = (0.5, 0.2, 0.1, 0.0, 0.0, 0.3)


def split_frame(f, offset_hmat):
    """tests/test_multilidar_debug.py::_split_frame: device 0 sees the front
    half, device 1 the rest in its own (offset) frame."""
    xyz = f["xyz"]
    front = xyz[:, 0] >= 0
    inv = se3.hmat_inverse(offset_hmat)
    f0 = {"xyz": xyz[front], "intensity": f["intensity"][front],
          "laser_id": f["laser_id"][front], "time": f["time"][front],
          "stamp": f["stamp"], "device_id": 0}
    f1 = {"xyz": (xyz[~front] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32),
          "intensity": f["intensity"][~front], "laser_id": f["laser_id"][~front],
          "time": f["time"][~front], "stamp": f["stamp"], "device_id": 1}
    return [f0, f1]


def rig_run(n_acq, mesh=None, device=None, **kw):
    """`add_frames` over `n_acq` split acquisitions: the poses."""
    offset = se3.pose_to_hmat(RIG_OFFSET)
    slam = Slam(small_config(), device=device, mesh=mesh, **kw)
    slam.set_base_to_lidar_offset(1, offset)
    outs = [slam.add_frames(split_frame(f, offset))
            for f in synthetic.generate_sequence(n_frames=n_acq, motion_distortion=False)]
    return {"poses": pose_stack(outs), "failed": [bool(o["failure"]) for o in outs]}


def tight_and_rig(mesh, n_acq):
    """tests/test_torch_mesh_tight.py's ranks: dryrun_multichip's runs, and
    the split rig's `n_acq` acquisitions in `shard_maps` mode."""
    return {"tight": tight_window(mesh), "rig": rig_run(n_acq, mesh=mesh, shard_maps=True)}



HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy",
              "cpu")


def _step_reads_on_host(slam, frame):
    """One mesh streaming step of `slam` (the SPMD step the mesh graph
    captures, its roll taking the captured loop: `as_captured`) on `frame`,
    with every Python-level host read of a tensor made to raise: (None or
    the error's text, the step's total matches)."""
    cfg = slam.cfg
    ri = slam._build_ri(frame)
    stamp = torch.tensor(frame["stamp"], dtype=torch.float32)
    az = torch.tensor(slam.azimuthal_resolution, dtype=torch.float32)
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor inside the mesh streaming step")
    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, refuse)
        with as_captured():
            _, packed, _ = slam._step("process_frame_stream")(
                ri, slam._stream_state, stamp, az, cfg, slam._map_cfgs_tuple, False)
    except AssertionError as e:
        return str(e), None
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    return None, int(pipeline.unpack_scalars(packed.numpy()[:pipeline.PACKED_LEN])["total"])


def mesh_stream(mesh, mode, n_frames):
    """`n_frames` golden sweeps through `add_frame_async` + `flush` on the
    mesh in `mode`: the poses and failures; then a second stream's step
    after its first 3 sweeps with host reads refused (`_step_reads_on_host`)."""
    cfg = unsaturated_config() if mode == "ext" else small_config()
    frames = golden(n_frames)
    slam = Slam(cfg, mesh=mesh, **MODES[mode])
    for f in frames:
        slam.add_frame_async(f)
    outs = slam.flush()
    probe = Slam(cfg, mesh=mesh, **MODES[mode])
    for f in frames[:3]:
        probe.add_frame_async(f)
    probe._drain_window()
    err, total = _step_reads_on_host(probe, frames[3])
    return {"poses": pose_stack(outs), "failed": [bool(o["failure"]) for o in outs],
            "host_read": err, "total": total}


def captured_and_eager_streams(mesh, modes, n_frames):
    """Per mode: `n_frames` golden sweeps through `add_frame_async` + `flush`
    on the mesh with the stream captured (on a card under NCCL: one graph
    replay per sweep) and with capture off; the poses, failures, and
    whether the first stream replayed a captured graph."""
    frames = golden(n_frames)
    out = {}
    for mode in modes:
        cfg = unsaturated_config() if mode == "ext" else small_config()
        runs = {}
        for captured in (True, False):
            slam = Slam(cfg, mesh=mesh, **MODES[mode])
            if not captured:
                slam._stream_captured = lambda: False
            for f in frames:
                slam.add_frame_async(f)
            outs = slam.flush()
            runs[captured] = {"poses": pose_stack(outs),
                              "failed": [bool(o["failure"]) for o in outs],
                              "graph": slam._graph is not None and slam._graph.graph is not None}
        out[mode] = runs
    return out
