"""The port's multi-device layer on the CPU: the `Mesh` collectives against
numpy at worlds 4 and 2, `sharded_icp_register` against the JAX package's
on the 4-device CPU mesh, the sharded segment-Schur against the unsharded
one, the mesh errors against JAX's, and `launch` ending every rank when
one fails or hangs.

The ranks are gloo processes on the CPU, started by `parallel.launch` once
for the file's world-4 checks (tests/torch_mesh_ranks.py::parallel_checks,
which imports no jax) and once for the collectives at world 2; the JAX
side runs here."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks_mod
from lidarslam_tpu_torch import Slam as TSlam
from lidarslam_tpu_torch.backend import posegraph_device as tpgd
from lidarslam_tpu_torch.parallel import sharded as tsharded
from lidarslam_tpu_torch.parallel.launch import launch
from test_torch_slam import _one_torch_thread  # noqa: F401

WORLD = 4
RANK_TIMEOUT_S = 240
ICP_POSE_TOL = 1e-4       # tests/test_multichip.py::test_sharded_matches_single_device
SCHUR_REL_TOL = 1e-10


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's sharded registration on its 4-device CPU mesh and
    its mesh errors; the registration's inputs written for the ranks."""
    import __graft_entry__ as g
    from lidarslam_tpu.config import Keypoint, MatchingConfig, SolverConfig
    from lidarslam_tpu.ops import icp
    from lidarslam_tpu.parallel import sharded

    inputs, geoms, pose0 = g._tiny_icp_setup(q=64)
    path = tmp_path_factory.mktemp("mesh") / "icp.npz"
    np.savez(path, kp_e=np.asarray(inputs.kp_xyz[0]), kp_p=np.asarray(inputs.kp_xyz[1]),
             edge_pts=np.asarray(inputs.index[0].xyz),
             plane_pts=np.asarray(inputs.index[1].xyz), pose0=np.asarray(pose0))
    mesh = sharded.make_mesh(WORLD)
    multi = sharded.sharded_icp_register(mesh, inputs, (Keypoint.EDGE, Keypoint.PLANE), pose0,
                                         MatchingConfig(), SolverConfig(), 3, 15, 20, geoms)
    single = icp.icp_register(inputs, types=(Keypoint.EDGE, Keypoint.PLANE), pose0=pose0,
                              params=MatchingConfig(), solver_cfg=SolverConfig(),
                              icp_iters=3, lm_max_iter=15, min_matches=20, geoms=geoms)
    return {"npz": str(path), "pose": np.asarray(multi.pose),
            "total": int(multi.total_matches), "single_total": int(single.total_matches),
            "errors": _jax_errors(mesh)}


def _jax_errors(mesh):
    from lidarslam_tpu.parallel import sharded
    from lidarslam_tpu.slam import Slam as JSlam

    out = {"make_mesh": ranks_mod._raises(lambda: sharded.make_mesh(9))}
    for name, cfg, kw in ranks_mod.mesh_error_configs():
        out[name] = ranks_mod._raises(lambda: JSlam(_jax_config(cfg), mesh=mesh, **kw))
    return out


def _jax_config(tcfg):
    """The port's SlamConfig rebuilt from the JAX package's classes."""
    from lidarslam_tpu import config as jcfg

    def conv(obj):
        if dataclasses.is_dataclass(obj):
            return getattr(jcfg, type(obj).__name__)(
                **{f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
        if isinstance(obj, tuple):
            return tuple(conv(x) for x in obj)
        if hasattr(obj, "name") and hasattr(jcfg, type(obj).__name__):
            return getattr(jcfg, type(obj).__name__)[obj.name]
        return obj
    return conv(tcfg)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    state_dir = tmp_path_factory.mktemp("mesh_state")
    return launch(ranks_mod.parallel_checks, WORLD, backend="gloo", device="cpu",
                  timeout_s=RANK_TIMEOUT_S, args=(jax_side["npz"], str(state_dir)))


@pytest.fixture(scope="module")
def ranks2():
    """The collectives at world 2, from a launch of their own."""
    return launch(ranks_mod.collective_checks, 2, backend="gloo", device="cpu",
                  timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def single_state(tmp_path_factory):
    """The state drive of the port's single-device Slam."""
    return ranks_mod.state_drive(TSlam(ranks_mod.small_config(), device="cpu"),
                                 str(tmp_path_factory.mktemp("single_state")))


def _expected(op, world):
    ins = [{k: v for k, v in ranks_mod.collective_inputs(r).items()} for r in range(world)]
    f = [x["f"] for x in ins]
    return [{"psum": np.sum(f, axis=0), "psum_i": np.sum([x["i"] for x in ins], axis=0, dtype=np.int32),
             "pmin": np.min(f, axis=0), "gather": np.stack(f), "tiled": np.concatenate(f),
             "gather_b": np.stack([x["b"] for x in ins]), "up": f[(r - 1) % world],
             "down": f[(r + 1) % world], "up_b": ins[(r - 1) % world]["b"]}[op]
            for r in range(world)]


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("op", ["psum", "psum_i", "pmin", "gather", "tiled", "gather_b",
                                "up", "down", "up_b"])
def test_mesh_collective_matches_numpy(request, world, op):
    """Each collective on every rank, at world 4 in the file's launch and at
    world 2 in a launch of its own."""
    want = _expected(op, world)
    results = [res["collectives"] for res in request.getfixturevalue("ranks")] \
        if world == 4 else request.getfixturevalue("ranks2")
    assert len(results) == world
    for r, res in enumerate(results):
        got = res[op]
        exp = want[r]
        assert got.dtype == exp.dtype and got.shape == exp.shape, (op, r)
        np.testing.assert_array_equal(got, exp, err_msg=f"{op} rank {r}")


def test_sharded_icp_matches_jax(ranks, jax_side):
    """Equal total_matches, and the pose within 1e-4 of the JAX package's
    sharded registration, on every rank."""
    for res in ranks:
        assert res["icp"]["total"] == jax_side["total"] == jax_side["single_total"]
        np.testing.assert_allclose(res["icp"]["pose"], jax_side["pose"], rtol=0,
                                   atol=ICP_POSE_TOL)


def test_sharded_icp_matches_single_device(ranks):
    """The psum-reduced solve against the port's single-device solve: the
    same matches, every keypoint's status reassembled, the pose within
    float32 reassociation."""
    for res in ranks:
        r = res["icp"]
        assert r["total"] == r["single_total"]
        for a, b in zip(r["statuses"], r["single_statuses"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(r["pose"], r["single_pose"], rtol=0, atol=ICP_POSE_TOL)


def test_sharded_icp_ranks_bit_equal(ranks):
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["icp"]["pose"], ranks[0]["icp"]["pose"])


@pytest.mark.parametrize("S", [7, 8, 13])
def test_sharded_schur_matches_unsharded(ranks, S):
    """The segment-Schur solve with its interiors sharded over 4 ranks
    (S segments: uneven ranges at 7 and 13) against the unsharded solve,
    within 1e-10 relative, on every rank."""
    D, U, rhs = (torch.from_numpy(a) for a in ranks_mod.tridiag_system())
    ref = tpgd.solve_block_tridiag_schur(D, U, rhs, S).numpy()
    for res in ranks:
        got = res["schur"][f"S{S}"]
        assert np.abs(got - ref).max() <= SCHUR_REL_TOL * np.abs(ref).max()


def test_sharded_pgo_matches_unsharded(ranks):
    """`optimize_pose_graph_device(mesh=)` (4 segments a rank) against the
    unsharded Schur over the same 16 segments."""
    poses, times, covs, gps, gps_t = ranks_mod.pose_graph()
    ref, cost = tpgd.optimize_pose_graph_device(poses, times, covs, gps, gps_t,
                                                n_segments=4 * WORLD, device="cpu")
    ref = np.stack(ref)
    for res in ranks:
        got = res["schur"]["pgo"]
        assert np.abs(got - ref).max() <= SCHUR_REL_TOL * np.abs(ref).max()
        assert abs(res["schur"]["pgo_cost"] - cost) <= SCHUR_REL_TOL * abs(cost)


@pytest.mark.parametrize("name", ["kp_capacity", "map_capacity", "n_rings"])
def test_mesh_slam_errors_match_jax(ranks, jax_side, name):
    """A mesh whose size does not divide the keypoint capacity, the map
    capacity (shard_maps) or the rings (shard_extraction): the same error
    as the JAX package's Slam, word for word."""
    want = jax_side["errors"][name]
    assert want is not None and want[0] == "ValueError"
    for res in ranks:
        assert res["errors"][name] == want


def test_make_mesh_errors_as_jax(ranks, jax_side):
    """A mesh larger than the group, and no group at all: RuntimeError, as
    the JAX package's make_mesh raises for too few devices."""
    assert jax_side["errors"]["make_mesh"][0] == "RuntimeError"
    for res in ranks:
        assert res["errors"]["make_mesh"][0] == "RuntimeError"
    with pytest.raises(RuntimeError, match="initialised default process group"):
        tsharded.make_mesh()


def test_slam_shard_flags_need_a_mesh():
    from lidarslam_tpu.slam import Slam as JSlam

    cfg = ranks_mod.small_config()
    for kw in ({"shard_maps": True}, {"shard_extraction": True}):
        with pytest.raises(ValueError) as jerr:
            JSlam(_jax_config(cfg), **kw)
        with pytest.raises(ValueError) as terr:
            TSlam(cfg, device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)


def test_stream_graph_refuses_a_mesh():
    """A CUDA graph holds a mesh step only on NCCL: gloo stages every
    collective through host memory (D10), so a gloo mesh is refused."""
    from types import SimpleNamespace

    from lidarslam_tpu_torch.ops import stream_graph

    cfg = ranks_mod.small_config()
    with pytest.raises(ValueError, match="only on NCCL: gloo stages(.|\n)*D10"):
        stream_graph.StreamGraph(cfg, (), "cpu", None, mesh=SimpleNamespace(backend="gloo"))


def test_launch_raises_when_a_rank_fails():
    """Rank 1 raises while rank 0 waits in a collective: `launch` ends both
    and raises with rank 1's traceback, well inside its timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*on purpose"):
        launch(ranks_mod.fail_on_rank_1, 2, backend="gloo", device="cpu", timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_launch_ends_a_hung_rank():
    """Rank 1 never joins the collective: `launch` raises at its timeout
    and ends both ranks."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="gave no result within"):
        launch(ranks_mod.hang_on_rank_1, 2, backend="gloo", device="cpu", timeout_s=10)
    assert time.monotonic() - t0 < 30


def _same_points(a, b, atol=0.0):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=str(k))


def test_mesh_checkpoint_roundtrip(ranks):
    """Under shard_maps: `save_checkpoint` gathers the slabs (rank 0
    writes), `load_checkpoint` gives each rank its slab back: the same map
    points, the slabs owning their leaves, and the next sweep's pose
    bit-equal to the uninterrupted run's."""
    for res in ranks:
        st = res["state"]
        _same_points(st["resumed_points"], st["points"])
        np.testing.assert_array_equal(st["resumed_next"], st["next"])
        assert all(st["owns"])


def test_mesh_pcd_roundtrip(ranks, single_state):
    """`save_maps_to_pcd` / `load_maps_from_pcd` under shard_maps: the
    loaded maps hold the saved points, as on one device."""
    for res in ranks:
        st = res["state"]
        _same_points(st["pcd_points"], st["saved_points"], atol=1e-4)
    for k, pts in single_state["pcd_points"].items():
        assert len(pts) == len(single_state["saved_points"][k])


def test_mesh_pgo_rebuild_matches_single_device(ranks, single_state):
    """`run_pose_graph_optimization` on the mesh (the device backend's Schur
    sharded over the ranks, the maps rebuilt whole and resharded): every
    rank's poses bit-equal, within 1e-3 m of the single-device PGO, the
    rebuilt maps' sizes within 2%."""
    ref = single_state["pgo_poses"]
    for res in ranks:
        st = res["state"]
        np.testing.assert_array_equal(st["pgo_poses"], ranks[0]["state"]["pgo_poses"])
        assert np.abs(st["pgo_poses"][:, :3, 3] - ref[:, :3, 3]).max() < 1e-3
        for k, pts in single_state["pgo_points"].items():
            assert abs(len(st["pgo_points"][k]) - len(pts)) <= max(5, 0.02 * len(pts))


def test_slam_runs_on_the_meshs_device():
    """A mesh Slam takes the mesh's device; naming another one raises."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(rank=0, size=1, device=torch.device("cpu"))
    cfg = ranks_mod.small_config()
    assert TSlam(cfg, mesh=mesh).device == mesh.device
    assert TSlam(cfg, device="cpu", mesh=mesh).device == mesh.device
    with pytest.raises(ValueError, match="is not the mesh's device"):
        TSlam(cfg, device="cuda", mesh=mesh)
