"""The port's slab-sharded map (`parallel/sharded_map.py`) on 4 gloo ranks
against the JAX package's on its 4-device CPU mesh: the counterpart of
tests/test_sharded_map.py, on the same CFG and the same seeded points.

The ranks run tests/torch_mesh_ranks.py::sharded_map_checks once for the
file and return their slabs gathered into the global layout, which is the
JAX package's global sharded map: so insert and roll are held to JAX's
slot for slot."""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks_mod
from lidarslam_tpu_torch.ops import voxel_map as tvm
from lidarslam_tpu_torch.parallel import sharded_map as tsm
from lidarslam_tpu_torch.parallel.launch import launch
from test_torch_slam import _one_torch_thread  # noqa: F401

WORLD = 4
RANK_TIMEOUT_S = 240
FIELDS = tvm.VoxelMap._fields
CFG = ranks_mod.MAP_CFG


def _jcfg():
    from lidarslam_tpu.config import MapConfig

    return MapConfig(leaf_size=CFG.leaf_size, voxel_resolution=CFG.voxel_resolution,
                     grid_size=CFG.grid_size, capacity=CFG.capacity,
                     submap_capacity=CFG.submap_capacity)


def _np(m):
    return {f: np.asarray(getattr(m, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's sharded insert, k-NN, rolls and too-few-hops roll
    on make_mesh(4); its insert written for the ranks."""
    import jax.numpy as jnp
    from lidarslam_tpu.ops import voxel_map
    from lidarslam_tpu.parallel import sharded, sharded_map

    mesh = sharded.make_mesh(WORLD)
    cfg = _jcfg()

    def insert(m, batches):
        for batch, seed in batches:
            xyz, inten = ranks_mod.points(batch, seed)
            m = sharded_map.add_points_sharded(mesh, m, jnp.asarray(xyz), jnp.asarray(inten),
                                               jnp.float32(seed), jnp.ones(batch, bool),
                                               jnp.float32(seed), cfg)
        return m

    empty = voxel_map.VoxelMap.empty(cfg)
    out = {"insert": _np(insert(empty, ((2000, 0), (1500, 1))))}
    q, _ = ranks_mod.points(256, 3, lo=-6.0, hi=6.0)
    d2, nbr, _ = sharded_map.knn_sharded(mesh, insert(empty, ((3000, 2),)), jnp.asarray(q), 8,
                                         cfg)
    out["knn"] = {"d2": np.asarray(d2), "nbr": np.asarray(nbr)}
    roll_map = insert(empty, ((2500, 4), (1000, 5)))
    out["roll"] = [_np(sharded_map.roll_sharded(mesh, roll_map, jnp.asarray(off, jnp.int32),
                                                cfg, max_hops=hops))
                   for off, hops in ranks_mod.ROLL_CASES]
    out["few_hops"] = _np(sharded_map.roll_sharded(
        mesh, insert(empty, ((2000, 6),)), jnp.asarray(ranks_mod.FEW_HOPS_OFFSET, jnp.int32),
        cfg, max_hops=1))
    path = tmp_path_factory.mktemp("mesh") / "jax_map.npz"
    np.savez(path, **{f"insert_{f}": v for f, v in out["insert"].items()})
    out["npz"] = str(path)
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    return launch(ranks_mod.sharded_map_checks, WORLD, backend="gloo", device="cpu",
                  timeout_s=RANK_TIMEOUT_S, args=(jax_side["npz"],))


def _single(batches):
    """The port's single-device map after the same inserts."""
    m = tvm.VoxelMap.empty(CFG, "cpu")
    for batch, seed in batches:
        xyz, inten = ranks_mod.points(batch, seed)
        m = tvm.add_points(m, torch.from_numpy(xyz), torch.from_numpy(inten), float(seed),
                           torch.ones(batch, dtype=torch.bool), float(seed), CFG)
    return m


def _content(a):
    """Canonically sorted (xyz, intensity, count, fixed) of the valid slots."""
    v = a["valid"]
    xyz = a["xyz"][v]
    rows = np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0]))
    return xyz[rows], a["intensity"][v][rows], a["count"][v][rows], a["fixed"][v][rows]


def _slot_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_sharded_insert_matches_jax(ranks, jax_side):
    """Every slot of every rank's slab equals the JAX package's sharded map,
    and the contents equal the single-device map's."""
    for res in ranks:
        _slot_equal(res["insert"], jax_side["insert"])
    single = _np(_single(((2000, 0), (1500, 1))))
    a, b = _content(single), _content(ranks[0]["insert"])
    assert len(a[0]) == len(b[0]) > 500
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert int(ranks[0]["insert"]["overflow"]) == 0


def test_sharded_knn_matches_jax(ranks, jax_side):
    """The slab scans merged over the ranks: d2 within 1e-5 of JAX's, and
    more than 0.99 of the neighbours at JAX's positions."""
    for res in ranks:
        np.testing.assert_allclose(res["knn"]["d2"], jax_side["knn"]["d2"], rtol=1e-5,
                                   atol=1e-6)
        match = np.isclose(res["knn"]["nbr"], jax_side["knn"]["nbr"], atol=1e-5).all(-1)
        assert match.mean() > 0.99


def test_sharded_knn_matches_single_device(ranks):
    """Against the plain scan of the single-device map (the JAX test's
    check): the same distances, the same neighbours where unique."""
    m = _single(((3000, 2),))
    q, _ = ranks_mod.points(256, 3, lo=-6.0, hi=6.0)
    d2, rows, nbr = tvm.brute_knn(tvm.SubmapView(xyz=m.xyz, ring=None, valid=m.valid),
                                  torch.from_numpy(q), 8)
    got = ranks[0]["knn"]
    np.testing.assert_allclose(got["d2"], d2.numpy(), rtol=1e-5, atol=1e-6)
    assert np.isclose(got["nbr"], nbr.numpy(), atol=1e-5).all(-1).mean() > 0.99


@pytest.mark.parametrize("case", range(len(ranks_mod.ROLL_CASES)),
                         ids=[f"{o}-hops{h}" for o, h in ranks_mod.ROLL_CASES])
def test_sharded_roll_matches_jax(ranks, jax_side, case):
    """The roll with ring migration, fixed hops or adaptive (None): every
    slot equal to the JAX package's, the contents equal to the
    single-device roll's, nothing dropped."""
    offset, _ = ranks_mod.ROLL_CASES[case]
    for res in ranks:
        _slot_equal(res["roll"][case], jax_side["roll"][case])
    m = tvm.roll_by_offset(_single(((2500, 4), (1000, 5))),
                           torch.tensor(offset, dtype=torch.int32), CFG)
    a, b = _content(_np(m)), _content(ranks[0]["roll"][case])
    assert len(a[0]) == len(b[0]) > 100
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert int(ranks[0]["roll"][case]["overflow"]) == 0


ADAPTIVE = [i for i, (_, hops) in enumerate(ranks_mod.ROLL_CASES) if hops is None]


@pytest.mark.parametrize("case", ADAPTIVE,
                         ids=[f"{ranks_mod.ROLL_CASES[i][0]}" for i in ADAPTIVE])
def test_sync_free_roll_equals_adaptive_roll(ranks, jax_side, case):
    """The roll a CUDA graph captures (`shard_roll` under capture,
    `torch_mesh_ranks.as_captured`: all n hops, each kept only while the
    summed stray count before it is above 0, no host read) against the
    adaptive host loop and JAX's `while_loop`: every slot equal on every
    rank, after a roll whose strays cross more than one slab."""
    assert max(abs(o) for o in ranks_mod.ROLL_CASES[case][0]) > 1
    for res in ranks:
        _slot_equal(res["roll_sync_free"][case], res["roll"][case])
        _slot_equal(res["roll_sync_free"][case], jax_side["roll"][case])


def test_sharded_roll_too_few_hops_counts_overflow(ranks, jax_side):
    """A 3-voxel jump (12 leaves, beyond one 9-leaf slab of 4 ranks)
    allowed one hop: the stragglers are dropped and counted, as in the JAX
    package, slot for slot."""
    want = jax_side["few_hops"]
    assert int(want["overflow"]) > 0
    for res in ranks:
        _slot_equal(res["few_hops"], want)


@pytest.mark.parametrize("rank", range(WORLD))
def test_slab_ownership_on_every_rank(ranks, rank):
    """After every insert and roll, each slab holds only the leaves its
    rank owns."""
    assert all(ranks[rank]["owns"])


def _band_map():
    """4000 points in a 2 m band of x: one slab's leaves, more than a slab
    of 8 holds."""
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-7.5, 7.5, (4000, 3)).astype(np.float32)
    xyz[:, 0] = rng.uniform(-1.0, 1.0, 4000)
    m = tvm.add_points(tvm.VoxelMap.empty(CFG, "cpu"), torch.from_numpy(xyz),
                       torch.zeros(4000), 0.0, torch.ones(4000, dtype=torch.bool), 0.0, CFG)
    return _np(m)


@pytest.mark.parametrize("n_shards,band", [(2, False), (4, False), (8, False), (8, True)])
def test_reshard_host_matches_jax(n_shards, band):
    """A single-device map repacked into slab layout: every slot equal to
    the JAX package's `reshard_host`, and idempotent. The band map overruns
    its slab and the drops are counted."""
    import jax.numpy as jnp
    from lidarslam_tpu.ops import voxel_map
    from lidarslam_tpu.parallel import sharded_map

    a = _band_map() if band else _np(_single(((2500, 4), (1000, 5), (3000, 7))))
    want = _np(sharded_map.reshard_host(
        voxel_map.VoxelMap(**{f: jnp.asarray(v) for f, v in a.items()}), _jcfg(), n_shards))
    got = tsm.reshard_host(a, CFG, n_shards)
    _slot_equal(_np(got), want)
    assert (int(want["overflow"]) > 0) == band
    if not band:
        _slot_equal(_np(tsm.reshard_host(got, CFG, n_shards)), _np(got))


def test_local_slab_gather_roundtrip(ranks, jax_side):
    """JAX's sharded map carried into the ranks by `local_slab` and back by
    `gather_slabs`: bit-equal; and queried there, JAX's k-NN."""
    for res in ranks:
        _slot_equal(res["jax_roundtrip"], jax_side["insert"])
        np.testing.assert_array_equal(res["jax_knn"]["d2"], ranks[0]["jax_knn"]["d2"])
    # JAX's map holds the first insert's points: the single-device scan
    m = _single(((2000, 0), (1500, 1)))
    q, _ = ranks_mod.points(256, 3, lo=-6.0, hi=6.0)
    d2, _, _ = tvm.brute_knn(tvm.SubmapView(xyz=m.xyz, ring=None, valid=m.valid),
                             torch.from_numpy(q), 8)
    np.testing.assert_allclose(ranks[0]["jax_knn"]["d2"], d2.numpy(), rtol=1e-5, atol=1e-6)
