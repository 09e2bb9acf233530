"""The port's k-NN: the plain PyTorch version against the JAX package's
exact brute force and its Pallas kernel (interpret mode). The CUDA kernel
against the plain version is in tests/test_torch_cuda.py (GPU only)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarslam_tpu.ops import pallas_knn
from lidarslam_tpu.ops import voxel_map as jvm
from lidarslam_tpu_torch.ops import cuda_knn
from lidarslam_tpu_torch.ops import voxel_map as tvm
from test_torch_cuda import RADIUS, knn_scene

PACKED_RTOL = 2.0 ** -12   # the Pallas kernel's packed d2 drops low mantissa bits


@pytest.fixture(scope="module")
def scene():
    return knn_scene()


def _plain(xyz, valid, queries, k, q_valid=None):
    view = tvm.SubmapView(xyz=torch.from_numpy(xyz), ring=None,
                          valid=torch.from_numpy(valid))
    qv = None if q_valid is None else torch.from_numpy(q_valid)
    d2, idx, nbr = tvm.brute_knn(view, torch.from_numpy(queries), k, q_valid=qv)
    return d2.numpy(), idx.numpy(), nbr.numpy()


@pytest.mark.parametrize("k", [1, 5, 10])
def test_plain_matches_jax_exact_brute(scene, k):
    xyz, valid, queries, _ = scene
    view = jvm.SubmapView(xyz=jnp.asarray(xyz), ring=jnp.zeros(len(xyz), jnp.int32),
                          valid=jnp.asarray(valid))
    jd, ji, jn = jvm.brute_knn(view, jnp.asarray(queries), k, recall_target=1.0,
                               use_pallas=False, with_coords=True)
    td, ti, tn = _plain(xyz, valid, queries, k)
    jd, ji, jn = np.asarray(jd), np.asarray(ji), np.asarray(jn)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tn, jn)


def test_plain_missing_neighbours_and_dead_queries():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    valid = np.zeros(50, bool)
    valid[[3, 17, 40]] = True
    queries = rng.uniform(-5, 5, (20, 3)).astype(np.float32)
    q_valid = np.arange(20) % 4 != 0
    d2, idx, nbr = _plain(xyz, valid, queries, 6, q_valid)
    live = q_valid
    assert np.isfinite(d2[live, :3]).all() and np.isinf(d2[live, 3:]).all()
    assert set(np.unique(idx[live, :3])) <= {3, 17, 40}
    assert (np.diff(d2[live, :3], axis=1) >= 0).all()
    assert (idx[live, 3:] == 0).all() and (nbr[live, 3:] == 0).all()
    assert np.isinf(d2[~live]).all() and (idx[~live] == 0).all() and (nbr[~live] == 0).all()


@pytest.mark.parametrize("M", [7, cuda_knn.PLAIN_CHUNK + 900, 2 * cuda_knn.PLAIN_CHUNK])
def test_plain_ties_go_to_the_lower_slot(M):
    """On an integer grid with duplicated points (many equal d2), across
    chunk boundaries: plain_knn is the (d2, slot) order of a numpy lexsort."""
    rng = np.random.default_rng(M)
    xyz = np.round(rng.normal(0, 3, (M, 3))).astype(np.float32)
    xyz[M // 2:M // 2 + 3] = xyz[:3]
    valid = rng.uniform(size=M) < 0.7
    queries = (np.round(rng.normal(0, 3, (40, 3))) + 0.5 * (rng.uniform(size=(40, 1)) < 0.5)
               ).astype(np.float32)
    q_valid = rng.uniform(size=40) < 0.8
    k = 10
    d2, idx, nbr = (a.numpy() for a in cuda_knn.plain_knn(
        torch.from_numpy(xyz), torch.from_numpy(valid), torch.from_numpy(queries), k,
        q_valid=torch.from_numpy(q_valid)))
    diff = queries[:, None, :] - xyz[None, :, :]
    want = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    want = np.where(valid[None, :], want + diff[..., 2] * diff[..., 2], np.inf)
    for q in range(40):
        order = np.lexsort((np.arange(M), want[q]))[:k]
        wd = np.full(k, np.inf, np.float32)
        wi = np.zeros(k, np.int32)
        if q_valid[q]:
            n = min(k, int(np.isfinite(want[q]).sum()))
            wd[:n], wi[:n] = want[q][order[:n]], order[:n]
        np.testing.assert_array_equal(d2[q], wd)
        np.testing.assert_array_equal(idx[q], wi)
        np.testing.assert_array_equal(nbr[q], np.where(np.isfinite(wd)[:, None], xyz[wi], 0.0))


def _rank_agreement(a, b):
    return float((a == b).mean())


@pytest.mark.parametrize("k", [5, 10])
def test_plain_agrees_with_pallas_kernel(scene, k):
    """The Pallas kernel is approximate: depth-2 lane buckets (slot mod 64)
    lose a neighbour when three of the true k share a bucket, and its
    packed d2 drops the low mantissa bits. Its own contract
    (tests/test_pallas_knn.py) is exact 1-NN and recall >= 0.99 at k=10;
    against it the plain version must be exact: the same 1-NN, never a
    farther k-th neighbour, equal slots and coordinates wherever the
    Pallas kernel found the same neighbour, and d2 within 2^-12."""
    xyz, valid, queries, _ = scene
    pd, pi, pn = pallas_knn.bucketed_knn(jnp.asarray(xyz), jnp.asarray(valid),
                                         jnp.asarray(queries), k, interpret=True,
                                         with_coords=True)
    pd, pi, pn = np.asarray(pd), np.asarray(pi), np.asarray(pn)
    td, ti, tn = _plain(xyz, valid, queries, k)
    np.testing.assert_array_equal(ti[:, 0], pi[:, 0])                  # 1-NN exact
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(ti, pi)])
    assert recall >= 0.99
    assert _rank_agreement(ti, pi) >= 0.99                             # slot by slot
    assert (td <= pd * (1 + PACKED_RTOL)).all()                        # plain is exact
    same = ti == pi
    np.testing.assert_allclose(pd[same], td[same], rtol=PACKED_RTOL, atol=0)
    np.testing.assert_array_equal(tn[same], pn[same])


def test_pruning_loses_no_neighbour_within_radius(scene):
    """With the matcher's prune radius and dead queries: the pruned Pallas
    kernel keeps what its unpruned scan finds within the radius, the plain
    version is never farther at any rank, and the port returns +inf for dead
    queries."""
    xyz, valid, queries, q_valid = scene
    k = 10
    args = (jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(queries), k)
    rd, ri = (np.asarray(a) for a in pallas_knn.bucketed_knn(
        *args, interpret=True, prune_radius=RADIUS, q_valid=jnp.asarray(q_valid)))
    ud, ui = (np.asarray(a) for a in pallas_knn.bucketed_knn(*args, interpret=True))
    td, ti, _ = _plain(xyz, valid, queries, k, q_valid)
    live = q_valid
    inside = np.isfinite(ud) & (ud <= RADIUS ** 2) & live[:, None]
    assert inside[live].mean() > 0.5
    np.testing.assert_array_equal(ri[inside], ui[inside])
    # the plain version is exact: rank by rank never farther than the pruned
    # kernel, and it holds all but the kernel's bucket misses (recall)
    assert (td[live] <= rd[live] * (1 + PACKED_RTOL)).all()
    near = np.isfinite(td) & (td <= RADIUS ** 2)
    kept = [len(set(ti[q][near[q]]) & set(ri[q])) for q in np.flatnonzero(live)]
    assert sum(kept) >= 0.99 * near[live].sum()
    assert np.isinf(td[~live]).all()


def _numpy_index(xyz, valid):
    """prepare_map's fields, by numpy loops: (pts (NS*SB, 4), lo (NS, 4),
    hi (NS, 4))."""
    sb = cuda_knn.SUB_BLOCK
    ns = max(-(-len(xyz) // sb), 1)
    pts = np.full((ns * sb, 4), np.inf, np.float32)
    pts[:, 3] = 0.0
    pts[:len(xyz)][valid, :3] = xyz[valid]
    lo = np.zeros((ns, 4), np.float32)
    hi = np.zeros((ns, 4), np.float32)
    for b in range(ns):
        sel = np.zeros(len(xyz), bool)
        sel[b * sb:(b + 1) * sb] = True
        p = xyz[sel & valid]
        lo[b, :3] = p.min(0) if len(p) else np.inf
        hi[b, :3] = p.max(0) if len(p) else -np.inf
    return pts, lo, hi


def test_prepare_map_blocks():
    """The packed slots and sub-block AABBs against numpy on a map that is
    a multiple of neither the sub-block nor a 1024-slot block, with one
    empty 1024-slot block."""
    rng = np.random.default_rng(3)
    block = 1024
    M = 2 * block + 100
    xyz = rng.uniform(-9, 9, (M, 3)).astype(np.float32)
    valid = rng.uniform(size=M) < 0.6
    valid[block:2 * block] = False   # one empty block
    idx = cuda_knn.prepare_map(torch.from_numpy(xyz), torch.from_numpy(valid))
    ns = -(-M // cuda_knn.SUB_BLOCK)
    assert idx.n_sub == ns and idx.pts.shape == (ns * cuda_knn.SUB_BLOCK, 4)
    assert all(t.is_contiguous() for t in idx)
    pts, lo, hi = _numpy_index(xyz, valid)
    np.testing.assert_array_equal(idx.pts.numpy(), pts)
    np.testing.assert_array_equal(idx.sub_lo.numpy(), lo)
    np.testing.assert_array_equal(idx.sub_hi.numpy(), hi)
    empty = slice(block // cuda_knn.SUB_BLOCK, 2 * block // cuda_knn.SUB_BLOCK)
    assert np.isposinf(idx.sub_lo.numpy()[empty, :3]).all()
    assert np.isneginf(idx.sub_hi.numpy()[empty, :3]).all()


@pytest.mark.parametrize("M", [1, cuda_knn.SUB_BLOCK, 3 * cuda_knn.SUB_BLOCK - 5])
def test_prepare_map_sub_blocks_hold_their_valid_slots(M):
    """Every valid slot lies in its sub-block's AABB and each face of the
    AABB touches one; padding and invalid slots are +inf."""
    rng = np.random.default_rng(M)
    xyz = rng.normal(0, 4, (M, 3)).astype(np.float32)
    valid = rng.uniform(size=M) < 0.5
    valid[0] = True
    idx = cuda_knn.prepare_map(torch.from_numpy(xyz), torch.from_numpy(valid))
    pts, lo, hi = _numpy_index(xyz, valid)
    np.testing.assert_array_equal(idx.pts.numpy(), pts)
    np.testing.assert_array_equal(idx.sub_lo.numpy(), lo)
    np.testing.assert_array_equal(idx.sub_hi.numpy(), hi)
    sb = np.arange(M) // cuda_knn.SUB_BLOCK
    got_lo, got_hi = idx.sub_lo.numpy()[sb, :3], idx.sub_hi.numpy()[sb, :3]
    assert ((got_lo <= xyz) & (xyz <= got_hi))[valid].all()
    assert np.isinf(idx.pts.numpy()[M:, :3]).all()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bound_pairs_matches_numpy(scene):
    """chip_smoke's count of the bound's pairs against a brute numpy count:
    every (live query, valid slot) whose 64-slot sub-block box lies within
    the radius."""
    xyz, valid, queries, q_valid = scene
    xyz, valid = xyz[:3000], valid[:3000]        # not a multiple of the sub-block
    index = cuda_knn.prepare_map(torch.from_numpy(xyz), torch.from_numpy(valid))
    got = _chip_smoke().bound_pairs(index, torch.from_numpy(queries),
                                    torch.from_numpy(q_valid), RADIUS)
    B = cuda_knn.SUB_BLOCK
    want = 0
    for b in range(0, len(xyz), B):
        p = xyz[b:b + B][valid[b:b + B]]
        if not len(p):
            continue
        lo, hi = p.min(0), p.max(0)
        for q in queries[q_valid]:
            g = np.maximum(np.maximum(lo - q, q - hi), 0).astype(np.float32)
            if g[0] * g[0] + g[1] * g[1] + g[2] * g[2] <= RADIUS ** 2:
                want += len(p)
    assert got == want > 0


def test_knn_bound_counts_what_the_function_moves(scene):
    """chip_smoke's bound without a radius: every live query against every
    valid slot; its bytes are the x, y, z of the valid slots and live
    queries, a validity bit per slot and per query and 20 B per output
    entry, not the index's +inf padding slots or its sub-block boxes."""
    xyz, valid, queries, q_valid = scene
    valid = valid & (np.arange(len(valid)) % 7 == 0)     # a sparse map
    index = cuda_knn.prepare_map(torch.from_numpy(xyz), torch.from_numpy(valid))
    k = 5
    b = _chip_smoke().knn_bound(index, torch.from_numpy(queries), torch.from_numpy(q_valid),
                                k, None)
    n_slots, Q = index.pts.shape[0], len(queries)
    assert b["pairs"] == int(valid.sum()) * int(q_valid.sum()) > 0
    assert b["bytes"] == (12 * (int(valid.sum()) + int(q_valid.sum()))
                          + -(-(n_slots + Q) // 8) + 20 * Q * k)
    assert b["us"] == max(b["ops_us"], b["bytes_us"])
    assert b["by"] == ("operations" if b["ops_us"] >= b["bytes_us"] else "bytes")


@pytest.mark.parametrize("radius", [1.0, RADIUS, None])
def test_plain_work_list_keeps_every_pair_within_radius(scene, radius):
    """No (tile, sub-block) holding a (live query, valid slot) pair within
    the radius is missing from the plan's work list, which lists only
    non-empty sub-blocks of tiles with a live query, and all of them
    without a radius."""
    xyz, valid, queries, q_valid = scene
    x, v = torch.from_numpy(xyz), torch.from_numpy(valid)
    q, qv = torch.from_numpy(queries), torch.from_numpy(q_valid)
    index = cuda_knn.prepare_map(x, v)
    r2 = np.inf if radius is None else radius ** 2
    order = cuda_knn.spatial_order(q, radius or 1.0, qv)
    keep = cuda_knn.plain_work_list(index, q, qv, order, r2).numpy()
    T, ns = keep.shape
    assert T == -(-len(queries) // cuda_knn.TILE) and ns == index.n_sub
    o = order.numpy()
    tile_of = np.empty(len(queries), int)
    tile_of[o] = np.arange(len(queries)) // cuda_knn.TILE
    sub_of = np.arange(len(xyz)) // cuda_knn.SUB_BLOCK
    nonempty = np.bincount(sub_of[valid], minlength=ns) > 0
    live_tile = np.bincount(tile_of[q_valid], minlength=T) > 0
    assert not (keep & ~(nonempty[None, :] & live_tile[:, None])).any()
    if radius is None:
        np.testing.assert_array_equal(keep, nonempty[None, :] & live_tile[:, None])
        return
    d2 = ((queries[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    qi, si = np.nonzero((d2 <= r2) & q_valid[:, None] & valid[None, :])
    need = np.zeros_like(keep)
    need[tile_of[qi], sub_of[si]] = True
    assert need.any() and not (need & ~keep).any()


def test_spatial_order_is_morton_with_dead_last():
    """The scan order: a stable sort of the 30-bit Morton code of each live
    query's cell from the live queries' lower corner (bits interleaved x,
    y, z from the lowest), dead queries last in row order."""
    rng = np.random.default_rng(4)
    Q, cell = 300, 5.0
    queries = rng.uniform(-3000, 3000, (Q, 3)).astype(np.float32)   # some cells clamp
    q_valid = rng.uniform(size=Q) < 0.7
    queries[~q_valid] = np.nan                                      # dead rows: any value
    got = cuda_knn.spatial_order(torch.from_numpy(queries), cell,
                                 torch.from_numpy(q_valid)).numpy()
    lo = queries[q_valid].min(0)
    cells = np.clip(((queries[q_valid] - lo) * np.float32(1 / cell)).astype(np.int64), 0, 1023)
    code = np.zeros(Q, np.int64)
    for bit in range(10):
        for axis in range(3):
            code[q_valid] |= ((cells[:, axis] >> bit) & 1) << (3 * bit + axis)
    code[~q_valid] = 2**31 - 1
    np.testing.assert_array_equal(got, np.argsort(code, kind="stable"))


def test_dispatch_cpu_plain_and_no_fallback():
    xyz = torch.zeros(10, 3)
    valid = torch.ones(10, dtype=torch.bool)
    before = cuda_knn.LAUNCHES
    d2, idx, nbr = cuda_knn.knn(xyz, valid, torch.ones(4, 3), 2)
    assert cuda_knn.LAUNCHES == before and d2.shape == (4, 2)
    with pytest.raises(ValueError):
        cuda_knn.knn(xyz, valid, torch.ones(4, 3, device="meta"), 2)
