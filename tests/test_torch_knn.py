"""The port's k-NN: the plain PyTorch version against the JAX package's
exact brute force and its Pallas kernel (interpret mode). The CUDA kernel
against the plain version is in tests/test_torch_cuda.py (GPU only)."""

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


def test_prepare_map_blocks():
    rng = np.random.default_rng(3)
    M = 2 * cuda_knn.MAP_BLOCK + 100
    xyz = torch.from_numpy(rng.uniform(-9, 9, (M, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=M) < 0.6)
    valid[cuda_knn.MAP_BLOCK:2 * cuda_knn.MAP_BLOCK] = False   # one empty block
    idx = cuda_knn.prepare_map(xyz, valid)
    assert idx.n_blocks == 3 and idx.px.shape == (3 * cuda_knn.MAP_BLOCK,)
    planes = torch.stack([idx.px, idx.py, idx.pz], dim=1)
    assert torch.equal(planes[:M][valid], xyz[valid])
    assert torch.isinf(planes[:M][~valid]).all() and torch.isinf(planes[M:]).all()
    assert torch.isinf(idx.bmin[1]).all() and torch.isinf(idx.bmax[1]).all()
    for b in (0, 2):
        sl = slice(b * cuda_knn.MAP_BLOCK, min((b + 1) * cuda_knn.MAP_BLOCK, M))
        pts = xyz[sl][valid[sl]]
        assert torch.equal(idx.bmin[b], pts.amin(0)) and torch.equal(idx.bmax[b], pts.amax(0))


def test_dispatch_cpu_plain_and_no_fallback():
    xyz = torch.zeros(10, 3)
    valid = torch.ones(10, dtype=torch.bool)
    before = cuda_knn.LAUNCHES
    d2, idx, nbr = cuda_knn.knn(xyz, valid, torch.ones(4, 3), 2)
    assert cuda_knn.LAUNCHES == before and d2.shape == (4, 2)
    with pytest.raises(ValueError):
        cuda_knn.knn(xyz, valid, torch.ones(4, 3, device="meta"), 2)
