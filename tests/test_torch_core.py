"""Port parity: core/se3 and core/pca (PyTorch) against the JAX package on
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarslam_tpu.core import pca as jpca
from lidarslam_tpu.core import se3 as jse3
from lidarslam_tpu_torch.core import pca as tpca
from lidarslam_tpu_torch.core import se3 as tse3

ATOL_SE3 = 1e-6   # float32 trig/matmul, different op order
ATOL_PCA = 1e-5   # float32, the same closed form


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-20, 20, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1)),
                           rng.uniform(-1.4, 1.4, (n, 1)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_numpy_helpers_match():
    for p in _poses(20, 0):
        np.testing.assert_array_equal(tse3.pose_to_hmat(p), jse3.pose_to_hmat(p))
        H = jse3.pose_to_hmat(p)
        np.testing.assert_array_equal(tse3.hmat_to_pose(H), jse3.hmat_to_pose(H))
        np.testing.assert_array_equal(tse3.hmat_inverse(H), jse3.hmat_inverse(H))
    a, b = (jse3.pose_to_hmat(p) for p in _poses(2, 1))
    for t in (0.3, 1.7, -0.4):
        np.testing.assert_allclose(tse3.interpolate_hmat(a, b, t, 0.0, 1.0),
                                   jse3.interpolate_hmat(a, b, t, 0.0, 1.0),
                                   atol=1e-12)


def test_device_helpers_match():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-30, 30, (200, 3)).astype(np.float32)
    for pa, pb in zip(_poses(10, 3), _poses(10, 4)):
        pa32, pb32 = pa.astype(np.float32), pb.astype(np.float32)
        ta, tb = torch.from_numpy(pa32), torch.from_numpy(pb32)
        ja, jb = jnp.asarray(pa32), jnp.asarray(pb32)
        _close(tse3.japply_pose(ta, torch.from_numpy(pts)),
               jse3.japply_pose(ja, jnp.asarray(pts)), atol=2e-5)  # |x| ~ 50 m
        _close(tse3.jcompose_pose(ta, tb), jse3.jcompose_pose(ja, jb), ATOL_SE3 * 30)
        R, t = tse3.jpose_to_rt(ta)
        Rj, tj = jse3.jpose_to_rt(ja)
        _close(R, Rj, ATOL_SE3)
        _close(t, tj, 0)
        _close(tse3.jrt_to_pose(R, t), jse3.jrt_to_pose(Rj, tj), ATOL_SE3 * 30)


def _cases():
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 1, (64, 12, 3)) * rng.uniform(0.01, 3, (64, 1, 3))
    mask = rng.uniform(size=(64, 12)) < 0.8
    diag = np.zeros((4, 12, 3))
    diag[..., 0] = rng.normal(0, 2.0, (4, 12))      # axis-aligned spreads
    diag[..., 1] = rng.normal(0, 0.5, (4, 12))
    line = np.linspace(-1, 1, 12)[None, :, None] * rng.normal(0, 1, (4, 1, 3))  # rank 1
    iso = rng.normal(0, 1, (4, 12, 3))               # near-repeated eigenvalues
    iso = np.concatenate([iso, -iso[:, :6]], axis=1)[:, :12]
    plane = rng.normal(0, 1, (4, 12, 3)) * np.array([1.0, 1.0, 0.0])  # repeated-ish
    all_pts = np.concatenate([pts, diag, line, iso, plane]).astype(np.float32)
    all_mask = np.concatenate([mask, np.ones((16, 12), bool)])
    all_mask[0] = False                               # empty neighbourhood
    return all_pts, all_mask


def test_masked_cov6_and_eigh6_match():
    """Random neighbourhoods, including near-degenerate spectra. Eigenvalues
    are compared relative to the matrix scale (the closed form works on
    A / max|a_ij|); an eigenvector is compared only where its eigenvalue is
    separated from the others, since within a repeated eigenspace any unit
    vector is right and float32 rounding picks one. The exactly degenerate
    branches are pinned by test_eigh6_degenerate_branches."""
    pts, mask = _cases()
    mt, ct, nt = tpca.masked_cov6(torch.from_numpy(pts), torch.from_numpy(mask))
    mj, cj, nj = jpca.masked_cov6(jnp.asarray(pts), jnp.asarray(mask))
    _close(mt, mj, ATOL_PCA)
    _close(nt, nj, 0)
    for a, b in zip(ct, cj):
        _close(a, b, ATOL_PCA)
    (lt, vt) = tpca.eigh6(ct)
    (lj, vj) = jpca.eigh6(cj)
    scale = np.maximum(np.max(np.abs(np.stack([c.numpy() for c in ct])), axis=0), 1e-12)
    lam = np.stack([l.numpy() for l in lt]) / scale
    lam_j = np.stack([np.asarray(l) for l in lj]) / scale
    # eigenvector error grows as eps / gap: compare where the gap is >= 10%
    gap_lo, gap_hi = lam[1] - lam[0] > 0.1, lam[2] - lam[1] > 0.1
    # a repeated eigenvalue is only determined to ~sqrt(float32 eps) by the
    # trigonometric method (the arccos near +-1); the trace stays exact
    np.testing.assert_allclose(lam.sum(0), lam_j.sum(0), atol=ATOL_PCA, rtol=0)
    np.testing.assert_allclose(lam, lam_j, atol=1e-3, rtol=0)
    sep_all = gap_lo & gap_hi
    np.testing.assert_allclose(lam[:, sep_all], lam_j[:, sep_all], atol=ATOL_PCA, rtol=0)
    for sep, va, vb in ((gap_lo, vt[0], vj[0]), (gap_lo & gap_hi, vt[1], vj[1]),
                        (gap_hi, vt[2], vj[2])):
        assert sep.sum() > 25
        for a, b in zip(va, vb):
            np.testing.assert_allclose(a.numpy()[sep], np.asarray(b)[sep],
                                       atol=ATOL_PCA, rtol=0)


@pytest.mark.parametrize("c6", [
    (2.0, 0.0, 0.0, 1.0, 0.0, 3.0),      # diagonal
    (1.0, 0.0, 0.0, 1.0, 0.0, 1.0),      # triple eigenvalue
    (1.0, 1.0, 1.0, 1.0, 1.0, 1.0),      # rank 1
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),      # zero
    (2.0, 0.5, 0.0, 2.0, 0.0, 1.0),      # repeated top pair
])
def test_eigh6_degenerate_branches(c6):
    t = tpca.eigh6(tuple(torch.tensor([v], dtype=torch.float32) for v in c6))
    j = jpca.eigh6(tuple(jnp.asarray([v], jnp.float32) for v in c6))
    for a, b in zip(t[0], j[0]):
        _close(a, b, ATOL_PCA)
    for va, vb in zip(t[1], j[1]):
        for a, b in zip(va, vb):
            _close(a, b, ATOL_PCA)


def test_line_fit_and_distance_match():
    pts, mask = _cases()
    pt, dt, lt, nt = tpca.line_fit(torch.from_numpy(pts), torch.from_numpy(mask))
    pj, dj, lj, nj = jpca.line_fit(jnp.asarray(pts), jnp.asarray(mask))
    lam = lt.numpy()
    sep = (lam[:, 2] - lam[:, 1]) > 0.1 * np.abs(lam).max(axis=1)  # well-separated direction
    assert sep.sum() > 25
    _close(pt, pj, ATOL_PCA)
    _close(nt, nj, 0)
    np.testing.assert_allclose(dt.numpy()[sep], np.asarray(dj)[sep], atol=ATOL_PCA)
    d2t = tpca.sq_dist_to_line(torch.from_numpy(pts), pt[:, None], dt[:, None])
    d2j = jpca.sq_dist_to_line(jnp.asarray(pts), pj[:, None], dj[:, None])
    np.testing.assert_allclose(d2t.numpy()[sep], np.asarray(d2j)[sep], atol=1e-4)
