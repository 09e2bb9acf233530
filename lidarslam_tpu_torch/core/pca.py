"""Batched closed-form symmetric 3x3 eigendecomposition and masked PCA
(PyTorch port of `lidarslam_tpu/core/pca.py`).

Same conventions and the same closed form as the JAX package: normalized
covariance, eigenvalues ascending, eigenvector v0 pairs with l0 (plane
normal) and v2 with l2 (line direction). Eigenvalues by the trigonometric
(Smith) method on the scaled matrix, eigenvectors from the largest cross
product of the rows of (A - lam I). The degenerate branches (near-diagonal
input, repeated eigenvalues) are load-bearing for the matcher's gates, so
they are kept as written instead of calling `torch.linalg.eigh`.

Structure-of-arrays: six covariance planes in, three eigenvalue planes and
three eigenvectors as (x, y, z) plane tuples out.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def masked_cov6(pts, mask):
    """Masked mean and normalized covariance, SoA form.

    Args:
      pts: (..., N, 3) points.
      mask: (..., N) boolean/float validity.

    Returns:
      (mean (..., 3), c6 = (c00, c01, c02, c11, c12, c22) each (...,),
       count (...,)) — covariances are zero where count == 0.
    """
    m = mask.to(pts.dtype)
    count = torch.sum(m, dim=-1)
    denom = torch.clamp(count, min=1.0)
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    mx = torch.sum(px * m, dim=-1) / denom
    my = torch.sum(py * m, dim=-1) / denom
    mz = torch.sum(pz * m, dim=-1) / denom
    cx = (px - mx[..., None]) * m
    cy = (py - my[..., None]) * m
    cz = (pz - mz[..., None]) * m
    c6 = (torch.sum(cx * cx, dim=-1) / denom,
          torch.sum(cx * cy, dim=-1) / denom,
          torch.sum(cx * cz, dim=-1) / denom,
          torch.sum(cy * cy, dim=-1) / denom,
          torch.sum(cy * cz, dim=-1) / denom,
          torch.sum(cz * cz, dim=-1) / denom)
    mean = torch.stack([mx, my, mz], dim=-1)
    return mean, c6, count


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _eigvec6(a00, a01, a02, a11, a12, a22, lam):
    """Unit eigenvector (3 component planes) for eigenvalue plane lam."""
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    c01 = _cross(m00, a01, a02, a01, m11, a12)
    c02 = _cross(m00, a01, a02, a02, a12, m22)
    c12 = _cross(a01, m11, a12, a02, a12, m22)
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = n02 >= n12
    v = tuple(torch.where(use01, c01[i], torch.where(use02, c02[i], c12[i]))
              for i in range(3))
    n = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    # degenerate (repeated eigenvalue): any unit axis; callers gate on
    # eigenvalue ratios so this choice is not load-bearing
    ok = n > 1e-12
    inv = 1.0 / torch.clamp(n, min=_EPS)
    return (torch.where(ok, v[0] * inv, 1.0),
            torch.where(ok, v[1] * inv, 0.0),
            torch.where(ok, v[2] * inv, 0.0))


def eigh6(c6):
    """Symmetric 3x3 eigendecomposition from six covariance planes.

    Returns (lams = (l0, l1, l2) ascending, vecs = (v0, v1, v2) unit
    eigenvectors, each a (vx, vy, vz) tuple of planes; v0 pairs with l0)."""
    c00, c01, c02, c11, c12, c22 = c6

    scale = torch.maximum(
        torch.maximum(torch.maximum(c00.abs(), c11.abs()), c22.abs()),
        torch.maximum(torch.maximum(c01.abs(), c02.abs()), c12.abs()))
    scale = torch.clamp(scale, min=_EPS)
    a00, a01, a02 = c00 / scale, c01 / scale, c02 / scale
    a11, a12, a22 = c11 / scale, c12 / scale, c22 / scale

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))

    safe_p = torch.clamp(p, min=_EPS)
    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0

    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo

    # nearly diagonal matrices: eigenvalues = diagonal, sorted
    is_diag = p1 < _EPS
    dmin = torch.minimum(torch.minimum(a00, a11), a22)
    dmax = torch.maximum(torch.maximum(a00, a11), a22)
    dmid = a00 + a11 + a22 - dmin - dmax
    l0 = torch.where(is_diag, dmin, lam_lo)
    l1 = torch.where(is_diag, dmid, lam_mid)
    l2 = torch.where(is_diag, dmax, lam_hi)

    v_lo = _eigvec6(a00, a01, a02, a11, a12, a22, l0)
    v_hi = _eigvec6(a00, a01, a02, a11, a12, a22, l2)
    # orthogonalize v_lo against v_hi to guarantee an orthonormal frame
    dot = v_lo[0] * v_hi[0] + v_lo[1] * v_hi[1] + v_lo[2] * v_hi[2]
    u = tuple(v_lo[i] - dot * v_hi[i] for i in range(3))
    un = torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
    alt = _any_orthonormal6(v_hi)
    inv = 1.0 / torch.clamp(un, min=_EPS)
    ok = un > 1e-6
    v_lo = tuple(torch.where(ok, u[i] * inv, alt[i]) for i in range(3))
    v_mid = _cross(*v_hi, *v_lo)

    # nearly diagonal: identity columns permuted by the stable argsort of
    # the diagonal (ties -> lower index first for the min slot, higher
    # index last for the max slot)
    i_lo = torch.where((a00 <= a11) & (a00 <= a22), 0,
                       torch.where(a11 <= a22, 1, 2))
    i_hi = torch.where((a22 >= a00) & (a22 >= a11), 2,
                       torch.where(a11 >= a00, 1, 0))
    i_mid = 3 - i_lo - i_hi

    def pick(v, i):
        return tuple(torch.where(is_diag, (i == c).to(l0.dtype), v[c])
                     for c in range(3))

    v_lo = pick(v_lo, i_lo)
    v_mid = pick(v_mid, i_mid)
    v_hi = pick(v_hi, i_hi)
    return (l0 * scale, l1 * scale, l2 * scale), (v_lo, v_mid, v_hi)


def _any_orthonormal6(v):
    """A unit vector orthogonal to unit vector v = (vx, vy, vz) planes."""
    ax_, ay, az = v[0].abs(), v[1].abs(), v[2].abs()
    i = torch.where((ax_ <= ay) & (ax_ <= az), 0, torch.where(ay <= az, 1, 2))
    e = tuple((i == c).to(v[0].dtype) for c in range(3))
    dot = e[0] * v[0] + e[1] * v[1] + e[2] * v[2]
    u = tuple(e[c] - dot * v[c] for c in range(3))
    un = torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
    inv = 1.0 / torch.clamp(un, min=_EPS)
    return tuple(u[c] * inv for c in range(3))


# -----------------------------------------------------------------------------
# (..., 3, 3) API wrappers
# -----------------------------------------------------------------------------

def masked_mean_and_cov(pts, mask):
    """Masked mean and normalized covariance.

    Args:
      pts: (..., N, 3) points.
      mask: (..., N) boolean/float validity.

    Returns:
      mean (..., 3), cov (..., 3, 3), count (...,) — cov is zero where
      count == 0.
    """
    mean, (c00, c01, c02, c11, c12, c22), count = masked_cov6(pts, mask)
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c01, c11, c12], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return mean, torch.stack([row0, row1, row2], dim=-2), count


def eigh_3x3(A):
    """Batched symmetric 3x3 eigendecomposition (the closed form of `eigh6`).

    Args:
      A: (..., 3, 3) symmetric matrices.

    Returns:
      (eigvals (..., 3) ascending, eigvecs (..., 3, 3) with eigvecs[..., :, i]
      the unit eigenvector of eigvals[..., i]).
    """
    c6 = (A[..., 0, 0],
          0.5 * (A[..., 0, 1] + A[..., 1, 0]),
          0.5 * (A[..., 0, 2] + A[..., 2, 0]),
          A[..., 1, 1],
          0.5 * (A[..., 1, 2] + A[..., 2, 1]),
          A[..., 2, 2])
    (l0, l1, l2), (v0, v1, v2) = eigh6(c6)
    lam = torch.stack([l0, l1, l2], dim=-1)
    V = torch.stack([torch.stack(v0, dim=-1), torch.stack(v1, dim=-1),
                     torch.stack(v2, dim=-1)], dim=-1)
    return lam, V


def line_fit(pts, mask):
    """Batched PCA line fit: position (centroid), direction (largest eigvec).

    Returns (position (...,3), direction (...,3), eigvals (...,3), count)."""
    mean, c6, count = masked_cov6(pts, mask)
    (l0, l1, l2), (_, _, v2) = eigh6(c6)
    return mean, torch.stack(v2, dim=-1), torch.stack([l0, l1, l2], dim=-1), count


def sq_dist_to_line(pts, position, direction):
    """Squared distance of (..., 3) points to line(position, direction)."""
    d = pts - position
    c = torch.linalg.cross(d, direction.expand_as(d))
    return torch.sum(c * c, dim=-1)
