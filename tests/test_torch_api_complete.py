"""The port against the JAX package, name by name.

An `ast` scan of every module of `lidarslam_tpu/` lists its public
top-level definitions (functions, classes, assigned names, and
`__version__`) and each public class's public methods and properties
(not its fields: a NamedTuple's fields are its layout, which the port
may change, e.g. `SubmapCache.index` for the Pallas map planes); the
port module of the same path must define each one (an import counts, so a
name may be re-exported), except the entries of `ALLOWED`, each with the
ROADMAP reason the port does without it. Beside it, the names the scan
found missing when the port was completed are held against the JAX
functions on seeded inputs.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "lidarslam_tpu"
PORT_PKG = ROOT / "lidarslam_tpu_torch"

# (module path, name or None for the whole module) -> why the port has none
ALLOWED = {
    ("ops/pallas_knn.py", None): "the Pallas TPU kernel; its port is ops/cuda_knn.py with "
                                 "csrc/knn.cu (ROADMAP Queue 2, K1)",
    ("utils/profiling.py", "find_xplane"): "the port reads torch.profiler's Chrome trace, "
                                           "found by find_trace, not an XLA xplane "
                                           "(ROADMAP Queue 1, items 1-4)",
    ("parallel/sharded.py", "AXIS"): "a shard_map mesh axis name; the port's Mesh is the "
                                     "ranks of a process group (ROADMAP Queue 1, item 9)",
    ("parallel/sharded_map.py", "AXIS"): "the same shard_map axis name (ROADMAP Queue 1, item 9)",
    ("parallel/sharded_map.py", "map_spec"): "a shard_map PartitionSpec tree; each rank "
                                             "holds its slab (ROADMAP Queue 1, item 9)",
}


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__version__"


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [e.id for t in targets for e in ast.walk(t) if isinstance(e, ast.Name)]


def _defined(path: Path, with_imports: bool) -> set:
    """The names a module defines at its top level and in its classes
    ("Class.method"), public ones only unless `with_imports` (the port
    side, where any definition or import counts)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    if with_imports:
        return out
    return {n for n in out if all(_public(part) for part in n.split("."))}


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_defines_every_public_name(module):
    if (module, None) in ALLOWED:
        assert not (PORT_PKG / module).exists(), f"{module} is ported: drop its entry"
        return
    port = PORT_PKG / module
    assert port.is_file(), f"the port has no {module}"
    want = _defined(JAX_PKG / module, with_imports=False)
    allowed = {name for (mod, name) in ALLOWED if mod == module}
    have = _defined(port, with_imports=True)
    missing = sorted(want - have - allowed)
    assert not missing, f"lidarslam_tpu_torch/{module} lacks {missing}"
    stale = sorted(n for n in allowed if n not in want or n in have)
    assert not stale, f"allow-list entries of {module} no longer needed: {stale}"


def test_allow_list_names_existing_modules():
    for module, _ in ALLOWED:
        assert (JAX_PKG / module).is_file(), module
    assert all(reason.rstrip(")").split("(")[-1].startswith("ROADMAP")
               for reason in ALLOWED.values())


# ----------------------------------------------------------------------
# the names the completing slice added, against the JAX functions
# ----------------------------------------------------------------------

def test_version_is_the_jax_packages():
    import lidarslam_tpu
    import lidarslam_tpu_torch

    assert lidarslam_tpu_torch.__version__ == lidarslam_tpu.__version__ == "0.1.0"


FIELD_SETS = [
    (("x", "adjustedtime", "intensity", "laser_id"), ("verticalCorrection",)),
    (("adjustedtime", "intensity", "laser_id"), ()),
    (("Raw Timestamp", "Signal Photons", "Channel", "Range"), ("Altitude Angles",)),
    (("Raw Timestamp", "Signal Photons", "Channel"), ("Azimuth",)),
    (("Timestamp", "Intensity", "LaserID"), ()),
    (("Timestamp", "Intensity", "LaserID", "adjustedtime", "intensity", "laser_id"), ()),
    (("time", "intensity"), ()),
]


@pytest.mark.parametrize("fields,calib", FIELD_SETS)
def test_identify_input_arrays_matches_jax(fields, calib):
    from lidarslam_tpu.io import sensor_csv as jcsv

    from lidarslam_tpu_torch.io import sensor_csv as tcsv

    got = tcsv.identify_input_arrays(fields, calib)
    want = jcsv.identify_input_arrays(fields, calib)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want) and got._fields == want._fields
    assert [tuple(v) for v in tcsv._VENDORS] == [tuple(v) for v in jcsv._VENDORS]


@pytest.mark.parametrize("vendor", ["velodyne", "ouster", "hesai", "other"])
@pytest.mark.parametrize("change", [{}, {"edge_intensity_gap_threshold": 2e6,
                                         "neighbor_width": 6,
                                         "min_distance_to_sensor": 0.5},
                                    {"edge_intensity_gap_threshold": 50.0}])
def test_recommended_parameter_checks_match_jax(vendor, change):
    from lidarslam_tpu.config import ExtractorConfig as JExtractorConfig
    from lidarslam_tpu.io import sensor_csv as jcsv

    from lidarslam_tpu_torch.config import ExtractorConfig
    from lidarslam_tpu_torch.io import sensor_csv as tcsv

    got = tcsv.recommended_parameter_checks(
        vendor, dataclasses.replace(ExtractorConfig(), **change))
    want = jcsv.recommended_parameter_checks(
        vendor, dataclasses.replace(JExtractorConfig(), **change))
    assert got == want


def _cloud(seed, batch=64, n=24):
    """Seeded neighbourhoods: planar, linear and blob-shaped point sets
    with random validity (some empty)."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(batch, 3, 3))
    scales = rng.choice([0.01, 0.3, 1.0], size=(batch, 3))
    pts = np.einsum("bnk,bkj->bnj", rng.normal(size=(batch, n, 3)) * scales[:, None, :], axes)
    pts = (pts + rng.uniform(-20, 20, (batch, 1, 3))).astype(np.float32)
    mask = rng.uniform(size=(batch, n)) < 0.7
    mask[:3] = False
    return pts, mask


def test_masked_mean_and_cov_matches_jax():
    import jax.numpy as jnp
    from lidarslam_tpu.core import pca as jpca

    from lidarslam_tpu_torch.core import pca as tpca

    pts, mask = _cloud(0)
    mean, cov, count = tpca.masked_mean_and_cov(torch.from_numpy(pts), torch.from_numpy(mask))
    jm, jc, jn = (np.asarray(a) for a in jpca.masked_mean_and_cov(jnp.asarray(pts),
                                                                    jnp.asarray(mask)))
    scale = np.abs(jc).max()
    np.testing.assert_allclose(mean.numpy(), jm, atol=1e-5 * np.abs(jm).max(), rtol=0)
    np.testing.assert_allclose(cov.numpy(), jc, atol=1e-5 * scale, rtol=0)
    np.testing.assert_array_equal(count.numpy(), jn)
    assert cov.shape == (64, 3, 3) and not cov[:3].any()


def test_eigh_3x3_matches_jax():
    """Covariances of seeded neighbourhoods (distinct eigenvalues, where
    the closed forms agree to rounding; near repeated ones the two agree
    only to ~1e-4 of scale, ROADMAP Queue 3, F4): eigenvalues within 1e-5
    of the matrix scale, each eigenvector within 1e-4 up to its sign, and
    A V = V diag(l)."""
    import jax.numpy as jnp
    from lidarslam_tpu.core import pca as jpca

    from lidarslam_tpu_torch.core import pca as tpca

    pts, mask = _cloud(1)
    mask[:3] = True
    _, cov, _ = tpca.masked_mean_and_cov(torch.from_numpy(pts), torch.from_numpy(mask))
    lam, V = tpca.eigh_3x3(cov)
    jl, jV = (np.asarray(a) for a in jpca.eigh_3x3(jnp.asarray(cov.numpy())))
    scale = np.abs(cov.numpy()).max(axis=(1, 2))
    assert (np.abs(lam.numpy() - jl) <= 1e-5 * scale[:, None]).all()
    gaps = np.diff(jl, axis=1).min(axis=1) > 1e-3 * scale
    assert gaps.sum() > 40
    dots = np.abs(np.einsum("bki,bki->bi", V.numpy(), jV))[gaps]
    assert (1.0 - dots <= 1e-4).all(), (1.0 - dots).max()
    AV = cov.numpy() @ V.numpy()
    np.testing.assert_allclose(AV, V.numpy() * lam.numpy()[:, None, :],
                               atol=1e-4 * scale.max())


@pytest.mark.parametrize("shape", [(37,), (5, 130), (2, 3, 1024)])
def test_prefix_shift_matches_jax_exactly(shape):
    import jax.numpy as jnp
    from lidarslam_tpu.ops import prims as jprims

    from lidarslam_tpu_torch.ops import prims as tprims

    x = np.random.default_rng(len(shape)).integers(-1000, 1000, shape, dtype=np.int32)
    got = tprims.prefix_shift(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jprims.prefix_shift(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.cumsum(x, axis=-1))


def test_rev_segment_scan_matches_jax():
    """Sums, maxima and a 2-D payload over sorted runs: equal to JAX's."""
    import jax.numpy as jnp
    from lidarslam_tpu.ops import prims as jprims

    from lidarslam_tpu_torch.ops import prims as tprims
    from lidarslam_tpu_torch.ops import voxel_map as tvm

    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    a = rng.integers(-50, 50, 300).astype(np.int32)
    b = rng.normal(size=300).astype(np.float32)
    c = rng.normal(size=(300, 3)).astype(np.float32)
    got = tprims.rev_segment_scan(torch.from_numpy(seg), [
        (torch.from_numpy(a), torch.add, 0), (torch.from_numpy(b), torch.maximum, -np.inf),
        (torch.from_numpy(c), torch.add, 0.0)])
    want = jprims.rev_segment_scan(jnp.asarray(seg), [
        (jnp.asarray(a), jnp.add, 0), (jnp.asarray(b), jnp.maximum, -jnp.inf),
        (jnp.asarray(c), jnp.add, 0.0)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    first = np.r_[True, seg[1:] != seg[:-1]]
    np.testing.assert_array_equal(got[0].numpy()[first], np.bincount(seg, a)[np.unique(seg)])
    # voxel_map's sums are this scan with add
    np.testing.assert_array_equal(
        tvm.rev_segment_scan(torch.from_numpy(seg), [torch.from_numpy(b)])[0].numpy(),
        tprims.rev_segment_scan(torch.from_numpy(seg), [(torch.from_numpy(b), torch.add,
                                                         0.0)])[0].numpy())


def test_range_image_shapes_match_jax():
    """n_rings / max_points of the float, flat and byte wires of one sweep."""
    from lidarslam_tpu.ops import frame as jframe

    from lidarslam_tpu_torch.io import synthetic
    from lidarslam_tpu_torch.ops import frame as tframe

    f = synthetic.generate_sequence(n_frames=1, motion_distortion=False)[0]
    args = (f["xyz"], f["intensity"], f["laser_id"], f["time"], 16, 1024)
    tri = tframe.build_range_image(*args, packed=False, device="cpu")
    jri = jframe.build_range_image(*args, packed=False)
    tpk = tframe.build_range_image(*args, packed=True, device=False)
    jpk = jframe.build_range_image(*args, packed=True, device=False)
    tflat, jflat = tframe.flatten_packed(tpk, 8192), jframe.flatten_packed(jpk, 8192)
    q = np.zeros((16, 1024, 3), np.int16)
    u8 = np.zeros((16, 1024), np.uint8)
    t16 = np.zeros((16, 1024), np.float16)
    tbytes = tframe.pack_range_image_bytes(q, u8, t16, u8)
    jbytes = jframe.pack_range_image_bytes(q, u8, t16, u8, device=False)
    for t, j in ((tri, jri), (tflat, jflat), (tbytes, jbytes)):
        assert (t.n_rings, t.max_points) == (j.n_rings, j.max_points) == (16, 1024)


def test_matches_from_dense_matches_jax():
    import jax.numpy as jnp
    from lidarslam_tpu.ops import matcher as jmatcher

    from lidarslam_tpu_torch.ops import matcher as tmatcher

    rng = np.random.default_rng(3)
    A = rng.normal(size=(10, 3, 3)).astype(np.float32)
    A = A + A.transpose(0, 2, 1)
    kw = dict(P=np.zeros((10, 3), np.float32), X=np.ones((10, 3), np.float32),
              weight=np.ones(10, np.float32), status=np.zeros(10, np.uint8),
              valid=np.ones(10, bool))
    got = tmatcher.Matches.from_dense(torch.from_numpy(A),
                                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = jmatcher.Matches.from_dense(jnp.asarray(A), **{k: jnp.asarray(v)
                                                          for k, v in kw.items()})
    np.testing.assert_array_equal(got.A6.numpy(), np.asarray(want.A6))
    np.testing.assert_array_equal(got.A.numpy(), A)
    assert int(got.n_matches) == int(want.n_matches) == 10
