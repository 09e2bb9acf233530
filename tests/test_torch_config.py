"""The port's copied host modules against the JAX package: config.py field
for field, io/synthetic.py bit for bit, and the bench configuration that
chip_smoke.py rebuilds from the port's config."""

import dataclasses
import enum
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest

import bench
from lidarslam_tpu import config as jcfg
from lidarslam_tpu.io import synthetic as jsyn
from lidarslam_tpu_torch import config as tcfg
from lidarslam_tpu_torch.io import synthetic as tsyn

ROOT = Path(__file__).resolve().parent.parent


def _members(mod, kind):
    return {n: o for n, o in inspect.getmembers(mod, inspect.isclass)
            if o.__module__ == mod.__name__ and kind(o)}


def _norm(v):
    """asdict output with enums as (class name, member name, value)."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name, v.value)
    return v


def test_same_enums():
    je = _members(jcfg, lambda c: issubclass(c, enum.Enum))
    te = _members(tcfg, lambda c: issubclass(c, enum.Enum))
    assert je.keys() == te.keys()
    for name in je:
        assert [(m.name, m.value) for m in je[name]] == \
            [(m.name, m.value) for m in te[name]], name
    assert {int(k): v for k, v in jcfg.KEYPOINT_NAMES.items()} == \
        {int(k): v for k, v in tcfg.KEYPOINT_NAMES.items()}


def test_same_dataclasses_and_defaults():
    jd = _members(jcfg, dataclasses.is_dataclass)
    td = _members(tcfg, dataclasses.is_dataclass)
    assert jd.keys() == td.keys()
    for name in jd:
        jf = [(f.name, f.type) for f in dataclasses.fields(jd[name])]
        tf = [(f.name, f.type) for f in dataclasses.fields(td[name])]
        assert jf == tf, name
        assert _norm(dataclasses.asdict(jd[name]())) == \
            _norm(dataclasses.asdict(td[name]())), name


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rings,azimuth", [(16, 1800), (64, 1024)])
def test_chip_smoke_bench_config_matches_bench(rings, azimuth, monkeypatch):
    monkeypatch.delenv("BENCH_PLANE_FACTOR", raising=False)
    monkeypatch.delenv("BENCH_EXACT_KNN", raising=False)
    want = dataclasses.asdict(bench.bench_config(rings, azimuth))
    got = dataclasses.asdict(_chip_smoke().bench_config(rings, azimuth))
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("distortion", [False, True])
def test_synthetic_sequence_bit_identical(distortion):
    kw = dict(n_frames=3, seed=4, motion_distortion=distortion,
              trajectory=None)
    j = jsyn.generate_sequence(sensor=jsyn.SensorModel(n_rings=16, n_azimuth=240),
                               **{**kw, "trajectory": jsyn.weaving_street_trajectory()})
    t = tsyn.generate_sequence(sensor=tsyn.SensorModel(n_rings=16, n_azimuth=240),
                               **{**kw, "trajectory": tsyn.weaving_street_trajectory()})
    assert len(j) == len(t)
    for fj, ft in zip(j, t):
        assert fj.keys() == ft.keys()
        for key in fj:
            a, b = np.asarray(fj[key]), np.asarray(ft[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)
