"""The port imports no jax, and chip_smoke.py refuses to run without a GPU
or outside a checkout (no silent CPU fallback)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lidarslam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lidarslam_tpu_torch.__path__,
                                               'lidarslam_tpu_torch.')]
for n in names:
    importlib.import_module(n)
# the streaming surface, by name
from lidarslam_tpu_torch import Slam
from lidarslam_tpu_torch.ops.frame import FlatRangeImage, KeypointsView, PackedRangeImage
from lidarslam_tpu_torch.ops.pipeline import StreamState, process_stream_window
from lidarslam_tpu_torch.ops.stream_graph import StreamGraph, WireRecord
from lidarslam_tpu_torch.ops.undistortion import compute_warp, jinterpolate_pose, warp_points
from lidarslam_tpu_torch.confidence import MotionLimitChecker, lcp_overlap
from lidarslam_tpu_torch.state import stream_state_from_numpy
# the sensor surface: constraints and the sensor CSV
from lidarslam_tpu_torch.sensors.constraints import ImuManager, WheelOdometryManager
from lidarslam_tpu_torch.io.sensor_csv import load_sensor_csv
assert callable(Slam.add_frame_async) and callable(Slam.flush)
assert callable(Slam.set_sensor_data) and callable(load_sensor_csv)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'lidarslam_tpu.'))
             or m == 'lidarslam_tpu')
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_package_imports_without_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=tmp_path,
                         env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_chip_smoke_without_gpu_exits_nonzero(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "lidarslam_tpu_torch/ not found" in out.stderr
    assert '"ok"' not in out.stdout
