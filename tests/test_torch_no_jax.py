"""The port imports no jax, and chip_smoke.py refuses to run without a GPU
or outside a checkout (no silent CPU fallback)."""

import ast
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
# native ingest, storage tiers, timers and profiling, multi-LiDAR
from lidarslam_tpu_torch.io import lzf, native, octree, pcd, storage
from lidarslam_tpu_torch.ops.frame import merge_keypoints, transform_keypoints
from lidarslam_tpu_torch.ops.pipeline import process_keypoints_stream
from lidarslam_tpu_torch.ops.stream_graph import FloatRecord, KeypointRecord
from lidarslam_tpu_torch.utils import profiling, timer
# the back end and the state surface
from lidarslam_tpu_torch import evaluation, outputs
from lidarslam_tpu_torch.backend import posegraph, posegraph_device, registration
assert callable(posegraph_device.optimize_pose_graph_device)
for name in ("run_pose_graph_optimization", "save_checkpoint", "load_checkpoint",
             "save_maps_to_pcd", "load_maps_from_pcd", "execute_command", "subscribe",
             "get_debug_array", "extract_debug", "get_registered_frame",
             "get_debug_information", "set_world_transform_from_guess",
             "get_latency_compensated_world_transform"):
    assert callable(getattr(Slam, name)), name
assert native.available(), native.last_error()
assert lzf.decompress(lzf.compress(b"ab" * 64), 128) == b"ab" * 64
assert callable(Slam.add_frame_async) and callable(Slam.flush)
assert callable(Slam.add_frames) and callable(Slam.add_frames_async)
assert callable(Slam.start_profiling) and callable(Slam.get_log_memory_usage)
assert callable(Slam.set_sensor_data) and callable(load_sensor_csv)
# the host I/O modules and the front ends
from lidarslam_tpu_torch.io import (assembler, conversions, csv_log, export, gps, kitti,
                                    vtp, yaml_config)
from lidarslam_tpu_torch import cli, paraview_plugin, ros_node, server
from lidarslam_tpu_torch.server import SlamClient, SlamServer
from lidarslam_tpu_torch.ros_node import LidarSlamNode, RospyFacade
from lidarslam_tpu_torch.paraview_plugin import SlamFilterCore
assert callable(cli.main) and callable(ros_node.main)
# the multi-device layer
from lidarslam_tpu_torch.parallel import launch, sharded, sharded_map
from lidarslam_tpu_torch.parallel.sharded import Mesh, make_mesh
assert callable(launch.launch) and callable(sharded_map.shard_roll)
for name in ("sharded_icp_register", "process_frame_spmd", "process_keypoints_spmd",
             "process_frame_stream_spmd", "process_stream_window_spmd",
             "process_keypoints_stream_spmd"):
    assert callable(getattr(sharded, name)), name
assert callable(yaml_config.load_config) and callable(export.aggregate_logged_frames)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'lidarslam_tpu.'))
             or m == 'lidarslam_tpu')
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
"""


def _package_imports(path: Path):
    """(line, module) of every import in a file that names jax or the JAX
    package (`lidarslam_tpu` not followed by `_torch`), wherever it stands:
    at the top, inside a function or a branch, or as `importlib.import_module`
    / `__import__` of a literal name. Strings and comments are not code."""
    def banned(name):
        return name.split(".")[0] in ("jax", "jaxlib", "lidarslam_tpu")

    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if banned(node.module):
                found.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and banned(node.args[0].value)):
            found.append((node.lineno, node.args[0].value))
    return sorted(found)


def test_no_jax_import_anywhere_in_the_port():
    """A static scan of every module of the port and of chip_smoke.py: the
    import check above runs what module import runs, not the lazy imports
    inside functions."""
    files = sorted((ROOT / "lidarslam_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_ranks.py"]
    assert len(files) > 40
    assert {"sharded.py", "sharded_map.py", "launch.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    bad = {str(f.relative_to(ROOT)): hits for f in files if (hits := _package_imports(f))}
    assert not bad, bad


def test_the_scan_sees_lazy_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n"
                   "'from lidarslam_tpu import Slam'  # import lidarslam_tpu\n"
                   "from lidarslam_tpu_torch.io import pcd\n"
                   "def f():\n"
                   "    from lidarslam_tpu.io import pcd\n"
                   "    import jax.numpy as jnp\n"
                   "    if True:\n"
                   "        import importlib; importlib.import_module('lidarslam_tpu.cli')\n"
                   "    return __import__('jax')\n")
    assert _package_imports(src) == [(5, "lidarslam_tpu.io"), (6, "jax.numpy"),
                                     (8, "lidarslam_tpu.cli"), (9, "jax")]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_package_imports_without_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=tmp_path,
                         env=_env(PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_rank_module_imports_without_jax(tmp_path):
    """The module the mesh tests' spawned ranks import (their functions)
    loads neither jax nor the JAX package."""
    code = ("import sys; import torch_mesh_ranks; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lidarslam_tpu')); print(bad); assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_env(PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}"),
                         capture_output=True, text=True, timeout=300)
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
