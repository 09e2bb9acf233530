"""The port's command line (`python -m lidarslam_tpu_torch.cli`)
against the JAX package's (`lidarslam_tpu.cli`), on the CPU (`--cpu`), on
the cases of tests/test_io_cli.py and tests/test_export.py: `run` on 5
synthetic sweeps at 1024 ring points, synchronous and `--follow`, each
compared with JAX's run by `compare` within the CI's 0.01 m / 5 deg;
`extract`'s keypoint counts; `aggregate` on the run's DISK log; `compare`'s
exit codes; and, without `--cpu` on a machine with no CUDA device, `run`
ends non-zero and names the device (no fallback). Both packages take the
numpy ingest (ROADMAP Queue 3, F5)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lidarslam_tpu import cli as jcli
from lidarslam_tpu.io import native
from lidarslam_tpu_torch import cli as tcli
from lidarslam_tpu_torch.io import csv_log, export, pcd, vtp
from lidarslam_tpu_torch.io import native as tnative
from test_torch_slam import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RUN = ["--synthetic", "5", "--max-ring-points", "1024", "--max-keypoints", "1024"]


def _main(main, argv, capsys):
    """(exit code, the JSON last line) of one in-process CLI call."""
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]), out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        for tag, main, cpu in (("jax", jcli.main, ["--cpu"]), ("port", tcli.main, ["--cpu"])):
            for mode, extra in (("sync", ["--aggregate", "--vtp", "--save-maps"]),
                                ("follow", ["--follow"])):
                out = d / f"{tag}_{mode}"
                argv = cpu + ["run", *RUN, "--out", str(out), "--log-dir",
                              str(out / "log"), *extra]
                outs[tag, mode] = (out, main(argv))
    return d, outs


def _compare(capsys, res, ref, *extra):
    return _main(tcli.main, ["compare", "--res", str(res), "--ref", str(ref),
                             "--time-threshold", "1e9", *extra], capsys)


@pytest.mark.parametrize("mode", ["sync", "follow"])
def test_run_matches_jax(runs, mode, capsys):
    """`compare` holds the port's run to JAX's within 0.01 m / 5 deg on
    every frame; overlap and n_matches agree; the same files come out."""
    _, outs = runs
    (t_out, t_rc), (j_out, j_rc) = outs["port", mode], outs["jax", mode]
    assert t_rc == j_rc == 0
    rc, cmp, _ = _compare(capsys, t_out, j_out)
    assert rc == 0 and cmp["success"] and cmp["n_compared"] == 5, cmp
    assert cmp["max_position_error_m"] < 1e-3, cmp
    te = csv_log.read_evaluators_csv(t_out / "Evaluators.csv")
    je = csv_log.read_evaluators_csv(j_out / "Evaluators.csv")
    np.testing.assert_array_equal(te[:, 0], je[:, 0])
    np.testing.assert_allclose(te[:, 1], je[:, 1], rtol=0, atol=0.01)
    assert np.abs(te[:, 2] - je[:, 2]).max() <= 0.01 * je[:, 2].max()
    names = sorted(p.name for p in t_out.iterdir() if p.is_file())
    assert names == sorted(p.name for p in j_out.iterdir() if p.is_file())
    for name in ("poses_kitti.txt", "poses_tum.txt"):
        np.testing.assert_allclose(np.loadtxt(t_out / name), np.loadtxt(j_out / name),
                                   rtol=0, atol=1e-3)


def test_run_outputs_parse(runs):
    """Every file of the port's synchronous run parses with the port's
    readers: Trajectory.csv, trajectory.ply, the .vtp files, the map PCDs
    and aggregated.pcd (its points those of JAX's within 1e-4 m)."""
    _, outs = runs
    out, j_out = outs["port", "sync"][0], outs["jax", "sync"][0]
    traj = export.read_trajectory_csv(out / "Trajectory.csv")
    poses = csv_log.read_poses_csv(out / "Poses.csv")
    assert len(traj) == len(poses) == 5
    for e, (t, H) in zip(traj, poses):
        assert abs(e["time"] - t) < 1e-9 and np.abs(e["pose"] - H).max() < 1e-6
    ply = (out / "trajectory.ply").read_text().splitlines()
    assert ply[0] == "ply" and "element vertex 5" in ply
    points, pdata, cells = vtp.read_vtp(str(out / "trajectory.vtp"))
    assert len(points) == 5 and cells["lines"][1].tolist() == [5]
    for name in ("edge", "plane"):
        m_xyz, m_data, _ = vtp.read_vtp(str(out / f"map_{name}.vtp"))
        on_disk = pcd.load_pcd(out / f"map_{name}s.pcd")
        assert len(m_xyz) == len(on_disk["xyz"]) == len(m_data["Intensity"]) > 100
    agg = pcd.load_pcd(out / "aggregated.pcd")
    want = pcd.load_pcd(j_out / "aggregated.pcd")
    assert len(agg["xyz"]) == len(want["xyz"]) > 1000
    np.testing.assert_allclose(agg["xyz"], want["xyz"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(agg["label"], want["label"])


def test_aggregate_command_matches_jax(runs, capsys):
    """`aggregate` on the port's DISK log and Trajectory.csv: without
    undistortion (the run had none) the run's aggregated.pcd within 1e-4 m,
    point for point; undistorted, and for planes alone, JAX's command on
    the same files gives the same bytes."""
    d, outs = runs
    out = outs["port", "sync"][0]
    argv = ["aggregate", "--log-dir", str(out / "log"), "--trajectory",
            str(out / "Trajectory.csv")]
    rc, got, _ = _main(tcli.main, argv + ["--out", str(d / "t_agg.pcd"), "--no-undistort"],
                       capsys)
    assert rc == 0 and got["frames"] == 5
    live = pcd.load_pcd(out / "aggregated.pcd")
    off = pcd.load_pcd(d / "t_agg.pcd")
    assert len(off["xyz"]) == len(live["xyz"]) == got["points"]
    np.testing.assert_allclose(off["xyz"], live["xyz"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(off["label"], live["label"])
    for tag, extra in (("all", []), ("planes", ["--types", "plane"])):
        rc, got, _ = _main(tcli.main, argv + ["--out", str(d / f"t_{tag}.pcd"), *extra],
                           capsys)
        jrc, want, _ = _main(jcli.main, argv + ["--out", str(d / f"j_{tag}.pcd"), *extra],
                             capsys)
        assert rc == jrc == 0 and got == {**want, "out": got["out"]}
        assert (d / f"t_{tag}.pcd").read_bytes() == (d / f"j_{tag}.pcd").read_bytes()
    assert 0 < got["points"] < len(live["xyz"])


def test_extract_counts_match_jax(tmp_path, capsys):
    """`extract` with blobs and the debug clouds: per frame the same edge,
    plane and blob counts and keypoints, the azimuthal resolution within
    1e-6 and the debug labels equal."""
    for tag, main in (("t", tcli.main), ("j", jcli.main)):
        rc, info, _ = _main(main, ["--cpu", "extract", "--synthetic", "2", "--blobs",
                                   "--debug", "--out", str(tmp_path / tag)], capsys)
        assert rc == 0 and info["frames"] == 2
    got = json.loads((tmp_path / "t" / "extraction.json").read_text())
    want = json.loads((tmp_path / "j" / "extraction.json").read_text())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g.pop("azimuthal_resolution") - w.pop("azimuthal_resolution")) < 1e-6
        assert g == w and g["edge"] > 0 and g["blob"] > 0
    for name in ("frame_0001_edge.pcd", "frame_0001_plane.pcd", "frame_0001_blob.pcd"):
        a, b = pcd.load_pcd(tmp_path / "t" / name), pcd.load_pcd(tmp_path / "j" / name)
        np.testing.assert_array_equal(a["xyz"], b["xyz"])
        np.testing.assert_array_equal(a["laser_id"], b["laser_id"])
    a = pcd.load_pcd(tmp_path / "t" / "frame_0001_debug.pcd")
    b = pcd.load_pcd(tmp_path / "j" / "frame_0001_debug.pcd")
    assert a.keys() == b.keys()
    np.testing.assert_array_equal(a["keypoint_label"], b["keypoint_label"])
    np.testing.assert_array_equal(a["point_validity"], b["point_validity"])


def test_compare_exit_codes(tmp_path, capsys):
    """0 on a run within the thresholds, 1 on one beyond them."""
    from lidarslam_tpu_torch.core import se3

    ref = [(0.1 * i, se3.pose_to_hmat([0.2 * i, 0, 0, 0, 0, 0])) for i in range(10)]
    good = [(t, H.copy()) for t, H in ref]
    good[3][1][0, 3] += 0.005
    bad = [(t, H.copy()) for t, H in ref]
    bad[5][1][0, 3] += 0.05
    for name, entries in (("ref", ref), ("good", good), ("bad", bad)):
        os.makedirs(tmp_path / name)
        csv_log.write_poses_csv(tmp_path / name / "Poses.csv", entries)
    rc, cmp, _ = _compare(capsys, tmp_path / "good", tmp_path / "ref")
    assert rc == 0 and cmp["success"] and cmp["n_compared"] == 10
    rc, cmp, _ = _compare(capsys, tmp_path / "bad", tmp_path / "ref")
    assert rc == 1 and not cmp["success"] and cmp["max_position_error_m"] > 0.04
    rc, cmp, _ = _compare(capsys, tmp_path / "bad", tmp_path / "ref",
                          "--position-threshold", "0.1")
    assert rc == 0


def test_run_without_cpu_needs_the_card(tmp_path):
    """No fallback: on a machine without a CUDA device, `run` without
    `--cpu` exits non-zero, names the device and writes nothing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "res"
    r = subprocess.run([sys.executable, "-m", "lidarslam_tpu_torch.cli", "run", *RUN,
                        "--out", str(out)], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr
    assert not out.exists()
    r = subprocess.run([sys.executable, "-m", "lidarslam_tpu_torch.cli", "extract",
                        "--synthetic", "1", "--out", str(out)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
